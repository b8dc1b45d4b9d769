"""The port's grouped GEMM and MoE layer against the reference, on the CPU.

* ``grouped_gemm``: against the reference's Pallas kernel (interpret mode)
  at d in {64, 200, 512}, where its padded d is a multiple of 512 or at most
  512; against the reference's ``moe_gemm_ref`` einsum at d in {640, 1408},
  where the Pallas kernel drops the last ``d % 512`` columns of the
  contraction (pinned here too, since the port must not copy it). Float32
  within atol 2e-4, rtol 1e-4 (the reference's own kernel tolerance).
* ``moe_apply``: outputs within 1e-5, the aux loss within 1e-6, and the three
  ``moe/*`` metrics equal, with and without tokens dropped at capacity.
* The wrapper's argument checks: what the MoE layer hands the kernels on a
  card passes them, ``rows`` included (run on CPU tensors), and what the
  kernels do not take raises. The CUDA kernels themselves run only on a
  card (``chip_smoke.py``); ``rows`` is covered in ``test_torch_moe_rows.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as r_smoke_config
from repro.kernels.moe_gemm import grouped_gemm as r_grouped_gemm
from repro.kernels.moe_gemm import moe_gemm_ref as r_moe_gemm_ref
from repro.models.moe import moe_apply as r_moe_apply
from repro.models.moe import moe_init as r_moe_init
from repro_torch.kernels.moe_gemm import grouped_gemm
from repro_torch.kernels.moe_gemm import kernel as tkernel
from repro_torch.models.moe import _capacity, moe_apply
from repro_torch.models.convert import _tree_map


def _xw(e, cap, d, f, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((e, cap, d)).astype(np.float32),
            r.standard_normal((e, d, f)).astype(np.float32))


@pytest.mark.parametrize("e,cap,d,f", [
    (2, 64, 64, 128), (4, 96, 200, 72), (3, 8, 512, 136)])
def test_grouped_gemm_matches_pallas(e, cap, d, f):
    x, w = _xw(e, cap, d, f)
    want = r_grouped_gemm(jnp.asarray(x), jnp.asarray(w), interpret=True)
    got = grouped_gemm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("d", [640, 1408])
def test_grouped_gemm_contracts_all_of_d(d):
    x, w = _xw(2, 16, d, 72, seed=d)
    want = np.asarray(r_moe_gemm_ref(jnp.asarray(x), jnp.asarray(w)))
    got = grouped_gemm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    # the reference's Pallas path drops the last d % 512 columns here
    pallas = np.asarray(r_grouped_gemm(jnp.asarray(x), jnp.asarray(w),
                                       interpret=True))
    tail = np.einsum("ecd,edf->ecf", x[:, :, d // 512 * 512:],
                     w[:, d // 512 * 512:])
    np.testing.assert_allclose(pallas, want - tail, atol=2e-3, rtol=1e-3)
    assert np.abs(pallas - want).max() > 1.0


def test_grouped_gemm_bf16():
    x, w = _xw(2, 24, 64, 32, seed=3)
    got = grouped_gemm(torch.from_numpy(x).bfloat16(),
                       torch.from_numpy(w).bfloat16())
    want = r_moe_gemm_ref(jnp.asarray(x).astype(jnp.bfloat16),
                          jnp.asarray(w).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=5e-2,
                               rtol=5e-2)


def _moe_case(capacity_factor, arch="qwen2-moe-a2.7b"):
    import jax
    cfg = r_smoke_config(arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    rp = r_moe_init(jax.random.PRNGKey(0), cfg)
    tp = _tree_map(lambda a: torch.from_numpy(np.array(a)), rp)
    x = np.random.default_rng(1).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    return cfg, rp, tp, x


@pytest.mark.parametrize("arch,capacity_factor,drops", [
    ("qwen2-moe-a2.7b", 1.25, False), ("qwen2-moe-a2.7b", 0.25, True),
    ("phi3.5-moe-42b-a6.6b", 0.5, True)])
def test_moe_apply_matches(arch, capacity_factor, drops):
    cfg, rp, tp, x = _moe_case(capacity_factor, arch)
    ry, raux, rm = r_moe_apply(rp, cfg, jnp.asarray(x), use_kernel=False)
    ty, taux, tm = moe_apply(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(taux), float(raux), rtol=1e-6,
                               atol=1e-7)
    assert set(tm) == set(rm)
    for key in rm:
        assert int(tm[key]) == int(rm[key]), key
    assert (int(tm["moe/dropped"]) > 0) == drops


def test_capacity_integer_math():
    from repro.models.moe import _capacity as r_capacity
    moe = r_smoke_config("qwen2-moe-a2.7b").moe
    from repro.configs import get_config
    full = get_config("qwen2-moe-a2.7b").moe
    for m in (moe, full):
        for t in (1, 4, 7, 48, 8192, 10000):
            assert _capacity(m, t) == r_capacity(m, t)
    assert _capacity(full, 8192) == 688 and _capacity(full, 4) == 8


def test_moe_hands_the_kernel_arguments_it_accepts(monkeypatch):
    """Every grouped-GEMM launch of the MoE layer would pass the kernel's
    checks: the layer runs on CPU tensors with each call checked first."""
    inner = tkernel.moe_gemm
    calls = []

    def checked(x, w, rows=None):
        out = torch.empty(x.shape[0], x.shape[1], w.shape[2], dtype=x.dtype)
        tkernel.check_launch_args(x, w, out, rows)
        assert rows is not None
        assert int(rows.min()) >= 0 and int(rows.max()) <= x.shape[1]
        calls.append((tuple(x.shape), tuple(w.shape), rows.tolist()))
        return inner(x, w, rows)

    monkeypatch.setattr(tkernel, "moe_gemm", checked)
    cfg, _, tp, x = _moe_case(1.25)
    for t in (x, x[:, :1]):                       # prefill- and decode-like
        moe_apply(tp, cfg, torch.from_numpy(np.ascontiguousarray(t)))
    assert len(calls) == 6
    caps = {c[0][1] for c in calls}
    assert caps == {_capacity(cfg.moe, 48), _capacity(cfg.moe, 2)}
    # the three GEMMs of one layer get the same rows: top-k slots in all
    for i in (0, 3):
        assert calls[i][2] == calls[i + 1][2] == calls[i + 2][2]
    assert sum(calls[0][2]) == 48 * cfg.moe.top_k
    assert sum(calls[3][2]) == 2 * cfg.moe.top_k


def test_block_rows_follow_capacity():
    assert [tkernel.block_rows(c) for c in (1, 8, 16, 17, 64, 65, 688)] == \
        [16, 16, 16, 64, 64, 128, 128]


@pytest.mark.parametrize("case", ["dtype", "d_multiple", "experts",
                                  "contiguous", "out_shape", "rows_int64",
                                  "rows_length", "rows_device"])
def test_check_launch_args_rejects(case):
    x, w = torch.zeros(2, 8, 64), torch.zeros(2, 64, 32)
    out = torch.empty(2, 8, 32)
    rows = torch.full((2,), 8, dtype=torch.int32)
    tkernel.check_launch_args(x, w, out, rows)
    if case == "rows_int64":
        rows = rows.long()
    elif case == "rows_length":
        rows = torch.full((3,), 8, dtype=torch.int32)
    elif case == "rows_device":
        rows = torch.full((2,), 8, dtype=torch.int32, device="meta")
    elif case == "dtype":
        w = w.half()
    elif case == "d_multiple":
        x, w = torch.zeros(2, 8, 60), torch.zeros(2, 60, 32)
    elif case == "experts":
        w = torch.zeros(3, 64, 32)
    elif case == "contiguous":
        x = torch.zeros(2, 64, 8).transpose(1, 2)
    else:
        out = torch.empty(2, 8, 40)
    with pytest.raises(ValueError):
        tkernel.check_launch_args(x, w, out, rows)
