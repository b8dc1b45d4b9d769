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
* The ``"fp32"`` route's split-TF32 arithmetic (``ref.moe_gemm_tf32_model``,
  per 32-deep k-panel): within atol 1e-4 + rtol 1e-4 of the reference's
  ``moe_gemm_ref`` (the tolerance the card is held to) at the serving
  shapes and the grid's narrow ones, with ``rows`` None, random and all 0;
  bitwise on integer-valued inputs; against the Pallas kernel in interpret
  mode; a single TF32 pass falls outside that tolerance; planted inf / NaN /
  |v| near FLT_MAX give the plain version's non-finite pattern; products
  at overflow magnitudes (C3's pairs and full-mantissa ones in [2^126,
  2^128), one term an output element) come out as the plain version's
  float32 product bit for bit, through the unsplit rule, and the split's
  terms round each product to float32 (hi·hi overflows). The route's
  blocking (``fp32_config``) against the kernel source's constants.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as r_smoke_config
from repro.kernels.moe_gemm import grouped_gemm as r_grouped_gemm
from repro.kernels.moe_gemm import moe_gemm_ref as r_moe_gemm_ref
from repro.models.moe import moe_apply as r_moe_apply
from repro.models.moe import moe_init as r_moe_init
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.bsr_spgemm.ref import (split_terms, tf32_split,
                                               unsplit_where)
from repro_torch.kernels.moe_gemm import grouped_gemm
from repro_torch.kernels.moe_gemm import kernel as tkernel
from repro_torch.kernels.moe_gemm.ref import (moe_gemm_ref,
                                              moe_gemm_tf32_model)
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


TF32_SHAPES = [(2048, 1408), (1408, 2048), (640, 72), (200, 72)]
TF32_TOL = dict(atol=1e-4, rtol=1e-4)


def _tf32_case(d, f, rows, *, ints=False, e=2, cap=24):
    """Seeded float32 inputs of the ``"fp32"`` route: normal x and w scaled
    by d^-1/2 (outputs of order 1), or integers in [-4, 4]; ``rows`` None,
    random in [0, cap + 8] (values past cap are clamped) or all 0."""
    r = np.random.default_rng(d * 7 + f + (1 if ints else 0))
    if ints:
        x = r.integers(-4, 5, (e, cap, d)).astype(np.float32)
        w = r.integers(-4, 5, (e, d, f)).astype(np.float32)
    else:
        x = r.standard_normal((e, cap, d)).astype(np.float32)
        w = (r.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)
    live = {"none": None, "random": r.integers(0, cap + 9, e),
            "zero": np.zeros(e)}[rows]
    return x, w, None if live is None else live.astype(np.int32)


def _reference(x, w, rows):
    """The reference's ``moe_gemm_ref`` einsum with rows at and past
    ``rows[e]`` zeroed."""
    y = np.array(r_moe_gemm_ref(jnp.asarray(x), jnp.asarray(w)))
    if rows is not None:
        y[np.arange(x.shape[1])[None, :] >= np.clip(rows, 0, x.shape[1])
          [:, None]] = 0.0
    return y


def _model(x, w, rows):
    bk = tkernel.fp32_config()["bk"]
    return moe_gemm_tf32_model(
        torch.from_numpy(x), torch.from_numpy(w),
        None if rows is None else torch.from_numpy(rows), block_k=bk)


@pytest.mark.parametrize("rows", ["none", "random", "zero"])
@pytest.mark.parametrize("d,f", TF32_SHAPES)
def test_fp32_route_split_tf32_stays_within_the_chip_tolerance(d, f, rows):
    """Three TF32 passes a 32-deep panel, the panels added in float32, stay
    within the float32 tolerance the card holds the route to; rows past
    ``rows[e]`` are exactly zero."""
    x, w, live = _tf32_case(d, f, rows)
    got = _model(x, w, live)
    assert got.dtype == torch.float32 and got.shape == (2, 24, f)
    np.testing.assert_allclose(got.numpy(), _reference(x, w, live),
                               **TF32_TOL)
    if live is not None:
        for i, n in enumerate(np.clip(live, 0, 24)):
            assert not got[i, n:].any()


@pytest.mark.parametrize("rows", ["none", "random", "zero"])
@pytest.mark.parametrize("d,f", TF32_SHAPES)
def test_fp32_route_is_bitwise_on_integers(d, f, rows):
    """Integers in [-4, 4] are TF32-exact (no lo part) and every partial
    sum stays below 2^24, so the split arithmetic gives the reference's
    result bit for bit."""
    x, w, live = _tf32_case(d, f, rows, ints=True)
    got = _model(x, w, live).numpy()
    want = _reference(x, w, live)
    assert np.array_equal(got.view(np.int32), (want + 0.0).view(np.int32))


@pytest.mark.parametrize("e,cap,d,f", [
    (2, 64, 64, 128), (4, 96, 200, 72), (3, 8, 512, 136)])
def test_fp32_route_model_matches_pallas(e, cap, d, f):
    """The model against the reference's Pallas kernel in interpret mode
    on the same seeded inputs, where the kernel's padded d is a multiple
    of 512 (so it contracts all of d)."""
    r = np.random.default_rng(e + cap + d)
    x = r.standard_normal((e, cap, d)).astype(np.float32)
    w = (r.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)
    want = np.asarray(r_grouped_gemm(jnp.asarray(x), jnp.asarray(w),
                                     interpret=True))
    got = _model(x, w, None).numpy()
    np.testing.assert_allclose(got, want, **TF32_TOL)


@pytest.mark.parametrize("d,f", TF32_SHAPES)
def test_one_tf32_pass_falls_outside_the_tolerance(d, f):
    """The three-term split is what holds the tolerance: one TF32 pass
    (hi·hi only) does not."""
    x, w, _ = _tf32_case(d, f, "none")
    hi = lambda a: tf32_split(torch.from_numpy(a))[0]
    one = moe_gemm_ref(hi(x), hi(w)).numpy()
    want = _reference(x, w, None)
    assert not np.allclose(one, want, **TF32_TOL)
    np.testing.assert_allclose(_model(x, w, None).numpy(), want, **TF32_TOL)


def _nonfinite_pattern(y):
    return np.isnan(y), np.isposinf(y), np.isneginf(y)


@pytest.mark.parametrize("rows", ["none", "random"])
@pytest.mark.parametrize("d,f", [(640, 72), (200, 72)])
def test_fp32_route_keeps_the_plain_non_finite_pattern(d, f, rows):
    """inf, NaN and an |x| near FLT_MAX planted in x and w: the panels that
    hold them are summed unsplit, so inf and NaN land where the plain
    version puts them (the split alone would turn inf * (hi + lo) into
    NaN), and every finite output stays within the tolerance."""
    x, w, live = _tf32_case(d, f, rows)
    x[:, 0, 3] = np.inf
    x[:, 2, d - 1] = np.nan
    x[:, 1, 0] = 3.0e38
    w[:, 5, 1] = -np.inf
    w[:, d // 2, f - 1] = np.nan
    got = _model(x, w, live).numpy()
    want = _reference(x, w, live)
    for a, b in zip(_nonfinite_pattern(got), _nonfinite_pattern(want)):
        assert np.array_equal(a, b)
    assert np.isnan(want).any() and np.isinf(want).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TF32_TOL)
    # the split of a wide panel is what the rule keeps out
    xs, ws = (tf32_split(torch.from_numpy(a)) for a in (x, w))
    naive = sum(a.double() @ b.double() for a, b in (
        (xs[1], ws[0]), (xs[0], ws[1]), (xs[0], ws[0]))).float().numpy()
    assert not np.array_equal(np.isnan(naive[:, :2]), np.isnan(want[:, :2]))


# C3's operand pairs at overflow magnitudes (the pairs ``chip_smoke.py``
# plants on the card): x = nextafter(2**64, 0), whose TF32 hi is 2**64, so
# hi·hi = 2**128 overflows where x·x does not; x·x negated; 2e19 squared,
# past FLT_MAX either way; 2**63 times nextafter(2**65, 0) = FLT_MAX; exact
# products under and over the 2**126 bound
_X = float(np.nextafter(np.float32(2.0 ** 64), np.float32(0)))
OVERFLOW_PAIRS = [(_X, _X), (-_X, _X), (2e19, 2e19),
                  (2.0 ** 63, float(np.nextafter(np.float32(2.0 ** 65),
                                                 np.float32(0)))),
                  (2.0 ** 100, 2.0 ** 20), (3 * 2.0 ** 62, 2.0 ** 63)]


def _overflow_pairs(n=24, seed=11):
    """``OVERFLOW_PAIRS``, then ``n`` seeded pairs with full 24-bit
    mantissas whose products lie in [2**126, 2**128): there the split's
    lo·hi + hi·lo + hi·hi (lo·lo dropped, and a lo short of the bits
    x - hi has) rounds to another float32 than x·y about half the time."""
    r = np.random.default_rng(seed)
    a, b = (np.float32(r.uniform(1.0, 2.0, n) * 2.0 ** 63) for _ in "ab")
    return OVERFLOW_PAIRS + [(float(u), float(v)) for u, v in zip(a, b)]


def test_fp32_route_model_is_the_plain_product_at_overflow_magnitudes():
    """Each pair of ``_overflow_pairs`` is the one nonzero term of an output
    element (x row i holds its first value at column i, w its second at
    (i, 5 i + 1 mod 64)), in 32-deep panels: where the largest |x| and |w|
    of a panel multiply to 2**126 or more the panel is summed unsplit, so
    every element is the float32 product bit for bit, inf and -inf
    included, as the reference's ``moe_gemm_ref`` gives it (a split rounds
    half the full-mantissa products elsewhere, and its hi·hi of
    nextafter(2**64, 0) squared is 2**128). Last, x·x - x·x for
    x = nextafter(2**64, 0) within one panel, a TF32 k-step apart: the
    plain version's 0, up to x·x's rounding residual (2**80, which a fused
    multiply-add keeps)."""
    pairs = _overflow_pairs()
    n, d = len(pairs), 64
    x = np.zeros((1, n + 1, d), np.float32)
    w = np.zeros((1, d, d), np.float32)
    for i, (a, b) in enumerate(pairs):
        x[0, i, i], w[0, i, (5 * i + 1) % d] = a, b
    x[0, n, 40], x[0, n, 41] = _X, -_X
    w[0, 40, 7] = w[0, 41, 7] = _X
    got = _model(x, w, None).numpy()
    want = _reference(x, w, None)
    assert np.isposinf(want).any() and np.isneginf(want[:, :n]).sum() == 0
    assert np.array_equal(got[:, :n].view(np.int32),
                          (want[:, :n] + 0.0).view(np.int32))
    for y in (got, want):
        assert np.isfinite(y[0, n]).all() and abs(y[0, n, 7]) <= 2.0 ** 80


def test_split_terms_round_each_product_to_float32():
    """The models form each split term's products as the tensor core does,
    in float32: hi·hi of nextafter(2**64, 0) squared is 2**128, an
    infinity, and x·x - x·x a k-step apart is inf - inf, NaN, which is what
    the unsplit rule keeps out; products below FLT_MAX are exact and summed
    in float64."""
    x = torch.tensor([[_X, -_X]])
    w = torch.tensor([[_X], [_X]])
    (xh, xl), (wh, wl) = tf32_split(x), tf32_split(w)
    assert float(xh[0, 0]) == 2.0 ** 64
    assert torch.isposinf(split_terms(((xh[:, :1], wh[:1]),))).all()
    assert torch.isnan(split_terms(((xl, wh), (xh, wl), (xh, wh)))).all()
    assert bool(unsplit_where(x.abs().amax(), w.abs().amax()))
    small = torch.tensor([[3.0, 5.0]])
    assert float(split_terms(((small, small.T), (small, small.T)))) == 68.0
    assert not bool(unsplit_where(small.abs().amax(), small.abs().amax()))


def test_fp32_config_matches_the_kernel_source():
    """The host's blocking of the ``"fp32"`` route against the constants of
    ``csrc/moe_gemm_tf32.cu`` (the card holds it against the built library
    in ``chip_smoke.py``): 128 x 128 tiles, 32-deep panels, the ring's and
    the staged stages, and dynamic shared memory within the 227 KB a CTA
    has."""
    import re
    src = tkernel.TF32_SOURCE.read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    cfg = tkernel.fp32_config()
    assert (cfg["bm"], cfg["bn"], cfg["bk"]) == (
        int(const["BM"]), int(const["BN"]), int(const["BK"])) == (128, 128, 32)
    assert (cfg["stages"], cfg["w_stages"]) == (
        int(const["RST"]), int(const["WST"]))
    assert cfg["smem_bytes"] <= 232448


def test_fp32_source_builds_with_the_shared_header():
    """The split-TF32 source includes the shared PTX header (its library's
    name covers it) and is one of the sources ``build`` compiles."""
    header = (Path(cuda_lib.__file__).parent / "hopper.cuh").resolve()
    assert cuda_lib.local_headers(tkernel.TF32_SOURCE) == [header]
    assert tkernel.SOURCES == (tkernel.SOURCE, tkernel.TC_SOURCE,
                               tkernel.TF32_SOURCE)
    assert cuda_lib.local_headers(tkernel.SOURCE) == []


@pytest.mark.parametrize("cap", [8, 88])
def test_cpu_wrapper_counts_no_fp32_launch(cap):
    """On CPU tensors the wrapper runs the plain version and counts no
    launch on the float32 route."""
    x, w = (torch.from_numpy(a) for a in _xw(2, cap, 64, 32, seed=cap))
    tkernel.reset_launches()
    got = tkernel.moe_gemm(x, w)
    assert torch.equal(got, moe_gemm_ref(x, w))
    assert tkernel.moe_gemm.launches == 0
    assert tkernel.moe_gemm.route_launches == dict.fromkeys(tkernel.ROUTES, 0)
