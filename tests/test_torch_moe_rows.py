"""Each expert's live-row count, ``rows``, through the port's grouped GEMM
and MoE layer, against the reference on the CPU.

* The plain version and the wrapper on CPU tensors: rows ``r >= rows[e]``
  (clamped to ``[0, cap]``) are zeros, the others equal the reference's
  ``moe_gemm_ref`` einsum (float32, atol 2e-4, rtol 1e-4, the reference's
  kernel tolerance), for rows of 0, cap, the 128-row tile edges 63-65 and
  127-129, values above cap, and a random mix.
* ``rows=None`` is every row live: bitwise what ``rows = cap`` gives.
* ``_route_and_combine``'s rows equal ``min(count_e, cap)``, the counts taken
  in numpy from the reference's own routing (its softmax and ``top_k``) on
  the same inputs; the buckets are zero at and past ``rows[e]`` (the
  invariant that makes the kernels' skip exact); ``moe_apply`` is bitwise
  the same with ``rows`` handed to the GEMMs and with ``rows=None``.
* :func:`route`: which kernel a card runs for a dtype and a capacity.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as r_smoke_config
from repro.kernels.moe_gemm import moe_gemm_ref as r_moe_gemm_ref
from repro.models.moe import moe_init as r_moe_init
import repro_torch.models.moe as tmoe
from repro_torch.kernels.moe_gemm import grouped_gemm, moe_gemm_ref
from repro_torch.kernels.moe_gemm import kernel as tkernel
from repro_torch.models.convert import _tree_map

CAP = 136


def _xw(e, cap, d, f, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((e, cap, d)).astype(np.float32),
            r.standard_normal((e, d, f)).astype(np.float32))


def _want(x, w, rows):
    """The reference's einsum with rows at and past ``rows[e]`` zeroed."""
    y = np.array(r_moe_gemm_ref(jnp.asarray(x), jnp.asarray(w)))
    live = np.clip(rows, 0, x.shape[1])
    y[np.arange(x.shape[1])[None, :] >= live[:, None]] = 0.0
    return y


@pytest.mark.parametrize("fill", [0, CAP, 63, 64, 65, 127, 128, 129,
                                  CAP + 1, 10 ** 6, "mixed"])
@pytest.mark.parametrize("fn", ["plain", "wrapper"])
def test_rows_zero_the_rows_past_each_fill(fill, fn):
    e, d, f = 3, 64, 24
    x, w = _xw(e, CAP, d, f, seed=7)
    if fill == "mixed":
        rows = np.array([5, CAP + 9, 0], np.int32)
    else:
        rows = np.full(e, fill, np.int32)
    call = moe_gemm_ref if fn == "plain" else grouped_gemm
    got = call(torch.from_numpy(x), torch.from_numpy(w),
               torch.from_numpy(rows)).numpy()
    want = _want(x, w, rows)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    live = np.clip(rows, 0, CAP)
    for i in range(e):
        assert not got[i, live[i]:].any()


def test_rows_none_is_every_row():
    x, w = _xw(2, 40, 32, 16, seed=3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    full = torch.full((2,), 40, dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        a = grouped_gemm(xt.to(dtype), wt.to(dtype))
        b = grouped_gemm(xt.to(dtype), wt.to(dtype), full)
        assert torch.equal(a, b)


def test_rows_bf16():
    x, w = _xw(2, 24, 64, 32, seed=5)
    rows = np.array([17, 3], np.int32)
    got = grouped_gemm(torch.from_numpy(x).bfloat16(),
                       torch.from_numpy(w).bfloat16(), torch.from_numpy(rows))
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    wb = np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _want(xb, wb, rows),
                               atol=5e-2, rtol=5e-2)


def _layer(capacity_factor, tokens, seed=1):
    cfg = r_smoke_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    rp = r_moe_init(jax.random.PRNGKey(0), cfg)
    tp = _tree_map(lambda a: torch.from_numpy(np.array(a)), rp)
    x = np.random.default_rng(seed).standard_normal(
        (tokens, cfg.d_model)).astype(np.float32)
    return cfg, rp, tp, x


def _reference_fill(cfg, rp, x):
    """min(count_e, cap) from the reference's routing of x, in numpy."""
    moe = cfg.moe
    e = moe.n_experts_padded
    logits = (jnp.asarray(x) @ rp["router"]).astype(jnp.float32)
    if e > moe.n_experts:
        logits = jnp.where(jnp.arange(e)[None, :] >= moe.n_experts, -1e30,
                           logits)
    _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), moe.top_k)
    count = np.bincount(np.asarray(ids).ravel(), minlength=e)
    return np.minimum(count, tmoe._capacity(moe, x.shape[0])), count


def _route(cfg, tp, x):
    seen = {}

    def run(bkts, rows):
        seen["buckets"], seen["rows"] = bkts.clone(), rows.clone()
        return bkts

    tmoe._route_and_combine(cfg, tp["router"], None, torch.from_numpy(x),
                            run)
    return seen["buckets"], seen["rows"]


@pytest.mark.parametrize("capacity_factor,tokens,case", [
    (1.25, 48, "no_drops"), (0.25, 48, "drops"), (1.25, 1, "empty_expert")])
def test_route_and_combine_rows(capacity_factor, tokens, case):
    cfg, rp, tp, x = _layer(capacity_factor, tokens)
    want, count = _reference_fill(cfg, rp, x)
    buckets, rows = _route(cfg, tp, x)
    assert rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), want)
    cap = buckets.shape[1]
    dropped = int((count - np.minimum(count, cap)).sum())
    assert (dropped > 0) == (case == "drops")
    n = cfg.moe.n_experts                 # the padded experts get nothing
    assert not count[n:].any()
    assert (count[:n] == 0).any() == (case == "empty_expert")
    # the invariant that makes the skip exact: nothing at or past the fill
    for i, r in enumerate(rows.tolist()):
        assert not buckets[i, r:].any()
        assert buckets[i, :r].abs().sum(-1).gt(0).all()


@pytest.mark.parametrize("capacity_factor,tokens", [
    (1.25, 48), (0.25, 48), (1.25, 1)])
def test_moe_apply_is_bitwise_the_same_without_rows(capacity_factor, tokens,
                                                    monkeypatch):
    cfg, _, tp, x = _layer(capacity_factor, tokens)
    xt = torch.from_numpy(x).reshape(1, tokens, -1)
    y, aux, _ = tmoe.moe_apply(tp, cfg, xt)
    monkeypatch.setattr(tmoe, "grouped_gemm",
                        lambda a, b, rows=None: grouped_gemm(a, b))
    y_none, aux_none, _ = tmoe.moe_apply(tp, cfg, xt)
    assert torch.equal(y, y_none)
    assert torch.equal(aux, aux_none)


def test_route_follows_dtype_and_capacity():
    r = tkernel.route
    assert [r(torch.float32, c) for c in (1, 8, 16, 688)] == ["fp32"] * 4
    assert [r(torch.bfloat16, c) for c in (1, 8, 16, 17, 96, 688)] == \
        ["decode"] * 3 + ["prefill"] * 3
    assert set(tkernel.ROUTES) == {"prefill", "decode", "fp32"}
    with pytest.raises(ValueError):
        r(torch.float16, 8)


def test_launch_counts_reset():
    tkernel.moe_gemm.launches = 5
    tkernel.moe_gemm.route_launches["decode"] = 2
    tkernel.reset_launches()
    assert tkernel.moe_gemm.launches == 0
    assert tkernel.moe_gemm.route_launches == dict.fromkeys(tkernel.ROUTES, 0)
    # the plain version on CPU tensors is no launch
    x, w = _xw(1, 8, 8, 8, seed=0)
    grouped_gemm(torch.from_numpy(x), torch.from_numpy(w))
    assert tkernel.moe_gemm.launches == 0
