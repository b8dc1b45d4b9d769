"""The port's mamba2 layer (``repro_torch.models.mamba2``) against the
reference's (``repro.models.mamba2``), on the CPU.

The layer's parameters come from the reference's ``mamba_init`` as numpy
arrays; every input is drawn from a numpy seed. The smoke configs of
mamba2-1.3b and jamba-v0.1-52b (d_model 64, d_state 16, head_dim 8, chunk
8, d_conv 4), float32. The reference's functions run under ``jax.jit``
(one compile per shape) to keep the file short.

Tolerances (float32; the contraction orders differ, the arithmetic is the
same): outputs and states within 1e-5 of the largest magnitude of the
reference's, the conv tail (a copy of rows of ``x @ w_in``) within 1e-6
absolute; ``_segsum`` within 1e-6 absolute with the same ``-inf``
pattern; the layer's input gradient and every parameter gradient within
1e-5 of the largest magnitude of each, all finite. bfloat16 (the casts):
within 2e-2 of the largest magnitude (a few bf16 roundings apart).

The port's :func:`mamba_prefill` also returns the state after the prompt,
held here against the reference's own ``mamba_decode`` stepped over the
prompt from ``init_ssm_state``. The reference's prefill leaves that state
at zero (``src/repro/models/blocks.py:86-87``); the last test pins it.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as rmodels
import repro.models.mamba2 as rm
from repro.configs import smoke_config as r_smoke_config
from repro_torch.configs import smoke_config
from repro_torch.models import mamba2 as tm

ARCHS = ("mamba2-1.3b", "jamba-v0.1-52b")
REL = 1e-5


def _rel_close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale + 1e-12, (err, scale)


@functools.lru_cache(maxsize=None)
def _layer(arch):
    """(reference cfg, reference params, port cfg, port params) of one
    mamba layer."""
    cfg = r_smoke_config(arch)
    rp = rm.mamba_init(jax.random.PRNGKey(0), cfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    return cfg, rp, smoke_config(arch), tp


_r_train = jax.jit(rm.mamba_train, static_argnums=1)
_r_decode = jax.jit(rm.mamba_decode, static_argnums=1)


@functools.partial(jax.jit, static_argnums=1)
def _r_train_vjp(rp, cfg, x, g):
    _, vjp = jax.vjp(lambda p, xx: rm.mamba_train(p, cfg, xx), rp, x)
    return vjp(g)


def _x(cfg, s, seed, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _state(st):
    return tm.SSMState(torch.from_numpy(np.array(st.conv)),
                       torch.from_numpy(np.array(st.ssm)))


def test_configs_are_the_reference_smoke_configs():
    for arch in ARCHS:
        assert dataclasses.asdict(smoke_config(arch)) == \
            dataclasses.asdict(r_smoke_config(arch))


@pytest.mark.parametrize("length", [1, 8, 13])
def test_segsum_matches(length):
    x = np.random.default_rng(length).standard_normal(
        (2, 3, length)).astype(np.float32)
    want = np.asarray(rm._segsum(jnp.asarray(x)))
    got = tm._segsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-6, rtol=0)


@pytest.mark.parametrize("s", [8, 24])
def test_ssd_chunked_matches(s):
    """One chunk and three; outputs and the final state."""
    rng = np.random.default_rng(s)
    b, h, p, n, chunk = 2, 4, 8, 16, 8
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    da = -np.abs(rng.standard_normal((b, s, h))).astype(np.float32)
    bb = rng.standard_normal((b, s, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, n)).astype(np.float32)
    ry, rf = rm._ssd_chunked(*map(jnp.asarray, (x, da, bb, cc)), chunk)
    ty, tf = tm._ssd_chunked(*map(torch.from_numpy, (x, da, bb, cc)), chunk)
    _rel_close(ty, ry)
    _rel_close(tf, rf)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", [16, 13])
def test_mamba_train_matches(arch, s):
    """S a multiple of the chunk (16) and not one (13: padded to 16)."""
    cfg, rp, tcfg, tp = _layer(arch)
    x = _x(cfg, s, seed=s)
    _rel_close(tm.mamba_train(tp, tcfg, torch.from_numpy(x)),
               _r_train(rp, cfg, jnp.asarray(x)))


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_train_gradients_match(arch):
    """The VJP of the whole-sequence layer (padded S, so pad positions and
    ``_segsum``'s -inf are in the graph) against ``jax.vjp``: finite, and
    every parameter's gradient and the input's within 1e-5 of its largest
    magnitude."""
    cfg, rp, tcfg, tp = _layer(arch)
    x = _x(cfg, 13, seed=5)
    g = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    rgp, rgx = _r_train_vjp(rp, cfg, jnp.asarray(x), jnp.asarray(g))
    tpg = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = tm.mamba_train(tpg, tcfg, tx)
    grads = torch.autograd.grad(out, [tx, *tpg.values()],
                                torch.from_numpy(g))
    assert all(bool(torch.isfinite(t).all()) for t in grads)
    _rel_close(grads[0], rgx)
    for name, got in zip(tpg, grads[1:]):
        _rel_close(got, rgp[name])


def test_mamba_train_bf16_keeps_the_reference_casts():
    """bf16 parameters and input: the output is bf16 and within a few bf16
    roundings of the reference's bf16 layer."""
    cfg, rp, tcfg, _ = _layer("mamba2-1.3b")
    rpb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), rp)
    tpb = {k: torch.from_numpy(np.asarray(v, np.float32)).bfloat16()
           for k, v in rpb.items()}
    x = _x(cfg, 13, seed=7)
    want = _r_train(rpb, cfg, jnp.asarray(x, jnp.bfloat16))
    got = tm.mamba_train(tpb, tcfg, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _rel_close(got, np.asarray(want, np.float32), rel=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_decode_matches_from_a_nonzero_state(arch):
    cfg, rp, tcfg, tp = _layer(arch)
    rng = np.random.default_rng(11)
    s0 = rm.init_ssm_state(cfg, 2)
    state = rm.SSMState(
        conv=jnp.asarray(rng.standard_normal(s0.conv.shape), jnp.float32),
        ssm=jnp.asarray(rng.standard_normal(s0.ssm.shape), jnp.float32))
    x = _x(cfg, 1, seed=12)
    ry, rs = _r_decode(rp, cfg, jnp.asarray(x), state)
    ty, ts = tm.mamba_decode(tp, tcfg, torch.from_numpy(x), _state(state))
    _rel_close(ty, ry)
    _rel_close(ts.ssm, rs.ssm)
    np.testing.assert_array_equal(ts.conv.numpy(), np.asarray(rs.conv))
    assert ts.conv.dtype == ts.ssm.dtype == torch.float32


def test_init_ssm_state_matches():
    want = rm.init_ssm_state(r_smoke_config("mamba2-1.3b"), 3)
    got = tm.init_ssm_state(smoke_config("mamba2-1.3b"), 3, device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert not bool(g.any())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", [2, 8, 13])
def test_prefill_state_is_the_decode_recurrence(arch, s):
    """S below d_conv - 1 (2: the conv tail zero-filled on the left), one
    chunk (8) and not a chunk multiple (13: pad positions must not decay
    the state): the port's prefill output is ``mamba_train``'s, and its
    state is the reference's ``mamba_decode`` stepped over the S tokens
    from ``init_ssm_state``; one more decode step from either state gives
    the same output."""
    cfg, rp, tcfg, tp = _layer(arch)
    x = _x(cfg, s + 1, seed=20 + s)
    out, st = tm.mamba_prefill(tp, tcfg, torch.from_numpy(x[:, :s]))
    _rel_close(out, _r_train(rp, cfg, jnp.asarray(x[:, :s])))
    rs = rm.init_ssm_state(cfg, 2)
    for t in range(s):
        _, rs = _r_decode(rp, cfg, jnp.asarray(x[:, t:t + 1]), rs)
    assert float(jnp.abs(rs.ssm).max()) > 0
    _rel_close(st.ssm, rs.ssm)
    np.testing.assert_allclose(st.conv.numpy(), np.asarray(rs.conv),
                               atol=1e-6, rtol=0)
    if s < cfg.ssm.d_conv - 1:
        assert not bool(st.conv[:, :cfg.ssm.d_conv - 1 - s].any())
    ry, _ = _r_decode(rp, cfg, jnp.asarray(x[:, s:]), rs)
    ty, _ = tm.mamba_decode(tp, tcfg, torch.from_numpy(x[:, s:]), st)
    _rel_close(ty, ry)


def test_reference_prefill_leaves_the_state_at_zero():
    """``src/repro/models/blocks.py:86-87`` hands a mamba layer's cache back
    unchanged in mode "prefill" (``new_cache = cache``), and no caller
    fills it: after the reference's ``prefill_step`` every SSM and conv
    state is still zero, and its decode step from there is off its own
    prefill over the longer sequence by more than half the largest logit
    (2.70 against 2.36 on these inputs). The port's prefill holds the
    prompt, and its decode step is within 1e-5 of that longer prefill."""
    from repro_torch.models import (decode_step, init_caches,
                                    params_from_reference, prefill_step)

    cfg = r_smoke_config("mamba2-1.3b")
    rp = rmodels.init_params(cfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 13))
    prefill = jax.jit(functools.partial(rmodels.prefill_step, cfg=cfg,
                                        use_kernel=False))
    _, rc = prefill(rp, batch={"tokens": jnp.asarray(toks[:, :12])},
                    caches=rmodels.init_caches(cfg, 2, 16))
    assert float(jnp.abs(rc["pos0"].ssm).max()) == 0.0
    assert float(jnp.abs(rc["pos0"].conv).max()) == 0.0
    longer, _ = prefill(rp, batch={"tokens": jnp.asarray(toks)},
                        caches=rmodels.init_caches(cfg, 2, 16))
    rd, _ = jax.jit(functools.partial(rmodels.decode_step, cfg=cfg))(
        rp, batch={"tokens": jnp.asarray(toks[:, 12:])}, caches=rc)
    scale = float(jnp.abs(longer).max())
    assert float(jnp.abs(rd - longer).max()) > 0.5 * scale

    tcfg = smoke_config("mamba2-1.3b")
    tp = params_from_reference(jax.tree.map(np.asarray, rp), tcfg,
                               device="cpu")
    with torch.no_grad():
        _, tc = prefill_step(tp, tcfg,
                             {"tokens": torch.from_numpy(toks[:, :12])},
                             init_caches(tcfg, 2, 16, device="cpu"))
        td, _ = decode_step(tp, tcfg,
                            {"tokens": torch.from_numpy(toks[:, 12:])}, tc)
    assert all(float(c.ssm.abs().max()) > 0 and float(c.conv.abs().max()) > 0
               for c in tc)
    _rel_close(td, longer)
