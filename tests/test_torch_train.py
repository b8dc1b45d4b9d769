"""The port's training path against the reference, on the CPU.

Same numpy inputs and seeds into both packages; the reference's weights and
train state reach the port through ``params_from_reference`` /
``train_state_from_reference``. The port runs each kernel's plain version
on CPU tensors, inside its ``torch.autograd.Function``.

* ``attention_chunked``: output and VJP against the reference's
  (GQA pre-repeated, window, softcap; S at, below and twice the 1024 chunk),
  within atol 1e-5, rtol 1e-5 (float32, the same recurrence); a ragged S
  raises.
* ``multihead_attention``'s Function: output and (dq, dk, dv) against the
  reference's custom VJP with ``use_kernel=True, interpret=True`` (the
  Pallas kernel in interpret mode) and ``use_kernel=False``, GQA, a window
  and a softcap, within atol 2e-5, rtol 1e-4 in float32 (the reference's
  kernel tolerance); bfloat16 through the plain path within 3e-2.
* ``grouped_gemm``'s Function: output and (dx, dw) against the reference's
  (interpret-mode kernel and einsum), d padded to at most 512 or to 512
  (the Pallas kernel drops the last ``d % 512`` columns otherwise), within
  atol 2e-4, rtol 1e-4; with ``rows``, against the port's plain version
  differentiated by autograd within 1e-6.
* ``loss_fn``: the loss and its metrics within rtol 1e-5, every leaf's
  gradient within 1e-5 of that leaf's largest magnitude (float32 smoke
  configs: summation orders differ), on qwen2-moe-a2.7b, phi3.5-moe,
  qwen3-8b, gemma2-2b (window and both softcaps) and pixtral-12b
  (``embeds``); the chunked cross entropy at 1, 2 and 4 chunks;
  ``train_logits`` within 1e-5.
* ``make_train_step``: three steps from the same state in both packages,
  one batch and two microbatches with int8 gradient compression, metrics
  and parameters within the tolerances its docstring states and argues.
* ``make_eval_step`` against the reference's; ``make_prefill_step`` /
  ``make_decode_step`` are the model's steps.
* ``remat="block"`` is bitwise ``"none"`` (loss and every gradient);
  ``"dots"`` (ported; held against the reference in
  ``test_torch_remat_dots.py``) is bitwise ``"block"``, and a policy
  neither package defines raises. The mamba kinds are held in
  ``test_torch_mamba_models.py``.
* What the training path hands the kernels on a card passes their argument
  checks (bf16 at head dim 128), with each kernel called twice per layer
  under block remat (forward and recompute): the launch counts the chip run
  expects.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as rmodels
from repro.configs import smoke_config as r_smoke_config
from repro.data import SyntheticLMDataset as RDataset
from repro.kernels.flash_attention import \
    multihead_attention as r_multihead_attention
from repro.kernels.flash_attention.chunked import \
    attention_chunked as r_attention_chunked
from repro.kernels.moe_gemm import grouped_gemm as r_grouped_gemm
from repro.train import AdamWConfig as RAdamWConfig
from repro.train import init_train_state as r_init_train_state
from repro.train import make_train_step as r_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.flash_attention import multihead_attention
from repro_torch.kernels.flash_attention.chunked import attention_chunked
from repro_torch.kernels.moe_gemm import grouped_gemm
from repro_torch.kernels.moe_gemm import kernel as mkernel
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.models import (init_params, loss_fn, params_from_reference,
                                train_logits, train_state_from_reference)
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.step import _grads

ARCHS = ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b", "qwen3-8b", "gemma2-2b",
         "pixtral-12b")


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _leaf_close(got, want, rel=1e-5):
    """Every element within ``rel`` of the leaf's largest magnitude."""
    want = torch.as_tensor(np.asarray(want))
    scale = float(want.abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * scale + 1e-12, (err, scale)


# --------------------------------------------------------------------------
# attention: the chunked recurrence and the Function
# --------------------------------------------------------------------------

def _qkv(b, s, hq, hkv, d, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, s, hq, d)).astype(np.float32),
            r.standard_normal((b, s, hkv, d)).astype(np.float32),
            r.standard_normal((b, s, hkv, d)).astype(np.float32),
            r.standard_normal((b, s, hq, d)).astype(np.float32))


def _torch_vjp(fn, g, *xs):
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g).to(out.dtype))
    return out, grads


@pytest.mark.parametrize("s,chunk,window,softcap", [
    (256, 1024, 0, 0.0), (512, 128, 64, 30.0), (2048, 1024, 0, 0.0)])
def test_attention_chunked_matches_the_reference(s, chunk, window, softcap):
    q, k, v, g = _qkv(1, s, 2, 2, 16, seed=s)
    kw = dict(scale=0.25, causal=True, window=window, softcap=softcap,
              chunk=chunk)
    out, grads = _torch_vjp(lambda *t: attention_chunked(*t, **kw), g,
                            q, k, v)
    want, vjp = jax.vjp(lambda *t: r_attention_chunked(*t, **kw),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(out, want, 1e-5, 1e-5)
    for a, b in zip(grads, vjp(jnp.asarray(g))):
        _close(a, b, 1e-5, 1e-5)


def test_attention_chunked_refuses_a_ragged_sequence():
    q = torch.zeros(1, 1536, 2, 8)
    with pytest.raises(ValueError, match="not a multiple"):
        attention_chunked(q, q, q, chunk=1024)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("s,hq,hkv,d,window,softcap", [
    (256, 4, 2, 16, 0, 0.0), (256, 4, 1, 32, 64, 30.0),
    (128, 2, 2, 64, 0, 20.0)])
def test_attention_function_matches_the_reference_vjp(use_kernel, s, hq, hkv,
                                                      d, window, softcap):
    q, k, v, g = _qkv(2, s, hq, hkv, d, seed=d)
    scale = d ** -0.5
    out, grads = _torch_vjp(
        lambda *t: multihead_attention(*t, scale, True, window, softcap), g,
        q, k, v)
    want, vjp = jax.vjp(
        lambda *t: r_multihead_attention(*t, scale, True, window, softcap,
                                         use_kernel, True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(out, want, 2e-5, 1e-4)
    for a, b, x in zip(grads, vjp(jnp.asarray(g)), (q, k, v)):
        assert a.shape == x.shape
        _close(a, b, 2e-5, 1e-4)


def test_attention_function_bf16_matches_the_reference_vjp():
    q, k, v, g = _qkv(1, 256, 4, 2, 32, seed=3)
    out, grads = _torch_vjp(
        lambda *t: multihead_attention(*(x.bfloat16() for x in t),
                                       32 ** -0.5, True, 0, 0.0), g, q, k, v)
    want, vjp = jax.vjp(
        lambda *t: r_multihead_attention(*t, 32 ** -0.5, True, 0, 0.0,
                                         False, True),
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    _close(out, np.asarray(want, np.float32), 3e-2, 3e-2)
    for a, b in zip(grads, vjp(jnp.asarray(g, jnp.bfloat16))):
        _close(a, np.asarray(b, np.float32), 3e-2, 3e-2)


# --------------------------------------------------------------------------
# grouped GEMM: the Function
# --------------------------------------------------------------------------

def _xwg(e, cap, d, f, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((e, cap, d)).astype(np.float32),
            r.standard_normal((e, d, f)).astype(np.float32),
            r.standard_normal((e, cap, f)).astype(np.float32))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("e,cap,d,f", [(2, 64, 64, 128), (4, 96, 200, 72),
                                       (3, 8, 512, 136)])
def test_grouped_gemm_function_matches_the_reference_vjp(use_kernel, e, cap,
                                                         d, f):
    x, w, g = _xwg(e, cap, d, f, seed=d)
    out, (dx, dw) = _torch_vjp(grouped_gemm, g, x, w)
    want, vjp = jax.vjp(
        lambda a, b: r_grouped_gemm(a, b, use_kernel=use_kernel,
                                    interpret=True),
        jnp.asarray(x), jnp.asarray(w))
    rdx, rdw = vjp(jnp.asarray(g))
    _close(out, want, 2e-4, 1e-4)
    _close(dx, rdx, 2e-4, 1e-4)
    _close(dw, rdw, 2e-4, 1e-4)


@pytest.mark.parametrize("rows", [[64, 0, 17, 3], [0, 0, 0, 0],
                                  [64, 64, 64, 64]])
def test_grouped_gemm_rows_gradient_is_the_forwards(rows):
    """Rows past ``rows[e]`` are zeros in the forward: the Function's
    gradient is autograd's through the plain version with the same
    ``rows``."""
    x, w, g = _xwg(4, 64, 40, 24, seed=1)
    r = torch.tensor(rows, dtype=torch.int32)
    out, (dx, dw) = _torch_vjp(lambda a, b: grouped_gemm(a, b, r), g, x, w)
    pout, (pdx, pdw) = _torch_vjp(lambda a, b: moe_gemm_ref(a, b, r), g,
                                  x, w)
    for a, b in ((out, pout), (dx, pdx), (dw, pdw)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    dead = torch.arange(64)[None, :] >= r[:, None]
    assert not dx[dead].any()


# --------------------------------------------------------------------------
# the loss and its gradient
# --------------------------------------------------------------------------

_CACHE = {}


def _case(arch, seq=64, batch=2):
    key = (arch, seq, batch)
    if key not in _CACHE:
        cfg = r_smoke_config(arch)
        rp = rmodels.init_params(cfg, jax.random.PRNGKey(0))
        ds = RDataset(cfg.vocab, seq, batch, seed=1,
                      input_kind=cfg.input_kind, d_model=cfg.d_model)
        b = ds.batch(0)
        tp = params_from_reference(jax.tree.map(np.asarray, rp), cfg,
                                   device="cpu")
        _CACHE[key] = (cfg, rp, tp, b)
    return _CACHE[key]


def _torch_batch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    out["tokens"] = out["tokens"].long()
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match(arch):
    cfg, rp, tp, b = _case(arch)
    (rl, rmet), rg = jax.value_and_grad(rmodels.loss_fn, has_aux=True)(
        rp, cfg, {k: jnp.asarray(v) for k, v in b.items()},
        use_kernel=False)
    grads, met = _grads(cfg, tp, _torch_batch(b))
    assert sorted(met) == sorted(rmet)
    for k in rmet:
        _close(met[k], rmet[k], 1e-7, 1e-5)
    want = params_from_reference(jax.tree.map(np.asarray, rg), cfg,
                                 device="cpu")
    assert len(grads) == len(tree_leaves(want))
    for a, w in zip(grads, tree_leaves(want)):
        assert a.shape == w.shape and a.dtype == torch.float32
        _leaf_close(a, w)


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_chunked_cross_entropy_matches(chunks):
    cfg, rp, tp, b = _case("gemma2-2b", seq=512, batch=1)
    rl, _ = rmodels.loss_fn(rp, cfg, {k: jnp.asarray(v) for k, v in
                                      b.items()},
                            use_kernel=False, loss_chunks=chunks)
    with torch.no_grad():
        tl, _ = loss_fn(tp, cfg, _torch_batch(b), loss_chunks=chunks)
        auto, _ = loss_fn(tp, cfg, _torch_batch(b))   # S 512: 2 chunks
    _close(tl, rl, 1e-7, 1e-5)
    _close(auto, rl, 1e-7, 1e-5)


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma2-2b"])
def test_train_logits_match(arch):
    cfg, rp, tp, b = _case(arch)
    rlog, raux = rmodels.train_logits(
        rp, cfg, {k: jnp.asarray(v) for k, v in b.items()}, use_kernel=False)
    with torch.no_grad():
        tlog, taux = train_logits(tp, cfg, _torch_batch(b))
    assert tlog.dtype == torch.float32 and tlog.shape == rlog.shape
    _close(tlog, rlog, 1e-5, 1e-5)
    _close(taux, raux, 1e-7, 1e-5)


# --------------------------------------------------------------------------
# train steps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches,compress", [(1, False), (2, True)])
def test_train_steps_match_the_reference(microbatches, compress):
    """Three steps of qwen2-moe-a2.7b's smoke config at lr 1e-4 from one
    state in both packages. The gradients agree to ~1e-6
    (``test_loss_and_gradients_match``), but AdamW divides each moment by
    its sqrt(v), so an element whose gradient is near 0 may move by up to
    lr on a difference in its last bits. Without compression: each step's
    metrics within rtol 1e-5, every parameter within 1e-4 of its leaf's
    largest magnitude. With int8 compression and two microbatches, an
    element that lies on a rounding boundary of its int8 grid can round to
    the next grid step in one package and not the other (the quantization
    itself is bitwise: ``test_torch_train_runtime.py``), which moves the
    global norm and, through AdamW, that parameter by up to about lr a
    step: metrics within rtol 1e-3, parameters within 2·lr a step."""
    arch, lr, steps = "qwen2-moe-a2.7b", 1e-4, 3
    cfg = r_smoke_config(arch)
    rp = rmodels.init_params(cfg, jax.random.PRNGKey(0))
    rs = r_init_train_state(cfg, rp, compress=compress)
    ts = train_state_from_reference(jax.tree.map(np.asarray, rs), cfg,
                                    device="cpu")
    opt = dict(lr=lr, warmup_steps=1, total_steps=10)
    rstep = jax.jit(r_make_train_step(
        cfg, RAdamWConfig(**opt), compress_grads=compress,
        microbatches=microbatches))
    tstep = make_train_step(cfg, AdamWConfig(**opt), compress_grads=compress,
                            microbatches=microbatches)
    metric_rtol = 1e-3 if compress else 1e-5
    ds = RDataset(cfg.vocab, 32, 4, seed=2)
    for i in range(steps):
        b = ds.batch(i)
        rs, rmet = rstep(rs, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tmet = tstep(ts, _torch_batch(b))
        assert sorted(tmet) == sorted(rmet)
        for k in rmet:
            _close(tmet[k], rmet[k], 1e-7, metric_rtol)
    assert int(ts.opt.step) == int(rs.opt.step) == steps
    want = params_from_reference(jax.tree.map(np.asarray, rs.params), cfg,
                                 device="cpu")
    for a, w in zip(tree_leaves(ts.params), tree_leaves(want)):
        if compress:
            _close(a, w.numpy(), 2 * lr * steps, 0.0)
        else:
            _leaf_close(a, w, rel=1e-4)
    if compress:
        assert all(torch.isfinite(r).all() and r.abs().max() > 0
                   for r in tree_leaves(ts.residual))


def test_eval_prefill_and_decode_steps_match():
    """``make_eval_step`` gives the reference's eval metrics (within rtol
    1e-5); ``make_prefill_step`` / ``make_decode_step`` are the model's
    steps under no_grad."""
    from repro.train import make_eval_step as r_make_eval_step
    from repro_torch.models import decode_step, init_caches, prefill_step
    from repro_torch.train import (make_decode_step, make_eval_step,
                                   make_prefill_step)

    cfg, rp, tp, b = _case("qwen3-8b")
    want = r_make_eval_step(cfg, use_kernel=False)(
        rp, {k: jnp.asarray(v) for k, v in b.items()})
    got = make_eval_step(cfg)(tp, _torch_batch(b))
    for k in want:
        _close(got[k], want[k], 1e-7, 1e-5)
    toks = _torch_batch(b)["tokens"][:, :8]
    lp, caches = make_prefill_step(cfg)(tp, {"tokens": toks},
                                        init_caches(cfg, 2, 9, device="cpu"))
    assert not lp.requires_grad
    with torch.no_grad():
        wp, wc = prefill_step(tp, cfg, {"tokens": toks},
                              init_caches(cfg, 2, 9, device="cpu"))
    assert torch.equal(lp, wp)
    ld, _ = make_decode_step(cfg)(tp, {"tokens": toks[:, :1]}, caches)
    with torch.no_grad():
        wd, _ = decode_step(tp, cfg, {"tokens": toks[:, :1]}, wc)
    assert torch.equal(ld, wd)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "gemma2-2b"])
def test_block_remat_is_bitwise_none(arch):
    cfg, _, tp, b = _case(arch)
    got = {}
    for remat in ("none", "block"):
        c = dataclasses.replace(cfg, remat=remat)
        got[remat] = _grads(c, tp, _torch_batch(b))
    (g0, m0), (g1, m1) = got["none"], got["block"]
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, c) for a, c in zip(g0, g1))


def test_unported_remat_dots_raises():
    """"dots" is ported: it runs, bitwise "block"; only a policy that is
    not one of the port's raises."""
    cfg, _, tp, b = _case("qwen3-8b")
    with pytest.raises(ValueError, match="remat 'full'"):
        loss_fn(tp, dataclasses.replace(cfg, remat="full"), _torch_batch(b))
    (g0, m0), (g1, m1) = (
        _grads(dataclasses.replace(cfg, remat=r), tp, _torch_batch(b))
        for r in ("block", "dots"))
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, c) for a, c in zip(g0, g1))


# --------------------------------------------------------------------------
# what a card's kernels would be handed
# --------------------------------------------------------------------------

def test_train_hands_the_kernels_arguments_they_accept(monkeypatch):
    """A bf16 training step at head dim 128 under block remat, every kernel
    call checked as a card launch would be: attention twice per layer,
    each MoE GEMM twice (forward and the backward's recompute), q, k and v
    contiguous, ``rows`` on every GEMM."""
    attn, gemm = [], []
    inner_a, inner_m = fkernel.flash_attention, mkernel.moe_gemm

    def checked_attn(q, k, v, **kw):
        fkernel.check_launch_args(q, k, v, torch.empty_like(q))
        attn.append(fkernel.route(q.dtype, q.shape[3]))
        return inner_a(q, k, v, **kw)

    def checked_gemm(x, w, rows=None):
        out = torch.empty(x.shape[0], x.shape[1], w.shape[2], dtype=x.dtype)
        mkernel.check_launch_args(x, w, out, rows)
        assert rows is not None
        gemm.append(mkernel.route(x.dtype, x.shape[1]))
        return inner_m(x, w, rows)

    monkeypatch.setattr(fkernel, "flash_attention", checked_attn)
    monkeypatch.setattr(mkernel, "moe_gemm", checked_gemm)
    cfg = dataclasses.replace(smoke_config("qwen2-moe-a2.7b"), head_dim=128,
                              n_layers=2, dtype="bfloat16", remat="block")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    b = RDataset(cfg.vocab, 64, 2, seed=0).batch(0)
    grads, met = _grads(cfg, params, _torch_batch(b))
    assert torch.isfinite(met["loss/total"])
    assert all(torch.isfinite(g).all() for g in grads)
    assert attn == ["tc"] * (2 * cfg.n_layers)
    assert gemm == ["prefill"] * (6 * cfg.n_layers)
