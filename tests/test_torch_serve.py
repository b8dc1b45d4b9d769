"""The port's LM serving path against the reference, on the CPU.

The smoke configs of qwen2-moe-a2.7b (attention + MoE, shared experts),
gemma2-2b (sliding window, attention and logit softcaps, GeGLU) and qwen3-8b
(qk-norm, GQA) run through ``block_apply``, ``prefill_step`` /
``decode_step`` and ``ServeEngine.generate`` in both packages, with the
reference's weights handed over by ``params_from_reference``. The
reference runs its default serving path (``use_kernel=False``: chunked
attention and the einsum grouped GEMM); the port runs its plain versions on
CPU tensors. The kernels themselves are held against the reference in
``test_torch_flash_attention.py`` and ``test_torch_moe_gemm.py``.

Tolerances: one block's output within 1e-4 (float32 smoke configs, the
summation order differs); logits within 2e-2, the bf16-KV-cache tolerance
of ``tests/test_serving_consistency.py``; greedy tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as rmodels
import repro.models.blocks as rblocks
from repro.configs import smoke_config as r_smoke_config
from repro.serve import ServeEngine as RServeEngine
from repro_torch.configs import smoke_config
from repro_torch.models import (decode_step, init_caches, init_params,
                                params_from_reference, prefill_step)
from repro_torch.models.blocks import block_apply
from repro_torch.models.attention import init_kv_cache
from repro_torch.serve import ServeEngine
import repro_torch.serve.engine as engine_mod

ARCHS = ("qwen2-moe-a2.7b", "gemma2-2b", "qwen3-8b")
PROMPTS = [np.array([5, 17, 3, 99, 42, 7], np.int32),
           np.array([11, 64, 2], np.int32)]


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _big_capacity(cfg):
    """Capacity drops differ between an S-token prefill and a 1-token
    decode; a large capacity isolates numerics from the drop policy."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))


_CACHE = {}


def _models(arch):
    """(cfg, reference params, port params) for an arch's smoke config."""
    if arch not in _CACHE:
        cfg = r_smoke_config(arch)
        rp = rmodels.init_params(cfg, jax.random.PRNGKey(0))
        tp = params_from_reference(_np_tree(rp), cfg, device="cpu")
        _CACHE[arch] = (cfg, rp, tp)
    return _CACHE[arch]


def test_configs_match_the_reference():
    from repro.configs import get_config as r_get_config
    from repro.configs import list_archs as r_list_archs
    from repro_torch.configs import get_config, list_archs
    assert list_archs() == r_list_archs()
    for arch in list_archs():
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(r_get_config(arch))
        assert dataclasses.asdict(smoke_config(arch)) == \
            dataclasses.asdict(r_smoke_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_block_apply_prefill_matches(arch):
    cfg, rp, tp = _models(arch)
    x = np.random.default_rng(1).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    for i, kind in enumerate(cfg.pattern):
        lp = jax.tree.map(lambda a: a[0], rp["period"][f"pos{i}"])
        rc = rblocks.block_cache_init(cfg, kind, 2, 16)
        rh, rcache, raux = rblocks.block_apply(
            lp, cfg, kind, jnp.asarray(x), rc, "prefill", use_kernel=False)
        th, tcache, taux = block_apply(
            tp["layers"][i], cfg, kind, torch.from_numpy(x),
            init_kv_cache(cfg, 2, 16, device="cpu"), "prefill")
        np.testing.assert_allclose(th.numpy(), np.asarray(rh), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(float(taux), float(raux), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_array_equal(
            tcache.k.float().numpy(), np.asarray(rcache.k, np.float32))
        assert tcache.length == int(rcache.length) == 12


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match(arch):
    cfg, rp, tp = _models(arch)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 9))
    rc = rmodels.init_caches(cfg, 2, 16)
    rl, rc = rmodels.prefill_step(rp, cfg, {"tokens": jnp.asarray(
        toks[:, :8])}, rc, use_kernel=False)
    rd, _ = rmodels.decode_step(rp, cfg, {"tokens": jnp.asarray(
        toks[:, 8:])}, rc, use_kernel=False)
    tc = init_caches(cfg, 2, 16, device="cpu")
    tl, tc = prefill_step(tp, cfg, {"tokens": torch.from_numpy(
        toks[:, :8])}, tc)
    td, tc = decode_step(tp, cfg, {"tokens": torch.from_numpy(
        toks[:, 8:])}, tc)
    assert tl.dtype == td.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(td.numpy(), np.asarray(rd), atol=2e-2,
                               rtol=2e-2)
    assert all(c.length == 9 for c in tc)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """prefill(n) + decode(token n+1) == prefill(n+1), last position."""
    cfg = _big_capacity(r_smoke_config(arch))
    tp = params_from_reference(
        _np_tree(rmodels.init_params(cfg, jax.random.PRNGKey(0))), cfg,
        device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (2, 9)))
    c1 = init_caches(cfg, 2, 16, device="cpu")
    _, c1 = prefill_step(tp, cfg, {"tokens": toks[:, :8]}, c1)
    ld, _ = decode_step(tp, cfg, {"tokens": toks[:, 8:9]}, c1)
    lp, _ = prefill_step(tp, cfg, {"tokens": toks},
                         init_caches(cfg, 2, 16, device="cpu"))
    np.testing.assert_allclose(ld.numpy(), lp.numpy(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_tokens(arch):
    cfg, rp, tp = _models(arch)
    want = RServeEngine(cfg, rp, max_len=32, batch_slots=2).generate(
        PROMPTS, max_new_tokens=8, sync_every=0)
    got = ServeEngine(cfg, tp, max_len=32, batch_slots=2,
                      device="cpu").generate(PROMPTS, max_new_tokens=8,
                                             sync_every=0)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert got.prefill_len == want.prefill_len == 6


def _engine(eos_id=-1, slots=2):
    cfg, _, tp = _models("qwen2-moe-a2.7b")
    return ServeEngine(cfg, tp, max_len=32, batch_slots=slots, eos_id=eos_id,
                       device="cpu")


def test_generate_empty_and_greedy_repeat():
    r = _engine().generate([])
    assert r.tokens.shape == (0, 0) and r.lengths.shape == (0,)
    assert r.prefill_len == 0
    eng = _engine()
    r1 = eng.generate(PROMPTS, max_new_tokens=6)
    r2 = eng.generate(PROMPTS, max_new_tokens=6)
    np.testing.assert_array_equal(r1.tokens, r2.tokens)
    assert r1.tokens.shape == (2, 6)


def test_generate_eos_accounting():
    """Lengths exclude EOS and every slot after a request's EOS reads
    eos_id (the reference's fixed semantics)."""
    base = _engine(eos_id=-2).generate(PROMPTS, max_new_tokens=8,
                                       sync_every=0)
    assert base.lengths.tolist() == [8, 8]
    eos = int(base.tokens[0, base.tokens.shape[1] // 2])
    res = _engine(eos_id=eos).generate(PROMPTS, max_new_tokens=8,
                                       sync_every=0)
    for i in range(2):
        row, want = res.tokens[i], base.tokens[i]
        hits = np.nonzero(want[:res.tokens.shape[1]] == eos)[0]
        length = int(hits[0]) if hits.size else res.tokens.shape[1]
        assert int(res.lengths[i]) == length          # EOS excluded
        np.testing.assert_array_equal(row[:length], want[:length])
        assert (row[length:] == eos).all()            # post-EOS masked
    assert (res.lengths < 8).any()                    # the EOS really fired


def test_generate_sync_every_equivalent(monkeypatch):
    """Identical tokens at any probe cadence; one host copy per probe plus
    one for the token matrix."""
    eng = _engine()
    ref = eng.generate(PROMPTS, max_new_tokens=8, sync_every=0)
    for sync_every in (1, 3, 8):
        got = eng.generate(PROMPTS, max_new_tokens=8, sync_every=sync_every)
        np.testing.assert_array_equal(got.tokens, ref.tokens)
        np.testing.assert_array_equal(got.lengths, ref.lengths)

    copies = []
    real = engine_mod._to_host

    def counting(t):
        copies.append(tuple(t.shape))
        return real(t)

    monkeypatch.setattr(engine_mod, "_to_host", counting)
    eng.generate(PROMPTS, max_new_tokens=8, sync_every=4)
    # 8 steps probed every 4: one in-loop probe (the step-8 boundary is the
    # loop's natural end), then the one copy of the (2, 8) token matrix
    assert copies == [(), (2, 8)]


def test_generate_samples_from_a_seeded_generator():
    eng = _engine()
    a = eng.generate(PROMPTS, max_new_tokens=6, greedy=False, seed=5)
    b = eng.generate(PROMPTS, max_new_tokens=6, greedy=False, seed=5)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert ((0 <= a.tokens) & (a.tokens < 128)).all()


def test_init_params_shapes_and_dtype():
    cfg = smoke_config("qwen2-moe-a2.7b")
    rp = rmodels.init_params(cfg, jax.random.PRNGKey(0))
    tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                     dtype=torch.bfloat16)
    ref = params_from_reference(_np_tree(rp), cfg, device="cpu")
    assert len(tp["layers"]) == cfg.n_layers
    flat_t = jax.tree_util.tree_flatten_with_path(tp)[0]
    flat_r = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(flat_t) == len(flat_r)
    for path, leaf in flat_t:
        assert leaf.dtype == torch.bfloat16
        assert leaf.shape == flat_r[path].shape, path
    up = tp["layers"][0]["moe"]["experts_up"].float()
    assert up.abs().max() <= 2 * cfg.d_model ** -0.5 + 1e-3   # truncated


def test_cuda_engine_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, _, tp = _models("qwen3-8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, tp)
