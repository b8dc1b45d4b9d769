"""Tensor and sequence parallelism in the port (the ``default``,
``serve_tp`` and ``ep_sharded`` profiles), on the CPU over gloo, against
the JAX package and the port's one-process path.

Under these profiles the ranks of a ``model`` line hold the same slab and
split each layer: attention by heads (the columns gathered where the line
does not divide the heads), the MLPs as Megatron pairs, the vocabulary by
rows, the KV cache by sequence (whole where the line does not divide its
length), the MoE by experts or, under ``ep_sharded`` where the line
divides the sequence, by sequence. One spawn per world (4 and 2 gloo
ranks, both at once, running ``tests/_torch_lm_ranks_worker.py``, which
imports no ``jax``) runs every case of that world while the parent
computes the oracles:

* qwen3-8b's smoke config (4 heads, one kv head of 16 columns: the line
  does not divide the kv heads) under ``serve_tp (1, 4)`` and ``(1, 2)``:
  the prefill's and 3 greedy decode steps' logits within 2e-3 of the
  reference's ``prefill_step`` / ``decode_step`` and of the port's one
  process, the greedy tokens equal, with a cache of 12 positions (3 a
  rank) and of 11 (which stays whole); the cache a rank holds a quarter of
  the one-process cache's, or all of it;
* qwen2-moe's MoE under ``ep_sharded (1, 4)`` and ``(1, 2)`` on both
  paths (48 positions: each rank routes its block of the sequence, drops
  included at capacity factor 0.5,
  against the port's one-process ``moe_apply`` on each block within 1e-5,
  and with capacity factor 16 the reference's global MoE within 2e-3; 9
  positions: every rank routes the slab and runs its experts, the
  reference's global MoE with drops, its metrics exactly), the same
  under ``default (1, 4)``, and serving under ``ep_sharded (1, 4)`` and
  ``default (2, 2)`` (FSDP over ``data`` too) against the reference;
* 2 AdamW steps under ``default (2, 2)``: qwen3-8b plain (oracles at
  ``microbatches=2``), qwen2-moe with int8 compression (the MoE routes the
  global batch: oracles at ``microbatches=1``), against the reference's
  ``make_train_step`` and the port's, to the bounds of
  ``tests/test_torch_lm_ranks.py`` (metrics rtol 1e-5, parameters 1e-4,
  their mean under 1e-6; with int8 against the reference metrics 1e-3,
  parameters 2·lr·steps, their mean under lr/10);
* the input operator (``tp_copy``, through the Megatron MLP) and the
  sequence-split attention's log-sum-exp combine (``sp_attend``): each
  rank's gradients against autograd through the one-process functions,
  within 1e-5;
* the int8 qwen2-moe state saved sharded at ``(2, 2)`` and read whole by
  the reference's ``restore_checkpoint``, bitwise.
"""

import concurrent.futures
import dataclasses
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_ranks_worker as worker
import repro.models as rmodels
from repro.checkpoint import restore_checkpoint as r_restore
from repro.configs import smoke_config as r_smoke_config
from repro.models.moe import moe_apply as _r_moe_apply
from repro.train import AdamWConfig as RAdamWConfig
from repro.train import OptState as ROptState
from repro.train import TrainState as RTrainState
from repro.train import init_train_state as r_init_train_state
from repro.train import make_train_step as r_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.models import (decode_step, init_caches, params_from_reference,
                                prefill_step)
from repro_torch.models.layers import mlp_apply, softcap
from repro_torch.models.moe import moe_apply
from repro_torch.train import AdamWConfig, init_train_state, make_train_step
from repro_torch.train.optimizer import tree_leaves, tree_map

QWEN3, QWEN_MOE = "qwen3-8b", "qwen2-moe-a2.7b"
WORLDS = (4, 2)
SPAWN_LIMIT_S = 150
LR = AdamWConfig().lr
STEPS = 2
PROMPT, GREEDY = 8, 3
r_moe_apply = jax.jit(_r_moe_apply, static_argnums=(1,),
                      static_argnames=("use_kernel",))
# name -> (world, mesh, cache positions)
SERVE = {"split": (4, (1, 4), 12), "whole": (4, (1, 4), 11),
         "two": (2, (1, 2), 12)}
# qwen2-moe served (capacity factor 16): name -> (mesh, profile)
SERVE_MOE = {"moe_ep_sharded": ((1, 4), "ep_sharded"),
             "moe_default": ((2, 2), "default")}
# name -> (world, arch, config change, int8, oracle microbatches, ckpt)
TRAIN = {"qwen3": (4, QWEN3, {}, False, 2, False),
         "moe_int8": (4, QWEN_MOE, {}, True, 1, True)}
# name -> (world, mesh, profile, global batch, sequence, capacity factor)
MOE = {"blocks": (4, (1, 4), "ep_sharded", 4, 48, 0.5),
       "blocks16": (4, (1, 4), "ep_sharded", 4, 48, 16.0),
       "slab": (4, (1, 4), "ep_sharded", 8, 9, 0.5),
       "default": (4, (1, 4), "default", 8, 12, 0.5),
       "two": (2, (1, 2), "ep_sharded", 4, 48, 0.5)}


# ---------------------------------------------------------------------------
# inputs and oracles (parent side)
# ---------------------------------------------------------------------------

def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)


def _cfgs(arch, moe=None, **kw):
    """(reference cfg, port cfg), remat ``block``, the MoE's capacity
    factor ``moe`` when given."""
    kw = {"remat": "block", **kw}
    out = []
    for c in (r_smoke_config(arch), smoke_config(arch)):
        if moe is not None:
            kw["moe"] = dataclasses.replace(c.moe, capacity_factor=moe)
        out.append(dataclasses.replace(c, **kw))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(reference params, port params in float32), one seed."""
    rp = rmodels.init_params(r_smoke_config(arch), jax.random.PRNGKey(0))
    return rp, params_from_reference(jax.tree.map(np.asarray, rp),
                                     smoke_config(arch), device="cpu",
                                     dtype=torch.float32)


def _tokens(arch):
    return np.random.default_rng(21).integers(
        0, smoke_config(arch).vocab, (2, PROMPT + 1))


def _moe_x(seq, batch):
    return np.random.default_rng(seq).standard_normal(
        (batch, seq, smoke_config(QWEN_MOE).d_model)).astype(np.float32)


def _batches(cfg, seed):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab, (2, 16)),
             "labels": rng.integers(0, cfg.vocab, (2, 16))}
            for _ in range(STEPS)]


def _grad_inputs():
    """Seeded whole inputs of the ``tp_grads`` case: an MLP (d 16, d_ff
    32) and one decode token's attention (4 heads, 2 kv heads, 12
    positions)."""
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"x": f(2, 3, 16), "w_up": f(16, 32) / 4, "w_gate": f(16, 32) / 4,
            "w_down": f(32, 16) / 6, "cot_y": f(2, 3, 16),
            "q": f(2, 4, 8), "k": f(2, 12, 2, 8), "v": f(2, 12, 2, 8),
            "cot_att": f(2, 4, 8)}


def _grad_cfg():
    return dataclasses.replace(smoke_config(QWEN3), n_heads=4, n_kv_heads=2,
                               head_dim=8, attn_softcap=5.0)


LIVE = (2, 10)          # the window's and the length's live positions


def _grid(world, root):
    cases = {}
    q3 = _cfgs(QWEN3)[1]
    for name, (w, mesh, max_len) in SERVE.items():
        if w == world:
            cases[("serve", name)] = dict(
                kind="serve", mesh=mesh, profile="serve_tp", cfg=q3,
                params=_np(_model(QWEN3)[1]), tokens=_tokens(QWEN3),
                prompt_len=PROMPT, max_len=max_len, greedy=GREEDY)
    for name, (w, mesh, profile, batch, seq, factor) in MOE.items():
        if w == world:
            cases[("moe", name)] = dict(
                kind="moe", mesh=mesh, profile=profile,
                cfg=_cfgs(QWEN_MOE, factor)[1],
                params=_np(_model(QWEN_MOE)[1]["layers"][0]["moe"]),
                x=_moe_x(seq, batch))
    if world != 4:
        return cases
    for name, (mesh, profile) in SERVE_MOE.items():
        cases[("serve", name)] = dict(
            kind="serve", mesh=mesh, profile=profile,
            cfg=_cfgs(QWEN_MOE, 16.0)[1], params=_np(_model(QWEN_MOE)[1]),
            tokens=_tokens(QWEN_MOE), prompt_len=PROMPT, max_len=12,
            greedy=GREEDY)
    for name, (_, arch, kw, compress, _, ckpt) in TRAIN.items():
        cfg = _cfgs(arch, **kw)[1]
        cases[("train", name)] = dict(
            kind="train", mesh=(2, 2), profile="default", cfg=cfg,
            params=_np(_model(arch)[1]), compress=compress,
            batches=_batches(cfg, 30),
            ckpt_dir=os.path.join(root, name) if ckpt else None)
    cases[("grads",)] = dict(kind="tp_grads", mesh=(1, 4),
                             profile="serve_tp", cfg=_grad_cfg(),
                             inputs=_grad_inputs(), live=LIVE)
    return cases


@functools.lru_cache(maxsize=None)
def _ref_serve(arch, max_len, factor=None):
    """The reference's prefill logits and greedy decode logits."""
    cfg = _cfgs(arch, factor)[0]
    prefill = jax.jit(functools.partial(rmodels.prefill_step, cfg=cfg,
                                        use_kernel=False))
    decode = jax.jit(functools.partial(rmodels.decode_step, cfg=cfg,
                                       use_kernel=False))
    toks = _tokens(arch)
    caches = rmodels.init_caches(cfg, toks.shape[0], max_len)
    logits, caches = prefill(_model(arch)[0],
                             batch={"tokens": jnp.asarray(toks[:, :PROMPT])},
                             caches=caches)
    out = [np.asarray(logits)]
    for _ in range(GREEDY):
        logits, caches = decode(_model(arch)[0],
                                batch={"tokens": logits.argmax(-1)[:, None]},
                                caches=caches)
        out.append(np.asarray(logits))
    return out


@functools.lru_cache(maxsize=None)
def _port_serve(arch, max_len, factor=None):
    """The port's one process: the same as :func:`_ref_serve`."""
    cfg = _cfgs(arch, factor)[1]
    toks = torch.from_numpy(_tokens(arch))
    params = _model(arch)[1]
    with torch.no_grad():
        caches = init_caches(cfg, toks.shape[0], max_len, device="cpu")
        logits, caches = prefill_step(params, cfg,
                                      {"tokens": toks[:, :PROMPT]}, caches)
        out = [logits.numpy()]
        for _ in range(GREEDY):
            logits, caches = decode_step(
                params, cfg, {"tokens": logits.argmax(-1)[:, None]}, caches)
            out.append(logits.numpy())
    return out


@functools.lru_cache(maxsize=None)
def _ref_train(name):
    _, arch, kw, compress, mb, _ = TRAIN[name]
    cfg = _cfgs(arch, **kw)[0]
    state = r_init_train_state(cfg, _model(arch)[0], compress=compress)
    step = jax.jit(r_make_train_step(cfg, RAdamWConfig(warmup_steps=1),
                                     compress_grads=compress,
                                     microbatches=mb))
    metrics = []
    for b in _batches(cfg, 30):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    params = params_from_reference(jax.tree.map(np.asarray, state.params),
                                   cfg, device="cpu")
    return metrics, [p.numpy() for p in tree_leaves(params)]


@functools.lru_cache(maxsize=None)
def _port_train(name):
    _, arch, kw, compress, mb, _ = TRAIN[name]
    cfg = _cfgs(arch, **kw)[1]
    state = init_train_state(cfg, tree_map(lambda t: t.clone(),
                                           _model(arch)[1]),
                             compress=compress)
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1),
                           compress_grads=compress, microbatches=mb)
    metrics = []
    for b in _batches(cfg, 30):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, [p.numpy() for p in tree_leaves(state.params)]


@functools.lru_cache(maxsize=None)
def _ref_moe(factor, seq, batch):
    cfg = _cfgs(QWEN_MOE, factor)[0]
    layer = jax.tree.map(lambda a: a[0],
                         _model(QWEN_MOE)[0]["period"]["pos0"]["moe"])
    y, aux, m = r_moe_apply(layer, cfg, jnp.asarray(_moe_x(seq, batch)),
                            use_kernel=False)
    return np.asarray(y), float(aux), {k: int(v) for k, v in m.items()}


_ROOT = tempfile.mkdtemp(prefix="tp_")


@functools.lru_cache(maxsize=None)
def _run_all():
    """Both worlds' grids, their ranks spawned at once, the oracles
    computed meanwhile."""
    grids = {w: _grid(w, os.path.join(_ROOT, str(w))) for w in WORLDS}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        spawned = {w: pool.submit(worker.spawn, w, list(grids[w].values()),
                                  worker.GROUP_TIMEOUT_S, SPAWN_LIMIT_S)
                   for w in WORLDS}
        jobs = [functools.partial(f, n) for n in TRAIN
                for f in (_ref_train, _port_train)]
        jobs += [functools.partial(f, QWEN3, n) for n in (12, 11)
                 for f in (_ref_serve, _port_serve)]
        jobs += [functools.partial(_ref_serve, QWEN_MOE, 12, 16.0),
                 functools.partial(_ref_moe, 16.0, 48, 4),
                 functools.partial(_ref_moe, 0.5, 9, 8)]
        with concurrent.futures.ThreadPoolExecutor(4) as oracles:
            for f in [oracles.submit(j) for j in jobs]:
                f.result()
        got = {w: f.result() for w, f in spawned.items()}
    out = {}
    for w, cases in grids.items():
        errors = {r: p for r, (s, p) in got[w].items() if s != "ok"}
        assert not errors, "\n".join(f"world {w} rank {r}:\n{p}"
                                     for r, p in errors.items())
        out[w] = ({k: [got[w][r][1][i] for r in range(w)]
                   for i, k in enumerate(cases)}, cases)
    return out


@pytest.fixture(scope="module")
def ranks():
    return lambda world: _run_all()[world]


# ---------------------------------------------------------------------------
# serving: heads, the cache split by sequence or whole
# ---------------------------------------------------------------------------

def _check_serve(per_rank, want, atol, data=1):
    """Every rank's logits (its data rank's rows of ``want``) and greedy
    tokens."""
    for r, got in enumerate(per_rank):
        steps = [got["prefill"]] + got["decode"]
        assert len(steps) == len(want) == 1 + GREEDY
        d, b = r // (len(per_rank) // data), want[0].shape[0] // data
        for g, w in zip(steps, want):
            w = w[d * b:(d + 1) * b]
            np.testing.assert_allclose(g, w, atol=atol, rtol=atol)
            np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("name", list(SERVE))
def test_serve_tp_matches_the_reference(ranks, name):
    world, _, max_len = SERVE[name]
    res, _ = ranks(world)
    _check_serve(res[("serve", name)], _ref_serve(QWEN3, max_len), 2e-3)


@pytest.mark.parametrize("name", list(SERVE))
def test_serve_tp_matches_one_process(ranks, name):
    world, _, max_len = SERVE[name]
    res, _ = ranks(world)
    _check_serve(res[("serve", name)], _port_serve(QWEN3, max_len), 2e-3)


@pytest.mark.parametrize("name", list(SERVE))
def test_cache_is_split_by_sequence_where_the_line_divides_it(ranks, name):
    world, _, max_len = SERVE[name]
    res, _ = ranks(world)
    cfg = smoke_config(QWEN3)
    whole = 2 * cfg.n_layers * 2 * max_len * cfg.n_kv_heads * cfg.hd * 2
    parts = world if max_len % world == 0 else 1
    for got in res[("serve", name)]:
        assert got["cache_bytes"] * parts == whole


@pytest.mark.parametrize("name", list(SERVE_MOE))
def test_moe_serving_matches_the_reference(ranks, name):
    """``ep_sharded``'s prefill routes each rank's block of the sequence,
    its decode steps and ``default`` the slab (over ``data``, the global
    batch): nothing drops at capacity factor 16, so each is the
    reference's global MoE."""
    res, _ = ranks(4)
    _check_serve(res[("serve", name)], _ref_serve(QWEN_MOE, 12, 16.0),
                 2e-3, SERVE_MOE[name][0][0])


# ---------------------------------------------------------------------------
# the MoE's two paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ("blocks", "two"))
def test_sequence_split_moe_is_one_process_blocks(ranks, name):
    """Each rank routes its block of the sequence (its own capacity): the
    output is the blocks' one-process outputs joined, the aux loss their
    mean, the metrics their sum, on every rank."""
    world, mesh = MOE[name][:2]
    res, cases = ranks(world)
    cfg = cases[("moe", name)]["cfg"]
    x = torch.from_numpy(cases[("moe", name)]["x"])
    with torch.no_grad():
        outs = [moe_apply(_model(QWEN_MOE)[1]["layers"][0]["moe"], cfg, c)
                for c in x.chunk(mesh[1], dim=1)]
    y = torch.cat([o[0] for o in outs], 1).numpy()
    aux = float(np.mean([float(o[1]) for o in outs]))
    metrics = {k: sum(int(o[2][k]) for o in outs) for k in outs[0][2]}
    assert metrics["moe/dropped"] > 0          # the blocks' capacity drops
    for got in res[("moe", name)]:
        np.testing.assert_allclose(got["y"], y, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got["aux"], aux, rtol=1e-6)
        assert got["metrics"] == metrics
        assert got["bytes"]["sent"]["a2a"] > 0


@pytest.mark.parametrize("name", ("blocks16", "slab", "default"))
def test_moe_matches_the_reference_global_moe(ranks, name):
    """Nothing drops (capacity factor 16) where each rank routes a block
    (whose aux loss is the blocks' mean, not the global one); where every
    rank routes the slab (9 positions, or ``default``) the capacity is the
    global batch's, drops included: the metrics and the aux loss."""
    world, mesh, _, batch, seq, factor = MOE[name]
    res, _ = ranks(world)
    y, aux, m = _ref_moe(factor, seq, batch)
    if name != "blocks16":
        assert m["moe/dropped"] > 0
    b = y.shape[0] // mesh[0]
    for r, got in enumerate(res[("moe", name)]):
        d = r // mesh[1]
        np.testing.assert_allclose(got["y"], y[d * b:(d + 1) * b],
                                   atol=2e-3, rtol=2e-3)
        assert got["metrics"] == m
        if name != "blocks16":
            np.testing.assert_allclose(got["aux"], aux, rtol=1e-5)
        assert (got["bytes"]["sent"]["a2a"] > 0) == (name == "blocks16")


# ---------------------------------------------------------------------------
# training under default (2, 2)
# ---------------------------------------------------------------------------

def _check_train(got, want_m, want_p, compress, metric_rtol, mean_bound):
    for g in got:
        assert len(g["metrics"]) == len(want_m) == STEPS
        for gm, wm in zip(g["metrics"], want_m):
            for k in ("loss/ce", "loss/aux", "loss/total", "opt/grad_norm"):
                np.testing.assert_allclose(gm[k], wm[k], rtol=metric_rtol,
                                           atol=1e-7, err_msg=k)
        assert g["metrics"] == got[0]["metrics"]
    atol = 2 * LR * STEPS if compress else 1e-4
    diffs = []
    assert len(got[0]["params"]) == len(want_p)
    for a, b in zip(got[0]["params"], want_p):
        np.testing.assert_allclose(a, b, atol=atol, rtol=1e-4)
        diffs.append(np.abs(a - b).ravel())
    assert np.concatenate(diffs).mean() < mean_bound


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_steps_match_the_reference(ranks, name):
    compress = TRAIN[name][3]
    res, _ = ranks(4)
    _check_train(res[("train", name)], *_ref_train(name), compress,
                 metric_rtol=1e-3 if compress else 1e-5,
                 mean_bound=LR / 10 if compress else 1e-6)


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_steps_match_one_process(ranks, name):
    compress = TRAIN[name][3]
    res, _ = ranks(4)
    _check_train(res[("train", name)], *_port_train(name), compress,
                 metric_rtol=1e-5, mean_bound=1e-6)


# ---------------------------------------------------------------------------
# the input operator's and the log-sum-exp combine's gradients
# ---------------------------------------------------------------------------

def _one_process_grads():
    cfg = _grad_cfg()
    g = {k: torch.from_numpy(v).requires_grad_()
         for k, v in _grad_inputs().items()}
    y = mlp_apply({k: g[k] for k in ("w_up", "w_gate", "w_down")}, g["x"],
                  cfg.mlp)
    (y * g["cot_y"]).sum().backward()
    lo, hi = LIVE
    b, h, hd = g["q"].shape
    qg = g["q"].reshape(b, cfg.n_kv_heads, -1, hd)
    logits = torch.einsum("bkrd,bskd->bkrs", qg, g["k"][:, lo:hi]) \
        * hd ** -0.5
    probs = torch.softmax(softcap(logits, cfg.attn_softcap), dim=-1)
    att = torch.einsum("bkrs,bskd->bkrd", probs,
                       g["v"][:, lo:hi]).reshape(b, h, hd)
    (att * g["cot_att"]).sum().backward()
    return y.detach().numpy(), att.detach().numpy(), \
        {k: v.grad.numpy() for k, v in g.items() if v.grad is not None}


@pytest.mark.parametrize("part", ("mlp", "sp"))
def test_gradients_match_autograd_through_one_process(ranks, part):
    res, _ = ranks(4)
    y, att, grads = _one_process_grads()
    world = 4
    for r, got in enumerate(res[("grads",)]):
        if part == "mlp":
            got = got["mlp"]
            f = grads["w_up"].shape[1] // world
            np.testing.assert_allclose(got["y"], y, atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(got["x"], grads["x"], atol=1e-5,
                                       rtol=1e-5)
            for k, sl in (("w_up", np.s_[:, r * f:(r + 1) * f]),
                          ("w_gate", np.s_[:, r * f:(r + 1) * f]),
                          ("w_down", np.s_[r * f:(r + 1) * f])):
                np.testing.assert_allclose(got[k], grads[k][sl], atol=1e-5,
                                           rtol=1e-5, err_msg=k)
        else:
            got = got["sp"]
            h = att.shape[1] // world
            span = grads["k"].shape[1] // world
            heads, block = np.s_[:, r * h:(r + 1) * h], \
                np.s_[:, r * span:(r + 1) * span]
            np.testing.assert_allclose(got["out"], att[heads], atol=1e-5,
                                       rtol=1e-5)
            np.testing.assert_allclose(got["q"], grads["q"][heads],
                                       atol=1e-5, rtol=1e-5)
            for k in ("k", "v"):
                np.testing.assert_allclose(got[k], grads[k][block],
                                           atol=1e-5, rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_sharded_checkpoint_reads_back_whole(ranks):
    res, cases = ranks(4)
    case = cases[("train", "moe_int8")]
    got = res[("train", "moe_int8")]
    whole = _np(_model(QWEN_MOE)[1])
    zeros = lambda t: jax.tree.map(lambda a: np.zeros_like(a, np.float32), t)
    template = RTrainState(params=whole,
                           opt=ROptState(mu=zeros(whole), nu=zeros(whole),
                                         step=np.zeros((), np.int32)),
                           residual=zeros(whole))
    start = r_restore(case["ckpt_dir"], template, step=0)
    for a, b in zip(jax.tree.leaves(start), jax.tree.leaves(template)):
        np.testing.assert_array_equal(np.asarray(a), b)
    end = r_restore(case["ckpt_dir"], template, step=1)
    for a, b in zip(jax.tree.leaves(end.params), got[0]["params"]):
        np.testing.assert_array_equal(np.asarray(a), b)
    for g in got:
        assert g["restored_equal"] is True
