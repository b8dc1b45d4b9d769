"""FSDP over ``data > 1`` in the port, on the CPU over gloo, against the
JAX package and the port's one-process path.

The parameters the reference's rules table splits over ``fsdp`` (the
embedding, attention's and the MLPs' projections, the router, mamba's in
and out projections) are each rank's slices; the model gathers each
layer's inside its body (``collectives.fsdp_gather``: the float32 master
cast to the compute dtype, then gathered; backward a float32
reduce-scatter). One spawn per world (2 and 4 gloo ranks, both at once,
running ``tests/_torch_lm_ranks_worker.py``, which imports no ``jax``)
runs every case of that world while the parent computes the oracles:

* the gather alone on ``(2, 1)`` and ``(4, 1)``, two leaves in one call,
  one along dim 0 and one along dim 1: its forward each whole leaf, each
  slice cast to bf16 as ``jnp.astype`` casts it, bitwise; its backward
  each rank's block of the bf16 cotangents summed in float32 in member
  order, bitwise, in float32; the wire's bytes bf16 forward, float32
  backward, one call each way;
* three AdamW steps (lr 3e-4 from the first) at smoke sizes, remat
  ``block``: qwen2-moe-a2.7b under ``ep_dp (2, 2)`` (FSDP and expert
  parallelism together), once with int8 compression; musicgen-large under
  ``dp_only (4, 1)``; mamba2-1.3b under ``dp_only (2, 1)``. Each against
  the reference's ``make_train_step`` and the port's, both one process at
  ``microbatches=world`` on the global batch, to the tolerances of
  ``tests/test_torch_lm_ranks.py``: metrics rtol 1e-5, parameters 1e-4
  and their mean difference under 1e-6; with compression (an element on a
  rounding boundary of its int8 grid may round apart) the reference's
  metrics rtol 1e-3, parameters 2·lr·steps, their mean under lr/10;
* prefill and decode logits under ``ep_dp (2, 2)`` (qwen2-moe, against the
  reference's ``prefill_step`` / ``decode_step`` on each rank's slab: its
  experts route with the slab's capacity) and ``dp_only (4, 1)``
  (musicgen-large, the global batch's rows), within 2e-2 (the tolerance of
  ``tests/test_torch_serve.py``), and the greedy tokens equal;
* the wire under remat ``block`` and ``none`` (musicgen-large, bf16
  compute, ``(4, 1)``): one gather a layer, of its 7 leaves, in bf16, and
  the embedding's in float32; under ``block`` the backward's recompute
  gathers every layer again and no gathered layer leaf is alive between
  the forward and the backward, under ``none`` all of them are and nothing
  is gathered again; bytes and calls exactly;
* the compressed qwen2-moe state saved sharded at ``(2, 2)`` and read whole
  by the reference's ``restore_checkpoint``, bitwise; a one-process state
  written by the reference's ``save_checkpoint`` restored with
  ``sharding_tree=`` at ``(4, 1)``: each rank's slices bitwise.
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
from repro.checkpoint import save_checkpoint as r_save
from repro.configs import smoke_config as r_smoke_config
from repro.train import AdamWConfig as RAdamWConfig
from repro.train import OptState as ROptState
from repro.train import TrainState as RTrainState
from repro.train import init_train_state as r_init_train_state
from repro.train import make_train_step as r_make_train_step
from repro_torch.checkpoint.store import _leaves as _paths
from repro_torch.configs import smoke_config
from repro_torch.models import params_from_reference
from repro_torch.sharding import ShardingRules, leaf_pspecs
from repro_torch.sharding.placement import local_slice
from repro_torch.train import AdamWConfig, init_train_state, make_train_step
from repro_torch.train.optimizer import tree_leaves, tree_map

QWEN, MUSICGEN, MAMBA = "qwen2-moe-a2.7b", "musicgen-large", "mamba2-1.3b"
WORLDS = (2, 4)
SPAWN_LIMIT_S = 300
LR = AdamWConfig().lr
STEPS = 3
# name -> (world, arch, profile, mesh, int8 compression, a checkpoint)
TRAIN = {
    "qwen_ep_dp": (4, QWEN, "ep_dp", (2, 2), False, False),
    "qwen_ep_dp_int8": (4, QWEN, "ep_dp", (2, 2), True, True),
    "musicgen_dp_only": (4, MUSICGEN, "dp_only", (4, 1), False, False),
    "mamba2_dp_only": (2, MAMBA, "dp_only", (2, 1), False, False),
}
# name -> (world, arch, profile, mesh)
SERVE = {
    "qwen_ep_dp": (4, QWEN, "ep_dp", (2, 2)),
    "musicgen_dp_only": (4, MUSICGEN, "dp_only", (4, 1)),
}
GATHER_SHAPES = ((3, 5), (5, 3))       # gathered along dims 0 and 1


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


def _cfgs(arch, **kw):
    """(reference cfg, port cfg), remat ``block`` and ``kw`` on both."""
    kw = {"remat": "block", **kw}
    return (dataclasses.replace(r_smoke_config(arch), **kw),
            dataclasses.replace(smoke_config(arch), **kw))


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(reference params, port params in float32), one seed."""
    rp = rmodels.init_params(r_smoke_config(arch), jax.random.PRNGKey(0))
    return rp, params_from_reference(jax.tree.map(np.asarray, rp),
                                     smoke_config(arch), device="cpu",
                                     dtype=torch.float32)


def _batches(world, vocab, seed):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (world, 16)),
             "labels": rng.integers(0, vocab, (world, 16))}
            for _ in range(STEPS)]


def _tokens(world, arch):
    return np.random.default_rng(20).integers(
        0, smoke_config(arch).vocab, (2 * world, 9))


def _whole_state(arch, seed=7):
    """A one-process train state in the port's layout (numpy), moments
    drawn so that every slice differs."""
    rng = np.random.default_rng(seed)
    params = _np(_model(arch)[1])
    draw = lambda t: tree_map(lambda a: rng.standard_normal(a.shape)
                              .astype(np.float32), t)
    return RTrainState(params=params,
                       opt=ROptState(mu=draw(params), nu=draw(params),
                                     step=np.asarray(5, np.int32)),
                       residual=None)


def _grid(world, root):
    cases = {}
    cases[("gather",)] = dict(kind="fsdp_gather", mesh=(world, 1),
                              profile="dp_only", shapes=GATHER_SHAPES,
                              dims=(0, 1), seed=1)
    for name, (w, arch, profile, mesh, compress, ckpt) in TRAIN.items():
        if w != world:
            continue
        cfg = _cfgs(arch)[1]
        cases[("train", name)] = dict(
            kind="train", mesh=mesh, profile=profile, cfg=cfg,
            params=_np(_model(arch)[1]), compress=compress,
            microbatches=1, batches=_batches(world, cfg.vocab, 30),
            ckpt_dir=os.path.join(root, name) if ckpt else None)
    if world != 4:
        return cases
    for name, (_, arch, profile, mesh) in SERVE.items():
        cases[("serve", name)] = dict(
            kind="serve", mesh=mesh, profile=profile, cfg=_cfgs(arch)[1],
            params=_np(_model(arch)[1]), tokens=_tokens(world, arch),
            prompt_len=8)
    for remat in ("block", "none"):
        cfg = _cfgs(MUSICGEN, dtype="bfloat16", remat=remat)[1]
        cases[("wire", remat)] = dict(
            kind="fsdp_wire", mesh=(4, 1), profile="dp_only", cfg=cfg,
            params=_np(_model(MUSICGEN)[1]),
            batch=_batches(world, cfg.vocab, 40)[0])
    ckpt = os.path.join(root, "one_process")
    r_save(ckpt, 5, _whole_state(MUSICGEN))
    cases[("restore",)] = dict(kind="restore", mesh=(4, 1),
                               profile="dp_only", cfg=_cfgs(MUSICGEN)[1],
                               ckpt_dir=ckpt, step=5)
    return cases


@functools.lru_cache(maxsize=None)
def _ref_train(name):
    """The reference's metrics and parameters (the port's leaf order) after
    the steps at ``microbatches=world``."""
    world, arch, _, _, compress, _ = TRAIN[name]
    cfg = _cfgs(arch)[0]
    state = r_init_train_state(cfg, _model(arch)[0], compress=compress)
    step = jax.jit(r_make_train_step(cfg, RAdamWConfig(warmup_steps=1),
                                     compress_grads=compress,
                                     microbatches=world))
    metrics = []
    for b in _batches(world, cfg.vocab, 30):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    params = params_from_reference(jax.tree.map(np.asarray, state.params),
                                   cfg, device="cpu")
    return metrics, [p.numpy() for p in tree_leaves(params)]


@functools.lru_cache(maxsize=None)
def _port_train(name):
    """The one-process port's metrics and parameters after the steps at
    ``microbatches=world``."""
    world, arch, _, _, compress, _ = TRAIN[name]
    cfg = _cfgs(arch)[1]
    state = init_train_state(cfg, tree_map(lambda t: t.clone(),
                                           _model(arch)[1]),
                             compress=compress)
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1),
                           compress_grads=compress, microbatches=world)
    metrics = []
    for b in _batches(world, cfg.vocab, 30):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, [p.numpy() for p in tree_leaves(state.params)]


def _slab(a, world, r):
    b = a.shape[0] // world
    return a[r * b:(r + 1) * b]


@functools.lru_cache(maxsize=None)
def _ref_steps(arch):
    cfg = _cfgs(arch)[0]
    return (jax.jit(functools.partial(rmodels.prefill_step, cfg=cfg,
                                      use_kernel=False)),
            jax.jit(functools.partial(rmodels.decode_step, cfg=cfg,
                                      use_kernel=False)))


def _ref_logits(arch, toks):
    cfg = _cfgs(arch)[0]
    rp = _model(arch)[0]
    prefill, decode = _ref_steps(arch)
    caches = rmodels.init_caches(cfg, toks.shape[0], toks.shape[1])
    lp, caches = prefill(rp, batch={"tokens": jnp.asarray(toks[:, :8])},
                         caches=caches)
    ld, _ = decode(rp, batch={"tokens": jnp.asarray(toks[:, 8:9])},
                   caches=caches)
    return np.asarray(lp), np.asarray(ld)


@functools.lru_cache(maxsize=None)
def _ref_serve(name):
    """Per rank, the reference's (prefill, decode) logits: on the rank's
    slab under ``ep_dp``, the global batch's rows under ``dp_only``."""
    world, arch, profile, _ = SERVE[name]
    toks = _tokens(world, arch)
    if profile == "ep_dp":
        return [_ref_logits(arch, _slab(toks, world, r))
                for r in range(world)]
    whole = _ref_logits(arch, toks)
    return [(_slab(whole[0], world, r), _slab(whole[1], world, r))
            for r in range(world)]


_ROOT = tempfile.mkdtemp(prefix="fsdp_")


@functools.lru_cache(maxsize=None)
def _run_all():
    """Both worlds' grids, their ranks spawned at once, the oracles computed
    meanwhile."""
    grids = {w: _grid(w, os.path.join(_ROOT, str(w))) for w in WORLDS}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        spawned = {w: pool.submit(worker.spawn, w, list(grids[w].values()),
                                  worker.GROUP_TIMEOUT_S, SPAWN_LIMIT_S)
                   for w in WORLDS}
        jobs = [functools.partial(f, n) for n in TRAIN
                for f in (_ref_train, _port_train)]
        jobs += [functools.partial(_ref_serve, n) for n in SERVE]
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
# the gather
# ---------------------------------------------------------------------------

def _gather_inputs(world, case, dim):
    """(every rank's slice, every rank's bf16 cotangent as float32) of leaf
    ``dim`` of the gather case, as the worker draws them."""
    seed = case["seed"] + 10 * dim
    shape = case["shapes"][dim]
    whole = list(shape)
    whole[dim] *= world
    slices = [np.random.default_rng(seed + r).standard_normal(shape)
              .astype(np.float32) for r in range(world)]
    cot = [np.asarray(jnp.asarray(np.random.default_rng(seed + 100 + r)
                                  .standard_normal(whole).astype(np.float32))
                      .astype(jnp.bfloat16).astype(jnp.float32))
           for r in range(world)]
    return slices, cot


@pytest.mark.parametrize("dim", (0, 1))
@pytest.mark.parametrize("world", WORLDS)
def test_gather_forward_is_the_whole_leaf_cast(ranks, world, dim):
    res, cases = ranks(world)
    case = cases[("gather",)]
    slices, _ = _gather_inputs(world, case, dim)
    cast = [np.asarray(jnp.asarray(s).astype(jnp.bfloat16)
                       .astype(jnp.float32)) for s in slices]
    want = np.concatenate(cast, axis=dim)
    numel = sum(int(np.prod(s)) for s in case["shapes"])
    for got in res[("gather",)]:
        assert got["whole_dtype"] == ["torch.bfloat16"]
        np.testing.assert_array_equal(got["whole"][dim], want)
        assert got["sent_forward"] == (world - 1) * numel * 2   # bf16


@pytest.mark.parametrize("dim", (0, 1))
@pytest.mark.parametrize("world", WORLDS)
def test_gather_backward_is_the_float32_member_sum(ranks, world, dim):
    res, cases = ranks(world)
    case = cases[("gather",)]
    _, cot = _gather_inputs(world, case, dim)
    numel = sum(int(np.prod(s)) for s in case["shapes"])
    for r, got in enumerate(res[("gather",)]):
        blocks = [np.split(c, world, axis=dim)[r] for c in cot]
        want = blocks[0]
        for b in blocks[1:]:
            want = want + b                      # float32, member order
        assert want.dtype == np.float32
        assert got["grad_dtype"] == ["torch.float32"]
        np.testing.assert_array_equal(got["grad"][dim], want)
        assert got["sent_backward"] == (world - 1) * numel * 4  # float32
        assert got["calls"] == 2             # one gather, one reduce-scatter


# ---------------------------------------------------------------------------
# training and serving
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
    world, _, _, _, compress, _ = TRAIN[name]
    res, _ = ranks(world)
    _check_train(res[("train", name)], *_ref_train(name), compress,
                 metric_rtol=1e-3 if compress else 1e-5,
                 mean_bound=LR / 10 if compress else 1e-6)


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_steps_match_microbatches_world(ranks, name):
    world, _, _, _, compress, _ = TRAIN[name]
    res, _ = ranks(world)
    _check_train(res[("train", name)], *_port_train(name), compress,
                 metric_rtol=1e-5, mean_bound=1e-6)


@pytest.mark.parametrize("name", list(SERVE))
def test_prefill_and_decode_match_the_reference(ranks, name):
    world, arch, _, _ = SERVE[name]
    res, _ = ranks(world)
    for (lp, ld), got in zip(_ref_serve(name), res[("serve", name)],
                             strict=True):
        assert got["prefill"].shape == (2, smoke_config(arch).vocab)
        np.testing.assert_allclose(got["prefill"], lp, atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(got["decode"][0], ld, atol=2e-2,
                                   rtol=2e-2)
        np.testing.assert_array_equal(got["prefill"].argmax(-1),
                                      lp.argmax(-1))
        np.testing.assert_array_equal(got["decode"][0].argmax(-1),
                                      ld.argmax(-1))


# ---------------------------------------------------------------------------
# the wire: dtypes, the recompute's gathers, what stays alive
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ("block", "none"))
def test_gathers_move_bf16_and_the_recompute_gathers_again(ranks, remat):
    res, cases = ranks(4)
    cfg = cases[("wire", remat)]["cfg"]
    n_layer = 7 * cfg.n_layers             # wq wk wv wo, w_up w_gate w_down
    # this rank's slices: the embedding's (vocab, d/4) and each layer's
    d, f = cfg.d_model, cfg.d_ff
    hq = cfg.n_heads * cfg.hd
    embed = cfg.vocab * d // 4
    layer = cfg.n_layers * (3 * d * hq + hq * d + 3 * d * f) // 4
    again = remat == "block"
    for got in res[("wire", remat)]:
        fwd, bwd = got["forward"], got["backward"]
        assert fwd[0] == ["torch.float32"]             # the embedding
        assert [len(c) for c in fwd[1:]] == [7] * cfg.n_layers
        assert {dt for c in fwd[1:] for dt in c} == {"torch.bfloat16"}
        assert bwd == (fwd[1:] if again else [])
        assert got["alive_after_forward"] == (0 if again else n_layer)
        assert got["sent_forward"] == 3 * (4 * embed + 2 * layer)
        assert got["sent"] == got["received"] == 3 * (
            4 * embed + 2 * layer * (2 if again else 1)   # gathers
            + 4 * (embed + layer))                         # float32 sums
        calls = 1 + cfg.n_layers
        assert got["calls"] == 2 * calls + (cfg.n_layers if again else 0)
        assert all(got["grads"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_sharded_checkpoint_reads_back_whole(ranks):
    res, cases = ranks(4)
    case = cases[("train", "qwen_ep_dp_int8")]
    got = res[("train", "qwen_ep_dp_int8")]
    whole = _np(_model(QWEN)[1])
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


def test_one_process_checkpoint_restores_as_slices(ranks):
    res, cases = ranks(4)
    whole = dict(_paths(_whole_state(MUSICGEN)))
    cfg = cases[("restore",)]["cfg"]
    split = 0
    for r, got in enumerate(res[("restore",)]):
        mesh = type("M", (), {"axis_names": ("data", "model"),
                              "shape": {"data": 4, "model": 1},
                              "coordinate": {"data": r, "model": 0}})()
        rules = ShardingRules.for_mesh(mesh, "dp_only")
        specs = dict(leaf_pspecs(_whole_state(MUSICGEN), rules))
        assert set(got) == set(whole)
        for key, piece in got.items():
            want = local_slice(np.asarray(whole[key]), specs[key], rules)
            split += piece.shape != np.shape(whole[key])
            np.testing.assert_array_equal(piece, want)
    # params, mu and nu: the embedding and 7 leaves a layer, on every rank
    assert split == 4 * 3 * (1 + 7 * cfg.n_layers)
