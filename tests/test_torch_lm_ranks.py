"""The port's language model across processes under ``sharding.use_rules``,
on the CPU over gloo, against the JAX package and the port's one-process
path.

The parent (this module) makes the inputs with numpy, hands the
reference's smoke weights (qwen2-moe-a2.7b and phi3.5-moe-42b-a6.6b) over
in the port's layout, computes the oracles, then spawns 2 and 4 ranks with
``torch.multiprocessing`` and a ``FileStore``. The ranks run
``tests/_torch_lm_ranks_worker.py``, which imports no ``jax``; each world
runs its whole grid in one spawn, both worlds at once (a module-scoped
fixture), on a ``(data=1, model=P)`` mesh:

* ``ep_dp``'s ``_moe_shard_map``: each rank's output equal (1e-5) to the
  port's one-process ``moe_apply`` on its slab (aux the mean of the slabs',
  metrics their sum); where nothing drops (capacity factor 16) within
  2e-3 of the reference's ``moe_apply(use_kernel=False)`` on the global
  batch (the bound of ``tests/test_serving_consistency.py``'s shard_map
  check); the all-to-all's bytes summed over ranks equal to
  2·(P−1)/P of all ranks' bucket bytes;
* ``dp_only``'s MoE: the reference's global-capacity MoE on the global
  batch (capacity factor 0.5: drops included), within 2e-3;
* prefill and decode logits per rank within 2e-2 of the reference's
  ``prefill_step`` / ``decode_step`` (the tolerance of
  ``tests/test_torch_serve.py``): on the rank's slab under ``ep_dp``, on
  the global batch's rows under ``dp_only``;
* two AdamW steps, int8 compression off and on: with every label valid,
  ``ep_dp`` against ``make_train_step(microbatches=P)`` on the global
  batch; with masked labels spread unevenly, capacity factor 16 and the
  aux weight 0, ``ep_dp`` against ``microbatches=1``; ``dp_only`` (global
  MoE) against ``microbatches=1``. Each case against two oracles from the
  same weights and batches:

  - the reference's ``make_train_step``: the losses, the aux loss and the
    gradient norm within rtol 1e-5, parameters within 1e-4 and their mean
    difference under 1e-6. With int8 compression an element whose
    gradient sits on a rounding boundary of its int8 grid can round to the
    next step in one package and not the other (the argument of
    ``tests/test_torch_train.py::test_train_steps_match_the_reference``):
    that moves the global norm, so the metrics within rtol 1e-3, and,
    through AdamW, the element by up to about lr a step, so parameters
    within 2·lr·steps and their mean difference under lr/10 (a few
    percent of the elements flip; the smoke runs read 1.1e-5, lr 3e-4);
  - the port's one-process ``make_train_step``, whose arithmetic the ranks
    repeat: metrics within rtol 1e-5, parameters within 1e-4 (with
    compression 2·lr·steps) and their mean difference under 1e-6;
* a train state saved sharded and read whole by the reference's
  ``restore_checkpoint`` (bitwise the one-process state before the steps;
  after them the ranks' gathered parameters bitwise), and restored with
  ``sharding_tree=`` on every rank: the live slices bitwise;
* a gradient taken from another thread (where a card's autograd
  recomputes a checkpointed layer) equal to one taken on the caller's;
* mamba2's blocks under a TP profile, on a ``(1, P)`` mesh and over
  ``data > 1`` on a ``(2, P/2)`` one: the prefill's and two decode steps'
  logits within 1e-4 of the port's one process (``test_torch_tp_mamba.py``
  holds the mixer under TP against the reference), and a collective one
  rank never joins raises within the group's timeout. (FSDP over ``data > 1`` executes:
  ``test_torch_fsdp.py``; tensor parallelism: ``test_torch_tp.py``.)
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
from repro_torch.models import params_from_reference
from repro_torch.models.moe import _capacity, moe_apply
from repro_torch.train import AdamWConfig, init_train_state, make_train_step
from repro_torch.train.optimizer import tree_leaves, tree_map

ARCHS = ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b")
r_moe_apply = jax.jit(_r_moe_apply, static_argnums=(1,),
                      static_argnames=("use_kernel",))
WORLDS = (2, 4)
SPAWN_LIMIT_S = 150
LR = AdamWConfig().lr
STEPS = 2
SEQ = 12


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


def _cap16(cfg, aux=None, factor=16.0):
    moe = dataclasses.replace(cfg.moe, capacity_factor=factor)
    if aux is not None:
        moe = dataclasses.replace(moe, router_aux_weight=aux)
    return dataclasses.replace(cfg, moe=moe)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(reference cfg, reference params, port params in float32)."""
    cfg = r_smoke_config(arch)
    rp = rmodels.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, rp, params_from_reference(
        jax.tree.map(np.asarray, rp), cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _mamba_params():
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params

    return init_params(smoke_config("mamba2-1.3b"),
                       torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.float32)


MAMBA_TOKENS = np.random.default_rng(24).integers(0, 128, (2, 10))
MAMBA_PROMPT = 8


@functools.lru_cache(maxsize=None)
def _mamba_one_process():
    """The port's one process on ``MAMBA_TOKENS``: the prefill's logits,
    then a decode step's on each later token."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import decode_step, init_caches, prefill_step

    cfg = smoke_config("mamba2-1.3b")
    toks = torch.from_numpy(MAMBA_TOKENS)
    with torch.no_grad():
        caches = init_caches(cfg, 2, toks.shape[1], device="cpu")
        logits, caches = prefill_step(_mamba_params(), cfg,
                                      {"tokens": toks[:, :MAMBA_PROMPT]},
                                      caches)
        out = [logits.numpy()]
        for i in range(MAMBA_PROMPT, toks.shape[1]):
            logits, caches = decode_step(_mamba_params(), cfg,
                                         {"tokens": toks[:, i:i + 1]},
                                         caches)
            out.append(logits.numpy())
    return out


def _x(world, cfg, seed):
    return np.random.default_rng(seed).standard_normal(
        (2 * world, SEQ, cfg.d_model)).astype(np.float32)


def _tokens(world, arch):
    return np.random.default_rng(20 + ARCHS.index(arch)).integers(
        0, _model(arch)[0].vocab, (2 * world, 9))


def _batches(world, cfg, seed, uneven):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        labels = rng.integers(0, cfg.vocab, (world, 16))
        if uneven:
            labels[0, :11] = -1              # rank 0 keeps 5 of 16
            labels[-1, 3] = -1
        out.append({"tokens": rng.integers(0, cfg.vocab, (world, 16)),
                    "labels": labels})
    return out


def _block(cfg):
    """The config with each layer recomputed in the backward (remat
    ``block``, the chip's training path)."""
    return dataclasses.replace(cfg, remat="block")


def _train_cases(world):
    """name -> (arch, profile, cfg, uneven, compress, oracle microbatches,
    with a checkpoint)."""
    q = r_smoke_config(ARCHS[0])
    p = r_smoke_config(ARCHS[1])
    return {
        "ep_mbP": (ARCHS[0], "ep_dp", q, False, False, world, False),
        "ep_mbP_int8": (ARCHS[0], "ep_dp", _block(q), False, True, world,
                        True),
        "ep_mbP_phi_int8": (ARCHS[1], "ep_dp", p, False, True, world, False),
        "ep_mb1": (ARCHS[0], "ep_dp", _cap16(q, 0.0), True, False, 1, False),
        "ep_mb1_int8": (ARCHS[0], "ep_dp", _cap16(q, 0.0), True, True, 1,
                        False),
        "dp_mb1": (ARCHS[0], "dp_only", q, True, False, 1, False),
        "dp_mb1_int8": (ARCHS[0], "dp_only", q, True, True, 1, False),
    }


def _grid(world, ckpt_root):
    cases = {}
    for i, arch in enumerate(ARCHS):
        cfg, _, tp = _model(arch)
        moe = _np(tp["layers"][0]["moe"])
        x = _x(world, cfg, 10 + i)
        for name, profile, c in (("ep", "ep_dp", cfg),
                                 ("ep16", "ep_dp", _cap16(cfg)),
                                 ("dp", "dp_only", _cap16(cfg, factor=0.5))):
            cases[("moe", name, arch)] = dict(
                kind="moe", mesh=(1, world), profile=profile, cfg=c,
                params=moe, x=x)
        for profile in ("ep_dp", "dp_only"):
            cases[("serve", profile, arch)] = dict(
                kind="serve", mesh=(1, world), profile=profile, cfg=cfg,
                params=_np(tp), tokens=_tokens(world, arch), prompt_len=8)
    for name, (arch, profile, cfg, uneven, compress, _, ckpt) in \
            _train_cases(world).items():
        cases[("train", name)] = dict(
            kind="train", mesh=(1, world), profile=profile, cfg=cfg,
            params=_np(_model(arch)[2]), compress=compress,
            batches=_batches(world, cfg, 30, uneven),
            ckpt_dir=os.path.join(ckpt_root, name) if ckpt else None)
    cfg = _block(r_smoke_config(ARCHS[0]))
    cases[("thread_grad",)] = dict(
        kind="thread_grad", mesh=(1, world), profile="ep_dp", cfg=cfg,
        params=_np(_model(ARCHS[0])[2]),
        batch=_batches(world, cfg, 40, False)[0])
    from repro_torch.configs import smoke_config

    mamba = smoke_config("mamba2-1.3b")
    for mesh, profile in (((2, world // 2), "default"),
                          ((1, world), "default"),
                          ((1, world), "ep_sharded")):
        cases[("mamba", mesh, profile)] = dict(
            kind="serve", mesh=mesh, profile=profile, cfg=mamba,
            params=_np(_mamba_params()), tokens=MAMBA_TOKENS,
            prompt_len=MAMBA_PROMPT)
    return cases


def _spawn(world, cases, timeout_s=worker.GROUP_TIMEOUT_S):
    """Run ``cases`` on ``world`` gloo ranks; returns per-rank results.
    Every process is joined, or killed past SPAWN_LIMIT_S."""
    return worker.spawn(world, cases, timeout_s, SPAWN_LIMIT_S)


_ROOT = tempfile.mkdtemp(prefix="lm_ranks_")


@functools.lru_cache(maxsize=None)
def _run_all():
    """Both worlds' grids and the stall case's world, their ranks spawned
    at once (a thread waits on each world)."""
    grids = {w: _grid(w, os.path.join(_ROOT, str(w))) for w in WORLDS}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS) + 1) as pool:
        spawned = {w: pool.submit(_spawn, w, list(grids[w].values()))
                   for w in WORLDS}
        # a world of 2 with a 3 s group timeout, for the stalled collective
        stall = pool.submit(_spawn, 2, [dict(kind="stall")], 3)
        # the parent's oracles meanwhile (cached for the tests)
        jobs = [functools.partial(f, w, n) for w in WORLDS
                for n in _train_cases(w) for f in (_ref_oracle, _oracle)]
        jobs += [functools.partial(_serve_oracle, w, a, p) for w in WORLDS
                 for a in ARCHS for p in ("ep_dp", "dp_only")]
        with concurrent.futures.ThreadPoolExecutor(4) as oracles:
            for f in [oracles.submit(j) for j in jobs]:
                f.result()
        got = {w: f.result() for w, f in spawned.items()}
    out = {"stall": stall.result()}
    for w, cases in grids.items():
        errors = {r: p for r, (s, p) in got[w].items() if s != "ok"}
        assert not errors, "\n".join(f"world {w} rank {r}:\n{p}"
                                     for r, p in errors.items())
        out[w] = ({k: [got[w][r][1][i] for r in range(w)]
                   for i, k in enumerate(cases)}, cases)
    return out


def _run(world):
    return _run_all()[world]


@pytest.fixture(scope="module")
def ranks():
    return _run


def _slab(a, world, r):
    b = a.shape[0] // world
    return a[r * b:(r + 1) * b]


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_moe_shard_map_matches_one_process_slabs(ranks, world, arch):
    res, cases = ranks(world)
    case = cases[("moe", "ep", arch)]
    cfg, _, tp = _model(arch)
    auxes, sums = [], {}
    for r, got in enumerate(res[("moe", "ep", arch)]):
        with torch.no_grad():
            y, aux, m = moe_apply(tp["layers"][0]["moe"], cfg,
                                  torch.from_numpy(_slab(case["x"], world,
                                                         r)))
        np.testing.assert_allclose(got["y"], y.numpy(), atol=1e-5, rtol=1e-5)
        auxes.append(float(aux))
        for k, v in m.items():
            sums[k] = sums.get(k, 0) + int(v)
    for got in res[("moe", "ep", arch)]:
        assert got["metrics"] == sums
        np.testing.assert_allclose(got["aux"], np.mean(auxes), rtol=1e-6)
    assert sums["moe/dropped"] > 0        # the local capacity drops


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_moe_shard_map_matches_reference_where_nothing_drops(ranks, world,
                                                             arch):
    res, cases = ranks(world)
    case = cases[("moe", "ep16", arch)]
    cfg, rp, _ = _model(arch)
    layer = jax.tree.map(lambda a: a[0], rp["period"]["pos0"]["moe"])
    y, _, m = r_moe_apply(layer, case["cfg"], jnp.asarray(case["x"]),
                          use_kernel=False)
    for r, got in enumerate(res[("moe", "ep16", arch)]):
        np.testing.assert_allclose(got["y"], _slab(np.asarray(y), world, r),
                                   atol=2e-3, rtol=2e-3)
        assert got["metrics"]["moe/dropped"] == int(m["moe/dropped"]) == 0
        assert got["metrics"]["moe/routed_tokens"] == \
            int(m["moe/routed_tokens"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_dp_only_moe_is_the_reference_global_moe(ranks, world, arch):
    res, cases = ranks(world)
    case = cases[("moe", "dp", arch)]
    cfg, rp, _ = _model(arch)
    layer = jax.tree.map(lambda a: a[0], rp["period"]["pos0"]["moe"])
    y, aux, m = r_moe_apply(layer, case["cfg"], jnp.asarray(case["x"]),
                            use_kernel=False)
    assert int(m["moe/dropped"]) > 0      # the global capacity drops
    for r, got in enumerate(res[("moe", "dp", arch)]):
        np.testing.assert_allclose(got["y"], _slab(np.asarray(y), world, r),
                                   atol=2e-3, rtol=2e-3)
        assert got["metrics"] == {k: int(v) for k, v in m.items()}
        np.testing.assert_allclose(got["aux"], float(aux), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_all_to_all_moves_two_thirds_of_the_buckets(ranks, world, arch):
    """Per MoE layer and forward pass: 2·(P−1)/P of every rank's (E, C, d)
    float32 buckets, summed over ranks (the rows counts go as "rows")."""
    res, cases = ranks(world)
    cfg = cases[("moe", "ep", arch)]["cfg"]
    cap = _capacity(cfg.moe, 2 * SEQ)
    buckets = world * cfg.moe.n_experts_padded * cap * cfg.d_model * 4
    got = res[("moe", "ep", arch)]
    sent = sum(g["bytes"]["sent"]["a2a"] for g in got)
    assert sent == sum(g["bytes"]["received"]["a2a"] for g in got)
    assert sent * world == 2 * (world - 1) * buckets
    assert sum(g["bytes"]["sent"]["rows"] for g in got) * world == \
        (world - 1) * world * cfg.moe.n_experts_padded * 4


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _r_serve(arch):
    cfg = _model(arch)[0]
    prefill = jax.jit(functools.partial(rmodels.prefill_step, cfg=cfg,
                                        use_kernel=False))
    decode = jax.jit(functools.partial(rmodels.decode_step, cfg=cfg,
                                       use_kernel=False))
    return prefill, decode


def _reference_logits(arch, toks):
    cfg, rp, _ = _model(arch)
    prefill, decode = _r_serve(arch)
    caches = rmodels.init_caches(cfg, toks.shape[0], toks.shape[1])
    lp, caches = prefill(rp, batch={"tokens": jnp.asarray(toks[:, :8])},
                         caches=caches)
    ld, _ = decode(rp, batch={"tokens": jnp.asarray(toks[:, 8:9])},
                   caches=caches)
    return np.asarray(lp), np.asarray(ld)


@functools.lru_cache(maxsize=None)
def _serve_oracle(world, arch, profile):
    """Per rank, the reference's (prefill, decode) logits: on the rank's
    slab under ``ep_dp``, the global batch's rows under ``dp_only``."""
    toks = _tokens(world, arch)
    if profile == "ep_dp":
        return [_reference_logits(arch, _slab(toks, world, r))
                for r in range(world)]
    whole = _reference_logits(arch, toks)
    return [(_slab(whole[0], world, r), _slab(whole[1], world, r))
            for r in range(world)]


@pytest.mark.parametrize("profile", ("ep_dp", "dp_only"))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_prefill_and_decode_match_reference(ranks, world, arch, profile):
    res, cases = ranks(world)
    np.testing.assert_array_equal(cases[("serve", profile, arch)]["tokens"],
                                  _tokens(world, arch))
    for (lp, ld), got in zip(_serve_oracle(world, arch, profile),
                             res[("serve", profile, arch)], strict=True):
        assert got["prefill"].shape == (2, _model(arch)[0].vocab)
        np.testing.assert_allclose(got["prefill"], lp, atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(got["decode"][0], ld, atol=2e-2,
                                   rtol=2e-2)


# ---------------------------------------------------------------------------
# training and checkpoints
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_oracle(world, name):
    """The reference's metrics and parameters (in the port's leaf order)
    after the steps, from the reference's weights and the same batches."""
    arch, _, cfg, uneven, compress, mb, _ = _train_cases(world)[name]
    state = r_init_train_state(cfg, _model(arch)[1], compress=compress)
    step = jax.jit(r_make_train_step(cfg, RAdamWConfig(warmup_steps=1),
                                     compress_grads=compress,
                                     microbatches=mb))
    metrics = []
    for b in _batches(world, cfg, 30, uneven):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    params = params_from_reference(jax.tree.map(np.asarray, state.params),
                                   cfg, device="cpu")
    return metrics, [p.numpy() for p in tree_leaves(params)]


@functools.lru_cache(maxsize=None)
def _oracle(world, name):
    """The one-process port's metrics and parameters after the steps."""
    arch, _, cfg, uneven, compress, mb, _ = _train_cases(world)[name]
    params = tree_map(lambda t: t.clone(), _model(arch)[2])
    state = init_train_state(cfg, params, compress=compress)
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1),
                           compress_grads=compress, microbatches=mb)
    metrics = []
    for b in _batches(world, cfg, 30, uneven):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, [p.numpy() for p in tree_leaves(state.params)]


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


@pytest.mark.parametrize("name", list(_train_cases(2)))
@pytest.mark.parametrize("world", WORLDS)
def test_train_steps_match_the_reference(ranks, world, name):
    res, _ = ranks(world)
    compress = _train_cases(world)[name][4]
    _check_train(res[("train", name)], *_ref_oracle(world, name), compress,
                 metric_rtol=1e-3 if compress else 1e-5,
                 mean_bound=LR / 10 if compress else 1e-6)


@pytest.mark.parametrize("name", list(_train_cases(2)))
@pytest.mark.parametrize("world", WORLDS)
def test_train_steps_match_their_oracle(ranks, world, name):
    res, _ = ranks(world)
    compress = _train_cases(world)[name][4]
    _check_train(res[("train", name)], *_oracle(world, name), compress,
                 metric_rtol=1e-5, mean_bound=1e-6)


def _r_state(tree_params, residual):
    zeros = lambda t: jax.tree.map(lambda a: np.zeros_like(a, np.float32), t)
    return RTrainState(params=tree_params,
                       opt=ROptState(mu=zeros(tree_params),
                                     nu=zeros(tree_params),
                                     step=np.zeros((), np.int32)),
                       residual=zeros(tree_params) if residual else None)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_checkpoint_crosses_to_the_reference(ranks, world):
    from repro_torch.sharding import ShardingRules, leaf_pspecs
    from repro_torch.sharding.placement import local_slice
    from repro_torch.checkpoint.store import _leaves as _paths

    res, cases = ranks(world)
    case = cases[("train", "ep_mbP_int8")]
    got = res[("train", "ep_mbP_int8")]
    whole = _np(_model(ARCHS[0])[2])
    template = _r_state(whole, residual=True)
    start = r_restore(case["ckpt_dir"], template, step=0)
    for a, b in zip(jax.tree.leaves(start), jax.tree.leaves(template)):
        np.testing.assert_array_equal(np.asarray(a), b)
    end = r_restore(case["ckpt_dir"], template, step=1)
    for a, b in zip(jax.tree.leaves(end.params), got[0]["params"]):
        np.testing.assert_array_equal(np.asarray(a), b)
    end = jax.tree.map(np.asarray, end)
    flat = dict(_paths(end))
    for r, g in enumerate(got):
        assert g["restored_equal"] is True
        mesh = type("M", (), {"axis_names": ("data", "model"),
                              "shape": {"data": 1, "model": world},
                              "coordinate": {"data": 0, "model": r}})()
        rules = ShardingRules.for_mesh(mesh, "ep_dp")
        specs = dict(leaf_pspecs(end, rules))
        assert set(g["slices"]) == set(worker.SLICE_KEYS)
        for key, piece in g["slices"].items():
            want = local_slice(flat[key], specs[key], rules)
            assert piece.shape != flat[key].shape
            np.testing.assert_array_equal(piece, want)


@pytest.mark.parametrize("world", WORLDS)
def test_gradient_taken_on_another_thread_keeps_the_rules(ranks, world):
    """A card's backward recomputes a checkpointed layer on autograd's
    device thread; the layer must still run under the caller's rules."""
    res, _ = ranks(world)
    for got in res[("thread_grad",)]:
        assert got == {"same": True}, got


@pytest.mark.parametrize("world", WORLDS)
def test_mamba_meshes_and_profiles_match_one_process(ranks, world):
    """mamba2's blocks under the TP profiles, on a ``(1, P)`` mesh and over
    ``data > 1`` on a ``(2, P/2)`` one: every rank's prefill and decode
    logits (its data rank's rows) within 1e-4 of the largest logit of the
    port's one process (float32; the line's sums in other orders)."""
    res, _ = ranks(world)
    want = _mamba_one_process()
    seen = 0
    for (kind, *key), per_rank in res.items():
        if kind != "mamba":
            continue
        seen += 1
        data = key[0][0]
        for r, got in enumerate(per_rank):
            d = r // (world // data)
            rows = np.s_[d * (2 // data):(d + 1) * (2 // data)]
            steps = [got["prefill"]] + got["decode"]
            assert len(steps) == len(want)
            for g, w in zip(steps, want):
                scale = float(np.abs(w).max())
                np.testing.assert_allclose(g, w[rows], atol=1e-4 * scale,
                                           rtol=0, err_msg=str(key))
    assert seen == 3


def test_failed_collective_raises_within_the_timeout(ranks):
    status, payload = _run_all()["stall"][0]
    assert status == "ok", payload
    kind, seconds = payload[0]
    assert kind == "RuntimeError" and seconds < 20, payload
