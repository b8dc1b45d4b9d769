"""mamba2's mixer under tensor parallelism (the ``default``, ``serve_tp``
and ``ep_sharded`` profiles) on the CPU over gloo, against the JAX package
and the port's one-process path.

Each leaf keeps its spec's layout (``w_in``'s and ``conv_w``'s column
blocks, ``w_out``'s rows over ``model``); where the line divides the heads
each rank computes its heads (the projection regrouped, the gated norm's
sum of squares summed over the line), where it does not every rank runs
the whole mixer. One spawn per world (4 and 2 gloo ranks, both at once,
running ``tests/_torch_lm_ranks_worker.py``, which imports no ``jax``)
runs every case of that world while the parent computes the oracles, on
the smoke configs (float32; jamba cut to one period, 8 layers, its MoE at
capacity factor 16 so that no path drops a token):

* mamba2 and jamba under ``serve_tp`` ``(1, 4)`` and ``(1, 2)``, jamba
  under ``default (2, 2)`` and ``ep_sharded (1, 4)``, and mamba2 at
  ``head_dim`` 64 (2 heads: the line of 4 does not divide them, so the
  mixer runs whole; ``w_in``'s 290 columns stay whole, ``conv_w``'s 160
  are split) and at ``d_state`` 3 (the line divides the 16 heads but not
  ``w_in``'s 278 columns or ``conv_w``'s 134, which stay whole: each rank
  takes its heads' columns) under ``serve_tp (1, 4)``: a prefill of 9
  tokens (padded to two chunks) into caches of 12 positions, then 3
  greedy decode steps.
  The prefill's logits against the reference's ``prefill_step``, every
  step's logits and greedy tokens against the port's one process (the
  reference's prefill leaves the mamba state at zero, so its decode is not
  the oracle; ``test_torch_mamba*.py`` hold the one-process decode against
  the reference's ``mamba_decode``). Within ``SERVE_TOL`` of the largest
  logit: 1e-4 for mamba2 (float32 throughout; the line's sums run in
  other orders), 2e-3 for jamba (its attention decodes against the bf16
  KV cache, whose rounding a float32 difference can flip). The SSM state a
  rank holds is a quarter (a half) of the one process's where the line
  divides the heads, all of it where it does not;
* 2 AdamW steps of mamba2 under ``default (2, 2)`` (FSDP over ``data``,
  the mixer over ``model``; one sequence a data rank): the metrics within
  rtol 1e-5 and the parameters within 1e-4 (their mean difference under
  1e-6) of the reference's ``make_train_step`` (autograd by
  ``jax.value_and_grad`` of its ``loss_fn``) and of the port's, both at
  ``microbatches=2``; the state saved sharded before and after the steps
  and restored with ``sharding_tree=``, bitwise;
* the gated norm's sum over the line: each rank's output and gradients
  (its channels of ``y``, ``z`` and the scale) against autograd through
  the one-process norm, within 1e-5.
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
from repro.configs import smoke_config as r_smoke_config
from repro.train import AdamWConfig as RAdamWConfig
from repro.train import init_train_state as r_init_train_state
from repro.train import make_train_step as r_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.models import (decode_step, init_caches, params_from_reference,
                                prefill_step)
from repro_torch.models.layers import rmsnorm
from repro_torch.train import AdamWConfig, init_train_state, make_train_step
from repro_torch.train.optimizer import tree_leaves, tree_map

MAMBA, JAMBA = "mamba2-1.3b", "jamba-v0.1-52b"
WORLDS = (4, 2)
SPAWN_LIMIT_S = 150
STEPS = 2
PROMPT, GREEDY, MAX_LEN = 9, 3, 12
SERVE_TOL = {MAMBA: 1e-4, JAMBA: 2e-3}
# name -> (world, arch, SSMConfig changes, mesh, profile)
SERVE = {"mamba": (4, MAMBA, (), (1, 4), "serve_tp"),
         "jamba": (4, JAMBA, (), (1, 4), "serve_tp"),
         "jamba_default": (4, JAMBA, (), (2, 2), "default"),
         "jamba_ep": (4, JAMBA, (), (1, 4), "ep_sharded"),
         "whole": (4, MAMBA, (("head_dim", 64),), (1, 4), "serve_tp"),
         "whole_w_in": (4, MAMBA, (("d_state", 3),), (1, 4), "serve_tp"),
         "mamba_two": (2, MAMBA, (), (1, 2), "serve_tp"),
         "jamba_two": (2, JAMBA, (), (1, 2), "serve_tp")}
# name -> (arch, oracle microbatches, ckpt)
TRAIN = {"mamba": (MAMBA, 2, True)}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _cfgs(arch, ssm=(), remat="none"):
    """(reference cfg, port cfg): jamba cut to one period, its MoE at
    capacity factor 16; the ``(field, value)`` changes ``ssm`` to the
    SSM config."""
    out = []
    for c in (r_smoke_config(arch), smoke_config(arch)):
        kw = {"remat": remat, "ssm": dataclasses.replace(c.ssm, **dict(ssm))}
        if c.moe is not None:
            kw.update(n_layers=len(c.pattern), moe=dataclasses.replace(
                c.moe, capacity_factor=16.0))
        out.append(dataclasses.replace(c, **kw))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _model(arch, ssm=()):
    """(reference params, port params in float32), one seed."""
    rcfg, cfg = _cfgs(arch, ssm)
    rp = jax.jit(rmodels.init_params, static_argnums=0)(
        rcfg, jax.random.PRNGKey(0))
    return rp, params_from_reference(jax.tree.map(np.asarray, rp), cfg,
                                     device="cpu", dtype=torch.float32)


def _tokens(arch):
    return np.random.default_rng(31).integers(
        0, smoke_config(arch).vocab, (2, PROMPT))


def _batches(cfg, seed):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab, (2, 16)),
             "labels": rng.integers(0, cfg.vocab, (2, 16))}
            for _ in range(STEPS)]


def _norm_inputs():
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"y": f(2, 3, 32), "z": f(2, 3, 32), "scale": 1 + f(32) / 4,
            "cot": f(2, 3, 32)}


NORM_EPS = 1e-5


def _grid(world, root):
    cases = {}
    for name, (w, arch, ssm, mesh, profile) in SERVE.items():
        if w == world:
            cases[("serve", name)] = dict(
                kind="serve", mesh=mesh, profile=profile,
                cfg=_cfgs(arch, ssm)[1], params=_np(_model(arch, ssm)[1]),
                tokens=_tokens(arch), prompt_len=PROMPT, max_len=MAX_LEN,
                greedy=GREEDY)
    if world != 4:
        return cases
    for name, (arch, _, ckpt) in TRAIN.items():
        cfg = _cfgs(arch, remat="block")[1]
        cases[("train", name)] = dict(
            kind="train", mesh=(2, 2), profile="default", cfg=cfg,
            params=_np(_model(arch)[1]), compress=False,
            batches=_batches(cfg, 30),
            ckpt_dir=os.path.join(root, name) if ckpt else None)
    cases[("norm",)] = dict(kind="mamba_norm", mesh=(1, 4),
                            profile="serve_tp", inputs=_norm_inputs(),
                            eps=NORM_EPS)
    return cases


@functools.lru_cache(maxsize=None)
def _ref_prefill(arch, ssm=()):
    """The reference's prefill logits."""
    cfg = _cfgs(arch, ssm)[0]
    prefill = jax.jit(functools.partial(rmodels.prefill_step, cfg=cfg,
                                        use_kernel=False))
    toks = _tokens(arch)
    logits, _ = prefill(_model(arch, ssm)[0],
                        batch={"tokens": jnp.asarray(toks)},
                        caches=rmodels.init_caches(cfg, toks.shape[0],
                                                   MAX_LEN))
    return np.asarray(logits)


@functools.lru_cache(maxsize=None)
def _port_serve(arch, ssm=()):
    """The port's one process: the prefill's and every greedy step's
    logits, and the SSM state's bytes."""
    cfg = _cfgs(arch, ssm)[1]
    toks = torch.from_numpy(_tokens(arch))
    with torch.no_grad():
        caches = init_caches(cfg, toks.shape[0], MAX_LEN, device="cpu")
        logits, caches = prefill_step(_model(arch, ssm)[1], cfg,
                                      {"tokens": toks}, caches)
        out = [logits.numpy()]
        for _ in range(GREEDY):
            logits, caches = decode_step(
                _model(arch, ssm)[1], cfg,
                {"tokens": logits.argmax(-1)[:, None]}, caches)
            out.append(logits.numpy())
    ssm = sum(c.ssm.numel() * 4 for c in caches if hasattr(c, "ssm"))
    return out, ssm


@functools.lru_cache(maxsize=None)
def _ref_train(name):
    arch, mb, _ = TRAIN[name]
    cfg = _cfgs(arch, remat="block")[0]
    state = r_init_train_state(cfg, _model(arch)[0])
    step = jax.jit(r_make_train_step(cfg, RAdamWConfig(warmup_steps=1),
                                     microbatches=mb))
    metrics = []
    for b in _batches(cfg, 30):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    params = params_from_reference(jax.tree.map(np.asarray, state.params),
                                   _cfgs(arch, remat="block")[1],
                                   device="cpu")
    return metrics, [p.numpy() for p in tree_leaves(params)]


@functools.lru_cache(maxsize=None)
def _port_train(name):
    arch, mb, _ = TRAIN[name]
    cfg = _cfgs(arch, remat="block")[1]
    state = init_train_state(cfg, tree_map(lambda t: t.clone(),
                                           _model(arch)[1]))
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1), microbatches=mb)
    metrics = []
    for b in _batches(cfg, 30):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, [p.numpy() for p in tree_leaves(state.params)]


_ROOT = tempfile.mkdtemp(prefix="tp_mamba_")


@functools.lru_cache(maxsize=None)
def _run_all():
    """Both worlds' grids, their ranks spawned at once, the oracles
    computed meanwhile."""
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda k: _model(*k), {v[1:3] for v in SERVE.values()}))
    grids = {w: _grid(w, os.path.join(_ROOT, str(w))) for w in WORLDS}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        spawned = {w: pool.submit(worker.spawn, w, list(grids[w].values()),
                                  worker.GROUP_TIMEOUT_S, SPAWN_LIMIT_S)
                   for w in WORLDS}
        jobs = [functools.partial(f, n) for n in TRAIN
                for f in (_ref_train, _port_train)]
        jobs += [functools.partial(f, arch, ssm)
                 for arch, ssm in {(v[1], v[2]) for v in SERVE.values()}
                 for f in (_ref_prefill, _port_serve)]
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
# serving
# ---------------------------------------------------------------------------

def _rows(per_rank, name):
    """Each rank's data rank's rows (a slice of the global batch)."""
    data = SERVE[name][3][0]
    for r, got in enumerate(per_rank):
        d = r // (len(per_rank) // data)
        yield got, np.s_[d * (2 // data):(d + 1) * (2 // data)]


def _close(got, want, tol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


@pytest.mark.parametrize("name", list(SERVE))
def test_prefill_matches_the_reference(ranks, name):
    world, arch, ssm = SERVE[name][:3]
    res, _ = ranks(world)
    want = _ref_prefill(arch, ssm)
    for got, rows in _rows(res[("serve", name)], name):
        _close(got["prefill"], want[rows], SERVE_TOL[arch])


@pytest.mark.parametrize("name", list(SERVE))
def test_greedy_steps_match_one_process(ranks, name):
    world, arch, ssm = SERVE[name][:3]
    res, _ = ranks(world)
    want, _ = _port_serve(arch, ssm)
    for got, rows in _rows(res[("serve", name)], name):
        steps = [got["prefill"]] + got["decode"]
        assert len(steps) == len(want) == 1 + GREEDY
        for g, w in zip(steps, want):
            _close(g, w[rows], SERVE_TOL[arch])
            np.testing.assert_array_equal(g.argmax(-1), w[rows].argmax(-1))


@pytest.mark.parametrize("name", list(SERVE))
def test_ssm_state_holds_the_ranks_heads(ranks, name):
    world, arch, ssm, mesh = SERVE[name][:4]
    res, cases = ranks(world)
    cfg = cases[("serve", name)]["cfg"]
    _, whole = _port_serve(arch, ssm)
    line = mesh[1]
    parts = line if cfg.ssm.n_heads(cfg.d_model) % line == 0 else 1
    assert (parts == 1) == (name == "whole")
    w_in = cases[("serve", name)]["params"]["layers"][0]["mamba"]["w_in"]
    assert (w_in.shape[1] % line == 0) == (name not in ("whole",
                                                       "whole_w_in"))
    for got in res[("serve", name)]:
        assert got["ssm_bytes"] * parts * mesh[0] == whole


# ---------------------------------------------------------------------------
# training under default (2, 2)
# ---------------------------------------------------------------------------

def _check_train(got, want_m, want_p):
    for g in got:
        assert len(g["metrics"]) == len(want_m) == STEPS
        for gm, wm in zip(g["metrics"], want_m):
            for k in ("loss/ce", "loss/aux", "loss/total", "opt/grad_norm"):
                np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5,
                                           atol=1e-7, err_msg=k)
        assert g["metrics"] == got[0]["metrics"]
    diffs = []
    assert len(got[0]["params"]) == len(want_p)
    for a, b in zip(got[0]["params"], want_p):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
        diffs.append(np.abs(a - b).ravel())
    assert np.concatenate(diffs).mean() < 1e-6


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_steps_match_the_reference(ranks, name):
    res, _ = ranks(4)
    _check_train(res[("train", name)], *_ref_train(name))


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_steps_match_one_process(ranks, name):
    res, _ = ranks(4)
    _check_train(res[("train", name)], *_port_train(name))


def test_sharded_checkpoint_round_trips(ranks):
    res, _ = ranks(4)
    for got in res[("train", "mamba")]:
        assert got["restored_equal"] is True


# ---------------------------------------------------------------------------
# the gated norm's sum over the line
# ---------------------------------------------------------------------------

def test_gated_norm_gradients_match_autograd_through_one_process(ranks):
    res, _ = ranks(4)
    g = {k: torch.from_numpy(v).requires_grad_()
         for k, v in _norm_inputs().items() if k != "cot"}
    out = rmsnorm({"scale": g["scale"]},
                  g["y"] * torch.nn.functional.silu(g["z"]), NORM_EPS)
    (out * torch.from_numpy(_norm_inputs()["cot"])).sum().backward()
    n = out.shape[-1] // 4
    for r, got in enumerate(res[("norm",)]):
        cols = np.s_[..., r * n:(r + 1) * n]
        np.testing.assert_allclose(got["out"], out.detach().numpy()[cols],
                                   atol=1e-5, rtol=1e-5)
        for k in ("y", "z", "scale"):
            np.testing.assert_allclose(got[k], g[k].grad.numpy()[cols],
                                       atol=1e-5, rtol=1e-5, err_msg=k)
