"""The examples' torch twins (``examples/torch/*.py``) on the CPU, each at a
small size, against the reference's functions on the same inputs.

Each twin's ``main([... "--device", "cpu"])`` runs and returns the numbers
it printed; the test computes them with ``repro`` (the reference's
generators and functions, the same seeds) and holds them equal:

* ``quickstart`` (n 256): nnz, nzc, the fetch plan's bytes and messages,
  CV/memA native and permuted, C's nnz, the 2D SUMMA bytes;
* ``amg_galerkin`` (side 16): the coarse operator's nnz and both
  variants' left / right bytes;
* ``betweenness_centrality`` (384 vertices, 4 parts, 8 sources): CV/memA,
  depths, SpGEMM calls, bytes, top-5, scores within 1e-9;
* ``mcl_quickstart`` (96 vertices): iterations, clusters, the session's
  misses / hits / calls (its ``traces``, executable builds, one a plan),
  and every re-clustering call a hit;
* ``serve_quickstart`` (n 128): its bitwise oracle assert passes, every
  wave served from the warm plan, one executable build, the rates and
  repacks the reference service reports on the same requests;
* ``moe_dispatch``: ``report`` on the reference's weights and tokens gives
  its routed / capacity-slot / dropped counts exactly and the aux loss
  within 1e-6; ``main`` runs on the twin's own seeded weights;
* ``train_lm`` (tiny, 3 steps of 2 x 16 from the reference's weights):
  each step's cross entropy within rtol 1e-5 of the reference's jitted
  ``make_train_step`` on the same batches, then a second run in the same
  ``--ckpt-dir`` resumes from the step-2 checkpoint and repeats steps 2
  bitwise.
"""

import argparse
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps as R
import repro.core as rcore
from repro.configs import smoke_config as r_smoke_config
from repro.configs.base import ModelConfig as RModelConfig
from repro.data import SyntheticLMDataset as RDataset
from repro.models import init_params as r_init_params
from repro.models.moe import moe_apply as r_moe_apply
from repro.models.moe import moe_init as r_moe_init
from repro.serve import ServicePolicy as RPolicy
from repro.serve import SpGEMMRequest as RRequest
from repro.serve import SpGEMMService as RService
from repro.train import AdamWConfig as RAdamWConfig
from repro.train import init_train_state as r_init_train_state
from repro.train import make_train_step as r_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.models import params_from_reference

HERE = os.path.join(os.path.dirname(__file__), "..", "examples", "torch")
TWINS = ("quickstart", "amg_galerkin", "betweenness_centrality",
         "mcl_quickstart", "serve_quickstart", "moe_dispatch", "train_lm")


def _twin(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_twin_{name}", os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_example_has_a_twin():
    ref = sorted(f[:-3] for f in os.listdir(os.path.join(HERE, ".."))
                 if f.endswith(".py"))
    assert ref == sorted(TWINS)


def test_quickstart():
    got = _twin("quickstart").main(["--n", "256", "--device", "cpu"])
    n, nparts = 256, 8
    a = rcore.banded_clustered(n, band=16, d=8.0, seed=0)
    part = rcore.Partition1D.balanced(n, nparts)
    plan = rcore.build_fetch_plan(a, a, part, part, nblocks=64)
    c = rcore.spgemm_1d(a, a, nparts).concat()
    ar = rcore.permute_symmetric(a, rcore.random_permutation(n, seed=1))
    assert got == {
        "nnz": a.nnz, "nzc": a.nzc, "fetched": plan.total_fetched_bytes,
        "required": plan.total_required_bytes,
        "messages": plan.total_messages, "cv": plan.cv_over_mema,
        "c_nnz": c.nnz, "correct": True,
        "summa_bytes": rcore.summa2d_comm_volume(a, a, 2)["total_bytes"],
        "cv_random": rcore.cv_over_mema(ar, ar, nparts)}


def test_amg_galerkin():
    got = _twin("amg_galerkin").main(["--side", "16", "--coarsening", "8",
                                      "--device", "cpu"])
    a = rcore.laplacian_2d(16)
    r = rcore.restriction_operator(a, coarsening=8)
    assert got["r_nnz"] == r.nnz and got["correct"]
    for alg in ("outer", "1d"):
        res = R.galerkin_product(a, r=r, nparts=8, right_algorithm=alg)
        assert got[alg] == (res.coarse.nnz, res.left_bytes, res.right_bytes)


def test_betweenness_centrality():
    got = _twin("betweenness_centrality").main(
        ["--n", "384", "--blocks", "6", "--nparts", "4", "--sources", "8",
         "--device", "cpu"])
    g = rcore.block_diagonal_noise(384, 6, d_in=5.0, d_out=0.3, seed=2)
    cv = rcore.cv_over_mema(g, g, 4)
    assert got["cv"] == cv and cv > 0.3
    rep = rcore.multilevel_partition(g, 4, seed=0)
    perm, _ = rcore.partition_to_permutation(rep.parts, 4)
    g = rcore.permute_symmetric(g, perm)

    def dist(x, y, semiring):
        r = rcore.spgemm_1d(x, y, 4, semiring=semiring)
        return r.concat(), r.plan.total_fetched_bytes

    res = R.bc_batch(g, perm[np.arange(8)], spgemm_fn=dist)
    assert (got["depths"], got["fwd"], got["bwd"], got["comm_bytes"]) == \
        (res.depths, res.fwd_spgemm_calls, res.bwd_spgemm_calls,
         res.comm_bytes)
    np.testing.assert_allclose(got["scores"], res.scores, rtol=1e-9)
    assert got["top"] == np.argsort(-res.scores)[:5].tolist()


def test_mcl_quickstart():
    got = _twin("mcl_quickstart").main(["--n", "96", "--blocks", "3",
                                        "--device", "cpu"])
    g = rcore.block_diagonal_noise(96, 3, d_in=8.0, d_out=0.05, seed=7)
    g.data[:] = np.abs(g.data) + 0.5
    session = rcore.SpGEMMSession()
    res = R.mcl(g, inflation=1.5, prune_threshold=1e-3, session=session,
                bs=32)
    s = session.stats
    assert got["iterations"] == res.iterations
    assert got["converged"] == res.converged
    assert np.array_equal(got["clusters"], res.clusters)
    assert (got["misses"], got["hits"], got["calls"]) == \
        (s["plan_cache_misses"], s["plan_cache_hits"], s["calls"])
    # the port's ``traces`` counts executable builds: one a plan (the
    # reference's counts jax traces, more than its plans)
    assert got["traces"] == got["misses"]
    assert got["again_hits"] == res.iterations and got["again_equal"]


def test_serve_quickstart():
    got = _twin("serve_quickstart").main(["--n", "128", "--device", "cpu"])
    assert got["oracle"] and got["traces"] == 1
    assert got["waves"] == [(8, 8)] * 3
    g = rcore.banded_clustered(128, 16, 6.0, seed=0)
    g.data[:] = np.rint(2 * g.data)
    g.data[g.data == 0] = 1.0
    g = g.astype(np.float32)
    g_bob = g.astype(np.float32)
    g_bob.data[:] = g.data * 3.0
    svc = RService(policy=RPolicy(tenant_quota=8))
    svc.prefetch("alice", g, g, bs=32)
    for _ in range(3):
        svc.serve([RRequest(tenant="alice", a=g, b=g, bs=32)
                   for _ in range(4)]
                  + [RRequest(tenant="bob", a=g_bob, b=g_bob, bs=32)
                     for _ in range(4)])
    st = svc.stats()
    assert (got["coalesce_rate"], got["cache_hit_rate"]) == \
        (st["coalesce_rate"], st["cache_hit_rate"])
    # ``traces``: one executable build here (the reference counts its jax
    # traces)
    assert got["repacks"] == svc.session.stats["payload_repacks"]


def test_moe_dispatch(capsys):
    twin = _twin("moe_dispatch")
    cfg = r_smoke_config("qwen2-moe-a2.7b")
    rp = jax.jit(r_moe_init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 64, cfg.d_model))
    _, aux, m = jax.jit(r_moe_apply, static_argnums=1,
                        static_argnames="use_kernel")(rp, cfg, x,
                                                      use_kernel=False)
    params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rp)
    got = twin.report(smoke_config("qwen2-moe-a2.7b"), params,
                      torch.from_numpy(np.array(x)))
    assert (got["routed"], got["slots"], got["dropped"]) == \
        (int(m["moe/routed_tokens"]), int(m["moe/capacity_slots"]),
         int(m["moe/dropped"]))
    assert abs(got["aux"] - float(aux)) <= 1e-6 and got["finite"]
    own = twin.main(["--device", "cpu"])
    assert own["finite"] and own["slots"] == got["slots"]
    assert "capacity slots (paper: fetched bytes) : " in \
        capsys.readouterr().out


def test_train_lm(tmp_path):
    twin = _twin("train_lm")
    cfg = twin.model_tiny()
    rcfg = RModelConfig(**dataclasses.asdict(cfg))
    rp = jax.jit(r_init_params, static_argnums=0)(rcfg,
                                                  jax.random.PRNGKey(0))
    args = argparse.Namespace(steps=3, batch=2, seq=16,
                              ckpt_dir=str(tmp_path), ckpt_every=2)
    params = params_from_reference(jax.tree.map(np.asarray, rp), cfg,
                                   device="cpu", dtype=torch.float32)
    got = twin.train(cfg, params, args, torch.device("cpu"), log_every=1)
    assert [s for s, _ in got] == [0, 1, 2]

    opt = RAdamWConfig(lr=6e-4, warmup_steps=20, total_steps=3)
    step = jax.jit(r_make_train_step(rcfg, opt))
    state = r_init_train_state(rcfg, rp)
    ds = RDataset(cfg.vocab, 16, 2, seed=0)
    for s, ce in got:
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in ds.batch(s).items()})
        np.testing.assert_allclose(ce, float(m["loss/ce"]), rtol=1e-5)

    # the same directory: resumes from the step-2 checkpoint
    again = twin.train(cfg, params,
                       argparse.Namespace(**{**vars(args), "steps": 1}),
                       torch.device("cpu"), log_every=1)
    assert again == [got[2]]
    run = twin.main(["--tiny", "--steps", "1", "--batch", "2", "--seq",
                     "16", "--ckpt-dir", str(tmp_path / "main"),
                     "--device", "cpu"])
    assert len(run) == 1 and np.isfinite(run[0][1])

