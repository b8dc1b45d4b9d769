"""The H100 dry-run (``repro_torch.launch.dryrun``) on the CPU.

* The reference test's cell (``tests/test_dryrun_cell.py``):
  musicgen-large ``decode_32k``, ``2x16x16`` through the CLI in a
  subprocess started with the module's first test, ``16x16`` through
  ``main`` in this process: ``status`` ok, 256 and 512 chips, flops above
  0, a dominant term, the reference record's keys and the H100's ``HW``;
  ``report`` renders the records. ``main --both-meshes`` records a cell
  the port refuses (a global batch of 1 over 16 ranks) as ``FAILED`` on
  both meshes and returns 1. A full-attention arch skips ``long_500k``.
* Exact counts: one spawned world of 4 gloo ranks
  (``tests/_torch_lm_ranks_worker.py``) runs steps of smoke configs under
  ``serve_tp (1, 4)`` (qwen3-8b prefill and decode, mamba2-1.3b prefill),
  ``default (2, 2)`` (qwen3-8b training, jamba's prefill, one period) and
  ``ep_dp (1, 4)`` (qwen2-moe training under remat none, block and dots);
  rank 0's ``MeshComm`` bytes sent and received and calls by kind equal
  the dry-run's for rank 0 of a ``DryMesh`` of the same shape, and the
  last rank's too where it differs (the decode step's and mamba's). The
  world runs after the other tests and the CLI, while this process
  waits.
  Under ``"dots"`` the MoE dispatch's ``a2a`` and ``rows`` calls equal
  ``"none"``'s and are fewer than ``"block"``'s, and the three losses are
  equal.
* Flops: the dry-run's count equals ``FlopCounterMode``'s count of the
  same plain step on real CPU tensors (one process; qwen2-moe's smoke
  config, training, prefill and decode), and the prefill step's lies
  within 0.75–1.05 of the reference's ``cost_analysis()["flops"]`` for the
  same smoke step on one device, its layers unrolled. Measured on the
  qwen3-8b and qwen2-moe smoke steps at S 64, B 2 (port / reference):
  train 1.0033 / 0.9715, prefill 0.9567 / 0.9604, decode 0.8063 / 0.9223;
  the port counts matrix products only, XLA element-wise work too.
* ``Meter``: the peak of live storage, on real tensors.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import _torch_lm_ranks_worker as worker
from repro.configs import smoke_config as r_smoke_config
from repro.models import init_params as r_init_params
from repro.models import init_caches as r_init_caches
from repro.train import make_prefill_step as r_make_prefill_step
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.collectives import KINDS
from repro_torch.launch import dryrun, report
from repro_torch.launch.roofline import HW
from repro_torch.models import init_caches, init_params
from repro_torch.sharding import ShardingRules
from repro_torch.train import (AdamWConfig, init_train_state,
                               make_decode_step, make_prefill_step,
                               make_train_step)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
REF_KEYS = {"status", "arch", "shape", "mesh", "chips", "flops_dev",
            "bytes_dev", "bytes_hlo_dev", "coll_dev", "t_compute_ms",
            "t_memory_ms", "t_collective_ms", "dominant", "model_flops",
            "useful_ratio", "roofline_frac", "peak_memory_gb", "profile",
            "t_lower_s", "t_compile_s", "coll_breakdown"}
WORLD = 4
# the cases whose last rank differs from rank 0 in what it sends: it owns
# the decode step's position; mamba's uneven regroup
LAST_RANK_TOO = ("qwen3_decode", "mamba_prefill")
# name -> (arch, layers (None: the smoke config's), mesh, profile, step,
#          seq, global batch, remat)
CASES = {
    "qwen3_prefill": ("qwen3-8b", None, (1, 4), "serve_tp", "prefill", 12,
                      2, "block"),
    "qwen3_decode": ("qwen3-8b", None, (1, 4), "serve_tp", "decode", 12, 2,
                     "block"),
    "mamba_prefill": ("mamba2-1.3b", None, (1, 4), "serve_tp", "prefill",
                      16, 2, "block"),
    "qwen3_train": ("qwen3-8b", None, (2, 2), "default", "train", 16, 4,
                    "block"),
    "jamba_prefill": ("jamba-v0.1-52b", 8, (2, 2), "default", "prefill", 16,
                      4, "block"),
    "moe_none": ("qwen2-moe-a2.7b", None, (1, 4), "ep_dp", "train", 16, 4,
                 "none"),
    "moe_block": ("qwen2-moe-a2.7b", None, (1, 4), "ep_dp", "train", 16, 4,
                  "block"),
    "moe_dots": ("qwen2-moe-a2.7b", None, (1, 4), "ep_dp", "train", 16, 4,
                 "dots"),
}


def _cfg(arch, layers, remat):
    cfg = dataclasses.replace(smoke_config(arch), remat=remat)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return tree.numpy()


def _world_case(name):
    arch, layers, mesh, profile, step, seq, gb, remat = CASES[name]
    cfg = _cfg(arch, layers, remat)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(5)
    s = seq if step != "decode" else 1
    case = {"kind": "step_counts", "mesh": mesh, "profile": profile,
            "cfg": cfg, "params": _np(params), "step": step, "seq": seq,
            "tokens": rng.integers(0, cfg.vocab, (gb, s)).astype(np.int32)}
    if step == "train":
        case["labels"] = rng.integers(0, cfg.vocab, (gb, s)).astype(
            np.int32)
    return case


def _dry_counts(name, rank):
    arch, layers, mesh, profile, step, seq, gb, remat = CASES[name]
    cfg = _cfg(arch, layers, remat)
    dmesh = dryrun.DryMesh(mesh, ("data", "model"), rank)
    rules = ShardingRules.for_mesh(dmesh, profile)
    cost = dryrun.run_step(cfg, ShapeConfig(name, seq, gb, step), dmesh,
                           rules)
    return {k: cost[k] for k in ("sent", "received", "calls")}


# ---------------------------------------------------------------------------
# the CLI's cell (beside the tests up to the world), refusals and skips
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def multi_pod_cli(tmp_path_factory):
    """The reference cell on ``2x16x16`` through the CLI, in a subprocess
    started with the module's first test; :func:`test_decode_cell_on_both
    _meshes_and_the_cli` runs the ``16x16`` one in this process meanwhile
    and reads both, and the spawned world waits for it to end."""
    out = tmp_path_factory.mktemp("cell")
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "musicgen-large", "--shape", "decode_32k", "--multi-pod", "--out",
         str(out)],
        env=dict(os.environ, PYTHONPATH=SRC), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        yield cli, out
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.communicate()


def test_refused_and_skipped_cells(tmp_path):
    rec, _ = dryrun.lower_cell("qwen3-8b", "long_500k", verbose=False)
    assert rec["status"] == "skipped"
    assert dryrun.main(["--arch", "jamba-v0.1-52b", "--shape", "long_500k",
                        "--both-meshes", "--out", str(tmp_path)]) == 1
    for tag in ("single", "multi"):
        with open(tmp_path / f"jamba-v0.1-52b__long_500k__{tag}.json") as f:
            failed = json.load(f)
        assert failed["status"] == "FAILED"
        assert "replicated" in failed["error"]


# ---------------------------------------------------------------------------
# flops and memory
# ---------------------------------------------------------------------------

STEPS = (("train", 64, 2), ("prefill", 64, 2), ("decode", 64, 2))


def _real_flops(cfg, kind, seq, gb):
    """FlopCounterMode's count of the plain step on real CPU tensors, no
    rules."""
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    s = seq if kind != "decode" else 1
    batch = {"tokens": torch.zeros((gb, s), dtype=torch.int32)}
    counter = FlopCounterMode(display=False)
    if kind == "train":
        batch["labels"] = torch.zeros((gb, s), dtype=torch.int32)
        state = init_train_state(cfg, params)
        with counter:
            make_train_step(cfg, AdamWConfig())(state, batch)
    else:
        caches = init_caches(cfg, gb, seq, device="cpu")
        if kind == "decode":
            caches = [c._replace(length=seq - 1) for c in caches]
        maker = make_prefill_step if kind == "prefill" else make_decode_step
        with counter:
            maker(cfg)(params, batch, caches)
    return float(counter.get_total_flops())


def _dry_flops(cfg, kind, seq, gb):
    mesh = dryrun.DryMesh((1, 1), ("data", "model"))
    return dryrun.run_step(cfg, ShapeConfig(kind, seq, gb, kind), mesh,
                           ShardingRules.for_mesh(mesh))["flops"]


@pytest.mark.parametrize("kind,seq,gb", STEPS)
def test_flops_equal_the_plain_step(kind, seq, gb):
    cfg = smoke_config("qwen2-moe-a2.7b")
    assert _dry_flops(cfg, kind, seq, gb) == _real_flops(cfg, kind, seq, gb)


def test_flops_near_the_reference():
    """The prefill step against the reference's XLA count, its layers
    unrolled (a scan body counts once)."""
    arch, (kind, seq, gb) = "qwen2-moe-a2.7b", STEPS[1]
    rcfg = dataclasses.replace(r_smoke_config(arch), remat="none",
                               unroll_layers=True, unroll_inner=True)
    rp = jax.jit(r_init_params, static_argnums=0)(rcfg,
                                                  jax.random.PRNGKey(0))
    compiled = jax.jit(r_make_prefill_step(rcfg, use_kernel=False)).lower(
        rp, {"tokens": jnp.zeros((gb, seq), jnp.int32)},
        r_init_caches(rcfg, gb, seq)).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    cfg = dataclasses.replace(smoke_config(arch), remat="none")
    ratio = _dry_flops(cfg, kind, seq, gb) / float(cost["flops"])
    assert 0.75 <= ratio <= 1.05, ratio


def test_meter_counts_the_peak_of_live_storage():
    meter = dryrun.Meter()
    with meter:
        x = torch.ones(1024, 256)                 # 1 MiB
        y = x * 2                                 # 2 MiB live
        v = y.view(256, 1024)                     # a view: no storage
        del y
        z = torch.cat([x, v.reshape(1024, 256)])  # 1 + 1 + 2 MiB
        del v
    assert meter.peak == 4 << 20
    assert meter.now == 3 << 20
    del z
    assert meter.now == 1 << 20


# ---------------------------------------------------------------------------
# the reference test's cell: 16x16 in this process, 2x16x16 from the CLI
# ---------------------------------------------------------------------------

def test_decode_cell_on_both_meshes_and_the_cli(capsys, multi_pod_cli):
    cli, out = multi_pod_cli
    assert dryrun.main(["--arch", "musicgen-large", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    assert "done: 1/1 cells ok" in capsys.readouterr().out
    stdout, stderr = cli.communicate(timeout=300)
    assert cli.returncode == 0, stderr[-3000:]
    assert "done: 1/1 cells ok" in stdout
    recs = []
    for tag in ("single", "multi"):
        with open(os.path.join(
                out, f"musicgen-large__decode_32k__{tag}.json")) as f:
            recs.append(json.load(f))
    rec, multi = recs
    assert report.main(["--dir", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "| musicgen-large | decode_32k | 16x16 | ok |" in printed
    assert "| musicgen-large | decode_32k | 2x16x16 | ok |" in printed
    for r, chips, mesh in ((rec, 256, "16x16"), (multi, 512, "2x16x16")):
        assert REF_KEYS <= set(r)
        assert r["status"] == "ok" and r["chips"] == chips
        assert r["mesh"] == mesh
        assert r["flops_dev"] > 0 and r["coll_dev"] >= 0
        assert r["dominant"] in ("compute", "memory", "collective")
        assert r["hw"] == HW
        assert r["coll_breakdown"]["total"] == r["coll_dev"]
        assert set(r["calls"]) == set(KINDS)
    # the model line's collectives: the TP sums and the sequence split
    assert rec["calls"]["tp"] > 0 and rec["calls"]["sp"] > 0
    assert rec["flops_dev"] == 2 * multi["flops_dev"]


# ---------------------------------------------------------------------------
# exact counts against the ranks (one world, after the tests above)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(multi_pod_cli):
    """The spawned world's results, ``{case name: {rank: result}}``: one
    world for every case, spawned when the first test below asks, once
    the CLI's cell has ended."""
    multi_pod_cli[0].wait(timeout=300)
    names = list(CASES)
    got = worker.spawn(WORLD, [_world_case(n) for n in names], limit_s=240)
    for rank, (status, payload) in got.items():
        assert status == "ok", payload
    assert len(got) == WORLD
    return {n: {r: got[r][1][i] for r in got} for i, n in enumerate(names)}


@pytest.mark.parametrize("name", list(CASES))
def test_dry_run_counts_equal_the_ranks(world, name):
    results = world
    for rank in (0, WORLD - 1) if name in LAST_RANK_TOO else (0,):
        got = results[name][rank]
        want = _dry_counts(name, rank)
        for what in ("sent", "received", "calls"):
            assert got[what] == want[what], (name, rank, what)
    assert sum(results[name][0]["calls"].values()) > 0


def test_dots_across_ranks_sends_no_dispatch_again(world):
    results = world
    calls = {r: results[f"moe_{r}"][0]["calls"]
             for r in ("none", "block", "dots")}
    for kind in ("a2a", "rows"):
        assert calls["dots"][kind] == calls["none"][kind] > 0
        assert calls["dots"][kind] < calls["block"][kind]
    for rank in range(WORLD):
        losses = [results[f"moe_{r}"][rank]["metrics"]["loss/total"]
                  for r in ("none", "block", "dots")]
        assert losses[0] == losses[1] == losses[2]
