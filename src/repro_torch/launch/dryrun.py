"""H100 dry-run: one rank's step of every (arch × shape × mesh) cell.

The port of ``repro.launch.dryrun``. The reference lowers and compiles each
cell's step on 512 placeholder host devices; here one rank of the
production mesh (rank 0) runs its step on the host under
``FakeTensorMode``, so nothing is allocated and no card is needed:

  * the mesh is a :class:`DryMesh` (the shape, the axis names and rank 0's
    coordinate; no process group), whose ``MeshComm`` is a :class:`DryComm`:
    ``MeshComm``'s methods and cost accounting, moving nothing. Each
    collective returns tensors of the shapes the peers would send and
    counts ``sent``, ``received`` and ``calls`` by kind exactly as
    ``MeshComm`` does on a process group;
  * the state, the batch and the caches are ``launch.specs``' stand-ins at
    rank 0's slice shapes, fake tensors on the CPU device, so the step runs
    the kernels' plain versions (``mha_ref``, ``moe_gemm_ref``), as the
    reference lowers with ``use_kernel=False``; no kernel is launched;
  * what the port refuses (``check_executable``, a batch the batch axes do
    not divide, which ``placement.batch_slab`` refuses) fails the cell with
    ``status: FAILED`` and the error, as the reference records a compile
    error.

Per cell, from the one full-depth run (the port's stack is a Python loop,
so every layer runs and is counted, and the reference's 1-/2-period
extrapolation is not needed):

  * ``flops_dev``: ``torch.utils.flop_counter.FlopCounterMode``'s count, the
    forward and the backward. It counts matrix products and convolutions
    only; XLA's ``cost_analysis()`` also counts element-wise work, so the
    reference's count is the larger for the same step;
  * ``peak_memory_gb``: the peak of the live fake storage across the step
    (:class:`Meter`: the state and the inputs included, as the reference's
    ``memory_analysis`` includes arguments). The plain versions hold what
    the card's kernels do not, the attention's (S, S) logits above all, so
    a prefill's or a training step's peak is above the card's. A peak past
    one card's 80 GB is recorded with ``status: "ok"``, as the reference
    records its ``memory_analysis``;
  * ``bytes_hlo_dev``: every op's reads and writes, unfused (the
    reference's raw ``cost_analysis`` bytes); the memory term uses
    ``roofline.bytes_model``, as the reference's does;
  * ``coll_breakdown``: ``roofline.collective_bytes`` of the comm's
    counts, keyed by ``MeshComm`` kind; ``sent``, ``received`` and
    ``calls`` by kind beside it.

Rank 0's numbers stand for the rank. Where a split is uneven, other ranks
differ: mamba's regroup sends each rank its own heads' columns and B and C
to every rank, a decode step writes its token only on the rank that owns
its position, a vocab or head count the line does not divide is left
whole or gathered. A decode cell's step runs at the cache's last position
(``seq_len - 1``), so it reads every cached position.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--out experiments/dryrun_torch]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from ..configs import SHAPES, get_config, list_archs
from ..configs.base import ShapeConfig
from ..core.collectives import KINDS, MeshComm, Transport
from ..sharding.placement import batch_slab
from ..sharding.rules import ShardingRules, check_executable, use_rules
from ..train import AdamWConfig, make_decode_step, make_prefill_step, \
    make_train_step
from .roofline import HW, Roofline, bytes_model, collective_bytes, \
    model_flops
from .specs import batch_specs, cache_specs, state_specs, tensors

__all__ = ["DryMesh", "DryComm", "Meter", "production_mesh", "run_step",
           "lower_cell", "main"]


# ---------------------------------------------------------------------------
# a mesh and its collectives, with no process group
# ---------------------------------------------------------------------------

class DryMesh:
    """A mesh of ``prod(shape)`` ranks that no process group backs: the
    dim names, the shape, the global ranks laid out in C order (``mesh``)
    and one rank's coordinate. It reads as a ``DeviceMesh`` does to
    ``sharding`` and ``core.collectives``; its ``MeshComm`` is a
    :class:`DryComm`."""

    def __init__(self, shape, names, rank: int = 0):
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(int(s) for s in shape)
        self.mesh = np.arange(math.prod(self.shape)).reshape(self.shape)
        self.rank = int(rank)

    @property
    def size(self) -> int:
        return int(self.mesh.size)

    def get_coordinate(self):
        return tuple(int(c) for c in np.unravel_index(self.rank, self.shape))

    def make_comm(self) -> "DryComm":
        return DryComm(self)


class _Landed:
    """A transfer of :class:`_DryTransport`: the received blocks, empty."""

    def __init__(self, recvs, device):
        self._out = [torch.empty(shape, dtype=dtype, device=device)
                     for _, shape, dtype, _ in recvs]

    def wait(self):
        return self._out


class _DryTransport(Transport):
    """A ``Transport`` that counts and moves nothing: a receive is an
    empty tensor of the shape the peer would send."""

    def __init__(self, device, rank: int):
        self.device = torch.device(device)
        self.rank = rank
        self.sent: Dict[str, int] = dict.fromkeys(KINDS, 0)
        self.received: Dict[str, int] = dict.fromkeys(KINDS, 0)

    def _exchange(self, kind, sends, recvs):
        self._count(kind, sends, recvs)
        return _Landed(recvs, self.device)


class DryComm(MeshComm):
    """``MeshComm`` on a :class:`DryMesh`: the same methods (``ranks``,
    ``size``, ``index``, ``exchange``, ``gather``, ``gather_to``,
    ``reduce``) and the same ``sent`` / ``received`` / ``calls`` by kind,
    as the mesh's rank; nothing moves and no process group is needed."""

    @property
    def rank(self) -> int:
        return self.mesh.rank

    def _transport(self, device):
        if device not in self._transports:
            t = _DryTransport(device, self.rank)
            t.sent, t.received = self.sent, self.received
            self._transports[device] = t
        return self._transports[device]

    def counts(self) -> dict:
        return {"sent": dict(self.sent), "received": dict(self.received),
                "calls": dict(self.calls)}


def production_mesh(multi_pod: bool = False, rank: int = 0) -> DryMesh:
    """``launch.mesh.make_production_mesh``'s shape and names: 16×16 = 256
    ranks per pod, 2 pods = 512 ranks multi-pod."""
    if multi_pod:
        return DryMesh((2, 16, 16), ("pod", "data", "model"), rank)
    return DryMesh((16, 16), ("data", "model"), rank)


# ---------------------------------------------------------------------------
# counting a step
# ---------------------------------------------------------------------------

class Meter(TorchDispatchMode):
    """Live storage bytes (``now``, ``peak``) and the bytes every op reads
    and writes (``accessed``; view ops excluded) under this mode. A
    storage counts from the op that makes it until it is freed; tensors on
    the ``meta`` device hold none."""

    def __init__(self):
        super().__init__()
        self.now = self.peak = self.accessed = 0
        self._live = WeakIdKeyDictionary()

    def _free(self, n: int) -> None:
        self.now -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._live:
            return
        n = st.nbytes()
        self._live[st] = n
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        held = lambda x: isinstance(x, torch.Tensor) \
            and x.device.type != "meta"
        outs = [t for t in tree_leaves(out) if held(t)]
        if not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs)) if held(t)]
            self.accessed += sum(t.numel() * t.element_size()
                                 for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


def _step_inputs(cfg, shape: ShapeConfig, mesh, rules, opts):
    """(the step function, its arguments) for ``cfg`` on this rank:
    stand-ins built where the caller's fake mode is active."""
    kw = dict(mesh=mesh, rules=rules, device="cpu")
    batch = batch_specs(cfg, shape, **kw)
    for leaf in batch.values():
        # a batch the batch axes do not divide: the port refuses it
        batch_slab(torch.empty(leaf.shape, device="meta"), rules)
    if shape.kind == "train":
        step = make_train_step(cfg, AdamWConfig(),
                               microbatches=opts.get("microbatches", 1))
        return step, (tensors(state_specs(cfg, **kw)), tensors(batch))
    maker = make_prefill_step if shape.kind == "prefill" \
        else make_decode_step
    caches = tensors(cache_specs(cfg, shape, **kw))
    if shape.kind == "decode":
        # the last position: every cached position is read
        caches = [c._replace(length=shape.seq_len - 1)
                  if hasattr(c, "length") else c for c in caches]
    params = tensors(state_specs(cfg, with_opt=False, **kw))
    return maker(cfg), (params, tensors(batch), caches)


def run_step(cfg, shape: ShapeConfig, mesh, rules: ShardingRules,
             opts: Optional[dict] = None) -> dict:
    """One rank's step of ``cfg`` at ``shape`` under ``rules`` on ``mesh``
    (a :class:`DryMesh`), run on fake tensors: ``"flops"``, ``"peak"``
    (live bytes), ``"bytes accessed"``, the comm's ``"sent"`` /
    ``"received"`` / ``"calls"`` by kind, ``"t_build_s"`` (the stand-ins)
    and ``"t_run_s"`` (the step)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from ..core.collectives import mesh_comm

    opts = opts or {}
    comm = mesh_comm(mesh)
    comm.reset_counts()
    check_executable(rules, cfg)
    meter = Meter()
    flops = FlopCounterMode(display=False)
    with FakeTensorMode(allow_non_fake_inputs=True), use_rules(rules):
        with meter:
            t0 = time.perf_counter()
            step, args = _step_inputs(cfg, shape, mesh, rules, opts)
            t_build = time.perf_counter() - t0
            meter.accessed = 0
            t0 = time.perf_counter()
            with flops:
                out = step(*args)
            t_run = time.perf_counter() - t0
        del out, args
    return {"flops": float(flops.get_total_flops()), "peak": meter.peak,
            "bytes accessed": float(meter.accessed), **comm.counts(),
            "t_build_s": t_build, "t_run_s": t_run}


def lower_cell(arch: str, shape_name, *, multi_pod: bool = False,
               opts: Optional[dict] = None, verbose: bool = True,
               cfg_override=None, mesh: Optional[DryMesh] = None):
    """Dry-run one cell; returns (record dict, the step's cost dict).

    ``shape_name``: a key of ``SHAPES`` or a ``ShapeConfig``; ``mesh``: a
    :class:`DryMesh` in place of the production mesh (its name is its
    shape joined by ``x``)."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    opts = opts or {}
    if opts.get("remat"):
        cfg = dataclasses.replace(cfg, remat=opts["remat"])
    if opts.get("attn_chunk"):
        cfg = dataclasses.replace(cfg, attn_chunk=opts["attn_chunk"])
    if mesh is None:
        mesh = production_mesh(multi_pod)
    mesh_name = "x".join(str(s) for s in mesh.shape)

    if shape.name == "long_500k" and not cfg.supports_long_context:
        return {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                "status": "skipped",
                "reason": "full-attention arch; long_500k needs "
                          "sub-quadratic mixing (DESIGN.md §5)"}, None

    chips = mesh.size
    rules = ShardingRules.for_mesh(mesh,
                                   profile=opts.get("profile", "default"))
    cost = run_step(cfg, shape, mesh, rules, opts)
    coll = collective_bytes(cost)
    flops = cost["flops"]
    byts = bytes_model(cfg, shape, tp=rules.tp_size,
                       batch_shards=rules.batch_size, chips=chips)

    rf = Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=byts,
        bytes_hlo=cost["bytes accessed"],
        coll_bytes_per_device=float(coll["total"]), coll_breakdown=coll,
        t_compute=flops / HW["peak_flops"],
        t_memory=byts / HW["hbm_bw"],
        t_collective=coll["total"] / HW["ici_bw"],
        model_flops=model_flops(cfg, shape),
        peak_memory_bytes=float(cost["peak"]))

    record = {"status": "ok", **rf.row(),
              "profile": opts.get("profile", "default"),
              "t_lower_s": round(cost["t_build_s"], 2),
              "t_compile_s": round(cost["t_run_s"], 2),
              "coll_breakdown": {k: int(v) for k, v in coll.items()},
              "sent": cost["sent"], "received": cost["received"],
              "calls": cost["calls"], "hw": dict(HW)}
    if verbose:
        print(json.dumps(record, indent=2, default=float))
    return record, cost


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--profile", default="default",
                    choices=["default", "dp_only", "serve_tp",
                             "ep_sharded", "ep_dp"])
    ap.add_argument("--remat", default=None,
                    choices=["none", "block", "dots"])
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = list_archs() if args.all else [args.arch]
    shapes = list(SHAPES) if args.all else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for a, s, mp in cells:
        tag = f"{a}__{s}__{'multi' if mp else 'single'}"
        if args.profile != "default":
            tag += f"__{args.profile}"
        if args.remat:
            tag += f"__remat-{args.remat}"
        if args.attn_chunk:
            tag += f"__ac{args.attn_chunk}"
        print(f"=== {tag} ===", flush=True)
        t0 = time.perf_counter()
        try:
            record, _ = lower_cell(
                a, s, multi_pod=mp,
                opts={"microbatches": args.microbatches,
                      "profile": args.profile, "remat": args.remat,
                      "attn_chunk": args.attn_chunk},
                verbose=not args.all)
        except Exception as e:
            failures += 1
            record = {"arch": a, "shape": s,
                      "mesh": "2x16x16" if mp else "16x16",
                      "status": "FAILED", "error": repr(e)}
            traceback.print_exc()
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(record, f, indent=2, default=float)
        print(f"--- {tag}: {record['status']} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    print(f"done: {len(cells) - failures}/{len(cells)} cells ok")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
