"""Rank worker for ``tests/test_torch_ranks.py``: one process of a gloo
group on the CPU, running a list of cases through the port's multi-rank
paths and handing each result back to the parent.

It imports only ``repro_torch``, torch and numpy — never ``jax`` or
``repro`` — so the spawned ranks do not import the JAX package (the test
module that spawns them does, for its oracles). Operands cross the process
boundary as plain arrays ``(shape, indptr, indices, data)``.

Cases (dicts, run in order; every rank runs every case):

* ``{"kind": "ring", "a", "b", "nparts", "bs", "chunk", "semiring"}`` —
  ``run_device_spgemm`` on a ``ring_mesh(nparts)``;
* ``{"kind": "summa", "a", "b", "grid", "layers", "bs", "semiring"}`` —
  ``run_device_summa`` on a ``(grid, grid, layers)`` mesh;
* either with ``"piece_bytes"``: the transport moves (and the Split-3D
  merge reduces) in pieces of that size;
* ``{"kind": "mesh", "shape"}`` — ``device_grid_mesh(shape, ("gr", "gc",
  "gl"))``: the coordinate, or the error it raises;
* ``{"kind": "session", "calls": [{"a", "b", **matmul kwargs}, ...],
  "faults": {rank: FaultInjector kwargs}, "launch_faults": {rank: n}}`` —
  one ``SpGEMMSession(device="cpu", group=WORLD)`` serving the calls in
  order; a call's ``"b_on": {rank: operand}`` swaps its B operand on the
  ranks named; ``launch_faults`` makes the ring's first n schedule runs on
  a rank raise, as a failed kernel launch would, mid-ring.

A ring / SUMMA result is ``{"c": arrays, "bytes": transport counts}``; a
session call's is ``{"ok": bool, "c" or "error", "stats", "last_call",
"bytes"}``.
"""

import datetime
import traceback

import numpy as np
import torch
import torch.distributed as dist

# the group's timeout: any wait longer than this raises, so a hang in a
# test ends in an error well inside the parent's join limit
GROUP_TIMEOUT_S = 30


def as_csc(arrs):
    from repro_torch.core.sparse import CSC

    shape, indptr, indices, data = arrs
    return CSC(np.asarray(indptr), np.asarray(indices), np.asarray(data),
               tuple(shape))


def arrays(c):
    return (tuple(c.shape), c.indptr, c.indices, c.data)


def _counts(t):
    return {"sent": dict(t.sent), "received": dict(t.received)}


def _transport(case):
    """A transport on the host; ``"piece_bytes"`` stands in for the
    module's 64 MiB pieces, which inputs this small never reach."""
    from repro_torch.core.collectives import Transport

    t = Transport("cpu")
    t.piece_bytes = case.get("piece_bytes", t.piece_bytes)
    return t


def _ring(case):
    from repro_torch.core import semiring as sr
    from repro_torch.core.device_common import ring_mesh
    from repro_torch.core.spgemm_1d_device import (build_device_plan,
                                                   run_device_spgemm)

    plan = build_device_plan(as_csc(case["a"]), as_csc(case["b"]),
                             nparts=case["nparts"], bs=case["bs"],
                             semiring=sr.by_name(case["semiring"]),
                             chunk=case["chunk"])
    t = _transport(case)
    c = run_device_spgemm(plan, device="cpu",
                          mesh=ring_mesh(case["nparts"]), transport=t)
    return {"c": arrays(c), "bytes": _counts(t)}


def _summa(case):
    from repro_torch.core import semiring as sr
    from repro_torch.core.device_common import device_grid_mesh
    from repro_torch.core.spgemm_2d_device import (SUMMA_AXES,
                                                   build_summa_plan,
                                                   run_device_summa)

    g, L = case["grid"], case["layers"]
    plan = build_summa_plan(as_csc(case["a"]), as_csc(case["b"]), grid=g,
                            layers=L, bs=case["bs"],
                            semiring=sr.by_name(case["semiring"]))
    t = _transport(case)
    c = run_device_summa(plan, device="cpu",
                         mesh=device_grid_mesh((g, g, L), SUMMA_AXES),
                         transport=t)
    return {"c": arrays(c), "bytes": _counts(t)}


def _mesh(case):
    from repro_torch.core.device_common import device_grid_mesh
    from repro_torch.core.validate import ValidationError

    try:
        mesh = device_grid_mesh(tuple(case["shape"]), ("gr", "gc", "gl"))
    except ValidationError as e:
        return {"error": type(e).__name__, "message": str(e)}
    return {"coordinate": mesh.get_coordinate()}


def _session(case, rank):
    from repro_torch.core import semiring as sr
    from repro_torch.core.session import SpGEMMSession
    from repro_torch.core.validate import SpGEMMError
    from repro_torch.runtime.fault_tolerance import RetryPolicy
    from repro_torch.runtime.faults import FaultInjector

    from repro_torch.core import spgemm_1d_device

    faults = case.get("faults", {}).get(rank)
    left = [case.get("launch_faults", {}).get(rank, 0)]
    run_schedule = spgemm_1d_device.run_schedule

    def failing(*args, **kw):
        if left[0]:
            left[0] -= 1
            raise RuntimeError("simulated launch failure")
        return run_schedule(*args, **kw)

    spgemm_1d_device.run_schedule = failing
    sess = SpGEMMSession(
        device="cpu", group=dist.group.WORLD,
        fault_injector=None if faults is None else FaultInjector(**faults),
        retry_policy=RetryPolicy(max_retries=2, backoff_s=0.0),
        retry_sleep=lambda s: None)
    out = []
    for call in case["calls"]:
        kw = dict(call)
        a, b = as_csc(kw.pop("a")), as_csc(kw.pop("b"))
        swap = kw.pop("b_on", {}).get(rank)
        if swap is not None:
            b = as_csc(swap)
        if "semiring" in kw:
            kw["semiring"] = sr.by_name(kw["semiring"])
        sess.transport.reset_counts()
        try:
            c = sess.matmul(a, b, **kw)
            res = {"ok": True, "c": arrays(c)}
        except SpGEMMError as e:
            res = {"ok": False, "error": type(e).__name__, "message": str(e)}
        res.update(stats=dict(sess.stats), last_call=dict(sess.last_call),
                   bytes=_counts(sess.transport))
        out.append(res)
    return out


def main(rank, world, init_file, cases, queue):
    """One rank: join the gloo group through ``init_file``, run ``cases``,
    put ``(rank, "ok", results)`` (or ``(rank, "error", traceback)``) on
    ``queue``."""
    torch.set_num_threads(1)  # ranks share the host's cores
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        out = []
        for case in cases:
            kind = case["kind"]
            out.append(_ring(case) if kind == "ring" else
                       _summa(case) if kind == "summa" else
                       _mesh(case) if kind == "mesh" else
                       _session(case, rank))
        queue.put((rank, "ok", out))
    except Exception:  # report to the parent, whatever failed
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
