#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; imports only ``repro_torch``, torch,
numpy and scipy. Phases (any failure exits non-zero and prints no result):

  1. build     — compile the bsr_spgemm kernel from the repo's sources
  2. kernel    — the kernel against its plain PyTorch version on the card:
                 3 semirings x bs in {16, 32, 64, 128}, runs of 1-8
                 products, a seg_start offset and an empty schedule;
                 integer-valued tiles bitwise, float plus-times within
                 rtol=1e-5, atol=1e-4 (summation order), bool / min-plus
                 bitwise
  3. main path — laplacian_2d(1024) (1,048,576 rows) A·A through
                 ``SpGEMMSession(device="cuda").matmul(algorithm="1d",
                 nparts=8, bs=128)`` with chunk=None and chunk=2, held
                 bitwise against scipy; a repeat must be a cache hit with
                 no new executable builds, values x2 must repack to C x4
  4. semirings — banded_clustered(65536, 64, 16.0) with integer weights,
                 bool_or_and and min_plus at nparts=8, bs=64, chunk=2,
                 bitwise against the port's host ``local_spgemm.spgemm``

Every main-path call must run on the kernel: ``fallbacks == 0``,
``last_call["engine"] == "cuda"`` and the kernel's launch count grows.
Prints one JSON line per phase, then the ``{"kernels": [...]}`` line, the
card's name and power limit, and last ``{"ok": true, "device": ...}``.
"""

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

# published rates of the H100 variants (NVIDIA data sheets, dense, at the
# full power limit): fp32 on the CUDA cores (FMA = 2 FLOP), HBM bandwidth
PEAKS = {
    "PCIe": (51.2e12, 2.0e12),
    "NVL": (60.0e12, 3.9e12),
    "SXM": (66.9e12, 3.35e12),
}
SEMIRINGS = ("plus_times", "bool_or_and", "min_plus")


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def peaks(name):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "SXM", PEAKS["SXM"]


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bitwise(x, y):
    return x.shape == y.shape and torch.equal(
        x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))


def phase_build():
    from repro_torch.kernels.bsr_spgemm import kernel

    info = kernel.build()
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": info["seconds"],
          "built": info["built"], "library": info["path"], "ptxas": regs})


def random_schedule(rng, na, nb, nruns):
    """A schedule sorted by output slot: ``nruns`` runs of 1-8 products."""
    from repro_torch.core.blocksparse import flags_from_c_slot

    lens = rng.integers(1, 9, size=nruns)
    c_slot = np.repeat(np.arange(nruns), lens).astype(np.int32)
    a_slot = rng.integers(0, na, size=len(c_slot)).astype(np.int32)
    b_slot = rng.integers(0, nb, size=len(c_slot)).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)])
    return a_slot, b_slot, c_slot, flags_from_c_slot(c_slot), starts


def phase_kernel(dev):
    """The kernel against its plain version on the card."""
    from repro_torch.core.semiring import by_name
    from repro_torch.kernels.bsr_spgemm.kernel import (bsr_spgemm,
                                                       run_starts_from_flags)
    from repro_torch.kernels.bsr_spgemm.ref import bsr_spgemm_ref

    rng = np.random.default_rng(0)
    cases, max_err = 0, 0.0
    for srname in SEMIRINGS:
        sr = by_name(srname)
        for bs in (16, 32, 64, 128):
            na, nb, nruns = 24, 24, 40
            a_slot, b_slot, c_slot, flags, starts = random_schedule(
                rng, na, nb, nruns)
            # windows: the whole schedule, one starting at run 5 (seg_start
            # offset) and ending 5 runs early, and an empty one
            windows = [(0, len(c_slot)),
                       (int(starts[5]), int(starts[nruns - 5] - starts[5])),
                       (int(starts[3]), 0)]
            put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            slots = [put(a_slot), put(b_slot), put(c_slot)]
            for kind in ("int", "float"):
                tiles = []
                for n in (na, nb):
                    vals = (rng.integers(-3, 4, size=(n, bs, bs))
                            if kind == "int" else
                            rng.standard_normal((n, bs, bs)))
                    vals = vals.astype(np.float32)
                    vals[rng.random((n, bs, bs)) < 0.5] = sr.zero
                    tiles.append(put(vals))
                for seg_start, nprod in windows:
                    rs = put(run_starts_from_flags(flags, seg_start, nprod))
                    got = bsr_spgemm(*tiles, *slots, rs, nprod=nprod,
                                     nc=nruns, bs=bs, semiring=sr,
                                     seg_start=seg_start)
                    want = bsr_spgemm_ref(*tiles, *slots, nc=nruns,
                                          semiring=sr, seg_start=seg_start,
                                          seg_len=nprod)
                    torch.cuda.synchronize()
                    if kind == "float" and srname == "plus_times":
                        ok = torch.allclose(got, want, rtol=1e-5, atol=1e-4)
                        err = float((got - want).abs().max())
                        max_err = max(max_err, err)
                    else:
                        ok = bitwise(got, want)
                    check(ok, f"kernel != plain version: {srname} bs={bs} "
                              f"{kind} window=({seg_start}, {nprod})")
                    cases += 1
    emit({"phase": "kernel_vs_plain", "cases": cases,
          "max_abs_err_float_plus_times": max_err})
    return max_err


def session_call(sess, kernel, a, b, **kw):
    """One main-path call: must run on the kernel, with no fallback."""
    before = kernel.bsr_spgemm.launches
    fallbacks = sess.stats["fallbacks"]
    t0 = time.perf_counter()
    c = sess.matmul(a, b, **kw)
    wall = time.perf_counter() - t0
    check(sess.stats["fallbacks"] == fallbacks,
          f"degradation ladder fell back: {sess.last_call}")
    check(sess.last_call["engine"] == "cuda",
          f"served by engine {sess.last_call['engine']!r}, not cuda")
    check(kernel.bsr_spgemm.launches > before, "the kernel was not launched")
    return c, wall


def decode_split(entry):
    """Host seconds of one cached call's decode, and of the ``from_coo``
    COO assembly inside it (the rest is the device prune and the copy of
    the surviving entries back to the host)."""
    from repro_torch.core import device_common

    raw = entry.fn(*entry.args)
    torch.cuda.synchronize()
    inner, spent = device_common.from_coo, []

    def timed(*args, **kw):
        t = time.perf_counter()
        try:
            return inner(*args, **kw)
        finally:
            spent.append(time.perf_counter() - t)

    device_common.from_coo = timed
    try:
        t0 = time.perf_counter()
        entry.decode(entry.plan, raw)
        total = time.perf_counter() - t0
    finally:
        device_common.from_coo = inner
    return {"decode_s": total, "from_coo_s": sum(spent)}


def same_csc(c, ref, what):
    check(c.shape == ref.shape, f"{what}: shape {c.shape} != {ref.shape}")
    check(np.array_equal(c.indptr, ref.indptr), f"{what}: indptr differs")
    check(np.array_equal(c.indices, ref.indices), f"{what}: indices differ")
    check(np.array_equal(c.data.view(np.int32),
                         ref.data.astype(np.float32).view(np.int32)),
          f"{what}: values differ")


def phase_main_path(dev, side=1024):
    """laplacian_2d(side)·itself through SpGEMMSession, against scipy."""
    import scipy.sparse as sp

    from repro_torch.core import CSC, laplacian_2d
    from repro_torch.core.device_common import REQUIRED_STATS
    from repro_torch.core.session import SpGEMMSession
    from repro_torch.kernels.bsr_spgemm import kernel

    a = laplacian_2d(side).astype(np.float32)
    a2 = CSC(a.indptr, a.indices, a.data * 2, a.shape)
    s = sp.csc_matrix((a.data.astype(np.float64), a.indices, a.indptr),
                      shape=a.shape)
    ref = (s @ s).tocsc()
    ref.eliminate_zeros()
    ref.sort_indices()
    ref_c = CSC(ref.indptr.astype(np.int64), ref.indices.astype(np.int64),
                ref.data, ref.shape)
    ref4 = CSC(ref_c.indptr, ref_c.indices, ref_c.data * 4, ref.shape)

    sess = SpGEMMSession(device=dev)
    kw = dict(algorithm="1d", nparts=8, bs=128)
    kernel.bsr_spgemm.launches = 0
    runs = {}
    for chunk in (None, 2):
        torch.cuda.reset_peak_memory_stats()
        c, wall_cold = session_call(sess, kernel, a, a, chunk=chunk, **kw)
        same_csc(c, ref_c, f"chunk={chunk} cold")
        cold = dict(sess.last_call)
        traces = sess.stats["traces"]
        c, wall_hit = session_call(sess, kernel, a, a, chunk=chunk, **kw)
        check(sess.last_call["cache_hit"], "repeat was not a cache hit")
        check(sess.stats["traces"] == traces, "cache hit rebuilt the ring")
        same_csc(c, ref_c, f"chunk={chunk} hit")
        c, wall_repack = session_call(sess, kernel, a2, a2, chunk=chunk,
                                      **kw)
        check(sess.last_call["repacked"], "values x2 did not repack")
        check(sess.stats["traces"] == traces, "repack rebuilt the ring")
        same_csc(c, ref4, f"chunk={chunk} repack")
        runs[chunk] = dict(cold=cold, wall_s=dict(
            cold=wall_cold, hit=wall_hit, repack=wall_repack),
            max_memory_allocated=torch.cuda.max_memory_allocated())
    launches = kernel.bsr_spgemm.launches

    entries = list(sess._cache.values())  # read-only: time the executables
    for chunk, entry in zip((None, 2), entries[:2]):
        plan = entry.plan
        r = runs[chunk]
        ms = cuda_ms(lambda: entry.fn(*entry.args), 3)
        split = decode_split(entry)
        emit({"phase": "main_path", "matrix": f"laplacian_2d({side})",
              "rows": a.shape[0], "nnz_a": a.nnz, "nnz_c": ref_c.nnz,
              "chunk": chunk, "nparts": 8, "bs": 128,
              "plan_seconds": plan.stats["plan_seconds"],
              "plan_and_build_seconds": r["cold"]["plan_seconds"],
              "execute_ms": ms, "wall_s": r["wall_s"], **split,
              "max_memory_allocated": r["max_memory_allocated"],
              "tile_products": plan.stats["nprod_total"],
              **{k: plan.stats[k] for k in REQUIRED_STATS}})
    emit({"phase": "main_path_counts", "launches": launches,
          "session_stats": sess.stats})
    return sess, entries[0].plan, entries[0].args, launches


def measure_kernel(dev, plan, args):
    """One launch over part 0's whole schedule at the main path's shapes
    (the unchunked plan), against the plain version on the same inputs."""
    from repro_torch.core.spgemm_1d_device import recv_index
    from repro_torch.kernels.bsr_spgemm.kernel import (bsr_spgemm,
                                                       run_starts_from_flags)
    from repro_torch.kernels.bsr_spgemm.ref import bsr_spgemm_ref

    P, bs, nc = plan.nparts, plan.bs, plan.nc_max + 1
    na = plan.a_tiles.shape[1]
    idx = np.concatenate([np.arange(na), recv_index(plan, range(P - 1))[0]])
    a_tiles, b_tiles, a_slot, b_slot, c_slot = args
    stack = a_tiles.reshape(P * na, bs, bs)[
        torch.from_numpy(idx.clip(min=0)).to(dev)]
    stack[torch.from_numpy(idx < 0).to(dev)] = plan.semiring.zero
    nprod = int(plan.a_slot.shape[1])
    real = int((plan.c_slot[0] < plan.nc_max).sum())
    rs = torch.from_numpy(run_starts_from_flags(plan.flags[0], 0, nprod)
                          ).to(dev)
    ins = (stack, b_tiles[0], a_slot[0], b_slot[0], c_slot[0])

    def kern():
        return bsr_spgemm(*ins, rs, nprod=nprod, nc=nc, bs=bs,
                          semiring=plan.semiring)

    def plain():
        return bsr_spgemm_ref(*ins, nc=nc, semiring=plan.semiring)

    got, want = kern(), plain()
    err = float((got - want).abs().max())
    check(bitwise(got, want), "main-path kernel != plain version")
    del got, want
    ms = cuda_ms(kern, 5)
    plain_ms = cuda_ms(plain, 2)
    name = torch.cuda.get_device_name(0)
    variant, (flops_peak, hbm) = peaks(name)
    flops = 2 * real * bs ** 3
    nbytes = sum(t.numel() * t.element_size() for t in ins) + rs.numel() * 4 \
        + nc * bs * bs * 4
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / hbm * 1e3
    emit({"phase": "kernel_timing", "part": 0, "tile_products": real,
          "padded_products": nprod, "flop": flops, "bytes": nbytes,
          "ms": ms, "plain_ms": plain_ms, "tflops": flops / ms / 1e9,
          "peaks_used": {"variant": variant, "fp32_flops": flops_peak,
                         "hbm_bytes_per_s": hbm}})
    return dict(ms=ms, plain_ms=plain_ms, err=err,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def phase_semirings(dev, sess, n=65536):
    """bool_or_and and min_plus at scale, against the host oracle."""
    from repro_torch.core import banded_clustered, by_name
    from repro_torch.core.device_common import REQUIRED_STATS
    from repro_torch.core.local_spgemm import spgemm
    from repro_torch.kernels.bsr_spgemm import kernel

    a = banded_clustered(n, 64, 16.0, seed=0)
    a.data[:] = np.rint(2 * a.data)
    a.data[a.data == 0] = 1.0
    a = a.astype(np.float32)
    for srname in ("bool_or_and", "min_plus"):
        sr = by_name(srname)
        before = kernel.bsr_spgemm.launches
        torch.cuda.reset_peak_memory_stats()
        c, wall = session_call(sess, kernel, a, a, algorithm="1d", nparts=8,
                               bs=64, chunk=2, semiring=sr)
        launches = kernel.bsr_spgemm.launches - before
        mem = torch.cuda.max_memory_allocated()
        plan_and_build = sess.last_call["plan_seconds"]
        same_csc(c, spgemm(a, a, sr), srname)
        entry = next(reversed(sess._cache.values()))  # the cold call's
        ms = cuda_ms(lambda: entry.fn(*entry.args), 3)
        emit({"phase": "semiring", "semiring": srname,
              "matrix": f"banded_clustered({n}, 64, 16.0, seed=0)",
              "nparts": 8, "bs": 64, "chunk": 2,
              "plan_seconds": entry.plan.stats["plan_seconds"],
              "plan_and_build_seconds": plan_and_build, "execute_ms": ms,
              "wall_s": wall, "max_memory_allocated": mem,
              "launches": launches,
              **{k: entry.plan.stats[k] for k in REQUIRED_STATS}})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from a checkout of the repo (src/ holds "
              "repro_torch)", file=sys.stderr)
        return 2
    # the plain version's float32 products stay full precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    try:
        phase_build()
        grid_err = phase_kernel(dev)
        sess, plan, args, launches = phase_main_path(dev)
        timing = measure_kernel(dev, plan, args)
        phase_semirings(dev, sess)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except Exception:  # report, then fail the run
        traceback.print_exc()
        return 1
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": [{
        "name": "bsr_spgemm", "route": "cuda",
        "source": "src/repro_torch/kernels/bsr_spgemm/csrc/bsr_spgemm.cu",
        "replaces": "src/repro/kernels/bsr_spgemm/kernel.py:92",
        "launches": launches,
        "max_abs_err": max(grid_err, timing["err"]),
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
