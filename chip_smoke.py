#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; imports only ``repro_torch``, torch,
numpy and scipy. Phases (any failure exits non-zero and prints no result):

  1. build     — compile the kernels' ten sources from the repo, one
                 nvcc each, all started together; report the four
                 bsr_spgemm sources' ptxas lines and the ``tc``, ``warp``
                 and ``minplus`` routes' dynamic shared memory
  2. kernel    — the three bsr_spgemm routes against the plain PyTorch
                 version on the card: 3 semirings x bs in {16, 32, 64, 128}
                 through the wrapper (every semiring at bs 16/32 on the
                 ``warp`` route, plus_times and bool_or_and at bs 64/128 on
                 ``tc``, min_plus at bs 64/128 on ``minplus``; the first
                 kernel, ``simt``, on no route, directly beside each), runs
                 of 1-8 products, a seg_start offset and an empty schedule,
                 min-plus also with NaNs planted (its plain version on the
                 CPU); on ``warp`` and ``tc`` also odd integers in
                 2049-4093 (not TF32-exact; one nonzero per row and column,
                 runs of one product), inf / -inf / NaN / |x| >= 2^127
                 planted for plus_times and bool_or_and, products at
                 overflow magnitudes (nextafter(2^64, 0) squared and
                 negated, 2e19 squared, a pair whose product is FLT_MAX,
                 exact products under and over 2^126; one nonzero term an
                 output element), and for every semiring windows whose runs
                 leave gaps and whose nc runs past the last visited slot
                 (the output starts as NaN: every slot must be written) and
                 a window made only of pad products; on ``minplus`` (and
                 ``simt`` beside it) runs of 1-4 products and one of 80,
                 which the worker shares cut, +inf and NaN planted, gaps,
                 pads after the runs and pads only; integer-valued tiles
                 bitwise, float plus-times within rtol=1e-5, atol=1e-4
                 (summation order, the TF32 split), bool / min-plus bitwise
                 (a NaN matching any NaN), every launch on a route repeated
                 bitwise
  3. main path — laplacian_2d(1024) (1,048,576 rows) A·A through
                 ``SpGEMMSession(device="cuda").matmul(algorithm="1d",
                 nparts=8, bs=128)`` with chunk=None and chunk=2, held
                 bitwise against scipy; a repeat must be a cache hit with
                 no new executable builds, values x2 must repack to C x4;
                 every launch on the ``tc`` route. Then part 0's launch
                 timed on both routes: integer payloads, the same schedule
                 with every value x (1 + 2^-12) (not TF32-exact: up to four
                 passes), the ``simt`` kernel with its fill as
                 ``previous_ms``, and fp32 ``torch.bmm`` of the gathered
                 products as a yardstick that is not the same function
  4. semirings — banded_clustered(65536, 64, 16.0) with integer weights,
                 bool_or_and (``tc``) and min_plus (``minplus``) at bs=64
                 through the 1D ring (nparts=8, chunk=2), 2D SUMMA (grid
                 2) and Split-3D (grid 2, 2 layers), and min_plus at bs=128
                 through the 1D ring unchunked, each bitwise against the
                 port's host ``local_spgemm.spgemm``, each on its own rung;
                 each 1D call's largest launch timed beside the plain
                 version and, for min-plus, the ``simt`` kernel with its
                 fill (``previous_ms``; CUDA events, device time in 11)
  4a. minplus_main — |laplacian_2d(1024)| (a grid graph's edge weights)
                 A (x) A in min-plus, one path-doubling step, through the 1D
                 ring (nparts=8, bs=128, unchunked), every launch on
                 ``minplus``, bitwise against the host oracle; part 0's
                 launch (23,228 products) bitwise against the plain version
                 on the card, repeated, and timed beside it and ``simt``
  4b. default_bs — the session at its default bs (32) and BC's (16), all
                 on the ``warp`` route: laplacian_2d(1024)^2 through the 1D
                 ring with ``bs`` left out, chunk=None and chunk=2, and at
                 bs=16, chunk=None, cold then hit, bitwise against scipy,
                 the execute ms beside the bs-128 ring's; part 0's launch at
                 bs 32 and 16 timed as in phase 3 (``previous_ms``: the
                 ``simt`` kernel with its fill, which is also timed alone);
                 bool_or_and at bs 16 and min_plus at bs 32 on
                 banded_clustered through the ring (chunk=2), bitwise
                 against the host oracle, each call's largest launch timed
                 beside ``simt`` and the plain version
  5. summa     — the main path's laplacian_2d(1024)² through
                 ``SpGEMMSession(device="cuda").matmul(algorithm="2d",
                 grid=2, bs=128)`` and ``algorithm="3d", grid=2,
                 layers=2``: cold, hit and values x2 repack, bitwise
                 against scipy, no downgrade, every launch on ``tc``; per
                 call the peak device memory (the 2D call's must stay below
                 30 GB; the 3D call's below a whole (8, nc_max + 1) output
                 stack), the executable's time (CUDA events), the plan and
                 decode seconds, and the planned / padded bytes of the 1D
                 ring, 2D SUMMA and Split-3D side by side
  5a. apps     — the paper's applications through ``repro_torch.apps``,
                 each on its own ``SpGEMMSession(device="cuda")`` at its
                 default bs, every launch on ``warp``, no profiler window:
                 (a) AMG ``galerkin_product`` of laplacian_2d(1024) with
                 ``restriction_operator(a, 100)`` (8 parts, bs 32), cold
                 then two hits, bitwise against scipy's RᵀAR; (b) a
                 CountSketch stream (dim 256, A·Sᵀ) over four integer value
                 sets on the Laplacian's structure: one cold call and three
                 repacks, bitwise against scipy; (c) ``mcl`` of
                 block_diagonal_noise(262144, 4096, 8, 0.05), on the kernel,
                 on the plain version (clusters and iterations equal,
                 operators within rtol 1e-4, atol 1e-6) and again on the
                 kernel's session (all hits, bitwise); (d) ``bc_batch`` of a
                 symmetrized block_diagonal_noise(262144, 1024, 5, 0.3), 128
                 seeded sources, bs 16, on the kernel and on the plain
                 version (depths and call counts equal, scores within rtol
                 1e-5), every backward call a hit with a repack; (e) MCL
                 killed by an injected execute fault in its fourth
                 iteration and BC by a fault on its first backward call,
                 each resumed from its snapshots, bitwise. Per run: calls,
                 hits, repacks, wall, planning, repack, decode and app host
                 seconds, execute ms (CUDA events), launches by route, peak
                 device memory, the largest deviation from the reference
  6. build_lm  — load the flash_attention and moe_gemm libraries (for
                 flash_attention the CUDA-core source and the bf16 and
                 split-TF32 tensor-core ones; for moe_gemm the CUDA-core
                 source, the bf16 tensor-core one and the split-TF32 one);
                 ptxas's registers, spills and shared memory per kernel,
                 and the tensor-core kernels' dynamic shared memory
                 (flash_attention bf16 per padded head dim 64 / 128 / 192 /
                 256; float32 per padded head dim 32 ... 256 with its query
                 and key block, held against the host's ``fp32_config`` at
                 every head dim the route takes; moe_gemm float32's
                 blocking and shared memory, the same at every shape,
                 held against its host ``fp32_config``)
  7. flash_attention_vs_plain — both routes against ``mha_ref`` on the
                 card, causal, window in {0, 64}, softcap in {0, 50}, Hq = 8
                 with Hkv in {8, 2}: bfloat16 on the tensor-core route at D
                 in {16, 64, 96, 128, 160, 256} and S in {77, 128, 129,
                 1000, 2048}, within atol 2e-2 + rtol 1e-2 (one bf16 ulp of
                 the output); float32 on the split-TF32 route at D in {16,
                 64, 96, 128, 160, 192, 256} and S in {77, 128, 1000},
                 within atol 2e-5 + rtol 1e-4; each launch repeated,
                 bitwise
  8. serve_smoke — ``python -m repro_torch.launch.serve --arch
                 qwen2-moe-a2.7b --smoke`` on the card in a process of its
                 own (float32, head dim 16): must exit 0
  9. moe_gemm_vs_plain — every route of the kernel against
                 ``moe_gemm_ref`` on the card: E in {1, 64}, cap in {8, 16,
                 96, 688} (bf16: the decode route up to 16, the prefill
                 route above; float32: the split-TF32 ``fp32`` route at
                 every cap), (d, f) in
                 {(2048, 1408), (1408, 2048), (640, 72), (200, 72)}; rows
                 None, all cap, all 0, random, and the 128-row tile edges
                 63-65 and 127-129; integer-valued float32 bitwise, float32
                 within atol 1e-4 + rtol 1e-4, bfloat16 within atol 2e-2 +
                 rtol 1e-2; inf, NaN and 3e38 planted in float32 x and w
                 must give the plain version's inf / NaN pattern, the
                 finite outputs within the float32 tolerance; every launch
                 repeated, bitwise (a NaN matching any NaN)
  10. lm_serve — qwen2-moe-a2.7b at its full published size (24 layers, 64
                 padded experts, bf16 weights from a seeded generator)
                 through ``ServeEngine.generate``: four prompts of 2048,
                 1536, 1024 and 512 tokens, 32 new tokens, greedy,
                 sync_every=8. The launch counts must be exactly 24
                 flash_attention launches (one prefill, all on the bf16
                 tensor-core route) and 72 moe_gemm
                 launches per forward (the prefill's on the prefill route,
                 the decode steps' on the decode route); a second generate
                 must repeat the tokens; no logit may be NaN or inf. The
                 inputs (``rows`` included) of one
                 layer's attention call and of its grouped GEMMs, in prefill
                 and in a decode step, are captured by wrapping the model's
                 op references, and each kernel is held against its plain
                 version on them and timed beside the plain version, the
                 library call (SDPA, ``bmm``), the bound and the earlier
                 CUDA-core kernel on the same bf16 inputs (``previous_ms``;
                 grouped GEMMs as device time from torch.profiler); the
                 attention inputs cast to float32 time the fp32 route
                 beside SDPA in float32 and the CUDA-core kernel in float32
                 (``previous_ms``), its bound counted as three TF32 passes
                 at the tensor-core peak, the fp32 CUDA-core bound beside
                 it. A torch.profiler window over a
                 prefill-only and a 5-token generate splits device time by
                 kernel. A 512-token bf16 prefill through the plain versions
                 is compared with the kernels' logits (reported), and the
                 model at full width cut to 2 layers in float32 must give
                 the same prefill and decode logits through the kernels as
                 through the plain versions, within 1e-3 of the largest
                 logit; that float32 run is the fp32 route's path (its
                 launches counted: 3 a MoE layer in the prefill and 3 in
                 the decode step; the prefill's up and down GEMMs and the
                 decode step's up GEMM timed, the bound counted as three
                 TF32 passes; at the decode GEMM also the CUDA-core kernel
                 on the live rows, ``cuda_core_rows_ms``)
  11. minplus_split — the three timed min-plus launches (phases 4 and 4a)
                 again from host copies of their inputs, under
                 torch.profiler: the product kernel's and the combine
                 pass's device time, and the ``simt`` kernel's with its
                 fill; last, because profiler windows opened before the LM
                 phases made theirs drop kernel records

Every main-path call must run on the kernel: ``fallbacks == 0``,
``last_call["engine"] == "cuda"`` and the kernel's launch count grows.
Bounds: max(bytes / HBM, operations / peak), the peak of the work's type:
fp32 FMA on the CUDA cores, TF32 or bf16 on the tensor cores.
Prints one JSON line per phase, then the ``{"kernels": [...]}`` line, the
card's name and power limit, and last ``{"ok": true, "device": ...}``.
"""

import contextlib
import gc
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

# published rates of the H100 variants (NVIDIA data sheets, dense, at the
# full power limit): fp32 on the CUDA cores (FMA = 2 FLOP), HBM bandwidth,
# bf16 and TF32 on the tensor cores
PEAKS = {
    "PCIe": (51.2e12, 2.0e12, 756e12, 378e12),
    "NVL": (60.0e12, 3.9e12, 835e12, 417.5e12),
    "SXM": (66.9e12, 3.35e12, 989.4e12, 494.7e12),
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


def profiled(fn, reps):
    """``torch.profiler``'s device events of ``reps`` calls of ``fn`` after
    one warm-up, summed by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, reps):
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls after
    one warm-up: the summed durations of the kernels it launched, from
    ``torch.profiler``. Unlike CUDA events around back-to-back launches, a
    host that enqueues more slowly than a short kernel runs does not
    inflate it. A profile that recorded no device time (one did on the
    card) is taken again; a second such profile gives way to CUDA events,
    as a line of its own says."""
    for _ in range(2):
        total = sum(ev.self_device_time_total for ev in profiled(fn, reps))
        if total > 0:
            return total / 1e3 / reps
    emit({"profiler": "recorded no device time twice",
          "timed_by": "cuda events"})
    return cuda_ms(fn, reps)


def kernel_ms(fn, reps):
    """Per kernel name, the mean device milliseconds of one launch and the
    launches the profiler recorded, over ``reps`` calls of ``fn``: a mean
    over the recorded launches, so a record the profiler drops (one did on
    the card) does not lower it."""
    return {ev.key: {"ms": ev.self_device_time_total / 1e3 / ev.count,
                     "recorded": ev.count}
            for ev in profiled(fn, reps) if ev.count}


def bitwise(x, y):
    return x.shape == y.shape and torch.equal(
        x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))


def bitwise_or_nan(x, y):
    """Bitwise equal, a NaN matching any NaN (its sign and payload are not
    part of the result)."""
    nan = torch.isnan(y)
    return (x.shape == y.shape and torch.equal(torch.isnan(x), nan)
            and bitwise(x[~nan], y[~nan]))


def ptxas_lines(log):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def phase_build():
    """Every kernel source built in parallel; the four bsr_spgemm
    libraries loaded."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.bsr_spgemm import kernel
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.moe_gemm import kernel as mg

    infos = cuda_lib.compile_sources([*kernel.SOURCES, *fa.SOURCES,
                                      *mg.SOURCES])
    kernel.build()
    smem = {kernel.TC_SOURCE: ("tc", kernel.TC_BS),
            kernel.WARP_SOURCE: ("warp", kernel.WARP_BS),
            kernel.MINPLUS_SOURCE: ("minplus", kernel.TC_BS)}
    for src in kernel.SOURCES:
        info = infos[src]
        extra = ({"dynamic_smem_bytes": {
            f"bs{bs}": kernel.smem_bytes(smem[src][0], bs)
            for bs in smem[src][1]}} if src in smem else {})
        emit({"phase": "build", "kernel": src.stem,
              "seconds": info["seconds"], "built": info["built"],
              "library": info["path"], "ptxas": ptxas_lines(info["log"]),
              **extra})
    return infos


def random_schedule(rng, na, nb, nruns, lens=None, nc=None):
    """A schedule sorted by output slot: ``nruns`` runs of 1-8 products
    (or of ``lens``), on slots 0..nruns-1 or, given ``nc``, on a sorted
    random subset of [0, nc - 1) that leaves gaps."""
    from repro_torch.core.blocksparse import flags_from_c_slot

    if lens is None:
        lens = rng.integers(1, 9, size=nruns)
    slots = (np.arange(nruns) if nc is None else
             np.sort(rng.choice(nc - 1, size=nruns, replace=False)))
    c_slot = np.repeat(slots, lens).astype(np.int32)
    a_slot = rng.integers(0, na, size=len(c_slot)).astype(np.int32)
    b_slot = rng.integers(0, nb, size=len(c_slot)).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)])
    return a_slot, b_slot, c_slot, flags_from_c_slot(c_slot), starts


def plant(rng, tiles, values):
    """Each tile with one element set to ``values[t % len(values)]``, at a
    random place."""
    tiles = tiles.copy()
    for t in range(len(tiles)):
        r, c = rng.integers(0, tiles.shape[1], size=2)
        tiles[t, r, c] = values[t % len(values)]
    return tiles


def odd_tiles(rng, n, bs):
    """One nonzero per row and column, odd integers in 2049..4093: not
    TF32-exact (lo = +-1, so the lo.lo pass is needed), and each exact
    product of two stays below 2**24."""
    vals = np.zeros((n, bs, bs), np.float32)
    for t in range(n):
        vals[t, np.arange(bs), rng.permutation(bs)] = \
            rng.integers(1024, 2047, size=bs) * 2 + 1
    return vals


# operand pairs at overflow magnitudes (C3): x = nextafter(2**64, 0), whose
# TF32 hi rounds up to 2**64, so the split's hi.hi overflows where x * x
# does not; 2e19 squared, past FLT_MAX either way; 2**63 times
# nextafter(2**65, 0) = FLT_MAX; exact products below 2**127 under and over
# the kernels' 2**126 pair bound
_X = float(np.nextafter(np.float32(2.0 ** 64), np.float32(0)))
OVERFLOW_PAIRS = [(_X, _X), (-_X, _X), (2e19, 2e19),
                  (2.0 ** 63, float(np.nextafter(np.float32(2.0 ** 65),
                                                 np.float32(0)))),
                  (2.0 ** 100, 2.0 ** 20), (3 * 2.0 ** 62, 2.0 ** 63)]


def overflow_tiles(rng, bs):
    """One diagonal A and B tile per pair of ``OVERFLOW_PAIRS``: small
    nonzero integers, the pair at one place (a different k-panel from tile
    to tile); product t is A tile t times B tile t, so every output element
    has one nonzero term."""
    n = len(OVERFLOW_PAIRS)
    a = np.zeros((n, bs, bs), np.float32)
    b = np.zeros((n, bs, bs), np.float32)
    for t, (x, y) in enumerate(OVERFLOW_PAIRS):
        d = (37 * t + 5) % bs
        for m in (a, b):
            m[t, np.arange(bs), np.arange(bs)] = rng.choice(
                [-3, -2, -1, 1, 2, 3], size=bs)
        a[t, d, d], b[t, d, d] = x, y
    return a, b


class RouteCheck:
    """Holds bsr_spgemm launches against the plain version, per route (and
    the first kernel, ``simt``, on no route): integer-valued and bool /
    min-plus results bitwise (a NaN matching any NaN), float plus-times
    within rtol=1e-5, atol=1e-4; a launch given ``repeat`` repeated must be
    bitwise equal."""

    def __init__(self):
        self.cases = {"tc": 0, "warp": 0, "minplus": 0, "simt": 0}
        self.max_err = dict.fromkeys(self.cases, 0.0)

    def __call__(self, name, got, want, exact, label, repeat=None):
        torch.cuda.synchronize()
        if exact:
            ok = bitwise_or_nan(got, want)
        else:
            ok = torch.allclose(got, want, rtol=1e-5, atol=1e-4)
            self.max_err[name] = max(self.max_err[name],
                                     float((got - want).abs().max()))
        check(ok, f"bsr_spgemm {name} != plain version: {label}")
        if repeat is not None:
            check(bitwise(repeat(), got),
                  f"a repeated bsr_spgemm {name} launch differs: {label}")
        self.cases[name] += 1


def phase_kernel(dev):
    """Every bsr_spgemm route against its plain version on the card."""
    from repro_torch.core.blocksparse import flags_from_c_slot
    from repro_torch.core.semiring import by_name
    from repro_torch.kernels.bsr_spgemm import kernel
    from repro_torch.kernels.bsr_spgemm.ref import bsr_spgemm_ref

    rng = np.random.default_rng(0)
    held = RouteCheck()
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def run(name, tiles, slots, rs, nprod, nc, bs, sr, seg_start=0,
            fill=None):
        """One launch of route ``name`` (through the wrapper when it is
        the route the wrapper picks) into an output prefilled with
        ``fill``."""
        out = torch.full((nc, bs, bs), float("nan") if fill is None
                         else fill, device=dev)
        if name == kernel.route(sr, bs):
            return kernel.bsr_spgemm(*tiles, *slots, rs, nprod=nprod, nc=nc,
                                     bs=bs, semiring=sr, seg_start=seg_start,
                                     out=out)
        kernel._launch(name, *tiles, *slots, rs, out, bs=bs, semiring=sr)
        return out

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
            slots = [put(a_slot), put(b_slot), put(c_slot)]
            routes = [kernel.route(sr, bs)]
            if routes[0] != "simt":
                routes.append("simt")    # the previous kernel, same inputs
            # min-plus also with a NaN planted in every third tile; its
            # plain version runs on the CPU, where torch.minimum and the
            # segment amin propagate NaN as the reference's jnp.minimum does
            kinds = ("int", "float") + (("nan",) if srname == "min_plus"
                                        else ())
            for kind in kinds:
                tiles = []
                for n in (na, nb):
                    vals = (rng.standard_normal((n, bs, bs))
                            if kind == "float" else
                            rng.integers(-3, 4, size=(n, bs, bs)))
                    vals = vals.astype(np.float32)
                    vals[rng.random((n, bs, bs)) < 0.5] = sr.zero
                    if kind == "nan":
                        vals = plant(rng, vals, [np.nan, 0.0, 1.0])
                    tiles.append(put(vals))
                for seg_start, nprod in windows:
                    rs = put(kernel.run_starts_from_flags(flags, seg_start,
                                                          nprod))
                    on = (lambda t: t.cpu()) if kind == "nan" else (
                        lambda t: t)
                    want = bsr_spgemm_ref(
                        *map(on, tiles), *map(on, slots), nc=nruns,
                        semiring=sr, seg_start=seg_start,
                        seg_len=nprod).to(dev)
                    if kind == "nan" and nprod:
                        check(bool(torch.isnan(want).any())
                              and bool(torch.isfinite(want).any()),
                              f"min-plus NaN case bs={bs} lacks NaN or "
                              f"finite outputs")
                    for name in routes if nprod else routes[:1]:
                        def launch(name=name):
                            if not nprod:
                                return kernel.bsr_spgemm(
                                    *tiles, *slots, rs, nprod=0, nc=nruns,
                                    bs=bs, semiring=sr, seg_start=seg_start)
                            return run(name, tiles, slots, rs, nprod, nruns,
                                       bs, sr, seg_start)
                        held(name, launch(), want,
                             kind != "float" or srname != "plus_times",
                             f"{srname} bs={bs} {kind} "
                             f"window=({seg_start}, {nprod})",
                             repeat=(launch if name != "simt" else None))

    # the tensor-core routes' own cases: warp at bs 16 and 32, tc at 64 and
    # 128
    for bs in (*kernel.WARP_BS, *kernel.TC_BS):
        name = kernel.route(by_name("plus_times"), bs)
        na = nb = 16
        # odd integers past 2048, runs of one product: exact only with the
        # lo.lo term
        a_slot, b_slot, c_slot, flags, _ = random_schedule(
            rng, na, nb, 24, lens=np.ones(24, np.int64))
        tiles = [put(odd_tiles(rng, na, bs)), put(odd_tiles(rng, nb, bs))]
        slots = [put(a_slot), put(b_slot), put(c_slot)]
        rs = put(kernel.run_starts_from_flags(flags, 0, len(c_slot)))
        want = bsr_spgemm_ref(*tiles, *slots, nc=24)
        check(float(want.max()) > 2049.0 ** 2, "odd-integer case too small")
        launch = lambda: run(name, tiles, slots, rs, len(c_slot), 24, bs,
                             by_name("plus_times"))
        held(name, launch(), want, True, f"odd integers bs={bs}",
             repeat=launch)
        # infinities and NaNs among odd integers past 2048 and among
        # integers, with |x| >= 2**127 in A (FLT_MAX's hi rounds to
        # infinity) against B in -1..1: the kernel sums such panels unsplit
        # on the CUDA cores. No product overflows (a fused multiply-add and
        # a rounded product disagree there), and runs of one product leave
        # each output element at most one huge finite term, so no sum
        # depends on its order. bool takes the same tiles (inf and NaN are
        # true, as x != 0 makes them)
        inf = np.float32(np.inf)
        for srname, kind in (("plus_times", "int"), ("plus_times", "odd"),
                             ("bool_or_and", "odd")):
            sr = by_name(srname)
            if kind == "odd":
                a, b = odd_tiles(rng, na, bs), odd_tiles(rng, nb, bs)
                a = plant(rng, a, [inf, -inf, np.nan])
            else:
                a, b = (rng.integers(lo, hi, size=(n, bs, bs)).astype(
                    np.float32) for lo, hi, n in ((-3, 4, na), (-1, 2, nb)))
                a = plant(rng, a, [inf, -inf, np.nan,
                                   np.finfo(np.float32).max,
                                   np.float32(-1.5 * 2.0 ** 127)])
            tiles = [put(a), put(plant(rng, b, [np.nan, inf, -inf]))]
            want = bsr_spgemm_ref(*tiles, *slots, nc=24, semiring=sr)
            for test in ((torch.isnan, torch.isposinf, torch.isneginf,
                          torch.isfinite) if srname == "plus_times" else ()):
                check(bool(test(want).any()), f"non-finite case lacks "
                      f"{test.__name__}")
            launch = lambda: run(name, tiles, slots, rs, len(c_slot), 24, bs,
                                 sr)
            held(name, launch(), want, True,
                 f"{srname}: inf / NaN / huge among {kind} integers bs={bs}",
                 repeat=launch)
        # products at overflow magnitudes (C3), runs of one product: where
        # the split's hi.hi overflows the kernel sums the panel unsplit, as
        # the plain version does; bool booleanizes first
        a, b = overflow_tiles(rng, bs)
        n = len(OVERFLOW_PAIRS)
        tiles = [put(a), put(b)]
        o_c = np.sort(rng.choice(n + 2, size=n, replace=False)).astype(
            np.int32)
        o_slots = [put(np.arange(n, dtype=np.int32)),
                   put(np.arange(n, dtype=np.int32)), put(o_c)]
        o_rs = put(kernel.run_starts_from_flags(flags_from_c_slot(o_c), 0, n))
        for srname in ("plus_times", "bool_or_and"):
            sr = by_name(srname)
            want = bsr_spgemm_ref(*tiles, *o_slots, nc=n + 3, semiring=sr)
            if srname == "plus_times":
                diag = want[:, torch.arange(bs), torch.arange(bs)]
                check(bool((diag == float(np.finfo(np.float32).max)).any())
                      and bool(torch.isposinf(diag).any()),
                      f"overflow case bs={bs} lacks FLT_MAX or inf")
            launch = lambda: run(name, tiles, o_slots, o_rs, n, n + 3, bs, sr)
            held(name, launch(), want, True,
                 f"{srname}: products at overflow magnitudes bs={bs}",
                 repeat=launch)
        # gapped windows and pad-only windows, every semiring on its route
        # (each kernel fills the identity itself)
        for srname in SEMIRINGS:
            sr = by_name(srname)
            name = kernel.route(sr, bs)
            # runs on a sorted subset of the slots, nc past the last one
            nruns, nc = 30, 3 * 30 + 7
            a_slot, b_slot, c_slot, flags, starts = random_schedule(
                rng, na, nb, nruns, nc=nc - 6)
            tiles = []
            for n in (na, nb):
                vals = rng.integers(-3, 4, size=(n, bs, bs)).astype(
                    np.float32)
                vals[rng.random((n, bs, bs)) < 0.5] = 0.0
                tiles.append(put(vals))
            slots = [put(a_slot), put(b_slot), put(c_slot)]
            for seg_start, nprod in ((0, len(c_slot)),
                                     (int(starts[4]),
                                      int(starts[20] - starts[4]))):
                rs = put(kernel.run_starts_from_flags(flags, seg_start,
                                                      nprod))
                want = bsr_spgemm_ref(*tiles, *slots, nc=nc, semiring=sr,
                                      seg_start=seg_start, seg_len=nprod)
                launch = lambda: run(name, tiles, slots, rs, nprod, nc, bs,
                                     sr, seg_start)
                held(name, launch(), want, True,
                     f"gapped {srname} bs={bs} window=({seg_start}, "
                     f"{nprod}) nc={nc}", repeat=launch)
            # pad products after the last run, into the garbage slot nc - 1,
            # run starts the ring's way (the pad run dropped): the whole
            # window, and a window made only of pads (no run: the kernel
            # fills every slot)
            npad = 5
            pad_c = np.concatenate([c_slot, np.full(npad, nc - 1, np.int32)])
            pad_slots = [put(np.concatenate([a_slot, a_slot[:npad]])),
                         put(np.concatenate([b_slot, b_slot[:npad]])),
                         put(pad_c)]
            pad_flags = flags_from_c_slot(pad_c)
            for seg_start, nprod in ((0, len(pad_c)), (len(c_slot), npad)):
                starts_np = kernel.run_starts_from_flags(pad_flags, seg_start,
                                                         nprod)
                if pad_c[starts_np[-2]] == nc - 1:
                    starts_np = starts_np[:-1]
                rs = put(starts_np)
                real = int(starts_np[-1] - seg_start)
                want = bsr_spgemm_ref(*tiles, *pad_slots, nc=nc, semiring=sr,
                                      seg_start=seg_start, seg_len=real)
                launch = lambda: run(name, tiles, pad_slots, rs, nprod, nc,
                                     bs, sr, seg_start)
                held(name, launch(), want, True,
                     f"pad products {srname} bs={bs} window=({seg_start}, "
                     f"{nprod}), {real} real", repeat=launch)
    phase_minplus_kernel(dev, rng, held, put, run)
    emit({"phase": "kernel_vs_plain", "cases": held.cases,
          "max_abs_err_float_plus_times": held.max_err,
          "tolerance": {"integer_bool_min_plus": "bitwise, NaN as any NaN",
                        "float_plus_times": {"rtol": 1e-5, "atol": 1e-4},
                        "repeat_routes": "bitwise"}})
    return held.max_err


def phase_minplus_kernel(dev, rng, held, put, run):
    """The ``minplus`` route's own cases at bs 64 and 128, ``simt`` beside
    it: runs of 1-4 products and one of 80, which the worker shares cut, on
    a sorted subset of the slots (gaps, nc past the last), integer tiles
    with +inf and a NaN planted in every third tile; the whole window, a
    seg_start offset, pad products after the runs and a window of pads only
    (every slot +inf); the output prefilled with NaN, each launch repeated
    bitwise, the plain version on the CPU (its NaN rules are the
    reference's)."""
    from repro_torch.core.blocksparse import flags_from_c_slot
    from repro_torch.core.semiring import MIN_PLUS
    from repro_torch.kernels.bsr_spgemm import kernel
    from repro_torch.kernels.bsr_spgemm.ref import bsr_spgemm_ref

    na = nb = 24
    for bs in kernel.TC_BS:
        name = kernel.route(MIN_PLUS, bs)
        check(name == "minplus", f"min_plus at bs {bs} is routed to {name}")
        nruns, nc = 60, 3 * 60 + 7
        lens = rng.integers(1, 5, size=nruns)
        lens[17] = 80
        a_slot, b_slot, c_slot, flags, starts = random_schedule(
            rng, na, nb, nruns, lens=lens, nc=nc - 6)
        tiles = []
        for n in (na, nb):
            vals = rng.integers(-3, 4, size=(n, bs, bs)).astype(np.float32)
            vals[rng.random((n, bs, bs)) < 0.3] = np.inf
            vals[::3] = plant(rng, vals[::3], [np.nan])
            tiles.append(vals)
        npad = 5
        pad_c = np.concatenate([c_slot, np.full(npad, nc - 1, np.int32)])
        slots = [np.concatenate([a_slot, a_slot[:npad]]),
                 np.concatenate([b_slot, b_slot[:npad]]), pad_c]
        pad_flags = flags_from_c_slot(pad_c)
        on_card = [put(t) for t in tiles + slots]
        workers = kernel.minplus_workers(bs, dev)
        for label, seg_start, nprod, fl in (
                ("whole", 0, len(c_slot), flags),
                ("offset", int(starts[4]), int(starts[50] - starts[4]), flags),
                ("pads after", 0, len(pad_c), pad_flags),
                ("pads only", len(c_slot), npad, pad_flags)):
            rs_np = kernel.run_starts_from_flags(fl, seg_start, nprod)
            if pad_c[rs_np[-2]] == nc - 1:
                rs_np = rs_np[:-1]
            rs = put(rs_np)
            real = int(rs_np[-1] - seg_start)
            if real:
                want = bsr_spgemm_ref(
                    *map(torch.from_numpy, tiles + slots), nc=nc,
                    semiring=MIN_PLUS, seg_start=seg_start,
                    seg_len=real).to(dev)
            else:
                want = torch.full((nc, bs, bs), float("inf"), device=dev)
            cut = int((kernel.minplus_shares(rs_np, workers, bs)[1]
                       >= 0).sum())
            if label == "whole":
                check(cut > 0 and bool(torch.isnan(want).any())
                      and bool(torch.isfinite(want).any()),
                      f"minplus case bs={bs} cuts no run or lacks NaN or "
                      f"finite outputs")
            for route in (name, "simt"):
                launch = lambda route=route: run(route, on_card[:2],
                                                 on_card[2:], rs, nprod, nc,
                                                 bs, MIN_PLUS, seg_start)
                held(route, launch(), want, True,
                     f"min_plus {label} bs={bs} window=({seg_start}, "
                     f"{nprod}), {real} real, {cut} cut runs",
                     repeat=launch)


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


def laplacian_case(side=1024):
    """laplacian_2d(side) in float32, its values x2, and scipy's products
    A·A and (2A)·(2A)."""
    import scipy.sparse as sp

    from repro_torch.core import CSC, laplacian_2d

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
    return dict(side=side, a=a, a2=a2, ref=ref_c, ref4=ref4)


def phase_main_path(dev, case):
    """laplacian_2d(1024)·itself through SpGEMMSession, against scipy."""
    from repro_torch.core.device_common import REQUIRED_STATS
    from repro_torch.core.session import SpGEMMSession
    from repro_torch.kernels.bsr_spgemm import kernel

    side, a, a2 = case["side"], case["a"], case["a2"]
    ref_c, ref4 = case["ref"], case["ref4"]
    sess = SpGEMMSession(device=dev)
    kw = dict(algorithm="1d", nparts=8, bs=128)
    kernel.reset_launches()
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
    routes = dict(kernel.bsr_spgemm.route_launches)
    check(routes["tc"] == launches and launches > 0,
          f"main-path launches off the tc route: {routes}")

    entries = list(sess._cache.values())  # read-only: time the executables
    execute_ms = {}
    for chunk, entry in zip((None, 2), entries[:2]):
        plan = entry.plan
        r = runs[chunk]
        ms = execute_ms[chunk] = cuda_ms(lambda: entry.fn(*entry.args), 3)
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
          "route_launches": routes, "session_stats": sess.stats})
    ring = {k: entries[0].plan.stats[k] for k in
            ("comm_bytes_planned", "comm_bytes_padded", "messages")}
    return sess, entries[0].plan, entries[0].args, launches, ring, execute_ms


def tc_pass_panels(a_tiles, b_tiles, a_slot, b_slot, bs):
    """Tensor-core passes the ``tc`` and ``warp`` kernels run over these
    products: per product and k-panel (32 deep, or bs below 32), hi.hi plus
    one pass for each operand whose panel holds an element that is not
    TF32-exact, plus lo.lo when both do."""
    depth = min(bs, 32)
    kp = bs // depth

    def inexact(t, a_side):              # (tiles, kp) flags
        low = (t.view(torch.int32) & 0x1FFF) != 0
        if a_side:                       # an A panel is `depth` columns
            return low.view(t.shape[0], bs, kp, depth).any(3).any(1)
        return low.view(t.shape[0], kp, depth * bs).any(2)   # B: rows

    fa = inexact(a_tiles, True)[a_slot.long()]
    fb = inexact(b_tiles, False)[b_slot.long()]
    return int((1 + fa.int() + fb.int() + (fa & fb).int()).sum())


def launch_bytes(a_slot, b_slot, rs, nc, bs):
    """Bytes a launch must move: each A and B tile that the window's real
    products (``rs[0]`` to ``rs[-1]``) read, once; their three slots and the
    run starts; each of the ``nc`` output tiles, written once. Returns the
    bytes and the counts of A and B tiles read."""
    first, end = int(rs[0]), int(rs[-1])
    read = [int(torch.unique(t[first:end]).numel()) for t in (a_slot, b_slot)]
    return ((nc + sum(read)) * bs * bs * 4 + 3 * 4 * (end - first)
            + nbytes(rs)), read


def bounds(moved, fp32_flop, pass_panels, bs):
    """Least times (ms) for the work: bytes over HBM, ``fp32_flop`` over
    the CUDA-core fp32 peak, and ``pass_panels`` TF32 passes of a k-panel
    (2 bs^2 min(bs, 32) flop each) over the tensor-core peak."""
    variant, (fp32, hbm, _, tf32) = peaks(torch.cuda.get_device_name(0))
    depth = min(bs, 32)
    return {"bytes_ms": moved / hbm * 1e3,
            "fp32_ops_ms": fp32_flop / fp32 * 1e3,
            "tf32_ops_ms": pass_panels * 2 * bs * bs * depth / tf32 * 1e3,
            "peak_variant": variant, "hbm_bytes_per_s": hbm,
            "fp32_flops": fp32, "tf32_flops": tf32}


def part0_inputs(dev, plan, args):
    """Part 0's launch of an unchunked 1D plan as the ring makes it: the
    gathered A stack (its own tiles, then what the ring brings, absent ones
    at the identity) and its B stack, its schedule slots, and the host run
    starts."""
    from repro_torch.core.spgemm_1d_device import _run_starts, recv_index

    P, bs, sr = plan.nparts, plan.bs, plan.semiring
    na = plan.a_tiles.shape[1]
    idx = np.concatenate([np.arange(na), recv_index(plan, range(P - 1))[0]])
    a_tiles, b_tiles, a_slot, b_slot, c_slot = args
    stack = a_tiles.reshape(P * na, bs, bs)[
        torch.from_numpy(idx.clip(min=0)).to(dev)]
    stack[torch.from_numpy(idx < 0).to(dev)] = sr.zero
    starts = _run_starts(plan, 0, 0, int(plan.a_slot.shape[1]))
    return (stack, b_tiles[0]), (a_slot[0], b_slot[0], c_slot[0]), starts


def measure_kernel(dev, plan, args):
    """Part 0's launch of the unchunked plan, with the ring's own run
    starts, on its route, against the plain version on the same inputs:
    integer payloads (one TF32 pass), the same schedule with every value x
    (1 + 2^-12) (not TF32-exact), the ``simt`` kernel with its identity
    fill as ``previous_ms`` (and the fill alone), and fp32 ``torch.bmm`` of
    the gathered products (a yardstick: no segment sum, so not the same
    function)."""
    from repro_torch.kernels.bsr_spgemm import kernel
    from repro_torch.kernels.bsr_spgemm.ref import bsr_spgemm_ref

    bs, nc, sr = plan.bs, plan.nc_max + 1, plan.semiring
    name = kernel.route(sr, bs)
    ints, slots, starts = part0_inputs(dev, plan, args)
    nprod = int(plan.a_slot.shape[1])
    real = int(starts[-1] - starts[0])
    rs = torch.from_numpy(starts).to(dev)
    scaled = tuple(t * (1 + 2 ** -12) for t in ints)
    out = torch.empty((nc, bs, bs), dtype=torch.float32, device=dev)

    def launch(route, tiles):
        kernel._launch(route, *tiles, *slots, rs, out, bs=bs, semiring=sr)
        return out

    def plain(tiles):
        return bsr_spgemm_ref(*tiles, *slots, nc=nc, semiring=sr,
                              seg_len=real)

    want = plain(ints)
    for route in dict.fromkeys((name, "simt")):
        check(bitwise(launch(route, ints), want),
              f"main-path launch at bs {bs} on {route} != plain version")
    del want
    want = plain(scaled)
    got = launch(name, scaled)
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-4),
          f"main-path launch at bs {bs} x (1 + 2^-12) != plain version: "
          f"{err}")
    del want, got
    ms = cuda_ms(lambda: launch(name, ints), 5)
    float_ms = cuda_ms(lambda: launch(name, scaled), 5)
    previous_ms = cuda_ms(lambda: launch("simt", ints), 5)
    fill_ms = cuda_ms(lambda: out.fill_(sr.zero), 5)
    plain_ms = cuda_ms(lambda: plain(ints), 2)
    ga = ints[0][slots[0][:real].long()]
    gb = ints[1][slots[1][:real].long()]
    gout = torch.empty_like(ga)
    bmm_ms = cuda_ms(lambda: torch.bmm(ga, gb, out=gout), 3)
    del ga, gb, gout
    flop = 2 * real * bs ** 3
    moved, read = launch_bytes(slots[0], slots[1], rs, nc, bs)
    passes = tc_pass_panels(*ints, slots[0][:real], slots[1][:real], bs)
    passes_f = tc_pass_panels(*scaled, slots[0][:real], slots[1][:real], bs)
    del scaled
    bd, bd_f = (bounds(moved, flop, n, bs) for n in (passes, passes_f))
    emit({"phase": "kernel_timing", "part": 0, "bs": bs, "route": name,
          "tile_products": real, "padded_products": nprod,
          "runs": len(starts) - 1, "output_tiles": nc, "flop": flop,
          "bytes": moved, "output_bytes": nc * bs * bs * 4,
          "tiles_read": read,
          "tf32_pass_panels": {"integer": passes, "scaled": passes_f},
          "ms": ms, "float_ms": float_ms, "previous_ms": previous_ms,
          "previous_fill_ms": fill_ms,
          "previous_ms_less_fill": previous_ms - fill_ms,
          "plain_ms": plain_ms, "bmm_products_ms": bmm_ms,
          "float_max_abs_err": err, "tflops_fp32_work": flop / ms / 1e9,
          "bounds": bd, "float_tf32_ops_ms": bd_f["tf32_ops_ms"]})
    return dict(ms=ms, plain_ms=plain_ms, err=err, route=name, bs=bs,
                bound_ms=max(bd["bytes_ms"], bd["tf32_ops_ms"]),
                bound_by=("operations" if bd["tf32_ops_ms"] >= bd["bytes_ms"]
                          else "bytes"),
                previous_ms=previous_ms, previous_fill_ms=fill_ms,
                float_ms=float_ms,
                float_bound_ms=max(bd["bytes_ms"], bd_f["tf32_ops_ms"]),
                fp32_bound_ms=max(bd["bytes_ms"], bd["fp32_ops_ms"]),
                bmm_products_ms=bmm_ms, tile_products=real)


def largest_launch(kernel, fn):
    """The arguments of the bsr_spgemm call with the most products in one
    run of ``fn``; the calls of that run count on the spy, not on the
    kernel's counters."""
    inner, best = kernel.bsr_spgemm, {}

    def spy(*args, **kw):
        if kw["nprod"] > best.get("nprod", -1):
            best.update(nprod=kw["nprod"], args=args, kw=kw)
        return inner(*args, **kw)

    spy.launches, spy.route_launches = 0, dict(inner.route_launches)
    kernel.bsr_spgemm = spy
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        kernel.bsr_spgemm = inner
    return best["args"], best["kw"]


def time_semiring_launch(kernel, args, kw):
    """A captured launch on its route against the plain version: bitwise,
    then both timed, beside the bound of its work."""
    from repro_torch.kernels.bsr_spgemm.ref import bsr_spgemm_ref

    sr, bs, nc = kw["semiring"], kw["bs"], kw["nc"]
    tiles, slots, rs = args[:2], args[2:5], args[5]
    seg_start = kw.get("seg_start", 0)
    first, end = int(rs[0]), int(rs[-1])
    real = end - first
    name = kernel.route(sr, bs)
    out = torch.empty((nc, bs, bs), dtype=torch.float32, device=rs.device)

    def launch():
        kernel._launch(name, *tiles, *slots, rs, out, bs=bs, semiring=sr)
        return out

    def plain():
        return bsr_spgemm_ref(*tiles, *slots, nc=nc, semiring=sr,
                              seg_start=seg_start, seg_len=end - seg_start)

    def previous():
        kernel._launch("simt", *tiles, *slots, rs, out, bs=bs, semiring=sr)
        return out

    check(bitwise(launch(), plain()),
          f"{sr.name} launch on {name} != plain version")
    ms, plain_ms = cuda_ms(launch, 5), cuda_ms(plain, 2)
    extra = {}
    if name != "simt":   # the earlier kernel, with its fill, same inputs
        check(bitwise(previous(), plain()),
              f"{sr.name} launch on simt != plain version")
        extra["previous_ms"] = cuda_ms(previous, 5)
    if name == "minplus":
        extra.update(minplus_stats(kernel, f"bs{bs}", tiles, slots, rs, nc,
                                   bs))
    moved, read = launch_bytes(slots[0], slots[1], rs, nc, bs)
    if sr.name != "min_plus":   # bool: booleanized operands, one TF32 pass
        bd = bounds(moved, 2 * real * bs ** 3, tc_pass_panels(
            (tiles[0] != 0).float(), (tiles[1] != 0).float(),
            slots[0][first:end], slots[1][first:end], bs), bs)
        t_ops = bd["tf32_ops_ms"]
    else:              # min-plus: an add and a min a term, each at the
        # fp32 instruction rate, half the FMA FLOP rate
        bd = bounds(moved, 4 * real * bs ** 3, 0, bs)
        t_ops = bd["fp32_ops_ms"]
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": max(t_ops, bd["bytes_ms"]),
            "bound_by": "operations" if t_ops >= bd["bytes_ms"] else "bytes",
            "route": name, "bs": bs, "tile_products": real,
            "output_tiles": nc, "bytes": moved, "tiles_read": read,
            "bounds": bd, **extra}


# host copies of the timed minplus launches' inputs, by launch: profiled
# last (phase_minplus_split)
MINPLUS_INPUTS = {}


def minplus_stats(kernel, label, tiles, slots, rs, nc, bs):
    """A ``minplus`` launch's shape: its runs, its longest run, its workers
    and the runs their shares cut. Its inputs are kept on the host for
    :func:`phase_minplus_split`."""
    rs_np = rs.cpu().numpy()
    workers = kernel.minplus_workers(bs, rs.device)
    heads = kernel.minplus_shares(rs_np, workers, bs)[1]
    MINPLUS_INPUTS[label] = ([t.cpu() for t in (*tiles, *slots, rs)], nc,
                             bs)
    return {"runs": len(rs_np) - 1,
            "longest_run": int(np.diff(rs_np).max(initial=0)),
            "workers": workers, "cut_runs": int(np.unique(heads[heads >= 0])
                                                .size)}


def phase_minplus_split(dev):
    """The timed minplus launches again, from their kept inputs, under
    ``torch.profiler``: the mean duration of each of the route's two
    kernels, the product and the combine pass, and their sum; and the sum
    of the ``simt`` kernel's and its fill's (device time, which the host's
    enqueue rate cannot inflate). It runs after the LM phases, so that
    their profiler windows are the process's first: on the card, windows
    opened earlier left later ones dropping kernel records."""
    from repro_torch.core.semiring import MIN_PLUS
    from repro_torch.kernels.bsr_spgemm import kernel

    split = {}
    for label, (ts, nc, bs) in MINPLUS_INPUTS.items():
        a, b, a_slot, b_slot, c_slot, rs = (t.to(dev) for t in ts)
        out = torch.empty((nc, bs, bs), dtype=torch.float32, device=dev)
        reps = 20 if nc * bs * bs < 2 ** 26 else 5
        by_kernel, previous = (kernel_ms(lambda route=route: kernel._launch(
            route, a, b, a_slot, b_slot, c_slot, rs, out, bs=bs,
            semiring=MIN_PLUS), reps) for route in ("minplus", "simt"))
        main = [v for k, v in by_kernel.items() if "minplus_kernel" in k]
        combine = [v for k, v in by_kernel.items() if "minplus_combine" in k]
        check(len(main) == 1 and len(combine) == 1,
              f"the minplus launch ran other kernels: {sorted(by_kernel)}")
        split[label] = {"main_ms": main[0]["ms"],
                        "combine_ms": combine[0]["ms"],
                        "device_ms": main[0]["ms"] + combine[0]["ms"],
                        "previous_device_ms": sum(v["ms"] for v in
                                                  previous.values()),
                        "profiled_launches": {"main": main[0]["recorded"],
                                              "combine":
                                                  combine[0]["recorded"],
                                              "calls": reps}}
        del a, b, a_slot, b_slot, c_slot, rs, out
    MINPLUS_INPUTS.clear()
    emit({"phase": "minplus_split", **split})
    return split


SEMIRING_CALLS = (("1d", dict(nparts=8, chunk=2)), ("2d", dict(grid=2)),
                  ("3d", dict(grid=2, layers=2)))


def phase_semirings(dev, sess, n=65536):
    """bool_or_and (``tc``) and min_plus (``minplus``) at scale through the
    1D ring, 2D SUMMA and Split-3D at bs 64, against the host oracle; the
    1D call's largest launch timed on its route (launch (a) for min-plus);
    then min_plus at bs 128 through the 1D ring, unchunked, its largest
    launch timed (launch (b)). Launches are counted per call (reset just
    before, read just after) and summed per semiring."""
    from repro_torch.core import banded_clustered, by_name
    from repro_torch.core.device_common import REQUIRED_STATS
    from repro_torch.core.local_spgemm import spgemm
    from repro_torch.kernels.bsr_spgemm import kernel

    a = banded_clustered(n, 64, 16.0, seed=0)
    a.data[:] = np.rint(2 * a.data)
    a.data[a.data == 0] = 1.0
    a = a.astype(np.float32)
    timings = {}
    for srname, want_route in (("bool_or_and", "tc"),
                               ("min_plus", "minplus")):
        sr = by_name(srname)
        want = spgemm(a, a, sr)
        launches = 0
        for alg, geo in SEMIRING_CALLS:
            kernel.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            c, wall = session_call(sess, kernel, a, a, algorithm=alg, bs=64,
                                   semiring=sr, **geo)
            routes = dict(kernel.bsr_spgemm.route_launches)
            check(routes[want_route] > 0
                  and sum(routes.values()) == routes[want_route],
                  f"{srname} {alg} at bs 64 ran off the {want_route} route: "
                  f"{routes}")
            check(sess.last_call["algorithm"] == alg
                  and not sess.last_call["degraded"],
                  f"{srname} {alg} was served by another rung: "
                  f"{sess.last_call}")
            launches += routes[want_route]
            mem = torch.cuda.max_memory_allocated()
            plan_and_build = sess.last_call["plan_seconds"]
            same_csc(c, want, f"{srname} {alg}")
            entry = next(reversed(sess._cache.values()))  # the cold call's
            ms = cuda_ms(lambda: entry.fn(*entry.args), 3)
            row = {"phase": "semiring", "semiring": srname,
                   "algorithm": alg,
                   "matrix": f"banded_clustered({n}, 64, 16.0, seed=0)",
                   "bs": 64, **geo,
                   "plan_seconds": entry.plan.stats["plan_seconds"],
                   "plan_and_build_seconds": plan_and_build,
                   "execute_ms": ms, "wall_s": wall,
                   "max_memory_allocated": mem,
                   "launches": sum(routes.values()), "route_launches": routes,
                   **{k: entry.plan.stats[k] for k in REQUIRED_STATS}}
            if alg == "1d":
                t = time_semiring_launch(kernel, *largest_launch(
                    kernel, lambda: entry.fn(*entry.args)))
                timings[srname] = row["largest_launch"] = t
            emit(row)
        timings[srname]["launches"] = launches
    # launch (b): min-plus at bs 128, the 1D ring unchunked, against the
    # loop's last oracle (min-plus)
    check(sr.name == "min_plus", "launch (b) is not min-plus")
    kernel.reset_launches()
    c, wall = session_call(sess, kernel, a, a, algorithm="1d", bs=128,
                           semiring=sr, nparts=8, chunk=None)
    routes = dict(kernel.bsr_spgemm.route_launches)
    check(routes["minplus"] > 0 and sum(routes.values()) == routes["minplus"],
          f"min_plus 1d at bs 128 ran off the minplus route: {routes}")
    same_csc(c, want, "min_plus 1d bs 128")
    entry = next(reversed(sess._cache.values()))
    t = time_semiring_launch(kernel, *largest_launch(
        kernel, lambda: entry.fn(*entry.args)))
    t["launches"] = routes["minplus"]
    timings["min_plus_bs128"] = t
    emit({"phase": "semiring", "semiring": "min_plus", "algorithm": "1d",
          "matrix": f"banded_clustered({n}, 64, 16.0, seed=0)", "bs": 128,
          "nparts": 8, "chunk": None, "wall_s": wall,
          "execute_ms": cuda_ms(lambda: entry.fn(*entry.args), 3),
          "route_launches": routes, "largest_launch": t})
    return timings


def phase_minplus_main(dev, side=1024):
    """Launch (c): laplacian_2d(side) with |values| as a grid graph's edge
    weights, A (x) A in min-plus (one path-doubling step) through
    ``SpGEMMSession`` on the 1D ring (nparts=8, bs=128, unchunked), every
    launch on ``minplus``, bitwise against the host oracle; then part 0's
    launch held bitwise against the plain version on the card and timed
    beside it and the ``simt`` kernel with its fill."""
    from repro_torch.core import MIN_PLUS, laplacian_2d
    from repro_torch.core.local_spgemm import spgemm
    from repro_torch.core.session import SpGEMMSession
    from repro_torch.kernels.bsr_spgemm import kernel
    from repro_torch.kernels.bsr_spgemm.ref import bsr_spgemm_ref

    a = laplacian_2d(side).astype(np.float32)
    a.data[:] = np.abs(a.data)
    t0 = time.perf_counter()
    want = spgemm(a, a, MIN_PLUS)
    oracle_s = time.perf_counter() - t0
    sess = SpGEMMSession(device=dev)
    kernel.reset_launches()
    c, wall = session_call(sess, kernel, a, a, algorithm="1d", nparts=8,
                           bs=128, semiring=MIN_PLUS, chunk=None)
    routes = dict(kernel.bsr_spgemm.route_launches)
    check(routes["minplus"] > 0 and sum(routes.values()) == routes["minplus"],
          f"min-plus Laplacian ran off the minplus route: {routes}")
    same_csc(c, want, "min-plus laplacian 1d bs 128")
    entry = next(reversed(sess._cache.values()))
    plan, bs = entry.plan, 128
    tiles, slots, starts = part0_inputs(dev, plan, entry.args)
    nc, real = plan.nc_max + 1, int(starts[-1] - starts[0])
    rs = torch.from_numpy(starts).to(dev)
    out = torch.empty((nc, bs, bs), dtype=torch.float32, device=dev)

    def launch(route="minplus"):
        kernel._launch(route, *tiles, *slots, rs, out, bs=bs,
                       semiring=MIN_PLUS)
        return out

    def plain():
        return bsr_spgemm_ref(*tiles, *slots, nc=nc, semiring=MIN_PLUS,
                              seg_len=real)

    ref = plain()
    check(bitwise(launch(), ref), "min-plus part 0 on minplus != plain")
    check(bitwise(launch("simt"), ref), "min-plus part 0 on simt != plain")
    check(bitwise(launch(), ref), "a repeated minplus launch differs")
    del ref
    ms = cuda_ms(launch, 5)
    previous_ms = cuda_ms(lambda: launch("simt"), 3)
    plain_ms = cuda_ms(plain, 1)
    moved, read = launch_bytes(slots[0], slots[1], rs, nc, bs)
    bd = bounds(moved, 4 * real * bs ** 3, 0, bs)
    t = {"ms": ms, "previous_ms": previous_ms, "plain_ms": plain_ms,
         "library_ms": None, "bound_ms": max(bd["fp32_ops_ms"],
                                             bd["bytes_ms"]),
         "bound_by": ("operations" if bd["fp32_ops_ms"] >= bd["bytes_ms"]
                      else "bytes"),
         "route": "minplus", "bs": bs, "tile_products": real,
         "output_tiles": nc, "bytes": moved, "tiles_read": read,
         "bounds": bd, "launches": routes["minplus"],
         **minplus_stats(kernel, "laplacian", tiles, slots, rs, nc, bs)}
    emit({"phase": "minplus_main", "matrix": f"|laplacian_2d({side})|",
          "semiring": "min_plus", "nparts": 8, "bs": bs, "chunk": None,
          "wall_s": wall, "oracle_s": oracle_s, "nnz_c": want.nnz,
          "execute_ms": cuda_ms(lambda: entry.fn(*entry.args), 3),
          "route_launches": routes, "part0_launch": t})
    del entry, plan, tiles, slots, out
    sess.clear()
    torch.cuda.empty_cache()
    return t


def phase_default_bs(dev, case, ring_ms, n=65536):
    """The session at its default bs (32; BC's 16): laplacian_2d(1024)^2
    through the 1D ring with ``bs`` left out, chunk=None and chunk=2, cold
    then hit, bitwise against scipy, the execute ms beside the bs-128
    ring's (``ring_ms``); the same at bs 16, chunk=None; part 0's launch
    timed at both; bool_or_and at bs 16 and min_plus at bs 32 on
    banded_clustered(n, 64, 16.0) through the ring (chunk=2), bitwise
    against the host oracle, each call's largest launch timed. Every launch
    on the route ``kernel.route`` names for the bs; counts are read per
    call, reset just before."""
    from repro_torch.core import PLUS_TIMES, banded_clustered, by_name
    from repro_torch.core.local_spgemm import spgemm
    from repro_torch.core.session import SpGEMMSession
    from repro_torch.kernels.bsr_spgemm import kernel

    a, ref_c = case["a"], case["ref"]
    sess = SpGEMMSession(device=dev)
    launches, timings, ring = 0, {}, []

    def call(x, bs_kw, sr, **kw):
        """One session call, every launch on the bs's route."""
        bs = bs_kw.get("bs", 32)
        want = kernel.route(sr, bs)
        check(want == "warp", f"{sr.name} at bs {bs} is routed to {want}")
        kernel.reset_launches()
        c, wall = session_call(sess, kernel, x, x, algorithm="1d", nparts=8,
                               semiring=sr, **bs_kw, **kw)
        routes = dict(kernel.bsr_spgemm.route_launches)
        check(routes[want] > 0 and sum(routes.values()) == routes[want],
              f"{sr.name} at bs {bs} ran off the {want} route: {routes}")
        check(sess.last_call["algorithm"] == "1d"
              and not sess.last_call["degraded"],
              f"{sr.name} at bs {bs} was served by another rung")
        return c, wall, routes

    for bs_kw, chunks in (({}, (None, 2)), ({"bs": 16}, (None,))):
        for chunk in chunks:
            walls = {}
            for label in ("cold", "hit"):
                c, walls[label], routes = call(a, bs_kw, PLUS_TIMES,
                                               chunk=chunk)
                check(sess.last_call["cache_hit"] == (label == "hit"),
                      f"default bs chunk={chunk} {label}: cache_hit "
                      f"{sess.last_call['cache_hit']}")
                same_csc(c, ref_c, f"bs {bs_kw or 'default'} chunk={chunk} "
                         f"{label}")
                launches += routes[kernel.route(PLUS_TIMES,
                                                bs_kw.get("bs", 32))]
            entry = next(reversed(sess._cache.values()))
            plan = entry.plan
            ms = cuda_ms(lambda: entry.fn(*entry.args), 3)
            row = {"phase": "default_bs", "matrix":
                   f"laplacian_2d({case['side']})", "bs": plan.bs,
                   "bs_argument": bs_kw.get("bs", "default"), "chunk": chunk,
                   "nparts": 8, "route": kernel.route(PLUS_TIMES, plan.bs),
                   "route_launches": routes, "execute_ms": ms,
                   "bs128_execute_ms": ring_ms.get(chunk), "wall_s": walls,
                   "plan_seconds": plan.stats["plan_seconds"],
                   "tile_products": plan.stats["nprod_total"],
                   "nc_max": plan.nc_max}
            ring.append(row)
            emit(row)
            if chunk is None:
                timings[plan.bs] = measure_kernel(dev, plan, entry.args)
            del entry, plan
        sess.clear()
        torch.cuda.empty_cache()

    g = banded_clustered(n, 64, 16.0, seed=0)
    g.data[:] = np.rint(2 * g.data)
    g.data[g.data == 0] = 1.0
    g = g.astype(np.float32)
    semirings = {}
    for srname, bs in (("bool_or_and", 16), ("min_plus", 32)):
        sr = by_name(srname)
        c, wall, routes = call(g, {"bs": bs}, sr, chunk=2)
        same_csc(c, spgemm(g, g, sr), f"{srname} bs {bs}")
        entry = next(reversed(sess._cache.values()))
        t = time_semiring_launch(kernel, *largest_launch(
            kernel, lambda: entry.fn(*entry.args)))
        t["launches"] = routes[t["route"]]
        launches += t["launches"]
        semirings[srname] = t
        emit({"phase": "default_bs_semiring", "semiring": srname,
              "matrix": f"banded_clustered({n}, 64, 16.0, seed=0)",
              "bs": bs, "chunk": 2, "nparts": 8, "wall_s": wall,
              "execute_ms": cuda_ms(lambda: entry.fn(*entry.args), 3),
              "route_launches": routes, "largest_launch": t})
        del entry
        sess.clear()
    torch.cuda.empty_cache()
    return dict(launches=launches, timings=timings, semirings=semirings,
                ring=ring)


def phase_summa(dev, case, ring):
    """laplacian_2d(1024)·itself through SpGEMMSession as 2D SUMMA (grid
    2) and Split-3D (grid 2, 2 layers): cold, hit and values-only repack,
    each bitwise against scipy, on its own rung with every launch on the
    ``tc`` route; each call's peak device memory (reset per call), the
    executable's time from CUDA events, the decode's host time, and the
    planned and padded bytes beside the 1D ring's (``ring``)."""
    from repro_torch.core.device_common import REQUIRED_STATS
    from repro_torch.core.session import SpGEMMSession
    from repro_torch.kernels.bsr_spgemm import kernel

    side, a, a2 = case["side"], case["a"], case["a2"]
    sess = SpGEMMSession(device=dev)
    comm = {"1d": ring}
    launches = 0
    for alg, geo in (("2d", dict(grid=2)), ("3d", dict(grid=2, layers=2))):
        kw = dict(algorithm=alg, bs=128, **geo)
        kernel.reset_launches()
        walls, peaks_b = {}, {}
        traces = sess.stats["traces"]
        for label, x, want in (("cold", a, case["ref"]),
                               ("hit", a, case["ref"]),
                               ("repack", a2, case["ref4"])):
            torch.cuda.reset_peak_memory_stats()
            c, walls[label] = session_call(sess, kernel, x, x, **kw)
            peaks_b[label] = torch.cuda.max_memory_allocated()
            same_csc(c, want, f"{alg} {label}")
            lc = sess.last_call
            check(lc["algorithm"] == lc["requested_algorithm"] == alg
                  and not lc["degraded"], f"{alg} {label} was served by "
                  f"another rung: {lc}")
            check(lc["cache_hit"] == (label != "cold")
                  and lc["repacked"] == (label == "repack"),
                  f"{alg} {label}: cache_hit {lc['cache_hit']}, repacked "
                  f"{lc['repacked']}")
            if label == "cold":
                plan_and_build = lc["plan_seconds"]
        check(sess.stats["traces"] == traces + 1,
              f"{alg}: a hit or a repack rebuilt the executable")
        routes = dict(kernel.bsr_spgemm.route_launches)
        check(routes["tc"] == kernel.bsr_spgemm.launches > 0,
              f"{alg} launches off the tc route: {routes}")
        launches += routes["tc"]
        entry = next(reversed(sess._cache.values()))
        plan = entry.plan
        ms = cuda_ms(lambda: entry.fn(*entry.args), 3)
        split = decode_split(entry)
        tile = plan.bs * plan.bs * 4
        g2, layers = plan.grid * plan.grid, plan.layers
        stacks = nbytes(entry.args[0], entry.args[1])
        out_bytes = g2 * (plan.nc_max + 1) * tile
        if alg == "2d":
            check(max(peaks_b.values()) < 30e9,
                  f"2d peak device memory {peaks_b} past 30 GB")
        else:   # the merge holds (r, c) blocks and two layers' partials
            check(max(peaks_b.values())
                  < stacks + g2 * layers * (plan.nc_max + 1) * tile,
                  f"3d peak device memory {peaks_b} reaches a whole "
                  f"(parts, nc_max + 1) output stack")
        comm[alg] = {k: plan.stats[k] for k in
                     ("comm_bytes_planned", "comm_bytes_padded",
                      "comm_bytes_model", "messages")}
        emit({"phase": "summa", "algorithm": alg,
              "matrix": f"laplacian_2d({side})", "rows": a.shape[0],
              "nnz_a": a.nnz, "nnz_c": case["ref"].nnz, "bs": 128, **geo,
              "logical_parts": g2 * layers,
              "plan_seconds": plan.stats["plan_seconds"],
              "plan_and_build_seconds": plan_and_build,
              "execute_ms": ms, "wall_s": walls, **split,
              "max_memory_allocated": peaks_b,
              "payload_stack_bytes": stacks, "output_bytes": out_bytes,
              "launches": routes["tc"], "route_launches": routes,
              "tile_products": plan.stats["nprod_total"],
              **{k: plan.stats[k] for k in
                 ("na_max", "nb_max", "nc_max", "nprod_max")},
              **{k: plan.stats[k] for k in REQUIRED_STATS}})
        sess.clear()
        del entry, plan
        torch.cuda.empty_cache()
    emit({"phase": "comm_bytes", "matrix": f"laplacian_2d({side})",
          "bs": 128, "geometry": {"1d": "nparts=8", "2d": "grid=2",
                                  "3d": "grid=2, layers=2"}, **comm})
    return launches


class AppClock:
    """Where one app's time goes, read off its session: host seconds inside
    ``matmul``; of those, planning (``last_call["plan_seconds"]``: the plan
    and the executable's build), values-only repacks and decodes (host
    clock; a decode is timed once the device has finished), and the
    executables' device time (CUDA events around each run). Wraps the
    session's stage hooks, so cached entries keep them."""

    def __init__(self, sess):
        self.reset()
        plan, build, matmul = sess._plan, sess._compile, sess.matmul

        def timed(key, fn):
            def run(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    self.seconds[key] += time.perf_counter() - t0
            return run

        def planned(*args, **kw):
            p, decode, repack = plan(*args, **kw)
            decode = timed("decode_s", decode)

            def synced_decode(*a):
                torch.cuda.synchronize()
                return decode(*a)
            return p, synced_decode, timed("repack_s", repack)

        def built(*args, **kw):
            fn, dev_args = build(*args, **kw)

            def run(*xs):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                out = fn(*xs)
                e1.record()
                self.events.append((e0, e1))
                return out
            return run, dev_args

        def call(*args, **kw):
            c = timed("matmul_s", matmul)(*args, **kw)
            self.calls.append(dict(sess.last_call))
            return c

        sess._plan, sess._compile, sess.matmul = planned, built, call

    def reset(self):
        self.seconds = dict.fromkeys(("matmul_s", "repack_s", "decode_s"),
                                     0.0)
        self.events, self.calls = [], []

    def report(self):
        torch.cuda.synchronize()
        ex = sum(e0.elapsed_time(e1) for e0, e1 in self.events)
        plan_s = sum(c["plan_seconds"] for c in self.calls)
        s = self.seconds
        return {"calls": len(self.calls),
                "hits": sum(c["cache_hit"] for c in self.calls),
                "misses": sum(not c["cache_hit"] for c in self.calls),
                "repacks": sum(c["repacked"] for c in self.calls),
                "plan_seconds": plan_s, "repack_s": s["repack_s"],
                "decode_s": s["decode_s"], "execute_ms": ex,
                "session_other_s": s["matmul_s"] - plan_s - s["repack_s"]
                - s["decode_s"] - ex / 1e3,
                "comm_bytes_planned": sum(c["comm_bytes_planned"]
                                          for c in self.calls)}


def app_run(kernel, clock, fn, plain=False):
    """``fn()`` once, counted: the kernel's launches by route (set to 0
    just before, read just after), the wall, the peak device memory and the
    session's split (``clock``). A kernel run must launch only on
    ``warp`` and serve every call on the cuda engine; a plain run
    (``engine="torch"``) must launch nothing."""
    clock.reset()
    kernel.reset_launches()
    # an AppClock ties its session into a reference cycle: collect the
    # sessions of earlier runs, so their buffers do not count in this peak
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    routes = dict(kernel.bsr_spgemm.route_launches)
    row = dict(wall_s=wall, **clock.report(),
               host_app_s=wall - clock.seconds["matmul_s"],
               launches=kernel.bsr_spgemm.launches, route_launches=routes,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    engines = {c["engine"] for c in clock.calls}
    if plain:
        check(row["launches"] == 0 and engines <= {"torch"},
              f"the plain run launched the kernel: {routes}, {engines}")
    else:
        check(routes["warp"] == row["launches"] > 0 and engines == {"cuda"},
              f"app launches off the warp route: {routes}, {engines}")
        check(not any(c["degraded"] for c in clock.calls),
              "an app call was served by another rung")
    return out, row


def scipy_csc(mat):
    import scipy.sparse as sp

    return sp.csc_matrix((mat.data.astype(np.float64), mat.indices,
                          mat.indptr), shape=mat.shape)


def port_csc(s):
    from repro_torch.core import CSC

    s = s.tocsc()
    s.eliminate_zeros()
    s.sort_indices()
    return CSC(s.indptr.astype(np.int64), s.indices.astype(np.int64),
               s.data, s.shape)


def max_dev(got, want):
    """Largest |got - want| over the union of both patterns."""
    d = abs(scipy_csc(got) - scipy_csc(want))
    return float(d.max()) if d.nnz else 0.0


def apps_amg(dev, kernel, side):
    """(a) RᵀAR of laplacian_2d(side) with restriction_operator(a, 100),
    cold then again on the same session (two hits, no planning), bitwise
    against scipy in float64."""
    from repro_torch.apps import galerkin_product
    from repro_torch.core import laplacian_2d, restriction_operator
    from repro_torch.core.session import SpGEMMSession

    t0 = time.perf_counter()
    a = laplacian_2d(side)
    r = restriction_operator(a, coarsening=100)
    ref = port_csc(scipy_csc(r).T @ scipy_csc(a) @ scipy_csc(r))
    setup = time.perf_counter() - t0
    sess = SpGEMMSession(device=dev)
    clock = AppClock(sess)
    rows = {}
    for label in ("cold", "hit"):
        res, rows[label] = app_run(kernel, clock, lambda: galerkin_product(
            a, r, backend="device", nparts=8, bs=32, session=sess))
        same_csc(res.coarse, ref, f"amg {label}")
        rows[label]["max_abs_dev"] = max_dev(res.coarse, ref)
    check(rows["hit"]["hits"] == 2 and rows["hit"]["plan_seconds"] == 0.0,
          f"amg repeat: {rows['hit']['hits']} hits")
    emit({"phase": "apps", "app": "amg_galerkin",
          "matrix": f"laplacian_2d({side})", "a_shape": a.shape,
          "a_nnz": a.nnz, "r_shape": r.shape, "r_nnz": r.nnz,
          "coarse_nnz": ref.nnz, "nparts": 8, "bs": 32,
          "setup_s": setup, "runs": rows})
    del sess, clock
    torch.cuda.empty_cache()
    return rows["cold"]["launches"] + rows["hit"]["launches"]


def apps_sketch(dev, kernel, side, dim=256):
    """(b) four value sets (integers in ±{1..4}) on laplacian_2d(side)'s
    structure through one CountSketch, A·Sᵀ: one cold call and three
    values-only repacks, each bitwise against scipy."""
    from repro_torch.apps import sketch_stream
    from repro_torch.core import CSC, laplacian_2d
    from repro_torch.core.session import SpGEMMSession

    a = laplacian_2d(side)
    rng = np.random.default_rng(0)
    mats = [CSC(a.indptr, a.indices,
                rng.integers(1, 5, size=a.nnz)
                * rng.choice(np.array([-1.0, 1.0]), size=a.nnz), a.shape)
            for _ in range(4)]
    sess = SpGEMMSession(device=dev)
    clock = AppClock(sess)
    outs, row = app_run(kernel, clock, lambda: sketch_stream(
        mats, dim=dim, seed=0, side="right", session=sess, nparts=8,
        bs=32))
    check([o.cache_hit for o in outs] == [False, True, True, True]
          and sess.stats["payload_repacks"] == 3,
          f"sketch stream: hits {[o.cache_hit for o in outs]}, repacks "
          f"{sess.stats['payload_repacks']}")
    st = scipy_csc(outs[0].sketch).T
    dev_max = 0.0
    for i, (m, o) in enumerate(zip(mats, outs)):
        want = port_csc(scipy_csc(m) @ st)
        same_csc(o.sketched, want, f"sketch {i}")
        dev_max = max(dev_max, max_dev(o.sketched, want))
    row["max_abs_dev"] = dev_max
    emit({"phase": "apps", "app": "count_sketch_stream",
          "matrix": f"laplacian_2d({side}) x 4 value sets",
          "a_shape": a.shape, "a_nnz": a.nnz, "dim": dim, "side": "right",
          "out_nnz": [o.sketched.nnz for o in outs], "nparts": 8, "bs": 32,
          **row})
    del sess, clock, outs
    torch.cuda.empty_cache()
    return row["launches"]


MCL_KW = dict(inflation=2.0, prune_threshold=1e-3, max_iter=32, nparts=8,
              bs=32)


def same_mcl(res, want, what):
    """Bitwise the same MCL result: operator (float64), clusters,
    iterations, chaos and bytes."""
    m, w = res.matrix, want.matrix
    check(m.shape == w.shape and np.array_equal(m.indptr, w.indptr)
          and np.array_equal(m.indices, w.indices)
          and m.data.dtype == w.data.dtype
          and m.data.tobytes() == w.data.tobytes(),
          f"{what}: the operator differs")
    check(np.array_equal(res.clusters, want.clusters)
          and res.iterations == want.iterations
          and res.converged == want.converged
          and res.chaos == want.chaos
          and res.comm_bytes == want.comm_bytes, f"{what}: differs")


def apps_mcl(dev, kernel, n):
    """(c) Markov clustering of block_diagonal_noise(n, n / 64, 8, 0.05)
    (|w| + 0.5): on the kernel, on the plain version (clusters and
    iterations equal, operators within rtol 1e-4, atol 1e-6), and again on
    the kernel's session (hits, bitwise). (e) the run killed by an injected
    execute fault in its fourth iteration resumes from its snapshots on a
    fresh session, bitwise."""
    import tempfile

    from repro_torch.apps import mcl
    from repro_torch.core import block_diagonal_noise
    from repro_torch.core.session import SpGEMMSession
    from repro_torch.core.validate import SpGEMMError
    from repro_torch.runtime import FaultInjector, RetryPolicy

    g = block_diagonal_noise(n, n // 64, d_in=8.0, d_out=0.05, seed=7)
    g.data = np.abs(g.data) + 0.5
    rows = {}
    sess = SpGEMMSession(device=dev)
    clock = AppClock(sess)
    res, rows["kernel"] = app_run(kernel, clock,
                                  lambda: mcl(g, session=sess, **MCL_KW))
    first = list(clock.calls)
    again, rows["kernel_again"] = app_run(
        kernel, clock, lambda: mcl(g, session=sess, **MCL_KW))
    same_mcl(again, res, "mcl again on its session")
    check(rows["kernel_again"]["hits"] == again.iterations,
          f"mcl again: {rows['kernel_again']['hits']} hits in "
          f"{again.iterations} iterations")
    plain_sess = SpGEMMSession(device=dev)
    pclock = AppClock(plain_sess)
    plain, rows["plain"] = app_run(kernel, pclock, lambda: mcl(
        g, session=plain_sess, engine="torch", **MCL_KW), plain=True)
    del plain_sess, pclock
    check(np.array_equal(res.clusters, plain.clusters)
          and res.iterations == plain.iterations,
          f"mcl clusters or iterations differ from the plain run "
          f"({res.iterations} vs {plain.iterations})")
    diff = abs(scipy_csc(res.matrix) - scipy_csc(plain.matrix))
    slack = diff - 1e-4 * abs(scipy_csc(plain.matrix))
    check(not slack.nnz or slack.max() <= 1e-6,
          "mcl operator beyond rtol 1e-4, atol 1e-6 of the plain run")
    dev_max = float(diff.max()) if diff.nnz else 0.0

    # (e) kill the fourth iteration: a cold call fires plan, compile and
    # execute, a hit with new values repack and execute, a plain hit
    # execute alone
    check(res.iterations >= 4, f"mcl ran {res.iterations} iterations")
    arm = sum(1 if c["cache_hit"] and not c["repacked"] else
              2 if c["cache_hit"] else 3 for c in first[:3])
    with tempfile.TemporaryDirectory() as ckpt:
        inj = FaultInjector(rates={"execute": 1.0}, arm_after=arm)
        broken = SpGEMMSession(device=dev, fault_injector=inj,
                               retry_policy=RetryPolicy(max_retries=0))

        def killed():
            try:
                mcl(g, session=broken, checkpoint_dir=ckpt, **MCL_KW)
            except SpGEMMError as e:
                return type(e).__name__
            return None

        fault, killed_row = app_run(kernel, AppClock(broken), killed)
        check(fault is not None and inj.total_injected == 1,
              "the injected fault did not surface")
        del broken
        from repro_torch.checkpoint import latest_step
        snap = latest_step(ckpt)
        check(snap == 3, f"mcl snapshot at step {snap}, not 3")
        fresh = SpGEMMSession(device=dev)
        fclock = AppClock(fresh)
        resumed, row = app_run(kernel, fclock, lambda: mcl(
            g, session=fresh, checkpoint_dir=ckpt, **MCL_KW))
        same_mcl(resumed, res, "mcl resumed")
        del fresh, fclock
    emit({"phase": "apps", "app": "mcl",
          "matrix": f"block_diagonal_noise({n}, {n // 64}, 8.0, 0.05, "
                    "seed=7), |w| + 0.5", "nnz": g.nnz,
          "iterations": res.iterations, "converged": res.converged,
          "clusters": int(len(np.unique(res.clusters))),
          "final_nnz": res.matrix.nnz, "max_abs_dev_plain": dev_max,
          **MCL_KW, "runs": rows})
    emit({"phase": "apps", "app": "mcl_resume", "fault": fault,
          "arm_after": arm, "resumed_from": snap,
          "runs": {"killed": killed_row, "resumed": row}})
    del sess, clock
    torch.cuda.empty_cache()
    return (rows["kernel"]["launches"] + rows["kernel_again"]["launches"]
            + killed_row["launches"] + row["launches"])


def apps_bc(dev, kernel, n, nsources):
    """(d) batched betweenness centrality of symmetrize(
    block_diagonal_noise(n, n / 256, 5, 0.3)), unit weights, from
    ``nsources`` seeded sources at bs 16: on the kernel, then on the plain
    version (depths and call counts equal, scores within rtol 1e-5).
    (e) the kernel run again with its first backward call failing, then
    resumed from its snapshots: scores bitwise."""
    import tempfile

    from repro_torch.apps import bc_batch, device_spgemm_fn
    from repro_torch.core import block_diagonal_noise, symmetrize
    from repro_torch.core.session import SpGEMMSession
    from repro_torch.core.validate import DeviceExecError

    a = symmetrize(block_diagonal_noise(n, n // 256, d_in=5.0, d_out=0.3,
                                        seed=2))
    a.data[:] = 1
    sources = np.sort(np.random.default_rng(0).choice(n, nsources,
                                                      replace=False))
    rows = {}
    sess = SpGEMMSession(device=dev)
    clock = AppClock(sess)
    fn = device_spgemm_fn(nparts=8, bs=16, session=sess)
    res, rows["kernel"] = app_run(kernel, clock,
                                  lambda: bc_batch(a, sources, spgemm_fn=fn))
    calls = clock.calls
    fwd, bwd = calls[:res.fwd_spgemm_calls], calls[res.fwd_spgemm_calls:]
    check(all(c["cache_hit"] and c["repacked"] for c in bwd),
          "a backward call missed the forward levels' entries")
    plain_sess = SpGEMMSession(device=dev)
    pclock = AppClock(plain_sess)
    plain, rows["plain"] = app_run(kernel, pclock, lambda: bc_batch(
        a, sources, spgemm_fn=device_spgemm_fn(
            nparts=8, bs=16, engine="torch", session=plain_sess)),
        plain=True)
    del plain_sess, pclock
    check(res.depths == plain.depths
          and res.fwd_spgemm_calls == plain.fwd_spgemm_calls
          and res.bwd_spgemm_calls == plain.bwd_spgemm_calls,
          "bc depths or call counts differ from the plain run")
    rel = np.abs(res.scores - plain.scores) / np.maximum(
        np.abs(plain.scores), 1e-300)
    check(np.allclose(res.scores, plain.scores, rtol=1e-5, atol=0.0),
          f"bc scores beyond rtol 1e-5 of the plain run: {rel.max()}")

    def failing(at):
        count = {"n": 0}

        def wrapped(x, y, semiring):
            count["n"] += 1
            if count["n"] == at:
                raise DeviceExecError("injected on the first backward call",
                                      stage="execute")
            return fn(x, y, semiring)
        return wrapped

    with tempfile.TemporaryDirectory() as ckpt:

        def killed():
            try:
                bc_batch(a, sources,
                         spgemm_fn=failing(res.fwd_spgemm_calls + 1),
                         checkpoint_dir=ckpt)
            except DeviceExecError as e:
                return type(e).__name__
            return None

        fault, killed_row = app_run(kernel, clock, killed)
        check(fault is not None, "the injected fault did not surface")
        resumed, row = app_run(kernel, clock, lambda: bc_batch(
            a, sources, spgemm_fn=failing(None), checkpoint_dir=ckpt))
    check(resumed.scores.tobytes() == res.scores.tobytes()
          and resumed.depths == res.depths
          and resumed.fwd_spgemm_calls == res.fwd_spgemm_calls
          and resumed.bwd_spgemm_calls == res.bwd_spgemm_calls
          and resumed.comm_bytes == res.comm_bytes,
          "bc resumed differs from the uninterrupted run")
    emit({"phase": "apps", "app": "bc_batch",
          "matrix": f"symmetrize(block_diagonal_noise({n}, {n // 256}, 5.0, "
                    "0.3, seed=2)), unit weights", "nnz": a.nnz,
          "sources": nsources, "nparts": 8, "bs": 16, "depths": res.depths,
          "fwd_calls": res.fwd_spgemm_calls,
          "bwd_calls": res.bwd_spgemm_calls,
          "fwd_hits": sum(c["cache_hit"] for c in fwd),
          "bwd_hits": sum(c["cache_hit"] for c in bwd),
          "max_rel_dev_plain": float(rel.max()), "runs": rows})
    emit({"phase": "apps", "app": "bc_resume", "fault": fault,
          "runs": {"killed": killed_row, "resumed": row}})
    del sess, clock, fn
    torch.cuda.empty_cache()
    return rows["kernel"]["launches"] + killed_row["launches"] + \
        row["launches"]


def phase_apps(dev, side=1024, n_mcl=262144, n_bc=262144, nsources=128):
    """The paper's applications through their entry points, each on its
    own session at its default bs (every launch on ``warp``): (a) AMG
    Galerkin, (b) a CountSketch stream, (c) Markov clustering, (d) batched
    betweenness centrality, (e) MCL and BC resumed after a fault."""
    from repro_torch.kernels.bsr_spgemm import kernel

    launches = {}
    t0 = time.perf_counter()
    launches["amg"] = apps_amg(dev, kernel, side)
    launches["sketch"] = apps_sketch(dev, kernel, side)
    launches["mcl"] = apps_mcl(dev, kernel, n_mcl)
    launches["bc"] = apps_bc(dev, kernel, n_bc, nsources)
    emit({"phase": "apps_done", "seconds": time.perf_counter() - t0,
          "warp_launches": launches})
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def timing_entry(ms, plain_ms, library_ms, flop, moved, dtype, err,
                 tf32_passes=0):
    """A kernel's timing beside its bound: max(flop / peak, bytes / HBM),
    with the bf16 tensor-core peak for bf16 work and the fp32 peak else;
    for float32 work done as ``tf32_passes`` TF32 passes, that many times
    the flop at the TF32 tensor-core peak, with the fp32 bound beside it
    (``fp32_bound_ms``)."""
    variant, (fp32, hbm, bf16, tf32) = peaks(torch.cuda.get_device_name(0))
    peak = bf16 if dtype == torch.bfloat16 else fp32
    t_bytes = moved / hbm * 1e3
    extra = {}
    if tf32_passes:
        extra = {"tf32_passes": tf32_passes,
                 "fp32_bound_ms": max(flop / fp32 * 1e3, t_bytes)}
        peak, flop_done = tf32, flop * tf32_passes
    else:
        flop_done = flop
    t_ops = flop_done / peak * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flop": flop, "bytes": moved, "max_abs_err": err,
            "tflops": flop / ms / 1e9, "peak_variant": variant,
            "peak_flops": peak, "hbm_bytes_per_s": hbm, **extra}


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def phase_build_lm(infos):
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.moe_gemm import kernel as mg

    for mod, sources in ((fa, fa.SOURCES), (mg, mg.SOURCES)):
        mod.build()
        for src in sources:
            info = infos[src]
            extra = {}
            if src == fa.TC_SOURCE:   # dynamic shared memory, per launch
                extra["dynamic_smem_bytes"] = {
                    f"d_pad{d}": fa.tc_smem_bytes(d)
                    for d in (64, 128, 192, 256)}
            if src == fa.TF32_SOURCE:
                per_dp = {}
                for d in range(8, fa.MAX_D + 1, 8):
                    got = fa.fp32_kernel_config(d)
                    want = fa.fp32_config(d)
                    check(all(got[k] == want[k] for k in want),
                          f"the fp32 kernel blocks head dim {d} as {got}, "
                          f"the host expects {want}")
                    per_dp[f"d_pad{got['dp']}"] = got
                extra["blocking"] = per_dp
                extra["dynamic_smem_bytes"] = {
                    k: v["smem_bytes"] for k, v in per_dp.items()}
            if src == mg.TC_SOURCE:
                extra["dynamic_smem_bytes"] = {
                    "prefill": mg.tc_smem_bytes("prefill", 2048),
                    **{f"decode_d{d}": mg.tc_smem_bytes("decode", d)
                       for d in (2048, 1408)}}
            if src == mg.TF32_SOURCE:
                got, want = mg.fp32_kernel_config(), mg.fp32_config()
                check(got == want, f"the moe_gemm fp32 kernel blocks as "
                      f"{got}, the host expects {want}")
                extra["blocking"] = got
                extra["dynamic_smem_bytes"] = {"fp32": got["smem_bytes"]}
            emit({"phase": "build_lm", "kernel": src.stem,
                  "seconds": info["seconds"], "built": info["built"],
                  "library": info["path"], "ptxas": ptxas_lines(info["log"]),
                  **extra})


def phase_serve_smoke(arch="qwen2-moe-a2.7b"):
    """``python -m repro_torch.launch.serve --arch <arch> --smoke`` on the
    card (its ``--device`` default): the float32 smoke config at head dim
    16 through both LM kernels' float32 routes, in a process of its own.
    It must exit 0."""
    import os

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke"], cwd=root, env=env, capture_output=True, text=True,
        timeout=300)
    lines = (proc.stdout + proc.stderr).strip().splitlines()
    check(proc.returncode == 0, f"launch.serve --smoke exited "
          f"{proc.returncode}: {lines[-20:]}")
    emit({"phase": "serve_smoke", "arch": arch, "seconds":
          time.perf_counter() - t0, "returncode": proc.returncode,
          "output": lines[:2]})


def within(got, want, atol, rtol):
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.all((got.float() - want.float()).abs()
                        <= atol + rtol * want.float().abs()))
    return ok, err


TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
MOE_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}


FLASH_GRID = {torch.bfloat16: ((16, 64, 96, 128, 160, 256),
                                (77, 128, 129, 1000, 2048)),
              torch.float32: ((16, 64, 96, 128, 160, 192, 256),
                              (77, 128, 1000))}


def phase_flash_grid(dev):
    """Both attention routes against their plain version on the card."""
    from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                            route)
    from repro_torch.kernels.flash_attention.ref import mha_ref

    g = torch.Generator(device=dev).manual_seed(0)
    cases = {"float32": 0, "bfloat16": 0}
    errs = {"float32": 0.0, "bfloat16": 0.0}
    by_route = {}
    for dtype, (dims, lens) in FLASH_GRID.items():
        key = str(dtype).split(".")[-1]
        for d in dims:
            for s in lens:
                for hkv in (8, 2):
                    q = torch.randn(2, s, 8, d, generator=g, device=dev)
                    k = torch.randn(2, s, hkv, d, generator=g, device=dev)
                    v = torch.randn(2, s, hkv, d, generator=g, device=dev)
                    q, k, v = (t.to(dtype) for t in (q, k, v))
                    for window in (0, 64):
                        for cap in (0.0, 50.0):
                            kw = dict(scale=d ** -0.5, causal=True,
                                      window=window, softcap=cap)
                            label = (f"{dtype} D={d} S={s} Hkv={hkv} "
                                     f"window={window} softcap={cap}")
                            got = flash_attention(q, k, v, **kw)
                            want = mha_ref(q, k, v, **kw)
                            torch.cuda.synchronize()
                            ok, err = within(got, want, *TOL[dtype])
                            check(ok, f"flash_attention != plain version: "
                                      f"{label} (max abs err {err})")
                            check(bitwise(flash_attention(q, k, v, **kw),
                                          got),
                                  f"a repeated launch differs: {label}")
                            name = route(dtype, d)
                            by_route[name] = by_route.get(name, 0) + 1
                            errs[key] = max(errs[key], err)
                            cases[key] += 1
    emit({"phase": "flash_attention_vs_plain", "cases": cases,
          "cases_by_route": by_route, "max_abs_err": errs,
          "tolerance": {"float32": TOL[torch.float32],
                        "bfloat16": TOL[torch.bfloat16],
                        "repeat": "bitwise"},
          "grid": {str(k).split(".")[-1]: {"D": v[0], "S": v[1]}
                   for k, v in FLASH_GRID.items()}})
    return errs


TILE_EDGES = (63, 64, 65, 127, 128, 129)


def moe_rows_cases(g, e, cap, dev):
    """``rows`` for one (E, cap): all cap, all 0, random in [0, cap + 8]
    (values past cap are clamped), and the 128-row tile edges (each alone at
    E = 1, cycled over the experts at E = 64)."""
    cases = [("all_cap", torch.full((e,), cap)),
             ("all_zero", torch.zeros(e)),
             ("random", torch.randint(0, cap + 9, (e,), generator=g,
                                      device=dev))]
    if e == 1:
        cases += [(f"edge_{v}", torch.full((1,), v)) for v in TILE_EDGES]
    else:
        cases.append(("edges", torch.tensor(TILE_EDGES).repeat(
            -(-e // len(TILE_EDGES)))[:e]))
    return [(name, r.to(device=dev, dtype=torch.int32)) for name, r in cases]


def phase_moe_grid(dev):
    """Every route of the grouped GEMM against its plain version."""
    from repro_torch.kernels.moe_gemm.kernel import moe_gemm, route
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

    g = torch.Generator(device=dev).manual_seed(1)
    cases, nonfinite, errs = 0, 0, {"float32": 0.0, "bfloat16": 0.0}
    by_route = {}

    def held(x, w, rows, what, exact=False):
        nonlocal cases, nonfinite
        got, want = moe_gemm(x, w, rows), moe_gemm_ref(x, w, rows)
        torch.cuda.synchronize()
        name = route(x.dtype, x.shape[1])
        label = (f"{name} route {x.dtype} E={x.shape[0]} cap={x.shape[1]} "
                 f"d={x.shape[2]} f={w.shape[2]} rows={what}")
        fin = torch.isfinite(want)
        if exact:
            check(bitwise(got, want), f"moe_gemm != plain version on "
                  f"integers: {label}")
        else:
            if not bool(fin.all()):       # planted inf / NaN
                check(all(torch.equal(a(got), a(want)) for a in (
                    torch.isnan, torch.isposinf, torch.isneginf)),
                    f"moe_gemm's inf / NaN pattern != the plain version's: "
                    f"{label}")
                nonfinite += 1
            ok, err = within(got[fin], want[fin], *MOE_TOL[x.dtype])
            check(ok, f"moe_gemm != plain version: {label} (max abs err "
                      f"{err})")
            key = str(x.dtype).split(".")[-1]
            errs[key] = max(errs[key], err)
        check(bitwise_or_nan(moe_gemm(x, w, rows), got),
              f"a repeated launch differs: {label}")
        by_route[name] = by_route.get(name, 0) + 1
        cases += 1

    for e in (1, 64):
        for cap in (8, 16, 96, 688):
            for d, f in ((2048, 1408), (1408, 2048), (640, 72), (200, 72)):
                x = torch.randn(e, cap, d, generator=g, device=dev)
                w = torch.randn(e, d, f, generator=g, device=dev) * d ** -0.5
                xi = torch.randint(-4, 5, (e, cap, d), generator=g,
                                   device=dev).float()
                wi = torch.randint(-4, 5, (e, d, f), generator=g,
                                   device=dev).float()
                rand = torch.randint(0, cap + 9, (e,), generator=g,
                                     device=dev).int()
                for rows, what in ((None, "None"), (rand, "random")):
                    held(xi, wi, rows, what, exact=True)
                    held(x, w, rows, what)
                del xi, wi
                # inf, NaN and a value whose TF32 hi rounds to inf
                xp, wp = x.clone(), w.clone()
                xp[:, 0, 3] = float("inf")
                xp[:, min(2, cap - 1), d - 1] = float("nan")
                xp[:, min(1, cap - 1), 0] = 3.0e38
                wp[:, 5, 1] = float("-inf")
                wp[:, d // 2, f - 1] = float("nan")
                for rows, what in ((None, "None"), (rand, "random")):
                    held(xp, wp, rows, f"{what} planted inf/NaN")
                del xp, wp
                xb, wb = x.bfloat16(), w.bfloat16()
                held(xb, wb, None, "None")
                for what, rows in moe_rows_cases(g, e, cap, dev):
                    held(xb, wb, rows, what)
    emit({"phase": "moe_gemm_vs_plain", "cases": cases,
          "cases_by_route": by_route, "planted_nonfinite_cases": nonfinite,
          "max_abs_err": errs,
          "tolerance": {"float32": MOE_TOL[torch.float32],
                        "bfloat16": MOE_TOL[torch.bfloat16],
                        "integer_float32": "bitwise",
                        "planted_inf_nan": "the plain version's pattern",
                        "repeat": "bitwise"}})
    return errs


class Capture:
    """Wraps the model's op references (``models.attention.
    multihead_attention``, ``models.moe.grouped_gemm``) and the engine's
    ``prefill_step`` / ``decode_step``: records the inputs of the first
    layer's attention call and of its three grouped GEMMs (``rows``
    included) in prefill and in the first decode step (under phase None
    outside the engine), CUDA events around every step, and whether any
    logit was not finite. Adds no kernel launch."""

    def __init__(self):
        import repro_torch.models.attention as attn_mod
        import repro_torch.models.moe as moe_mod
        import repro_torch.serve.engine as engine_mod

        self.mods = (attn_mod, moe_mod, engine_mod)
        self.orig = (attn_mod.multihead_attention, moe_mod.grouped_gemm,
                     engine_mod.prefill_step, engine_mod.decode_step)
        self.attn, self.gemm = {}, {}
        self.events = {"prefill": [], "decode": []}
        self.phase = None
        self.bad = None
        self.capturing = True

    def __enter__(self):
        attn_mod, moe_mod, engine_mod = self.mods
        mha, gemm, prefill, decode = self.orig

        def attn(q, k, v, *args):
            if self.capturing and self.phase not in self.attn:
                self.attn[self.phase] = (q.clone(), k.clone(), v.clone(),
                                         args)
            return mha(q, k, v, *args)

        def grouped(x, w, rows=None):
            calls = self.gemm.setdefault(self.phase, [])
            if self.capturing and len(calls) < 3:
                calls.append((x.clone(), w,
                              None if rows is None else rows.clone()))
            return gemm(x, w, rows)

        def step(fn, phase):
            def run(params, cfg, batch, caches):
                self.phase = phase
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                logits, caches = fn(params, cfg, batch, caches)
                t1.record()
                self.events[phase].append((t0, t1))
                bad = ~torch.isfinite(logits).all()
                self.bad = bad if self.bad is None else self.bad | bad
                if phase == "decode":
                    self.capturing = False
                return logits, caches
            return run

        attn_mod.multihead_attention = attn
        moe_mod.grouped_gemm = grouped
        engine_mod.prefill_step = step(prefill, "prefill")
        engine_mod.decode_step = step(decode, "decode")
        return self

    def __exit__(self, *exc):
        attn_mod, moe_mod, engine_mod = self.mods
        (attn_mod.multihead_attention, moe_mod.grouped_gemm,
         engine_mod.prefill_step, engine_mod.decode_step) = self.orig
        return False

    def step_ms(self, phase):
        return [t0.elapsed_time(t1) for t0, t1 in self.events[phase]]


def time_flash(dev, captured):
    """The route's kernel, the plain version and SDPA on the captured
    prefill attention, as CUDA events around back-to-back launches; also
    the earlier CUDA-core kernel on the same inputs (``previous_ms``) and
    the host time of one wrapper call (argument checks, output allocation,
    three tensor-map encodes, launch) and of the C launch function alone.
    The float32 route's bound counts its three TF32 passes."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        _launch, _launch_cuda_core, flash_attention, route)
    from repro_torch.kernels.flash_attention.ref import mha_ref

    q, k, v, (scale, causal, window, softcap) = captured
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    got, want = flash_attention(q, k, v, **kw), mha_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    ok, err = within(got, want, *TOL[q.dtype])
    check(ok, f"prefill attention kernel != plain version in {q.dtype} "
              f"({err})")
    del got, want
    name = route(q.dtype, q.shape[3])
    ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), 10)
    plain_ms = cuda_ms(lambda: mha_ref(q, k, v, **kw), 3)
    library_ms = None
    if window == 0 and softcap == 0.0 and q.shape[2] == k.shape[2]:
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, scale=scale), 10)
        del qh, kh, vh
    extra = {"previous_ms": cuda_ms(
        lambda: _launch_cuda_core(q, k, v, **kw), 3)}
    extra["host_us_per_call"] = host_call_us(
        lambda: flash_attention(q, k, v, **kw))
    out = torch.empty_like(q)
    extra["launch_us_per_call"] = host_call_us(
        lambda: _launch(name, q, k, v, out, scale, causal, window, softcap))
    del out
    b, s, hq, d = q.shape
    rows = torch.arange(s, device=dev)
    lo = (rows - window + 1).clamp(min=0) if window > 0 else 0 * rows
    pairs = b * int((rows - lo + 1).sum())         # unmasked (row, key)
    flop = 4 * d * hq * pairs                      # q.k and p.v
    entry = timing_entry(ms, plain_ms, library_ms, flop,
                         nbytes(q, k, v) + nbytes(q), q.dtype, err,
                         tf32_passes=3 if name == "fp32" else 0)
    return {"shape": {"q": list(q.shape), "k": list(k.shape),
                      "dtype": str(q.dtype), "route": name, "window": window,
                      "softcap": softcap}, **entry, **extra}


def host_call_us(fn, n=50):
    """Host microseconds per call of ``fn`` over ``n`` calls (the enqueue;
    the device runs behind)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def time_moe(x, w, rows):
    """The route's kernel, the plain version, ``torch.bmm`` and the earlier
    CUDA-core kernel (every slot of every expert, as before ``rows``) on
    one captured GEMM, each as device time per call; the kernel also as
    CUDA events around back-to-back launches (``events_ms``, which the
    host's enqueue rate bounds from below); the host time of one wrapper
    call (argument checks, output allocation, tensor maps, launch) and of
    the C launch function alone (tensor maps and launch). The ``fp32``
    route's bound counts its three TF32 passes at the tensor-core peak,
    with the fp32 CUDA-core bound beside it."""
    from repro_torch.kernels.moe_gemm.kernel import (_launch,
                                                     _launch_cuda_core,
                                                     moe_gemm, route)
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

    got, want = moe_gemm(x, w, rows), moe_gemm_ref(x, w, rows)
    torch.cuda.synchronize()
    ok, err = within(got, want, *MOE_TOL[x.dtype])
    check(ok, f"grouped GEMM kernel != plain version at {tuple(x.shape)} x "
              f"{tuple(w.shape)} ({err})")
    check(bitwise(moe_gemm(x, w, rows), got), "a repeated launch differs at "
          f"{tuple(x.shape)} x {tuple(w.shape)}")
    e, cap, d = x.shape
    f = w.shape[2]
    live = rows.clamp(0, cap)
    slots, experts = int(live.sum()), int((live > 0).sum())
    del got, want
    reps = 20 if cap <= 16 else 10
    ms = device_ms(lambda: moe_gemm(x, w, rows), reps)
    previous_ms = device_ms(lambda: _launch_cuda_core(x, w), reps // 2)
    plain_ms = device_ms(lambda: moe_gemm_ref(x, w, rows), 3)
    library_ms = device_ms(lambda: torch.bmm(x, w), reps)
    events_ms = cuda_ms(lambda: moe_gemm(x, w, rows), reps)
    host_us = host_call_us(lambda: moe_gemm(x, w, rows))
    out = torch.empty_like(moe_gemm(x, w, rows))
    launch_us = host_call_us(
        lambda: _launch(route(x.dtype, cap), x, w, rows, out))
    el = x.element_size()
    passes = 3 if route(x.dtype, cap) == "fp32" else 0
    # what this run's data needs: the products of live rows, those x rows,
    # the weights of experts with a live row, y written whole
    entry = timing_entry(ms, plain_ms, library_ms, 2 * slots * d * f,
                         slots * d * el + experts * d * f * el
                         + e * cap * f * el, x.dtype, err, passes)
    dense = timing_entry(ms, plain_ms, library_ms, 2 * e * cap * d * f,
                         nbytes(x, w) + e * cap * f * el, x.dtype, err,
                         passes)
    return {"shape": {"x": list(x.shape), "w": list(w.shape),
                      "dtype": str(x.dtype), "route": route(x.dtype, cap),
                      "live_rows": slots, "experts_with_rows": experts},
            **entry, "previous_ms": previous_ms, "events_ms": events_ms,
            "host_us_per_call": host_us,
            "launch_us_per_call": launch_us,
            "dense_bound_ms": dense["bound_ms"],
            "dense_bound_by": dense["bound_by"], "dense_flop": dense["flop"]}


@contextlib.contextmanager
def plain_ops():
    """Point the model's op references at the plain versions (the
    comparison's other side; the package itself has no such switch)."""
    import repro_torch.models.attention as attn_mod
    import repro_torch.models.moe as moe_mod
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

    orig = attn_mod.multihead_attention, moe_mod.grouped_gemm
    attn_mod.multihead_attention = (
        lambda q, k, v, scale, causal, window, softcap: mha_ref(
            q, k, v, scale=scale, causal=causal, window=window,
            softcap=softcap))
    moe_mod.grouped_gemm = moe_gemm_ref
    try:
        yield
    finally:
        attn_mod.multihead_attention, moe_mod.grouped_gemm = orig


def plain_prefill_check(params, cfg, dev, prompts):
    """Prefill of the prompts' last n tokens (n the shortest prompt's
    length) through the kernels and through the plain versions (the model's
    op references pointed at them); the two sets of last-position logits
    are compared."""
    from repro_torch.models import init_caches, prefill_step

    n = min(len(p) for p in prompts)
    toks = torch.from_numpy(np.stack([p[-n:] for p in prompts])
                            .astype(np.int64)).to(dev)
    b = toks.shape[0]
    logits_k, _ = prefill_step(params, cfg, {"tokens": toks},
                               init_caches(cfg, b, n, device=dev))
    with plain_ops():
        logits_p, _ = prefill_step(params, cfg, {"tokens": toks},
                                   init_caches(cfg, b, n, device=dev))
    diff = float((logits_k - logits_p).abs().max())
    scale = float(logits_p.abs().max())
    same_top1 = int((logits_k.argmax(-1) == logits_p.argmax(-1)).sum())
    return {"tokens": list(toks.shape), "max_abs_logit_diff": diff,
            "max_abs_logit": scale, "rel": diff / scale,
            "top1_agree": same_top1, "rows": b}


def profile_generate(engine, prompts):
    """Device time by kernel over a generate of 1 token (prefill only) and
    of 5 tokens (prefill + 4 decode steps), from ``torch.profiler``; the
    decode steps' share is the difference. Also the host side of those 4
    decode steps: self CPU time by op (aten ops and the CUDA runtime calls),
    profiler overhead included."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(max_new):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.generate(prompts, max_new_tokens=max_new, sync_every=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out, host = {}, {}
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                out[ev.key] = (ev.count, ev.self_device_time_total / 1e3)
            else:
                host[ev.key] = (ev.count, ev.self_cpu_time_total / 1e3)
        return out, host, wall * 1e3

    def kind(name):
        low = name.lower()
        if "flash_fwd" in name:
            return "flash_attention"
        if "moe_gemm" in name:
            return "moe_gemm"
        if any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet")):
            return "library_gemm"
        if "memcpy" in low or "memset" in low:
            return "memcpy"
        return "other"

    pre, pre_host, pre_wall = kernels(1)
    full, full_host, full_wall = kernels(5)
    res = {}
    for label, table, wall in (("prefill", pre, pre_wall),
                               ("prefill_plus_4_decode", full, full_wall)):
        by_kind = {}
        for name, (n, ms) in table.items():
            k = by_kind.setdefault(kind(name), [0, 0.0])
            k[0] += n
            k[1] += ms
        busy = sum(ms for _, ms in table.values())
        top = sorted(table.items(), key=lambda kv: -kv[1][1])[:12]
        res[label] = {"wall_ms": wall, "device_busy_ms": busy,
                      "idle_share": 1 - busy / wall if wall else None,
                      "by_kind": {k: {"launches": v[0], "ms": v[1]}
                                  for k, v in by_kind.items()},
                      "top": [{"kernel": n[:90], "launches": c, "ms": ms}
                              for n, (c, ms) in top]}
    decode_host = {k: (c - pre_host.get(k, (0, 0.0))[0],
                       ms - pre_host.get(k, (0, 0.0))[1])
                   for k, (c, ms) in full_host.items()}
    top = sorted(decode_host.items(), key=lambda kv: -kv[1][1])[:15]
    res["host"] = {
        "prefill_self_cpu_ms": sum(ms for _, ms in pre_host.values()),
        "prefill_plus_4_decode_self_cpu_ms": sum(
            ms for _, ms in full_host.values()),
        "decode_4_steps_top": [{"op": n[:60], "calls": c, "ms": ms}
                               for n, (c, ms) in top]}
    return res


def f32_plain_check(dev, arch, layers=2, n=256):
    """The model at full width, cut to ``layers`` layers, in float32: a
    prefill of 4 x n tokens and one decode step through the kernels and
    through the plain versions; the logits must agree within 1e-3 of their
    largest magnitude (float32 kernels agree with the plain versions to
    ~1e-6 per op). The kernels' run is the float32 routes' path: their
    launch counts, from 0 just before it, and the prefill's up and down
    grouped GEMMs and the decode step's up GEMM, timed; the decode GEMM
    also on the CUDA-core kernel with its ``rows`` (``cuda_core_rows_ms``),
    beside which the ``fp32`` route needs no decode kernel of its own."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.moe_gemm import kernel as mg
    from repro_torch.models import (decode_step, init_caches, init_params,
                                    prefill_step)

    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                         device=dev, dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (4, n + 1), generator=g, device=dev)

    def run(cap=None):
        caches = init_caches(cfg, 4, n + 1, device=dev)
        if cap:
            cap.phase = "prefill"
        lp, caches = prefill_step(params, cfg, {"tokens": toks[:, :n]},
                                  caches)
        if cap:
            cap.phase = "decode"
        ld, _ = decode_step(params, cfg, {"tokens": toks[:, n:]}, caches)
        return lp, ld

    mg.reset_launches()
    fa.reset_launches()
    with Capture() as cap:
        kern = run(cap)
    routes = dict(mg.moe_gemm.route_launches)
    attn_routes = dict(fa.flash_attention.route_launches)
    n_moe = sum(1 for k in cfg.pattern if k in "AM") * cfg.n_periods
    n_attn = sum(1 for k in cfg.pattern if k in "aAl") * cfg.n_periods
    want = {"prefill": 0, "decode": 0, "fp32": 6 * n_moe}
    check(routes == want, f"float32 route launches {routes}, expected "
          f"{want}")
    check(attn_routes == {"tc": 0, "fp32": n_attn},
          f"float32 attention route launches {attn_routes}, expected "
          f"{n_attn} on fp32 (one prefill)")
    with plain_ops():
        plain = run()
    out = {"dtype": "float32", "layers": layers, "tokens": [4, n],
           "route_launches": routes,
           "flash_attention_route_launches": attn_routes}
    for name, a, b in (("prefill", kern[0], plain[0]),
                       ("decode", kern[1], plain[1])):
        diff = float((a - b).abs().max())
        scale = float(b.abs().max())
        check(bool(torch.isfinite(a).all()), f"{name} logits not finite")
        check(diff <= 1e-3 * scale, f"float32 {name} logits: kernels vs "
              f"plain versions differ by {diff} (max |logit| {scale})")
        out[name] = {"max_abs_logit_diff": diff, "max_abs_logit": scale,
                     "top1_agree": int((a.argmax(-1) == b.argmax(-1)).sum())}
    out["moe_gemm_fp32"] = [
        {"phase": phase, "projection": name,
         **time_moe(*cap.gemm[phase][i])}
        for phase, i, name in (("prefill", 0, "up"), ("prefill", 2, "down"),
                               ("decode", 0, "up"))]
    x, w, rows = cap.gemm["decode"][0]
    out["moe_gemm_fp32"][2]["cuda_core_rows_ms"] = device_ms(
        lambda: mg._launch_cuda_core(x, w, rows), 20)
    return out


def phase_lm_serve(dev, arch="qwen2-moe-a2.7b", lens=(2048, 1536, 1024, 512),
                   max_new=32):
    """qwen2-moe-a2.7b at full size through ServeEngine.generate."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.moe_gemm import kernel as mg
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in
                   [params["embed"], params["final_norm"]["scale"]]
                   + [w for lp in params["layers"] for w in leaves(lp)])
    engine = ServeEngine(cfg, params, max_len=4096, batch_slots=4,
                         device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in lens]

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    mg.reset_launches()
    with Capture() as cap:
        t0 = time.perf_counter()
        res = engine.generate(prompts, max_new_tokens=max_new, greedy=True,
                              sync_every=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.flash_attention.launches,
                "moe_gemm": mg.moe_gemm.launches}
    routes = dict(mg.moe_gemm.route_launches)
    attn_routes = dict(fa.flash_attention.route_launches)
    peak = torch.cuda.max_memory_allocated()
    n_moe = sum(1 for k in cfg.pattern if k in "AM") * cfg.n_periods
    n_attn = sum(1 for k in cfg.pattern if k in "aAl") * cfg.n_periods
    forwards = 1 + len(cap.events["decode"])
    check(res.tokens.shape == (4, max_new), f"tokens {res.tokens.shape}")
    check(forwards == max_new, f"{forwards} forwards for {max_new} tokens")
    check(launches["flash_attention"] == n_attn,
          f"flash_attention launched {launches['flash_attention']} times, "
          f"expected {n_attn} (one prefill)")
    check(attn_routes == {"tc": n_attn, "fp32": 0},
          f"flash_attention routes {attn_routes}, expected {n_attn} on tc")
    check(launches["moe_gemm"] == 3 * n_moe * forwards,
          f"moe_gemm launched {launches['moe_gemm']} times, expected "
          f"{3 * n_moe * forwards}")
    want_routes = {"prefill": 3 * n_moe, "decode": 3 * n_moe * (forwards - 1),
                   "fp32": 0}
    check(routes == want_routes, f"moe_gemm routes {routes}, expected "
          f"{want_routes}")
    check(not bool(cap.bad), "a logit was NaN or inf")
    check(((0 <= res.tokens) & (res.tokens < cfg.vocab)).all(),
          "token out of range")
    prefill_ms = cap.step_ms("prefill")[0]
    decode_ms = cap.step_ms("decode")

    before = dict(launches)
    res2 = engine.generate(prompts, max_new_tokens=max_new, greedy=True,
                           sync_every=8)
    check(np.array_equal(res.tokens, res2.tokens),
          "a second generate gave other tokens")
    repeat_launches = {"flash_attention": fa.flash_attention.launches
                       - before["flash_attention"],
                       "moe_gemm": mg.moe_gemm.launches - before["moe_gemm"]}
    check(repeat_launches == launches, f"repeat launches {repeat_launches}")

    emit({"phase": "lm_serve", "arch": arch, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "experts_padded":
          cfg.moe.n_experts_padded, "params": n_params,
          "param_bytes": 2 * n_params, "init_s": init_s,
          "prompt_lens": list(lens), "max_new_tokens": max_new,
          "generated_tokens": int(res.lengths.sum()),
          "generate_wall_s": wall,
          "tokens_per_s": int(res.lengths.sum()) / wall,
          "prefill_ms": prefill_ms,
          "decode_step_ms_mean": float(np.mean(decode_ms)),
          "decode_step_ms_min": float(np.min(decode_ms)),
          "decode_step_ms_max": float(np.max(decode_ms)),
          "peak_memory_allocated": peak, "launches": launches,
          "moe_gemm_route_launches": routes,
          "flash_attention_route_launches": attn_routes,
          "repeat_identical": True, "first_tokens": res.tokens[:, :8]
          .tolist()})

    q, k, v, args = cap.attn["prefill"]
    flash = time_flash(dev, (q, k, v, args))
    flash_fp32 = time_flash(dev, (q.float(), k.float(), v.float(), args))
    del q, k, v
    gemms = []
    for phase in ("prefill", "decode"):
        calls = cap.gemm[phase]
        for name, (x, w, rows) in (("up", calls[0]), ("down", calls[2])):
            gemms.append({"phase": phase, "projection": name,
                          **time_moe(x, w, rows)})
    emit({"phase": "lm_kernel_timing", "flash_attention": flash,
          "flash_attention_fp32": flash_fp32, "moe_gemm": gemms})
    cap = None
    emit({"phase": "lm_profile", **profile_generate(engine, prompts)})
    emit({"phase": "lm_plain_prefill", "dtype": "bfloat16",
          "layers": cfg.n_layers,
          **plain_prefill_check(params, cfg, dev, prompts)})
    del engine, params
    torch.cuda.empty_cache()
    f32 = f32_plain_check(dev, arch)
    emit({"phase": "lm_plain_check", **f32})
    routes["fp32"] = f32["route_launches"]["fp32"]
    attn_routes["fp32"] = f32["flash_attention_route_launches"]["fp32"]
    return (routes, attn_routes, flash, flash_fp32, gemms,
            f32["moe_gemm_fp32"])


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree

def kernel_row(name, replaces, launches, t, extra=None, source=None):
    source = source or f"src/repro_torch/kernels/{name}/csrc/{name}.cu"
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **(extra or {})}


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
        infos = phase_build()
        grid_err = phase_kernel(dev)
        case = laplacian_case()
        sess, plan, args, launches, ring, ring_ms = phase_main_path(dev,
                                                                    case)
        timing = measure_kernel(dev, plan, args)
        check(timing["route"] == "tc", "the bs-128 main path is off the tc "
              "route")
        semirings = phase_semirings(dev, sess)
        del sess, plan, args      # the SpGEMM session's cached entries
        torch.cuda.empty_cache()
        minplus_main = phase_minplus_main(dev)
        default = phase_default_bs(dev, case, ring_ms)
        summa_launches = phase_summa(dev, case, ring)
        del case
        torch.cuda.empty_cache()
        app_launches = phase_apps(dev)
        phase_build_lm(infos)
        flash_grid_err = phase_flash_grid(dev)
        phase_serve_smoke()
        moe_grid_err = phase_moe_grid(dev)
        (routes, attn_routes, flash, flash_fp32, gemms,
         fp32) = phase_lm_serve(dev)
        split = phase_minplus_split(dev)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except Exception:  # report, then fail the run
        traceback.print_exc()
        return 1
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    timing["library_ms"] = None
    timing["max_abs_err"] = max(grid_err["tc"], timing["err"])
    # minplus launches: device time first, CUDA events beside it
    mp, mp_b, mp_c = (dict(t, **split[label], events_ms=t["ms"],
                           previous_events_ms=t["previous_ms"],
                           ms=split[label]["device_ms"],
                           previous_ms=split[label]["previous_device_ms"])
                      for t, label in ((semirings["min_plus"], "bs64"),
                                       (semirings["min_plus_bs128"], "bs128"),
                                       (minplus_main, "laplacian")))
    mp["max_abs_err"] = grid_err["minplus"]
    mp_keys = ("ms", "main_ms", "combine_ms", "events_ms", "previous_ms",
               "previous_events_ms", "plain_ms", "bound_ms", "bound_by",
               "tile_products", "runs", "longest_run", "workers", "cut_runs",
               "launches")
    bsr_src = "src/repro_torch/kernels/bsr_spgemm/csrc/"
    bsr_pallas = "src/repro/kernels/bsr_spgemm/kernel.py:92"
    flash["max_abs_err"] = max(flash_grid_err["bfloat16"],
                               flash["max_abs_err"])
    flash_fp32["max_abs_err"] = max(flash_grid_err["float32"],
                                    flash_fp32["max_abs_err"])
    fa_src = "src/repro_torch/kernels/flash_attention/csrc/"
    fa_pallas = "src/repro/kernels/flash_attention/kernel.py:108"
    moe_src = "src/repro_torch/kernels/moe_gemm/csrc/"
    moe_pallas = "src/repro/kernels/moe_gemm/kernel.py:52"
    moe_keys = ("phase", "projection", "shape", "ms", "previous_ms",
                "events_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "host_us_per_call", "launch_us_per_call")

    def moe_row(route, timings, err, source, extra=None):
        head = timings[0]
        return kernel_row(
            f"moe_gemm_{route}", moe_pallas, routes[route],
            {**head, "max_abs_err": max([err] + [t["max_abs_err"]
                                                 for t in timings])},
            {"shape": head["shape"], "previous_ms": head["previous_ms"],
             "shapes": [{k: t[k] for k in moe_keys} for t in timings],
             **(extra or {})},
            source=moe_src + source)

    warp = dict(default["timings"][32], library_ms=None,
                max_abs_err=max(grid_err["warp"],
                                *(t["err"] for t in
                                  default["timings"].values())))
    emit({"kernels": [
        kernel_row("bsr_spgemm_warp", bsr_pallas,
                   default["launches"] + sum(app_launches.values()), warp,
                   {"kernel_route": "warp", "launches_on":
                    "the session at its default bs: laplacian_2d(1024) "
                    "through the 1D ring at bs 32 (chunk None and 2) and 16 "
                    "(chunk None), cold and hit each; bool_or_and at bs 16 "
                    "and min_plus at bs 32 on banded_clustered (chunk 2); "
                    "the apps' kernel runs (AMG, the sketch stream, MCL, "
                    "BC and their resumes)",
                    "launches_by_path": {"default_bs": default["launches"],
                                         "apps": app_launches},
                    "bs": 32, "previous_ms": warp["previous_ms"],
                    "previous_fill_ms": warp["previous_fill_ms"],
                    "float_ms": warp["float_ms"],
                    "float_bound_ms": warp["float_bound_ms"],
                    "fp32_bound_ms": warp["fp32_bound_ms"],
                    "bmm_products_ms": warp["bmm_products_ms"],
                    "bs16": {k: default["timings"][16][k] for k in
                             ("ms", "float_ms", "previous_ms", "plain_ms",
                              "bound_ms", "bound_by", "bmm_products_ms")},
                    "bool_bs16": default["semirings"]["bool_or_and"],
                    "min_plus_bs32": default["semirings"]["min_plus"]},
                   source=bsr_src + "bsr_spgemm_warp.cu"),
        kernel_row("bsr_spgemm_tc", bsr_pallas, launches + summa_launches,
                   timing,
                   {"kernel_route": "tc", "launches_on":
                    "the main path (laplacian_2d(1024), bs 128): the 1D "
                    "ring (chunk None and 2) and 2D / 3D SUMMA, cold, hit "
                    "and repack each",
                    "launches_by_path": {"1d": launches,
                                         "2d_3d": summa_launches},
                    "previous_ms": timing["previous_ms"],
                    "float_ms": timing["float_ms"],
                    "float_bound_ms": timing["float_bound_ms"],
                    "fp32_bound_ms": timing["fp32_bound_ms"],
                    "bmm_products_ms": timing["bmm_products_ms"],
                    "bool_bs64": semirings["bool_or_and"]},
                   source=bsr_src + "bsr_spgemm_tc.cu"),
        kernel_row("bsr_spgemm_minplus", bsr_pallas,
                   mp["launches"] + mp_b["launches"] + mp_c["launches"], mp,
                   {"kernel_route": "minplus", "serves": "min_plus at bs 64 "
                    "and 128", "launches_on":
                    "the min-plus paths: banded_clustered at bs 64 through "
                    "1D (chunk 2), 2D and 3D (launch a, the 1D call's "
                    "largest), at bs 128 through 1D unchunked (launch b), "
                    "and |laplacian_2d(1024)| at bs 128 through 1D "
                    "unchunked (launch c, part 0)",
                    "bs": 64, "ms_is": "profiler device time of the "
                    "product and the combine pass (previous_ms: of the "
                    "simt kernel and its fill); events_ms: CUDA events "
                    "around back-to-back calls, the host's enqueue in it",
                    "previous_ms": mp["previous_ms"],
                    "previous_source": bsr_src + "bsr_spgemm.cu",
                    "launch_a": {k: mp[k] for k in mp_keys},
                    "launch_b": {k: mp_b[k] for k in mp_keys},
                    "launch_c": {k: mp_c[k] for k in mp_keys}},
                   source=bsr_src + "bsr_spgemm_minplus.cu"),
        kernel_row("flash_attention_bf16", fa_pallas, attn_routes["tc"],
                   flash, {"shape": flash["shape"],
                           "previous_ms": flash["previous_ms"],
                           "host_us_per_call": flash["host_us_per_call"],
                           "launch_us_per_call": flash["launch_us_per_call"]},
                   source=fa_src + "flash_attention_tc.cu"),
        kernel_row("flash_attention_fp32", fa_pallas, attn_routes["fp32"],
                   flash_fp32,
                   {"shape": flash_fp32["shape"],
                    "previous_ms": flash_fp32["previous_ms"],
                    "previous_source": fa_src + "flash_attention.cu",
                    "tf32_passes": flash_fp32["tf32_passes"],
                    "fp32_bound_ms": flash_fp32["fp32_bound_ms"],
                    "host_us_per_call": flash_fp32["host_us_per_call"],
                    "launch_us_per_call":
                        flash_fp32["launch_us_per_call"]},
                   source=fa_src + "flash_attention_tf32.cu"),
        moe_row("prefill", gemms[:2], moe_grid_err["bfloat16"],
                "moe_gemm_tc.cu"),
        moe_row("decode", gemms[2:], moe_grid_err["bfloat16"],
                "moe_gemm_tc.cu"),
        moe_row("fp32", fp32, moe_grid_err["float32"], "moe_gemm_tf32.cu",
                {"tf32_passes": fp32[0]["tf32_passes"],
                 "fp32_bound_ms": fp32[0]["fp32_bound_ms"],
                 "previous_source": moe_src + "moe_gemm.cu",
                 "decode_cuda_core_rows_ms": fp32[2]["cuda_core_rows_ms"]})]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
