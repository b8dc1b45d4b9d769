"""Hopper CUDA kernels: scheduled block-sparse semiring product.

Replaces ``src/repro/kernels/bsr_spgemm/kernel.py::bsr_spgemm_pallas``. Three
routes, chosen by :func:`route` from the semiring and bs alone:

* ``"warp"`` — every semiring at bs 16 and 32 (the session's default bs
  and every app's), ``csrc/bsr_spgemm_warp.cu``: one warp per run of
  products that share an output tile, persistent warps striding over the
  runs, a ``cp.async`` ring per warp kept full across run boundaries.
  plus_times and bool_or_and run ``mma.sync`` m16n8k8 (tf32 in, fp32
  accumulate) in the ``"tc"`` route's exact arithmetic below; min_plus
  runs on the CUDA cores in a NaN-propagating min, two warps a run at bs
  32. The kernel writes the identity into every output slot no run
  writes.
* ``"tc"`` — plus_times and bool_or_and at bs 64 and 128,
  ``csrc/bsr_spgemm_tc.cu``: persistent CTAs walk the runs; a producer
  keeps a TMA ring of 32-deep k-panels full across run boundaries, and the
  consumer warpgroups stage each panel (B transposed on the way), split an
  operand that is not TF32-exact into TF32 hi and lo parts, and run
  ``wgmma`` (tf32 in, fp32 accumulate) on hi.hi plus whichever lo passes
  the panel needs. Integer-valued tiles (exact up to 2048) run one pass
  and stay bitwise equal to the plain version; general floats run up to
  four (``ref.bsr_spgemm_tc_model`` is this arithmetic on the CPU, for
  both tensor-core routes). A k-panel holding an infinity, a NaN or an
  ``|x| >= 2**127``, which the split cannot carry, or whose A and B parts'
  largest magnitudes multiply to ``2**126`` or more, where the split's
  hi·hi could overflow and the fp32 product would not, is summed unsplit
  on the CUDA cores in fp32, as the plain version sums it. The kernel also
  writes the identity into every output slot no run writes.
* ``"minplus"`` — min_plus at bs 64 and 128,
  ``csrc/bsr_spgemm_minplus.cu``: fp32 on the CUDA cores (min-plus has no
  tensor-core form) in the NaN-propagating min. Persistent CTAs take equal
  shares of the window's 32-deep k-panels (:func:`minplus_shares`); a run
  cut between shares is combined by min in a second small kernel, exact
  in any order. The kernel writes the identity (+inf) into every output
  slot no run writes.

``csrc/bsr_spgemm.cu`` (one CTA per run on the CUDA cores, after an
identity fill of the whole output by the wrapper) is the routes' first
kernel and is on no route: ``_launch("simt", ...)`` reaches it, so timings
can set it beside the others.

Build and binding: ``..cuda_lib`` compiles the four sources for
``sm_90a`` at first use, one ``nvcc`` each, and ``ctypes`` loads them. The
``"tc"`` library encodes its TMA tensor maps per launch with the CUDA
driver API's ``cuTensorMapEncodeTiled``, reached through
``cudaGetDriverEntryPoint``. Nothing is compiled or loaded at import.

:func:`bsr_spgemm` is the wrapper. A tensor on the CPU goes to the plain
version (``ref.bsr_spgemm_ref``) because it lies on the CPU; a CUDA tensor
launches its route's kernel on the current stream or raises — there is no
fallback to another route or to the plain version.
``bsr_spgemm.launches`` counts kernel launches,
``bsr_spgemm.route_launches`` the same per route.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ...core.semiring import PLUS_TIMES, Semiring
from ..cuda_lib import check_tensor, compile_sources
from .ref import PANEL, bsr_spgemm_ref

__all__ = ["bsr_spgemm", "run_starts_from_flags", "check_launch_args",
           "build", "route", "reset_launches", "smem_bytes",
           "minplus_workers", "minplus_shares", "KERNEL_BS", "TC_BS",
           "TC_SEMIRINGS", "WARP_BS", "ROUTES", "SOURCE", "TC_SOURCE",
           "WARP_SOURCE", "MINPLUS_SOURCE", "SOURCES", "PANEL"]

KERNEL_BS = (16, 32, 64, 128)
TC_BS = (64, 128)
TC_SEMIRINGS = ("plus_times", "bool_or_and")
WARP_BS = (16, 32)
ROUTES = ("tc", "warp", "minplus")
SOURCE = Path(__file__).resolve().parent / "csrc" / "bsr_spgemm.cu"
TC_SOURCE = SOURCE.with_name("bsr_spgemm_tc.cu")
WARP_SOURCE = SOURCE.with_name("bsr_spgemm_warp.cu")
MINPLUS_SOURCE = SOURCE.with_name("bsr_spgemm_minplus.cu")
SOURCES = (SOURCE, TC_SOURCE, WARP_SOURCE, MINPLUS_SOURCE)
_SEMIRING_CODE = {"plus_times": 0, "bool_or_and": 1, "min_plus": 2}

_lib: Optional[Dict[str, ctypes.CDLL]] = None
_workers: Dict[tuple, int] = {}


def build() -> dict:
    """Compile (if not yet built) and load the four kernel libraries;
    returns ``{source: {"path", "seconds", "built", "log"}}`` as
    ``cuda_lib.compile_sources`` does. A failing build raises
    ``RuntimeError`` with nvcc's output."""
    global _lib
    infos = compile_sources(SOURCES)
    if _lib is None:
        simt = ctypes.CDLL(infos[SOURCE]["path"])
        simt.bsr_spgemm_launch.argtypes = (
            [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        simt.bsr_spgemm_launch.restype = ctypes.c_int
        tc = ctypes.CDLL(infos[TC_SOURCE]["path"])
        tc.bsr_spgemm_tc_launch.argtypes = (
            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        tc.bsr_spgemm_tc_launch.restype = ctypes.c_int
        tc.bsr_spgemm_tc_smem_bytes.argtypes = [ctypes.c_int]
        tc.bsr_spgemm_tc_smem_bytes.restype = ctypes.c_int
        warp = ctypes.CDLL(infos[WARP_SOURCE]["path"])
        warp.bsr_spgemm_warp_launch.argtypes = (
            [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        warp.bsr_spgemm_warp_launch.restype = ctypes.c_int
        warp.bsr_spgemm_warp_smem_bytes.argtypes = [ctypes.c_int]
        warp.bsr_spgemm_warp_smem_bytes.restype = ctypes.c_int
        mp = ctypes.CDLL(infos[MINPLUS_SOURCE]["path"])
        mp.bsr_spgemm_minplus_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
        mp.bsr_spgemm_minplus_launch.restype = ctypes.c_int
        for fn in (mp.bsr_spgemm_minplus_workers,
                   mp.bsr_spgemm_minplus_smem_bytes):
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_int
        _lib = {"simt": simt, "tc": tc, "warp": warp, "minplus": mp}
    return infos


def route(semiring: Semiring, bs: int) -> str:
    """The kernel a card runs for ``semiring`` at tile size ``bs``:
    ``"warp"`` for every semiring at bs in :data:`WARP_BS`, ``"tc"`` for
    plus_times and bool_or_and at bs in :data:`TC_BS`, ``"minplus"`` for
    min_plus at bs in :data:`TC_BS`."""
    if bs in WARP_BS:
        return "warp"
    return "tc" if semiring.name in TC_SEMIRINGS else "minplus"


def smem_bytes(name: str, bs: int) -> int:
    """Dynamic shared memory of one launch of route ``name`` (``"tc"``,
    ``"warp"`` or ``"minplus"``) at ``bs`` (ptxas reports only static shared
    memory)."""
    if _lib is None:
        build()
    return getattr(_lib[name], f"bsr_spgemm_{name}_smem_bytes")(bs)


def minplus_workers(bs: int, device: torch.device) -> int:
    """The ``"minplus"`` kernel's persistent CTAs on ``device`` at ``bs``:
    as many as fit an SM, at most the kernel's own count, times the SMs.
    Asked of the built library once per device and bs."""
    key = (device.index, bs)
    if key not in _workers:
        if _lib is None:
            build()
        with torch.cuda.device(device):
            n = _lib["minplus"].bsr_spgemm_minplus_workers(bs)
        if n <= 0:
            raise RuntimeError(f"bsr_spgemm minplus: no workers at bs {bs} "
                               f"(error {-n})")
        _workers[key] = n
    return _workers[key]


def minplus_shares(run_starts: np.ndarray, workers: int, bs: int):
    """The ``"minplus"`` kernel's split of a window among ``workers``, as
    the kernel computes it on the card. The window's real products
    (``run_starts[0]`` to ``run_starts[-1]``) are ``bs // PANEL`` k-panels
    each, ``U`` in all; of ``n = min(workers, U)``, worker w takes panels
    ``[w U // n, (w + 1) U // n)`` and the rest none, so no two shares
    differ by more than one panel and a run's pieces lie in consecutive
    shares. Returns ``(bounds, heads)``: the ``workers + 1`` share bounds in
    panels (int64), and per worker the run whose first panel lies before
    its share but which its share continues (the piece the kernel leaves
    for its combine pass), or -1. Only a run that some share bound cuts has
    heads."""
    rs = np.asarray(run_starts, dtype=np.int64)
    kp = bs // PANEL
    total = (rs[-1] - rs[0]) * kp
    n = min(workers, total)
    bounds = np.full(workers + 1, total, dtype=np.int64)
    bounds[:n + 1] = np.arange(n + 1) * total // max(n, 1)
    first = bounds[:-1]
    run = np.searchsorted(rs[:-1], rs[0] + first // kp, side="right") - 1
    starts = (rs[np.clip(run, 0, None)] - rs[0]) * kp
    heads = np.where((first < bounds[1:]) & (starts < first), run, -1)
    return bounds, heads


def run_starts_from_flags(flags: np.ndarray, seg_start: int,
                          nprod: int) -> np.ndarray:
    """Host-side run boundaries of one schedule window, once per plan.

    The products of a window ``[seg_start, seg_start + nprod)`` that share
    an output slot are one run; a run starts where flags bit 0 (first
    visit) is set. Returns the ``nruns + 1`` absolute positions of the run
    starts followed by the window's end, as int32. The window's first
    product always starts a run.
    """
    f = np.asarray(flags)[seg_start:seg_start + nprod]
    starts = np.flatnonzero(f & 1)
    if nprod and (len(starts) == 0 or starts[0] != 0):
        starts = np.concatenate([[0], starts])
    return (np.concatenate([starts, [nprod]]) + seg_start).astype(np.int32)


def check_launch_args(a_tiles, b_tiles, a_slot, b_slot, c_slot, run_starts,
                      out, *, nprod: int, nc: int, bs: int,
                      semiring: Semiring, seg_start: int) -> None:
    """Raise ``ValueError`` on anything the kernels do not take: bs
    outside :data:`KERNEL_BS`, an unknown semiring, tensors on another
    device, of another dtype or shape, non-contiguous, or misaligned (tile
    stacks are read as float4 and through TMA tensor maps, so 16 bytes;
    index arrays 4), or a window with products but an empty tile stack or
    output."""
    if bs not in KERNEL_BS:
        raise ValueError(f"the CUDA kernel takes bs in {KERNEL_BS}, got {bs}")
    if semiring.name not in _SEMIRING_CODE:
        raise ValueError(f"no kernel instantiation for semiring "
                         f"{semiring.name!r}")
    dev = a_tiles.device
    for name, t in (("a_tiles", a_tiles), ("b_tiles", b_tiles),
                    ("out", out)):
        check_tensor(name, t, torch.float32, 3, dev, 16)
        if tuple(t.shape[1:]) != (bs, bs):
            raise ValueError(f"{name} has tiles of shape "
                             f"{tuple(t.shape[1:])}, expected {(bs, bs)}")
    if out.shape[0] != nc:
        raise ValueError(f"out holds {out.shape[0]} tiles, expected {nc}")
    for name, t in (("a_slot", a_slot), ("b_slot", b_slot),
                    ("c_slot", c_slot), ("run_starts", run_starts)):
        check_tensor(name, t, torch.int32, 1, dev, 4)
    for name, t in (("a_slot", a_slot), ("b_slot", b_slot),
                    ("c_slot", c_slot)):
        if t.shape[0] < seg_start + nprod:
            raise ValueError(f"{name} has {t.shape[0]} entries, the window "
                             f"needs {seg_start + nprod}")
    if run_starts.shape[0] < 1:
        raise ValueError("run_starts must hold at least the window end")
    if nprod and min(a_tiles.shape[0], b_tiles.shape[0], nc) < 1:
        raise ValueError("a window with products needs at least one A "
                         "tile, one B tile and one output slot")


def _launch(name: str, a_tiles, b_tiles, a_slot, b_slot, c_slot,
            run_starts, out, *, bs: int, semiring: Semiring) -> bool:
    """One launch of route ``name``'s kernel (or of the first kernel,
    ``"simt"``, on no route) over the runs in ``run_starts``, counted
    nowhere (timings call it directly); returns whether a kernel was
    launched. The ``"tc"``, ``"warp"`` and ``"minplus"`` kernels write every
    slot of ``out`` themselves, also for a window with no run (only pad
    products); ``"minplus"`` gets its scratch (a partial tile and a run
    index per worker) here. ``"simt"`` gets the identity fill of ``out``
    first, and launches nothing for such a window. Raises on a refused
    launch."""
    nruns = run_starts.shape[0] - 1
    if name == "simt":
        out.fill_(semiring.zero)
        if nruns == 0:
            return False
    if _lib is None:
        build()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    code = _SEMIRING_CODE[semiring.name]
    if name == "tc":
        err = _lib["tc"].bsr_spgemm_tc_launch(
            code, bs, a_tiles.data_ptr(), a_tiles.shape[0],
            b_tiles.data_ptr(), b_tiles.shape[0], a_slot.data_ptr(),
            b_slot.data_ptr(), c_slot.data_ptr(), run_starts.data_ptr(),
            nruns, out.data_ptr(), out.shape[0], stream)
    elif name == "minplus":
        workers = minplus_workers(bs, out.device)
        partials = torch.empty((workers, bs, bs), dtype=torch.float32,
                               device=out.device)
        heads = torch.empty(workers, dtype=torch.int32, device=out.device)
        err = _lib["minplus"].bsr_spgemm_minplus_launch(
            bs, a_tiles.data_ptr(), b_tiles.data_ptr(), a_slot.data_ptr(),
            b_slot.data_ptr(), c_slot.data_ptr(), run_starts.data_ptr(),
            nruns, out.data_ptr(), out.shape[0], partials.data_ptr(),
            heads.data_ptr(), workers, stream)
    elif name == "warp":
        err = _lib["warp"].bsr_spgemm_warp_launch(
            code, bs, a_tiles.data_ptr(), b_tiles.data_ptr(),
            a_slot.data_ptr(), b_slot.data_ptr(), c_slot.data_ptr(),
            run_starts.data_ptr(), nruns, out.data_ptr(), out.shape[0],
            stream)
    else:
        err = _lib["simt"].bsr_spgemm_launch(
            code, bs, a_tiles.data_ptr(), b_tiles.data_ptr(),
            a_slot.data_ptr(), b_slot.data_ptr(), c_slot.data_ptr(),
            run_starts.data_ptr(), nruns, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bsr_spgemm {name} launch failed: error {err}")
    return True


def bsr_spgemm(a_tiles: torch.Tensor, b_tiles: torch.Tensor,
               a_slot: torch.Tensor, b_slot: torch.Tensor,
               c_slot: torch.Tensor, run_starts: torch.Tensor, *,
               nprod: int, nc: int, bs: int,
               semiring: Semiring = PLUS_TIMES, seg_start: int = 0,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the product schedule window; returns ``(nc, bs, bs)`` payloads.

    a_tiles / b_tiles : (na, bs, bs), (nb, bs, bs) float32 payload stacks
        whose absent positions hold ``semiring.zero``
    a_slot / b_slot / c_slot : int32 schedule arrays of length
        ``>= seg_start + nprod``; products ``[seg_start, seg_start+nprod)``
        run, ``c_slot`` nondecreasing over the window
    run_starts : int32 ``run_starts_from_flags(flags, seg_start, nprod)``
        on the same device (the plain version does not read it)
    out : optional ``(nc, bs, bs)`` float32 destination

    Slots no product visits hold ``semiring.zero``: every route's kernel
    writes them itself, so the output is never filled first.
    ``nprod == 0`` returns a ``(max(nc, 1), bs, bs)`` identity fill.
    """
    if nprod == 0 or not a_tiles.is_cuda:
        if out is None:
            out = torch.full((max(nc, 1) if nprod == 0 else nc, bs, bs),
                             semiring.zero, dtype=torch.float32,
                             device=a_tiles.device)
        else:
            out.fill_(semiring.zero)
        if nprod:
            out.copy_(bsr_spgemm_ref(a_tiles, b_tiles, a_slot, b_slot,
                                     c_slot, nc=nc, semiring=semiring,
                                     seg_start=seg_start, seg_len=nprod))
        return out

    if out is None:
        out = torch.empty((nc, bs, bs), dtype=torch.float32,
                          device=a_tiles.device)
    check_launch_args(a_tiles, b_tiles, a_slot, b_slot, c_slot, run_starts,
                      out, nprod=nprod, nc=nc, bs=bs, semiring=semiring,
                      seg_start=seg_start)
    name = route(semiring, bs)
    if _launch(name, a_tiles, b_tiles, a_slot, b_slot, c_slot, run_starts,
               out, bs=bs, semiring=semiring):
        bsr_spgemm.launches += 1
        bsr_spgemm.route_launches[name] += 1
    return out


def reset_launches() -> None:
    """Set ``bsr_spgemm.launches`` and every route's count to 0."""
    bsr_spgemm.launches = 0
    bsr_spgemm.route_launches = dict.fromkeys(ROUTES, 0)


reset_launches()
