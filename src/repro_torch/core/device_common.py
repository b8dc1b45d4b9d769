"""Shared plan/compile/decode machinery for the device SpGEMM engines.

The port's counterpart of ``repro.core.device_common``. The 1D ring
(``spgemm_1d_device.py``) and the 2D SUMMA / Split-3D engines
(``spgemm_2d_device.py``) share these pieces:

  * device resolution (:func:`resolve_device`: ``"cuda"`` by default, and
    an error — never a quiet CPU run — when no CUDA device is present);
  * tile-aligned partition snapping and per-part blockization
    (:func:`snap_to_tiles`, :func:`blockize_parts`);
  * engine selection (``"cuda"``, the hand-written kernel, / ``"torch"``,
    the plain version, :func:`resolve_engine`) and the plan-vs-call
    semiring handshake (:func:`check_plan_semiring`);
  * static-shape packing of per-part product schedules with the
    garbage-slot pad convention (:func:`pack_schedules`);
  * the compute-phase dispatch (:func:`run_schedule`) and the kernel's
    run boundaries of a schedule window (:func:`window_run_starts`);
  * the semiring-aware output decode, pruned on the output's device before
    the copy back (:func:`decode_tiles`);
  * the shared stats surfaces :data:`REQUIRED_STATS` and
    :data:`SESSION_STATS`, with the reference's keys and meanings.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .blocksparse import BlockSparse, flags_from_c_slot, from_csc
from .plan import Partition1D
from .semiring import Semiring
from .sparse import CSC, from_coo

__all__ = [
    "ENGINES", "REQUIRED_STATS", "CHUNK_STATS", "SESSION_STATS",
    "resolve_device", "snap_to_tiles", "blockize_parts", "resolve_engine",
    "check_plan_semiring", "pack_schedules", "run_schedule",
    "window_run_starts", "decode_tiles",
]

ENGINES = ("cuda", "torch")

# the chunked-pipeline slice of the stats surface:
#   peak_payload_tiles : per-part A-side working set in tiles — own payload
#                        stack plus the fetched chunks resident at once
#                        (current + next chunk); the unchunked ring holds
#                        the whole gathered stack
#   chunks             : schedule segments the compute phase streams through
#   overlap_fraction   : modeled fraction of fetched (padded) tiles whose
#                        fetch is issued while a previous chunk's compute
#                        is outstanding (0.0 for the unchunked ring)
CHUNK_STATS = ("peak_payload_tiles", "chunks", "overlap_fraction")

# every device plan's ``stats`` dict carries these keys with these meanings:
#   comm_bytes_planned : payload bytes of real tiles the algorithm moves
#   comm_bytes_padded  : bytes the static-shape exchange actually moves
#   messages           : planned point-to-point transfers (0 for one part)
#   dense_flops        : flops of the scheduled dense tile products
#   plan_seconds       : host planner wall time
#   peak_payload_tiles / chunks / overlap_fraction : CHUNK_STATS above
REQUIRED_STATS = ("comm_bytes_planned", "comm_bytes_padded", "messages",
                  "dense_flops", "plan_seconds",
                  "peak_payload_tiles", "chunks", "overlap_fraction")

# the persistent-session stats surface (``core.session.SpGEMMSession.stats``
# carries exactly these keys):
#   calls             : multiplies served by the session
#   plan_cache_hits   : structure-identical repeats that skipped planning
#   plan_cache_misses : cold keys that planned + built their executable
#   plan_seconds_saved: sum of cached plans' plan_seconds over the hits
#   payload_repacks   : hits whose operand *values* changed — payload
#                       stacks refilled, plan/executable reused
#   traces            : builds of an executable (the plan's device tensors
#                       plus the ring closure); constant across cache hits
#   evictions         : LRU entries dropped at capacity
#   retries           : per-stage attempts repeated after a retryable failure
#   fallbacks         : degradation-ladder descents (engine cuda→torch)
#   quarantined       : cached entries dropped because a stage failed on them
#   validation_failures : operands rejected at session ingress
#   bytes_cached      : device bytes pinned by cached entries' payload and
#                       schedule stacks
SESSION_STATS = ("calls", "plan_cache_hits", "plan_cache_misses",
                 "plan_seconds_saved", "payload_repacks", "traces",
                 "evictions", "retries", "fallbacks", "quarantined",
                 "validation_failures", "bytes_cached")


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` is the default; asking
    for it without a CUDA device raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain version on the "
            "CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def snap_to_tiles(part: Partition1D, bs: int) -> Partition1D:
    """Round interior split points to multiples of ``bs`` (monotone).

    Interior points are capped at ``ncols`` *before* the monotone sweep —
    rounding up past the end (bs > part width at the tail) must yield empty
    trailing parts, not grow the partition beyond the matrix.
    """
    splits = part.splits.copy()
    splits[1:-1] = np.minimum((splits[1:-1] + bs // 2) // bs * bs,
                              splits[-1])
    return Partition1D(np.maximum.accumulate(splits))


def blockize_parts(mat: CSC, part: Partition1D, bs: int,
                   dtype, fill: float) -> List[BlockSparse]:
    """Blockize each column part of ``mat`` independently. ``fill`` is
    required: it must be the executing semiring's additive identity."""
    return [from_csc(mat.col_slice(*part.part_slice(i)), bs=bs, dtype=dtype,
                     fill=fill)
            for i in range(part.nparts)]


def resolve_engine(engine: str, device: torch.device) -> str:
    """``"auto"`` resolves to the CUDA kernel on a CUDA device and to the
    plain version on the CPU. ``"cuda"`` on CPU tensors runs the kernel
    wrapper, which takes the plain version because the tensors lie on the
    CPU."""
    if engine == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES + ('auto',)}, "
                         f"got {engine!r}")
    return engine


def check_plan_semiring(plan_semiring: Semiring,
                        semiring: Optional[Semiring]) -> Semiring:
    """A device plan's payloads are identity-filled at build time, so the
    semiring is baked in; an explicit argument must match the plan."""
    if semiring is None:
        return plan_semiring
    if semiring.name != plan_semiring.name:
        raise ValueError(
            f"plan was built for semiring {plan_semiring.name!r} "
            f"(payload pads are its identity); cannot execute under "
            f"{semiring.name!r} — rebuild the plan with semiring=")
    return semiring


def pack_schedules(scheds: Sequence[dict]) -> dict:
    """Pad per-part product schedules to one static shape.

    ``scheds[d]`` is a dict with keys ``a_slot``/``b_slot``/``c_slot``
    (equal-length product arrays, ``c_slot`` nondecreasing) and
    ``c_rows``/``c_cols`` (output-tile coordinates). Pad products point at
    payload slot 0 and the trailing garbage output slot ``nc_max``
    (computed unmasked, dropped after the call), flags packed per part.
    """
    D = len(scheds)
    nprod_max = max((len(s["a_slot"]) for s in scheds), default=0)
    nc_max = max((len(s["c_rows"]) for s in scheds), default=0)
    nprod_max = max(nprod_max, 1)
    nc_max = max(nc_max, 1)
    A = np.zeros((D, nprod_max), dtype=np.int32)
    B = np.zeros((D, nprod_max), dtype=np.int32)
    C = np.full((D, nprod_max), nc_max, dtype=np.int32)
    c_rows = np.zeros((D, nc_max), dtype=np.int32)
    c_cols = np.zeros((D, nc_max), dtype=np.int32)
    c_counts = np.zeros(D, dtype=np.int64)
    for d, s in enumerate(scheds):
        n = len(s["a_slot"])
        A[d, :n] = s["a_slot"]
        B[d, :n] = s["b_slot"]
        C[d, :n] = s["c_slot"]
        nc = len(s["c_rows"])
        c_rows[d, :nc] = s["c_rows"]
        c_cols[d, :nc] = s["c_cols"]
        c_counts[d] = nc
    return dict(a_slot=A, b_slot=B, c_slot=C, flags=flags_from_c_slot(C),
                c_rows=c_rows, c_cols=c_cols, c_counts=c_counts,
                nprod_max=int(nprod_max), nc_max=int(nc_max))


def run_schedule(stack_a, stack_b, a_slot, b_slot, c_slot, run_starts, *,
                 engine: str, nprod_max: int, nc_max: int, bs: int,
                 semiring: Semiring, seg_start: int = 0, out=None):
    """Compute phase of one part: the schedule window ``[seg_start,
    seg_start + nprod_max)`` over the payload stacks, through the CUDA
    kernel wrapper (``engine="cuda"``) or the plain version
    (``engine="torch"``). Returns the ``(nc_max + 1, bs, bs)`` output
    stack *including* the trailing garbage slot every pad product targets
    (callers drop it); slots no product visits hold ``semiring.zero``.
    """
    from ..kernels.bsr_spgemm.kernel import bsr_spgemm
    from ..kernels.bsr_spgemm.ref import bsr_spgemm_ref

    if engine == "cuda":
        return bsr_spgemm(stack_a, stack_b, a_slot, b_slot, c_slot,
                          run_starts, nprod=nprod_max, nc=nc_max + 1, bs=bs,
                          semiring=semiring, seg_start=seg_start, out=out)
    res = bsr_spgemm_ref(stack_a, stack_b, a_slot, b_slot, c_slot,
                         nc=nc_max + 1, semiring=semiring,
                         seg_start=seg_start, seg_len=nprod_max)
    return res if out is None else out.copy_(res)


def window_run_starts(flags: np.ndarray, c_slot: np.ndarray, nc_max: int,
                      off: int, ln: int) -> np.ndarray:
    """Run boundaries of one part's schedule window ``[off, off + ln)`` for
    the kernel (``flags`` / ``c_slot`` are the part's rows), once per plan.
    The trailing run of pad products (the garbage slot ``nc_max``) is left
    out: its output is dropped, so the kernel need not compute it."""
    from ..kernels.bsr_spgemm.kernel import run_starts_from_flags

    starts = run_starts_from_flags(flags, off, ln)
    if len(starts) > 1 and c_slot[starts[-2]] == nc_max:
        starts = starts[:-1]
    return starts


# output tiles pruned at once in a decode: bounds the prune's temporaries
# (a float and a bool copy of the chunk) to 256 MiB at bs 128
DECODE_CHUNK_TILES = 4096


def decode_tiles(out, c_rows: np.ndarray, c_cols: np.ndarray,
                 c_counts: np.ndarray, semiring: Semiring,
                 out_shape: Tuple[int, int],
                 col_off: Optional[np.ndarray] = None,
                 col_lim: Optional[np.ndarray] = None) -> CSC:
    """Decode per-part output tile stacks into one global CSC.

    The prune runs where ``out`` lies (a torch tensor on the device, or a
    numpy array on the host), one part and at most
    :data:`DECODE_CHUNK_TILES` tiles at a time, and only the surviving COO
    triples are copied back. Tiles past each part's real count are
    treated as the additive identity; an entry is kept iff the semiring's
    ``prune_mask`` keeps it, never by a literal nonzero test.

    out      : (D, nc_max, bs, bs) part outputs (garbage slot dropped)
    c_rows   : (D, nc_max) global tile-grid rows of each output payload
    c_cols   : (D, nc_max) tile-grid cols — global, or local to a column
               part when ``col_off`` carries the per-part element offset
    c_counts : (D,) real output-tile count per part
    col_off  : (D,) element-column offset added per part (1D ring parts)
    col_lim  : (D,) exclusive global column bound per part
    """
    out = torch.as_tensor(out)
    D, nc_max, bs, _ = out.shape
    if col_off is None:
        col_off = np.zeros(D, dtype=np.int64)
    if col_lim is None:
        col_lim = np.full(D, out_shape[1], dtype=np.int64)
    rows_l, cols_l, vals_l = [], [], []
    for d in range(D):
        for t0 in range(0, max(int(c_counts[d]), 1), DECODE_CHUNK_TILES):
            part = out[d, t0:min(int(c_counts[d]), t0 + DECODE_CHUNK_TILES)]
            tt, rr, cc = torch.nonzero(semiring.prune_mask(part),
                                       as_tuple=True)
            vals = part[tt, rr, cc].cpu().numpy()
            tt, rr, cc = (x.cpu().numpy() for x in (tt, rr, cc))
            tt = tt + t0
            rows_g = rr + c_rows[d, tt].astype(np.int64) * bs
            cols_g = (cc + c_cols[d, tt].astype(np.int64) * bs
                      + int(col_off[d]))
            keep = (rows_g < out_shape[0]) & (cols_g < int(col_lim[d]))
            rows_l.append(rows_g[keep])
            cols_l.append(cols_g[keep])
            vals_l.append(vals[keep])
    return from_coo(np.concatenate(rows_l), np.concatenate(cols_l),
                    np.concatenate(vals_l), out_shape)
