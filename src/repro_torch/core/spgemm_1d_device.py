"""Device execution of the sparsity-aware 1D SpGEMM — the ring on one GPU.

The port's counterpart of ``repro.core.spgemm_1d_device``. The planner is
the reference's, unchanged: host numpy work that resolves everything
data-dependent before anything runs on the device — tile snapping,
blockizing, the Algorithm-2 payload need maps, per-part product schedules
over the post-fetch stack, the ring's packed send slots, and (``chunk=c``)
the split of the schedule into per-chunk segments. Its arrays are
array-equal to the reference planner's on the same inputs.

What changes is the ring body. The reference runs the P parts on P
devices under ``shard_map`` and delivers each ring step with one
``ppermute``. On one CUDA device the P parts are logical parts of one
process, so a ring step becomes a device-side gather from the owner
part's payload stack: part i receives at step s what part (i+s) mod P
packs for it (``send_slots``). The gather indices are built once per plan
from ``send_slots``; a slot of -1 yields ``semiring.zero``, like every
other pad. Then each part's schedule runs through
``device_common.run_schedule`` — the hand-written CUDA kernel
(``kernels/bsr_spgemm``) or its plain version — and the outputs decode to
one CSC. The plan, the bytes accounting and the stats are the reference's,
so nothing about the algorithm changes.

The whole path is **semiring-generic**: the plan is built for one
:class:`~repro_torch.core.semiring.Semiring`, whose additive identity fills
every absent tile position, pad payload slot and pad product, and whose
``prune_mask`` drives the output decode.

Planner invariant: plan construction contains **no Python-level per-tile
loops** — payload needs, block-fetch grouping, product schedules, and the
output decode are all computed with array ops. Loops over parts / ring
steps (O(P), O(P²) with vectorized bodies) are fine; loops over tiles or
nonzeros are not.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .blocksparse import BlockSparse, build_schedule, flags_from_c_slot
from .device_common import (ENGINES, blockize_parts, check_plan_semiring,
                            decode_tiles, pack_schedules, resolve_device,
                            resolve_engine, run_schedule, snap_to_tiles,
                            window_run_starts)
from .plan import Partition1D
from .semiring import PLUS_TIMES, Semiring
from .sparse import CSC

__all__ = ["DeviceSpGEMMPlan", "build_device_plan", "compile_ring",
           "run_device_spgemm", "decode_ring_output", "payload_need_maps",
           "repack_ring_payloads", "segment_ring_schedule", "recv_index",
           "ENGINES"]


# ---------------------------------------------------------------------------
# host-side plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceSpGEMMPlan:
    """Static-shape plan for one distributed device SpGEMM call."""

    nparts: int
    bs: int
    # padded per-part stacks (numpy, uploaded once per executable):
    a_tiles: np.ndarray        # (P, na_max, bs, bs)
    b_tiles: np.ndarray        # (P, nb_max, bs, bs)
    send_slots: np.ndarray     # (P, S_total) i32: per-step packed slot ids, -1 pad
    # per-device product schedule over the post-fetch combined stack
    # (pad products: a_slot/b_slot 0, c_slot nc_max — the garbage slot):
    a_slot: np.ndarray         # (P, nprod_max) i32
    b_slot: np.ndarray         # (P, nprod_max) i32
    c_slot: np.ndarray         # (P, nprod_max) i32
    flags: np.ndarray          # (P, nprod_max) i32 bit0 first / bit1 last visit
    # static step geometry:
    step_sizes: Tuple[int, ...]   # max payload count per ring step (len P-1)
    nc_max: int
    # decode info (host): output tile coords per device, 0-padded past counts
    c_rows: np.ndarray         # (P, nc_max) i32
    c_cols: np.ndarray         # (P, nc_max) i32
    c_counts: np.ndarray       # (P,) real output-tile count per device
    part_k: Partition1D        # tile-snapped contraction partition (A cols)
    part_n: Partition1D
    out_shape: Tuple[int, int]
    # the semiring the payloads were built for: every pad above is filled
    # with its additive identity, and the decode prunes against it
    semiring: Semiring
    # accounting:
    exact_bytes: int           # planned payload bytes (sum of real tiles moved)
    padded_bytes: int          # what the static-shape ring actually moves
    stats: dict
    # ---- chunked pipeline (chunk=None: single-pass ring — fetch
    # everything, one schedule launch per part). chunk=c splits the ring
    # steps into groups of <= c consecutive steps; the ring body fetches
    # group g+1's payload before group g's schedule segment runs through
    # the kernel, and per-segment partials combine under the semiring's
    # additive monoid. The schedule
    # arrays above are then flat per-segment blocks addressed by the
    # static (seg_prod_off, seg_prod_len) pairs, with a_slot local to each
    # segment's payload stack (own tiles for segment 0, the group's
    # concatenated receives otherwise).
    chunk: Optional[int] = None
    seg_steps: Tuple[Tuple[int, ...], ...] = ((),)   # ring steps per segment
    seg_payload_sizes: Tuple[int, ...] = (0,)        # payload tiles per segment
    seg_prod_off: Tuple[int, ...] = (0,)             # flat schedule offsets
    seg_prod_len: Tuple[int, ...] = (0,)             # padded products per seg


def payload_need_maps(a_parts: List[BlockSparse],
                      col_tile_off: List[int],
                      hit: np.ndarray,
                      nblocks: Optional[int]) -> List[np.ndarray]:
    """Per-owner payload-need matrices, one array op pass per owner.

    Returns, for each owner ``src``, a ``(P, ntiles_src)`` bool matrix whose
    row ``dst`` marks the tiles of ``A_src`` that ``dst``'s plan fetches:
    tile t is needed iff its global tile-col is hit by ``H_dst`` —
    optionally coarsened by the Algorithm-2 ``nblocks`` grouping (the
    owner's distinct nonzero tile-cols are cut into ≤ nblocks groups and
    whole groups are fetched). The grouping is computed once per owner and
    applied to every destination at once; there is no per-tile Python loop
    and no per-(src, dst) dict rebuild.
    """
    Pn = hit.shape[0]
    need_all: List[np.ndarray] = []
    for src, ap in enumerate(a_parts):
        if not ap.ntiles:
            need_all.append(np.zeros((Pn, 0), dtype=bool))
            continue
        gcols = ap.tile_cols + col_tile_off[src]
        need = hit[:, gcols]                       # (P, ntiles_src)
        if nblocks is not None:
            nz = np.unique(ap.tile_cols)
            k = min(nblocks, len(nz))
            bounds = np.linspace(0, len(nz), k + 1).astype(np.int64)
            grp_of_nz = np.searchsorted(bounds, np.arange(len(nz)),
                                        side="right") - 1
            # tile_cols is sorted (from_csc orders by (col, row)), so the
            # per-tile group ids are nondecreasing and each group is one
            # contiguous run — a single reduceat ORs every run per dst.
            grp_of_tile = grp_of_nz[np.searchsorted(nz, ap.tile_cols)]
            starts = np.searchsorted(grp_of_tile, np.arange(k), side="left")
            grp_hit = np.bitwise_or.reduceat(need, starts, axis=1)
            need = grp_hit[:, grp_of_tile]
        need_all.append(need)
    return need_all


def segment_ring_schedule(scheds: List[dict], step_sizes: Sequence[int],
                          max_na: int, chunk: int, nc_max: int) -> dict:
    """Split per-device combined-stack schedules into per-chunk segments.

    ``scheds[d]`` carries the device's products over the combined
    post-fetch stack (``a_slot`` in combined-stack coordinates, ``c_slot``
    nondecreasing). The ring steps are grouped into runs of ``<= chunk``
    consecutive steps; segment 0 is the resident own-tile stack, segment
    ``1+g`` is receive group ``g``. Products are routed to the segment
    whose payload region their ``a_slot`` falls in (one vectorized
    ``searchsorted`` per device — the combined layout is contiguous per
    group, so the rebase to segment-local payload indices is a subtraction)
    and packed into per-segment ``(P, len_g)`` blocks concatenated flat,
    with pads pointing at local payload slot 0 and the garbage output slot
    ``nc_max``. Product order is preserved inside each segment, so each
    segment's ``c_slot`` stays nondecreasing and its first/last-visit
    flags are valid *within the segment*; cross-segment revisits are
    combined by the pipeline body under the semiring's additive monoid.
    """
    Pn = len(scheds)
    nsteps = len(step_sizes)
    step_off = np.concatenate(
        [[0], np.cumsum(np.asarray(step_sizes, dtype=np.int64))])
    groups = [tuple(range(g, min(g + chunk, nsteps)))
              for g in range(0, nsteps, chunk)]
    # payload region starts in the combined stack, one per segment
    seg_payload_off = np.asarray(
        [0] + [max_na + int(step_off[g[0]]) for g in groups], dtype=np.int64)
    seg_payload_sizes = tuple(
        [max_na] + [int(step_off[g[-1] + 1] - step_off[g[0]])
                    for g in groups])
    G = len(seg_payload_off)

    parts: List[List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = []
    counts = np.zeros((Pn, G), dtype=np.int64)
    for d, s in enumerate(scheds):
        a_sl = np.asarray(s["a_slot"], dtype=np.int64)
        sid = np.searchsorted(seg_payload_off, a_sl, side="right") - 1
        row = []
        for g in range(G):
            m = sid == g
            row.append((a_sl[m] - seg_payload_off[g],
                        np.asarray(s["b_slot"])[m],
                        np.asarray(s["c_slot"])[m]))
            counts[d, g] = int(m.sum())
        parts.append(row)

    seg_len = tuple(int(x) for x in counts.max(axis=0))
    seg_off = tuple(int(x) for x in
                    np.concatenate([[0], np.cumsum(seg_len)[:-1]]))
    total = max(int(sum(seg_len)), 1)
    A = np.zeros((Pn, total), dtype=np.int32)
    B = np.zeros((Pn, total), dtype=np.int32)
    C = np.full((Pn, total), nc_max, dtype=np.int32)
    for d in range(Pn):
        for g in range(G):
            al, bl, cl = parts[d][g]
            o = seg_off[g]
            A[d, o:o + len(al)] = al
            B[d, o:o + len(bl)] = bl
            C[d, o:o + len(cl)] = cl
    # flags are per-segment: each (P, len_g) block gets its own
    # first/last-visit runs (pads form a trailing garbage-slot run)
    F = np.zeros((Pn, total), dtype=np.int32)
    for g in range(G):
        o, ln = seg_off[g], seg_len[g]
        if ln:
            F[:, o:o + ln] = flags_from_c_slot(C[:, o:o + ln])
    return dict(a_slot=A, b_slot=B, c_slot=C, flags=F,
                seg_steps=((),) + tuple(groups),
                seg_payload_sizes=seg_payload_sizes,
                seg_prod_off=seg_off, seg_prod_len=seg_len)


def build_device_plan(a: CSC, b: CSC, nparts: int,
                      part_k: Optional[Partition1D] = None,
                      part_n: Optional[Partition1D] = None,
                      bs: int = 128,
                      nblocks: Optional[int] = None,
                      dtype=np.float32,
                      semiring: Semiring = PLUS_TIMES,
                      a_blockize_cache: Optional[dict] = None,
                      chunk: Optional[int] = None
                      ) -> DeviceSpGEMMPlan:
    """Symbolic phase at tile granularity + static-shape padding.

    ``semiring`` fixes the payload fill: every absent tile position, pad
    slot and pad product is the semiring's additive identity (its
    multiplicative annihilator too), so the engines stay mask-free under
    min-plus / bool exactly as under plus-times.

    ``chunk`` enables the double-buffered k-chunk pipeline: the ring steps
    are grouped into runs of ``<= chunk`` steps, the product schedule is
    split into matching segments at build time, and the ring body fetches
    each group before the previous segment's compute, bounding the
    per-part fetched working set by two adjacent chunks
    instead of the whole gathered stack. ``None`` keeps the legacy
    single-pass ring. Both decode bitwise-identically for every semiring.

    ``a_blockize_cache``: callers that re-plan against the *same* A many
    times (BC multiplies one adjacency operand by a fresh frontier every
    level) pass a dict here to reuse A's blockization across calls. The
    cache pins the operand object (so the ``id``-based key cannot go
    stale) and assumes it is not mutated between calls.
    """
    assert a.ncols == b.nrows
    if chunk is not None:
        chunk = int(chunk)
        if chunk < 1:
            raise ValueError(f"chunk must be a positive int or None, "
                             f"got {chunk}")
    t_plan0 = time.perf_counter()
    Pn = nparts
    if part_k is None:
        part_k = Partition1D.balanced(a.ncols, Pn)
    if part_n is None:
        part_n = Partition1D.balanced(b.ncols, Pn)
    # the k partition must land on tile boundaries, otherwise the parts'
    # local tile grids don't embed into the global k tile space
    part_k = snap_to_tiles(part_k, bs)

    if a_blockize_cache is None:
        a_parts = blockize_parts(a, part_k, bs, dtype, fill=semiring.zero)
    else:
        key = (id(a), tuple(int(s) for s in part_k.splits), bs,
               np.dtype(dtype).str, float(semiring.zero))
        cached = a_blockize_cache.get(key)
        if cached is None or cached[0] is not a:
            cached = (a, blockize_parts(a, part_k, bs, dtype,
                                         fill=semiring.zero))
            # bounded FIFO: callers alternate between a handful of static
            # operands (BC: Aᵀ forward / A backward); evicting beyond that
            # keeps the pinned-operand retention O(1), not O(calls)
            while len(a_blockize_cache) >= 4:
                a_blockize_cache.pop(next(iter(a_blockize_cache)))
            a_blockize_cache[key] = cached
        a_parts = cached[1]
    b_parts = blockize_parts(b, part_n, bs, dtype, fill=semiring.zero)

    # tile-level hit vectors: device i needs global tile-row g of B_i ⇔ some
    # nonzero of B_i falls in element rows [g*bs, (g+1)*bs)
    kg = math.ceil(a.ncols / bs)  # global tile count along k
    hit = np.zeros((Pn, kg), dtype=bool)
    for i, bp in enumerate(b_parts):
        hit[i, bp.tile_rows] = True

    # per-owner global tile-col offsets of A's local grids
    col_tile_off = [part_k.part_slice(j)[0] // bs for j in range(Pn)]

    need_all = payload_need_maps(a_parts, col_tile_off, hit, nblocks)

    # ring steps: at step s, dst i receives from src (i+s) mod P
    step_sizes: List[int] = []
    send_per_step: List[List[np.ndarray]] = []   # [step][device j] slots
    recv_per_dev: List[List[np.ndarray]] = [[] for _ in range(Pn)]
    exact_tiles = 0
    planned_msgs = 0
    for s in range(1, Pn):
        sends = []
        for j in range(Pn):
            dst = (j - s) % Pn
            slots = np.nonzero(need_all[j][dst])[0].astype(np.int32)
            sends.append(slots)
            exact_tiles += len(slots)
            planned_msgs += int(len(slots) > 0)
        step_sizes.append(max((len(sl) for sl in sends), default=0))
        send_per_step.append(sends)
        for i in range(Pn):
            recv_per_dev[i].append(sends[(i + s) % Pn])

    na_max = max((p.ntiles for p in a_parts), default=0)
    nb_max = max((p.ntiles for p in b_parts), default=0)
    S_total = sum(step_sizes)

    # pad slots hold the additive identity, not literal zeros (semiring fill)
    a_tiles = semiring.fill((Pn, max(na_max, 1), bs, bs), dtype=dtype)
    b_tiles = semiring.fill((Pn, max(nb_max, 1), bs, bs), dtype=dtype)
    send_slots = np.full((Pn, max(S_total, 1)), -1, dtype=np.int32)
    for j in range(Pn):
        if a_parts[j].ntiles:
            a_tiles[j, :a_parts[j].ntiles] = a_parts[j].tiles
        if b_parts[j].ntiles:
            b_tiles[j, :b_parts[j].ntiles] = b_parts[j].tiles
        off = 0
        for s_idx, mx in enumerate(step_sizes):
            sl = send_per_step[s_idx][j]
            send_slots[j, off:off + len(sl)] = sl
            off += mx

    # ---- per-device product schedule over the combined stack ---------------
    # combined stack layout on device i: [own A_i (na_max)] ++ recv step 1
    # (step_sizes[0]) ++ ... ++ recv step P-1. Build a BlockSparse "virtual"
    # A-view per device with *global* tile cols and stack-slot payload ids.
    max_na = max(na_max, 1)
    scheds = []
    for i in range(Pn):
        rows_l, cols_l, slots_l = [], [], []
        ap = a_parts[i]
        if ap.ntiles:
            rows_l.append(ap.tile_rows)
            cols_l.append(ap.tile_cols + col_tile_off[i])
            slots_l.append(np.arange(ap.ntiles, dtype=np.int64))
        off = max_na
        for s_idx in range(Pn - 1):
            src = (i + 1 + s_idx) % Pn
            slots = recv_per_dev[i][s_idx]
            spart = a_parts[src]
            if len(slots):
                rows_l.append(spart.tile_rows[slots])
                cols_l.append(spart.tile_cols[slots] + col_tile_off[src])
                slots_l.append(off + np.arange(len(slots), dtype=np.int64))
            off += step_sizes[s_idx]
        if rows_l:
            vrows = np.concatenate(rows_l).astype(np.int32)
            vcols = np.concatenate(cols_l).astype(np.int32)
            vslots = np.concatenate(slots_l)
        else:
            vrows = np.zeros(0, np.int32)
            vcols = np.zeros(0, np.int32)
            vslots = np.zeros(0, np.int64)

        # virtual A view (payloads indexed by stack slot), global k tile space
        virt = BlockSparse(
            tiles=np.zeros(  # replint: off=RS003 1x1 placeholder payloads; only tile coords feed build_schedule, values never read
                (len(vrows), 1, 1), dtype=dtype),
            tile_rows=vrows, tile_cols=vcols,
            shape=(a_parts[i].shape[0], kg * bs),
            orig_shape=(a.nrows, a.ncols), bs=bs)
        bp = b_parts[i]
        bview = BlockSparse(
            tiles=np.zeros(  # replint: off=RS003 1x1 placeholder payloads; only tile coords feed build_schedule, values never read
                (bp.ntiles, 1, 1), dtype=dtype),
            tile_rows=bp.tile_rows, tile_cols=bp.tile_cols,
            shape=(kg * bs, bp.shape[1]),
            orig_shape=(a.ncols, bp.orig_shape[1]), bs=bs)
        sched = build_schedule(virt, bview)
        scheds.append(dict(a_slot=vslots[sched.a_slot].astype(np.int32),
                           b_slot=sched.b_slot, c_slot=sched.c_slot,
                           c_rows=sched.c_rows, c_cols=sched.c_cols))

    # pad products target the garbage output slot nc_max with payload slot 0:
    # the engines compute them unmasked and the trailing slot is dropped.
    packed = pack_schedules(scheds)
    nprod_max, nc_max = packed["nprod_max"], packed["nc_max"]

    # ---- schedule segmentation (chunked pipeline) --------------------------
    if chunk is None:
        # legacy single-pass ring: one segment spanning own + all receives
        sched_flat = dict(a_slot=packed["a_slot"], b_slot=packed["b_slot"],
                          c_slot=packed["c_slot"], flags=packed["flags"])
        seg_steps: Tuple[Tuple[int, ...], ...] = (tuple(range(Pn - 1)),)
        seg_payload_sizes = (max_na + S_total,)
        seg_prod_off = (0,)
        seg_prod_len = (int(nprod_max),)
        peak_payload_tiles = max_na + S_total
        overlap_fraction = 0.0
    else:
        seg = segment_ring_schedule(scheds, step_sizes, max_na, chunk,
                                    nc_max)
        sched_flat = dict(a_slot=seg["a_slot"], b_slot=seg["b_slot"],
                          c_slot=seg["c_slot"], flags=seg["flags"])
        seg_steps = seg["seg_steps"]
        seg_payload_sizes = seg["seg_payload_sizes"]
        seg_prod_off = seg["seg_prod_off"]
        seg_prod_len = seg["seg_prod_len"]
        # double-buffered working set: own stack + current + next chunk
        rs = list(seg_payload_sizes[1:])
        if not rs:
            peak_payload_tiles = max_na
        elif len(rs) == 1:
            peak_payload_tiles = max_na + rs[0]
        else:
            peak_payload_tiles = max_na + max(
                rs[i] + rs[i + 1] for i in range(len(rs) - 1))
        # modeled fetch-issue overlap: a chunk's fetch is overlapped iff
        # the preceding segment has compute to hide it behind
        overlapped = sum(rs[i] for i in range(len(rs))
                         if seg_prod_len[i] > 0)
        overlap_fraction = overlapped / S_total if S_total else 0.0

    tile_bytes = bs * bs * np.dtype(dtype).itemsize
    padded_tiles = Pn * S_total
    nprod_total = int(sum(len(s["a_slot"]) for s in scheds))
    plan_seconds = time.perf_counter() - t_plan0
    return DeviceSpGEMMPlan(
        nparts=Pn, bs=bs,
        a_tiles=a_tiles, b_tiles=b_tiles, send_slots=send_slots,
        a_slot=sched_flat["a_slot"], b_slot=sched_flat["b_slot"],
        c_slot=sched_flat["c_slot"], flags=sched_flat["flags"],
        step_sizes=tuple(step_sizes), nc_max=nc_max,
        c_rows=packed["c_rows"], c_cols=packed["c_cols"],
        c_counts=packed["c_counts"],
        part_k=part_k, part_n=part_n, out_shape=(a.nrows, b.ncols),
        semiring=semiring,
        exact_bytes=exact_tiles * tile_bytes,
        padded_bytes=padded_tiles * tile_bytes,
        chunk=chunk, seg_steps=seg_steps,
        seg_payload_sizes=seg_payload_sizes,
        seg_prod_off=seg_prod_off, seg_prod_len=seg_prod_len,
        stats=dict(
            # shared device-engine stats surface (device_common.REQUIRED_STATS)
            comm_bytes_planned=exact_tiles * tile_bytes,
            comm_bytes_padded=padded_tiles * tile_bytes,
            messages=int(planned_msgs),
            dense_flops=2 * nprod_total * bs ** 3,
            plan_seconds=plan_seconds,
            peak_payload_tiles=int(peak_payload_tiles),
            chunks=len(seg_steps),
            overlap_fraction=float(overlap_fraction),
            # 1D-specific detail
            na_max=na_max, nb_max=nb_max, nprod_max=int(nprod_max),
            nprod_total=nprod_total,
            nc_max=int(nc_max), ring_steps=Pn - 1,
            exact_tiles=int(exact_tiles), padded_tiles=int(padded_tiles),
        ),
    )


def _refill_stack(mat: CSC, part: Partition1D, shape, bs: int, dtype,
                  semiring: Semiring) -> np.ndarray:
    parts = blockize_parts(mat, part, bs, dtype, fill=semiring.zero)
    stack = semiring.fill(shape, dtype=dtype)
    for j, p in enumerate(parts):
        if p.ntiles:
            stack[j, :p.ntiles] = p.tiles
    return stack


def repack_ring_payloads(plan: DeviceSpGEMMPlan,
                         a: Optional[CSC] = None,
                         b: Optional[CSC] = None
                         ) -> Tuple[Optional[np.ndarray],
                                    Optional[np.ndarray]]:
    """Fresh payload stacks for *structure-identical* operands.

    The values-only half of re-planning: blockize the changed operand(s)
    on the plan's (tile-snapped) partitions and refill the static payload
    stacks. Pass only the side(s) whose values changed — a ``None``
    operand returns a ``None`` stack, so a loop-invariant operand (BC's
    adjacency across the backward sweep) costs nothing to keep resident.
    Everything structural — schedules, send slots, step geometry, decode
    coordinates — is untouched, so the caller can reuse the plan and its
    executable (``core.session`` does exactly that on a
    structure-keyed cache hit whose values changed). Blockization is
    deterministic given structure (``from_csc`` orders tiles by
    (col, row)), so feeding these stacks to the cached executable decodes
    bitwise-identically to a cold re-plan.
    """
    dtype = plan.a_tiles.dtype
    sr = plan.semiring
    a_tiles = None if a is None else _refill_stack(
        a, plan.part_k, plan.a_tiles.shape, plan.bs, dtype, sr)
    b_tiles = None if b is None else _refill_stack(
        b, plan.part_n, plan.b_tiles.shape, plan.bs, dtype, sr)
    return a_tiles, b_tiles


# ---------------------------------------------------------------------------
# device execution
# ---------------------------------------------------------------------------

def recv_index(plan: DeviceSpGEMMPlan, steps: Sequence[int]) -> np.ndarray:
    """(P, n) flat payload indices each part receives over ``steps``.

    Part i receives at ring step s (= s_idx + 1) the slots that owner
    (i+s) mod P packed for it in ``send_slots``; an index addresses the
    owners' stacked payloads ``a_tiles.reshape(P * na, bs, bs)``, and -1
    marks a pad slot (filled with ``semiring.zero`` after the gather).
    """
    Pn = plan.nparts
    na = plan.a_tiles.shape[1]
    offs = np.concatenate([[0], np.cumsum(plan.step_sizes)]).astype(np.int64)
    cols = [np.zeros((Pn, 0), dtype=np.int64)]
    for s_idx in steps:
        src = (np.arange(Pn) + s_idx + 1) % Pn
        slots = plan.send_slots[src, offs[s_idx]:offs[s_idx + 1]]
        cols.append(np.where(slots >= 0, src[:, None] * na + slots, -1))
    return np.concatenate(cols, axis=1)


def _windows(plan: DeviceSpGEMMPlan) -> List[Tuple[int, int]]:
    """The (offset, length) schedule window of every segment."""
    if plan.chunk is None:
        return [(0, int(plan.a_slot.shape[1]))]
    return list(zip(plan.seg_prod_off, plan.seg_prod_len))


def _run_starts(plan: DeviceSpGEMMPlan, part: int, off: int,
                ln: int) -> np.ndarray:
    """Run boundaries of one part's window, for the kernel, once per plan
    (``device_common.window_run_starts``)."""
    return window_run_starts(plan.flags[part], plan.c_slot[part],
                             plan.nc_max, off, ln)


def _make_step_fn(plan: DeviceSpGEMMPlan, device: torch.device, engine: str,
                  trace_probe: Optional[Callable] = None):
    """Build the ring body: the plan's derived device tensors (gather
    indices, pad masks, run starts) plus the closure that
    runs all P parts. Built once per plan — ``trace_probe`` fires here, so
    the session counts builds, and a cache hit shows none."""
    if trace_probe is not None:
        trace_probe()
    Pn, bs, nc_max = plan.nparts, plan.bs, plan.nc_max
    na = plan.a_tiles.shape[1]
    semiring = plan.semiring
    windows = _windows(plan)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    if plan.chunk is None:
        # own stack ++ every receive: one payload stack per part
        own = np.arange(Pn)[:, None] * na + np.arange(na)[None, :]
        seg_index = [np.concatenate(
            [own, recv_index(plan, range(Pn - 1))], axis=1)]
    else:
        # segment 0 is the resident own stack; segment g is receive group g
        seg_index = [None] + [recv_index(plan, steps)
                              for steps in plan.seg_steps[1:]]
    gathers = [None if ix is None else
               [(put(ix[i].clip(min=0)), put(ix[i] < 0) if (ix[i] < 0).any()
                 else None) for i in range(Pn)]
               for ix in seg_index]
    starts = [[put(_run_starts(plan, i, off, ln)) for off, ln in windows]
              for i in range(Pn)]

    def fetch(a_flat, g, i):
        # one segment's payload for part i: a gather from the owners'
        # stacks, pad slots set to the additive identity
        idx, pad = gathers[g][i]
        stack = a_flat.index_select(0, idx)
        if pad is not None:
            stack.masked_fill_(pad[:, None, None], semiring.zero)
        return stack

    def body(a_tiles, b_tiles, a_slot, b_slot, c_slot):
        a_flat = a_tiles.reshape(Pn * na, bs, bs)
        out = torch.empty((Pn, nc_max + 1, bs, bs), dtype=torch.float32,
                          device=device)

        def compute(i, g, payload, dst=None):
            off, ln = windows[g]
            return run_schedule(payload, b_tiles[i], a_slot[i], b_slot[i],
                                c_slot[i], starts[i][g], engine=engine,
                                nprod_max=ln, nc_max=nc_max, bs=bs,
                                semiring=semiring, seg_start=off, out=dst)

        if plan.chunk is None:
            for i in range(Pn):
                compute(i, 0, fetch(a_flat, 0, i), dst=out[i])
            return out[:, :nc_max]

        # chunked pipeline: an identity-filled accumulator per part; the
        # next chunk's payload is gathered before the current segment's
        # compute, so at most two receive chunks are live at once, and
        # partials combine under the semiring's additive monoid. Both
        # engines leave slots a segment does not visit at the identity
        # (the Pallas kernel left them unspecified and needed a visited
        # mask), so a partial adds in as it is
        out.fill_(semiring.zero)
        G = len(windows)
        for i in range(Pn):
            cur = a_tiles[i]
            for g in range(G):
                nxt = fetch(a_flat, g + 1, i) if g + 1 < G else None
                if windows[g][1] > 0:
                    semiring.add(out[i], compute(i, g, cur), out=out[i])
                cur = nxt
        return out[:, :nc_max]

    return body


def compile_ring(plan: DeviceSpGEMMPlan, device="cuda", engine: str = "auto",
                 semiring: Optional[Semiring] = None,
                 trace_probe: Optional[Callable] = None):
    """Upload the plan and build the ring; returns ``(fn, args)``.

    ``fn(*args)`` yields the raw ``(P, nc_max, bs, bs)`` output stacks on
    the device. ``args`` are the payload stacks and the schedule arrays
    (``[a_tiles, b_tiles, a_slot, b_slot, c_slot]``); a values-only repack
    swaps ``args[0]`` / ``args[1]`` and reuses ``fn``.
    """
    dev = resolve_device(device)
    engine = resolve_engine(engine, dev)
    check_plan_semiring(plan.semiring, semiring)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        plan.a_tiles, plan.b_tiles, plan.a_slot, plan.b_slot, plan.c_slot)]
    return _make_step_fn(plan, dev, engine, trace_probe), args


def decode_ring_output(plan: DeviceSpGEMMPlan, out) -> CSC:
    """Decode the raw ``(P, nc_max, bs, bs)`` ring output to a global CSC.

    The shared semiring-aware decode (``device_common.decode_tiles``): each
    part's output-tile columns are local to its ``part_n`` slice, so the
    part's element offset is added and columns are clipped at the part's
    upper boundary before the single global COO assembly.
    """
    splits = plan.part_n.splits.astype(np.int64)
    return decode_tiles(out, plan.c_rows, plan.c_cols, plan.c_counts,
                        plan.semiring, plan.out_shape,
                        col_off=splits[:-1], col_lim=splits[1:])


def run_device_spgemm(plan: DeviceSpGEMMPlan, device="cuda",
                      engine: str = "auto",
                      semiring: Optional[Semiring] = None) -> CSC:
    """Execute the plan's P parts on ``device`` and decode C."""
    fn, args = compile_ring(plan, device, engine, semiring)
    return decode_ring_output(plan, fn(*args))
