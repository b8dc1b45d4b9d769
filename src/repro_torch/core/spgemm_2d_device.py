"""Device execution of sparse 2D SUMMA and Split-3D on one GPU.

The port's counterpart of ``repro.core.spgemm_2d_device``: the
sparsity-*oblivious* baselines the paper compares its 1D algorithm against
(CombBLAS's 2D SUMMA, and Split-3D when ``layers > 1``). The MPI original
runs ``grid`` stages on a ``grid x grid`` process mesh: stage ``s``
broadcasts A's block-column ``s`` along process rows and B's block-row
``s`` along process columns; every process multiplies and accumulates into
its local C block. Split-3D adds a ``layers`` axis that splits the
contraction dimension: each layer runs a 2D SUMMA on its k-slice and the
layers' partial C blocks are merged under the semiring's additive monoid.

The planner is the reference's, unchanged: host numpy that blockizes A and
B onto the ``(grid, grid, layers)`` mesh, builds each part's one product
schedule over the union of its stage broadcasts (the reference's
``all_gather`` stacks: stage s's A block at slots ``[s*max_na, ...)``,
likewise B), retargets every layer's schedule onto the union of the
layers' output tiles, and accounts the bytes the oblivious broadcasts move.
Its arrays are array-equal to the reference planner's on the same inputs.

What changes is the body. On one CUDA device the ``grid·grid·layers`` mesh
parts are logical parts of one process, and every part's payload stack
already lies in device memory. So the reference's ``all_gather`` over the
row / column axis becomes an **index remap, not a copy**: the payload
stacks are uploaded once as one flat stack per operand, and each part's
schedule slot ``s*max_na + i`` is rewritten once per plan to the global
slot ``((r*grid + s)*layers + l)*max_na + i`` of the owner's block (for B,
``((s*grid + c)*layers + l)*max_nb + i``). Each part's schedule then runs
through ``device_common.run_schedule`` — the hand-written CUDA kernel
(``kernels/bsr_spgemm``) or its plain version — straight from the flat
stacks. Materialising each part's gathered stack would cost a copy of
``grid`` blocks per part (5.1 GB a part for laplacian_2d(1024)² at grid 2,
bs 128).

The cross-layer merge (the reference's ``Semiring.jnp_axis_reduce``:
psum / pmax / pmin over the layer axis) is ``Semiring.axis_reduce`` over a
tensor dim, streamed layer by layer through a two-slot buffer into each
(r, c) block's accumulator, so no more than two layers' partials are live
at once. Both engines leave every union slot a layer's schedule does not
visit at ``semiring.zero`` (the Pallas kernel left them unspecified, and
the reference reset them with the plan's ``visit`` mask), so the partials
reduce as they are.

Everything is semiring-generic: payload pads, unvisited slots, the
cross-layer reduce and the output decode all go through the plan's
semiring — no literal ``0.0`` anywhere.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .blocksparse import BlockSparse, build_schedule, from_csc
from .device_common import (check_plan_semiring, decode_tiles,
                            pack_schedules, resolve_device, resolve_engine,
                            run_schedule, snap_to_tiles, window_run_starts)
from .plan import BYTES_PER_NNZ, Partition1D
from .semiring import PLUS_TIMES, Semiring
from .sparse import CSC, from_coo

__all__ = ["SummaDevicePlan", "build_summa_plan", "compile_summa",
           "run_device_summa", "decode_summa_output",
           "repack_summa_payloads", "global_slots"]


@dataclasses.dataclass
class SummaDevicePlan:
    """Static-shape plan for one device SUMMA call (2D, or 3D when
    ``layers > 1``). Leading array dims are the logical mesh: (grid, grid,
    layers), part (r, c, l) at flat index ``(r * grid + c) * layers + l``."""

    grid: int
    layers: int
    bs: int
    # per-part payload stacks (numpy; uploaded once as one flat stack each):
    a_tiles: np.ndarray        # (grid, grid, layers, na_max, bs, bs)
    b_tiles: np.ndarray        # (grid, grid, layers, nb_max, bs, bs)
    # per-part product schedule over the gathered stacks — stage s's block
    # at slots [s*max_n, ...) — (pad products: a_slot/b_slot 0, c_slot
    # nc_max — the garbage slot):
    a_slot: np.ndarray         # (grid, grid, layers, nprod_max) i32
    b_slot: np.ndarray         # (grid, grid, layers, nprod_max) i32
    c_slot: np.ndarray         # (grid, grid, layers, nprod_max) i32
    flags: np.ndarray          # (grid, grid, layers, nprod_max) i32
    # union-slot visit mask per layer (slots this layer's schedule writes;
    # both engines leave the rest at the additive identity, so the layer
    # reduce needs no reset — kept for the plan's surface and its tests):
    visit: np.ndarray          # (grid, grid, layers, nc_max + 1) bool
    nc_max: int
    # decode info, per (r, c) — identical across layers by construction:
    c_rows: np.ndarray         # (grid*grid, nc_max) global tile rows
    c_cols: np.ndarray         # (grid*grid, nc_max) global tile cols
    c_counts: np.ndarray       # (grid*grid,) real (union) output-tile count
    # the element partitions the blocks were cut on (tile-aligned):
    part_m: Partition1D        # rows of A / C, grid parts
    part_n: Partition1D        # cols of B / C, grid parts
    part_k: Partition1D        # contraction dim, grid*layers parts:
    #                            piece l*grid + s = layer l, stage s
    out_shape: Tuple[int, int]
    semiring: Semiring
    exact_bytes: int           # real tiles moved (gathers + layer merge)
    padded_bytes: int          # what the static-shape exchange would move
    stats: dict


def _split_rows(sub: CSC, row_part: Partition1D) -> list:
    """Cut a column slice into its row blocks with ONE COO pass: each
    returned CSC is block ``r`` = rows ``row_part[r]`` of ``sub`` (local
    row ids). Replaces per-(row-block) re-slicing of the same columns."""
    rows, cols, vals = sub.to_coo()
    ri = np.searchsorted(row_part.splits, rows, side="right") - 1
    out = []
    for r in range(row_part.nparts):
        rlo, rhi = row_part.part_slice(r)
        keep = ri == r
        out.append(from_coo(rows[keep] - rlo, cols[keep], vals[keep],
                            (max(rhi - rlo, 0), sub.ncols)))
    return out


def _blockize_mesh_a(a: CSC, grid: int, layers: int, bs: int, dtype,
                     semiring: Semiring, part_m: Partition1D,
                     part_k: Partition1D):
    """a_blk[r][s][l]: A rows part_m[r] × k-piece (l*grid + s), owner
    (r, s, l); plus per-block stored-entry counts (explicit identity-valued
    entries included — an oblivious SUMMA moves stored entries regardless
    of value) for the element-level comm model."""
    fill = semiring.zero
    a_blk = [[[None] * layers for _ in range(grid)] for _ in range(grid)]
    a_nnzb = np.zeros((grid, grid, layers), dtype=np.int64)
    for l in range(layers):
        for s in range(grid):
            # slice each k-piece of A once, then bin its rows into the
            # grid row blocks in one COO pass (not grid re-slices)
            klo, khi = part_k.part_slice(l * grid + s)
            for r, blk in enumerate(_split_rows(a.col_slice(klo, khi),
                                                part_m)):
                a_blk[r][s][l] = from_csc(blk, bs=bs, dtype=dtype, fill=fill)
                a_nnzb[r, s, l] = blk.nnz
    return a_blk, a_nnzb


def _blockize_mesh_b(b: CSC, grid: int, layers: int, bs: int, dtype,
                     semiring: Semiring, part_n: Partition1D,
                     part_k: Partition1D):
    """b_blk[s][c][l]: B k-piece (l*grid + s) × cols part_n[c], owner
    (s, c, l); counts as in :func:`_blockize_mesh_a`."""
    fill = semiring.zero
    b_blk = [[[None] * layers for _ in range(grid)] for _ in range(grid)]
    b_nnzb = np.zeros((grid, grid, layers), dtype=np.int64)
    for c in range(grid):
        # each column part of B once, rows binned into the grid*layers
        # k-pieces
        nlo, nhi = part_n.part_slice(c)
        for p, blk in enumerate(_split_rows(b.col_slice(nlo, nhi), part_k)):
            b_blk[p % grid][c][p // grid] = from_csc(blk, bs=bs, dtype=dtype,
                                                     fill=fill)
            b_nnzb[p % grid, c, p // grid] = blk.nnz
    return b_blk, b_nnzb


def _pack_side(blk, grid: int, layers: int, max_n: int, bs: int, dtype,
               semiring: Semiring) -> np.ndarray:
    """Fill one static (grid, grid, layers, max_n, bs, bs) payload stack
    from a per-owner blockization (pads hold the additive identity)."""
    tiles = semiring.fill((grid, grid, layers, max_n, bs, bs), dtype=dtype)
    for r in range(grid):
        for c in range(grid):
            for l in range(layers):
                xb = blk[r][c][l]
                if xb.ntiles:
                    tiles[r, c, l, :xb.ntiles] = xb.tiles
    return tiles


def build_summa_plan(a: CSC, b: CSC, grid: int,
                     layers: int = 1,
                     bs: int = 128,
                     dtype=np.float32,
                     semiring: Semiring = PLUS_TIMES) -> SummaDevicePlan:
    """Blockize A and B onto the (grid, grid, layers) mesh and build every
    device's product schedule over the post-gather stacks.

    All three element partitions are snapped to tile boundaries so block
    tile grids embed into the global tile space (empty blocks — small
    matrices, surplus layers — simply contribute zero tiles). ``semiring``
    fixes the payload fill exactly as in the 1D planner.
    """
    assert a.ncols == b.nrows
    t_plan0 = time.perf_counter()
    m, k, n = a.nrows, a.ncols, b.ncols
    part_m = snap_to_tiles(Partition1D.balanced(m, grid), bs)
    part_n = snap_to_tiles(Partition1D.balanced(n, grid), bs)
    part_k = snap_to_tiles(Partition1D.balanced(k, grid * layers), bs)
    mg = math.ceil(max(m, 1) / bs)
    kg = math.ceil(max(k, 1) / bs)
    ng = math.ceil(max(n, 1) / bs)

    row_tile_off = [part_m.part_slice(r)[0] // bs for r in range(grid)]
    k_tile_off = [part_k.part_slice(p)[0] // bs for p in range(grid * layers)]
    n_tile_off = [part_n.part_slice(c)[0] // bs for c in range(grid)]

    # ---- blockize every block of the 3D distribution -----------------------
    a_blk, a_nnzb = _blockize_mesh_a(a, grid, layers, bs, dtype, semiring,
                                     part_m, part_k)
    b_blk, b_nnzb = _blockize_mesh_b(b, grid, layers, bs, dtype, semiring,
                                     part_n, part_k)

    na_max = max((a_blk[r][s][l].ntiles for r in range(grid)
                  for s in range(grid) for l in range(layers)), default=0)
    nb_max = max((b_blk[s][c][l].ntiles for s in range(grid)
                  for c in range(grid) for l in range(layers)), default=0)
    max_na, max_nb = max(na_max, 1), max(nb_max, 1)

    a_tiles = _pack_side(a_blk, grid, layers, max_na, bs, dtype, semiring)
    b_tiles = _pack_side(b_blk, grid, layers, max_nb, bs, dtype, semiring)

    # ---- per-part schedules over the gathered stacks -----------------------
    # Gathered layout of part (r, c, l): stage s's A block occupies slots
    # [s*max_na, s*max_na + ntiles) of the A stack (the reference's
    # all_gather over the grid-column axis orders by stage); B likewise
    # over the grid-row axis. Virtual views carry *global* tile
    # coordinates, so one build_schedule join pairs tiles of equal global k
    # and merges all stages into one revisit-free schedule.
    scheds = []
    union_rows, union_cols, union_counts = [], [], []
    visit_sets = []            # per flat (r, c, l): visited union slots
    nprod_total = 0
    for r in range(grid):
        for c in range(grid):
            per_layer = []
            for l in range(layers):
                rows_l, cols_l, slots_l = [], [], []
                for s in range(grid):
                    blk = a_blk[r][s][l]
                    if blk.ntiles:
                        rows_l.append(blk.tile_rows + row_tile_off[r])
                        cols_l.append(blk.tile_cols
                                      + k_tile_off[l * grid + s])
                        slots_l.append(s * max_na
                                       + np.arange(blk.ntiles, dtype=np.int64))
                va_rows = (np.concatenate(rows_l).astype(np.int32)
                           if rows_l else np.zeros(0, np.int32))
                va_cols = (np.concatenate(cols_l).astype(np.int32)
                           if cols_l else np.zeros(0, np.int32))
                va_slots = (np.concatenate(slots_l)
                            if slots_l else np.zeros(0, np.int64))

                rows_l, cols_l, slots_l = [], [], []
                for s in range(grid):
                    blk = b_blk[s][c][l]
                    if blk.ntiles:
                        rows_l.append(blk.tile_rows
                                      + k_tile_off[l * grid + s])
                        cols_l.append(blk.tile_cols + n_tile_off[c])
                        slots_l.append(s * max_nb
                                       + np.arange(blk.ntiles, dtype=np.int64))
                vb_rows = (np.concatenate(rows_l).astype(np.int32)
                           if rows_l else np.zeros(0, np.int32))
                vb_cols = (np.concatenate(cols_l).astype(np.int32)
                           if cols_l else np.zeros(0, np.int32))
                vb_slots = (np.concatenate(slots_l)
                            if slots_l else np.zeros(0, np.int64))

                virt_a = BlockSparse(
                    tiles=np.zeros(  # replint: off=RS003 1x1 placeholder payloads; only tile coords feed build_schedule, values never read
                        (len(va_rows), 1, 1), dtype=dtype),
                    tile_rows=va_rows, tile_cols=va_cols,
                    shape=(mg * bs, kg * bs), orig_shape=(m, k), bs=bs)
                virt_b = BlockSparse(
                    tiles=np.zeros(  # replint: off=RS003 1x1 placeholder payloads; only tile coords feed build_schedule, values never read
                        (len(vb_rows), 1, 1), dtype=dtype),
                    tile_rows=vb_rows, tile_cols=vb_cols,
                    shape=(kg * bs, ng * bs), orig_shape=(k, n), bs=bs)
                sched = build_schedule(virt_a, virt_b)
                okeys = (sched.c_cols.astype(np.int64) * mg
                         + sched.c_rows)          # sorted (build_schedule)
                per_layer.append(
                    (va_slots[sched.a_slot].astype(np.int32),
                     vb_slots[sched.b_slot].astype(np.int32),
                     sched.c_slot, okeys))
                nprod_total += sched.nprod

            # union of output tiles across layers: the cross-layer reduce is
            # elementwise, so every layer's schedule retargets union slots
            union = (np.unique(np.concatenate([p[3] for p in per_layer]))
                     if layers > 1 else per_layer[0][3])
            u_rows = (union % mg).astype(np.int32)
            u_cols = (union // mg).astype(np.int32)
            union_rows.append(u_rows)
            union_cols.append(u_cols)
            union_counts.append(len(union))
            for a_sl, b_sl, c_sl, okeys in per_layer:
                remap = np.searchsorted(union, okeys)
                c_union = (remap[c_sl].astype(np.int32)
                           if len(c_sl) else c_sl.astype(np.int32))
                scheds.append(dict(a_slot=a_sl, b_slot=b_sl, c_slot=c_union,
                                   c_rows=u_rows, c_cols=u_cols))
                visit_sets.append(np.unique(c_union))

    packed = pack_schedules(scheds)
    nprod_max, nc_max = packed["nprod_max"], packed["nc_max"]
    D = grid * grid * layers

    visit = np.zeros((D, nc_max + 1), dtype=bool)
    for d, vs in enumerate(visit_sets):
        visit[d, vs] = True
        visit[d, nc_max] = True   # garbage slot: every pad product hits it

    # per-(r, c) decode arrays: layer 0's row of the packed stack (identical
    # across layers — all carry the union coords)
    lead = np.arange(0, D, layers)
    c_rows = packed["c_rows"][lead]
    c_cols = packed["c_cols"][lead]
    c_counts = packed["c_counts"][lead]

    # ---- communication accounting ------------------------------------------
    # gathers: device (r,c,l) receives every A block of its process row but
    # its own, and every B block of its process column but its own
    tile_bytes = bs * bs * np.dtype(dtype).itemsize
    a_ntiles = np.array([[[a_blk[r][s][l].ntiles for l in range(layers)]
                          for s in range(grid)] for r in range(grid)])
    b_ntiles = np.array([[[b_blk[s][c][l].ntiles for l in range(layers)]
                          for c in range(grid)] for s in range(grid)])
    gather_exact = 0
    for r in range(grid):
        for c in range(grid):
            for l in range(layers):
                gather_exact += (a_ntiles[r, :, l].sum() - a_ntiles[r, c, l]
                                 + b_ntiles[:, c, l].sum()
                                 - b_ntiles[r, c, l])
    gather_padded = D * (grid - 1) * (max_na + max_nb)
    # layer merge: every non-root layer's padded partial stack moves once
    merge_exact = (layers - 1) * int(sum(union_counts))
    merge_padded = (layers - 1) * grid * grid * nc_max
    exact_tiles = int(gather_exact) + merge_exact
    padded_tiles = gather_padded + merge_padded

    # element-level model of the gather volume (stored entries inside the
    # moved blocks, BYTES_PER_NNZ each). Counted during the row-binning
    # blockize above — a path independent of ``plan.summa2d_comm_volume``'s
    # COO binning, which it must agree with on the same partitions (pinned
    # by tests/test_torch_summa.py). Stored entries equal to the
    # semiring identity count too: the oblivious algorithm ships them like
    # any other payload. The layer merge is excluded: its element volume
    # needs the partial products' nnz (see ``plan.summa3d_comm_volume``
    # for the host model).
    model_per_proc = np.zeros((grid, grid), dtype=np.int64)
    for r in range(grid):
        for c in range(grid):
            recv = 0
            for l in range(layers):
                recv += (a_nnzb[r, :, l].sum() - a_nnzb[r, c, l]
                         + b_nnzb[:, c, l].sum() - b_nnzb[r, c, l])
            model_per_proc[r, c] = recv * BYTES_PER_NNZ

    messages = D * 2 * (grid - 1) + grid * grid * (layers - 1)
    plan_seconds = time.perf_counter() - t_plan0

    def _reshape(x):
        return x.reshape((grid, grid, layers) + x.shape[1:])

    return SummaDevicePlan(
        grid=grid, layers=layers, bs=bs,
        a_tiles=a_tiles, b_tiles=b_tiles,
        a_slot=_reshape(packed["a_slot"]), b_slot=_reshape(packed["b_slot"]),
        c_slot=_reshape(packed["c_slot"]), flags=_reshape(packed["flags"]),
        visit=_reshape(visit), nc_max=nc_max,
        c_rows=c_rows, c_cols=c_cols, c_counts=c_counts,
        part_m=part_m, part_n=part_n, part_k=part_k,
        out_shape=(m, n), semiring=semiring,
        exact_bytes=exact_tiles * tile_bytes,
        padded_bytes=padded_tiles * tile_bytes,
        stats=dict(
            # shared device-engine stats surface (device_common.REQUIRED_STATS)
            comm_bytes_planned=exact_tiles * tile_bytes,
            comm_bytes_padded=padded_tiles * tile_bytes,
            messages=int(messages),
            dense_flops=2 * nprod_total * bs ** 3,
            plan_seconds=plan_seconds,
            # SUMMA gathers the whole process-row/column working set up
            # front and runs one schedule pass: no chunking, no overlap,
            # and the per-device payload peak is the full gathered stack
            peak_payload_tiles=int((grid - 1) * (max_na + max_nb)
                                   + max_na + max_nb),
            chunks=1,
            overlap_fraction=0.0,
            # SUMMA-specific detail
            na_max=na_max, nb_max=nb_max, nprod_max=int(nprod_max),
            nprod_total=int(nprod_total), nc_max=int(nc_max),
            exact_tiles=exact_tiles, padded_tiles=int(padded_tiles),
            merge_tiles=merge_exact,
            comm_bytes_model=int(model_per_proc.sum()),
            comm_bytes_model_per_device=model_per_proc.reshape(-1),
        ),
    )


def repack_summa_payloads(plan: SummaDevicePlan,
                          a: Optional[CSC] = None,
                          b: Optional[CSC] = None
                          ) -> Tuple[Optional[np.ndarray],
                                     Optional[np.ndarray]]:
    """Fresh payload stacks for *structure-identical* operands.

    The SUMMA analogue of ``spgemm_1d_device.repack_ring_payloads``:
    re-blockize the changed side(s) on the plan's tile-snapped partitions
    and refill the static stacks (``None`` operand → ``None`` stack, so an
    unchanged operand is never re-blockized), leaving schedules / visit
    masks / decode coordinates untouched so the built executable can be
    reused as it is (``core.session``'s values-only cache-hit path). The
    stacks come back in the plan's (grid, grid, layers, n, bs, bs) layout;
    the executable's flat stack is the same memory order.
    """
    dtype = plan.a_tiles.dtype
    a_tiles = b_tiles = None
    if a is not None:
        a_blk, _ = _blockize_mesh_a(a, plan.grid, plan.layers, plan.bs,
                                    dtype, plan.semiring, plan.part_m,
                                    plan.part_k)
        a_tiles = _pack_side(a_blk, plan.grid, plan.layers,
                             plan.a_tiles.shape[3], plan.bs, dtype,
                             plan.semiring)
    if b is not None:
        b_blk, _ = _blockize_mesh_b(b, plan.grid, plan.layers, plan.bs,
                                    dtype, plan.semiring, plan.part_n,
                                    plan.part_k)
        b_tiles = _pack_side(b_blk, plan.grid, plan.layers,
                             plan.b_tiles.shape[3], plan.bs, dtype,
                             plan.semiring)
    return a_tiles, b_tiles


def global_slots(plan: SummaDevicePlan) -> Tuple[np.ndarray, np.ndarray]:
    """Each part's schedule slots remapped into the flat payload stacks.

    Returns ``(a_glob, b_glob)``, each ``(grid*grid*layers, nprod_max)``
    int32 in flat part order. Part (r, c, l)'s A slot ``s*max_na + i`` (stage
    s's block, the reference's ``all_gather`` over the grid-column axis)
    addresses tile i of owner (r, s, l)'s stack, at global slot
    ``((r*grid + s)*layers + l)*max_na + i`` of
    ``a_tiles.reshape(-1, bs, bs)``; B slot ``s*max_nb + i`` addresses owner
    (s, c, l)'s, at ``((s*grid + c)*layers + l)*max_nb + i``.
    """
    g, L = plan.grid, plan.layers
    na, nb = plan.a_tiles.shape[3], plan.b_tiles.shape[3]
    if g * g * L * max(na, nb) >= 2 ** 31:
        raise ValueError("payload stacks too large for int32 slots")
    r, c, l = (x[..., None] for x in np.meshgrid(
        np.arange(g), np.arange(g), np.arange(L), indexing="ij"))
    a = plan.a_slot.astype(np.int64)
    b = plan.b_slot.astype(np.int64)
    a_glob = ((r * g + a // na) * L + l) * na + a % na
    b_glob = ((b // nb * g + c) * L + l) * nb + b % nb
    shape = (g * g * L, -1)
    return (a_glob.astype(np.int32).reshape(shape),
            b_glob.astype(np.int32).reshape(shape))


def _make_body(plan: SummaDevicePlan, device: torch.device, engine: str,
               trace_probe: Optional[Callable] = None):
    """Build the SUMMA body: the plan's run boundaries on the device plus
    the closure that runs every part. Built once per plan — ``trace_probe``
    fires here, so the session counts builds, and a cache hit shows
    none."""
    if trace_probe is not None:
        trace_probe()
    g2, L = plan.grid * plan.grid, plan.layers
    bs, nc_max = plan.bs, plan.nc_max
    nprod = int(plan.a_slot.shape[-1])
    semiring = plan.semiring
    flags = plan.flags.reshape(g2 * L, nprod)
    c_slot = plan.c_slot.reshape(g2 * L, nprod)
    starts = [torch.from_numpy(window_run_starts(
        flags[d], c_slot[d], nc_max, 0, nprod)).to(device)
        for d in range(g2 * L)]

    def body(a_flat, b_flat, a_glob, b_glob, c_slot):
        out = torch.empty((g2, nc_max + 1, bs, bs), dtype=torch.float32,
                          device=device)
        # the layer merge's two live partials: the running merge and the
        # next layer's
        pair = (torch.empty((2, nc_max + 1, bs, bs), dtype=torch.float32,
                            device=device) if L > 1 else None)

        def compute(d, dst):
            run_schedule(a_flat, b_flat, a_glob[d], b_glob[d], c_slot[d],
                         starts[d], engine=engine, nprod_max=nprod,
                         nc_max=nc_max, bs=bs, semiring=semiring, out=dst)

        for rc in range(g2):
            if L == 1:
                compute(rc, out[rc])
                continue
            compute(rc * L, pair[0])
            for l in range(1, L):
                compute(rc * L + l, pair[1])
                if l + 1 < L:
                    pair[0].copy_(semiring.axis_reduce(pair, 0))
                else:
                    semiring.axis_reduce(pair, 0, out=out[rc])
        return out[:, :nc_max]

    return body


def compile_summa(plan: SummaDevicePlan, device="cuda", engine: str = "auto",
                  semiring: Optional[Semiring] = None,
                  trace_probe: Optional[Callable] = None):
    """Upload the plan and build the SUMMA body; returns ``(fn, args)``.

    ``fn(*args)`` yields the raw ``(grid*grid, nc_max, bs, bs)`` merged
    output blocks on the device, (r, c) at ``r*grid + c``. ``args`` are the
    flat payload stacks and the remapped schedule (``[a_tiles, b_tiles,
    a_glob, b_glob, c_slot]``, :func:`global_slots`); a values-only repack
    swaps ``args[0]`` / ``args[1]`` (reshaped flat) and reuses ``fn``.
    """
    dev = resolve_device(device)
    engine = resolve_engine(engine, dev)
    check_plan_semiring(plan.semiring, semiring)
    bs = plan.bs
    a_glob, b_glob = global_slots(plan)
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    args = [put(plan.a_tiles).reshape(-1, bs, bs),
            put(plan.b_tiles).reshape(-1, bs, bs), put(a_glob), put(b_glob),
            put(plan.c_slot.reshape(a_glob.shape))]
    return _make_body(plan, dev, engine, trace_probe), args


def decode_summa_output(plan: SummaDevicePlan, out) -> CSC:
    """Decode the raw ``(grid*grid, nc_max, bs, bs)`` output to a global
    CSC (output tile coordinates are already global, and blocks are
    disjoint across the (r, c) mesh by the tile-aligned partitions)."""
    return decode_tiles(out, plan.c_rows, plan.c_cols, plan.c_counts,
                        plan.semiring, plan.out_shape)


def run_device_summa(plan: SummaDevicePlan, device="cuda",
                     engine: str = "auto",
                     semiring: Optional[Semiring] = None) -> CSC:
    """Execute the plan's parts on ``device`` and decode C."""
    fn, args = compile_summa(plan, device, engine, semiring)
    return decode_summa_output(plan, fn(*args))
