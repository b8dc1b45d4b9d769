"""Block-sparse tiles — the device payload format (host side, numpy).

The port's copy of ``repro.core.blocksparse``. The matrix is cut into a
``(m/bs) × (n/bs)`` tile grid and only nonempty tiles are materialized as
dense payloads; sparsity-awareness then operates at tile granularity, which
is the paper's block-fetch strategy (Algorithm 2) promoted from a
message-coalescing trick to the storage format itself.

  * :class:`BlockSparse` — host container: dense tile payloads (ntiles, bs,
    bs) + (tile_row, tile_col) coordinates, convertible to/from CSC.
  * :func:`build_schedule` — the *product schedule*: for ``C = A·B`` over
    block-sparse operands, the static list of tile-products
    ``(a_slot, b_slot, c_slot)`` such that ``C[c_slot] += A[a_slot] @
    B[b_slot]``, sorted by output tile so the CUDA kernel gives each run
    of products that share an output tile to one thread block.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from .sparse import CSC, _segment_indices, from_coo

__all__ = [
    "BlockSparse",
    "ProductSchedule",
    "from_csc",
    "build_schedule",
    "flags_from_c_slot",
    "DEFAULT_BLOCK",
]

DEFAULT_BLOCK = 128  # the kernel takes bs in {16, 32, 64, 128}


@dataclasses.dataclass
class BlockSparse:
    """Block-sparse matrix: only nonempty ``bs×bs`` tiles are stored.

    tiles     : (ntiles, bs, bs) dense payloads (f32 by default)
    tile_rows : (ntiles,) tile-grid row of each payload
    tile_cols : (ntiles,) tile-grid col of each payload, sorted (col, row)
    shape     : logical (padded) element shape, multiples of bs
    orig_shape: pre-padding element shape
    fill      : the value absent positions hold — the additive identity of
                the semiring the tiles execute under (0.0 for plus-times /
                bool, +inf for min-plus). Distinguishes "absent entry" from
                "explicitly stored value equal to 0.0".
    """

    tiles: np.ndarray
    tile_rows: np.ndarray
    tile_cols: np.ndarray
    shape: Tuple[int, int]
    orig_shape: Tuple[int, int]
    bs: int
    fill: float = 0.0

    @property
    def ntiles(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.shape[0] // self.bs, self.shape[1] // self.bs)

    @property
    def nbytes_payload(self) -> int:
        return self.tiles.nbytes

    def tile_nnz(self) -> np.ndarray:
        """Stored-element count per tile (for fill diagnostics).

        ``!=`` against an infinite fill is still correct: inf != inf is
        False, so identity-padded positions never count as stored.
        """
        return (self.tiles != self.fill).sum(axis=(1, 2))

    def fill_fraction(self) -> float:
        """nnz / stored payload elements — over-fetch diagnostic."""
        if self.ntiles == 0:
            return 1.0
        return float(self.tile_nnz().sum()) / self.tiles.size

    # ---- conversions ------------------------------------------------------
    def to_dense(self) -> np.ndarray:
        out = np.full(self.shape, self.fill, dtype=self.tiles.dtype)
        bs = self.bs
        for t in range(self.ntiles):
            r, c = self.tile_rows[t] * bs, self.tile_cols[t] * bs
            out[r:r + bs, c:c + bs] = self.tiles[t]
        return out[: self.orig_shape[0], : self.orig_shape[1]]

    def to_csc(self, tol: float = 0.0, semiring=None) -> CSC:
        """Back to CSC, keeping the entries the semiring considers nonzero.

        Entries are pruned relative to the additive identity — ``fill`` by
        default, ``semiring.zero`` when one is passed — *not* relative to a
        literal 0.0: an explicitly stored 0.0 in an identity-filled min-plus
        container (a zero-cost edge) survives the round trip
        ``from_csc(..., fill=sr.zero) → to_csc(semiring=sr)``. ``tol``
        widens the prune band around a *finite* identity only; with an
        infinite identity the kept set is exactly the finite entries and
        ``tol`` has no effect (no finite value is near +inf).
        """
        zero = self.fill if semiring is None else semiring.zero
        d = self.to_dense()
        if np.isinf(zero):
            keep = np.isfinite(d)
        else:
            keep = np.abs(d - zero) > tol
        rows, cols = np.nonzero(keep)
        return from_coo(rows, cols, d[rows, cols], self.orig_shape)

    def col_block_ids(self) -> np.ndarray:
        """Distinct nonempty tile columns (DCSC-style column compression
        lifted to tile granularity)."""
        return np.unique(self.tile_cols)


def from_csc(a: CSC, bs: int = DEFAULT_BLOCK,
             dtype=np.float32, fill: float = 0.0,
             payload: bool = True) -> BlockSparse:
    """Blockize a CSC matrix: nonempty tiles become dense payloads.

    ``fill`` is the additive identity of the executing semiring: positions
    of a stored tile with no stored entry hold ``fill``, so explicit stored
    values equal to 0.0 stay distinguishable from absent entries whenever
    ``fill != 0.0`` (min-plus zero-cost edges).

    ``payload=False`` gives the tile structure only (coordinates and
    count), with 1x1 placeholder payloads: what a rank plans with for the
    parts other ranks hold.
    """
    m, n = a.shape
    gm, gn = math.ceil(max(m, 1) / bs), math.ceil(max(n, 1) / bs)
    rows, cols, vals = a.to_coo()
    tr, tc = rows // bs, cols // bs
    key = tc * gm + tr
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq_mask = np.empty(len(key_s), dtype=bool)
    if len(key_s):
        uniq_mask[0] = True
        np.not_equal(key_s[1:], key_s[:-1], out=uniq_mask[1:])
        uniq_keys = key_s[uniq_mask]
    else:
        uniq_keys = np.zeros(0, dtype=np.int64)
    ntiles = len(uniq_keys)
    if payload:
        tiles = np.full((ntiles, bs, bs), fill, dtype=dtype)
        # uniq_keys is sorted, so every key resolves to its slot in one
        # searchsorted — no per-nonzero Python dict probing
        slot = np.searchsorted(uniq_keys, key) if len(key) \
            else np.zeros(0, dtype=np.int64)
        tiles[slot, rows % bs, cols % bs] = vals.astype(dtype)
    else:
        tiles = np.zeros(  # replint: off=RS003 1x1 placeholder payloads; the structure is read, never the values
            (ntiles, 1, 1), dtype=dtype)
    return BlockSparse(
        tiles=tiles,
        tile_rows=(uniq_keys % gm).astype(np.int32),
        tile_cols=(uniq_keys // gm).astype(np.int32),
        shape=(gm * bs, gn * bs),
        orig_shape=(m, n),
        bs=bs,
        fill=fill,
    )


# ---------------------------------------------------------------------------
# product schedule for C = A @ B over block-sparse operands
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProductSchedule:
    """Static tile-product schedule, sorted by output slot.

    a_slot / b_slot : (nprod,) payload indices into A.tiles / B.tiles
    c_slot          : (nprod,) output payload index; nondecreasing
    c_rows / c_cols : (nc,) tile-grid coordinates of the output payloads
    nprod, nc       : schedule length / number of output tiles
    flops           : dense tile-product flops the schedule will execute
    """

    a_slot: np.ndarray
    b_slot: np.ndarray
    c_slot: np.ndarray
    c_rows: np.ndarray
    c_cols: np.ndarray
    nprod: int
    nc: int
    flops: int

    def flags(self) -> np.ndarray:
        """(nprod,) i32 first/last-visit flag words for the kernel —
        see :func:`flags_from_c_slot`."""
        return flags_from_c_slot(self.c_slot)


def build_schedule(a: BlockSparse, b: BlockSparse) -> ProductSchedule:
    """Symbolic tile-level multiply: match A's tile-cols to B's tile-rows.

    Sorted so every output tile's products are contiguous: one run per
    output tile, accumulated revisit-free by one thread block.
    """
    assert a.shape[1] == b.shape[0], (a.shape, b.shape)
    assert a.bs == b.bs
    gm = a.grid[0]

    # join on the contraction tile index k: A tile (i, k) × B tile (k, j).
    # Fully vectorized cartesian expansion: each A tile (k-sorted) pairs
    # with the contiguous run of B tiles sharing its k — repeat on the A
    # side, one segment gather on the B side. No Python loop over k.
    order_a = np.argsort(a.tile_cols, kind="stable")
    order_b = np.argsort(b.tile_rows, kind="stable")
    ak = a.tile_cols[order_a].astype(np.int64)

    nk = a.grid[1]
    cb = np.bincount(b.tile_rows, minlength=nk).astype(np.int64)
    starts_b = np.concatenate([[0], np.cumsum(cb)])

    nb_per_a = cb[ak]
    a_slot = np.repeat(order_a, nb_per_a)
    b_slot = order_b[_segment_indices(starts_b[ak], nb_per_a)]
    if len(a_slot) == 0:
        z = np.zeros(0, dtype=np.int64)
        return ProductSchedule(z, z, z, z.astype(np.int32),
                               z.astype(np.int32), 0, 0, 0)

    # output tile coordinates and dedup to slots
    oi = a.tile_rows[a_slot].astype(np.int64)
    oj = b.tile_cols[b_slot].astype(np.int64)
    okey = oj * gm + oi
    order = np.argsort(okey, kind="stable")
    a_slot, b_slot, okey = a_slot[order], b_slot[order], okey[order]
    uniq_keys, c_slot = np.unique(okey, return_inverse=True)

    return ProductSchedule(
        a_slot=a_slot.astype(np.int32),
        b_slot=b_slot.astype(np.int32),
        c_slot=c_slot.astype(np.int32),
        c_rows=(uniq_keys % gm).astype(np.int32),
        c_cols=(uniq_keys // gm).astype(np.int32),
        nprod=len(a_slot),
        nc=len(uniq_keys),
        flops=2 * len(a_slot) * a.bs ** 3,
    )


def flags_from_c_slot(c_slot: np.ndarray) -> np.ndarray:
    """Pack first/last-visit booleans into the kernel's i32 flag word.

    ``c_slot`` is any ``(..., nprod)`` nondecreasing output-slot array —
    a ProductSchedule's, or the padded per-device stack of the ring plan
    (whose pad entries all map to one trailing garbage slot, so they form
    a well-flagged segment of their own). Bit 0: first visit of the slot
    (accumulator reset); bit 1: last visit (flush).
    """
    c = np.asarray(c_slot)
    first = np.ones(c.shape, dtype=bool)
    last = np.ones(c.shape, dtype=bool)
    if c.shape[-1]:
        change = c[..., 1:] != c[..., :-1]
        first[..., 1:] = change
        last[..., :-1] = change
    return first.astype(np.int32) | (last.astype(np.int32) << 1)
