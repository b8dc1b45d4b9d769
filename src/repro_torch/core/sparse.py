"""Element-level sparse matrix substrate (host side, numpy).

The port's own copy of ``repro.core.sparse``: a CSC with an explicit
nonzero-column view (the DCSC ``JC`` array), the COO and dense
constructors, the structure-matched generators of the paper's input
families, the AMG restriction operator and the permutation helpers.
Everything here is numpy; on the same seed the generators give
array-equal output to the reference's. Device execution lives in the
``spgemm_*_device.py`` engines.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = [
    "CSC",
    "from_coo",
    "from_dense",
    "identity",
    "erdos_renyi",
    "banded_clustered",
    "laplacian_2d",
    "rmat",
    "block_diagonal_noise",
    "restriction_operator",
    "symmetrize",
    "permute_symmetric",
    "permute_cols",
    "permute_rows",
    "hstack_partitions",
]


@dataclasses.dataclass
class CSC:
    """Compressed sparse column matrix with a DCSC-style nonzero-column view.

    indptr  : (ncols+1,) int64 — column pointers
    indices : (nnz,)     int64 — row ids, sorted within each column
    data    : (nnz,)     dtype — numeric values
    shape   : (nrows, ncols)
    """

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: Tuple[int, int]

    # ---- basic properties -------------------------------------------------
    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def col_nnz(self) -> np.ndarray:
        """nnz per column, (ncols,)."""
        return np.diff(self.indptr)

    @property
    def nzc_ids(self) -> np.ndarray:
        """DCSC ``JC``: ids of columns with at least one nonzero."""
        return np.nonzero(self.col_nnz)[0]

    @property
    def nzc(self) -> int:
        """Number of nonzero columns (paper's ``nzc(A)``)."""
        return int(self.nzc_ids.shape[0])

    def nonzero_rows(self) -> np.ndarray:
        """Boolean hit vector over rows (paper's H for this submatrix)."""
        out = np.zeros(self.nrows, dtype=bool)
        out[self.indices] = True
        return out

    # ---- conversions ------------------------------------------------------
    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        cols = np.repeat(np.arange(self.ncols), self.col_nnz)
        out[self.indices, cols] = self.data
        return out

    def to_coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        cols = np.repeat(np.arange(self.ncols, dtype=np.int64), self.col_nnz)
        return self.indices.copy(), cols, self.data.copy()

    def transpose(self) -> "CSC":
        """CSC of A^T (== CSR view of A), via stable counting sort on rows."""
        rows, cols, vals = self.to_coo()
        order = np.argsort(rows, kind="stable")
        new_indptr = np.zeros(self.nrows + 1, dtype=np.int64)
        np.add.at(new_indptr, rows + 1, 1)
        np.cumsum(new_indptr, out=new_indptr)
        return CSC(new_indptr, cols[order], vals[order],
                   (self.ncols, self.nrows))

    # ---- slicing ----------------------------------------------------------
    def col_slice(self, lo: int, hi: int) -> "CSC":
        """Columns [lo, hi) as a new CSC (same row space)."""
        start, stop = self.indptr[lo], self.indptr[hi]
        return CSC(self.indptr[lo:hi + 1] - start,
                   self.indices[start:stop].copy(),
                   self.data[start:stop].copy(),
                   (self.nrows, hi - lo))

    def select_cols(self, col_ids: np.ndarray) -> "CSC":
        """Gather arbitrary columns (keeps width = len(col_ids))."""
        col_ids = np.asarray(col_ids, dtype=np.int64)
        lens = self.col_nnz[col_ids]
        starts = self.indptr[col_ids]
        idx = _segment_indices(starts, lens)
        indptr = np.zeros(len(col_ids) + 1, dtype=np.int64)
        np.cumsum(lens, out=indptr[1:])
        return CSC(indptr, self.indices[idx], self.data[idx],
                   (self.nrows, len(col_ids)))

    def scatter_cols_into(self, col_ids: np.ndarray, ncols: int) -> "CSC":
        """Inverse of select_cols: place our columns at global ids col_ids."""
        indptr = np.zeros(ncols + 1, dtype=np.int64)
        indptr[np.asarray(col_ids, dtype=np.int64) + 1] = self.col_nnz
        np.cumsum(indptr, out=indptr)
        return CSC(indptr, self.indices.copy(), self.data.copy(),
                   (self.nrows, ncols))

    # ---- elementwise ------------------------------------------------------
    def astype(self, dtype) -> "CSC":
        return CSC(self.indptr.copy(), self.indices.copy(),
                   self.data.astype(dtype), self.shape)

    def prune(self, tol: float = 0.0) -> "CSC":
        """Drop stored entries with |v| <= tol (explicit zeros by default)."""
        keep = np.abs(self.data) > tol
        rows, cols, vals = self.to_coo()
        return from_coo(rows[keep], cols[keep], vals[keep], self.shape)

    def allclose(self, other: "CSC", rtol: float = 1e-6,
                 atol: float = 1e-8) -> bool:
        if self.shape != other.shape:
            return False
        return np.allclose(self.to_dense(), other.to_dense(),
                           rtol=rtol, atol=atol)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"CSC(shape={self.shape}, nnz={self.nnz}, "
                f"nzc={self.nzc}, dtype={self.data.dtype})")


# ---------------------------------------------------------------------------
# segment gather helper (the vectorized "take_segments" trick)
# ---------------------------------------------------------------------------

def _segment_indices(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat indices covering [starts[i], starts[i]+lens[i]) for all i."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    seg_ends = np.cumsum(lens)
    seg_starts = seg_ends - lens
    offs = np.arange(total, dtype=np.int64) - np.repeat(seg_starts, lens)
    return np.repeat(starts, lens) + offs


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def from_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
             shape: Tuple[int, int], dedupe: str = "sum") -> CSC:
    """Build CSC from COO triples; duplicate (r, c) entries are combined."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    m, n = shape
    if rows.size:
        key = cols * m + rows
        order = np.argsort(key, kind="stable")
        key, rows, vals = key[order], rows[order], vals[order]
        uniq_mask = np.empty(key.shape, dtype=bool)
        uniq_mask[0] = True
        np.not_equal(key[1:], key[:-1], out=uniq_mask[1:])
        uniq_pos = np.nonzero(uniq_mask)[0]
        if dedupe == "sum":
            vals = np.add.reduceat(vals, uniq_pos)
        elif dedupe == "max":
            vals = np.maximum.reduceat(vals, uniq_pos)
        elif dedupe == "first":
            vals = vals[uniq_pos]
        else:  # pragma: no cover
            raise ValueError(f"unknown dedupe {dedupe!r}")
        rows = rows[uniq_pos]
        key = key[uniq_pos]
        cols = key // m
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, cols + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSC(indptr, rows, vals, shape)


def from_dense(a: np.ndarray, tol: float = 0.0) -> CSC:
    rows, cols = np.nonzero(np.abs(a) > tol)
    return from_coo(rows, cols, a[rows, cols], a.shape)


def identity(n: int, dtype=np.float64) -> CSC:
    idx = np.arange(n, dtype=np.int64)
    return CSC(np.arange(n + 1, dtype=np.int64), idx,
               np.ones(n, dtype=dtype), (n, n))


# ---------------------------------------------------------------------------
# generators — structure-matched synthetic analogues of the paper's inputs
# ---------------------------------------------------------------------------

def erdos_renyi(m: int, n: int, d: float, seed: int = 0,
                dtype=np.float64) -> CSC:
    """G(m*n, p) with expected d nonzeros per column ("eukarya-like":
    unstructured — the worst case for the 1D algorithm per the paper)."""
    rng = np.random.default_rng(seed)
    nnz = int(d * n)
    rows = rng.integers(0, m, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    vals = rng.standard_normal(nnz).astype(dtype)
    return from_coo(rows, cols, vals, (m, n), dedupe="first")


def banded_clustered(n: int, band: int, d: float, seed: int = 0,
                     dtype=np.float64) -> CSC:
    """Nonzeros clustered near the diagonal ("hv15r-like": strong native
    structure; the 1D algorithm's best case)."""
    rng = np.random.default_rng(seed)
    nnz = int(d * n)
    cols = rng.integers(0, n, size=nnz)
    offs = np.rint(rng.standard_normal(nnz) * (band / 3.0)).astype(np.int64)
    rows = np.clip(cols + offs, 0, n - 1)
    vals = rng.standard_normal(nnz).astype(dtype)
    return from_coo(rows, cols, vals, (n, n), dedupe="first")


def laplacian_2d(side: int, dtype=np.float64) -> CSC:
    """5-point 2D Laplacian ("nlpkkt/queen-like": mesh structure)."""
    n = side * side
    i = np.arange(n, dtype=np.int64)
    x, y = i % side, i // side
    rows = [i]
    cols = [i]
    vals = [np.full(n, 4.0, dtype=dtype)]
    for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        ok = ((x + dx >= 0) & (x + dx < side) &
              (y + dy >= 0) & (y + dy < side))
        j = (x + dx) + (y + dy) * side
        rows.append(i[ok])
        cols.append(j[ok])
        vals.append(np.full(int(ok.sum()), -1.0, dtype=dtype))
    return from_coo(np.concatenate(rows), np.concatenate(cols),
                    np.concatenate(vals), (n, n))


def rmat(scale: int, edge_factor: int = 8, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         dtype=np.float64) -> CSC:
    """R-MAT power-law graph (BC benchmark input family)."""
    n = 1 << scale
    nnz = edge_factor * n
    rng = np.random.default_rng(seed)
    rows = np.zeros(nnz, dtype=np.int64)
    cols = np.zeros(nnz, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(nnz)
        # quadrant probabilities (a | b / c | d)
        go_right = r > (a + c)
        go_down = ((r > a) & (r <= a + c)) | (r > (a + b + c))
        rows |= go_down.astype(np.int64) << bit
        cols |= go_right.astype(np.int64) << bit
    vals = np.ones(nnz, dtype=dtype)
    g = from_coo(rows, cols, vals, (n, n), dedupe="first")
    return symmetrize(g)


def block_diagonal_noise(n: int, nblocks: int, d_in: float, d_out: float,
                         seed: int = 0, dtype=np.float64) -> CSC:
    """Community structure: dense diagonal blocks + sparse off-block noise.

    METIS-partitionable by construction — used to validate that the
    partitioner recovers structure that random permutation destroys.
    """
    rng = np.random.default_rng(seed)
    bsz = n // nblocks
    nnz_in = int(d_in * n)
    cols_in = rng.integers(0, n, size=nnz_in)
    blk = cols_in // bsz
    rows_in = blk * bsz + rng.integers(0, bsz, size=nnz_in)
    nnz_out = int(d_out * n)
    rows_out = rng.integers(0, n, size=nnz_out)
    cols_out = rng.integers(0, n, size=nnz_out)
    rows = np.concatenate([rows_in, rows_out])
    cols = np.concatenate([cols_in, cols_out])
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    return symmetrize(from_coo(rows, cols, vals, (n, n), dedupe="first"))


def restriction_operator(a: CSC, coarsening: int = 100,
                         seed: int = 0) -> CSC:
    """AMG restriction operator R (tall-skinny, one nonzero per row).

    nrows(R) = n_fine, nnz(R) = n_fine. Aggregates are grown greedily from
    seeds over A's graph (a cheap stand-in for MIS-2 aggregation).
    """
    n = a.nrows
    target = max(1, n // coarsening)
    at = a.transpose()
    rng = np.random.default_rng(seed)
    agg = np.full(n, -1, dtype=np.int64)
    seeds = rng.permutation(n)
    n_agg = 0
    # greedy aggregation: unaggregated vertex becomes a seed, grabs its
    # unaggregated neighbors (distance-1 closure of an independent set).
    for v in seeds:
        if agg[v] >= 0:
            continue
        agg[v] = n_agg
        nbrs = at.indices[at.indptr[v]:at.indptr[v + 1]]
        free = nbrs[agg[nbrs] < 0]
        agg[free] = n_agg
        n_agg += 1
    # fold aggregates down to ~target by modular merge (keeps locality)
    if n_agg > target:
        agg = agg % target
        n_agg = target
    rows = np.arange(n, dtype=np.int64)
    return from_coo(rows, agg, np.ones(n), (n, n_agg))


# ---------------------------------------------------------------------------
# permutation helpers
# ---------------------------------------------------------------------------

def symmetrize(a: CSC) -> CSC:
    rows, cols, vals = a.to_coo()
    return from_coo(np.concatenate([rows, cols]),
                    np.concatenate([cols, rows]),
                    np.concatenate([vals, vals]), a.shape, dedupe="max")


def permute_symmetric(a: CSC, perm: np.ndarray) -> CSC:
    """P A P^T — relabel rows and columns by ``perm`` (new_id = perm[old])."""
    rows, cols, vals = a.to_coo()
    return from_coo(perm[rows], perm[cols], vals, a.shape)


def permute_cols(a: CSC, perm: np.ndarray) -> CSC:
    rows, cols, vals = a.to_coo()
    return from_coo(rows, perm[cols], vals, a.shape)


def permute_rows(a: CSC, perm: np.ndarray) -> CSC:
    rows, cols, vals = a.to_coo()
    return from_coo(perm[rows], cols, vals, a.shape)


def hstack_partitions(parts: list) -> CSC:
    """Concatenate column-partitions back into one global CSC."""
    nrows = parts[0].nrows
    indptrs = [parts[0].indptr]
    off = parts[0].indptr[-1]
    for p in parts[1:]:
        assert p.nrows == nrows
        indptrs.append(p.indptr[1:] + off)
        off += p.indptr[-1]
    return CSC(np.concatenate(indptrs),
               np.concatenate([p.indices for p in parts]),
               np.concatenate([p.data for p in parts]),
               (nrows, sum(p.ncols for p in parts)))
