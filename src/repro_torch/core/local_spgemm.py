"""Local (single-process) SpGEMM over a semiring — the numpy oracle.

The port's copy of ``repro.core.local_spgemm`` (``spgemm``, ``spgemm_flops``).

The paper uses a hybrid heap/hash SpGEMM [Azad+'16, Nagasaka+'19] for the
local multiply. Scalar probing does not vectorize in numpy, so we use the
fully-vectorized *expand / sort / segment-reduce* formulation of Gustavson's
algorithm: every nontrivial scalar product a_ik * b_kj is materialized, then
combined by a stable sort on the (j, i) key and one ``reduceat``. The flop
count it performs is exactly the paper's "sparse flops" (inner product of
A's column-nnz and B's row-nnz counts), which we also expose for planning.
"""

from __future__ import annotations

import numpy as np

from .semiring import PLUS_TIMES, Semiring
from .sparse import CSC, _segment_indices

__all__ = ["spgemm", "spgemm_flops"]


def spgemm_flops(a: CSC, b: CSC) -> int:
    """Exact nontrivial-multiply count: sum_k colnnz(A,k) * rownnz(B,k).

    With B in CSC, rownnz(B, k) is over B's *rows*, i.e. B.indices. The
    outer-product view [paper §III.B; Buluc & Gilbert Th. 13.1] counts
    flops = <colnnz(A), rownnz(B)>.
    """
    a_col = a.col_nnz  # (k,)
    counts = np.zeros(b.nrows, dtype=np.int64)
    np.add.at(counts, b.indices, 1)
    return int(np.dot(a_col, counts))


def spgemm(a: CSC, b: CSC, semiring: Semiring = PLUS_TIMES,
           prune: bool = True) -> CSC:
    """C = A ⊗ B over ``semiring``; column-by-column (Gustavson) expand."""
    assert a.ncols == b.nrows, (a.shape, b.shape)
    m, n = a.nrows, b.ncols

    # nonzeros of B drive the expansion: entry (k, j, vB) pulls column k of A.
    ks = b.indices                                     # (nnzB,)
    js = np.repeat(np.arange(n, dtype=np.int64), b.col_nnz)
    lens = a.col_nnz[ks]                               # contributions per (k,j)
    total = int(lens.sum())
    if total == 0:
        return CSC(np.zeros(n + 1, dtype=np.int64),
                   np.zeros(0, dtype=np.int64),
                   np.zeros(0, dtype=a.data.dtype), (m, n))

    flat = _segment_indices(a.indptr[ks], lens)        # indices into A arrays
    rows = a.indices[flat]
    vals = semiring.mul(a.data[flat], np.repeat(b.data, lens))
    cols = np.repeat(js, lens)

    key = cols * m + rows
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    uniq = np.empty(key.shape, dtype=bool)
    uniq[0] = True
    np.not_equal(key[1:], key[:-1], out=uniq[1:])
    pos = np.nonzero(uniq)[0]
    red = semiring.add_reduceat(vals, pos)
    key = key[pos]
    rows_out = key % m
    cols_out = key // m
    if prune:
        keep = semiring.prune_mask(red)
        rows_out, cols_out, red = rows_out[keep], cols_out[keep], red[keep]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, cols_out + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSC(indptr, rows_out, red, (m, n))
