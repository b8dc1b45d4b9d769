"""Outer-product 1D SpGEMM — Algorithm 3 of the paper.

Used for the *right multiplication* of the AMG Galerkin product,
``(R^T A) R``, where Ballard et al. showed the outer-product formulation is
the best 1D algorithm. The three steps, exactly as in the paper:

  1. Redistribute B so that process i owns the i-th **row** block
     (aligned with A's column partition of the shared k dimension).
  2. Each process multiplies its column slice of A with its row slice of B —
     a full-size (m×n) but very sparse partial result.
  3. Redistribute the partial results to C's 1D column partition and merge.

Both the numeric result and exact per-step communication volumes are
produced (step 1 moves nnz(B) minus what is already in place; step 3 moves
every partial-C nonzero that lands on a different owner).

The port's copy of ``repro.core.spgemm_outer``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .local_spgemm import spadd, spgemm
from .plan import BYTES_PER_NNZ, Partition1D
from .semiring import PLUS_TIMES, Semiring
from .sparse import CSC, hstack_partitions

__all__ = ["OuterProductResult", "spgemm_outer_1d"]


@dataclasses.dataclass
class OuterProductResult:
    c_parts: List[CSC]
    redistribute_b_bytes: int     # step 1 traffic
    merge_c_bytes: int            # step 3 traffic
    per_process_flops: np.ndarray

    @property
    def total_bytes(self) -> int:
        return self.redistribute_b_bytes + self.merge_c_bytes

    def concat(self) -> CSC:
        return hstack_partitions(self.c_parts)


def spgemm_outer_1d(a: CSC, b: CSC, nparts: int,
                    part_k: Optional[Partition1D] = None,
                    part_n: Optional[Partition1D] = None,
                    semiring: Semiring = PLUS_TIMES) -> OuterProductResult:
    from .local_spgemm import spgemm_flops

    assert a.ncols == b.nrows
    P = nparts
    if part_k is None:
        part_k = Partition1D.balanced(a.ncols, P)
    if part_n is None:
        part_n = Partition1D.balanced(b.ncols, P)

    # --- step 1: redistribute B to row blocks --------------------------------
    # B starts 1D column-partitioned (part_n). Row block i = rows in
    # part_k slice i. An entry B[r, c] owned by col-owner(c) must move to
    # row-owner(r) unless they coincide.
    rows_b, cols_b, _ = b.to_coo()
    row_owner = part_k.owner_of(rows_b)
    col_owner = part_n.owner_of(cols_b)
    redistribute_b = int((row_owner != col_owner).sum()) * BYTES_PER_NNZ

    bt = b.transpose()  # CSC over B's rows for cheap row-block slicing

    merge_c = 0
    flops = np.zeros(P, dtype=np.int64)
    partials: List[CSC] = []
    for i in range(P):
        klo, khi = part_k.part_slice(i)
        a_i = a.col_slice(klo, khi)                      # m × k_i
        b_rows_i = bt.col_slice(klo, khi).transpose()    # k_i × n
        c_partial = spgemm(a_i, b_rows_i, semiring)      # m × n, sparse
        flops[i] = spgemm_flops(a_i, b_rows_i)
        partials.append(c_partial)
        # step 3 traffic: partial nonzeros whose column owner != i
        if c_partial.nnz:
            _, pc, _ = c_partial.to_coo()
            merge_c += int((part_n.owner_of(pc) != i).sum()) * BYTES_PER_NNZ

    # --- step 3: merge partials into C's column partition --------------------
    c_parts: List[CSC] = []
    for j in range(P):
        nlo, nhi = part_n.part_slice(j)
        acc: Optional[CSC] = None
        for cp in partials:
            piece = cp.col_slice(nlo, nhi)
            acc = piece if acc is None else spadd(acc, piece, semiring)
        c_parts.append(acc)

    return OuterProductResult(
        c_parts=c_parts,
        redistribute_b_bytes=redistribute_b,
        merge_c_bytes=merge_c,
        per_process_flops=flops,
    )
