"""Symbolic/planning phase of the sparsity-aware 1D SpGEMM (Algorithms 1-2).

The port's copy of the 1D part of ``repro.core.plan``: from sparsity
*metadata* only (no numerics) it derives which columns of A each process
must fetch, groups them into block-fetch messages (Algorithm 2), and
accounts communication exactly. The host oracle ``spgemm_1d`` executes
against this plan, and the device ring's ``bs=1`` plan is held against it.

Bytes accounting follows the paper's implementation: 64-bit row indices +
double-precision values, 16 bytes per nonzero.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .sparse import CSC

__all__ = [
    "BYTES_PER_NNZ",
    "Partition1D",
    "PairFetch",
    "FetchPlan",
    "build_fetch_plan",
    "block_fetch_groups",
]

BYTES_PER_NNZ = 16  # int64 row id + float64 value, as in the paper's impl


# ---------------------------------------------------------------------------
# 1D column partitions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Partition1D:
    """1D column partition: part i owns columns [splits[i], splits[i+1])."""

    splits: np.ndarray  # (P+1,) int64, monotone, splits[0]=0, splits[-1]=ncols

    @property
    def nparts(self) -> int:
        return len(self.splits) - 1

    @property
    def ncols(self) -> int:
        return int(self.splits[-1])

    def owner_of(self, col_ids: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.splits, col_ids, side="right") - 1

    def part_slice(self, i: int) -> Tuple[int, int]:
        return int(self.splits[i]), int(self.splits[i + 1])

    def widths(self) -> np.ndarray:
        return np.diff(self.splits)

    @staticmethod
    def balanced(ncols: int, nparts: int) -> "Partition1D":
        """Equal column counts (the default CombBLAS-style split)."""
        splits = np.linspace(0, ncols, nparts + 1).astype(np.int64)
        return Partition1D(splits)


# ---------------------------------------------------------------------------
# Algorithm 2 — block fetch
# ---------------------------------------------------------------------------

def block_fetch_groups(nz_cols: np.ndarray, hit: np.ndarray,
                       nblocks: int) -> Tuple[np.ndarray, int]:
    """Algorithm 2 on one remote peer.

    nz_cols : (nzc,) global ids of the peer's nonzero columns (ordered) — D.
    hit     : (nzc,) bool — H alignment: hit[t] ⇔ column nz_cols[t] is needed.
    nblocks : K, the non-zero column split number.

    Returns (fetched_mask over nz_cols, n_messages). A group is fetched iff
    it contains ≥1 hit column; messages = number of fetched groups ≤ K.
    """
    nzc = len(nz_cols)
    if nzc == 0:
        return np.zeros(0, dtype=bool), 0
    k = min(nblocks, nzc)
    # split the ordered nonzero column ids into k (near-)equal groups
    bounds = np.linspace(0, nzc, k + 1).astype(np.int64)
    group_of = np.searchsorted(bounds, np.arange(nzc), side="right") - 1
    group_hit = np.zeros(k, dtype=bool)
    np.logical_or.at(group_hit, group_of, hit)
    fetched = group_hit[group_of]
    return fetched, int(group_hit.sum())


# ---------------------------------------------------------------------------
# Algorithm 1 symbolic phase — full fetch plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PairFetch:
    """What process ``dst`` fetches from process ``src``."""

    dst: int
    src: int
    required_cols: np.ndarray   # global col ids strictly needed (H ∩ D)
    fetched_cols: np.ndarray    # superset after block grouping
    required_bytes: int
    fetched_bytes: int
    n_messages: int


@dataclasses.dataclass
class FetchPlan:
    """Complete symbolic plan for one distributed 1D SpGEMM call."""

    part_k: Partition1D          # partition of A's columns / B's rows
    part_n: Partition1D          # partition of B/C's columns
    pairs: List[PairFetch]       # all (dst, src) with src != dst
    local_required: List[np.ndarray]  # per process: local cols it multiplies
    a_nnz_bytes: int             # total bytes of A (for CV/memA)
    nblocks: int

    # ---- aggregate statistics -------------------------------------------
    def per_process_fetched_bytes(self) -> np.ndarray:
        out = np.zeros(self.part_n.nparts, dtype=np.int64)
        for p in self.pairs:
            out[p.dst] += p.fetched_bytes
        return out

    def per_process_required_bytes(self) -> np.ndarray:
        out = np.zeros(self.part_n.nparts, dtype=np.int64)
        for p in self.pairs:
            out[p.dst] += p.required_bytes
        return out

    def per_process_messages(self) -> np.ndarray:
        out = np.zeros(self.part_n.nparts, dtype=np.int64)
        for p in self.pairs:
            out[p.dst] += p.n_messages
        return out

    @property
    def total_fetched_bytes(self) -> int:
        return int(sum(p.fetched_bytes for p in self.pairs))

    @property
    def total_required_bytes(self) -> int:
        return int(sum(p.required_bytes for p in self.pairs))

    @property
    def total_messages(self) -> int:
        return int(sum(p.n_messages for p in self.pairs))

    @property
    def cv_over_mema(self) -> float:
        """Paper §V.A criterion: planned comm volume / size of full A."""
        if self.a_nnz_bytes == 0:
            return 0.0
        return self.total_fetched_bytes / self.a_nnz_bytes


def build_fetch_plan(a: CSC, b: CSC, part_k: Partition1D,
                     part_n: Partition1D, nblocks: int = 2048) -> FetchPlan:
    """Run the symbolic phase of Algorithm 1 for C = A·B.

    a : m×k, 1D column-partitioned by ``part_k``
    b : k×n, 1D column-partitioned by ``part_n``

    Mirrors the MPI implementation: an allgather publishes every A_j's
    nonzero-column ids and per-column nnz (vector D + prefix sums); each
    process intersects with its hit vector H_i (nonzero rows of B_i) and
    groups fetches with Algorithm 2.
    """
    assert a.ncols == b.nrows
    P = part_n.nparts
    assert part_k.nparts == P

    col_nnz = a.col_nnz  # replicated metadata (the allgather of step 2)
    pairs: List[PairFetch] = []
    local_required: List[np.ndarray] = []

    # per-owner nonzero column lists of A (global ids) — vector D, split
    owner_nz_cols = []
    for j in range(P):
        lo, hi = part_k.part_slice(j)
        nz_local = np.nonzero(col_nnz[lo:hi])[0] + lo
        owner_nz_cols.append(nz_local)

    for i in range(P):
        nlo, nhi = part_n.part_slice(i)
        b_i = b.col_slice(nlo, nhi)
        hit_rows = b_i.nonzero_rows()          # H_i over the k dimension
        for j in range(P):
            nz = owner_nz_cols[j]
            hit = hit_rows[nz]
            if j == i:
                local_required.append(nz[hit])
                continue
            fetched_mask, n_msg = block_fetch_groups(nz, hit, nblocks)
            req = nz[hit]
            fet = nz[fetched_mask]
            pairs.append(PairFetch(
                dst=i, src=j,
                required_cols=req,
                fetched_cols=fet,
                required_bytes=int(col_nnz[req].sum()) * BYTES_PER_NNZ,
                fetched_bytes=int(col_nnz[fet].sum()) * BYTES_PER_NNZ,
                n_messages=n_msg,
            ))

    return FetchPlan(
        part_k=part_k, part_n=part_n, pairs=pairs,
        local_required=local_required,
        a_nnz_bytes=a.nnz * BYTES_PER_NNZ,
        nblocks=nblocks,
    )
