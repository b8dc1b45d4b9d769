"""Symbolic/planning phase of the sparsity-aware 1D SpGEMM (Algorithms 1-2).

The port's copy of ``repro.core.plan``: from sparsity *metadata* only (no
numerics) it derives which columns of A each process must fetch, groups
them into block-fetch messages (Algorithm 2), and accounts communication
exactly. The host oracle ``spgemm_1d`` executes against this plan, and
the device ring's ``bs=1`` plan is held against it. It also holds the
exact communication volumes of the sparsity-oblivious baselines (2D SUMMA,
Split-3D), which the device SUMMA plan's ``comm_bytes_model`` must equal,
and the alpha-beta time model of the benchmarks.

Bytes accounting follows the paper's implementation: 64-bit row indices +
double-precision values, 16 bytes per nonzero.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .sparse import CSC

__all__ = [
    "BYTES_PER_NNZ",
    "Partition1D",
    "PairFetch",
    "FetchPlan",
    "build_fetch_plan",
    "block_fetch_groups",
    "cv_over_mema",
    "summa2d_comm_volume",
    "summa3d_comm_volume",
    "CommModel",
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

    @staticmethod
    def by_weight(weights: np.ndarray, nparts: int) -> "Partition1D":
        """Contiguous split balancing cumulative weight (paper: weight =
        (column nnz)^2 ~ sparse flops per column in squaring)."""
        cum = np.concatenate([[0], np.cumsum(weights.astype(np.float64))])
        total = cum[-1]
        targets = total * np.arange(1, nparts) / nparts
        cuts = np.searchsorted(cum, targets)
        splits = np.concatenate([[0], cuts, [len(weights)]]).astype(np.int64)
        # enforce monotonicity in degenerate cases (empty weight runs)
        splits = np.maximum.accumulate(splits)
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


def cv_over_mema(a: CSC, b: CSC, nparts: int, nblocks: int = 2048) -> float:
    """Convenience: the paper's partitioning-decision criterion."""
    pk = Partition1D.balanced(a.ncols, nparts)
    pn = Partition1D.balanced(b.ncols, nparts)
    return build_fetch_plan(a, b, pk, pn, nblocks).cv_over_mema


# ---------------------------------------------------------------------------
# sparsity-oblivious baselines — exact per-instance communication volumes
# ---------------------------------------------------------------------------

def _block_nnz(mat: CSC, row_splits: np.ndarray,
               col_splits: np.ndarray) -> np.ndarray:
    """nnz of each (row-block, col-block) tile of ``mat``."""
    rows, cols, _ = mat.to_coo()
    ri = np.searchsorted(row_splits, rows, side="right") - 1
    ci = np.searchsorted(col_splits, cols, side="right") - 1
    nr, nc = len(row_splits) - 1, len(col_splits) - 1
    out = np.zeros((nr, nc), dtype=np.int64)
    np.add.at(out, (ri, ci), 1)
    return out


def summa2d_comm_volume(a: CSC, b: CSC, grid: int,
                        row_splits: Optional[np.ndarray] = None,
                        colk_splits: Optional[np.ndarray] = None,
                        coln_splits: Optional[np.ndarray] = None) -> dict:
    """Exact comm volume of 2D sparse SUMMA on a grid×grid process mesh.

    Every A block is broadcast along its process row (grid-1 receivers);
    every B block along its process column. This is sparsity-*oblivious*:
    volume depends only on block nnz, not on whether the data is used.

    The optional splits override the default balanced block cuts (A rows /
    contraction dim / B cols, each ``(grid+1,)`` monotone) so the model can
    be evaluated on exactly the partition another plan used — e.g. the
    tile-snapped partitions of ``spgemm_2d_device.build_summa_plan``, whose
    ``comm_bytes_model`` stat must agree with this function.
    """
    rs_a = (np.linspace(0, a.nrows, grid + 1).astype(np.int64)
            if row_splits is None else np.asarray(row_splits, np.int64))
    cs_a = (np.linspace(0, a.ncols, grid + 1).astype(np.int64)
            if colk_splits is None else np.asarray(colk_splits, np.int64))
    rs_b = cs_a  # B's rows live on the contraction partition
    cs_b = (np.linspace(0, b.ncols, grid + 1).astype(np.int64)
            if coln_splits is None else np.asarray(coln_splits, np.int64))
    a_blocks = _block_nnz(a, rs_a, cs_a)
    b_blocks = _block_nnz(b, rs_b, cs_b)
    vol_a = int(a_blocks.sum()) * (grid - 1) * BYTES_PER_NNZ
    vol_b = int(b_blocks.sum()) * (grid - 1) * BYTES_PER_NNZ
    # per-process received bytes: all A blocks in my row + B blocks in my col
    per_proc = np.zeros((grid, grid), dtype=np.int64)
    for r in range(grid):
        for c in range(grid):
            recv_a = a_blocks[r, :].sum() - a_blocks[r, c]
            recv_b = b_blocks[:, c].sum() - b_blocks[r, c]
            per_proc[r, c] = (recv_a + recv_b) * BYTES_PER_NNZ
    return {
        "total_bytes": vol_a + vol_b,
        "bytes_a": vol_a,
        "bytes_b": vol_b,
        "per_process_bytes": per_proc.reshape(-1),
        "messages": 2 * grid * (grid - 1) * grid,  # bcast as p2p sends
    }


def summa3d_comm_volume(a: CSC, b: CSC, grid: int, layers: int) -> dict:
    """Exact comm volume of Split-3D-SpGEMM [Azad+ '16] on grid×grid×layers.

    The k dimension is split across layers; each layer runs a 2D SUMMA on
    its k-slice, then partial C results are merged across layers (the
    all-to-all/reduction volume is the nnz of the partial results, computed
    exactly via a symbolic multiply per layer).
    """
    from .local_spgemm import spgemm_structure

    k = a.ncols
    ksplits = np.linspace(0, k, layers + 1).astype(np.int64)
    total_ab = 0
    partial_nnz = []
    for l in range(layers):
        lo, hi = int(ksplits[l]), int(ksplits[l + 1])
        a_l = a.col_slice(lo, hi)
        bt = b.transpose().col_slice(lo, hi)  # rows lo:hi of B
        b_l = bt.transpose()
        v2d = summa2d_comm_volume(a_l, b_l, grid)
        total_ab += v2d["total_bytes"]
        if layers > 1:
            partial_nnz.append(spgemm_structure(a_l, b_l).nnz)
    merge_bytes = 0
    if layers > 1:
        # every layer's partial C moves once during the merge (split+reduce)
        merge_bytes = int(sum(partial_nnz)) * (layers - 1) // layers \
            * BYTES_PER_NNZ
    return {
        "total_bytes": total_ab + merge_bytes,
        "bytes_ab": total_ab,
        "bytes_merge": merge_bytes,
        "messages": 2 * grid * (grid - 1) * grid * layers
        + (layers - 1) * grid * grid,
    }


# ---------------------------------------------------------------------------
# latency/bandwidth time model (for benchmark "modeled time" columns)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CommModel:
    """alpha-beta model. Defaults ~ Slingshot-11 NIC per the paper's system:
    ~25 GB/s injection bandwidth, ~2 microseconds latency."""

    bandwidth: float = 25e9   # bytes/s
    latency: float = 2e-6     # s per message

    def time(self, nbytes: float, nmessages: float) -> float:
        return nbytes / self.bandwidth + nmessages * self.latency

    def pipelined_time(self, nbytes: float, nmessages: float,
                       compute_seconds: float,
                       overlap_fraction: float = 0.0) -> float:
        """Modeled wall time of a double-buffered (fetch/compute pipelined)
        exchange: the overlapped fraction of the communication hides behind
        compute, bounded by whichever of the two phases is shorter.
        ``overlap_fraction=0`` degenerates to serial ``time() + compute``.
        """
        t_comm = self.time(nbytes, nmessages)
        hidden = overlap_fraction * min(t_comm, compute_seconds)
        return t_comm + compute_seconds - hidden
