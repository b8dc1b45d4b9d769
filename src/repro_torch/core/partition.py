"""Permutation & graph-partitioning preprocessing (paper §II.B / §III.B).

Three strategies, exactly the paper's menu:

  * ``random_permutation``  — the 2D/3D load-balancing default; *harmful*
    for the 1D algorithm because it destroys nonzero clustering.
  * native ordering         — no-op; best when the matrix is structured.
  * ``multilevel_partition``— METIS-style multilevel k-way partitioner
    (heavy-edge-matching coarsening → greedy region growing → boundary
    refinement) with the paper's vertex weights: (column nnz)², the
    sparse-flops estimate for squaring.

The partitioner is pure numpy (METIS is not available offline); it targets
the same objective — balanced vertex weight, minimized edge cut — and the
benchmarks validate the paper's *qualitative* claim: on unstructured inputs
it recovers clustering that slashes the 1D algorithm's communication.

The port's copy of ``repro.core.partition``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .sparse import CSC, from_coo, symmetrize

__all__ = [
    "random_permutation",
    "degree_squared_weights",
    "multilevel_partition",
    "partition_to_permutation",
    "PartitionReport",
    "edge_cut",
]


def random_permutation(n: int, seed: int = 0) -> np.ndarray:
    """Symmetric random relabeling: new_id = perm[old_id]."""
    rng = np.random.default_rng(seed)
    return rng.permutation(n).astype(np.int64)


def degree_squared_weights(a: CSC) -> np.ndarray:
    """Paper's vertex weight: square of the column nnz (≈ sparse flops the
    column contributes to the squaring)."""
    d = a.col_nnz.astype(np.float64)
    return d * d


def edge_cut(a: CSC, parts: np.ndarray) -> int:
    """Number of nonzeros whose endpoints land in different parts."""
    rows, cols, _ = a.to_coo()
    return int((parts[rows] != parts[cols]).sum())


@dataclasses.dataclass
class PartitionReport:
    parts: np.ndarray          # (n,) part id per vertex
    nparts: int
    cut: int                   # edge cut on the input graph
    weight_imbalance: float    # max part weight / mean part weight
    levels: int                # coarsening levels used


# ---------------------------------------------------------------------------
# multilevel k-way partitioner
# ---------------------------------------------------------------------------

def _heavy_edge_matching(adj: CSC, rng: np.random.Generator) -> np.ndarray:
    """Mutual-heaviest-neighbor matching, fully vectorized.

    Returns ``mate`` (n,) with mate[v] = matched partner or v itself.
    """
    n = adj.ncols
    mate = np.arange(n, dtype=np.int64)
    if adj.nnz == 0:
        return mate
    rows, cols, vals = adj.to_coo()
    off = rows != cols
    rows, cols, vals = rows[off], cols[off], np.abs(vals[off])
    if rows.size == 0:
        return mate
    # random tiebreak so uniform-weight graphs still match densely
    vals = vals * (1.0 + 0.01 * rng.random(vals.shape))
    # heaviest neighbor per column: sort by (col, weight) and take last
    order = np.lexsort((vals, cols))
    rows_s, cols_s = rows[order], cols[order]
    last = np.empty(len(cols_s), dtype=bool)
    last[-1] = True
    np.not_equal(cols_s[1:], cols_s[:-1], out=last[:-1])
    heaviest = np.full(n, -1, dtype=np.int64)
    heaviest[cols_s[last]] = rows_s[last]
    # mutual pairs: heaviest[heaviest[v]] == v
    v = np.arange(n)
    h = heaviest
    ok = (h >= 0)
    mutual = ok & (h[np.where(ok, h, 0)] == v) & (v < np.where(ok, h, n))
    mate[v[mutual]] = h[mutual]
    mate[h[mutual]] = v[mutual]
    return mate


def _coarsen(adj: CSC, weights: np.ndarray,
             rng: np.random.Generator) -> Tuple[CSC, np.ndarray, np.ndarray]:
    """One coarsening level. Returns (coarse_adj, coarse_weights, cmap)."""
    mate = _heavy_edge_matching(adj, rng)
    n = adj.ncols
    rep = np.minimum(np.arange(n), mate)        # representative per pair
    uniq, cmap = np.unique(rep, return_inverse=True)
    nc = len(uniq)
    cw = np.zeros(nc)
    np.add.at(cw, cmap, weights)
    rows, cols, vals = adj.to_coo()
    cadj = from_coo(cmap[rows], cmap[cols], vals, (nc, nc), dedupe="sum")
    return cadj, cw, cmap


def _greedy_grow(adj: CSC, weights: np.ndarray, nparts: int,
                 rng: np.random.Generator) -> np.ndarray:
    """Initial partition on the coarsest graph: BFS region growing, picking
    the next frontier vertex that maximizes internal connectivity, bounded
    by the per-part weight budget."""
    n = adj.ncols
    parts = np.full(n, -1, dtype=np.int64)
    total_w = weights.sum()
    budget = total_w / nparts * 1.05
    at = adj  # symmetric assumed
    order = rng.permutation(n)
    ptr = 0
    for p in range(nparts):
        # seed: first unassigned vertex
        while ptr < n and parts[order[ptr]] >= 0:
            ptr += 1
        if ptr >= n:
            break
        seed = order[ptr]
        parts[seed] = p
        w = weights[seed]
        frontier = list(at.indices[at.indptr[seed]:at.indptr[seed + 1]])
        head = 0
        while w < budget and head < len(frontier):
            v = frontier[head]          # BFS: pop from the front
            head += 1
            if parts[v] >= 0:
                continue
            parts[v] = p
            w += weights[v]
            frontier.extend(
                at.indices[at.indptr[v]:at.indptr[v + 1]].tolist())
    # leftovers: assign to the lightest part
    part_w = np.zeros(nparts)
    np.add.at(part_w, parts[parts >= 0], weights[parts >= 0])
    for v in np.nonzero(parts < 0)[0]:
        p = int(np.argmin(part_w))
        parts[v] = p
        part_w[p] += weights[v]
    return parts


def _refine(adj: CSC, weights: np.ndarray, parts: np.ndarray, nparts: int,
            passes: int = 4, tol: float = 1.10) -> np.ndarray:
    """Greedy boundary refinement (KL/FM-flavored, move-based).

    Each pass: for boundary vertices compute the gain of moving to the
    best-connected neighboring part; apply positive-gain moves that keep
    the balance within ``tol``.
    """
    n = adj.ncols
    rows, cols, vals = adj.to_coo()
    off = rows != cols
    rows, cols, vals = rows[off], cols[off], np.abs(vals[off])
    total_w = weights.sum()
    cap = total_w / nparts * tol
    part_w = np.zeros(nparts)
    np.add.at(part_w, parts, weights)

    for _ in range(passes):
        pr, pc = parts[rows], parts[cols]
        # connectivity of each (vertex, part) along edges: for each column
        # vertex c, sum of edge weights into part pr
        key = cols * nparts + pr
        conn = np.zeros(n * nparts)
        np.add.at(conn, key, vals)
        conn = conn.reshape(n, nparts)
        internal = conn[np.arange(n), parts]
        best_part = np.argmax(conn, axis=1)
        best_conn = conn[np.arange(n), best_part]
        gain = best_conn - internal
        cand = np.nonzero((gain > 0) & (best_part != parts))[0]
        if len(cand) == 0:
            break
        cand = cand[np.argsort(-gain[cand])]
        moved = 0
        for v in cand:
            tgt = int(best_part[v])
            if part_w[tgt] + weights[v] > cap:
                continue
            part_w[parts[v]] -= weights[v]
            part_w[tgt] += weights[v]
            parts[v] = tgt
            moved += 1
        if moved == 0:
            break
    return parts


def multilevel_partition(a: CSC, nparts: int,
                         weights: Optional[np.ndarray] = None,
                         coarsen_to: Optional[int] = None,
                         seed: int = 0) -> PartitionReport:
    """METIS-style multilevel k-way partition of (the graph of) ``a``.

    ``a`` is symmetrized if needed (METIS requires undirected graphs — the
    paper symmetrizes too). Default weights are the paper's (col nnz)².
    """
    rng = np.random.default_rng(seed)
    adj = symmetrize(a)
    # structural view: edge weight 1 per nonzero, so that coarse-level edge
    # weights become fine-edge multiplicities (numeric values could cancel)
    adj = CSC(adj.indptr, adj.indices,
              np.ones(adj.nnz, dtype=np.float64), adj.shape)
    if weights is None:
        weights = degree_squared_weights(a)
    weights = weights.astype(np.float64) + 1e-9

    # --- coarsening phase ---------------------------------------------------
    graphs = [(adj, weights)]
    cmaps = []
    levels = 0
    # METIS-style: coarsen down to ~30 vertices per part
    target = coarsen_to if coarsen_to is not None else max(nparts * 30, 128)
    while graphs[-1][0].ncols > target and levels < 30:
        cadj, cw, cmap = _coarsen(graphs[-1][0], graphs[-1][1], rng)
        if cadj.ncols >= graphs[-1][0].ncols * 0.95:
            break  # matching stalled
        graphs.append((cadj, cw))
        cmaps.append(cmap)
        levels += 1

    # --- initial partition on the coarsest graph -----------------------------
    cadj, cw = graphs[-1]
    parts = _greedy_grow(cadj, cw, nparts, rng)
    parts = _refine(cadj, cw, parts, nparts)

    # --- uncoarsen + refine ---------------------------------------------------
    for lvl in range(levels - 1, -1, -1):
        parts = parts[cmaps[lvl]]
        gadj, gw = graphs[lvl]
        parts = _refine(gadj, gw, parts, nparts)

    part_w = np.zeros(nparts)
    np.add.at(part_w, parts, weights)
    report = PartitionReport(
        parts=parts, nparts=nparts,
        cut=edge_cut(adj, parts),
        weight_imbalance=float(part_w.max() / max(part_w.mean(), 1e-12)),
        levels=levels,
    )
    return report


def partition_to_permutation(parts: np.ndarray,
                             nparts: Optional[int] = None
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Turn a part assignment into (perm, splits): vertices of part 0 first,
    then part 1, ... ``perm[old_id] = new_id``; splits are the 1D column
    split points aligned with the parts (feed to ``Partition1D``).

    Pass ``nparts`` to keep empty trailing parts (zero-width splits) so the
    partition stays aligned with a fixed process count.
    """
    if nparts is None:
        nparts = int(parts.max()) + 1
    order = np.argsort(parts, kind="stable")   # old ids grouped by part
    perm = np.empty_like(order)
    perm[order] = np.arange(len(parts), dtype=np.int64)
    counts = np.zeros(nparts + 1, dtype=np.int64)
    np.add.at(counts, parts + 1, 1)
    splits = np.cumsum(counts)
    return perm, splits
