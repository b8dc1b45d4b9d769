"""Markov clustering (MCL, van Dongen '00) — iterated squaring on the
device SpGEMM session.

The port's counterpart of ``repro.apps.mcl``, with the same loop, operators
and snapshot format (a run interrupted in either package resumes in the
other). The expansion runs on ``device="cuda"`` unless the caller asks for
the CPU.

The paper's abstract names Markov clustering among the driving workloads
(cf. the multi-level SpGEMM parallelism study of HipMCL, arXiv:1510.00844):
the hot loop alternates **expansion** — squaring the column-stochastic
transition matrix, a sparse-sparse multiply whose operand sparsity changes
every iteration — with elementwise **inflation** and **pruning** that
re-sharpen the sparsity. That shape is exactly what
:class:`~repro_torch.core.session.SpGEMMSession` exists for: every expansion
runs through the session (any engine: 1D ring / 2D SUMMA / Split-3D), so
planning is re-done only while the sparsity structure is still moving and
is skipped outright once the iteration converges onto a fixed pattern —
the steady state plays back the cached plan + compiled executable with at
most a values-only payload repack.

Everything except the multiply is host-side numpy on CSC: inflation,
column normalization, threshold pruning, the chaos convergence criterion
and the attractor-based cluster readout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core import CSC, from_coo, identity, spadd
from ..core.session import SpGEMMSession, as_payload_dtype, session_or_new
from ..runtime.resumable import LoopCheckpointer, pack_csc, unpack_csc

__all__ = ["mcl", "MCLResult", "mcl_dense_reference", "add_self_loops",
           "column_normalize", "inflate", "prune_small", "chaos",
           "clusters_from_matrix"]


# ---- elementwise MCL operators (host-side, CSC) ----------------------------

def add_self_loops(a: CSC, weight: float = 1.0) -> CSC:
    """A + weight·I — MCL's standard self-loop regularization (keeps the
    random walk aperiodic and every column nonempty)."""
    eye = identity(a.nrows, dtype=np.float64)
    eye.data *= weight
    return spadd(a.astype(np.float64), eye)


def column_normalize(m: CSC) -> CSC:
    """Scale each column to sum 1 (columns with no entries stay empty)."""
    rows, cols, vals = m.to_coo()
    sums = np.zeros(m.ncols, dtype=np.float64)
    np.add.at(sums, cols, vals)
    safe = np.where(sums > 0, sums, 1.0)
    return from_coo(rows, cols, vals / safe[cols], m.shape)


def inflate(m: CSC, r: float) -> CSC:
    """Entrywise power then column re-normalization (the Γ_r operator)."""
    powered = CSC(m.indptr.copy(), m.indices.copy(),
                  np.power(m.data, r), m.shape)
    return column_normalize(powered)


def prune_small(m: CSC, threshold: float) -> CSC:
    """Drop entries below ``threshold`` and re-normalize the survivors
    (HipMCL-style sparsification between iterations)."""
    rows, cols, vals = m.to_coo()
    keep = vals >= threshold
    return column_normalize(
        from_coo(rows[keep], cols[keep], vals[keep], m.shape))


def chaos(m: CSC) -> float:
    """MCL's convergence measure: max over columns of (max - sum of
    squares). Zero iff every column is a 0/1 indicator (idempotent limit).
    """
    if m.nnz == 0:
        return 0.0
    rows, cols, vals = m.to_coo()
    cmax = np.zeros(m.ncols)
    np.maximum.at(cmax, cols, vals)
    csq = np.zeros(m.ncols)
    np.add.at(csq, cols, vals * vals)
    return float(np.max(cmax - csq))


def clusters_from_matrix(m: CSC) -> np.ndarray:
    """Attractor readout: node j joins the cluster of the heaviest row of
    its column; nodes whose column emptied out (fully pruned) become
    singleton clusters of themselves.

    The dense readout's labels (a column's largest value, counting its
    implicit zeros, must be positive; ties go to the first row), read off
    the stored entries: an n×n dense copy does not fit at the sizes the
    loop runs at."""
    n = m.ncols
    labels = np.arange(n, dtype=np.int64)
    if m.nnz:
        counts = np.diff(m.indptr)
        cols = np.repeat(np.arange(n, dtype=np.int64), counts)
        cmax = np.full(n, -np.inf)
        np.maximum.at(cmax, cols, m.data)
        # a column with fewer stored entries than rows also holds zeros
        cmax = np.where(counts < m.nrows, np.maximum(cmax, 0.0), cmax)
        nonempty = np.nonzero(cmax > 0)[0]
        at_max = m.data == cmax[cols]
        first = np.full(n, m.nrows, dtype=np.int64)
        np.minimum.at(first, cols[at_max], m.indices[at_max])
        labels[nonempty] = first[nonempty]
    return labels


# ---- the clustering loop ----------------------------------------------------

@dataclasses.dataclass
class MCLResult:
    clusters: np.ndarray          # (n,) attractor label per node
    matrix: CSC                   # the converged (or final) operator
    iterations: int               # expansion steps executed
    converged: bool
    chaos: float                  # final chaos value
    comm_bytes: int               # sum of planned payload bytes moved


def mcl(a: CSC,
        inflation: float = 2.0,
        prune_threshold: float = 1e-3,
        max_iter: int = 32,
        tol: float = 1e-6,
        self_loops: float = 1.0,
        session: Optional[SpGEMMSession] = None,
        algorithm: str = "1d",
        nparts: int = 1,
        grid: int = 1,
        layers: int = 1,
        bs: int = 32,
        engine: str = "auto",
        device=None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1) -> MCLResult:
    """Markov clustering of the graph ``a`` (n×n, nonnegative weights).

    Expansion (M ← M·M) runs on the device SpGEMM path through
    ``session`` (one is created when not supplied — pass a shared session
    to amortize across multiple ``mcl`` calls on related graphs);
    inflation/pruning/normalization are host-side. ``algorithm`` /
    ``nparts`` / ``grid`` / ``layers`` / ``bs`` / ``engine`` forward to
    :meth:`SpGEMMSession.matmul` (the geometry counts logical parts on the
    session's one device). ``device`` places a new session (None: the
    session's default, ``"cuda"``); it may not come with ``session``.

    ``checkpoint_dir`` makes the loop resumable: every
    ``checkpoint_every`` completed iterations the host state (operator,
    iteration count, comm tally, chaos) is snapshotted atomically; if a
    fault escapes the session's ladder and aborts the run, re-calling
    ``mcl`` with the same directory resumes at the last snapshot and
    converges to the bitwise-identical result instead of restarting.
    """
    assert a.nrows == a.ncols, a.shape
    session = session_or_new(session, device)

    m = column_normalize(add_self_loops(a, weight=self_loops))
    comm = 0
    it = 0
    ch = chaos(m)
    ckpt = None
    if checkpoint_dir is not None:
        ckpt = LoopCheckpointer(checkpoint_dir, every=checkpoint_every)
        _, state = ckpt.resume()
        if state is not None:
            m = unpack_csc("m", state)
            it = int(state["it"])
            comm = int(state["comm"])
            ch = float(state["chaos"])
    converged = ch < tol
    while not converged and it < max_iter and m.nnz:
        # inflation/normalization run in float64 on the host; the session
        # computes in float32 and rejects dtype-mismatched values repacks,
        # so the expansion operand is cast explicitly at the boundary
        mf = as_payload_dtype(m)
        m2 = session.matmul(mf, mf, algorithm=algorithm, nparts=nparts,
                            grid=grid, layers=layers, bs=bs, engine=engine)
        comm += session.last_call["comm_bytes_planned"]
        it += 1
        m = inflate(m2.astype(np.float64), inflation)
        m = prune_small(m, prune_threshold)
        if m.nnz == 0:
            # fully-pruned iteration: the walk died everywhere — treat as
            # converged to the all-singletons clustering
            break
        ch = chaos(m)
        converged = ch < tol
        if ckpt is not None:
            state = {"it": np.asarray(it, dtype=np.int64),
                     "comm": np.asarray(comm, dtype=np.int64),
                     "chaos": np.asarray(ch, dtype=np.float64)}
            pack_csc("m", m, state)
            ckpt.maybe_save(it, state)

    return MCLResult(clusters=clusters_from_matrix(m), matrix=m,
                     iterations=it, converged=converged or m.nnz == 0,
                     chaos=ch if m.nnz else 0.0, comm_bytes=comm)


# ---- dense reference --------------------------------------------------------

def mcl_dense_reference(g: np.ndarray,
                        inflation: float = 2.0,
                        prune_threshold: float = 1e-3,
                        max_iter: int = 32,
                        tol: float = 1e-6,
                        self_loops: float = 1.0):
    """Dense numpy mirror of :func:`mcl`'s loop — the test/benchmark oracle.

    An independent computation path from the sparse/device implementation
    (dense matmul vs the distributed block-sparse engines, dense masking vs
    CSC surgery) that follows the same iteration order, with the expansion
    in f32 exactly like the device tile products and elementwise steps in
    f64. Returns ``(matrix, iterations)``.
    """
    def norm(m):
        s = m.sum(axis=0)
        return m / np.where(s > 0, s, 1.0)

    def dense_chaos(m):
        if not m.any():
            return 0.0
        return float(np.max(m.max(axis=0) - (m * m).sum(axis=0)))

    m = norm(g.astype(np.float64) + self_loops * np.eye(len(g)))
    it = 0
    while dense_chaos(m) >= tol and it < max_iter:
        m = (m.astype(np.float32) @ m.astype(np.float32)).astype(np.float64)
        it += 1
        m = norm(np.power(m, inflation))
        m = norm(np.where(m >= prune_threshold, m, 0.0))
        if not m.any():
            break
    return m, it
