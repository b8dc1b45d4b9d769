"""Batched approximate betweenness centrality (paper §II.C.3, §IV.C).

Linear-algebraic Brandes, exactly the CombBLAS formulation the paper
benchmarks: per batch of K source vertices, a *forward* multi-source BFS
expands frontiers with SpGEMM — plus-times by default, accumulating exact
shortest-path counts σ as it goes (``fwd_semiring=BOOL_OR_AND`` opts into
the pure-reachability variant with degenerate 0/1 σ) — then a *backward
sweep* tallies dependency scores δ with plus-times SpGEMMs down the BFS
levels. Both phases take the distributed SpGEMM implementation as a
parameter (1D sparsity-aware / 2D SUMMA / 3D split / device ring) so the
benchmark compares them on identical work.

The port's counterpart of ``repro.apps.bc``, with the same sweeps and
snapshot format (a batch interrupted in either package resumes in the
other); :func:`device_spgemm_fn` runs every multiply through
:class:`~repro_torch.core.session.SpGEMMSession` on ``device="cuda"``
unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from ..core import PLUS_TIMES, CSC, Semiring, from_coo, spgemm
from ..core.session import as_payload_dtype, session_or_new
from ..runtime.resumable import (LoopCheckpointer, pack_csc_list,
                                 unpack_csc_list)

__all__ = ["bc_batch", "BCResult", "ew_multiply", "ew_mask_not",
           "device_spgemm_fn"]


# ---- elementwise CSC helpers (the EWiseMult/Apply of CombBLAS) -------------

def _coo(mat: CSC):
    return mat.to_coo()


def ew_multiply(a: CSC, b_dense_col: np.ndarray) -> CSC:
    """Scale each entry a[i, j] by b_dense_col[i] (broadcast over cols)."""
    rows, cols, vals = _coo(a)
    return from_coo(rows, cols, vals * b_dense_col[rows], a.shape)


def ew_mask_not(a: CSC, visited: np.ndarray) -> CSC:
    """Keep entries a[i, j] whose *position* is unset in the dense boolean
    ``visited`` mask — i.e. drop every entry with ``visited[i, j]`` True
    (CombBLAS ``EWiseMult`` with a negated mask). The mask is per
    (vertex, source) pair, not per row: vertex i may already be visited in
    one BFS of the batch while still frontier-new in another."""
    rows, cols, vals = _coo(a)
    keep = ~visited[rows, cols]
    return from_coo(rows[keep], cols[keep], vals[keep], a.shape)


@dataclasses.dataclass
class BCResult:
    scores: np.ndarray            # (n,) accumulated centrality
    depths: int                   # BFS levels executed
    fwd_spgemm_calls: int
    bwd_spgemm_calls: int
    comm_bytes: int               # sum over distributed spgemm calls


def bc_batch(a: CSC, sources: np.ndarray,
             spgemm_fn: Optional[Callable] = None,
             fwd_semiring: Semiring = PLUS_TIMES,
             checkpoint_dir: Optional[str] = None) -> BCResult:
    """One batch of multi-source Brandes on graph ``a`` (n×n, unweighted).

    sources: (b,) vertex ids. ``spgemm_fn(A, B, semiring) -> (CSC, bytes)``
    is the distributed multiply; defaults to the local oracle with zero
    communication.

    ``fwd_semiring`` is routed to ``spgemm_fn`` on the forward frontier
    expansion (it is not pinned to plus-times): the default accumulates
    exact shortest-path counts σ; ``BOOL_OR_AND`` runs the frontier as a
    pure reachability BFS (σ degenerates to 0/1 — the approximate-BC
    variant). The backward sweep tallies real-valued dependencies and is
    inherently plus-times.

    ``checkpoint_dir`` makes the batch resumable: each completed level
    (forward expansion or backward tally) snapshots the host state —
    levels, σ, visited, δ, phase — atomically; a re-call with the same
    directory after an aborting fault resumes mid-sweep and produces the
    bitwise-identical scores.
    """
    n = a.nrows
    b = len(sources)
    at = a.transpose()

    if spgemm_fn is None:
        def spgemm_fn(x, y, semiring):
            return spgemm(x, y, semiring), 0

    # frontier: one-hot sources (n × b); sigma: path counts so far
    frontier = from_coo(sources, np.arange(b), np.ones(b), (n, b))
    sigma_dense = frontier.to_dense().astype(np.float64)
    visited = sigma_dense > 0

    levels: List[CSC] = [frontier]
    comm = 0
    fwd_calls = 0
    delta = np.zeros((n, b))
    bwd_calls = 0
    phase = 0                       # 0 = forward sweep, 1 = backward
    d_next = -1                     # next backward level once phase == 1

    ckpt = None
    if checkpoint_dir is not None:
        ckpt = LoopCheckpointer(checkpoint_dir)
        _, state = ckpt.resume()
        if state is not None:
            levels = unpack_csc_list("levels", state)
            frontier = levels[-1]
            sigma_dense = np.asarray(state["sigma"], dtype=np.float64)
            visited = np.asarray(state["visited"], dtype=bool)
            delta = np.asarray(state["delta"], dtype=np.float64)
            comm = int(state["comm"])
            fwd_calls = int(state["fwd_calls"])
            bwd_calls = int(state["bwd_calls"])
            phase = int(state["phase"])
            d_next = int(state["d_next"])

    def snapshot():
        state = {"sigma": sigma_dense, "visited": visited, "delta": delta,
                 "comm": np.asarray(comm, dtype=np.int64),
                 "fwd_calls": np.asarray(fwd_calls, dtype=np.int64),
                 "bwd_calls": np.asarray(bwd_calls, dtype=np.int64),
                 "phase": np.asarray(phase, dtype=np.int64),
                 "d_next": np.asarray(d_next, dtype=np.int64)}
        pack_csc_list("levels", levels, state)
        ckpt.maybe_save(fwd_calls + bwd_calls, state)

    if phase == 0:
        while frontier.nnz:
            nxt, bytes_ = spgemm_fn(at, frontier, fwd_semiring)
            comm += bytes_
            fwd_calls += 1
            nxt = ew_mask_not(nxt, visited)        # drop already-visited
            if nxt.nnz == 0:
                break
            rows, cols, vals = nxt.to_coo()
            sigma_dense[rows, cols] += vals
            visited[rows, cols] = True
            frontier = nxt
            levels.append(frontier)
            if ckpt is not None:
                snapshot()
        phase = 1
        d_next = len(levels) - 1

    # backward sweep over levels (deepest first)
    for d in range(d_next, 0, -1):
        lv = levels[d]
        rows, cols, _ = lv.to_coo()
        # w = (1 + delta) / sigma on the level-d frontier
        w_vals = (1.0 + delta[rows, cols]) / sigma_dense[rows, cols]
        w = from_coo(rows, cols, w_vals, lv.shape)
        contrib, bytes_ = spgemm_fn(a, w, PLUS_TIMES)
        comm += bytes_
        bwd_calls += 1
        # restrict to the level-(d-1) frontier and scale by sigma there
        prv = levels[d - 1]
        prows, pcols, _ = prv.to_coo()
        cd = contrib.to_dense()
        delta[prows, pcols] += cd[prows, pcols] * sigma_dense[prows, pcols]
        if ckpt is not None:
            d_next = d - 1
            snapshot()

    scores = delta.sum(axis=1)
    scores[sources] -= delta[sources, np.arange(b)]  # exclude s==v terms
    return BCResult(scores=scores, depths=len(levels),
                    fwd_spgemm_calls=fwd_calls, bwd_spgemm_calls=bwd_calls,
                    comm_bytes=comm)


# ---- device-ring adapter ----------------------------------------------------

def device_spgemm_fn(nparts: int = 1, bs: int = 16,
                     nblocks: Optional[int] = None,
                     engine: str = "auto",
                     device=None,
                     session=None) -> Callable:
    """A ``spgemm_fn`` for :func:`bc_batch` backed by the device SpGEMM ring.

    Every BC multiply (forward frontier expansion *and* backward sweep)
    executes on the device ring (the ``bsr_spgemm`` CUDA kernel on a card)
    under whatever semiring ``bc_batch`` passes — this is the paper's §IV.C
    scenario on the product engine. ``nparts`` counts the ring's logical
    parts on the session's one device; comm bytes are the plan's exact
    planned payload bytes (zero at nparts=1 — a one-part ring has no fetch
    steps).

    Multiplies route through a persistent
    :class:`~repro_torch.core.session.SpGEMMSession` (pass one to share its
    plan cache across batches; a private one is created otherwise, on
    ``device`` — None: the session's default, ``"cuda"`` — and exposed as
    ``fn.session``; ``device`` may not come with ``session``). Frontier
    structure changes every forward level, but on a symmetric graph the
    backward sweep replays the forward levels' structures with new values
    — those multiplies are structure-keyed cache hits: no host planning,
    no rebuilt executable, a values-only payload repack. Repeated batches
    over the same graph hit even more.
    """
    session = session_or_new(session, device)

    def fn(x: CSC, y: CSC, semiring: Semiring):
        # the backward sweep repacks values into f32-keyed entries; the
        # session rejects dtype-mismatched repacks, so cast explicitly
        c = session.matmul(as_payload_dtype(x), as_payload_dtype(y),
                           nparts=nparts, bs=bs, nblocks=nblocks,
                           semiring=semiring, engine=engine)
        # downstream σ/δ accumulation is float64; the exact small-int
        # frontier counts survive the f32 payloads unchanged
        return c.astype(np.float64), session.last_call["comm_bytes_planned"]

    fn.session = session
    return fn
