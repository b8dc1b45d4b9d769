"""Randomized sparse sketching on the device SpGEMM session.

The port's counterpart of ``repro.apps.sketch``: the same operator from
the same seed, every multiply through
:class:`~repro_torch.core.session.SpGEMMSession` (``device="cuda"`` unless
the caller asks for the CPU).

The paper's abstract names randomized sketching among the SpGEMM-driven
workloads (cf. the distributed sparse × tall-and-skinny study,
arXiv:2408.11988): compress a large sparse matrix by multiplying with a
sparse random sketch operator. We implement the CountSketch family — the
sketch ``S`` has exactly one ±1 entry per column, so ``S·A`` hashes A's
rows into ``dim`` buckets with random signs (and ``A·Sᵀ`` hashes the
columns, yielding the tall-and-skinny ``nrows × dim`` compression).

Both products are plain sparse-sparse multiplies on the device path, and
the workload is inherently *iterated*: a stream of same-pattern matrices
(time-varying weights on a fixed graph, minibatches of a fixed feature
layout) is sketched with one fixed operator. Through
:class:`~repro_torch.core.session.SpGEMMSession` every multiply after the
first is a structure-keyed cache hit — zero host planning, zero rebuilt
executable, at most a values-only payload repack (see
:func:`sketch_stream`).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

import numpy as np

from ..core import CSC, from_coo
from ..core.session import SpGEMMSession, session_or_new

__all__ = ["count_sketch", "sketch_apply", "sketch_stream", "SketchResult"]


def count_sketch(dim: int, n: int, seed: int = 0,
                 dtype=np.float64) -> CSC:
    """A ``dim × n`` CountSketch operator: column j holds a single ±1 at a
    uniformly random row (bucket). Rows that no column hashes to are empty
    — a legal, fully supported degenerate (the sketched result simply has
    empty rows there)."""
    assert dim >= 1 and n >= 0
    rng = np.random.default_rng(seed)
    buckets = rng.integers(0, dim, size=n)
    signs = rng.choice(np.array([-1.0, 1.0], dtype=dtype), size=n)
    return from_coo(buckets, np.arange(n, dtype=np.int64), signs, (dim, n))


@dataclasses.dataclass
class SketchResult:
    sketched: CSC                 # S·A (dim × n) or A·Sᵀ (m × dim)
    sketch: CSC                   # the operator S that was applied
    comm_bytes: int               # planned payload bytes of the multiply
    cache_hit: bool               # served without host planning


def sketch_apply(a: CSC, sketch: CSC, side: str = "left",
                 session: Optional[SpGEMMSession] = None,
                 algorithm: str = "1d",
                 nparts: int = 1, grid: int = 1, layers: int = 1,
                 bs: int = 32, engine: str = "auto",
                 device=None) -> SketchResult:
    """Apply a sketch operator to ``a`` on the device SpGEMM path.

    side="left":  S·A   — rows hashed, short-fat ``dim × ncols`` result;
    side="right": A·Sᵀ  — columns hashed, tall-and-skinny ``nrows × dim``
    result (the sparse × tall-and-skinny shape of arXiv:2408.11988).
    The multiply routes through ``session`` (created if absent) on any
    engine; geometry kwargs forward to :meth:`SpGEMMSession.matmul`.
    ``device`` places a new session (None: the session's default,
    ``"cuda"``); it may not come with ``session``.
    """
    from ..core.session import as_payload_dtype

    session = session_or_new(session, device)
    # streams apply one sketch to many same-structure matrices — values-only
    # repacks, which the session accepts only at its own payload dtype
    if side == "left":
        assert sketch.ncols == a.nrows, (sketch.shape, a.shape)
        c = session.matmul(as_payload_dtype(sketch), as_payload_dtype(a),
                           algorithm=algorithm, nparts=nparts,
                           grid=grid, layers=layers, bs=bs, engine=engine)
    elif side == "right":
        assert sketch.ncols == a.ncols, (sketch.shape, a.shape)
        c = session.matmul(as_payload_dtype(a),
                           as_payload_dtype(sketch.transpose()),
                           algorithm=algorithm, nparts=nparts, grid=grid,
                           layers=layers, bs=bs, engine=engine)
    else:
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    return SketchResult(sketched=c, sketch=sketch,
                        comm_bytes=session.last_call["comm_bytes_planned"],
                        cache_hit=session.last_call["cache_hit"])


def sketch_stream(mats: Iterable[CSC], dim: int, seed: int = 0,
                  side: str = "left",
                  session: Optional[SpGEMMSession] = None,
                  **kwargs) -> List[SketchResult]:
    """Sketch a stream of matrices with ONE fixed operator.

    The session amortization case: when the stream's matrices share a
    sparsity pattern (time-varying values on a fixed structure), every
    multiply after the first is a plan-cache hit with a values-only
    payload repack. ``kwargs`` forward to :func:`sketch_apply`.
    """
    session = session_or_new(session, kwargs.pop("device", None))
    mats = list(mats)
    if not mats:
        return []
    first = mats[0]
    n = first.nrows if side == "left" else first.ncols
    s = count_sketch(dim, n, seed=seed)
    return [sketch_apply(m, s, side=side, session=session, **kwargs)
            for m in mats]
