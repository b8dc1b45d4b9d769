"""Structural validation + the sparse runtime's typed error taxonomy.

The port's copy of ``repro.core.validate``: the CSC and BlockSparse
checks and the error taxonomy.

Serving-grade SpGEMM (ROADMAP open item 1) cannot afford a single corrupt
request poisoning a shared plan cache: a non-monotone ``indptr`` or an
out-of-bounds row id would be baked into a structure fingerprint, planned
into payload/schedule stacks, compiled, cached — and then replayed for
every later caller that hashes to the same key. The contract here is
**validation at session ingress**: :meth:`SpGEMMSession.matmul` runs
:func:`validate_matmul_operands` *before* fingerprinting, so a malformed
operand is rejected with a :class:`ValidationError` and never touches the
cache, the planner or the device.

Every check is vectorized O(nnz) (one ``np.diff`` / comparison sweep per
array — no Python-level per-nonzero loop), so ingress validation costs
microseconds at bench scale and stays off the profile next to hashing the
same arrays for the fingerprint.

The error taxonomy (see also ROADMAP "hardened-runtime contract"):

    SpGEMMError                 — base; carries ``stage`` + free-form context
    ├── ValidationError         — malformed operand at session ingress
    ├── PlanError               — host planning / packing / geometry failed
    └── DeviceExecError         — compile / execute / repack failed on device

No bare ``RuntimeError`` may escape the session: anything a stage raises
that is not already an ``SpGEMMError`` is wrapped into ``PlanError`` (plan
stage) or ``DeviceExecError`` (compile/execute/repack stages) after the
retry/degradation ladder is exhausted, with the original exception chained
via ``__cause__``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .semiring import Semiring
from .sparse import CSC

__all__ = [
    "SpGEMMError", "ValidationError", "PlanError", "DeviceExecError",
    "wrap_stage_error", "validate_csc", "validate_blocksparse",
    "validate_matmul_operands",
]


# ---------------------------------------------------------------------------
# taxonomy
# ---------------------------------------------------------------------------

class SpGEMMError(Exception):
    """Base of the sparse runtime's typed errors.

    ``stage`` names the pipeline stage that failed (``"validate"`` /
    ``"plan"`` / ``"compile"`` / ``"execute"`` / ``"repack"``); ``context``
    is a free-form dict (operand name, algorithm, engine, retry count)
    rendered into the message so logs are self-describing.
    """

    def __init__(self, message: str, *, stage: Optional[str] = None,
                 context: Optional[dict] = None):
        self.stage = stage
        self.context = dict(context or {})
        suffix = ""
        if stage is not None:
            suffix = f" [stage={stage}"
            if self.context:
                suffix += "".join(f" {k}={v!r}"
                                  for k, v in sorted(self.context.items()))
            suffix += "]"
        super().__init__(message + suffix)


class ValidationError(SpGEMMError):
    """A structurally invalid operand reached session ingress."""


class PlanError(SpGEMMError):
    """Host-side planning / schedule packing / geometry resolution failed."""


class DeviceExecError(SpGEMMError):
    """Compilation or device execution (including payload repack) failed."""


# which taxonomy class wraps an unexpected failure of each pipeline stage
_STAGE_ERROR = {
    "validate": ValidationError,
    "plan": PlanError,
    "compile": DeviceExecError,
    "execute": DeviceExecError,
    "repack": DeviceExecError,
}


def wrap_stage_error(stage: str, exc: BaseException,
                     context: Optional[dict] = None) -> SpGEMMError:
    """Wrap ``exc`` into the taxonomy class owning ``stage``.

    Already-typed errors pass through unchanged (their stage is
    authoritative); everything else — a CUDA ``RuntimeError``, a
    ``ValueError`` from the kernel wrapper's checks, an injected fault —
    becomes the stage's
    typed error with ``exc`` chained as ``__cause__`` by the raiser.
    """
    if isinstance(exc, SpGEMMError):
        return exc
    cls = _STAGE_ERROR.get(stage, SpGEMMError)
    return cls(f"{type(exc).__name__}: {exc}", stage=stage, context=context)


# ---------------------------------------------------------------------------
# vectorized structural validation
# ---------------------------------------------------------------------------

def _fail(name: str, reason: str, **context) -> None:
    raise ValidationError(f"operand {name!r} is structurally invalid: "
                          f"{reason}", stage="validate",
                          context=dict(context, operand=name))


def validate_csc(mat: CSC, *, semiring: Optional[Semiring] = None,
                 name: str = "operand") -> None:
    """Vectorized O(nnz) structural validation of one CSC operand.

    Checks, in order (each one array sweep, no per-nonzero Python loop):

      * shape is a pair of non-negative python/numpy ints;
      * ``indptr``: 1-D integer array of length ``ncols+1``, starts at 0,
        ends at ``nnz``, monotone non-decreasing;
      * ``indices``: 1-D integer array, row ids in ``[0, nrows)``, strictly
        increasing within each column (sorted, no duplicates);
      * ``data``: 1-D numeric array of length ``nnz``;
      * value policy (semiring-aware): NaN is always rejected; non-finite
        values are rejected unless they equal the semiring's additive
        identity (min-plus stores ``+inf`` legally — it *is* the identity —
        while ``-inf`` is still corrupt under every registered semiring).

    Raises :class:`ValidationError` with the precise reason; returns None
    on success.
    """
    if not isinstance(mat, CSC):
        _fail(name, f"expected CSC, got {type(mat).__name__}")
    shape = mat.shape
    if len(shape) != 2:
        _fail(name, f"shape must be 2-D, got {shape!r}")
    nrows, ncols = (int(shape[0]), int(shape[1]))
    if nrows < 0 or ncols < 0:
        _fail(name, f"negative dimension in shape {shape!r}")

    indptr = mat.indptr
    indices = mat.indices
    data = mat.data
    for arr_name, arr in (("indptr", indptr), ("indices", indices),
                          ("data", data)):
        if not isinstance(arr, np.ndarray):
            _fail(name, f"{arr_name} is {type(arr).__name__}, not ndarray")
        if arr.ndim != 1:
            _fail(name, f"{arr_name} must be 1-D, has ndim={arr.ndim}")

    if not np.issubdtype(indptr.dtype, np.integer):
        _fail(name, f"indptr dtype {indptr.dtype} is not integral")
    if not np.issubdtype(indices.dtype, np.integer):
        _fail(name, f"indices dtype {indices.dtype} is not integral")
    if not (np.issubdtype(data.dtype, np.floating)
            or np.issubdtype(data.dtype, np.integer)
            or np.issubdtype(data.dtype, np.bool_)):
        _fail(name, f"data dtype {data.dtype} is not numeric")

    if indptr.shape[0] != ncols + 1:
        _fail(name, f"indptr has length {indptr.shape[0]}, "
                    f"expected ncols+1 = {ncols + 1}")
    if indptr.shape[0] and indptr[0] != 0:
        _fail(name, f"indptr[0] = {int(indptr[0])}, expected 0")
    nnz = indices.shape[0]
    if indptr[-1] != nnz:
        _fail(name, f"indptr[-1] = {int(indptr[-1])} does not match "
                    f"nnz = {nnz}")
    if data.shape[0] != nnz:
        _fail(name, f"data has length {data.shape[0]}, indices {nnz}")
    col_nnz = np.diff(indptr)
    if col_nnz.size and int(col_nnz.min()) < 0:
        bad = int(np.argmax(col_nnz < 0))
        _fail(name, f"indptr is not monotone at column {bad} "
                    f"({int(indptr[bad])} > {int(indptr[bad + 1])})")

    if nnz:
        lo, hi = int(indices.min()), int(indices.max())
        if lo < 0 or hi >= nrows:
            _fail(name, f"row index out of bounds: range [{lo}, {hi}] "
                        f"vs nrows = {nrows}")
        # sorted + duplicate-free within each column: a row-id step must be
        # strictly positive everywhere the column id does not advance
        col_of = np.repeat(np.arange(ncols, dtype=np.int64), col_nnz)
        same_col = col_of[1:] == col_of[:-1]
        bad_step = same_col & (np.diff(indices) <= 0)
        if bad_step.any():
            pos = int(np.argmax(bad_step))
            _fail(name, f"indices not strictly increasing within column "
                        f"{int(col_of[pos])} (positions {pos}, {pos + 1}: "
                        f"rows {int(indices[pos])}, {int(indices[pos + 1])})")

        if np.issubdtype(data.dtype, np.floating):
            if np.isnan(data).any():
                _fail(name, "data contains NaN",
                      semiring=getattr(semiring, "name", None))
            finite = np.isfinite(data)
            if not finite.all():
                zero = semiring.zero if semiring is not None else 0.0
                # an infinite additive identity (min-plus) may be stored
                # explicitly; any other non-finite value is corruption
                offending = data[~finite]
                if np.isinf(zero):
                    offending = offending[offending != zero]
                if offending.size:
                    _fail(name, f"data contains non-finite value "
                                f"{float(offending[0])!r} (not the additive "
                                f"identity)",
                          semiring=getattr(semiring, "name", None))


def validate_blocksparse(bsp, *, name: str = "tiles") -> None:
    """Structural validation of a BSR/BlockSparse payload stack.

    Used by tools that ingest pre-blockized operands; the session path
    validates at CSC granularity before blockization instead.
    """
    from .blocksparse import BlockSparse
    if not isinstance(bsp, BlockSparse):
        _fail(name, f"expected BlockSparse, got {type(bsp).__name__}")
    bs = int(bsp.bs)
    if bs <= 0:
        _fail(name, f"block size must be positive, got {bs}")
    tiles = bsp.tiles
    if tiles.ndim != 3:
        _fail(name, f"tiles must be (ntiles, bs, bs), got {tiles.shape}")
    n = tiles.shape[0]
    if bsp.tile_rows.shape != (n,) or bsp.tile_cols.shape != (n,):
        _fail(name, f"tile coordinate arrays {bsp.tile_rows.shape} / "
                    f"{bsp.tile_cols.shape} do not match ntiles = {n}")
    gr = -(-int(bsp.shape[0]) // bs)
    gc = -(-int(bsp.shape[1]) // bs)
    if n:
        if int(bsp.tile_rows.min()) < 0 or int(bsp.tile_rows.max()) >= gr:
            _fail(name, f"tile_rows out of bounds for grid {gr}")
        if int(bsp.tile_cols.min()) < 0 or int(bsp.tile_cols.max()) >= gc:
            _fail(name, f"tile_cols out of bounds for grid {gc}")
        if np.issubdtype(tiles.dtype, np.floating) and \
                np.isnan(tiles).any():
            _fail(name, "tile payloads contain NaN")


def validate_matmul_operands(a: CSC, b: CSC, *,
                             semiring: Optional[Semiring] = None) -> None:
    """Ingress check for C = A ⊗ B: both operands + the inner dimension."""
    validate_csc(a, semiring=semiring, name="a")
    validate_csc(b, semiring=semiring, name="b")
    if a.shape[1] != b.shape[0]:
        raise ValidationError(
            f"inner dimensions do not match: a is {a.shape}, b is {b.shape}",
            stage="validate", context={"a_shape": a.shape,
                                       "b_shape": b.shape})
