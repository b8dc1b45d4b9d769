"""Persistent device-SpGEMM sessions — structure-keyed plan/executable cache.

The port's counterpart of ``repro.core.session``. The paper's use cases are
all *iterated* multiplies (BC frontier levels, AMG Galerkin products, Markov
clustering, sketching). On the device path the expensive work per multiply
is **host planning** (symbolic phase, schedule join, static-shape packing)
and **building the executable** (uploading the plan's stacks, deriving the
gather indices or slot remaps and the run boundaries) — both depend only on
the operands' *sparsity structure* and the call geometry, never on the
values.

:class:`SpGEMMSession` serves every multiply from an LRU cache keyed on

    (algorithm, geometry (nparts / grid×layers), bs, nblocks, chunk,
     semiring, engine, payload dtype,
     structure fingerprint of A, structure fingerprint of B)

(``nblocks`` and ``chunk`` are 1D-ring knobs and key only ``"1d"``
entries) with three outcomes:

  * **cold key** — plan (``build_device_plan`` / ``build_summa_plan``),
    build the executable (``compile_ring`` / ``compile_summa``: the plan's
    device tensors plus the body closure), cache both;
  * **hit, same values** — run the cached executable as-is: zero host
    planning, zero builds, zero payload transfer;
  * **hit, new values** — the values-only path: re-blockize payloads on
    the cached plan's partitions (``repack_ring_payloads`` /
    ``repack_summa_payloads``), swap them into the cached device args, run
    the same executable.

``stats["traces"]`` counts executable builds, so a hit is observable as
zero new ones (the surface is ``device_common.SESSION_STATS``).

Hardened-runtime contract (``core/validate.py``): operands are validated at
ingress; every stage (plan / compile / execute / repack) runs under
seeded-jitter backoff retries, and cached entries whose stage fails are
quarantined behind a per-key circuit breaker. Whatever escapes is a typed
:class:`SpGEMMError`. A stage that stays broken walks the **degradation
ladder**: engine fallback cuda→torch inside each algorithm rung, then the
algorithm downgrade 3d→2d→1d; every rung is bitwise oracle-equivalent, and
each descent shows in ``stats["fallbacks"]``. The engine fallback exists
only for CPU tensors: on a CUDA device every rung runs the kernel, so the
plain version never stands in for it on the card (an algorithm downgrade
still may, and ``last_call["degraded"]`` says so). The kernel is built
before the ladder and a bs the kernel does not take is rejected at
ingress, so neither reaches a rung.
"""

from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import numpy as np

import torch

from ..runtime.fault_tolerance import RetryPolicy, with_retries
from .device_common import SESSION_STATS, resolve_device, resolve_engine
from .semiring import PLUS_TIMES, Semiring
from .sparse import CSC
from .validate import (DeviceExecError, SpGEMMError,
                       ValidationError, validate_matmul_operands,
                       wrap_stage_error)

__all__ = ["SpGEMMSession", "session_or_new", "as_payload_dtype",
           "structure_fingerprint", "values_fingerprint", "ALGORITHMS",
           "DOWNGRADE"]

ALGORITHMS = ("1d", "2d", "3d")

# the algorithm rungs of the degradation ladder, most- to least-demanding;
# every rung is bitwise-pinned to the same host oracle, so a downgraded
# call returns the identical CSC — it just moves more bytes to get there
DOWNGRADE = {"1d": ("1d",), "2d": ("2d", "1d"), "3d": ("3d", "2d", "1d")}


def structure_fingerprint(mat: CSC) -> bytes:
    """Digest of the sparsity *structure* only: shape + indptr + indices.

    Two matrices with equal fingerprints blockize to identical tile
    layouts, so they share plans, schedules and executables;
    values are deliberately excluded (they only affect payload contents).
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(mat.shape, dtype=np.int64).tobytes())
    h.update(mat.indptr.tobytes())
    h.update(mat.indices.tobytes())
    return h.digest()


def values_fingerprint(mat: CSC) -> bytes:
    """Digest of the stored values (used to skip the payload repack when a
    structure-identical repeat also carries bit-identical values)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(mat.data.tobytes())
    return h.digest()


def as_payload_dtype(mat: CSC, dtype=np.float32) -> CSC:
    """Cast an operand's data to the session's payload dtype, explicitly.

    Sessions compute in ``dtype`` (default float32) regardless of the
    operand's host dtype; the cast used to happen silently inside
    blockization. Values-only repacks now *reject* dtype-mismatched
    operands (see :meth:`SpGEMMSession.matmul`), so iterated workloads
    whose host arithmetic runs in float64 (BC's σ/δ sweeps, MCL's
    inflation) cast at the call site — once, visibly — before handing
    operands to the session. A no-op (no copy) when the dtype already
    matches; structure is untouched either way, so cache keys are stable.
    """
    if np.dtype(mat.data.dtype) == np.dtype(dtype):
        return mat
    return mat.astype(dtype)


def session_or_new(session: Optional["SpGEMMSession"],
                   device=None) -> "SpGEMMSession":
    """App-facing helper: create a session on ``device``, or pass an
    existing one through. ``device=None`` means the session's own default,
    ``"cuda"``, which raises without a CUDA device. A supplied session
    already fixed its device at construction, so combining it with an
    explicit ``device`` would be silently ignored — refuse instead."""
    if session is None:
        return SpGEMMSession() if device is None else \
            SpGEMMSession(device=device)
    if device is not None:
        raise ValueError(
            "device is fixed when the session is created; construct "
            "SpGEMMSession(device=...) instead of passing device "
            "alongside an existing session")
    return session


class _Entry:
    """One cached (plan, executable, device args) triple.

    ``nbytes`` is the device footprint of the entry's argument stacks,
    fixed when the executable is built (values-only repacks swap same-shape
    payloads).
    """

    __slots__ = ("plan", "fn", "args", "decode", "repack", "val_fp",
                 "nbytes")

    def __init__(self, plan, fn, args: List, decode: Callable,
                 repack: Callable, val_fp: Tuple[bytes, bytes]):
        self.plan = plan
        self.fn = fn
        self.args = args
        self.decode = decode
        self.repack = repack
        self.val_fp = val_fp
        self.nbytes = sum(int(getattr(x, "nbytes", 0)) for x in args)

    def release(self) -> None:
        """Drop the device buffer references (the payload/schedule stacks in
        ``args``) and the executable so eviction actually returns
        device memory — an evicted entry kept alive by a stray reference
        must not pin its arrays."""
        self.args = []
        self.fn = None
        self.repack = None


class SpGEMMSession:
    """Persistent SpGEMM session over the device engines (1D/2D/3D) on one
    device.

    ``maxsize`` bounds the LRU entry count (each entry pins a plan, an
    executable and its device-resident payload stacks). ``device`` is
    ``"cuda"`` by default; without a CUDA device that raises at
    construction — the CPU runs only when asked for (``device="cpu"``).

    ``stats`` carries the cumulative ``device_common.SESSION_STATS``
    surface; ``last_call`` describes the most recent multiply::

        cache_hit      : served from the cache (no host planning)
        repacked       : values-only payload refresh performed
        plan_seconds   : host planning time spent by THIS call (0.0 on hit)
        comm_bytes_planned / comm_bytes_padded / messages / dense_flops :
                         the executed plan's stats surface
        algorithm      : the algorithm rung that actually served the call
        engine         : the engine rung that actually served the call
        requested_algorithm : what the caller asked for (== algorithm
                         unless the ladder downgraded)
        degraded       : served by a rung below the requested one
        retries        : per-stage retry attempts spent by THIS call

    Hardening knobs (all optional; defaults are production-shaped):

    ``validate``        — run :func:`validate_matmul_operands` at ingress.
    ``fault_injector``  — a :class:`runtime.faults.FaultInjector` fired at
                          the top of every stage attempt (tests/chaos).
    ``retry_policy``    — :class:`runtime.RetryPolicy` for per-stage
                          retries (exponential backoff + jitter).
    ``retry_sleep`` / ``retry_rng`` — injectable sleep/jitter source so
                          tier-1 tests never wall-clock-sleep.
    ``breaker_threshold`` — consecutive failures of one cache key before
                          its circuit opens and the rung fails fast.
    """

    def __init__(self, maxsize: int = 32, device="cuda", *,
                 validate: bool = True,
                 fault_injector=None,
                 retry_policy: Optional[RetryPolicy] = None,
                 retry_sleep: Callable[[float], None] = time.sleep,
                 retry_rng: Optional[np.random.Generator] = None,
                 breaker_threshold: int = 3):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        if breaker_threshold < 1:
            raise ValueError(f"breaker_threshold must be >= 1, "
                             f"got {breaker_threshold}")
        self.maxsize = maxsize
        self.device = resolve_device(device)
        self._kernel_built = False
        self.validate = validate
        self.fault_injector = fault_injector
        self.retry_policy = retry_policy if retry_policy is not None else \
            RetryPolicy(max_retries=2, backoff_s=0.05, backoff_mult=2.0,
                        jitter=0.25)
        self._retry_sleep = retry_sleep
        self._retry_rng = retry_rng
        self.breaker_threshold = breaker_threshold
        self._cache: "OrderedDict[tuple, _Entry]" = OrderedDict()
        # loop-invariant-operand blockize reuse inside the 1D planner (BC
        # re-plans the same adjacency against a fresh frontier every level)
        self._blockize_cache: dict = {}
        # circuit breaker: cache key -> consecutive stage failures; reset
        # on the first success, opened at breaker_threshold
        self._quarantine: dict = {}
        self.stats = {k: 0 for k in SESSION_STATS}
        self.stats["plan_seconds_saved"] = 0.0
        self.last_call: dict = {}

    # ---- internals --------------------------------------------------------

    def _count_trace(self):
        self.stats["traces"] += 1

    def _on_retry(self, attempt: int, exc: Exception) -> None:
        self.stats["retries"] += 1

    def _stage(self, stage: str, thunk: Callable, context: dict):
        """Run one pipeline stage: fault-injection point + retry/backoff,
        wrapping whatever survives retries into the stage's typed error."""

        def attempt():
            if self.fault_injector is not None:
                self.fault_injector.fire(stage)
            return thunk()

        try:
            return with_retries(attempt, self.retry_policy,
                                on_retry=self._on_retry,
                                sleep=self._retry_sleep,
                                rng=self._retry_rng)()
        except Exception as e:
            raise wrap_stage_error(stage, e, context) from e

    def _record_failure(self, key: tuple) -> None:
        """A rung failed on ``key``: bump its breaker count and quarantine
        any cached entry (drop + release buffers) so a poisoned
        plan/executable can never serve a later call."""
        self._quarantine[key] = self._quarantine.get(key, 0) + 1
        entry = self._cache.pop(key, None)
        if entry is not None:
            self.stats["bytes_cached"] -= entry.nbytes
            entry.release()
            self.stats["quarantined"] += 1

    def _evict_lru(self) -> None:
        """Evict least-recently-used entries until ``maxsize`` holds,
        releasing their device buffers and settling the byte ledger."""
        while len(self._cache) > self.maxsize:
            entry = self._cache.pop(next(iter(self._cache)))
            self.stats["evictions"] += 1
            self.stats["bytes_cached"] -= entry.nbytes
            entry.release()

    def _plan(self, a: CSC, b: CSC, algorithm: str, nparts: int, grid: int,
              layers: int, bs: int, nblocks: Optional[int],
              semiring: Semiring, dtype, chunk: Optional[int]):
        """Host planning only (the ``plan`` stage); returns
        (plan, decode, repack)."""
        from .spgemm_1d_device import (build_device_plan, decode_ring_output,
                                       repack_ring_payloads)
        from .spgemm_2d_device import (build_summa_plan, decode_summa_output,
                                       repack_summa_payloads)

        if algorithm == "1d":
            plan = build_device_plan(
                a, b, nparts, bs=bs, nblocks=nblocks, dtype=dtype,
                semiring=semiring, a_blockize_cache=self._blockize_cache,
                chunk=chunk)
            return plan, decode_ring_output, repack_ring_payloads
        plan = build_summa_plan(
            a, b, grid=grid, layers=layers if algorithm == "3d" else 1,
            bs=bs, dtype=dtype, semiring=semiring)
        return plan, decode_summa_output, repack_summa_payloads

    def _compile(self, plan, algorithm: str, engine: str):
        """Upload the plan and build the executable (the ``compile``
        stage); returns (fn, device args)."""
        from .spgemm_1d_device import compile_ring
        from .spgemm_2d_device import compile_summa

        compiler = compile_ring if algorithm == "1d" else compile_summa
        fn, args = compiler(plan, device=self.device, engine=engine,
                            trace_probe=self._count_trace)
        return fn, list(args)

    def _build_kernel(self) -> None:
        """Build the CUDA kernel once, outside the degradation ladder: a
        build failure raises rather than falling back to the plain
        version."""
        from ..kernels.bsr_spgemm.kernel import build

        if self._kernel_built:
            return
        try:
            build()
        except (RuntimeError, OSError) as e:
            raise DeviceExecError(f"the bsr_spgemm CUDA kernel failed to "
                                  f"build: {e}", stage="compile",
                                  context={"device": str(self.device)}) \
                from e
        self._kernel_built = True

    # ---- the one public multiply ------------------------------------------

    def matmul(self, a: CSC, b: CSC, *,
               algorithm: str = "1d",
               nparts: int = 1,
               grid: int = 1,
               layers: int = 1,
               bs: int = 32,
               nblocks: Optional[int] = None,
               semiring: Semiring = PLUS_TIMES,
               engine: str = "auto",
               dtype=np.float32,
               chunk: Optional[int] = None) -> CSC:
        """C = A ⊗ B on the device path, cached by structure.

        ``algorithm`` selects the engine, each run as logical parts on the
        session's device: ``"1d"`` (the sparsity-aware ring, geometry
        ``nparts``), ``"2d"`` (sparse SUMMA, geometry ``grid``×``grid``) or
        ``"3d"`` (Split-3D, geometry ``grid``×``grid``×``layers``). A 2d or
        3d call whose rung keeps failing downgrades (3d→2d→1d); a
        downgraded 1d rung gets ``grid*grid`` ring parts, a downgraded 2d
        rung keeps the grid.

        On a CUDA device with the kernel engine, ``bs`` must be one the
        kernel takes (``KERNEL_BS``); any other is a :class:`ValidationError`
        at ingress.

        ``chunk`` selects the ring's k-chunk pipeline (ring steps per
        fetched chunk; ``None`` = single-pass ring). It is part of the
        cache key — chunked and unchunked plans build different bodies —
        and is ignored by the 2d/3d engines, exactly like ``nblocks``.
        """
        if algorithm not in ALGORITHMS:
            raise ValueError(
                f"algorithm must be one of {ALGORITHMS}, got {algorithm!r}")
        if chunk is not None and (not isinstance(chunk, int) or chunk < 1):
            raise ValueError(
                f"chunk must be a positive int or None, got {chunk!r}")
        from ..kernels.bsr_spgemm.kernel import KERNEL_BS

        engine = resolve_engine(engine, self.device)
        on_card = engine == "cuda" and self.device.type == "cuda"
        self.stats["calls"] += 1
        try:
            if self.validate:
                validate_matmul_operands(a, b, semiring=semiring)
            if on_card and bs not in KERNEL_BS:
                raise ValidationError(
                    f"the CUDA kernel takes bs in {KERNEL_BS}, got {bs}",
                    stage="validate", context={"bs": bs, "engine": engine})
        except ValidationError:
            self.stats["validation_failures"] += 1
            raise
        if on_card:
            self._build_kernel()

        # the degradation ladder: engine fallback cuda→torch inside each
        # algorithm rung, for CPU tensors only (there the cuda engine's
        # wrapper runs the plain version anyway), then algorithm downgrade.
        # On the card every rung runs the kernel, so a launch failure is
        # never served by the plain version. Every rung is bitwise
        # oracle-equivalent on integer-valued inputs.
        rungs = []
        for alg in DOWNGRADE[algorithm]:
            rungs.append((alg, engine))
            if engine == "cuda" and not on_card:
                rungs.append((alg, "torch"))

        retries_before = self.stats["retries"]
        last_err: Optional[SpGEMMError] = None
        for i, (alg_r, eng_r) in enumerate(rungs):
            try:
                c, info = self._run_rung(a, b, alg_r, eng_r, algorithm,
                                         nparts, grid, layers, bs, nblocks,
                                         semiring, dtype, chunk)
            except ValidationError:
                # an ingress rejection (e.g. a dtype-mismatched values-only
                # repack) is deterministic: every rung would refuse it the
                # same way — and a colder rung would *accept* it by planning
                # fresh with the silent cast the rejection exists to stop.
                # The ladder is for device/stage failures, not bad requests.
                raise
            except SpGEMMError as e:
                last_err = e
                if i + 1 < len(rungs):
                    self.stats["fallbacks"] += 1
                continue
            s = info["plan_stats"]
            self.last_call = dict(
                cache_hit=info["cache_hit"], repacked=info["repacked"],
                algorithm=alg_r, engine=eng_r,
                requested_algorithm=algorithm, degraded=i > 0,
                retries=self.stats["retries"] - retries_before,
                plan_seconds=info["plan_seconds"],
                comm_bytes_planned=s["comm_bytes_planned"],
                comm_bytes_padded=s["comm_bytes_padded"],
                messages=s["messages"], dense_flops=s["dense_flops"])
            return c
        raise last_err

    def _run_rung(self, a: CSC, b: CSC, algorithm: str, engine: str,
                  requested: str, nparts: int, grid: int, layers: int,
                  bs: int, nblocks: Optional[int], semiring: Semiring,
                  dtype, chunk: Optional[int] = None) -> Tuple[CSC, dict]:
        """One rung of the ladder: serve the multiply with a fixed
        (algorithm, engine), all four stages under retry + typed wrapping.

        A downgraded 1d rung inherits the 2d/3d call's part budget
        (``grid*grid`` ring parts); a downgraded 2d rung keeps the grid and
        collapses the layers. The key keeps the reference's layout.
        """
        if algorithm == "1d":
            geom = (nparts if requested == "1d" else grid * grid,)
        else:
            geom = (grid, layers if algorithm == "3d" else 1)
        # nblocks and chunk are 1D-ring knobs (Algorithm-2 fetch grouping /
        # the chunked pipeline); the SUMMA planners have neither, so they
        # must not split byte-identical 2d/3d plans into distinct entries
        key = (algorithm, geom, bs,
               nblocks if algorithm == "1d" else None,
               chunk if algorithm == "1d" else None,
               semiring.name, engine, np.dtype(dtype).str,
               structure_fingerprint(a), structure_fingerprint(b))
        ctx = {"algorithm": algorithm, "engine": engine,
               "requested_algorithm": requested}
        failures = self._quarantine.get(key, 0)
        if failures >= self.breaker_threshold:
            raise DeviceExecError(
                "circuit breaker open: this plan-cache key failed "
                f"{failures} consecutive times", stage="execute",
                context=ctx)

        entry = self._cache.get(key)
        hit = entry is not None
        repacked = False
        plan_seconds = 0.0
        try:
            if hit:
                val_fp = (values_fingerprint(a), values_fingerprint(b))
                if val_fp != entry.val_fp:
                    # values-only repacks blockize straight into the plan's
                    # payload stacks; a dtype-mismatched operand would be
                    # cast silently (float64 values narrowed into a
                    # float32-keyed entry) and still count as a cache hit —
                    # reject at ingress instead, before anything mutates
                    mism = [
                        f"operand {nm} has data dtype "
                        f"{np.dtype(m.data.dtype).name}"
                        for nm, i, m in (("a", 0, a), ("b", 1, b))
                        if val_fp[i] != entry.val_fp[i]
                        and np.dtype(m.data.dtype) != np.dtype(dtype)]
                    if mism:
                        self.stats["validation_failures"] += 1
                        raise ValidationError(
                            "dtype-mismatched values-only repack: "
                            + "; ".join(mism)
                            + f" but the cached plan's payloads are "
                            f"{np.dtype(dtype).name} — repacking would "
                            "silently narrow the values; cast the operand "
                            "or request a matching dtype=",
                            stage="repack", context=ctx)
                self._cache.move_to_end(key)
                self.stats["plan_cache_hits"] += 1
                self.stats["plan_seconds_saved"] += \
                    entry.plan.stats["plan_seconds"]
                if val_fp != entry.val_fp:
                    # values-only path: refill payload stacks, keep the
                    # plan, the schedules and the executable — and
                    # only for the side(s) whose values actually changed
                    # (BC's backward sweep keeps the adjacency operand
                    # bit-identical while the frontier moves every level).
                    # A mid-repack failure quarantines the entry, so a
                    # half-swapped payload stack can never serve a call.
                    def do_repack():
                        new_a, new_b = entry.repack(
                            entry.plan,
                            a if val_fp[0] != entry.val_fp[0] else None,
                            b if val_fp[1] != entry.val_fp[1] else None)
                        # the stacks arrive in the plan's layout; the
                        # executable's may be their flat view
                        if new_a is not None:
                            entry.args[0] = torch.from_numpy(new_a).to(
                                self.device).reshape(entry.args[0].shape)
                        if new_b is not None:
                            entry.args[1] = torch.from_numpy(new_b).to(
                                self.device).reshape(entry.args[1].shape)

                    self._stage("repack", do_repack, ctx)
                    entry.val_fp = val_fp
                    self.stats["payload_repacks"] += 1
                    repacked = True
            else:
                t0 = time.perf_counter()
                plan, decode, repack = self._stage(
                    "plan",
                    lambda: self._plan(a, b, algorithm, geom[0], grid,
                                       layers, bs, nblocks, semiring,
                                       dtype, chunk),
                    ctx)
                fn, args = self._stage(
                    "compile",
                    lambda: self._compile(plan, algorithm, engine), ctx)
                plan_seconds = time.perf_counter() - t0
                entry = _Entry(plan, fn, args, decode, repack,
                               (values_fingerprint(a),
                                values_fingerprint(b)))

            def do_execute():
                return entry.decode(entry.plan, entry.fn(*entry.args))

            c = self._stage("execute", do_execute, ctx)
        except ValidationError:
            # ingress rejection of a malformed request: the cached entry is
            # healthy and untouched — quarantining it (or bumping its
            # breaker) would punish the cache for the caller's operand
            raise
        except SpGEMMError:
            self._record_failure(key)
            raise
        # success: only now may a cold entry enter the cache — a plan that
        # never executed cleanly is never cached, so injected faults can't
        # poison it — and the key's breaker resets
        if not hit:
            self.stats["plan_cache_misses"] += 1
            self._cache[key] = entry
            self.stats["bytes_cached"] += entry.nbytes
            self._evict_lru()
        self._quarantine.pop(key, None)
        return c, dict(cache_hit=hit, repacked=repacked,
                       plan_seconds=plan_seconds,
                       plan_stats=entry.plan.stats)

    # ---- maintenance ------------------------------------------------------

    def __len__(self) -> int:
        return len(self._cache)

    def clear(self) -> None:
        """Drop every cached plan/executable, releasing the device buffer
        references each entry pinned (stats are kept; breakers reset)."""
        for entry in self._cache.values():
            entry.release()
        self._cache.clear()
        self._blockize_cache.clear()
        self._quarantine.clear()
        self.stats["bytes_cached"] = 0
