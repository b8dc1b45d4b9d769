"""SpGEMM-as-a-service: a request-driven multi-tenant layer over sessions.

The port's counterpart of ``repro.serve.spgemm_service``. The paper's
workloads — graph algorithms, AMG setup, randomized sketching — are exactly
the shape where many callers repeatedly multiply against the same shared
structure (a social graph, a mesh operator), so the 1D algorithm's plan
reuse pays off at *serving* scale: sustained throughput under concurrent
mixed load, not one multiply's latency.

:class:`SpGEMMService` is that layer, built strictly on top of
:class:`~repro_torch.core.session.SpGEMMSession`: the service never plans
or builds an executable itself.

  * **admission queue** — :meth:`submit` accepts
    ``SpGEMMRequest(tenant, a, b, semiring, algorithm, ...)`` and returns
    a ticket; :meth:`run_pending` drains the queue and returns a
    ``{ticket: ServedResult}`` map (:meth:`serve` is the submit+drain
    convenience for a whole batch).
  * **fingerprint coalescing** — queued requests are grouped by execution
    key (algorithm, geometry, semiring, dtype, *structure and values
    fingerprints*): N concurrent callers multiplying the same shared
    graph cost ONE session multiply — one plan, one executable — and all
    N receive the same decoded result. Same structure with different
    values is a separate group that rides the session's values-only
    repack path on the shared cached plan.
  * **per-tenant budgets** — cold entries a tenant creates are tagged
    with its name; the session's ``tenant_quota`` / ``tenant_max_bytes``
    / ``max_bytes`` LRU budgets bound device memory, and the service
    attributes every eviction per tenant (``evictions_by_tenant``).
  * **warm-plan prefetch** — :meth:`prefetch` pre-builds (and caches) the
    plan/executable for a declared structure, so a tenant's first real
    request is already a cache hit.
  * **failure routing** — whatever escapes the session's typed-error
    retry/degradation ladder (a refused bs at ingress, a kernel build or
    launch failure as a :class:`~repro_torch.core.validate.DeviceExecError`)
    is returned as a failed :class:`ServedResult` (never raised through the
    drain loop), recorded against the *requesting tenant's* circuit breaker
    (:class:`~repro_torch.runtime.fault_tolerance.CircuitBreaker`): a
    tenant whose requests keep failing is rejected at admission until its
    cooldown elapses, and tenant A's faults never open tenant B's breaker.
  * **telemetry** — :meth:`stats` exports exactly the
    :data:`SERVICE_STATS` surface (p50/p99 latency, coalesce rate, cache
    hit rate, bytes moved planned/padded, per-tenant evictions).

All timing runs on an injectable ``clock`` (latencies, breaker cooldowns)
and the session's injectable retry sleep (backoff), so tests never wait on
wall time.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.semiring import PLUS_TIMES, Semiring
from ..core.session import (SpGEMMSession, structure_fingerprint,
                            values_fingerprint)
from ..core.sparse import CSC
from ..core.validate import SpGEMMError
from ..runtime.fault_tolerance import CircuitBreaker

__all__ = ["SERVICE_STATS", "ServicePolicy", "SpGEMMRequest", "ServedResult",
           "SpGEMMService", "TenantOverloadError"]

# the serving telemetry surface (the reference's keys, in its order):
#   requests            : tickets admitted (incl. later rejections)
#   served              : requests answered with a result
#   failed              : requests whose group's multiply failed (typed
#                         SpGEMMError after the session's ladder)
#   rejected_breaker    : requests refused at admission — tenant's circuit
#                         was open
#   coalesced           : requests served by another request's multiply
#                         (group size − 1, summed)
#   coalesce_rate       : coalesced / served
#   cache_hits          : executed groups served from the session's plan
#                         cache (no host planning)
#   cache_hit_rate      : cache_hits / executed groups
#   latency_p50_s / latency_p99_s : request latency percentiles on the
#                         injectable clock (a coalesced member's latency
#                         is its group's)
#   bytes_moved_planned / bytes_moved_padded : communication bytes of the
#                         executed plans, summed per executed group
#   prefetched          : warm-plan prefetches performed
#   evictions_by_tenant : {tenant: evictions} attributed via the session's
#                         on_evict hook (entry creator pays)
SERVICE_STATS = ("requests", "served", "failed", "rejected_breaker",
                 "coalesced", "coalesce_rate", "cache_hits",
                 "cache_hit_rate", "latency_p50_s", "latency_p99_s",
                 "bytes_moved_planned", "bytes_moved_padded",
                 "prefetched", "evictions_by_tenant")


@dataclasses.dataclass(frozen=True)
class ServicePolicy:
    """Admission/budget policy, fixed at service construction.

    ``tenant_quota`` / ``tenant_max_bytes`` / ``max_bytes`` forward to the
    session the service creates (ignored when a session is supplied — its
    own budgets stand). ``coalesce=False`` disables fingerprint grouping
    (every request is its own session call). Breaker knobs shape the
    per-tenant circuit breakers.
    """

    tenant_quota: Optional[int] = None
    tenant_max_bytes: Optional[int] = None
    max_bytes: Optional[int] = None
    coalesce: bool = True
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 30.0


@dataclasses.dataclass
class SpGEMMRequest:
    """One admission-queue entry: tenant + operands + execution knobs.

    The knobs mirror :meth:`SpGEMMSession.matmul`; ``nparts``, ``nblocks``
    and ``chunk`` are 1D-only and normalized away for 2d/3d in the
    execution key, exactly as the session's cache key does — requests that
    the session would serve from one entry must coalesce into one group.
    """

    tenant: str
    a: CSC
    b: CSC
    algorithm: str = "1d"
    semiring: Semiring = PLUS_TIMES
    nparts: int = 1
    grid: int = 1
    layers: int = 1
    bs: int = 32
    nblocks: Optional[int] = None
    chunk: Optional[int] = None
    dtype: type = np.float32
    engine: str = "auto"

    def exec_key(self) -> tuple:
        """Full coalescing key: two requests with equal keys are satisfied
        by one multiply (structure AND values fingerprints — values-only
        variants are distinct groups riding the repack path)."""
        is_1d = self.algorithm == "1d"
        return (self.algorithm,
                self.nparts if is_1d else None,
                self.grid, self.layers, self.bs,
                self.nblocks if is_1d else None,
                self.chunk if is_1d else None,
                self.semiring.name, self.engine,
                np.dtype(self.dtype).str,
                structure_fingerprint(self.a), structure_fingerprint(self.b),
                values_fingerprint(self.a), values_fingerprint(self.b))

    def matmul_kwargs(self) -> dict:
        return dict(algorithm=self.algorithm, semiring=self.semiring,
                    nparts=self.nparts, grid=self.grid, layers=self.layers,
                    bs=self.bs, nblocks=self.nblocks, chunk=self.chunk,
                    dtype=self.dtype, engine=self.engine)


@dataclasses.dataclass
class ServedResult:
    """Outcome of one admitted request.

    ``ok`` — a result was produced; ``value`` is the decoded CSC.
    ``rejected`` — refused at admission (open breaker); never executed.
    ``error`` — the typed :class:`SpGEMMError` for failed/rejected
    requests. ``coalesced`` — served by a group of size > 1; ``leader``
    — this request's multiply actually ran (False for riders).
    ``cache_hit`` / ``call_stats`` mirror the session's ``last_call``
    for the group's multiply; ``latency_s`` is measured on the service
    clock (shared across a group).
    """

    tenant: str
    ok: bool
    value: Optional[CSC] = None
    error: Optional[Exception] = None
    rejected: bool = False
    coalesced: bool = False
    leader: bool = False
    cache_hit: bool = False
    latency_s: float = 0.0
    call_stats: dict = dataclasses.field(default_factory=dict)


class TenantOverloadError(SpGEMMError):
    """Request refused at admission: the tenant's circuit breaker is open
    (too many consecutive failures; retry after the cooldown)."""


class SpGEMMService:
    """Request-driven multi-tenant SpGEMM service over one shared session.

    ``session`` — bring your own (its budgets stand), or None to have the
    service build one from ``policy`` on ``device`` (None: the session's
    default, ``"cuda"``, which raises without a CUDA device; ``"cpu"`` runs
    the plain versions) with any extra ``session_kwargs`` — fault
    injectors, retry policy, injectable retry sleep — forwarded to the
    constructor. ``device`` and ``session_kwargs`` beside a supplied
    session are refused: that session fixed them when it was built.
    ``clock`` — injectable monotonic-seconds source for latency
    accounting and breaker cooldowns.
    """

    def __init__(self, session: Optional[SpGEMMSession] = None, *,
                 policy: ServicePolicy = ServicePolicy(),
                 clock: Callable[[], float] = time.monotonic,
                 device=None,
                 **session_kwargs):
        self.policy = policy
        self.clock = clock
        if session is None:
            if device is not None:
                session_kwargs["device"] = device
            session = SpGEMMSession(
                max_bytes=policy.max_bytes,
                tenant_quota=policy.tenant_quota,
                tenant_max_bytes=policy.tenant_max_bytes,
                **session_kwargs)
        elif device is not None or session_kwargs:
            raise ValueError(
                "device/session kwargs are fixed when the session is "
                "created; construct the SpGEMMSession yourself or let the "
                "service build it")
        self.session = session
        self._evictions_by_tenant: Dict[str, int] = {}
        prev_hook = session.on_evict

        def _on_evict(owner, key, nbytes, _prev=prev_hook):
            name = owner if owner is not None else "<untagged>"
            self._evictions_by_tenant[name] = \
                self._evictions_by_tenant.get(name, 0) + 1
            if _prev is not None:
                _prev(owner, key, nbytes)

        session.on_evict = _on_evict
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._queue: List[Tuple[int, SpGEMMRequest]] = []
        self._rejected: Dict[int, ServedResult] = {}
        self._next_ticket = 0
        self._latencies: List[float] = []
        self._counts = {"requests": 0, "served": 0, "failed": 0,
                        "rejected_breaker": 0, "coalesced": 0,
                        "cache_hits": 0, "groups_executed": 0,
                        "prefetched": 0}
        self._bytes = {"planned": 0, "padded": 0}

    # ---- admission ---------------------------------------------------------

    def _breaker(self, tenant: str) -> CircuitBreaker:
        br = self._breakers.get(tenant)
        if br is None:
            br = CircuitBreaker(threshold=self.policy.breaker_threshold,
                                cooldown_s=self.policy.breaker_cooldown_s,
                                clock=self.clock)
            self._breakers[tenant] = br
        return br

    def breaker_state(self, tenant: str) -> str:
        """closed / open / half_open for ``tenant`` (closed if unseen)."""
        br = self._breakers.get(tenant)
        return br.state if br is not None else "closed"

    def submit(self, request: SpGEMMRequest) -> int:
        """Admit one request; returns its ticket.

        An open tenant breaker rejects here — fail-fast at admission, the
        queue never sees the request; the rejection is delivered through
        :meth:`run_pending` like any other outcome.
        """
        ticket = self._next_ticket
        self._next_ticket += 1
        self._counts["requests"] += 1
        if not self._breaker(request.tenant).allow():
            self._counts["rejected_breaker"] += 1
            self._rejected[ticket] = ServedResult(
                tenant=request.tenant, ok=False, rejected=True,
                error=TenantOverloadError(
                    f"tenant {request.tenant!r} circuit breaker is open "
                    f"(cooldown {self.policy.breaker_cooldown_s}s)",
                    stage="admit", context={"tenant": request.tenant}))
            return ticket
        self._queue.append((ticket, request))
        return ticket

    def prefetch(self, tenant: str, a: CSC, b: CSC, **knobs) -> bool:
        """Warm-plan prefetch: run one multiply for a declared structure so
        the plan/executable is cached before real traffic arrives (the
        session only caches entries that executed cleanly, so a prefetch
        is a full multiply whose result is discarded). Returns True if the
        plan is now warm; a failed prefetch counts against the tenant's
        breaker exactly like a failed request."""
        req = SpGEMMRequest(tenant=tenant, a=a, b=b, **knobs)
        self._counts["prefetched"] += 1
        try:
            self.session.matmul(req.a, req.b, tenant=tenant,
                                **req.matmul_kwargs())
        except SpGEMMError:
            self._breaker(tenant).record_failure()
            return False
        self._breaker(tenant).record_success()
        return True

    # ---- the drain loop ----------------------------------------------------

    def run_pending(self) -> Dict[int, ServedResult]:
        """Drain the admission queue: coalesce, execute one multiply per
        group through the session, deliver every outstanding outcome
        (including admission rejections) keyed by ticket."""
        batch, self._queue = self._queue, []
        out, self._rejected = self._rejected, {}

        groups: "OrderedDict[tuple, list]" = OrderedDict()
        for ticket, req in batch:
            # coalescing off → every ticket is its own group
            key = req.exec_key() if self.policy.coalesce else ("!", ticket)
            groups.setdefault(key, []).append((ticket, req))

        for members in groups.values():
            t0 = self.clock()
            _, leader = members[0]
            err: Optional[SpGEMMError] = None
            c = None
            try:
                c = self.session.matmul(leader.a, leader.b,
                                        tenant=leader.tenant,
                                        **leader.matmul_kwargs())
            except SpGEMMError as e:
                err = e
            latency = self.clock() - t0
            ok = err is None
            call = dict(self.session.last_call) if ok else {}
            if ok:
                self._counts["groups_executed"] += 1
                self._counts["served"] += len(members)
                self._counts["coalesced"] += len(members) - 1
                if call.get("cache_hit"):
                    self._counts["cache_hits"] += 1
                self._bytes["planned"] += int(
                    call.get("comm_bytes_planned", 0))
                self._bytes["padded"] += int(call.get("comm_bytes_padded", 0))
            else:
                self._counts["failed"] += len(members)
            for i, (ticket, req) in enumerate(members):
                br = self._breaker(req.tenant)
                if ok:
                    br.record_success()
                else:
                    br.record_failure()
                self._latencies.append(latency)
                out[ticket] = ServedResult(
                    tenant=req.tenant, ok=ok, value=c, error=err,
                    coalesced=len(members) > 1, leader=i == 0,
                    cache_hit=bool(call.get("cache_hit", False)),
                    latency_s=latency, call_stats=call)
        return out

    def serve(self, requests: Sequence[SpGEMMRequest]) -> List[ServedResult]:
        """Submit a batch and drain it: results in request order."""
        tickets = [self.submit(r) for r in requests]
        done = self.run_pending()
        return [done[t] for t in tickets]

    # ---- telemetry ---------------------------------------------------------

    def stats(self) -> dict:
        """The :data:`SERVICE_STATS` surface, computed from the counters."""
        n = self._counts
        lat = np.asarray(self._latencies, dtype=np.float64)
        served = n["served"]
        executed = n["groups_executed"]
        return {
            "requests": n["requests"],
            "served": served,
            "failed": n["failed"],
            "rejected_breaker": n["rejected_breaker"],
            "coalesced": n["coalesced"],
            "coalesce_rate": n["coalesced"] / served if served else 0.0,
            "cache_hits": n["cache_hits"],
            "cache_hit_rate":
                n["cache_hits"] / executed if executed else 0.0,
            "latency_p50_s":
                float(np.percentile(lat, 50)) if lat.size else 0.0,
            "latency_p99_s":
                float(np.percentile(lat, 99)) if lat.size else 0.0,
            "bytes_moved_planned": self._bytes["planned"],
            "bytes_moved_padded": self._bytes["padded"],
            "prefetched": n["prefetched"],
            "evictions_by_tenant": dict(self._evictions_by_tenant),
        }
