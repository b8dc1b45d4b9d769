"""The port's multi-tenant SpGEMM service against the reference's, on the CPU.

* A twin of each of the reference's ``tests/test_spgemm_service.py`` cases
  (``device="cpu"``: the plain versions), on integer-valued graphs at
  n <= 96 and bs 16, results bitwise against the port's host oracle
  (``spgemm_1d``).
* A differential stream: one seeded mixed workload (3 tenants; a shared
  structure, its per-tenant reweighted twins and distinct structures; all
  three semirings; a tenant quota; a fault injector on the session while
  one tenant's requests drain, which opens that tenant's breaker; its
  cooldown on the injectable clock) through the reference's
  ``SpGEMMService`` and the port's, each with its own fake clock, at
  ``algorithm="1d", nparts=1`` (the reference's in-process limit). Per
  ticket ``ok``, ``rejected``, ``coalesced``, ``leader``, ``cache_hit``,
  ``call_stats["repacked"]`` and the CSC bitwise; the ``SERVICE_STATS``
  equal but for the latencies. Trace counts are not compared.
* Port-only geometries (``nparts=4``, 2D SUMMA, Split-3D) through the
  service, coalescing across tenants and ring knobs, bitwise against the
  port's host ``local_spgemm`` and ``spgemm_1d``.
* A kernel build failure on a card surfaces as a failed result carrying a
  typed ``DeviceExecError``, with no fallback.
* ``repro_torch.launch.serve_spgemm.main([... "--device", "cpu"])`` exits 0
  and prints every ``SERVICE_STATS`` key.
"""

import numpy as np
import pytest
import torch

from repro.core.sparse import CSC as RCSC
from repro.core.semiring import by_name as r_by_name
from repro.runtime.faults import FaultInjector as RFaultInjector
from repro.serve import SERVICE_STATS as R_SERVICE_STATS
from repro.serve import ServicePolicy as RPolicy
from repro.serve import SpGEMMRequest as RRequest
from repro.serve import SpGEMMService as RService
from repro_torch.core.local_spgemm import spgemm as host_spgemm
from repro_torch.core.semiring import by_name
from repro_torch.core.session import SpGEMMSession
from repro_torch.core.sparse import banded_clustered, erdos_renyi
from repro_torch.core.spgemm_1d import spgemm_1d
from repro_torch.core.validate import DeviceExecError, ValidationError
from repro_torch.runtime.faults import FaultInjector
from repro_torch.serve import (SERVICE_STATS, ServicePolicy, SpGEMMRequest,
                               SpGEMMService, TenantOverloadError)


class Clock:
    """Manual monotonic clock: ``tick`` advances per call (0 = frozen)."""

    def __init__(self, tick=0.0):
        self.now = 0.0
        self.tick = tick

    def __call__(self):
        self.now += self.tick
        return self.now

    def advance(self, dt):
        self.now += dt


def _graph(n=96, d=4.0, seed=0):
    g = banded_clustered(n, max(n // 16, 4), d, seed=seed)
    g.data[:] = np.rint(2 * g.data)
    g.data[g.data == 0] = 1.0
    return g.astype(np.float32)


def _distinct(i, n=64):
    g = erdos_renyi(n, n, 3.0, seed=100 + i)
    g.data[:] = 1.0
    return g.astype(np.float32)


def _oracle(g):
    return spgemm_1d(g, g, 1).concat().prune(0.0).astype(np.float32)


def _bad():
    return erdos_renyi(48, 32, 3.0, seed=7).astype(np.float32)   # 48x32


def _service(**kw):
    return SpGEMMService(device="cpu", **kw)


def _assert_bitwise(c, want):
    np.testing.assert_array_equal(c.indptr, want.indptr)
    np.testing.assert_array_equal(c.indices, want.indices)
    assert c.data.dtype == want.data.dtype
    assert c.data.tobytes() == want.data.tobytes()


@pytest.fixture(scope="module")
def shared_graph():
    return _graph()


def test_service_stats_surface_pinned():
    assert SERVICE_STATS == R_SERVICE_STATS
    svc = _service()
    assert tuple(svc.stats()) == SERVICE_STATS
    g = _distinct(0)
    svc.serve([SpGEMMRequest(tenant="a", a=g, b=g, bs=16)])
    assert tuple(svc.stats()) == SERVICE_STATS


def test_cross_tenant_coalescing_one_build_n_results(shared_graph):
    """N requests for the same structure+values from DIFFERENT tenants
    cost one session multiply — one plan, one executable build — and every
    caller gets the bitwise-identical decoded result."""
    g = shared_graph
    svc = _service()
    results = svc.serve([SpGEMMRequest(tenant=t, a=g, b=g, bs=16)
                         for t in ("alice", "bob", "carol", "alice")])
    assert all(r.ok for r in results)
    assert [r.leader for r in results] == [True, False, False, False]
    assert all(r.coalesced for r in results)
    want = _oracle(g)
    for r in results:
        _assert_bitwise(r.value, want)
    sess = svc.session.stats
    assert sess["traces"] == 1 and sess["plan_cache_misses"] == 1
    st = svc.stats()
    assert st["requests"] == 4 and st["served"] == 4
    assert st["coalesced"] == 3
    assert st["coalesce_rate"] == pytest.approx(0.75)


def test_values_variant_rides_repack_path(shared_graph):
    """Same structure, different values: a separate coalescing group that
    reuses the cached plan/executable via the session's values-only
    repack — no second build, no second planning pass."""
    g = shared_graph
    jit = g.astype(np.float32)
    jit.data[:] = g.data + 1.0
    svc = _service()
    first = svc.serve([SpGEMMRequest(tenant="alice", a=g, b=g, bs=16)])[0]
    second = svc.serve([SpGEMMRequest(tenant="bob", a=jit, b=jit,
                                      bs=16)])[0]
    assert first.ok and second.ok
    assert not second.coalesced
    assert second.cache_hit and second.call_stats["repacked"]
    sess = svc.session.stats
    assert sess["traces"] == 1 and sess["payload_repacks"] == 1
    assert sess["plan_cache_misses"] == 1
    _assert_bitwise(second.value, _oracle(jit))


def test_tenant_quota_evicts_only_that_tenant():
    """tenant_quota bounds entries per tenant, LRU-first, and the
    eviction is attributed to the owning tenant — another tenant's
    cached plans are untouched."""
    svc = _service(policy=ServicePolicy(tenant_quota=2))
    gb = _distinct(9)
    assert svc.serve([SpGEMMRequest(tenant="b", a=gb, b=gb, bs=16)])[0].ok
    for i in range(3):
        g = _distinct(i)
        assert svc.serve([SpGEMMRequest(tenant="a", a=g, b=g,
                                        bs=16)])[0].ok
    assert svc.session.cached_entries("a") == 2
    assert svc.session.cached_entries("b") == 1
    assert svc.stats()["evictions_by_tenant"] == {"a": 1}
    g0 = _distinct(0)
    r = svc.serve([SpGEMMRequest(tenant="a", a=g0, b=g0, bs=16)])[0]
    assert r.ok and not r.cache_hit
    g2 = _distinct(2)
    r = svc.serve([SpGEMMRequest(tenant="a", a=g2, b=g2, bs=16)])[0]
    assert r.ok and r.cache_hit


def test_global_byte_budget_bounds_cache():
    """max_bytes evicts LRU-first but always keeps the newest entry, so
    an oversized multiply still serves; bytes_cached tracks the tensors of
    what actually stays resident."""
    svc = _service(policy=ServicePolicy(max_bytes=1))
    for i in range(3):
        g = _distinct(i)
        assert svc.serve([SpGEMMRequest(tenant="a", a=g, b=g,
                                        bs=16)])[0].ok
    assert svc.session.cached_entries() == 1
    assert sum(svc.stats()["evictions_by_tenant"].values()) == 2
    assert svc.session.cached_bytes() > 0
    assert svc.session.stats["bytes_cached"] == svc.session.cached_bytes()


def test_breaker_opens_per_tenant_and_recovers():
    """Tenant A's failures open A's breaker only; while open, A is
    rejected at admission (typed TenantOverloadError, never raised); the
    cooldown elapsing on the injectable clock half-opens it and one
    success closes it."""
    clk = Clock()
    svc = _service(policy=ServicePolicy(breaker_threshold=2,
                                        breaker_cooldown_s=10.0), clock=clk)
    g = _graph(64)
    bad = _bad()
    for _ in range(2):
        r = svc.serve([SpGEMMRequest(tenant="a", a=bad, b=bad, bs=16)])[0]
        assert not r.ok and isinstance(r.error, ValidationError)
    assert svc.breaker_state("a") == "open"
    assert svc.breaker_state("b") == "closed"
    r = svc.serve([SpGEMMRequest(tenant="a", a=g, b=g, bs=16)])[0]
    assert r.rejected and not r.ok and r.value is None
    assert isinstance(r.error, TenantOverloadError)
    assert r.error.stage == "admit"
    r = svc.serve([SpGEMMRequest(tenant="b", a=g, b=g, bs=16)])[0]
    assert r.ok and not r.rejected
    _assert_bitwise(r.value, _oracle(g))
    clk.advance(10.0)
    assert svc.breaker_state("a") == "half_open"
    r = svc.serve([SpGEMMRequest(tenant="a", a=g, b=g, bs=16)])[0]
    assert r.ok and svc.breaker_state("a") == "closed"
    st = svc.stats()
    assert (st["failed"], st["rejected_breaker"], st["served"],
            st["requests"]) == (2, 1, 2, 5)


def test_failure_charges_every_group_member():
    """A coalesced group that fails charges each member's tenant breaker
    — riders share the outcome, not just the leader."""
    svc = _service(policy=ServicePolicy(breaker_threshold=1,
                                        breaker_cooldown_s=5.0),
                   clock=Clock())
    bad = _bad()
    results = svc.serve([SpGEMMRequest(tenant=t, a=bad, b=bad, bs=16)
                         for t in ("a", "b")])
    assert not any(r.ok for r in results)
    assert svc.breaker_state("a") == "open"
    assert svc.breaker_state("b") == "open"


def test_prefetch_warms_the_plan(shared_graph):
    g = shared_graph
    svc = _service()
    assert svc.prefetch("alice", g, g, bs=16)
    r = svc.serve([SpGEMMRequest(tenant="alice", a=g, b=g, bs=16)])[0]
    assert r.ok and r.cache_hit
    assert r.call_stats["plan_seconds"] == 0.0
    assert svc.stats()["prefetched"] == 1


def test_prefetch_failure_counts_against_breaker():
    svc = _service(policy=ServicePolicy(breaker_threshold=1,
                                        breaker_cooldown_s=5.0),
                   clock=Clock())
    bad = _bad()
    assert not svc.prefetch("a", bad, bad, bs=16)
    assert svc.breaker_state("a") == "open"


def test_latency_on_injectable_clock(shared_graph):
    """One tick between a group's start and finish, shared by every
    member of the group."""
    g = shared_graph
    svc = _service(clock=Clock(tick=1.0))
    results = svc.serve([SpGEMMRequest(tenant=t, a=g, b=g, bs=16)
                         for t in ("alice", "bob")])
    assert [r.latency_s for r in results] == [1.0, 1.0]
    st = svc.stats()
    assert st["latency_p50_s"] == 1.0 and st["latency_p99_s"] == 1.0


def test_coalesce_disabled_serves_per_request(shared_graph):
    g = shared_graph
    svc = _service(policy=ServicePolicy(coalesce=False))
    results = svc.serve([SpGEMMRequest(tenant="a", a=g, b=g, bs=16)
                         for _ in range(3)])
    assert all(r.ok and not r.coalesced and r.leader for r in results)
    st = svc.stats()
    assert st["coalesced"] == 0 and st["cache_hits"] == 2


def test_byo_session_rejects_stale_kwargs():
    sess = SpGEMMSession(device="cpu", tenant_quota=4)
    svc = SpGEMMService(session=sess)
    assert svc.session is sess
    with pytest.raises(ValueError):
        SpGEMMService(session=sess, device="cpu")
    with pytest.raises(ValueError):
        SpGEMMService(session=sess, max_retries=2)


def test_serve_empty_batch():
    svc = _service()
    assert svc.serve([]) == []
    assert svc.run_pending() == {}


# ---- the differential stream ----------------------------------------------


def _stream():
    """The seeded mixed workload as drains of (tenant, operand name,
    semiring) requests, each drain in a seeded order, plus the operands:
    ``shared`` (banded, integer values), ``twin{i}`` (its structure, values
    + i + 1: tenant i's reweighted copy), ``d{j}`` (distinct structures).
    Drain 2 runs with the fault injector on and holds only tenant t2's
    requests; its breaker (threshold 2) opens, drain 3 rejects it, and
    drain 4 comes after the cooldown."""
    rng = np.random.default_rng(42)
    ops = {"shared": _graph(48, seed=1)}
    for i in range(3):
        t = ops["shared"].astype(np.float32)
        t.data[:] = ops["shared"].data + float(i + 1)
        ops[f"twin{i}"] = t
    for j in range(5):
        ops[f"d{j}"] = _distinct(j, n=40)
    pt, bo, mp = "plus_times", "bool_or_and", "min_plus"
    drains = [
        [(f"t{i}", op, sr) for i in range(3)
         for op, sr in (("shared", pt), ("shared", pt), (f"twin{i}", pt),
                        ("shared", bo), ("shared", mp), (f"d{i}", pt))],
        [("t1", "d3", pt), ("t1", "d4", pt), ("t0", "twin0", mp),
         ("t1", "shared", pt)],
        [("t2", "d2", pt), ("t2", "twin2", mp)],
        [(f"t{i}", op, pt) for i in range(3)
         for op in ("shared", f"twin{i}")],
        [("t2", "d2", pt), ("t0", "d0", bo), ("t1", "d3", pt)],
    ]
    return ops, [[d[k] for k in rng.permutation(len(d))] for d in drains]


def _to_reference(m):
    return RCSC(m.indptr.copy(), m.indices.copy(), m.data.copy(), m.shape)


def _run_stream(svc, make_request, to_csc, make_injector, clock, ops,
                drains):
    """Drive one service through the stream; returns per ticket the
    compared fields and the service's stats."""
    svc.prefetch("t0", to_csc(ops["shared"]), to_csc(ops["shared"]), bs=16)
    tickets, results = [], {}
    for k, drain in enumerate(drains):
        svc.session.fault_injector = make_injector() if k == 2 else None
        if k == 4:
            clock.advance(10.0)
        for tenant, op, sr in drain:
            tickets.append(svc.submit(make_request(
                tenant=tenant, a=to_csc(ops[op]), b=to_csc(ops[op]),
                semiring=sr, bs=16)))
        results.update(svc.run_pending())
    assert sorted(results) == tickets
    out = []
    for r in (results[t] for t in tickets):
        row = dict(tenant=r.tenant, ok=r.ok, rejected=r.rejected,
                   coalesced=r.coalesced, leader=r.leader,
                   cache_hit=r.cache_hit,
                   repacked=r.call_stats.get("repacked"),
                   error=None if r.error is None else type(r.error).__name__)
        if r.ok:
            row["csc"] = (r.value.shape, r.value.indptr.tobytes(),
                          r.value.indices.tobytes(),
                          r.value.data.astype(np.float32).tobytes())
        out.append(row)
    return out, svc.stats()


def test_differential_stream_matches_the_reference():
    ops, drains = _stream()
    policy = dict(tenant_quota=2, breaker_threshold=2,
                  breaker_cooldown_s=10.0)
    no_sleep = dict(retry_sleep=lambda _: None)
    runs = []
    for make_svc, make_request, to_csc, make_injector, by in (
            (lambda clk: RService(policy=RPolicy(**policy), clock=clk,
                                  **no_sleep),
             RRequest, _to_reference,
             lambda: RFaultInjector(seed=0, rates={"execute": 1.0}),
             r_by_name),
            (lambda clk: SpGEMMService(policy=ServicePolicy(**policy),
                                       clock=clk, device="cpu", **no_sleep),
             SpGEMMRequest, lambda m: m,
             lambda: FaultInjector(seed=0, rates={"execute": 1.0}),
             by_name)):
        clk = Clock()

        def request(semiring, by=by, make_request=make_request, **kw):
            return make_request(semiring=by(semiring), **kw)

        runs.append(_run_stream(make_svc(clk), request, to_csc,
                                make_injector, clk, ops, drains))
    (want, want_stats), (got, got_stats) = runs
    assert len(got) == len(want) == sum(map(len, drains))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"ticket {i}"
    # the stream exercised what it is for
    assert sum(r["ok"] for r in got) > 20
    assert any(r["rejected"] for r in got)
    assert sum(r["error"] == "DeviceExecError" for r in got) == 2
    assert any(r["repacked"] for r in got)
    assert any(r["coalesced"] and not r["leader"] for r in got)
    for key in SERVICE_STATS:
        if not key.startswith("latency"):
            assert got_stats[key] == want_stats[key], key
    assert got_stats["evictions_by_tenant"].get("t1", 0) >= 1


# ---- port-only geometries ------------------------------------------------


@pytest.mark.parametrize("kw,semiring", [
    (dict(algorithm="1d", nparts=4), "plus_times"),
    (dict(algorithm="2d", grid=2), "bool_or_and"),
    (dict(algorithm="3d", grid=2, layers=2), "min_plus")])
def test_geometries_coalesce_and_are_bitwise(kw, semiring):
    """Three tenants' requests for one structure coalesce into one
    multiply on the geometry; a 2d/3d request carrying ring knobs
    (nparts, nblocks, chunk) joins the same group, as it hits the same
    session entry; the result is bitwise the host oracle's."""
    g = _graph(96, seed=3)
    sr = by_name(semiring)
    svc = _service()
    reqs = [SpGEMMRequest(tenant=t, a=g, b=g, semiring=sr, bs=16, **kw)
            for t in ("a", "b", "c")]
    if kw["algorithm"] != "1d":
        reqs.append(SpGEMMRequest(tenant="d", a=g, b=g, semiring=sr, bs=16,
                                  nparts=3, nblocks=7, chunk=2, **kw))
    results = svc.serve(reqs)
    assert all(r.ok and r.coalesced for r in results)
    assert sum(r.leader for r in results) == 1
    assert results[0].call_stats["algorithm"] == kw["algorithm"]
    assert not results[0].call_stats["degraded"]
    want = host_spgemm(g, g, sr).astype(np.float32)
    if semiring != "min_plus":          # min-plus keeps its zero sums
        want = want.prune(0.0)
    if semiring == "plus_times":
        _assert_bitwise(want, _oracle(g))
    for r in results:
        _assert_bitwise(r.value, want)
    assert svc.session.stats["plan_cache_misses"] == 1


def test_kernel_build_failure_is_a_failed_result(monkeypatch):
    """On a card a kernel that does not build surfaces as a failed
    ServedResult carrying a typed DeviceExecError (no plain version stands
    in), charged to the tenant's breaker; the other tenants' requests in
    the drain fail the same way, each charged to its own breaker."""
    import repro_torch.kernels.bsr_spgemm.kernel as bk

    def broken():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(bk, "build", broken)
    sess = SpGEMMSession(device="cpu", retry_sleep=lambda _: None)
    sess.device = torch.device("cuda", 0)
    svc = SpGEMMService(session=sess,
                        policy=ServicePolicy(breaker_threshold=1))
    g = _graph(64)
    results = svc.serve([SpGEMMRequest(tenant="a", a=g, b=g, bs=16)])
    assert not results[0].ok and results[0].value is None
    assert isinstance(results[0].error, DeviceExecError)
    assert "nvcc failed" in str(results[0].error)
    assert svc.breaker_state("a") == "open"
    assert svc.stats()["failed"] == 1


def test_launcher_runs_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve_spgemm

    seen = []

    class Recording(SpGEMMService):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)

    monkeypatch.setattr(serve_spgemm, "SpGEMMService", Recording)
    assert serve_spgemm.main(["--n", "96", "--tenants", "3", "--requests",
                              "4", "--bs", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for key in SERVICE_STATS:
        assert f"  {key} " in out, key
    assert "wave 0: 12/12 served" in out and "wave 1: 12/12 served" in out
    assert "bsr_spgemm launches by route: tc 0, warp 0, minplus 0" in out
    svc, = seen
    st = svc.stats()
    assert (st["served"], st["failed"], st["prefetched"]) == (24, 0, 1)
    # every group after the prefetch hit its plan; the twins repacked
    assert st["cache_hit_rate"] == 1.0
    assert svc.session.stats["payload_repacks"] >= 3
