"""The port's SpGEMMSession against the reference's contract, on the CPU.

Pins the stats surface (the same ``SESSION_STATS`` keys as the reference),
structure-keyed caching (a hit builds no new executable; the reference's
key rules for 2d/3d), the values-only repack, the typed dtype rejection on
a repack, the degradation ladder (engine, then 3d→2d→1d) and the circuit
breaker under injected faults, the card's rules (no plain rung behind the
kernel on any algorithm rung, a bs the kernel does not take rejected at
ingress), the serving budgets (LRU order under a byte budget, an oversized
newest entry kept, per-tenant quota and bytes charged to the creator as
the reference charges them, the eviction hook's arguments and its chaining,
the tenant through a downgrade, an entry's bytes as the sum of its
tensors), and
the device rule (asking for ``"cuda"`` without a GPU raises). Results compare bitwise on
integer-valued operands (tolerance: none).
"""

import numpy as np
import pytest
import torch

import repro.core.device_common as rdc
import repro.runtime.fault_tolerance as rft
import repro.runtime.faults as rfaults
from repro.core.session import SpGEMMSession as RSession
from repro.core.sparse import erdos_renyi as r_erdos_renyi
from repro_torch.core import MIN_PLUS, PLUS_TIMES, erdos_renyi
from repro_torch.core.device_common import SESSION_STATS
from repro_torch.core.session import DOWNGRADE, SpGEMMSession
from repro_torch.core.spgemm_1d_device import (build_device_plan,
                                               run_device_spgemm)
from repro_torch.core.validate import (DeviceExecError, SpGEMMError,
                                       ValidationError)
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.runtime.faults import FaultInjector, InjectedFault


def _int_matrix(n=50, seed=3, mod=erdos_renyi):
    a = mod(n, n, 4.0, seed=seed)
    a.data[:] = np.rint(2 * a.data)
    a.data[a.data == 0] = 1.0
    return a.astype(np.float32)


def _assert_bitwise(c, ref):
    assert np.array_equal(c.indptr, ref.indptr)
    assert np.array_equal(c.indices, ref.indices)
    assert np.array_equal(c.data, ref.data)


def _cold(a, b, **kw):
    return run_device_spgemm(build_device_plan(a, b, **kw), device="cpu")


def test_stats_surfaces_equal_reference():
    assert SESSION_STATS == rdc.SESSION_STATS
    s = SpGEMMSession(device="cpu")
    assert tuple(s.stats) == SESSION_STATS
    r = RSession()
    a = _int_matrix()
    s.matmul(a, a, bs=16)
    r.matmul(r_erdos_renyi(50, 50, 4.0, seed=3), r_erdos_renyi(50, 50, 4.0,
                                                               seed=3),
             bs=16, engine="jnp")
    assert set(s.last_call) == set(r.last_call)
    assert set(s.stats) == set(r.stats)


@pytest.mark.parametrize("chunk", [None, 2])
def test_hit_builds_nothing_and_is_bitwise(chunk):
    a = _int_matrix()
    s = SpGEMMSession(device="cpu")
    c1 = s.matmul(a, a, nparts=4, bs=16, chunk=chunk)
    assert s.stats["plan_cache_misses"] == 1 and s.stats["traces"] == 1
    assert s.last_call["plan_seconds"] > 0
    c2 = s.matmul(a, a, nparts=4, bs=16, chunk=chunk)
    assert s.last_call["cache_hit"] and s.last_call["plan_seconds"] == 0.0
    assert s.stats["traces"] == 1                      # zero new builds
    assert s.stats["plan_seconds_saved"] > 0
    _assert_bitwise(c2, c1)
    _assert_bitwise(c1, _cold(a, a, nparts=4, bs=16, chunk=chunk))
    # chunk is part of the key: the other setting is a miss
    s.matmul(a, a, nparts=4, bs=16, chunk=None if chunk else 2)
    assert s.stats["plan_cache_misses"] == 2 and s.stats["traces"] == 2


@pytest.mark.parametrize("semiring", [PLUS_TIMES, MIN_PLUS])
def test_values_only_change_repacks(semiring):
    a = _int_matrix()
    b = _int_matrix(seed=4)
    s = SpGEMMSession(device="cpu")
    s.matmul(a, b, nparts=3, bs=16, semiring=semiring)
    b3 = b.astype(np.float32)
    b3.data = b3.data * 3
    c = s.matmul(a, b3, nparts=3, bs=16, semiring=semiring)
    assert s.last_call["cache_hit"] and s.last_call["repacked"]
    assert s.stats["payload_repacks"] == 1 and s.stats["traces"] == 1
    _assert_bitwise(c, _cold(a, b3, nparts=3, bs=16, semiring=semiring))


def test_dtype_mismatched_repack_is_a_typed_rejection():
    a = _int_matrix()
    s = SpGEMMSession(device="cpu")
    s.matmul(a, a, nparts=2, bs=16)
    a64 = a.astype(np.float64)
    a64.data = a64.data * 2
    with pytest.raises(ValidationError) as err:
        s.matmul(a64, a64, nparts=2, bs=16)
    assert err.value.stage == "repack"
    assert s.stats["validation_failures"] == 1
    assert s.stats["quarantined"] == 0 and s.stats["fallbacks"] == 0
    assert len(s) == 1                                 # entry untouched


def test_injected_faults_walk_the_ladder_then_open_the_breaker():
    a = _int_matrix()
    sleeps = []
    s = SpGEMMSession(device="cpu", breaker_threshold=2,
                      fault_injector=FaultInjector(seed=0,
                                                   rates={"execute": 1.0}),
                      retry_sleep=sleeps.append,
                      retry_rng=np.random.default_rng(0))
    # engine="cuda" on the CPU has a ladder: cuda, then torch
    with pytest.raises(DeviceExecError) as err:
        s.matmul(a, a, nparts=2, bs=16, engine="cuda")
    assert isinstance(err.value, SpGEMMError) and err.value.stage == "execute"
    assert isinstance(err.value.__cause__, InjectedFault)
    assert s.stats["fallbacks"] == 1
    assert s.stats["retries"] == 2 * 2                 # 2 per rung
    assert len(sleeps) == 4 and len(s) == 0
    # the torch rung's key failed twice over two calls: its breaker opens
    with pytest.raises(DeviceExecError):
        s.matmul(a, a, nparts=2, bs=16, engine="torch")
    with pytest.raises(DeviceExecError, match="circuit breaker open"):
        s.matmul(a, a, nparts=2, bs=16, engine="torch")


def test_fault_then_recovery_serves_the_right_answer():
    a = _int_matrix()
    s = SpGEMMSession(device="cpu",
                      fault_injector=FaultInjector(seed=1, rates=1.0,
                                                   max_faults=1),
                      retry_sleep=lambda _: None)
    c = s.matmul(a, a, nparts=2, bs=16)
    assert s.stats["retries"] == 1 and s.stats["fallbacks"] == 0
    _assert_bitwise(c, _cold(a, a, nparts=2, bs=16))


GEOMETRY = {"2d": dict(grid=2), "3d": dict(grid=2, layers=2)}


@pytest.mark.parametrize("algorithm", ["2d", "3d"])
def test_2d_3d_served_without_downgrade(algorithm):
    """SUMMA and Split-3D serve on their own rung: bitwise the oracle, a
    hit builds nothing, new values repack."""
    a = _int_matrix()
    s = SpGEMMSession(device="cpu")
    c = s.matmul(a, a, algorithm=algorithm, bs=16, **GEOMETRY[algorithm])
    _assert_bitwise(c, _cold(a, a, nparts=1, bs=16))
    assert s.last_call["algorithm"] == s.last_call["requested_algorithm"] \
        == algorithm
    assert s.last_call["degraded"] is False and s.stats["fallbacks"] == 0
    assert s.last_call["comm_bytes_planned"] > 0
    s.matmul(a, a, algorithm=algorithm, bs=16, **GEOMETRY[algorithm])
    assert s.last_call["cache_hit"] and s.stats["traces"] == 1
    a2 = a.astype(np.float32)
    a2.data = a2.data * 2
    c = s.matmul(a2, a2, algorithm=algorithm, bs=16, **GEOMETRY[algorithm])
    assert s.last_call["repacked"] and s.stats["traces"] == 1
    _assert_bitwise(c, _cold(a2, a2, nparts=1, bs=16))


def test_2d_3d_cache_keys_ignore_ring_knobs():
    """nblocks and chunk key only 1d entries; the grid keys 2d and 3d, the
    layers only 3d."""
    a = _int_matrix()
    s = SpGEMMSession(device="cpu")
    s.matmul(a, a, algorithm="2d", grid=2, bs=16)
    s.matmul(a, a, algorithm="2d", grid=2, bs=16, nblocks=3, chunk=2,
             layers=5)
    assert s.stats["plan_cache_misses"] == 1 and s.last_call["cache_hit"]
    s.matmul(a, a, algorithm="3d", grid=2, layers=2, bs=16, nblocks=3,
             chunk=2)
    s.matmul(a, a, algorithm="3d", grid=2, layers=2, bs=16)
    assert s.stats["plan_cache_misses"] == 2 and s.last_call["cache_hit"]
    for kw in (dict(algorithm="3d", grid=2, layers=3),
               dict(algorithm="2d", grid=3),
               dict(algorithm="1d", nparts=4, chunk=2)):
        s.matmul(a, a, bs=16, **kw)
        assert not s.last_call["cache_hit"], kw
    assert s.stats["plan_cache_misses"] == 5 and s.stats["traces"] == 5


def test_ladder_downgrades_3d_to_2d():
    """The plan stage hard-fails 3 times with zero retries: on CPU tensors
    the ladder walks (3d, cuda) → (3d, torch) → (2d, cuda) and serves at
    (2d, torch), still bitwise, the descent visible in stats and
    last_call (the reference's (3d, pallas) → ... → (2d, jnp))."""
    inj = FaultInjector(seed=0, rates={"plan": 1.0}, max_faults=3)
    s = SpGEMMSession(device="cpu", fault_injector=inj,
                      retry_policy=tft.RetryPolicy(max_retries=0,
                                                   backoff_s=0.0))
    a = _int_matrix(30, seed=2)
    c = s.matmul(a, a, algorithm="3d", grid=1, layers=1, bs=16,
                 engine="cuda")
    _assert_bitwise(c, _cold(a, a, nparts=1, bs=16))
    assert s.last_call["degraded"] is True
    assert s.last_call["requested_algorithm"] == "3d"
    assert (s.last_call["algorithm"], s.last_call["engine"]) == \
        ("2d", "torch")
    assert s.stats["fallbacks"] == 3
    assert len(s) == 1      # only the serving rung's entry was cached


def test_ladder_exhaustion_raises_typed_not_bare():
    inj = FaultInjector(seed=0, rates=1.0)
    s = SpGEMMSession(device="cpu", fault_injector=inj,
                      retry_policy=tft.RetryPolicy(max_retries=1,
                                                   backoff_s=0.0),
                      retry_sleep=lambda _: None)
    a = _int_matrix(20, seed=4)
    with pytest.raises(SpGEMMError) as ei:
        s.matmul(a, a, algorithm="3d", grid=1, layers=1, bs=16,
                 engine="cuda")
    assert not type(ei.value) is RuntimeError  # noqa: E714
    assert isinstance(ei.value.__cause__, InjectedFault)
    n_rungs = sum(2 for _ in DOWNGRADE["3d"])   # cuda + torch per algorithm
    assert s.stats["fallbacks"] == n_rungs - 1
    assert len(s) == 0      # nothing poisoned ever entered the cache


def test_downgraded_1d_rung_inherits_the_grid():
    """A 2d call that falls to the 1d rung runs the ring on grid*grid
    parts, under the same key a direct 1d call on that many parts uses."""
    inj = FaultInjector(seed=0, rates={"plan": 1.0}, max_faults=1)
    s = SpGEMMSession(device="cpu", fault_injector=inj,
                      retry_policy=tft.RetryPolicy(max_retries=0,
                                                   backoff_s=0.0))
    a = _int_matrix()
    c = s.matmul(a, a, algorithm="2d", grid=2, bs=16)
    assert (s.last_call["algorithm"], s.last_call["degraded"]) == \
        ("1d", True)
    assert next(iter(s._cache.values())).plan.nparts == 4
    _assert_bitwise(c, _cold(a, a, nparts=4, bs=16))
    s.matmul(a, a, algorithm="1d", nparts=4, bs=16)
    assert s.last_call["cache_hit"] and s.stats["plan_cache_misses"] == 1


def _card_session(monkeypatch, **kw):
    """A session that believes it sits on a CUDA device, with the kernel
    build stubbed out: the ladder and ingress rules of the card, with no
    card."""
    s = SpGEMMSession(device="cpu", retry_sleep=lambda _: None, **kw)
    s.device = torch.device("cuda", 0)
    monkeypatch.setattr(s, "_build_kernel", lambda: None)
    return s


def test_launch_failure_on_the_card_raises_without_fallback(monkeypatch):
    import repro_torch.core.spgemm_1d_device as dev1d

    def failing_ring(plan, device, engine, trace_probe=None):
        assert engine == "cuda"                        # never the torch rung
        trace_probe()

        def fn(*args):
            raise RuntimeError("bsr_spgemm launch failed: cudaError_t 719")
        return fn, []

    monkeypatch.setattr(dev1d, "compile_ring", failing_ring)
    a = _int_matrix()
    s = _card_session(monkeypatch, breaker_threshold=2)
    for _ in range(2):
        with pytest.raises(DeviceExecError, match="cudaError_t 719") as err:
            s.matmul(a, a, nparts=2, bs=16)
        assert err.value.stage == "execute"
    assert s.stats["fallbacks"] == 0 and s.stats["traces"] == 2
    assert s.stats["retries"] == 2 * 2 and len(s) == 0
    with pytest.raises(DeviceExecError, match="circuit breaker open"):
        s.matmul(a, a, nparts=2, bs=16)
    assert s.stats["fallbacks"] == 0


def test_card_ladder_runs_the_kernel_on_every_rung(monkeypatch):
    """On the card the algorithm downgrade runs the kernel engine on every
    rung: two plan faults take a 3d call to (1d, cuda), never to the plain
    version (the compilers are pointed at CPU tensors here, where the
    kernel wrapper takes its plain version)."""
    import repro_torch.core.spgemm_1d_device as dev1d
    import repro_torch.core.spgemm_2d_device as dev2d

    a = _int_matrix()
    want = _cold(a, a, nparts=4, bs=16)
    engines = []
    for mod, name in ((dev1d, "compile_ring"), (dev2d, "compile_summa")):
        inner = getattr(mod, name)

        def on_cpu(plan, device, engine, trace_probe=None, inner=inner):
            engines.append(engine)
            return inner(plan, device="cpu", engine=engine,
                         trace_probe=trace_probe)
        monkeypatch.setattr(mod, name, on_cpu)
    s = _card_session(monkeypatch,
                      fault_injector=FaultInjector(seed=0,
                                                   rates={"plan": 1.0},
                                                   max_faults=2),
                      retry_policy=tft.RetryPolicy(max_retries=0,
                                                   backoff_s=0.0))
    c = s.matmul(a, a, algorithm="3d", grid=2, layers=2, bs=16)
    assert (s.last_call["algorithm"], s.last_call["engine"]) == \
        ("1d", "cuda")
    assert s.last_call["degraded"] is True and s.stats["fallbacks"] == 2
    assert engines == ["cuda"]
    _assert_bitwise(c, want)
    s.fault_injector = None
    for alg, kw in GEOMETRY.items():
        s.matmul(a, a, algorithm=alg, bs=16, **kw)
        assert (s.last_call["algorithm"], s.last_call["engine"],
                s.last_call["degraded"]) == (alg, "cuda", False)
    assert engines == ["cuda"] * 3


@pytest.mark.parametrize("bs", [1, 8, 256])
def test_bs_the_kernel_does_not_take_is_rejected_on_the_card(monkeypatch,
                                                             bs):
    a = _int_matrix()
    s = _card_session(monkeypatch)
    with pytest.raises(ValidationError, match="takes bs in") as err:
        s.matmul(a, a, nparts=2, bs=bs)
    assert err.value.stage == "validate"
    assert s.stats["validation_failures"] == 1
    assert s.stats["fallbacks"] == 0 and s.stats["traces"] == 0
    # the plain engine on the CPU takes any bs
    c = SpGEMMSession(device="cpu").matmul(a, a, nparts=2, bs=bs)
    _assert_bitwise(c, _cold(a, a, nparts=2, bs=bs))


def test_invalid_operand_counts_a_validation_failure():
    a = _int_matrix()
    bad = a.astype(np.float32)
    bad.indices = bad.indices.copy()
    bad.indices[0] = a.shape[0] + 5
    s = SpGEMMSession(device="cpu")
    with pytest.raises(ValidationError):
        s.matmul(bad, a)
    assert s.stats["validation_failures"] == 1 and len(s) == 0


def test_lru_eviction_releases_bytes():
    s = SpGEMMSession(maxsize=1, device="cpu")
    a, b = _int_matrix(), _int_matrix(seed=9)
    s.matmul(a, a, bs=16)
    first = s.stats["bytes_cached"]
    assert first > 0
    s.matmul(b, b, bs=16)
    assert s.stats["evictions"] == 1 and len(s) == 1
    s.clear()
    assert s.stats["bytes_cached"] == 0 and len(s) == 0


# ---- the serving budgets ----------------------------------------------------


def _fill(s, i, **kw):
    """One cold multiply of the i-th distinct integer matrix; returns the
    key it cached (the newest, last in LRU order)."""
    m = _int_matrix(30, seed=20 + i)
    s.matmul(m, m, bs=16, **kw)
    return next(reversed(s._cache))


def test_entry_bytes_are_the_device_tensors_it_pins():
    """An entry's ``nbytes`` is the sum of the tensors its executable was
    built with, and the ledger holds it; the reference's count of the same
    multiply is larger, since it also pins a flag array and a count the
    port does not build (documented, not padded)."""
    a = _int_matrix()
    for kw in (dict(), dict(nparts=2), dict(algorithm="2d", grid=2)):
        s = SpGEMMSession(device="cpu")
        s.matmul(a, a, bs=16, **kw)
        entry = next(iter(s._cache.values()))
        assert all(isinstance(t, torch.Tensor) for t in entry.args)
        assert entry.nbytes == sum(t.nbytes for t in entry.args) > 0
        assert s.cached_bytes() == s.stats["bytes_cached"] == entry.nbytes
    s = SpGEMMSession(device="cpu")
    s.matmul(a, a, bs=16)
    r = RSession()
    ra = r_erdos_renyi(50, 50, 4.0, seed=3)
    ra.data[:] = a.data
    r.matmul(ra, ra, bs=16, engine="jnp")
    assert s.cached_bytes() < r.cached_bytes()


def test_byte_budget_evicts_lru_first_and_keeps_the_newest():
    """``max_bytes`` evicts oldest-first (a hit refreshes an entry) until
    the ledger fits, firing the hook with each entry's owner, key and
    bytes; a newest entry larger than the whole budget still serves and
    stays, alone."""
    sizes = {}
    probe = SpGEMMSession(device="cpu")
    for i in range(4):
        key = _fill(probe, i)
        sizes[i] = probe._cache[key].nbytes
    seen = []
    s = SpGEMMSession(device="cpu", max_bytes=sizes[1] + sizes[2],
                      on_evict=lambda *a: seen.append(a))
    keys = [_fill(s, i, tenant=f"t{i}") for i in range(3)]
    assert [k for _, k, _ in seen] == [keys[0]]
    assert seen[0] == ("t0", keys[0], sizes[0])
    _fill(s, 1)                                        # a hit: 1 is newest
    assert s.last_call["cache_hit"] and list(s._cache) == [keys[2], keys[1]]
    k3 = _fill(s, 3, tenant="t3")
    assert seen[1] == ("t2", keys[2], sizes[2])        # LRU went first
    assert s.cached_bytes() <= s.max_bytes and k3 in s._cache
    s.max_bytes = 1                                    # smaller than any
    k0 = _fill(s, 0)
    assert list(s._cache) == [k0] and s.cached_bytes() == sizes[0]
    assert s.stats["evictions"] == len(seen)
    assert s.stats["bytes_cached"] == s.cached_bytes()


def test_quota_charges_the_creator_as_the_reference_does():
    """``tenant_quota`` counts the entries a tenant created: a hit by
    another tenant neither moves ownership nor counts against it, and the
    hook reports the owner. The same sequence through the reference's
    session evicts the same structures for the same owners."""
    got, want = [], []
    s = SpGEMMSession(device="cpu", tenant_quota=1,
                      on_evict=lambda o, k, n: got.append((o, k[-2:], n)))
    r = RSession(tenant_quota=1,
                 on_evict=lambda o, k, n: want.append((o, k[-2:])))
    seq = [("a", 0), ("a", 1), ("b", 2), ("b", 1), ("b", 3), ("a", 4)]
    for tenant, i in seq:
        m = _int_matrix(30, seed=20 + i)
        s.matmul(m, m, bs=16, tenant=tenant)
        rm = r_erdos_renyi(30, 30, 4.0, seed=20 + i)
        rm.data[:] = m.data
        r.matmul(rm, rm, bs=16, engine="jnp", tenant=tenant)
        assert s.last_call["cache_hit"] == r.last_call["cache_hit"]
        for t in ("a", "b"):
            assert s.cached_entries(t) == r.cached_entries(t) <= 1
    assert [(o, k) for o, k, _ in got] == want
    assert [o for o, _, _ in got] == ["a", "b", "a"]
    assert all(n > 0 for _, _, n in got)
    assert s.cached_bytes("a") + s.cached_bytes("b") == s.cached_bytes()


def test_tenant_max_bytes_keeps_the_tenants_newest():
    s = SpGEMMSession(device="cpu", tenant_max_bytes=1)
    for i in range(3):
        _fill(s, i, tenant="a")
    _fill(s, 3, tenant="b")
    assert s.cached_entries("a") == 1 and s.cached_entries("b") == 1
    assert s.stats["evictions"] == 2


def test_tenant_passes_through_a_downgrade():
    """A 3d call whose plan fails on the 3d rung is served on the 2d rung,
    and the entry that rung caches belongs to the calling tenant."""
    inj = FaultInjector(seed=0, rates={"plan": 1.0}, max_faults=1)
    s = SpGEMMSession(device="cpu", fault_injector=inj, tenant_quota=4,
                      retry_policy=tft.RetryPolicy(max_retries=0,
                                                   backoff_s=0.0))
    a = _int_matrix(30, seed=2)
    c = s.matmul(a, a, algorithm="3d", grid=2, layers=2, bs=16,
                 tenant="t")
    assert (s.last_call["algorithm"], s.last_call["degraded"]) == \
        ("2d", True)
    _assert_bitwise(c, _cold(a, a, nparts=1, bs=16))
    entry, = s._cache.values()
    assert entry.owner == "t" and s.cached_entries("t") == 1
    assert s.cached_bytes("t") == entry.nbytes


def test_eviction_releases_the_entry_and_chains_hooks():
    """An evicted entry drops its tensors and executable; a service built
    over a session that already has a hook calls that hook after counting
    the eviction for the owner."""
    from repro_torch.serve import SpGEMMService

    prior = []
    s = SpGEMMSession(device="cpu", maxsize=1,
                      on_evict=lambda *a: prior.append(a))
    svc = SpGEMMService(session=s)
    k0 = _fill(s, 0, tenant="x")
    entry = s._cache[k0]
    nbytes = entry.nbytes
    _fill(s, 1, tenant="y")
    assert prior == [("x", k0, nbytes)]
    assert entry.args == [] and entry.fn is None and entry.repack is None
    assert svc.stats()["evictions_by_tenant"] == {"x": 1}
    assert s.cached_bytes() == s.stats["bytes_cached"] \
        == s.cached_bytes("y")


@pytest.mark.parametrize("knob", ["max_bytes", "tenant_quota",
                                  "tenant_max_bytes"])
def test_budget_knobs_must_be_positive(knob):
    with pytest.raises(ValueError, match=knob):
        SpGEMMSession(device="cpu", **{knob: 0})


def test_cuda_session_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpGEMMSession()


def test_retry_schedule_and_breaker_match_reference():
    """Same seed, same backoff schedule; same breaker state machine."""
    def flaky(n):
        state = {"left": n}

        def fn():
            if state["left"]:
                state["left"] -= 1
                raise RuntimeError("transient")
            return "ok"
        return fn

    got, want = [], []
    for mod, out in ((tft, got), (rft, want)):
        pol = mod.RetryPolicy(max_retries=3, backoff_s=0.1, jitter=0.5)
        assert mod.with_retries(flaky(3), pol, sleep=out.append,
                                rng=np.random.default_rng(5))() == "ok"
    assert got == want
    clock = [0.0]
    for mod in (tft, rft):
        br = mod.CircuitBreaker(threshold=2, cooldown_s=5.0,
                                clock=lambda: clock[0])
        br.record_failure()
        br.record_failure()
        assert br.state == "open" and not br.allow()
        clock[0] += 5.0
        assert br.state == "half_open"
        br.record_success()
        assert br.state == "closed"
        clock[0] = 0.0


def test_fault_injector_replays_the_reference_sequence():
    got = FaultInjector(seed=3, rates=0.5, kinds=("oom", "corrupt"))
    want = rfaults.FaultInjector(seed=3, rates=0.5, kinds=("oom", "corrupt"))
    seq = []
    for inj in (got, want):
        out = []
        for stage in ("plan", "compile", "execute", "repack") * 5:
            try:
                inj.fire(stage)
                out.append(None)
            except RuntimeError as e:
                out.append(type(e).__name__)
        seq.append(out)
    assert seq[0] == seq[1]
    assert got.injected == want.injected
