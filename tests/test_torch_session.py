"""The port's SpGEMMSession against the reference's contract, on the CPU.

Pins the stats surface (the same ``SESSION_STATS`` keys as the reference),
structure-keyed caching (a hit builds no new executable), the values-only
repack, the typed dtype rejection on a repack, the degradation ladder and
the circuit breaker under injected faults, the card's rules (no plain rung
behind the kernel, a bs the kernel does not take rejected at ingress), and
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
from repro_torch.core.session import SpGEMMSession
from repro_torch.core.spgemm_1d_device import (build_device_plan,
                                               run_device_spgemm)
from repro_torch.core.validate import (DeviceExecError, PlanError,
                                       SpGEMMError, ValidationError)
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


@pytest.mark.parametrize("algorithm", ["2d", "3d"])
def test_unported_algorithms_raise_plan_error(algorithm):
    a = _int_matrix()
    s = SpGEMMSession(device="cpu")
    with pytest.raises(PlanError, match="not yet ported"):
        s.matmul(a, a, algorithm=algorithm, nparts=2)
    assert s.stats["fallbacks"] == 0 and s.stats["calls"] == 0


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
