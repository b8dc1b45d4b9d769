"""Retries with backoff and circuit breakers for the sparse runtime.

The port's copy of the session-facing half of
``repro.runtime.fault_tolerance``: :class:`RetryPolicy` /
:func:`with_retries` (exponential backoff with seeded jitter, injectable
sleep) and the consecutive-failure :class:`CircuitBreaker`. The
checkpoint and train-loop parts belong to a later slice.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

__all__ = ["RetryPolicy", "with_retries", "CircuitBreaker"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``jitter`` spreads the backoff multiplicatively: each pause is
    ``delay * (1 + jitter * u)`` with ``u ~ U[0, 1)``, so a fleet of
    workers retrying the same dead link does not stampede in lockstep."""
    max_retries: int = 3
    backoff_s: float = 0.5
    backoff_mult: float = 2.0
    jitter: float = 0.0
    retryable: tuple = (RuntimeError,)


def with_retries(fn: Callable, policy: RetryPolicy = RetryPolicy(),
                 on_retry: Optional[Callable[[int, Exception], None]] = None,
                 *, sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[np.random.Generator] = None):
    """Wrap ``fn``; transient failures back off and retry.

    ``sleep`` and ``rng`` are injectable so tests (and the SpGEMM
    session's ladder) drive the backoff schedule without wall-clock
    sleeps or nondeterministic jitter: pass ``sleep=fake.append`` to
    record the schedule, ``rng=np.random.default_rng(seed)`` to pin it.
    """

    def wrapped(*args, **kwargs):
        delay = policy.backoff_s
        gen = rng
        for attempt in range(policy.max_retries + 1):
            try:
                return fn(*args, **kwargs)
            except policy.retryable as e:
                if attempt == policy.max_retries:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                pause = delay
                if policy.jitter > 0.0:
                    if gen is None:
                        gen = np.random.default_rng()
                    pause = delay * (1.0 + policy.jitter
                                     * float(gen.random()))
                sleep(pause)
                delay *= policy.backoff_mult
        raise AssertionError("unreachable")

    return wrapped


class CircuitBreaker:
    """Consecutive-failure circuit breaker with a cooldown half-open state.

    The SpGEMM session already breaks per *cache key* (a poisoned plan
    stops being re-planned); this is the coarser per-*principal* breaker
    the serving layer keeps per tenant: a tenant whose requests keep
    failing is cut off at admission instead of burning a retry ladder per
    request, and other tenants' breakers never see those failures.

    States: ``closed`` (all traffic passes) → ``open`` after ``threshold``
    consecutive failures (``allow()`` is False) → ``half_open`` once
    ``cooldown_s`` has elapsed on the injectable ``clock`` (one probe
    request passes; success closes the circuit, failure re-opens it and
    restarts the cooldown). ``clock`` is injectable for the same reason
    the session's retry sleep is — tier-1 never waits on wall time.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s}")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self.failures = 0          # consecutive failures since last success
        self.opened_at: Optional[float] = None

    @property
    def state(self) -> str:
        if self.opened_at is None:
            return "closed"
        if self._clock() - self.opened_at >= self.cooldown_s:
            return "half_open"
        return "open"

    def allow(self) -> bool:
        """May a request pass right now? (half-open admits the probe)"""
        return self.state != "open"

    def record_success(self) -> None:
        self.failures = 0
        self.opened_at = None

    def record_failure(self) -> None:
        self.failures += 1
        if self.failures >= self.threshold:
            self.opened_at = self._clock()
