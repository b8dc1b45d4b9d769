"""Fault tolerance & straggler mitigation: retries, breakers, the train loop.

The port of ``repro.runtime.fault_tolerance``:

  * **Transient-failure retries** — :func:`with_retries` wraps a step;
    ``RuntimeError`` (a failed launch, a lost link) backs off and retries
    and, past the policy's count, re-raises.
  * **Circuit breakers** — :class:`CircuitBreaker`, per principal (the
    SpGEMM service keeps one per tenant).
  * **Straggler detection** — :class:`StragglerStats` keeps a rolling
    window of step wall times; a step slower than ``z_thresh`` standard
    deviations is flagged.
  * **Checkpoint/restart** — :class:`TrainLoopRunner` snapshots the train
    state every ``ckpt_every`` steps through the async
    ``checkpoint.CheckpointManager``; on construction it resumes from the
    latest checkpoint, and the deterministic data pipeline's skip-ahead
    (``data/pipeline.py``) puts the restarted loop on exactly the batch it
    would have seen.

The port's checkpoints keep the port's own tree: a train state saves as
``params/embed``, ``params/layers/<i>/...``, ``opt/mu/...``, ``opt/nu/...``,
``opt/step`` (and ``residual/...``), not the reference's stacked
``params/period/pos<i>/...``. A JAX train checkpoint's arrays come in
through ``models.convert.train_state_from_reference``, not through a
resume. The resume copies the checkpoint into the given state's tensors in
place (``CheckpointManager.restore_into``): the port's train step updates
its state in place too, and a second copy of a full-size state does not fit
on one card. There is no resharding: the port runs on one card.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager, latest_step

__all__ = ["RetryPolicy", "with_retries", "CircuitBreaker", "StragglerStats",
           "StepTimer", "TrainLoopRunner"]


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


class StragglerStats:
    """Rolling per-step timing; z-score flagging of slow steps."""

    def __init__(self, window: int = 50, z_thresh: float = 3.0):
        self.window = window
        self.z_thresh = z_thresh
        self.times: deque = deque(maxlen=window)
        self.flagged = 0

    def record(self, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if len(self.times) >= 10:
            mu = float(np.mean(self.times))
            sd = float(np.std(self.times)) + 1e-9
            if (dt - mu) / sd > self.z_thresh:
                is_straggler = True
                self.flagged += 1
        self.times.append(dt)
        return is_straggler

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"step_time_mean": 0.0, "stragglers": 0}
        return {"step_time_mean": float(np.mean(self.times)),
                "step_time_p50": float(np.median(self.times)),
                "step_time_max": float(np.max(self.times)),
                "stragglers": float(self.flagged)}


class StepTimer:
    """Host seconds of a ``with`` block (``dt``). A CUDA step returns before
    the card finishes, so when CUDA is initialized the timer synchronizes
    the current device before it reads the clock."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.dt = time.perf_counter() - self.t0
        return False


class TrainLoopRunner:
    """Orchestrates step → time → checkpoint → (maybe) restart-resume.

    ``state``'s leaves must be tensors: a resume copies the latest
    checkpoint under ``ckpt_dir`` into them in place.
    """

    def __init__(self, step_fn: Callable, state: Any, ckpt_dir: str,
                 *, ckpt_every: int = 100, keep: int = 3,
                 retry: RetryPolicy = RetryPolicy(),
                 retry_sleep: Callable[[float], None] = time.sleep,
                 straggler_window: int = 50):
        self.manager = CheckpointManager(ckpt_dir, keep=keep)
        self.stats = StragglerStats(window=straggler_window)
        self.ckpt_every = ckpt_every
        self.state = state
        self.start_step = 0
        self._step_fn = with_retries(step_fn, retry, sleep=retry_sleep)
        last = latest_step(ckpt_dir)
        if last is not None:        # auto-resume
            self.state = self.manager.restore_into(self.state, step=last)
            self.start_step = last

    def run(self, batches: Callable[[int], Any], num_steps: int,
            log_every: int = 10,
            log_fn: Optional[Callable[[int, Dict], None]] = None) -> Any:
        for step in range(self.start_step, self.start_step + num_steps):
            batch = batches(step)
            with StepTimer() as t:
                self.state, metrics = self._step_fn(self.state, batch)
            self.stats.record(t.dt)
            if log_fn is not None and step % log_every == 0:
                log_fn(step, {**{k: float(v) for k, v in metrics.items()},
                              **self.stats.summary()})
            if (step + 1) % self.ckpt_every == 0:
                self.manager.save(step + 1, self.state)
        self.manager.wait()
        return self.state
