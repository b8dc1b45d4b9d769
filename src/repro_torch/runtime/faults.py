"""Deterministic, seeded fault injection for the sparse execution pipeline.

The port's copy of ``repro.runtime.faults``. Real hardware faults cannot be
provoked in tests, so this module simulates them, reproducibly: a
:class:`FaultInjector` is attached to a
:class:`~repro_torch.core.session.SpGEMMSession` and fires at the four
pipeline stages (``plan`` / ``compile`` / ``execute`` / ``repack``) with
configurable per-stage rates, raising exceptions shaped like the real
failure modes:

  * :class:`SimulatedDeviceError` — a device error mid-ring (the
    counterpart of the reference's simulated runtime error; a CUDA error
    surfaces as a ``RuntimeError`` too);
  * :class:`SimulatedOOM` — out of device memory on the payload gather
    (the static-shape stacks growing past device memory);
  * :class:`SimulatedCorruption` — a corrupted payload repack (host-side
    blockization fed garbage, detected before it reaches the cache).

All three subclass :class:`InjectedFault` (itself ``RuntimeError``, like
a CUDA error raised through torch), so the session's retry/degradation machinery
handles them exactly as it would the real thing — and the differential
tests can assert that whatever escapes is a typed ``SpGEMMError``, never a
bare ``RuntimeError``.

Determinism contract: decisions come from one ``np.random.default_rng``
seeded at construction and consumed in call order, so a given (seed,
workload) pair replays the identical fault sequence on every run — the
fault tests are exactly reproducible.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np

__all__ = ["STAGES", "InjectedFault", "SimulatedDeviceError",
           "SimulatedOOM", "SimulatedCorruption", "FaultInjector"]

STAGES = ("plan", "compile", "execute", "repack")


class InjectedFault(RuntimeError):
    """Base of all injected faults (a ``RuntimeError``, like a real CUDA
    error — the session must never let one escape untyped)."""


class SimulatedDeviceError(InjectedFault):
    """A device error mid-ring (illegal address, launch failure)."""


class SimulatedOOM(InjectedFault):
    """Out-of-device-memory failure on the payload gather."""


class SimulatedCorruption(InjectedFault):
    """Corrupted payload repack detected host-side."""


_KINDS = {
    "device": (SimulatedDeviceError,
               "simulated CUDA error during the ring's payload gather"),
    "oom": (SimulatedOOM,
            "CUDA out of memory: simulated OOM gathering payload stacks"),
    "corrupt": (SimulatedCorruption,
                "simulated corrupted repack: payload stack checksum "
                "mismatch"),
}


class FaultInjector:
    """Seeded per-stage fault source for ``SpGEMMSession``.

    Parameters
    ----------
    seed      : RNG seed; the full fault sequence is a pure function of it
                and the order of ``fire`` calls.
    rates     : either one float (same rate at every stage) or a dict
                ``{stage: rate}`` — stages absent from the dict never
                fault. Rates are probabilities in [0, 1]; 1.0 makes a
                stage fail deterministically (the ladder-exhaustion case).
    kinds     : which simulated failure classes to draw from (uniformly).
    arm_after : number of ``fire`` calls to let pass before any fault may
                trigger (lets a workload make progress, then break —
                the resume tests inject mid-iteration this way).
    max_faults: stop injecting after this many faults (None = unbounded);
                with retries enabled this bounds how long a stage can stay
                broken, making recovery deterministic.

    ``injected`` counts faults raised per stage; ``calls`` counts fire
    invocations per stage — both are plain dicts for test assertions.
    """

    def __init__(self, seed: int = 0,
                 rates: Union[float, Dict[str, float], None] = None,
                 kinds: Sequence[str] = ("device", "oom", "corrupt"),
                 arm_after: int = 0,
                 max_faults: Optional[int] = None):
        if isinstance(rates, dict):
            unknown = set(rates) - set(STAGES)
            if unknown:
                raise ValueError(f"unknown stages {sorted(unknown)}; "
                                 f"valid: {STAGES}")
            self.rates = {s: float(rates.get(s, 0.0)) for s in STAGES}
        else:
            r = 0.0 if rates is None else float(rates)
            self.rates = {s: r for s in STAGES}
        unknown = set(kinds) - set(_KINDS)
        if unknown:
            raise ValueError(f"unknown fault kinds {sorted(unknown)}; "
                             f"valid: {sorted(_KINDS)}")
        self.kinds = tuple(kinds)
        self.arm_after = int(arm_after)
        self.max_faults = max_faults
        self._rng = np.random.default_rng(seed)
        self._fired = 0
        self.injected = {s: 0 for s in STAGES}
        self.calls = {s: 0 for s in STAGES}

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def fire(self, stage: str) -> None:
        """Possibly raise an injected fault for ``stage``.

        Called by the session at the top of each pipeline stage (and again
        on every retry of it, so a stage under retry re-rolls the dice —
        at rate < 1 retries converge, at rate 1.0 they provably cannot).
        """
        if stage not in self.calls:
            raise ValueError(f"unknown stage {stage!r}; valid: {STAGES}")
        self.calls[stage] += 1
        self._fired += 1
        rate = self.rates[stage]
        if rate <= 0.0 or self._fired <= self.arm_after:
            return
        if self.max_faults is not None and \
                self.total_injected >= self.max_faults:
            return
        # one draw per fire call, consumed unconditionally once armed so
        # the sequence stays aligned across stages with different rates
        roll = self._rng.random()
        if roll >= rate:
            return
        kind = self.kinds[int(self._rng.integers(len(self.kinds)))]
        self.injected[stage] += 1
        cls, msg = _KINDS[kind]
        raise cls(f"{msg} [stage={stage} fault#{self.total_injected} "
                  f"kind={kind}]")
