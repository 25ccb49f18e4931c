"""Timeout budgets and clocks — a copy of ``deeplearning_cfn_tpu/utils/timeouts.py``
(the port imports nothing of the JAX package).

Timeout budgets for multi-phase bootstrap.

The reference threads a single wallclock budget through its bootstrap phases:
``setup_timeout = WAITCONDITION_TIMEOUT - MASTERLAUNCH_TIMEOUT`` and each
polling phase decrements what the previous one consumed
(dl_cfn_setup_v2.py:411-415, 322-323).  ``TimeoutBudget`` makes that
discipline an object: every phase draws from the same budget, and exhaustion
raises a typed error naming the phase that starved.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


class BudgetExhausted(TimeoutError):
    """Raised when a phase asks for time the budget no longer has."""

    def __init__(self, phase: str, total: float):
        super().__init__(
            f"timeout budget ({total:.0f}s total) exhausted during phase {phase!r}"
        )
        self.phase = phase


@dataclass
class TimeoutBudget:
    """A decrementing wallclock budget shared across bootstrap phases.

    ``clock`` is injectable so the choreography unit tests can run the full
    multi-phase protocol (with simulated 30 s polling sleeps) in microseconds.
    """

    total_s: float
    clock: "Clock" = field(default_factory=lambda: MonotonicClock())

    def __post_init__(self) -> None:
        self._start = self.clock.now()

    @property
    def remaining_s(self) -> float:
        return self.total_s - (self.clock.now() - self._start)

    @property
    def elapsed_s(self) -> float:
        return self.clock.now() - self._start

    def check(self, phase: str) -> None:
        if self.remaining_s <= 0:
            raise BudgetExhausted(phase, self.total_s)

    def sleep(self, seconds: float, phase: str) -> None:
        """Sleep (against the injected clock), then verify the budget."""
        self.clock.sleep(min(seconds, max(self.remaining_s, 0.0)))
        self.check(phase)


class Clock:
    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class MonotonicClock(Clock):
    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class FakeClock(Clock):
    """Deterministic clock for tests: sleep() advances instantly."""

    def __init__(self, start: float = 0.0):
        self._t = start

    def now(self) -> float:
        return self._t

    def sleep(self, seconds: float) -> None:
        self._t += max(seconds, 0.0)

    def advance(self, seconds: float) -> None:
        self._t += seconds
