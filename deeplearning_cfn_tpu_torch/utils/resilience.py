"""The circuit breaker of ``deeplearning_cfn_tpu/utils/resilience.py``, copied
(the port imports nothing of the JAX package): what the checkpoint tiers of
``train/checkpoint.FallbackCheckpointer`` sit behind.  ``RetryPolicy`` is
not ported; nothing of the port retries yet.

:class:`CircuitBreaker`: after ``failure_threshold`` consecutive failures
the circuit opens, calls fail fast with :class:`CircuitOpen`, and a
``degraded`` event lands in the port's flight recorder
(``obs/recorder``).  After ``reset_after_s`` the breaker half-opens and
admits a single probe.  It takes an injectable :class:`~.timeouts.Clock`
and never reads the wall clock directly.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable

from deeplearning_cfn_tpu_torch.utils.logging import get_logger
from deeplearning_cfn_tpu_torch.utils.timeouts import Clock, MonotonicClock

log = get_logger("dlcfn.resilience")


class CircuitOpen(RuntimeError):
    """The circuit breaker is open; the call was refused without trying."""

    def __init__(self, name: str, failures: int):
        super().__init__(
            f"circuit {name!r} is open after {failures} consecutive failures"
        )
        self.name = name
        self.failures = failures


CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


@dataclass
class CircuitBreaker:
    """Trip after N consecutive failures; fail fast until a cooldown probe.

    State machine: CLOSED -> (threshold failures) -> OPEN -> (after
    ``reset_after_s`` on the injected clock) -> HALF_OPEN, which admits
    exactly one probe call — success closes the circuit, failure re-opens
    it for another cooldown.  Tripping records a ``degraded`` event to the
    flight recorder; recovery records ``degraded_recovered``.

    Thread-safe; the flight-recorder write happens outside the lock.
    """

    name: str = "dependency"
    failure_threshold: int = 5
    reset_after_s: float = 30.0
    clock: Clock = field(default_factory=MonotonicClock)

    def __post_init__(self) -> None:
        if self.failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1: {self.failure_threshold}"
            )
        self._lock = threading.Lock()
        self._failures = 0
        self._state = CLOSED
        self._opened_at = 0.0
        self._probing = False

    # -- observation -----------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._effective_state_locked()

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._failures

    def _effective_state_locked(self) -> str:
        if self._state == OPEN and (
            self.clock.now() - self._opened_at >= self.reset_after_s
        ):
            return HALF_OPEN
        return self._state

    # -- transitions -----------------------------------------------------
    def allow(self) -> bool:
        """Whether a call may proceed right now (claims the half-open probe)."""
        with self._lock:
            state = self._effective_state_locked()
            if state == CLOSED:
                return True
            if state == HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            was_open = self._state == OPEN
            self._failures = 0
            self._state = CLOSED
            self._probing = False
        if was_open:
            self._record("degraded_recovered")

    def record_failure(self) -> None:
        tripped = False
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._state == OPEN:
                # A failed half-open probe: restart the cooldown.
                self._opened_at = self.clock.now()
            elif self._failures >= self.failure_threshold:
                self._state = OPEN
                self._opened_at = self.clock.now()
                tripped = True
        if tripped:
            self._record("degraded")

    def call(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` through the breaker; refused calls raise CircuitOpen."""
        if not self.allow():
            raise CircuitOpen(self.name, self.consecutive_failures)
        try:
            result = fn()
        except BaseException:
            self.record_failure()
            raise
        self.record_success()
        return result

    def _record(self, kind: str) -> None:
        # Lazy import: utils must stay importable without the obs layer.
        try:
            from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

            get_recorder().record(
                kind,
                breaker=self.name,
                failures=self.consecutive_failures,
                threshold=self.failure_threshold,
            )
        except Exception:  # pragma: no cover - journaling must never break callers
            log.debug("flight-recorder write failed for breaker %s", self.name)
        if kind == "degraded":
            log.warning(
                "circuit %r opened after %d consecutive failures",
                self.name,
                self.failure_threshold,
            )
        else:
            log.info("circuit %r recovered", self.name)
