"""One resilience policy for every retry loop in the stack.

Before this module the repo had three divergent retry idioms: the GCP
transport's unjittered ``2**attempt`` wall-clock loop, broker_client's
bare ``time.sleep(0.05)`` readiness poll, and recovery's give-up
counter.  Each one re-derived backoff, deadline, and error-classification
logic, and none was testable without real sleeps.  :class:`RetryPolicy`
is the single replacement:

* **decorrelated jitter** (``sleep = min(cap, uniform(base, prev * 3))``)
  instead of synchronized exponential waves — the classic thundering-herd
  fix, seeded so chaos soaks replay byte-for-byte;
* **monotonic deadlines** via :class:`~.timeouts.TimeoutBudget` — a retry
  loop inside a bootstrap phase draws from the same budget as everything
  else in that phase and raises the budget's typed error when starved;
* **typed classification** — exceptions are Retryable, Fatal, or
  classified by a callback; fatal errors propagate on the first throw
  instead of burning the whole attempt budget.

:class:`CircuitBreaker` layers on top for callers that talk to one
dependency repeatedly: after ``failure_threshold`` consecutive failures
the circuit opens, calls fail fast with :class:`CircuitOpen`, and a
``degraded`` event lands in the flight recorder so ``dlcfn events`` shows
the outage.  After ``reset_after_s`` the breaker half-opens and admits a
single probe.

Everything takes an injectable :class:`~.timeouts.Clock`; nothing in this
module reads the wall clock directly.

Counterpart of ``deeplearning_cfn_tpu/utils/resilience.py``, copied: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

from deeplearning_cfn_tpu_torch.utils.logging import get_logger
from deeplearning_cfn_tpu_torch.utils.timeouts import (
    BudgetExhausted,
    Clock,
    MonotonicClock,
    TimeoutBudget,
)

log = get_logger("dlcfn.resilience")


class Retryable(Exception):
    """Marker: an operation failed transiently and may be re-attempted."""


class Fatal(Exception):
    """Marker: an operation failed permanently; retrying cannot help."""


class RetryExhausted(RuntimeError):
    """Every attempt failed; carries the count and the final cause."""

    def __init__(self, attempts: int, last: BaseException | None):
        super().__init__(f"retries exhausted after {attempts} attempts: {last}")
        self.attempts = attempts
        self.last = last


class CircuitOpen(RuntimeError):
    """The circuit breaker is open; the call was refused without trying."""

    def __init__(self, name: str, failures: int):
        super().__init__(
            f"circuit {name!r} is open after {failures} consecutive failures"
        )
        self.name = name
        self.failures = failures


# Exception types that are transient by nature, used when a policy is
# built without an explicit classification.  TimeoutError is retryable
# here, but BudgetExhausted (a TimeoutError subclass) always propagates:
# the budget IS the deadline, retrying against it is self-defeating.
DEFAULT_RETRYABLE: tuple[type[BaseException], ...] = (
    Retryable,
    ConnectionError,
    TimeoutError,
    OSError,
)


@dataclass
class RetryPolicy:
    """Seeded decorrelated-jitter retry with typed classification.

    ``classify(exc)`` (when given) is consulted first and may return
    ``True`` (retry), ``False`` (fatal), or ``None`` (fall through to the
    ``fatal`` / ``retryable`` type tuples).  ``Fatal`` beats ``Retryable``
    when both match.  :class:`~.timeouts.BudgetExhausted` is never
    swallowed regardless of classification.
    """

    max_attempts: int = 4
    base_s: float = 0.05
    cap_s: float = 5.0
    clock: Clock = field(default_factory=MonotonicClock)
    seed: int | None = None
    retryable: tuple[type[BaseException], ...] = DEFAULT_RETRYABLE
    fatal: tuple[type[BaseException], ...] = (Fatal,)
    classify: Callable[[BaseException], bool | None] | None = None

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1: {self.max_attempts}")
        if self.base_s < 0 or self.cap_s < self.base_s:
            raise ValueError(
                f"need 0 <= base_s <= cap_s: base={self.base_s} cap={self.cap_s}"
            )
        self._rng = random.Random(self.seed)

    # -- backoff ---------------------------------------------------------
    def delays(self) -> Iterator[float]:
        """The (unbounded) jittered delay sequence this policy would sleep.

        Decorrelated jitter: each delay is uniform on ``[base, prev * 3]``
        clamped to ``cap_s``, so waits spread out instead of synchronizing
        into retry waves.  Every yielded value is in ``[base_s, cap_s]``.
        """
        prev = self.base_s
        while True:
            prev = min(self.cap_s, self._rng.uniform(self.base_s, prev * 3))
            yield prev

    # -- classification --------------------------------------------------
    def is_retryable(self, exc: BaseException) -> bool:
        if isinstance(exc, BudgetExhausted):
            return False
        if self.classify is not None:
            verdict = self.classify(exc)
            if verdict is not None:
                return bool(verdict)
        if isinstance(exc, self.fatal):
            return False
        return isinstance(exc, self.retryable)

    # -- the loop --------------------------------------------------------
    def call(
        self,
        fn: Callable[[], Any],
        *,
        budget: TimeoutBudget | None = None,
        phase: str = "retry",
        on_retry: Callable[[int, float, BaseException], None] | None = None,
    ) -> Any:
        """Run ``fn`` under this policy; return its first successful value.

        Fatal errors propagate immediately; retryable ones are re-attempted
        up to ``max_attempts`` with jittered sleeps against the injected
        clock (or ``budget``, which raises its own typed error when the
        shared deadline runs out).  Exhaustion raises
        :class:`RetryExhausted` chained to the final cause.
        """
        delays = self.delays()
        last: BaseException | None = None
        for attempt in range(1, self.max_attempts + 1):
            if budget is not None:
                budget.check(phase)
            try:
                return fn()
            except BaseException as exc:
                if not self.is_retryable(exc):
                    raise
                last = exc
                if attempt >= self.max_attempts:
                    break
                delay = next(delays)
                if on_retry is not None:
                    on_retry(attempt, delay, exc)
                log.debug(
                    "retry %d/%d in %.3fs (%s): %s",
                    attempt,
                    self.max_attempts,
                    delay,
                    phase,
                    exc,
                )
                if budget is not None:
                    budget.sleep(delay, phase)
                else:
                    self.clock.sleep(delay)
        raise RetryExhausted(self.max_attempts, last) from last


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
