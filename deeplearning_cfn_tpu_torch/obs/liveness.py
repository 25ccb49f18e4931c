"""Worker liveness state machine: ALIVE → SUSPECT → DEAD on silence.

Counterpart of ``deeplearning_cfn_tpu/obs/liveness.py``, copied (the port imports
nothing of the JAX package).

The broker only stores last-heartbeat timestamps (native/broker/
broker.cpp keeps C++ dumb on purpose); the *interpretation* — how much
silence means suspect, how much means dead — lives here, Python-side,
where it is configurable and testable with an injected clock.

Transitions are monotone while a worker stays silent (a DEAD worker
that beats again is resurrected to ALIVE — brokers survive partitions),
and every transition is journaled plus handed to ``on_transition`` so
the broker service can publish ``INSTANCE_TERMINATE`` for DEAD workers
(cluster/broker_service.py BrokerLivenessWatcher).
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from deeplearning_cfn_tpu_torch.obs.recorder import FlightRecorder, get_recorder


class WorkerState(str, enum.Enum):
    ALIVE = "alive"
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclass(frozen=True)
class LivenessConfig:
    """Silence thresholds, in seconds of heartbeat age."""

    suspect_after_s: float = 15.0
    dead_after_s: float = 60.0

    def __post_init__(self) -> None:
        if not 0 < self.suspect_after_s <= self.dead_after_s:
            raise ValueError(
                "need 0 < suspect_after_s <= dead_after_s, got "
                f"{self.suspect_after_s} / {self.dead_after_s}"
            )

    def classify(self, age_s: float) -> WorkerState:
        if age_s >= self.dead_after_s:
            return WorkerState.DEAD
        if age_s >= self.suspect_after_s:
            return WorkerState.SUSPECT
        return WorkerState.ALIVE


@dataclass
class _Worker:
    last_beat: float
    beats: int = 0
    state: WorkerState = WorkerState.ALIVE


Transition = tuple[str, WorkerState, WorkerState]


@dataclass
class LivenessTable:
    """Tracks heartbeat recency per worker and classifies silence.

    ``clock`` is injectable (monotonic by default) so tests drive time
    explicitly instead of sleeping.
    """

    config: LivenessConfig = field(default_factory=LivenessConfig)
    clock: Callable[[], float] = time.monotonic
    on_transition: Callable[[Transition], None] | None = None
    recorder: FlightRecorder | None = None
    _workers: dict[str, _Worker] = field(default_factory=dict)

    def beat(self, worker_id: str, count: int | None = None) -> None:
        """Record a fresh heartbeat (direct observation, age zero)."""
        self.observe(worker_id, age_s=0.0, count=count)

    def observe(self, worker_id: str, age_s: float, count: int | None = None) -> None:
        """Record that ``worker_id``'s last beat was ``age_s`` seconds ago.

        This is the broker-poll path: the broker reports ages, not
        events, so the table back-dates last_beat accordingly.
        """
        now = self.clock()
        worker = self._workers.get(worker_id)
        if worker is None:
            worker = self._workers[worker_id] = _Worker(last_beat=now - age_s)
        else:
            worker.last_beat = max(worker.last_beat, now - age_s)
        if count is not None:
            worker.beats = max(worker.beats, count)
        else:
            worker.beats += 1

    def expect(self, worker_id: str) -> None:
        """Register a worker that *should* beat, starting its clock now.

        A worker that never sends a single heartbeat still marches
        through SUSPECT to DEAD from registration time.
        """
        if worker_id not in self._workers:
            self._workers[worker_id] = _Worker(last_beat=self.clock())

    def sweep(self) -> list[Transition]:
        """Re-classify every worker; returns (and journals) transitions."""
        now = self.clock()
        transitions: list[Transition] = []
        for worker_id, worker in self._workers.items():
            new = self.config.classify(now - worker.last_beat)
            if new is worker.state:
                continue
            transition = (worker_id, worker.state, new)
            worker.state = new
            transitions.append(transition)
            (self.recorder or get_recorder()).record(
                "liveness",
                worker=worker_id,
                from_state=transition[1].value,
                to_state=new.value,
                age_s=round(now - worker.last_beat, 3),
            )
            if self.on_transition is not None:
                self.on_transition(transition)
        return transitions

    def state(self, worker_id: str) -> WorkerState | None:
        worker = self._workers.get(worker_id)
        return worker.state if worker else None

    def snapshot(self) -> dict[str, dict[str, Any]]:
        """Per-worker view for ``dlcfn status`` and the exporter."""
        now = self.clock()
        return {
            worker_id: {
                "state": worker.state.value,
                "age_s": round(max(0.0, now - worker.last_beat), 3),
                "beats": worker.beats,
            }
            for worker_id, worker in sorted(self._workers.items())
        }
