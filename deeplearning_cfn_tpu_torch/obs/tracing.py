"""Step tracing: wall-clock spans with per-name aggregates.  Counterpart of
``deeplearning_cfn_tpu/obs/tracing.py``, copied onto the port's recorder.

``with span("train_step"): ...`` times a block, folds the duration into
a process-wide per-name aggregate (count / total / max / last), and
records a ``span`` event on the flight recorder.  Spans measure *host*
wall time — under CUDA's asynchronous launches a span covers the issue of
the work, not its device execution; the trainer's loss readbacks are where
device time surfaces.

Aggregates are what ``dlcfn status --format prom`` exports, so the
overhead budget is the train-step hot path: one perf_counter pair, one
dict update under a lock, one ring append.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Iterator

from deeplearning_cfn_tpu_torch.obs.recorder import FlightRecorder, get_recorder


@dataclass
class SpanStats:
    """Running aggregate for one span name."""

    count: int = 0
    errors: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    last_s: float = 0.0

    def fold(self, seconds: float, ok: bool) -> None:
        self.count += 1
        if not ok:
            self.errors += 1
        self.total_s += seconds
        self.max_s = max(self.max_s, seconds)
        self.last_s = seconds

    def as_dict(self) -> dict[str, Any]:
        return {
            "count": self.count,
            "errors": self.errors,
            "total_s": round(self.total_s, 6),
            "max_s": round(self.max_s, 6),
            "last_s": round(self.last_s, 6),
        }


_aggregates: dict[str, SpanStats] = {}
_lock = threading.Lock()


@contextmanager
def span(
    name: str, recorder: FlightRecorder | None = None, **attrs: Any
) -> Iterator[None]:
    """Time a block; journal it and fold it into the name's aggregate."""
    t0 = time.perf_counter()
    ok = True
    try:
        yield
    except BaseException:
        ok = False
        raise
    finally:
        seconds = time.perf_counter() - t0
        with _lock:
            stats = _aggregates.get(name)
            if stats is None:
                stats = _aggregates[name] = SpanStats()
            stats.fold(seconds, ok)
        (recorder or get_recorder()).record(
            "span", span=name, seconds=round(seconds, 6), ok=ok, **attrs
        )


def span_aggregates() -> dict[str, dict[str, Any]]:
    """Snapshot of every span name's running aggregate."""
    with _lock:
        return {name: stats.as_dict() for name, stats in _aggregates.items()}


def reset_aggregates() -> None:
    with _lock:
        _aggregates.clear()
