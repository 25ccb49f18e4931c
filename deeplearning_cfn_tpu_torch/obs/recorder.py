"""Counterpart of ``deeplearning_cfn_tpu/obs/recorder.py``: the flight recorder.

A bounded ring of structured events, mirrored as strict JSONL to a journal
file when one is configured.  The journal format is the JAX package's, line
for line (``{"ts", "kind", host, pid, [cluster], [worker], fields...}``,
``json.dumps(..., allow_nan=False, default=str)``, rotation to ``<path>.1``),
so the JAX package's ``read_journal`` and ``fold_serve_events`` read a
journal the port wrote.  Ported: ``FlightRecorder``, ``configure``,
``get_recorder`` and ``read_journal``, what the serving plane uses.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Iterator

ENV_JOURNAL = "DLCFN_FLIGHT_JOURNAL"


def _safe(obj: dict[str, Any]) -> dict[str, Any]:
    """Plain scalars pass as they are (non-finite floats become None); any
    other value takes ``train.metrics.json_safe``, imported lazily."""
    out = {}
    for key, value in obj.items():
        t = type(value)
        if t is str or t is bool or t is int or value is None:
            out[key] = value
        elif t is float:
            out[key] = (
                value if value == value and value not in (float("inf"), float("-inf")) else None
            )
        else:
            from deeplearning_cfn_tpu_torch.train.metrics import json_safe

            out[key] = json_safe(value)
    return out


def _identity() -> dict[str, Any]:
    ident: dict[str, Any] = {"host": socket.gethostname(), "pid": os.getpid()}
    cluster = os.environ.get("DLCFN_CLUSTER")
    if cluster:
        ident["cluster"] = cluster
    worker = os.environ.get("DLCFN_WORKER")
    if worker:
        ident["worker"] = worker
    return ident


class FlightRecorder:
    """Bounded ring of structured events, optionally mirrored to JSONL."""

    def __init__(
        self,
        path: str | Path | None = None,
        max_events: int = 4096,
        max_file_lines: int = 100_000,
    ):
        self._events: deque[dict[str, Any]] = deque(maxlen=max_events)
        self._lock = threading.Lock()
        self._path = Path(path) if path else None
        self._fh = None
        self._file_lines = 0
        self._max_file_lines = max(1, max_file_lines)
        self._identity = _identity()
        if self._path is not None:
            self._path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self._path, "a", encoding="utf-8")

    @property
    def path(self) -> Path | None:
        return self._path

    def record(self, kind: str, **fields: Any) -> dict[str, Any]:
        """Append one event; returns the (json-safe) event dict."""
        event: dict[str, Any] = {"ts": round(time.time(), 6), "kind": kind}
        event.update(self._identity)
        event.update(fields)
        event = _safe(event)
        with self._lock:
            self._events.append(event)
            if self._fh is not None:
                # default=str: a journal never crashes its host process over
                # an exotic payload; it stringifies and stays strict JSON.
                self._fh.write(json.dumps(event, allow_nan=False, default=str) + "\n")
                self._fh.flush()
                self._file_lines += 1
                if self._file_lines >= self._max_file_lines:
                    self._rotate_locked()
        return event

    def _rotate_locked(self) -> None:
        self._fh.close()
        os.replace(self._path, self._path.with_suffix(self._path.suffix + ".1"))
        self._fh = open(self._path, "a", encoding="utf-8")
        self._file_lines = 0

    def tail(self, n: int = 100) -> list[dict[str, Any]]:
        with self._lock:
            events = list(self._events)
        return events[-n:]

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


_default: FlightRecorder | None = None
_default_lock = threading.Lock()


def configure(path: str | Path | None = None, max_events: int = 4096) -> FlightRecorder:
    """Install the process-wide default recorder (closing any previous)."""
    global _default
    with _default_lock:
        if _default is not None:
            _default.close()
        _default = FlightRecorder(path=path, max_events=max_events)
        return _default


def get_recorder() -> FlightRecorder:
    """The process-wide recorder, created on first use: journals to
    ``$DLCFN_FLIGHT_JOURNAL`` when set, else in memory only."""
    global _default
    with _default_lock:
        if _default is None:
            _default = FlightRecorder(path=os.environ.get(ENV_JOURNAL) or None)
        return _default


def read_journal(
    path: str | Path, limit: int | None = None, kind: str | None = None
) -> Iterator[dict[str, Any]]:
    """Parse a JSONL journal back into event dicts, the rotation
    (``<path>.1``) first; a torn final line is skipped."""
    path = Path(path)
    events: list[dict[str, Any]] = []
    for part in (path.with_suffix(path.suffix + ".1"), path):
        if not part.exists():
            continue
        with open(part, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    event = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if kind is not None and event.get("kind") != kind:
                    continue
                events.append(event)
    if limit is not None:
        events = events[-limit:]
    return iter(events)
