"""Counterpart of ``deeplearning_cfn_tpu/obs/recorder.py``: the flight recorder.

A bounded ring of structured events, mirrored as strict JSONL to a journal
file when one is configured.  The journal format is the JAX package's, line
for line (``{"ts", "kind", host, pid, [cluster], [worker], fields...}``,
``json.dumps(..., allow_nan=False, default=str)``, rotation to ``<path>.1``),
so the JAX package's ``read_journal`` and ``fold_serve_events`` read a
journal the port wrote.  Ported: ``FlightRecorder``, ``configure``,
``get_recorder``, ``read_journal``, ``follow_journal`` (the ``events``
command's live mode) and ``attach_event_bus`` (the provisioner's lifecycle
events).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import weakref
from collections import deque
from pathlib import Path
from typing import Any, Callable, Iterator

ENV_JOURNAL = "DLCFN_FLIGHT_JOURNAL"


def json_safe(obj):
    """Recursively map non-finite floats to None so the result serializes
    under ``json.dumps(..., allow_nan=False)``; 0-d tensors and numpy
    scalars unwrap to Python numbers first.  Kept here, free of ``torch``,
    so the on-VM agent's journal and telemetry never import it;
    ``train.metrics`` re-exports it."""
    if isinstance(obj, float):
        if obj != obj or obj in (float("inf"), float("-inf")):
            return None
        return obj
    if getattr(obj, "shape", None) == () and hasattr(obj, "item"):
        return json_safe(obj.item())
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj


def _safe(obj: dict[str, Any]) -> dict[str, Any]:
    """Plain scalars pass as they are (non-finite floats become None); any
    other value takes :func:`json_safe`."""
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
        self._attached_buses: "weakref.WeakSet" = weakref.WeakSet()
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

    def attach_event_bus(self, bus) -> None:
        """Mirror every provisioner lifecycle event into the journal.

        Idempotent per bus: a backend shared by several provisioner
        generations must not journal each event once per generation.
        """
        with self._lock:
            if bus in self._attached_buses:
                return
            self._attached_buses.add(bus)

        def _on_event(event) -> None:
            self.record(
                "lifecycle",
                event=getattr(event.kind, "value", str(event.kind)),
                group=event.group,
                instance_id=event.instance_id,
                detail=dict(event.detail),
            )

        bus.subscribe(_on_event)

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


def _parse_journal_lines(
    lines: list[str], kind: str | None
) -> Iterator[dict[str, Any]]:
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            event = json.loads(line)
        except json.JSONDecodeError:
            continue
        if kind is not None and event.get("kind") != kind:
            continue
        yield event


def follow_journal(
    path: str | Path,
    kind: str | None = None,
    poll_s: float = 0.5,
    sleep: Callable[[float], None] = time.sleep,
    stop: Callable[[], bool] | None = None,
) -> Iterator[dict[str, Any]]:
    """Yield journal events as they are appended — ``tail -F`` semantics.

    Emits the rotation (``<path>.1``) and any existing live-file content
    first, then polls for new bytes.  A torn trailing line stays
    buffered until its newline arrives.  Rotation is detected by inode:
    ``FlightRecorder`` rotates with ``os.replace``, which leaves the old
    file readable through the open handle — the handle is drained to EOF
    before reopening the new live file, so no event is skipped across a
    rotation.  Waits for ``path`` to appear if it does not exist yet.

    ``sleep`` and ``stop`` are injectable so tests drive the poll loop
    deterministically without wall-clock waits; ``stop`` is checked once
    per poll after a full drain, so everything written before it flips
    is still yielded.  No deadline arithmetic — the loop is purely
    poll-driven.
    """
    path = Path(path)
    rotated = path.with_suffix(path.suffix + ".1")
    if rotated.exists():
        with open(rotated, encoding="utf-8") as fh:
            yield from _parse_journal_lines(fh.read().split("\n"), kind)
    fh = None
    buf = ""
    try:
        while True:
            if fh is None and path.exists():
                fh = open(path, encoding="utf-8")
                buf = ""
            if fh is not None:
                chunk = fh.read()
                if chunk:
                    buf += chunk
                    *complete, buf = buf.split("\n")
                    yield from _parse_journal_lines(complete, kind)
                else:
                    # At EOF: if the live path now names a different file
                    # (rotation happened), this handle is fully drained —
                    # switch to the new file without sleeping.
                    try:
                        live_ino = os.stat(path).st_ino
                    except FileNotFoundError:
                        live_ino = None
                    if live_ino != os.fstat(fh.fileno()).st_ino:
                        fh.close()
                        fh = None
                        continue
            if stop is not None and stop():
                return
            sleep(poll_s)
    finally:
        if fh is not None:
            fh.close()
