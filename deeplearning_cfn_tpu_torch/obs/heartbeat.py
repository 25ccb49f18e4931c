"""Counterpart of ``deeplearning_cfn_tpu/obs/heartbeat.py``: the heartbeater.

A daemon thread that beats ``HEARTBEAT <worker_id>`` at a liveness table
every interval, with the JAX package's cooperative ``beat_step`` and its
reconnect-on-error rule.  The connection comes from ``connection_factory``,
any zero-argument callable returning an object with ``heartbeat(worker_id)``
and ``close()``: that is the seam a serve replica and the tests use.

Not ported yet: the broker client (a heartbeater with no factory) and the
telemetry piggyback (``telemetry_source``, which needs ``obs/aggregator``).
Asking for either raises ``NotImplementedError`` at construction.
"""

from __future__ import annotations

import os
import threading

from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder
from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.obs")

ENV_INTERVAL = "DLCFN_HEARTBEAT_S"
DEFAULT_INTERVAL_S = 10.0
_LATER_SLICE = ("a later slice of the PyTorch port (the broker client and service, with the "
                "telemetry piggyback of obs/aggregator)")


def heartbeat_interval_s() -> float:
    """Configured beat interval (``$DLCFN_HEARTBEAT_S``, default 10 s)."""
    try:
        value = float(os.environ.get(ENV_INTERVAL, ""))
    except ValueError:
        return DEFAULT_INTERVAL_S
    return value if value > 0 else DEFAULT_INTERVAL_S


class Heartbeater(threading.Thread):
    """Beats ``HEARTBEAT <worker_id>`` through ``connection_factory``'s
    connection every ``interval_s``."""

    def __init__(
        self,
        host: str,
        port: int,
        worker_id: str,
        interval_s: float | None = None,
        connection_factory=None,
        telemetry_source=None,
    ):
        if telemetry_source is not None:
            raise NotImplementedError(f"heartbeat telemetry is ported in {_LATER_SLICE}")
        if connection_factory is None:
            raise NotImplementedError(
                f"the broker client (heartbeats to {host}:{port}) is ported in "
                f"{_LATER_SLICE}; pass connection_factory"
            )
        super().__init__(name=f"heartbeater-{worker_id}", daemon=True)
        self.host = host
        self.port = port
        self.worker_id = worker_id
        self.interval_s = interval_s if interval_s is not None else heartbeat_interval_s()
        self._connection_factory = connection_factory
        self.beats_sent = 0
        # beats_sent is read by other threads; the loop increments it only
        # under this lock.
        self._lock = threading.Lock()
        # Not named _stop: threading.Thread's join calls a private _stop().
        self._halt = threading.Event()
        self._conn = None

    def _beat_once(self) -> None:
        if self._conn is None:
            self._conn = self._connection_factory()
        self._conn.heartbeat(self.worker_id)
        with self._lock:
            self.beats_sent += 1
            seq = self.beats_sent
        # Journaled with the sender's clock, outside the lock.
        get_recorder().record("heartbeat_sent", worker=self.worker_id, seq=seq)

    def beat_step(self) -> bool:
        """One protected beat (the body of the daemon loop); returns whether
        the beat landed.  On an error the connection is dropped and the next
        beat dials afresh."""
        try:
            self._beat_once()
            return True
        except Exception as exc:
            log.warning("heartbeat to %s:%d failed: %s", self.host, self.port, exc)
            self._close_conn()
            return False

    def run(self) -> None:
        get_recorder().record(
            "heartbeater_start", worker=self.worker_id, interval_s=self.interval_s
        )
        while not self._halt.is_set():
            self.beat_step()
            self._halt.wait(self.interval_s)
        self._close_conn()

    def _close_conn(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except Exception:
                pass
            self._conn = None

    def stop(self, join_timeout_s: float = 5.0) -> None:
        """Signal the loop to exit and wait (bounded) for it."""
        self._halt.set()
        if self.is_alive():
            self.join(timeout=join_timeout_s)
