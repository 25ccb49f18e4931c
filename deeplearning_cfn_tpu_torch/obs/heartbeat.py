"""Agent-side heartbeater: a daemon thread beating HEARTBEAT at the broker.

Counterpart of ``deeplearning_cfn_tpu/obs/heartbeat.py``, copied (the port
imports nothing of the JAX package).

Each worker agent runs one :class:`Heartbeater`; the supervisor side
(cluster/broker_service.py BrokerLivenessWatcher) polls the broker's
heartbeat table and drives the :mod:`~deeplearning_cfn_tpu_torch.obs.liveness`
state machine.  The thread owns its own connection and reconnects with
a fresh dial on any error — a broker restart costs one missed interval,
not a dead worker.

cluster.broker_client is imported lazily: obs must stay importable
before (and without) the cluster layer, which itself imports
obs.tracing for RPC spans.
"""

from __future__ import annotations

import os
import threading

from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder
from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.obs")

ENV_INTERVAL = "DLCFN_HEARTBEAT_S"
DEFAULT_INTERVAL_S = 10.0


def heartbeat_interval_s() -> float:
    """Configured beat interval (``$DLCFN_HEARTBEAT_S``, default 10s)."""
    raw = os.environ.get(ENV_INTERVAL, "")
    try:
        value = float(raw)
    except ValueError:
        return DEFAULT_INTERVAL_S
    return value if value > 0 else DEFAULT_INTERVAL_S


class Heartbeater(threading.Thread):
    """Beats ``HEARTBEAT <worker_id>`` at the broker every interval.

    ``telemetry_source``: optional zero-arg callable returning the
    agent's current gauge/summary snapshot (the shape
    ``obs.aggregator.encode_snapshot`` accepts) or ``None`` to skip a
    cycle.  When set, every successful beat piggybacks one ``TELEM``
    frame on the SAME connection — fleet telemetry costs zero extra
    dials and inherits the beat cadence.  A telemetry failure is
    contained: the beat already landed, so liveness never regresses
    because a snapshot didn't.
    """

    def __init__(
        self,
        host: str,
        port: int,
        worker_id: str,
        token: str | None = None,
        interval_s: float | None = None,
        connect_timeout_s: float = 10.0,
        connection_factory=None,
        telemetry_source=None,
    ):
        # token=None -> BrokerConnection's ambient $DLCFN_BROKER_TOKEN
        # (how agents authenticate); pass "" for an open dev broker.
        super().__init__(name=f"heartbeater-{worker_id}", daemon=True)
        self.host = host
        self.port = port
        self.worker_id = worker_id
        self.token = token
        self.interval_s = (
            interval_s if interval_s is not None else heartbeat_interval_s()
        )
        self.connect_timeout_s = connect_timeout_s
        # connection_factory: () -> an object with heartbeat()/close().
        # The seam the deterministic interleaving harness
        # (analysis/schedules.py) injects a simulated broker through, so
        # beat_step() can be driven cooperatively without sockets.
        self._connection_factory = connection_factory
        self._telemetry_source = telemetry_source
        self.beats_sent = 0
        self.snapshots_sent = 0
        # beats_sent is read by other threads (status displays, tests);
        # the daemon loop increments it only under this lock.
        self._lock = threading.Lock()
        # not named _stop: threading.Thread's join internals
        # call a private _stop() method of that name.
        self._halt = threading.Event()
        self._conn = None

    def _dial(self):
        if self._connection_factory is not None:
            return self._connection_factory()
        from deeplearning_cfn_tpu_torch.cluster.broker_client import BrokerConnection

        return BrokerConnection(
            self.host,
            self.port,
            token=self.token,
            timeout_s=self.connect_timeout_s,
        )

    def _beat_once(self) -> None:
        if self._conn is None:
            self._conn = self._dial()
        self._conn.heartbeat(self.worker_id)
        with self._lock:
            self.beats_sent += 1
            seq = self.beats_sent
        # Journaled with the SENDER's clock, outside the lock: matched
        # against the supervisor's heartbeat_observed event (same worker,
        # same seq) by obs/trace_export.py to recover cross-host clock
        # offsets for the merged timeline.
        get_recorder().record("heartbeat_sent", worker=self.worker_id, seq=seq)
        self._ship_telemetry()

    def _ship_telemetry(self) -> None:
        if self._telemetry_source is None or self._conn is None:
            return
        telem = getattr(self._conn, "telem", None)
        if telem is None:
            return  # connection seam predates TELEM (old sim); skip quietly
        try:
            snapshot = self._telemetry_source()
            if snapshot is None:
                return
            from deeplearning_cfn_tpu_torch.obs.aggregator import encode_snapshot

            telem(self.worker_id, encode_snapshot(snapshot))
            with self._lock:
                self.snapshots_sent += 1
        except Exception as exc:
            # Contained: the beat landed; a telemetry hiccup must not
            # tear down the connection liveness depends on.
            log.warning(
                "telemetry from %s failed: %s", self.worker_id, exc
            )

    def beat_step(self) -> bool:
        """One protected beat iteration (the body of the daemon loop).

        Public so the interleaving harness can drive the REAL beat +
        reconnect logic cooperatively; returns whether the beat landed.
        """
        try:
            self._beat_once()
            return True
        except Exception as exc:
            # Drop the wedged connection; next beat dials fresh.
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
