"""Fleet telemetry: agent snapshots over TELEM, merged controller-side.

Counterpart of ``deeplearning_cfn_tpu/obs/aggregator.py``, copied (the port
imports nothing of the JAX package): the snapshot bytes are the JAX
package's, byte for byte.

Every observability surface before this module was per-host; ROADMAP
items 3 (autoscale) and 5 (10k agents) need ONE fleet-wide view.  The
design piggybacks on planes that already exist:

* **Agent side** — :func:`agent_snapshot` builds a compact dict of
  gauges (scalar, last-write-wins per worker) and summaries (bounded
  raw-sample lists — the mergeable form; per-host p99s cannot be
  merged, samples can).  :func:`encode_snapshot` serializes it through
  ``json_safe`` with ``allow_nan=False`` so a snapshot line always
  parses (NaN/Inf become null, exactly like the flight journal).  The
  :class:`~deeplearning_cfn_tpu_torch.obs.heartbeat.Heartbeater` ships it via
  the ``TELEM`` broker verb on the SAME connection and cadence as the
  beat — fleet telemetry costs zero extra dials.

* **Broker** — stores only (payload, steady-clock age, count) per
  worker and replicates TELEM frames through the PR 10 journal, so the
  fleet view survives a primary failover with at most the unshipped
  tail lost (the same bound the queue plane has).

* **Controller side** — :class:`FleetAggregator` merges the dump:
  gauges fold as sum / max / last-by-worker, summaries concatenate
  samples and reduce to quantiles once, fleet-wide.  The merge is
  deterministic (sorted worker order) so chaos reports built on it are
  byte-identical per seed.  ``dlcfn status --fleet`` renders the
  aggregate as json or Prometheus text (obs/exporter.py), and the SLO
  engine (obs/slo.py) evaluates alert rules over
  :func:`fleet_metric_values`.

Metric names inside snapshots are the exporter's registered families
(``dlcfn_*``, see ``obs.exporter.METRIC_REGISTRY``); the SLO schema
check in scripts/check.sh rejects rules referencing anything else.
"""

from __future__ import annotations

import json
import math
from typing import Any, Callable, Mapping, Sequence

from deeplearning_cfn_tpu_torch.obs.recorder import json_safe

SNAPSHOT_VERSION = 1

#: Per-host bound on samples shipped per summary metric: keeps the
#: heartbeat-path encode O(gauge count + capped samples) and the TELEM
#: payload small regardless of how long the agent has been running.
MAX_SUMMARY_SAMPLES = 64

#: Snapshots older than this are dropped from the merge — a worker that
#: stopped shipping (dead, partitioned) must not pin stale gauges into
#: the fleet view forever.  Interpretation is controller-side and
#: configurable, like liveness thresholds.
DEFAULT_STALE_AFTER_S = 120.0


def agent_snapshot(
    gauges: Mapping[str, float] | None = None,
    summaries: Mapping[str, Sequence[float]] | None = None,
    profiler: Any = None,
) -> dict[str, Any]:
    """One agent's current telemetry: ``{"v", "gauges", "summaries"}``.

    ``profiler`` (a :class:`~deeplearning_cfn_tpu_torch.obs.profiler.StepProfiler`)
    contributes its rolling step-time window as the ``dlcfn_step_ms``
    summary.  Callers add serving/queue gauges under their registered
    exporter names.
    """
    snap: dict[str, Any] = {
        "v": SNAPSHOT_VERSION,
        "gauges": {str(k): v for k, v in (gauges or {}).items()},
        "summaries": {
            str(k): list(v)[-MAX_SUMMARY_SAMPLES:]
            for k, v in (summaries or {}).items()
        },
    }
    if profiler is not None:
        samples = profiler.recent_step_ms()
        if samples:
            snap["summaries"]["dlcfn_step_ms"] = samples[-MAX_SUMMARY_SAMPLES:]
    return snap


def encode_snapshot(snapshot: Mapping[str, Any]) -> bytes:
    """Serialize a snapshot for the TELEM payload.

    Strict JSON like the flight journal: values route through
    ``obs.recorder.json_safe`` (NaN/Inf -> null, 0-d numpy scalars and
    tensors -> plain Python) and ``allow_nan=False`` guarantees the wire bytes
    always re-parse.  Summary sample lists are re-capped here so a
    caller handing an unbounded list cannot bloat the heartbeat path.
    """
    body = {
        "v": int(snapshot.get("v", SNAPSHOT_VERSION)),
        "gauges": json_safe(dict(snapshot.get("gauges") or {})),
        "summaries": {
            str(k): json_safe(list(v)[-MAX_SUMMARY_SAMPLES:])
            for k, v in (snapshot.get("summaries") or {}).items()
        },
    }
    return json.dumps(
        body, allow_nan=False, sort_keys=True, separators=(",", ":")
    ).encode()


def decode_snapshot(payload: bytes) -> dict[str, Any] | None:
    """Parse a TELEM payload; ``None`` for torn/foreign bytes (a merge
    must survive one corrupt snapshot without dropping the fleet)."""
    try:
        body = json.loads(payload.decode())
    except (UnicodeDecodeError, ValueError):
        return None
    if not isinstance(body, dict):
        return None
    return body


def _quantile(ordered: Sequence[float], q: float) -> float:
    """Nearest-rank on the sorted sample list — the same reduction
    RollingQuantiles uses, so per-host and fleet-wide views agree on a
    single host."""
    n = len(ordered)
    return ordered[min(n - 1, round(q * (n - 1)))]


def _finite(value: Any) -> float | None:
    try:
        out = float(value)
    except (TypeError, ValueError):
        return None
    return out if math.isfinite(out) else None


class FleetAggregator:
    """Merge per-worker TELEM snapshots into one fleet aggregate.

    ``merge`` consumes the telemetry-dump shape both the real client
    (``BrokerConnection.telemetry()``) and the sim twin
    (``SimBrokerNode.dump_telem()``) produce: ``worker -> (age_s,
    count, payload_bytes)``.  Iteration is over sorted worker names and
    quantiles reduce once over the concatenated samples, so the output
    is a pure function of the input table — byte-deterministic.
    """

    def __init__(self, stale_after_s: float = DEFAULT_STALE_AFTER_S):
        self.stale_after_s = float(stale_after_s)

    def merge(
        self,
        table: Mapping[str, tuple[float, int, bytes]],
        liveness: Mapping[str, Mapping[str, Any]] | None = None,
    ) -> dict[str, Any]:
        workers: dict[str, dict[str, Any]] = {}
        gauges: dict[str, dict[str, Any]] = {}
        samples: dict[str, list[float]] = {}
        dropped_stale = 0
        dropped_corrupt = 0
        for worker in sorted(table):
            age_s, count, payload = table[worker]
            if age_s > self.stale_after_s:
                dropped_stale += 1
                continue
            body = decode_snapshot(payload)
            if body is None:
                dropped_corrupt += 1
                continue
            workers[worker] = {"age_s": round(float(age_s), 6), "count": int(count)}
            for name in sorted(body.get("gauges") or {}):
                value = _finite((body["gauges"] or {}).get(name))
                if value is None:
                    continue
                slot = gauges.setdefault(
                    name, {"sum": 0.0, "max": None, "last": {}}
                )
                slot["sum"] += value
                slot["max"] = value if slot["max"] is None else max(slot["max"], value)
                slot["last"][worker] = value
            for name in sorted(body.get("summaries") or {}):
                values = (body["summaries"] or {}).get(name) or []
                bucket = samples.setdefault(name, [])
                bucket.extend(
                    v for v in (_finite(x) for x in values) if v is not None
                )
        summaries: dict[str, dict[str, Any]] = {}
        for name in sorted(samples):
            ordered = sorted(samples[name])
            if not ordered:
                summaries[name] = {"count": 0, "sum": 0.0}
                continue
            summaries[name] = {
                "count": len(ordered),
                "sum": round(sum(ordered), 6),
                "p50": round(_quantile(ordered, 0.50), 6),
                "p95": round(_quantile(ordered, 0.95), 6),
                "p99": round(_quantile(ordered, 0.99), 6),
            }
        aggregate: dict[str, Any] = {
            "hosts": len(workers),
            "workers": workers,
            "gauges": {
                name: {
                    "sum": round(slot["sum"], 6),
                    "max": round(slot["max"], 6),
                    "last": {w: round(v, 6) for w, v in sorted(slot["last"].items())},
                }
                for name, slot in sorted(gauges.items())
            },
            "summaries": summaries,
            "dropped_stale": dropped_stale,
            "dropped_corrupt": dropped_corrupt,
        }
        if liveness is not None:
            total = len(liveness)
            dead = sum(
                1 for row in liveness.values() if row.get("state") == "dead"
            )
            aggregate["dead_fraction"] = (
                round(dead / total, 6) if total else 0.0
            )
        return aggregate


def fleet_metric_values(aggregate: Mapping[str, Any]) -> dict[str, dict[str, float]]:
    """Flatten a merged aggregate into ``metric -> {agg: value}`` — the
    view the SLO engine resolves rule references against.

    Gauges expose ``sum`` / ``max``; summaries expose ``p50`` / ``p95``
    / ``p99`` / ``count``; the synthesized fleet metrics expose
    ``value``.  Missing metrics are simply absent — a rule over an
    absent metric does not fire (no data is not a breach).
    """
    values: dict[str, dict[str, float]] = {}
    for name, slot in (aggregate.get("gauges") or {}).items():
        entry: dict[str, float] = {}
        for agg in ("sum", "max"):
            v = _finite(slot.get(agg))
            if v is not None:
                entry[agg] = v
        if entry:
            values[name] = entry
    for name, slot in (aggregate.get("summaries") or {}).items():
        entry = {}
        for agg in ("p50", "p95", "p99", "count"):
            v = _finite(slot.get(agg))
            if v is not None:
                entry[agg] = v
        if entry:
            values[name] = entry
    values["dlcfn_fleet_workers"] = {"value": float(aggregate.get("hosts") or 0)}
    dead_fraction = _finite(aggregate.get("dead_fraction"))
    if dead_fraction is not None:
        values["dlcfn_worker_dead_fraction"] = {"value": dead_fraction}
    return values


def telemetry_source(
    worker_id: str,
    profiler: Any = None,
    gauges: Callable[[], Mapping[str, float]] | None = None,
) -> Callable[[], dict[str, Any]]:
    """Build the zero-arg callable ``Heartbeater(telemetry_source=...)``
    wants: a fresh snapshot per beat from the live profiler window plus
    optional dynamic gauges.  ``worker_id`` only names the closure for
    logs — identity on the wire comes from the TELEM frame itself."""

    def produce() -> dict[str, Any]:
        return agent_snapshot(
            gauges=gauges() if gauges is not None else None,
            profiler=profiler,
        )

    produce.__name__ = f"telemetry_source[{worker_id}]"
    return produce
