"""Prometheus text exposition — the parts of ``deeplearning_cfn_tpu/obs/exporter.py``
that the live reshard, the cluster plane and the broker control plane surface.

Ported: the registry entries of the liveness, span, ``dlcfn_reshard_*``,
``dlcfn_mesh_*``, broker (``dlcfn_broker_*``, per node and per shard) and
fleet-telemetry (``dlcfn_fleet_*``) families, :func:`fold_reshard_events`,
:func:`fold_broker_events`, and :func:`render_prometheus` for those, whose
text is the JAX package's line for line.  Headers come from
:data:`METRIC_REGISTRY` through a per-render seen-set, so no family gets two
``# TYPE`` lines.  The other families (the input pipeline, the step profiler,
serving, comms, data plane, scheduler, replay, gauntlet) come with the slices
that port what feeds them.
"""

from __future__ import annotations

from typing import Any, Mapping

#: family name -> (prometheus type, help text).  Summary families list
#: the base name only; their ``_sum`` / ``_count`` children inherit the
#: header per the text format.
METRIC_REGISTRY: dict[str, tuple[str, str]] = {
    # liveness
    "dlcfn_worker_up": ("gauge", "1 while the worker's heartbeat is not DEAD."),
    "dlcfn_heartbeat_age_seconds": ("gauge", "Seconds since the worker's last heartbeat."),
    "dlcfn_heartbeats_total": ("counter", "Heartbeats observed from the worker."),
    "dlcfn_worker_dead_fraction": ("gauge", "Fraction of tracked workers currently declared dead."),
    # spans
    "dlcfn_span_count": ("counter", "Completed spans by name."),
    "dlcfn_span_seconds_total": ("counter", "Total wall seconds spent in spans."),
    "dlcfn_span_seconds_max": ("gauge", "Longest single span by name."),
    "dlcfn_span_seconds": ("summary", "Span duration quantiles over the journal window."),
    # elastic reshard
    "dlcfn_reshard_total": ("counter", "Live elastic reshards completed."),
    "dlcfn_reshard_seconds": ("gauge", "Total seconds spent pausing and resharding (injected clock)."),
    "dlcfn_reshard_fallback_total": ("counter", "Reshards that degraded to the checkpoint/restore path."),
    # mesh / contract
    "dlcfn_mesh_slices": ("gauge", "Slices in the current cluster contract."),
    "dlcfn_mesh_workers": ("gauge", "Worker hosts in the current cluster contract."),
    "dlcfn_mesh_chips_total": ("gauge", "Total chips across the current mesh."),
    # broker control plane
    "dlcfn_broker_role": ("gauge", "Broker role per node (1 = primary, 0 = standby)."),
    "dlcfn_broker_epoch": ("gauge", "Leadership term the node is fenced to."),
    "dlcfn_broker_up": ("gauge", "1 while the node answers on loopback."),
    "dlcfn_broker_replication_lag_seconds": ("gauge", "Age of the oldest journal entry the standby has not applied."),
    "dlcfn_broker_replication_lag_entries": ("gauge", "Journal entries the standby has not applied."),
    # sharded broker control plane (one pair per keyspace shard)
    "dlcfn_broker_shard_role": ("gauge", "Broker role per shard node (1 = primary, 0 = standby)."),
    "dlcfn_broker_shard_epoch": ("gauge", "Leadership term the shard node is fenced to."),
    "dlcfn_broker_shard_up": ("gauge", "1 while the shard node answers on loopback."),
    "dlcfn_broker_shard_replication_lag_seconds": ("gauge", "Age of the oldest journal entry the shard's standby has not applied."),
    "dlcfn_broker_shard_replication_lag_entries": ("gauge", "Journal entries the shard's standby has not applied."),
    # fleet telemetry (TELEM plane, obs/aggregator.py)
    "dlcfn_fleet_workers": ("gauge", "Workers with a fresh telemetry snapshot in the fleet merge."),
    "dlcfn_fleet_telemetry_age_seconds": ("gauge", "Age of each worker's newest telemetry snapshot."),
    "dlcfn_fleet_gauge": ("gauge", "Fleet-merged agent gauge (agg label: sum/max fleet-wide, last per worker)."),
    "dlcfn_fleet_summary": ("summary", "Fleet-merged sample summaries (quantiles over all hosts' samples)."),
}


def _escape(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _labels(**labels: str) -> str:
    body = ",".join(f'{k}="{_escape(str(v))}"' for k, v in labels.items() if v != "")
    return "{" + body + "}" if body else ""


def fold_reshard_events(events) -> dict[str, Any]:
    """Fold flight-journal ``reshard`` / ``reshard_fallback`` events into
    the counters the exporter and ``status`` surface.  Empty dict when the
    journal holds neither kind."""
    out: dict[str, Any] = {
        "total": 0,
        "seconds_total": 0.0,
        "fallback_total": 0,
        "last": None,
    }
    for event in events:
        kind = event.get("kind")
        if kind == "reshard":
            out["total"] += 1
            out["seconds_total"] = round(
                out["seconds_total"] + float(event.get("seconds") or 0.0), 6
            )
            out["last"] = {
                k: event.get(k)
                for k in (
                    "step",
                    "old_topology",
                    "new_topology",
                    "grad_accum_before",
                    "grad_accum_after",
                )
            }
        elif kind == "reshard_fallback":
            out["fallback_total"] += 1
    if not out["total"] and not out["fallback_total"]:
        return {}
    return out


def fold_broker_events(events) -> dict[str, Any]:
    """Fold flight-journal broker lifecycle events into the counters
    ``dlcfn status`` surfaces: ``broker_promoted`` (a standby adopted a
    dead primary's record) and ``standby_reprovisioned`` (the promoted
    primary healed its pair with a fresh standby — the self-healing half
    of the failover ladder).  Empty dict when the journal holds neither
    kind."""
    out: dict[str, Any] = {"promotions": 0, "reprovisions": 0}
    last: dict[str, Any] | None = None
    for event in events:
        kind = event.get("kind")
        if kind not in ("broker_promoted", "standby_reprovisioned"):
            continue
        out["promotions" if kind == "broker_promoted" else "reprovisions"] += 1
        last = event
    if last is None:
        return {}
    out["last_event"] = {
        key: last[key]
        for key in ("kind", "ts", "cluster", "epoch", "replayed")
        if key in last
    }
    return out


def render_prometheus(
    liveness: Mapping[str, Mapping[str, Any]] | None = None,
    spans: Mapping[str, Mapping[str, Any]] | None = None,
    cluster: str = "",
    reshard: Mapping[str, Any] | None = None,
    mesh: Mapping[str, Any] | None = None,
    broker: Mapping[str, Any] | None = None,
    fleet: Mapping[str, Any] | None = None,
) -> str:
    """Render the liveness snapshot, span aggregates, the reshard counters,
    the mesh shape, the broker's replication view and the fleet merge as
    Prometheus text.  ``liveness`` is ``LivenessTable.snapshot()``;
    ``spans`` is ``tracing.span_aggregates()`` (span dicts carrying
    ``p50_s`` / ``p95_s`` / ``p99_s`` additionally render as a summary-style
    ``dlcfn_span_seconds`` family); ``reshard`` is ``fold_reshard_events()``;
    ``mesh`` is the mesh/contract shape of ``status --cluster``; ``broker``
    is ``broker_service.broker_replication_status()`` (or its sharded
    form); ``fleet`` is ``obs.aggregator.FleetAggregator.merge()``.  Any may
    be None/empty."""
    lines: list[str] = []
    seen: set[str] = set()

    def head(name: str) -> None:
        # One HELP/TYPE header per family per render, straight from the
        # registry — folds can interleave without ever duplicating one.
        if name in seen:
            return
        seen.add(name)
        mtype, help_text = METRIC_REGISTRY[name]
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")

    if liveness:
        head("dlcfn_worker_up")
        for worker, row in liveness.items():
            labels = _labels(cluster=cluster, worker=worker, state=row["state"])
            lines.append(
                f"dlcfn_worker_up{labels} {0 if row['state'] == 'dead' else 1}"
            )
        head("dlcfn_heartbeat_age_seconds")
        for worker, row in liveness.items():
            labels = _labels(cluster=cluster, worker=worker)
            lines.append(f"dlcfn_heartbeat_age_seconds{labels} {row['age_s']}")
        head("dlcfn_heartbeats_total")
        for worker, row in liveness.items():
            labels = _labels(cluster=cluster, worker=worker)
            lines.append(f"dlcfn_heartbeats_total{labels} {row['beats']}")
    if spans:
        head("dlcfn_span_count")
        for name, agg in spans.items():
            lines.append(f"dlcfn_span_count{_labels(span=name)} {agg['count']}")
        head("dlcfn_span_seconds_total")
        for name, agg in spans.items():
            lines.append(
                f"dlcfn_span_seconds_total{_labels(span=name)} {agg['total_s']}"
            )
        head("dlcfn_span_seconds_max")
        for name, agg in spans.items():
            lines.append(f"dlcfn_span_seconds_max{_labels(span=name)} {agg['max_s']}")
        quantiled = {
            name: agg for name, agg in spans.items() if "p50_s" in agg
        }
        if quantiled:
            head("dlcfn_span_seconds")
            for name, agg in quantiled.items():
                for quantile, key in (
                    ("0.5", "p50_s"),
                    ("0.95", "p95_s"),
                    ("0.99", "p99_s"),
                ):
                    value = agg.get(key)
                    if value is None:
                        continue
                    lines.append(
                        f"dlcfn_span_seconds"
                        f"{_labels(span=name, quantile=quantile)} {value}"
                    )
                lines.append(
                    f"dlcfn_span_seconds_sum{_labels(span=name)} {agg['total_s']}"
                )
                lines.append(
                    f"dlcfn_span_seconds_count{_labels(span=name)} {agg['count']}"
                )
    if reshard:
        for name, key in (
            ("dlcfn_reshard_total", "total"),
            ("dlcfn_reshard_seconds", "seconds_total"),
            ("dlcfn_reshard_fallback_total", "fallback_total"),
        ):
            head(name)
            lines.append(f"{name}{_labels(cluster=cluster)} {reshard.get(key, 0)}")
    if mesh:
        for key in ("slices", "workers", "chips_total"):
            value = mesh.get(key)
            if value is None:
                continue
            head(f"dlcfn_mesh_{key}")
            lines.append(f"dlcfn_mesh_{key}{_labels(cluster=cluster)} {value}")
    if broker:
        for name in ("dlcfn_broker_role", "dlcfn_broker_epoch", "dlcfn_broker_up"):
            head(name)
        for node_name in ("primary", "standby"):
            node = broker.get(node_name)
            if not node:
                continue
            labels = _labels(
                cluster=cluster,
                node=node_name,
                endpoint=f"{node.get('host')}:{node.get('port')}",
            )
            role = node.get("role")
            lines.append(
                f"dlcfn_broker_role{labels} {1 if role == 'primary' else 0}"
            )
            lines.append(f"dlcfn_broker_epoch{labels} {node.get('epoch') or 0}")
            lines.append(f"dlcfn_broker_up{labels} {1 if node.get('alive') else 0}")
        lag_s = broker.get("lag_seconds")
        if lag_s is not None:
            head("dlcfn_broker_replication_lag_seconds")
            lines.append(
                f"dlcfn_broker_replication_lag_seconds{_labels(cluster=cluster)} {lag_s}"
            )
        lag_entries = broker.get("lag_entries")
        if lag_entries is not None:
            head("dlcfn_broker_replication_lag_entries")
            lines.append(
                f"dlcfn_broker_replication_lag_entries{_labels(cluster=cluster)} {lag_entries}"
            )
        shards = broker.get("shards")
        if shards:
            for name in (
                "dlcfn_broker_shard_role",
                "dlcfn_broker_shard_epoch",
                "dlcfn_broker_shard_up",
            ):
                head(name)
            for entry in shards:
                shard = entry.get("shard")
                status = entry.get("status") or {}
                for node_name in ("primary", "standby"):
                    node = status.get(node_name)
                    if not node:
                        continue
                    labels = _labels(
                        cluster=cluster,
                        shard=shard,
                        node=node_name,
                        endpoint=f"{node.get('host')}:{node.get('port')}",
                    )
                    role = node.get("role")
                    lines.append(
                        f"dlcfn_broker_shard_role{labels}"
                        f" {1 if role == 'primary' else 0}"
                    )
                    lines.append(
                        f"dlcfn_broker_shard_epoch{labels} {node.get('epoch') or 0}"
                    )
                    lines.append(
                        f"dlcfn_broker_shard_up{labels}"
                        f" {1 if node.get('alive') else 0}"
                    )
            for key in ("lag_seconds", "lag_entries"):
                rows = [
                    (e.get("shard"), (e.get("status") or {}).get(key))
                    for e in shards
                ]
                rows = [(s, v) for s, v in rows if v is not None]
                if not rows:
                    continue
                head(f"dlcfn_broker_shard_replication_{key}")
                for shard, value in rows:
                    lines.append(
                        f"dlcfn_broker_shard_replication_{key}"
                        f"{_labels(cluster=cluster, shard=shard)} {value}"
                    )
    if fleet:
        head("dlcfn_fleet_workers")
        lines.append(
            f"dlcfn_fleet_workers{_labels(cluster=cluster)} {fleet.get('hosts', 0)}"
        )
        workers = fleet.get("workers") or {}
        if workers:
            head("dlcfn_fleet_telemetry_age_seconds")
            for worker, row in workers.items():
                lines.append(
                    f"dlcfn_fleet_telemetry_age_seconds"
                    f"{_labels(cluster=cluster, worker=worker)} {row.get('age_s', 0)}"
                )
        gauges = fleet.get("gauges") or {}
        if gauges:
            head("dlcfn_fleet_gauge")
            for metric, slot in gauges.items():
                for agg in ("sum", "max"):
                    value = slot.get(agg)
                    if value is None:
                        continue
                    lines.append(
                        f"dlcfn_fleet_gauge"
                        f"{_labels(cluster=cluster, metric=metric, agg=agg)} {value}"
                    )
                for worker, value in (slot.get("last") or {}).items():
                    lines.append(
                        f"dlcfn_fleet_gauge"
                        f"{_labels(cluster=cluster, metric=metric, worker=worker, agg='last')}"
                        f" {value}"
                    )
        summaries = fleet.get("summaries") or {}
        if summaries:
            head("dlcfn_fleet_summary")
            for metric, slot in summaries.items():
                for quantile, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
                    value = slot.get(key)
                    if value is None:
                        continue
                    lines.append(
                        f"dlcfn_fleet_summary"
                        f"{_labels(cluster=cluster, metric=metric, quantile=quantile)}"
                        f" {value}"
                    )
                lines.append(
                    f"dlcfn_fleet_summary_sum"
                    f"{_labels(cluster=cluster, metric=metric)} {slot.get('sum', 0.0)}"
                )
                lines.append(
                    f"dlcfn_fleet_summary_count"
                    f"{_labels(cluster=cluster, metric=metric)} {slot.get('count', 0)}"
                )
        dead_fraction = fleet.get("dead_fraction")
        if dead_fraction is not None:
            head("dlcfn_worker_dead_fraction")
            lines.append(
                f"dlcfn_worker_dead_fraction{_labels(cluster=cluster)} {dead_fraction}"
            )
    return "\n".join(lines) + ("\n" if lines else "")
