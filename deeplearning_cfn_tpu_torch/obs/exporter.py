"""Prometheus text exposition — counterpart of ``deeplearning_cfn_tpu/obs/exporter.py``.

``status --format prom`` renders through here; the output follows the text
format (``# HELP`` / ``# TYPE`` then ``name{labels} value``), so a textfile
collector or a pushgateway cron can scrape it without a client library.

Every family this module may emit is declared once in :data:`METRIC_REGISTRY`
(name, type, help), and headers are rendered only from it through a
per-render seen-set, so two folds that touch one family never produce two
``# TYPE`` lines.  The registry is also what SLO rules are validated against
(``obs/slo.validate_rules``).  A copy of the JAX module (it imports nothing):
every fold and family renders the JAX package's text line for line.  The
gauntlet fold reads the ``gauntlet`` events that ``chaos/gauntlet.py``
journals (a run, a sweep); the comms and replay folds read events that no
part of the port writes yet (they come with the port of ``analysis/``),
and are pure functions of the events all the same.
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
    # input pipeline
    "dlcfn_input_pipeline_bytes_transferred": ("gauge", "Host->device bytes moved by the input pipeline."),
    "dlcfn_input_pipeline_host_input_seconds": ("gauge", "Seconds producers spent in the source iterator."),
    "dlcfn_input_pipeline_producer_stall_seconds": ("gauge", "Seconds producers blocked on a full buffer."),
    "dlcfn_input_pipeline_consumer_wait_seconds": ("gauge", "Seconds the training loop waited for input."),
    "dlcfn_input_pipeline_overlap_fraction": ("gauge", "Fraction of the run with input hidden behind compute."),
    # elastic reshard
    "dlcfn_reshard_total": ("counter", "Live elastic reshards completed."),
    "dlcfn_reshard_seconds": ("gauge", "Total seconds spent pausing and resharding (injected clock)."),
    "dlcfn_reshard_fallback_total": ("counter", "Reshards that degraded to the checkpoint/restore path."),
    # mesh / contract
    "dlcfn_mesh_slices": ("gauge", "Slices in the current cluster contract."),
    "dlcfn_mesh_workers": ("gauge", "Worker hosts in the current cluster contract."),
    "dlcfn_mesh_chips_total": ("gauge", "Total chips across the current mesh."),
    # step profiler
    "dlcfn_step_phase_ms": ("summary", "Step-phase duration quantiles (rolling window)."),
    "dlcfn_step_ms": ("summary", "Whole-step duration quantiles (rolling window)."),
    # serving
    "dlcfn_serve_active_slots": ("gauge", "Decode slots currently occupied on the replica."),
    "dlcfn_serve_queue_depth": ("gauge", "Requests admitted but not yet slotted."),
    "dlcfn_serve_tokens_per_s": ("gauge", "Sampled tokens per second (replica lifetime)."),
    "dlcfn_serve_ttft_ms": ("summary", "Time-to-first-token quantiles (replica lifetime)."),
    # comms audit
    "dlcfn_comms_collective_bytes": ("gauge", "Bytes moved by collectives per execution of the audited program."),
    "dlcfn_comms_peak_hbm_bytes": ("gauge", "Peak-HBM estimate (args + outputs + temps - aliased) of the audited program."),
    "dlcfn_comms_collective_count": ("gauge", "Collective ops (all-gather/all-reduce/...) in the audited program's HLO."),
    "dlcfn_comms_overlap_score": ("gauge", "Mean compute slack per collective in the audited program's optimized schedule (DLC512 ratchet)."),
    "dlcfn_replay_cases": ("gauge", "Cases (chaos scenarios + fleet soaks) double-run by the last replay audit."),
    "dlcfn_replay_divergent": ("gauge", "Cases whose same-seed double runs produced different report bytes."),
    "dlcfn_replay_clean": ("gauge", "1 when the last replay audit was byte-identical everywhere, else 0."),
    # chaos gauntlet (the JAX package's chaos/gauntlet.py)
    "dlcfn_gauntlet_runs_total": ("counter", "Composed-incident gauntlet runs journaled."),
    "dlcfn_gauntlet_passed": ("gauge", "1 when the last gauntlet run held every cross-subsystem invariant, else 0."),
    "dlcfn_gauntlet_faults_injected": ("gauge", "Fault events in the last gauntlet run's schedule."),
    "dlcfn_gauntlet_violations": ("gauge", "Invariant violations in the last gauntlet run."),
    "dlcfn_gauntlet_sweep_seeds": ("gauge", "Seeds explored by the last gauntlet incident sweep."),
    "dlcfn_gauntlet_sweep_failures": ("gauge", "Failing schedules found by the last gauntlet incident sweep."),
    "dlcfn_gauntlet_broker_degraded_pairs": ("gauge", "Broker shard pairs not fully healed during a gauntlet incident (drives the gauntlet SLO rule)."),
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
    # sharded streaming data plane (train/datastream)
    "dlcfn_datastream_records_per_s": ("gauge", "Records/second the data plane delivered (plane lifetime)."),
    "dlcfn_datastream_records_total": ("counter", "Records the data plane delivered."),
    "dlcfn_datastream_shard_lag": ("gauge", "Spread (max-min) of records remaining across hosts — shard imbalance."),
    "dlcfn_datastream_reshard_total": ("counter", "Data-plane reshards (epoch work redistributed over survivors)."),
    "dlcfn_datastream_checkpoint_write_seconds": ("gauge", "Off-path seconds the background writer spent on the last sharded checkpoint."),
    "dlcfn_datastream_checkpoint_writes_total": ("counter", "Async sharded checkpoint manifests committed."),
    "dlcfn_datastream_native_fallback_total": ("counter", "Record-loader falls from native to the pure-Python reader."),
    # fleet scheduler (sched/arbiter.py)
    "dlcfn_sched_jobs": ("gauge", "Jobs admitted to the fleet arbiter."),
    "dlcfn_sched_slices_free": ("gauge", "Slices in the inventory not assigned to any job."),
    "dlcfn_sched_loans_outstanding": ("gauge", "Slices currently lent from a preempted job to the serve pool."),
    "dlcfn_sched_decisions_total": ("counter", "Arbiter decisions journaled (submit/preempt/restore/absorb/defer)."),
    "dlcfn_sched_preemptions_total": ("counter", "Slices preempted from a lower-priority job under a serve page."),
    "dlcfn_sched_restores_total": ("counter", "Lent slices returned to their owning job after the page resolved."),
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
    the counters the exporter and ``status`` surface.  Empty dict
    when the journal holds neither kind."""
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
    ``status`` surfaces: ``broker_promoted`` (a standby adopted a
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


def fold_serve_events(events) -> dict[str, Any]:
    """Fold flight-journal ``serve_metrics`` events into the latest
    snapshot per replica (each journal write is a full snapshot, so
    last-wins is the fold).  Empty dict when no replica ever reported."""
    out: dict[str, Any] = {}
    for event in events:
        if event.get("kind") != "serve_metrics":
            continue
        replica = str(event.get("replica") or "?")
        out[replica] = {
            k: event.get(k)
            for k in (
                "steps",
                "admitted",
                "completed",
                "rejected",
                "active_slots",
                "queue_depth",
                "tokens_out",
                "tokens_per_s",
                "ttft_ms",
                "itl_ms",
                "free_blocks",
                "recycled_blocks",
                "max_wait_steps",
                "kv_transfer_bytes",
                "disaggregated",
            )
        }
    return out


def fold_comms_events(events) -> dict[str, Any]:
    """Fold flight-journal ``comms_audit`` events into the latest budget
    per audited program (each audit journals a full per-program readout,
    so last-wins is the fold).  Empty dict when no audit ever ran."""
    out: dict[str, Any] = {}
    for event in events:
        if event.get("kind") != "comms_audit":
            continue
        for name, program in (event.get("programs") or {}).items():
            if not isinstance(program, Mapping):
                continue
            out[str(name)] = {
                k: program.get(k)
                for k in (
                    "collective_count",
                    "collective_bytes",
                    "peak_hbm_bytes",
                    "overlap_score",
                    "by_op",
                    "unpredicted_gathers",
                )
            }
    return out


def fold_replay_events(events) -> dict[str, Any]:
    """Fold flight-journal ``replay_audit`` events into the latest
    audit's verdict (each audit journals a full summary, so last-wins
    is the fold).  Empty dict when no replay audit ever ran."""
    out: dict[str, Any] = {}
    for event in events:
        if event.get("kind") != "replay_audit":
            continue
        out = {
            "clean": bool(event.get("clean")),
            "cases": int(event.get("cases") or 0),
            "seeds": list(event.get("seeds") or []),
            "divergent": sorted(event.get("divergent") or []),
        }
    return out


def fold_gauntlet_events(events) -> dict[str, Any]:
    """Fold flight-journal ``gauntlet`` events (composed-incident runs
    and incident-explorer sweeps from ``chaos/gauntlet.py``) into the
    counters ``status`` and the ``dlcfn_gauntlet_*`` gauges
    surface.  Runs count; the newest run and the newest sweep summary
    win.  Empty dict when no gauntlet ever ran."""
    out: dict[str, Any] = {"runs_total": 0, "last_run": None, "sweep": None}
    saw = False
    for event in events:
        if event.get("kind") != "gauntlet":
            continue
        saw = True
        name = event.get("event")
        if name == "run":
            out["runs_total"] += 1
            out["last_run"] = {
                k: event.get(k)
                for k in ("seed", "passed", "faults", "violations")
            }
        elif name == "sweep":
            out["sweep"] = {
                k: event.get(k) for k in ("seeds", "base_seed", "failures")
            }
    return out if saw else {}


def fold_datastream_events(events) -> dict[str, Any]:
    """Fold flight-journal ``datastream`` events (data-plane progress,
    reshards, async-checkpoint writes, loader fallbacks) into the
    counters ``status`` and the ``dlcfn_datastream_*`` gauges
    surface.  Progress events are full snapshots, so last-wins; the
    rest count.  Empty dict when the data plane never journaled."""
    out: dict[str, Any] = {
        "progress": None,
        "hosts": {},
        "reshard_total": 0,
        "last_reshard": None,
        "checkpoint": {
            "writes": 0,
            "failures": 0,
            "superseded": 0,
            "seconds_total": 0.0,
            "last_write_seconds": None,
            "last_step": None,
        },
        "native_fallback_total": 0,
    }
    saw = False
    for event in events:
        if event.get("kind") != "datastream":
            continue
        saw = True
        name = event.get("event")
        if name == "progress":
            out["progress"] = {
                k: event.get(k)
                for k in (
                    "hosts",
                    "shards",
                    "records_total",
                    "records_per_s",
                    "shard_lag",
                    "reshards",
                    "epoch",
                )
            }
        elif name == "host_progress":
            out["hosts"][str(event.get("host") or "?")] = {
                k: event.get(k) for k in ("records", "remaining", "epoch")
            }
        elif name == "reshard":
            out["reshard_total"] += 1
            out["last_reshard"] = {
                k: event.get(k)
                for k in (
                    "epoch",
                    "lost_hosts",
                    "survivors",
                    "work_units",
                    "records_remaining",
                )
            }
        elif name == "checkpoint_write":
            ck = out["checkpoint"]
            ck["writes"] += 1
            ck["seconds_total"] = round(
                ck["seconds_total"] + float(event.get("seconds") or 0.0), 6
            )
            ck["last_write_seconds"] = event.get("seconds")
            ck["last_step"] = event.get("step")
        elif name == "checkpoint_write_failed":
            out["checkpoint"]["failures"] += 1
        elif name == "checkpoint_superseded":
            out["checkpoint"]["superseded"] += 1
        elif name == "native_fallback":
            out["native_fallback_total"] += 1
    return out if saw else {}


def fold_sched_events(events) -> dict[str, Any]:
    """Fold flight-journal scheduler events (``sched_decision`` /
    ``sched_preempt`` / ``sched_restore``) into the counters the
    ``dlcfn_sched_*`` families surface.  Decisions carry the arbiter's
    fleet shape (jobs, free slices), preempts/restores carry the loan
    book — last-wins for the gauges, counting for the totals.  Empty
    dict when the arbiter never journaled."""
    out: dict[str, Any] = {
        "decisions": 0,
        "preemptions": 0,
        "restores": 0,
        "jobs": None,
        "free_slices": None,
        "loans_outstanding": None,
        "last": None,
    }
    saw = False
    for event in events:
        kind = event.get("kind")
        if kind == "sched_decision":
            saw = True
            out["decisions"] += 1
            out["jobs"] = event.get("jobs")
            out["free_slices"] = event.get("free_slices")
            out["loans_outstanding"] = event.get("loans_outstanding")
        elif kind in ("sched_preempt", "sched_restore"):
            saw = True
            out["preemptions" if kind == "sched_preempt" else "restores"] += 1
            out["loans_outstanding"] = event.get("loans_outstanding")
            out["last"] = {
                k: event.get(k)
                for k in ("kind", "seq", "rule", "slice", "from_job", "to_job")
            }
    return out if saw else {}


def render_prometheus(
    liveness: Mapping[str, Mapping[str, Any]] | None = None,
    spans: Mapping[str, Mapping[str, Any]] | None = None,
    cluster: str = "",
    pipeline: Mapping[str, Mapping[str, Any]] | None = None,
    reshard: Mapping[str, Any] | None = None,
    mesh: Mapping[str, Any] | None = None,
    profile: Mapping[str, Any] | None = None,
    serve: Mapping[str, Mapping[str, Any]] | None = None,
    broker: Mapping[str, Any] | None = None,
    comms: Mapping[str, Mapping[str, Any]] | None = None,
    fleet: Mapping[str, Any] | None = None,
    datastream: Mapping[str, Any] | None = None,
    sched: Mapping[str, Any] | None = None,
    replay: Mapping[str, Any] | None = None,
    gauntlet: Mapping[str, Any] | None = None,
) -> str:
    """Render liveness snapshot + span aggregates + input-pipeline
    counters as Prometheus text.

    ``liveness`` is ``LivenessTable.snapshot()``; ``spans`` is
    ``tracing.span_aggregates()`` (span dicts carrying ``p50_s`` /
    ``p95_s`` / ``p99_s`` additionally render as a summary-style
    ``dlcfn_span_seconds`` family); ``pipeline`` is
    ``train.pipeline.fold_pipeline_events()``; ``reshard`` is
    ``fold_reshard_events()``; ``mesh`` is the current mesh/contract
    shape from ``status --cluster``; ``profile`` is the
    ``status --profile`` dict (``{"profilers": {name: snapshot}}``)
    whose per-phase quantiles render as ``dlcfn_step_phase_ms``
    summaries; ``broker`` is
    ``broker_service.broker_replication_status()`` (role/epoch per node
    plus replication lag); ``comms`` is ``fold_comms_events()`` (the
    comms-audit sentinel's per-program collective/HBM budgets);
    ``fleet`` is ``obs.aggregator.FleetAggregator.merge()`` (the TELEM
    fleet merge); ``datastream`` is ``fold_datastream_events()`` (the
    sharded streaming data plane's progress/reshard/async-checkpoint
    counters); ``sched`` is ``fold_sched_events()`` (the fleet
    arbiter's decision/preemption/loan counters); ``replay`` is
    ``fold_replay_events()`` (the replay-audit sentinel's double-run
    byte-determinism verdict); ``gauntlet`` is
    ``fold_gauntlet_events()`` (the composed-incident gauntlet's
    run/sweep verdicts).  Any may be None/empty.
    """
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
    if pipeline:
        for key in (
            "bytes_transferred",
            "host_input_seconds",
            "producer_stall_seconds",
            "consumer_wait_seconds",
            "overlap_fraction",
        ):
            head(f"dlcfn_input_pipeline_{key}")
            for name, agg in pipeline.items():
                value = agg.get(key)
                if value is None:
                    continue
                lines.append(
                    f"dlcfn_input_pipeline_{key}"
                    f"{_labels(cluster=cluster, pipeline=name)} {value}"
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
    profilers = (profile or {}).get("profilers") or {}
    if profilers:
        head("dlcfn_step_phase_ms")
        for prof_name, snap in profilers.items():
            for phase, stats in (snap.get("phases") or {}).items():
                for quantile, key in (
                    ("0.5", "p50_ms"),
                    ("0.95", "p95_ms"),
                    ("0.99", "p99_ms"),
                ):
                    value = stats.get(key)
                    if value is None:
                        continue
                    lines.append(
                        f"dlcfn_step_phase_ms"
                        f"{_labels(cluster=cluster, profiler=prof_name, phase=phase, quantile=quantile)}"
                        f" {value}"
                    )
                lines.append(
                    f"dlcfn_step_phase_ms_sum"
                    f"{_labels(cluster=cluster, profiler=prof_name, phase=phase)}"
                    f" {stats.get('total_ms', 0.0)}"
                )
                lines.append(
                    f"dlcfn_step_phase_ms_count"
                    f"{_labels(cluster=cluster, profiler=prof_name, phase=phase)}"
                    f" {stats.get('count', 0)}"
                )
        head("dlcfn_step_ms")
        for prof_name, snap in profilers.items():
            step_ms = snap.get("step_ms") or {}
            for quantile, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
                value = step_ms.get(key)
                if value is None:
                    continue
                lines.append(
                    f"dlcfn_step_ms"
                    f"{_labels(cluster=cluster, profiler=prof_name, quantile=quantile)}"
                    f" {value}"
                )
            lines.append(
                f"dlcfn_step_ms_count"
                f"{_labels(cluster=cluster, profiler=prof_name)}"
                f" {snap.get('steps', 0)}"
            )
    if serve:
        for key in ("active_slots", "queue_depth", "tokens_per_s"):
            head(f"dlcfn_serve_{key}")
            for replica, snap in serve.items():
                value = snap.get(key)
                if value is None:
                    continue
                lines.append(
                    f"dlcfn_serve_{key}"
                    f"{_labels(cluster=cluster, replica=replica)} {value}"
                )
        head("dlcfn_serve_ttft_ms")
        for replica, snap in serve.items():
            ttft = snap.get("ttft_ms") or {}
            for quantile, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
                value = ttft.get(key)
                if value is None:
                    continue
                lines.append(
                    f"dlcfn_serve_ttft_ms"
                    f"{_labels(cluster=cluster, replica=replica, quantile=quantile)}"
                    f" {value}"
                )
            lines.append(
                f"dlcfn_serve_ttft_ms_count"
                f"{_labels(cluster=cluster, replica=replica)}"
                f" {snap.get('admitted', 0)}"
            )
    if comms:
        for key in (
            "collective_bytes",
            "peak_hbm_bytes",
            "collective_count",
            "overlap_score",
        ):
            head(f"dlcfn_comms_{key}")
            for program, snap in comms.items():
                value = snap.get(key)
                if value is None:
                    continue
                lines.append(
                    f"dlcfn_comms_{key}"
                    f"{_labels(cluster=cluster, program=program)} {value}"
                )
    if replay:
        head("dlcfn_replay_cases")
        lines.append(
            f"dlcfn_replay_cases{_labels(cluster=cluster)} "
            f"{replay.get('cases', 0)}"
        )
        head("dlcfn_replay_divergent")
        lines.append(
            f"dlcfn_replay_divergent{_labels(cluster=cluster)} "
            f"{len(replay.get('divergent') or [])}"
        )
        head("dlcfn_replay_clean")
        lines.append(
            f"dlcfn_replay_clean{_labels(cluster=cluster)} "
            f"{1 if replay.get('clean') else 0}"
        )
    if gauntlet:
        head("dlcfn_gauntlet_runs_total")
        lines.append(
            f"dlcfn_gauntlet_runs_total{_labels(cluster=cluster)} "
            f"{gauntlet.get('runs_total', 0)}"
        )
        last_run = gauntlet.get("last_run")
        if last_run:
            labels = _labels(cluster=cluster, seed=last_run.get("seed"))
            head("dlcfn_gauntlet_passed")
            lines.append(
                f"dlcfn_gauntlet_passed{labels} "
                f"{1 if last_run.get('passed') else 0}"
            )
            head("dlcfn_gauntlet_faults_injected")
            lines.append(
                f"dlcfn_gauntlet_faults_injected{labels} "
                f"{last_run.get('faults') or 0}"
            )
            head("dlcfn_gauntlet_violations")
            lines.append(
                f"dlcfn_gauntlet_violations{labels} "
                f"{last_run.get('violations') or 0}"
            )
        sweep = gauntlet.get("sweep")
        if sweep:
            head("dlcfn_gauntlet_sweep_seeds")
            lines.append(
                f"dlcfn_gauntlet_sweep_seeds{_labels(cluster=cluster)} "
                f"{sweep.get('seeds') or 0}"
            )
            head("dlcfn_gauntlet_sweep_failures")
            lines.append(
                f"dlcfn_gauntlet_sweep_failures{_labels(cluster=cluster)} "
                f"{sweep.get('failures') or 0}"
            )
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
    if datastream:
        progress = datastream.get("progress") or {}
        for name, key in (
            ("dlcfn_datastream_records_per_s", "records_per_s"),
            ("dlcfn_datastream_records_total", "records_total"),
            ("dlcfn_datastream_shard_lag", "shard_lag"),
        ):
            value = progress.get(key)
            if value is None:
                continue
            head(name)
            lines.append(f"{name}{_labels(cluster=cluster)} {value}")
        head("dlcfn_datastream_reshard_total")
        lines.append(
            f"dlcfn_datastream_reshard_total{_labels(cluster=cluster)}"
            f" {datastream.get('reshard_total', 0)}"
        )
        checkpoint = datastream.get("checkpoint") or {}
        if checkpoint.get("last_write_seconds") is not None:
            head("dlcfn_datastream_checkpoint_write_seconds")
            lines.append(
                f"dlcfn_datastream_checkpoint_write_seconds"
                f"{_labels(cluster=cluster)} {checkpoint['last_write_seconds']}"
            )
        if checkpoint.get("writes"):
            head("dlcfn_datastream_checkpoint_writes_total")
            lines.append(
                f"dlcfn_datastream_checkpoint_writes_total"
                f"{_labels(cluster=cluster)} {checkpoint['writes']}"
            )
        if datastream.get("native_fallback_total"):
            head("dlcfn_datastream_native_fallback_total")
            lines.append(
                f"dlcfn_datastream_native_fallback_total"
                f"{_labels(cluster=cluster)} {datastream['native_fallback_total']}"
            )
    if sched:
        for name, key in (
            ("dlcfn_sched_jobs", "jobs"),
            ("dlcfn_sched_slices_free", "free_slices"),
            ("dlcfn_sched_loans_outstanding", "loans_outstanding"),
        ):
            value = sched.get(key)
            if value is None:
                continue
            head(name)
            lines.append(f"{name}{_labels(cluster=cluster)} {value}")
        for name, key in (
            ("dlcfn_sched_decisions_total", "decisions"),
            ("dlcfn_sched_preemptions_total", "preemptions"),
            ("dlcfn_sched_restores_total", "restores"),
        ):
            head(name)
            lines.append(f"{name}{_labels(cluster=cluster)} {sched.get(key, 0)}")
    return "\n".join(lines) + ("\n" if lines else "")
