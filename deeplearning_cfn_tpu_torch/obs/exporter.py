"""Prometheus text exposition — the parts of ``deeplearning_cfn_tpu/obs/exporter.py``
that the live reshard and the cluster plane surface.

Ported: the registry entries of the span, ``dlcfn_reshard_*`` and
``dlcfn_mesh_*`` families, :func:`fold_reshard_events`, and
:func:`render_prometheus` for spans, reshards and the mesh, whose text is the
JAX package's line for line.  Headers come from :data:`METRIC_REGISTRY`
through a per-render seen-set, so no family gets two ``# TYPE`` lines.  The
other families (liveness, the input pipeline, the step profiler, serving,
the broker, comms, fleet, data plane, scheduler, replay, gauntlet) come with
the slices that port what feeds them.
"""

from __future__ import annotations

from typing import Any, Mapping

OBS_SLICE = "a later slice of the PyTorch port (obs/: liveness, the aggregator, the rest of exporter)"

#: family name -> (prometheus type, help text).  Summary families list
#: the base name only; their ``_sum`` / ``_count`` children inherit the
#: header per the text format.
METRIC_REGISTRY: dict[str, tuple[str, str]] = {
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


def render_prometheus(
    liveness: Mapping[str, Mapping[str, Any]] | None = None,
    spans: Mapping[str, Mapping[str, Any]] | None = None,
    cluster: str = "",
    reshard: Mapping[str, Any] | None = None,
    mesh: Mapping[str, Any] | None = None,
) -> str:
    """Render span aggregates, the reshard counters and the mesh shape as
    Prometheus text.  ``spans`` is ``tracing.span_aggregates()`` (span dicts
    carrying ``p50_s`` / ``p95_s`` / ``p99_s`` additionally render as a
    summary-style ``dlcfn_span_seconds`` family); ``reshard`` is
    ``fold_reshard_events()``; ``mesh`` is the mesh/contract shape of
    ``status --cluster``.  Any may be None/empty; ``liveness`` (the
    heartbeat table) is ported with the liveness plane and raises."""
    if liveness:
        raise NotImplementedError(f"the liveness families are ported in {OBS_SLICE}")
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
    return "\n".join(lines) + ("\n" if lines else "")
