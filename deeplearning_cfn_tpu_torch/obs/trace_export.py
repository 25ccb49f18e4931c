"""Cross-host trace timeline: merge flight journals into Chrome trace JSON.

Counterpart of ``deeplearning_cfn_tpu/obs/trace_export.py``, copied (the port imports
nothing of the JAX package); ``cli trace`` renders through it, and the
``straggler`` chaos scenario checks it.

Each host writes its own flight-recorder journal with timestamps from
its own clock.  Merging them naively interleaves events wrongly whenever
host clocks disagree (NTP skew on pods is routinely larger than a step
time).  This module aligns clocks using the broker heartbeat exchange
that already exists for liveness:

- every worker journals ``heartbeat_sent  {worker, seq, ts}`` with its
  own clock,
- the supervisor journals ``heartbeat_observed {worker, seq, age_s, ts}``
  with *its* clock when the beat count advances,

so for each matched ``(worker, seq)`` pair, ``(observed_ts - age_s)``
and ``sent_ts`` name the same instant on two clocks.  The median of the
differences is the sender->observer offset (median absorbs the odd
delayed observation).  The first journal containing ``heartbeat_observed``
events is the reference clock; journals with no matched beats keep
offset 0.

Output is Chrome trace-event JSON (the ``{"traceEvents": [...]}`` form),
loadable in ``chrome://tracing`` or https://ui.perfetto.dev: one process
row per host, ``span`` and ``step_time`` events as complete ("X") slices,
everything else as instants.  ``straggler_table`` turns per-host
``step_time`` events into the slowest-host-per-step table surfaced by
``dlcfn status --profile`` and ``dlcfn trace``.
"""

from __future__ import annotations

import statistics
from pathlib import Path
from typing import Any, Iterable, Sequence

from deeplearning_cfn_tpu_torch.obs.recorder import read_journal


#: Event kinds whose ``worker`` field names ANOTHER host (the observed
#: worker), not the journal's owner — label by ``host`` for these.
_OBSERVER_KINDS = frozenset({"heartbeat_observed", "liveness"})


def _event_host(event: dict[str, Any]) -> str | None:
    keys = (
        ("trace_host", "host", "worker")
        if event.get("kind") in _OBSERVER_KINDS
        else ("trace_host", "worker", "host")
    )
    for key in keys:
        value = event.get(key)
        if isinstance(value, str) and value:
            return value
    return None


def _journal_label(events: list[dict[str, Any]], fallback: str) -> str:
    """A journal's host label: its dominant worker/host field, else stem."""
    counts: dict[str, int] = {}
    for event in events:
        keys = (
            ("host",)
            if event.get("kind") in _OBSERVER_KINDS
            else ("worker", "host")
        )
        for key in keys:
            value = event.get(key)
            if isinstance(value, str) and value:
                counts[value] = counts.get(value, 0) + 1
                break
    if counts:
        return max(sorted(counts), key=lambda label: counts[label])
    return fallback


def heartbeat_offsets(
    journals: dict[str, list[dict[str, Any]]],
) -> tuple[dict[str, float], str | None]:
    """Per-journal clock offset onto the reference (observer) clock.

    Returns ``(offsets, reference_label)``; every journal gets an entry
    (0.0 when unmatched), ``reference_label`` is None when no journal
    contains ``heartbeat_observed`` events (alignment degrades to raw
    timestamps).
    """
    reference: str | None = None
    observed: dict[tuple[str, int], tuple[float, float]] = {}
    for label, events in journals.items():
        for event in events:
            if event.get("kind") != "heartbeat_observed":
                continue
            worker, seq, ts = event.get("worker"), event.get("seq"), event.get("ts")
            if not isinstance(worker, str) or not isinstance(seq, int):
                continue
            if not isinstance(ts, (int, float)):
                continue
            if reference is None:
                reference = label
            age = event.get("age_s")
            age_s = float(age) if isinstance(age, (int, float)) else 0.0
            observed[(worker, seq)] = (float(ts), age_s)
    offsets = {label: 0.0 for label in journals}
    if reference is None:
        return offsets, None
    for label, events in journals.items():
        if label == reference:
            continue
        deltas = []
        for event in events:
            if event.get("kind") != "heartbeat_sent":
                continue
            worker, seq, ts = event.get("worker"), event.get("seq"), event.get("ts")
            if not isinstance(worker, str) or not isinstance(seq, int):
                continue
            if not isinstance(ts, (int, float)):
                continue
            match = observed.get((worker, seq))
            if match is None:
                continue
            observed_ts, age_s = match
            deltas.append((observed_ts - age_s) - float(ts))
        if deltas:
            offsets[label] = statistics.median(deltas)
    return offsets, reference


def merge_journals(
    paths: Sequence[str | Path], align: bool = True
) -> tuple[list[dict[str, Any]], dict[str, Any]]:
    """Merge per-host journals into one aligned, time-sorted event list.

    Every event gains a ``trace_host`` label (the journal it came from)
    and, when ``align`` is true, its ``ts`` is shifted onto the reference
    clock.  Returns ``(events, meta)`` where meta carries the recovered
    offsets and the reference journal's label.
    """
    journals: dict[str, list[dict[str, Any]]] = {}
    for i, path in enumerate(paths):
        events = list(read_journal(path))
        label = _journal_label(events, Path(path).stem or f"journal{i}")
        base, suffix = label, 2
        while label in journals:
            label = f"{base}#{suffix}"
            suffix += 1
        journals[label] = events
    if align:
        offsets, reference = heartbeat_offsets(journals)
    else:
        offsets, reference = {label: 0.0 for label in journals}, None
    merged = []
    for label, events in journals.items():
        offset = offsets.get(label, 0.0)
        for event in events:
            ts = event.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            out = dict(event)
            out["ts"] = float(ts) + offset
            out["trace_host"] = label
            merged.append(out)
    merged.sort(key=lambda e: (e["ts"], e["trace_host"], str(e.get("kind", ""))))
    meta = {
        "offsets": {label: round(value, 6) for label, value in offsets.items()},
        "reference": reference,
        "aligned": align and reference is not None,
    }
    return merged, meta


_STEP_PHASE_KEYS = (
    "data_wait_ms",
    "h2d_ms",
    "dispatch_ms",
    "compute_ms",
    "host_ms",
)


def chrome_trace(events: Iterable[dict[str, Any]]) -> dict[str, Any]:
    """Render merged events as Chrome trace-event JSON.

    One process per host (stable pids in sorted-label order); ``span``
    and ``step_time`` events become complete "X" slices ending at their
    journal timestamp (both are recorded at block end), everything else
    an instant.  Timestamps are microseconds, per the trace-event spec.
    """
    events = list(events)
    hosts = sorted({_event_host(e) or "host" for e in events})
    pid_of = {host: i + 1 for i, host in enumerate(hosts)}
    trace: list[dict[str, Any]] = []
    for host in hosts:
        trace.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid_of[host],
                "tid": 0,
                "args": {"name": host},
            }
        )
    for event in events:
        ts = event.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        pid = pid_of[_event_host(event) or "host"]
        kind = str(event.get("kind", "event"))
        end_us = float(ts) * 1e6
        if kind == "span" and isinstance(event.get("seconds"), (int, float)):
            dur = float(event["seconds"]) * 1e6
            args = {
                key: event[key]
                for key in ("step", "ok")
                if event.get(key) is not None
            }
            trace.append(
                {
                    "name": str(event.get("span") or "span"),
                    "cat": "span",
                    "ph": "X",
                    "ts": round(end_us - dur, 3),
                    "dur": round(dur, 3),
                    "pid": pid,
                    "tid": 0,
                    "args": args,
                }
            )
        elif kind == "step_time" and isinstance(
            event.get("total_ms"), (int, float)
        ):
            dur = float(event["total_ms"]) * 1e3
            args = {
                key: event[key] for key in _STEP_PHASE_KEYS if key in event
            }
            step = event.get("step")
            trace.append(
                {
                    "name": f"step {step}" if step is not None else "step",
                    "cat": "step",
                    "ph": "X",
                    "ts": round(end_us - dur, 3),
                    "dur": round(dur, 3),
                    "pid": pid,
                    "tid": 1,
                    "args": args,
                }
            )
        else:
            trace.append(
                {
                    "name": kind,
                    "cat": "event",
                    "ph": "i",
                    "ts": round(end_us, 3),
                    "pid": pid,
                    "tid": 0,
                    "s": "p",
                }
            )
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def straggler_table(events: Iterable[dict[str, Any]]) -> dict[str, Any]:
    """Slowest-host-per-step table from per-host ``step_time`` events.

    Steps observed on fewer than two hosts carry no cross-host signal
    and are skipped.  Ties break to the alphabetically-first host, so
    the table is deterministic for fixture journals.
    """
    by_step: dict[int, dict[str, float]] = {}
    for event in events:
        if event.get("kind") != "step_time":
            continue
        step, total = event.get("step"), event.get("total_ms")
        if not isinstance(step, int) or not isinstance(total, (int, float)):
            continue
        host = _event_host(event) or "host"
        by_step.setdefault(step, {})[host] = float(total)
    rows = []
    counts: dict[str, int] = {}
    for step in sorted(by_step):
        hosts = by_step[step]
        if len(hosts) < 2:
            continue
        slowest = max(sorted(hosts), key=lambda h: hosts[h])
        median_ms = statistics.median(hosts.values())
        rows.append(
            {
                "step": step,
                "slowest": slowest,
                "slowest_ms": round(hosts[slowest], 3),
                "median_ms": round(median_ms, 3),
                "margin_ms": round(hosts[slowest] - median_ms, 3),
                "hosts": {h: round(v, 3) for h, v in sorted(hosts.items())},
            }
        )
        counts[slowest] = counts.get(slowest, 0) + 1
    top = max(sorted(counts), key=lambda h: counts[h]) if counts else None
    return {
        "steps": rows,
        "slowest_counts": dict(sorted(counts.items())),
        "top_straggler": top,
    }
