"""Crash blackbox: per-host postmortem bundles and the merged timeline.

Counterpart of ``deeplearning_cfn_tpu/obs/blackbox.py``, copied (the port
imports nothing of the JAX package).  ``dlcfn postmortem`` itself is not
ported yet; :func:`merge_bundles` and :func:`render_timeline` are what it
calls.

When an agent dies — fatal exception in the training loop, or the
provisioner announcing ``INSTANCE_TERMINATE`` — the most valuable bytes
are the ones that existed *just before*: the tail of the flight
journal, the profiler's rolling window, the resolved config, the
comms/compile budgets the static passes pinned.  This module freezes
exactly that into a **bundle** (one strict-JSON file per host, written
through the same ``json_safe``/``allow_nan=False`` discipline as the
journal, so a crash bundle always re-parses).

``dlcfn postmortem`` then merges bundles from every host into ONE
causal timeline: per-host clocks are aligned with the heartbeat-pair
offsets obs/trace_export.py already recovers for tracing (the
``heartbeat_sent`` / ``heartbeat_observed`` events ride inside each
bundle's journal tail, so the alignment needs no extra data), and ties
at the same aligned instant break deterministically by ``(host, seq)``
where ``seq`` is the event's index within its bundle — skewed host
clocks reorder nothing between runs.  Alert transitions (journal kind
``"alert"``, obs/slo.py) are surfaced as an overlay so the operator
reads "what fired" next to "what happened".
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Callable, Mapping

from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder, json_safe
from deeplearning_cfn_tpu_torch.obs.trace_export import heartbeat_offsets
from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.obs")

BUNDLE_VERSION = 1

#: Journal tail length a bundle freezes.  Matches the recorder ring's
#: order of magnitude — more would just re-ship the journal file.
DEFAULT_LAST_N = 200


def capture_bundle(
    reason: str,
    host: str,
    worker: str | None = None,
    recorder: Any = None,
    last_n: int = DEFAULT_LAST_N,
    profiler: Any = None,
    config: Mapping[str, Any] | None = None,
    budgets: Mapping[str, Any] | None = None,
    clock: Callable[[], float] = time.time,
) -> dict[str, Any]:
    """Freeze this host's observability state into a bundle dict.

    ``profiler`` is a ``StepProfiler`` (its ``snapshot()`` is taken) or
    an already-built snapshot dict; ``config`` / ``budgets`` are
    whatever resolved mappings the caller owns (agent config, comms /
    compile budget readouts) — stored verbatim, json-safe.
    """
    rec = recorder if recorder is not None else get_recorder()
    snap = profiler
    if profiler is not None and hasattr(profiler, "snapshot"):
        snap = profiler.snapshot()
    return {
        "v": BUNDLE_VERSION,
        "host": host,
        "worker": worker,
        "reason": reason,
        "captured_ts": round(float(clock()), 6),
        "events": rec.tail(last_n),
        "profiler": snap,
        "config": dict(config) if config else None,
        "budgets": dict(budgets) if budgets else None,
    }


def write_bundle(bundle: Mapping[str, Any], path: str | Path) -> Path:
    """Persist a bundle as strict JSON (NaN/Inf -> null, like the
    journal) — a postmortem written during a crash must never itself
    fail to parse later."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(
        json.dumps(json_safe(dict(bundle)), allow_nan=False, default=str, indent=2)
        + "\n"
    )
    return path


def read_bundle(path: str | Path) -> dict[str, Any]:
    return json.loads(Path(path).read_text())


class BlackBox:
    """Arms the capture triggers for one agent process.

    * ``attach(bus)`` — capture on ``INSTANCE_TERMINATE`` for this
      worker's instance (the spot-reap path: the provisioner's warning
      is often the only notice the host gets);
    * ``capture(reason)`` — the fatal-error path agent_main wraps
      around its run loop.

    Each capture writes ``<dir>/blackbox-<host>.json`` (last capture
    wins — the newest state is the one the postmortem wants).
    """

    def __init__(
        self,
        out_dir: str | Path,
        host: str,
        worker: str | None = None,
        instance_id: str | None = None,
        profiler: Any = None,
        config: Mapping[str, Any] | None = None,
        budgets: Mapping[str, Any] | None = None,
        recorder: Any = None,
        clock: Callable[[], float] = time.time,
    ):
        self.out_dir = Path(out_dir)
        self.host = host
        self.worker = worker
        self.instance_id = instance_id
        self._profiler = profiler
        self._config = config
        self._budgets = budgets
        self._recorder = recorder
        self._clock = clock
        self.captures = 0
        self._handler = None

    @property
    def path(self) -> Path:
        return self.out_dir / f"blackbox-{self.host}.json"

    def capture(self, reason: str) -> Path:
        bundle = capture_bundle(
            reason=reason,
            host=self.host,
            worker=self.worker,
            recorder=self._recorder,
            profiler=self._profiler,
            config=self._config,
            budgets=self._budgets,
            clock=self._clock,
        )
        out = write_bundle(bundle, self.path)
        self.captures += 1
        log.warning("blackbox captured (%s) -> %s", reason, out)
        return out

    def attach(self, bus: Any) -> None:
        """Subscribe the terminate trigger; idempotent per BlackBox."""
        if self._handler is not None:
            return
        from deeplearning_cfn_tpu_torch.provision.events import EventKind

        def _on_event(event) -> None:
            if event.kind is not EventKind.INSTANCE_TERMINATE:
                return
            if (
                self.instance_id is not None
                and event.instance_id is not None
                and event.instance_id != self.instance_id
            ):
                return
            self.capture(f"instance-terminate:{event.instance_id or event.group}")

        self._handler = _on_event
        bus.subscribe(_on_event)

    def detach(self, bus: Any) -> None:
        if self._handler is not None:
            bus.unsubscribe(self._handler)
            self._handler = None


def merge_bundles(bundles: list[Mapping[str, Any]]) -> dict[str, Any]:
    """Merge per-host bundles into one causally-ordered timeline.

    Clock alignment reuses the heartbeat-pair offsets from
    obs/trace_export.py over each bundle's embedded journal tail; hosts
    with no matched beats keep offset 0 (degrades to raw timestamps,
    which the meta records).  The sort key is ``(aligned_ts, host,
    seq)`` — ``seq`` being the event's index within its own bundle —
    so equal timestamps under clock skew still order byte-identically.
    """
    journals: dict[str, list[dict[str, Any]]] = {}
    labeled: list[tuple[str, Mapping[str, Any]]] = []
    for i, bundle in enumerate(bundles):
        label = str(bundle.get("host") or bundle.get("worker") or f"bundle{i}")
        base, suffix = label, 2
        while label in journals:
            label = f"{base}#{suffix}"
            suffix += 1
        journals[label] = list(bundle.get("events") or [])
        labeled.append((label, bundle))
    offsets, reference = heartbeat_offsets(journals)
    events: list[dict[str, Any]] = []
    for label, bundle in labeled:
        offset = offsets.get(label, 0.0)
        for seq, event in enumerate(journals[label]):
            ts = event.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            out = dict(event)
            out["ts"] = round(float(ts) + offset, 6)
            out["bb_host"] = label
            out["bb_seq"] = seq
            events.append(out)
    events.sort(key=lambda e: (e["ts"], e["bb_host"], e["bb_seq"]))
    alerts = [e for e in events if e.get("kind") == "alert"]
    return {
        "events": events,
        "alerts": alerts,
        "hosts": {
            label: {
                "reason": bundle.get("reason"),
                "worker": bundle.get("worker"),
                "captured_ts": bundle.get("captured_ts"),
                "offset_s": round(offsets.get(label, 0.0), 6),
            }
            for label, bundle in labeled
        },
        "reference": reference,
        "aligned": reference is not None,
    }


def render_timeline(merged: Mapping[str, Any], last_n: int | None = None) -> str:
    """Human postmortem view: one line per event on the aligned clock,
    alert transitions flagged, capture reasons up top."""
    lines: list[str] = []
    hosts = merged.get("hosts") or {}
    lines.append(
        f"postmortem: {len(hosts)} host(s), "
        f"clock alignment {'heartbeat-paired' if merged.get('aligned') else 'RAW (no matched beats)'}"
    )
    for label, info in sorted(hosts.items()):
        lines.append(
            f"  {label}: reason={info.get('reason')!r} "
            f"worker={info.get('worker')} offset={info.get('offset_s')}s"
        )
    alerts = merged.get("alerts") or []
    if alerts:
        lines.append(f"alerts ({len(alerts)} transition(s)):")
        for alert in alerts:
            lines.append(
                f"  {alert['ts']:.3f} [{alert['bb_host']}] "
                f"{alert.get('rule')} -> {alert.get('state')} "
                f"({alert.get('metric')}.{alert.get('agg')}={alert.get('value')})"
            )
    events = list(merged.get("events") or [])
    if last_n is not None:
        events = events[-last_n:]
    lines.append(f"timeline ({len(events)} event(s)):")
    for event in events:
        marker = " !" if event.get("kind") == "alert" else ""
        detail = {
            k: v
            for k, v in event.items()
            if k
            not in (
                "ts", "kind", "host", "pid", "cluster",
                "worker", "bb_host", "bb_seq",
            )
            and v is not None
        }
        body = " ".join(f"{k}={v}" for k, v in detail.items())
        lines.append(
            f"  {event['ts']:.3f} [{event['bb_host']}]"
            f"{marker} {event.get('kind')} {body}".rstrip()
        )
    return "\n".join(lines) + "\n"
