"""Declarative SLO rules and the firing/resolved alert engine — counterpart
of ``deeplearning_cfn_tpu/obs/slo.py``, copied (the port imports nothing of
the JAX package; ``tests/test_torch_slo.py`` holds the copy to the original).

Rules are data, not code: ``SloRule(metric, agg, op, threshold, for_s)``
— the CloudWatch-alarm analog the reference wired per-ASG by hand
(deeplearning.template alarm blocks), expressed once over the FLEET
aggregate instead of per instance.  The engine is a pure state machine
over an injected clock:

* a breach starts a **pending** window; the rule must stay breached for
  ``for_s`` seconds before it **fires** (debounces the one-slow-step
  blip that would otherwise page at 3am);
* each transition is journaled as kind ``"alert"`` through the flight
  recorder and published on the cluster EventBus as
  ``EventKind.ALERT``, so postmortem timelines (obs/blackbox.py) and
  the elasticity controller both see it;
* recovery emits exactly one ``resolved`` — re-breaching restarts the
  pending window from zero, so a flapping metric produces
  fire/resolve pairs, never duplicate fires.

Missing or NaN values are *absence of evidence*: they clear the pending
window, never fire, and never resolve — a firing alert HOLDS through a
telemetry blackout (a broker failover blanks the fleet table for a
round; resolving on that would flap).  "No data" alarms are a separate
liveness problem, owned by the dead-fraction rule whose input the
liveness state machine always produces.

Evaluation is deterministic: rules evaluate in declaration order over a
plain values dict (``obs.aggregator.fleet_metric_values``), the clock
is injected, and transitions depend only on (values, now) — the
alert-storm chaos scenario replays byte-identically per seed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder
from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.obs")

#: Aggregations a rule may reference.  "value" reads synthesized fleet
#: metrics (dead fraction, worker count); the rest select a fold from
#: the aggregate (see obs.aggregator.fleet_metric_values).
AGGS = ("value", "sum", "max", "p50", "p95", "p99", "count")
OPS: dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}
SEVERITIES = ("page", "warn", "info")


@dataclass(frozen=True)
class SloRule:
    """One alert rule: ``<metric>.<agg> <op> <threshold> for <for_s>s``."""

    name: str
    metric: str
    agg: str
    op: str
    threshold: float
    for_s: float
    severity: str = "warn"
    description: str = ""

    def validate(self) -> list[str]:
        """Schema errors, empty when shippable (printed verbatim by
        :func:`validate_rules`' callers)."""
        errors = []
        if not self.name:
            errors.append("rule has no name")
        if not self.metric.startswith("dlcfn_"):
            errors.append(
                f"{self.name}: metric {self.metric!r} is not a dlcfn_* family"
            )
        if self.agg not in AGGS:
            errors.append(f"{self.name}: unknown agg {self.agg!r} (want {AGGS})")
        if self.op not in OPS:
            errors.append(f"{self.name}: unknown op {self.op!r}")
        if not math.isfinite(self.threshold):
            errors.append(f"{self.name}: non-finite threshold {self.threshold!r}")
        if not math.isfinite(self.for_s) or self.for_s < 0:
            errors.append(f"{self.name}: for_s must be finite and >= 0")
        if self.severity not in SEVERITIES:
            errors.append(
                f"{self.name}: unknown severity {self.severity!r} (want {SEVERITIES})"
            )
        return errors

    def breached(self, values: Mapping[str, Mapping[str, float]]) -> tuple[bool, float | None]:
        """(is_breached, observed_value) against a fleet values dict."""
        observed = (values.get(self.metric) or {}).get(self.agg)
        if observed is None or not math.isfinite(observed):
            return False, None
        return OPS[self.op](observed, self.threshold), observed


#: Shipped rules, referencing registered exporter families only
#: (:func:`validate_rules` enforces this against METRIC_REGISTRY).
#: Thresholds are conservative defaults; deployments tune
#: for_s/threshold, not the mechanism.
DEFAULT_RULES: tuple[SloRule, ...] = (
    SloRule(
        name="worker-dead-fraction",
        metric="dlcfn_worker_dead_fraction",
        agg="value",
        op=">=",
        threshold=0.10,
        for_s=30.0,
        severity="page",
        description=">=10% of the fleet missed enough heartbeats to be "
        "declared dead for 30s — correlated failure, not one flaky host.",
    ),
    SloRule(
        name="step-time-p99-straggler",
        metric="dlcfn_step_ms",
        agg="p99",
        op=">",
        threshold=1500.0,
        for_s=60.0,
        severity="warn",
        description="fleet-wide step-time p99 above 1.5s for a minute — "
        "a straggler host is gating every synchronous collective.",
    ),
    SloRule(
        name="serve-ttft-p99",
        metric="dlcfn_serve_ttft_ms",
        agg="p99",
        op=">",
        threshold=2000.0,
        for_s=60.0,
        severity="page",
        description="serving time-to-first-token p99 over 2s sustained — "
        "user-visible latency SLO breach.",
    ),
    SloRule(
        name="serve-queue-depth",
        metric="dlcfn_serve_queue_depth",
        agg="sum",
        op=">",
        threshold=256.0,
        for_s=30.0,
        severity="warn",
        description="admission queue backing up across the serve fleet — "
        "add replicas before TTFT follows.",
    ),
    SloRule(
        name="broker-replication-lag",
        metric="dlcfn_broker_replication_lag_entries",
        agg="max",
        op=">",
        threshold=1000.0,
        for_s=30.0,
        severity="page",
        description="warm standby more than 1000 journal entries behind — "
        "a failover now would lose that tail.",
    ),
)


@dataclass
class _RuleState:
    pending_since: float | None = None
    firing: bool = False
    fired_count: int = 0
    resolved_count: int = 0
    last_value: float | None = None


class SloEngine:
    """Evaluates rules over successive fleet-value snapshots.

    ``clock`` is injected (VirtualClock in chaos, time.monotonic in
    prod); ``bus`` / ``recorder`` are optional sinks — the engine works
    headless for unit tests and wires both in the control plane.
    """

    def __init__(
        self,
        rules: tuple[SloRule, ...] | list[SloRule] = DEFAULT_RULES,
        clock: Callable[[], float] | None = None,
        bus: Any = None,
        recorder: Any = None,
        group: str = "fleet",
    ):
        errors = [e for rule in rules for e in rule.validate()]
        if errors:
            raise ValueError("invalid SLO rules: " + "; ".join(errors))
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO rule names: {names}")
        self.rules = tuple(rules)
        self._clock = clock if clock is not None else _monotonic
        self._bus = bus
        self._recorder = recorder
        self._group = group
        self._state: dict[str, _RuleState] = {r.name: _RuleState() for r in self.rules}

    def evaluate(self, values: Mapping[str, Mapping[str, float]]) -> list[dict[str, Any]]:
        """One evaluation tick; returns the transitions it emitted
        (``{"rule", "state", "value", ...}``), empty when quiet."""
        now = self._clock()
        transitions: list[dict[str, Any]] = []
        for rule in self.rules:
            state = self._state[rule.name]
            breached, observed = rule.breached(values)
            state.last_value = observed
            if observed is None:
                # No evidence either way: clear the pending window, hold
                # any firing alert (a telemetry blackout must not flap).
                state.pending_since = None
                continue
            if breached:
                if state.firing:
                    continue
                if state.pending_since is None:
                    state.pending_since = now
                if now - state.pending_since >= rule.for_s:
                    state.firing = True
                    state.fired_count += 1
                    state.pending_since = None
                    transitions.append(self._emit(rule, "firing", observed, now))
            else:
                state.pending_since = None
                if state.firing:
                    state.firing = False
                    state.resolved_count += 1
                    transitions.append(self._emit(rule, "resolved", observed, now))
        return transitions

    def _emit(
        self, rule: SloRule, state: str, observed: float | None, now: float
    ) -> dict[str, Any]:
        transition = {
            "rule": rule.name,
            "state": state,
            "metric": rule.metric,
            "agg": rule.agg,
            "op": rule.op,
            "threshold": rule.threshold,
            "value": observed if observed is None or math.isfinite(observed) else None,
            "severity": rule.severity,
            "at": now,
        }
        recorder = self._recorder if self._recorder is not None else get_recorder()
        recorder.record("alert", **transition)
        if self._bus is not None:
            from deeplearning_cfn_tpu_torch.provision.events import (
                EventKind,
                LifecycleEvent,
            )

            self._bus.publish(
                LifecycleEvent(
                    kind=EventKind.ALERT, group=self._group, detail=dict(transition)
                )
            )
        log.info(
            "alert %s %s: %s.%s=%r %s %r",
            transition["rule"], state, rule.metric, rule.agg,
            observed, rule.op, rule.threshold,
        )
        return transition

    def snapshot(self) -> dict[str, dict[str, Any]]:
        """Per-rule state for status displays and chaos assertions."""
        return {
            name: {
                "firing": s.firing,
                "pending": s.pending_since is not None,
                "fired_count": s.fired_count,
                "resolved_count": s.resolved_count,
                "last_value": s.last_value,
            }
            for name, s in sorted(self._state.items())
        }

    def active(self) -> list[str]:
        """Names of currently-firing rules, sorted."""
        return sorted(n for n, s in self._state.items() if s.firing)


def _monotonic() -> float:
    import time

    return time.monotonic()


def validate_rules(rules: tuple[SloRule, ...] = DEFAULT_RULES) -> list[str]:
    """Standalone schema check: every rule parses, and its metric resolves
    against the exporter's registered families."""
    errors = [e for rule in rules for e in rule.validate()]
    from deeplearning_cfn_tpu_torch.obs.exporter import METRIC_REGISTRY

    for rule in rules:
        if rule.metric not in METRIC_REGISTRY:
            errors.append(
                f"{rule.name}: metric {rule.metric!r} is not in "
                "obs.exporter.METRIC_REGISTRY"
            )
    return errors
