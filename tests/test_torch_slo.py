"""The port's SLO engine (``obs/slo.py``, a copy) against the JAX package's.

Seeded sequences of fleet values — breaches, recoveries, flapping, NaN and
missing readings (telemetry blackouts) — go through both engines on virtual
clocks: the transition lists, the snapshots, the active rules, the journal's
``alert`` events and the ``ALERT`` events on the bus must be equal, exactly
(the engine compares floats; it computes none).  ``DEFAULT_RULES`` and
``validate_rules`` (over the shipped rules and broken ones) are equal too.
"""

import dataclasses
import math

import numpy as np
import pytest

try:
    from deeplearning_cfn_tpu.analysis import schedules as jschedules
    from deeplearning_cfn_tpu.obs import recorder as jrecorder
    from deeplearning_cfn_tpu.obs import slo as jslo
    from deeplearning_cfn_tpu.provision import events as jevents
except ImportError:  # the card's host
    jslo = None

from deeplearning_cfn_tpu_torch import obs  # noqa: E402
from deeplearning_cfn_tpu_torch.analysis import schedules  # noqa: E402
from deeplearning_cfn_tpu_torch.obs import recorder, slo  # noqa: E402
from deeplearning_cfn_tpu_torch.provision import events  # noqa: E402

pytestmark = pytest.mark.skipif(jslo is None, reason="needs JAX, the reference")


def _rules(mod):
    return tuple(mod.DEFAULT_RULES) + (
        mod.SloRule(name="fast", metric="dlcfn_serve_queue_depth", agg="max", op=">=",
                    threshold=3.0, for_s=0.0, severity="info"),
        mod.SloRule(name="low-rate", metric="dlcfn_serve_tokens_per_s", agg="p50", op="<",
                    threshold=10.0, for_s=2.5),
    )


def _values(seed: int, rounds: int) -> list[dict]:
    """Per round a fleet-values dict: each rule's metric breaching, healthy,
    NaN or missing, in seeded runs (so pending windows fill and flap)."""
    rng = np.random.default_rng(seed)
    metrics = {("dlcfn_worker_dead_fraction", "value"): (0.0, 0.5),
               ("dlcfn_step_ms", "p99"): (100.0, 2000.0),
               ("dlcfn_serve_ttft_ms", "p99"): (50.0, 5000.0),
               ("dlcfn_serve_queue_depth", "sum"): (10.0, 400.0),
               ("dlcfn_serve_queue_depth", "max"): (1.0, 5.0),
               ("dlcfn_broker_replication_lag_entries", "max"): (0.0, 2000.0),
               ("dlcfn_serve_tokens_per_s", "p50"): (50.0, 2.0)}
    state = {k: 0 for k in metrics}
    out = []
    for _ in range(rounds):
        values: dict = {}
        for key, (ok, bad) in metrics.items():
            if rng.random() < 0.2:
                state[key] = int(rng.integers(0, 4))  # 0 ok, 1 bad, 2 NaN, 3 missing
            reading = (ok, bad, math.nan, None)[state[key]]
            if reading is not None:
                values.setdefault(key[0], {})[key[1]] = float(reading)
        out.append(values)
    return out


def _drive(side: str, seed: int) -> dict:
    mod, sched, rec_mod, ev = ((slo, schedules, recorder, events) if side == "port"
                               else (jslo, jschedules, jrecorder, jevents))
    clock = sched.VirtualClock()
    bus = ev.EventBus()
    seen = []
    bus.subscribe(lambda e: seen.append((e.kind.value, e.group, dict(e.detail))))
    rec = rec_mod.FlightRecorder()
    engine = mod.SloEngine(rules=_rules(mod), clock=clock, bus=bus, recorder=rec,
                           group="fleet")
    transitions, snaps, active = [], [], []
    for values in _values(seed, 120):
        transitions.append(engine.evaluate(values))
        snaps.append(engine.snapshot())
        active.append(engine.active())
        clock.advance(1.0)
    journal = [{k: v for k, v in e.items() if k not in ("ts", "seq", "host", "pid")}
               for e in rec.tail(4096) if e.get("kind") == "alert"]
    return {"transitions": transitions, "snaps": snaps, "active": active, "bus": seen,
            "journal": journal}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_engine_transitions_and_snapshots_equal_jax(seed):
    port, ref = _drive("port", seed), _drive("jax", seed)
    assert port == ref
    fired = sum(1 for ts in port["transitions"] for t in ts if t["state"] == "firing")
    assert fired and port["bus"] and port["journal"]  # the sequence exercises the engine


def test_default_rules_equal_jax():
    assert [dataclasses.asdict(r) for r in slo.DEFAULT_RULES] == [
        dataclasses.asdict(r) for r in jslo.DEFAULT_RULES]
    assert slo.validate_rules() == jslo.validate_rules() == []
    assert obs.DEFAULT_RULES is slo.DEFAULT_RULES and obs.SloEngine is slo.SloEngine


def _broken(mod):
    return (
        mod.SloRule(name="", metric="cpu", agg="p42", op="!=", threshold=math.inf,
                    for_s=-1.0, severity="critical"),
        mod.SloRule(name="unregistered", metric="dlcfn_nope", agg="sum", op=">",
                    threshold=1.0, for_s=1.0),
    )


def test_validate_rules_on_broken_rules_equals_jax():
    assert slo.validate_rules(_broken(slo)) == jslo.validate_rules(_broken(jslo))
    assert len(slo.validate_rules(_broken(slo))) == 9
    for mod in (slo, jslo):
        with pytest.raises(ValueError, match="invalid SLO rules"):
            mod.SloEngine(rules=_broken(mod))
        dup = mod.DEFAULT_RULES[0]
        with pytest.raises(ValueError, match="duplicate"):
            mod.SloEngine(rules=(dup, dup))


def test_rule_breached_equals_jax():
    for values in _values(7, 40):
        for a, b in zip(_rules(slo), _rules(jslo)):
            assert a.breached(values) == b.breached(values)
