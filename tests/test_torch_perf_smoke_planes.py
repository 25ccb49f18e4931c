"""The port's perf-smoke gate: the stages on virtual clocks and host data
(4 ``serve``, 5 ``broker_failover``, 7 ``telemetry``, 8 ``datastream``,
9 ``sched``, 12 ``determinism``) on the CPU.

- Each stage passes, and its snapshot, wall-clock fields aside, equals
  the JAX script's stage (``scripts/perf_smoke.py``) on the same seed.
- Each stage fails, and names the violation, when a fault is planted by
  monkeypatching: a completion the engine drops, a terminate the soak
  loses, a payload over its byte budget, a shard assigned twice, a
  placement that depends on submission order, a replay case that is not
  deterministic.

(``fleet_sim`` is ``test_torch_perf_smoke_fleet.py``'s.)
"""

import importlib.util
import random
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from deeplearning_cfn_tpu_torch import sched as sched_pkg  # noqa: E402
from deeplearning_cfn_tpu_torch.analysis import replay_audit, schedules  # noqa: E402
from deeplearning_cfn_tpu_torch.obs import aggregator  # noqa: E402
from deeplearning_cfn_tpu_torch.scripts import perf_smoke as ps  # noqa: E402
from deeplearning_cfn_tpu_torch.serve import engine as engine_mod  # noqa: E402
from deeplearning_cfn_tpu_torch.train import datastream  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
STAGES = dict(ps.STAGES)
NAMES = ("serve", "broker_failover", "telemetry", "datastream", "sched", "determinism")
JAX_STAGE_OF = {"serve": "serve_scheduler", "broker_failover": "broker_soak",
                "telemetry": "telemetry_overhead", "datastream": "datastream",
                "sched": "sched_placer", "determinism": "determinism"}
WALL_CLOCK_FIELDS = {"determinism": ("wall_s",)}


def _jax_script():
    """The JAX package's ``scripts/perf_smoke.py``, imported by path."""
    try:
        import jax  # noqa: F401
    except ImportError:
        pytest.skip("needs JAX, the reference")
    spec = importlib.util.spec_from_file_location("jax_perf_smoke",
                                                  REPO / "scripts" / "perf_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def port_runs():
    """Each stage's (snapshot, failures), run once for the module."""
    cache = {}

    def run(name):
        if name not in cache:
            cache[name] = STAGES[name]("cpu")
        return cache[name]

    return run


def _without_wall_clock(name, snap):
    return {k: v for k, v in snap.items() if k not in WALL_CLOCK_FIELDS.get(name, ())}


@pytest.mark.parametrize("name", NAMES)
def test_stage_passes_on_the_cpu(name, port_runs):
    snap, failures = port_runs(name)
    assert failures == []
    assert snap


@pytest.mark.parametrize("name", NAMES)
def test_stage_equals_the_jax_scripts_on_the_same_seed(name, port_runs):
    jax_snap, jax_failures = getattr(_jax_script(), JAX_STAGE_OF[name])()
    snap, _ = port_runs(name)
    assert jax_failures == []
    assert _without_wall_clock(name, snap) == _without_wall_clock(name, jax_snap)


def _drop_a_completion(monkeypatch):
    retire = engine_mod.ContinuousBatchingEngine._retire
    dropped = []

    def lossy(self, slot, completions):
        retire(self, slot, completions)
        if not dropped and slot.request.request_id != "warm":
            dropped.append(completions.pop())

    monkeypatch.setattr(engine_mod.ContinuousBatchingEngine, "_retire", lossy)
    return "serve scheduler lost requests"


def _lose_a_terminate(monkeypatch):
    soak = schedules.soak_failover

    def lossy(**kw):
        out = soak(**kw)
        return {**out, "lost_terminates": out["lost_terminates"] + 1}

    monkeypatch.setattr(schedules, "soak_failover", lossy)
    return "broker failover lost 1 INSTANCE_TERMINATE events"


def _pad_the_payload(monkeypatch):
    encode = aggregator.encode_snapshot
    monkeypatch.setattr(aggregator, "encode_snapshot", lambda snap: encode(snap) + b" " * 8192)
    return "telemetry payload"


def _assign_a_shard_twice(monkeypatch):
    assign = datastream.assign_shards

    def twice(hosts, n_shards, **kw):
        out = assign(hosts, n_shards, **kw)
        first, second = list(out)[:2]
        return {**out, second: tuple(out[second]) + tuple(out[first][:1])}

    monkeypatch.setattr(datastream, "assign_shards", twice)
    return "epoch 0: shard assignment is not an exact partition"


def _order_dependent_placement(monkeypatch):
    place = sched_pkg.place

    def by_order(jobs, inventory, *a, **kw):
        jobs = list(jobs)
        return place(jobs if jobs[-1].name == "hopeless" else jobs[:-1], inventory, *a, **kw)

    monkeypatch.setattr(sched_pkg, "place", by_order)
    return "placement depends on submission order"


def _a_nondeterministic_case(monkeypatch):
    cases = replay_audit.default_cases
    coin = random.Random()

    def with_coin(*a, **kw):
        return cases(*a, **kw) + [replay_audit.ReplayCase(
            name="coin", kind="soak", run=lambda seed: {"draw": coin.random()},
            audited_file="tests/test_torch_perf_smoke_planes.py")]

    monkeypatch.setattr(replay_audit, "default_cases", with_coin)
    return "determinism stage: soak 'coin' diverged"


PLANTS = {"serve": _drop_a_completion, "broker_failover": _lose_a_terminate,
          "telemetry": _pad_the_payload, "datastream": _assign_a_shard_twice,
          "sched": _order_dependent_placement, "determinism": _a_nondeterministic_case}


@pytest.mark.parametrize("name", NAMES)
def test_a_planted_violation_fails_the_stage_by_name(name, monkeypatch):
    expected = PLANTS[name](monkeypatch)
    _, failures = STAGES[name]("cpu")
    assert any(f.startswith(expected) for f in failures), failures
