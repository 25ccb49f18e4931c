"""The port's composed-incident gauntlet (``chaos/gauntlet.py``) against the
JAX package's.

The schedule half is a copy of JAX's and is held to it: validation, the
dict round trip, the perturbed draws, the shrinker and the sweep with a
stub runner.  The pinned seed-0 incident runs for real: four CPU gloo ranks
(2 slices x fsdp 2, the control plane in rank 0's process) where JAX runs
one SPMD program over eight virtual devices, both from JAX's initial
weights (``interop.dense_params_from_jax``) on the same global batches.
Its report passes, and its decisions are JAX's: the schedule and its
faults, the alert timeline, the record and work counts, the journal
deltas and the restored checkpoint step; the meshes differ by the device
count alone (the one invariant that names it says 2 ranks where JAX's says
4 devices), and the losses are held to JAX's within the scenario's own
tolerance (rtol 5e-3, atol 1e-4).  The journal's ``gauntlet`` events fold
into ``cli status`` and its Prometheus text, and ``cli gauntlet`` prints
JAX's shapes with JAX's exit codes.  The pairwise fault matrix and the
20-seed sweep are slow, as JAX's are.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax

    from deeplearning_cfn_tpu.chaos import gauntlet as jgauntlet
    from deeplearning_cfn_tpu.chaos import scenarios as jscenarios
except ImportError:  # the card's host
    jax = None

from deeplearning_cfn_tpu_torch import cli  # noqa: E402
from deeplearning_cfn_tpu_torch.chaos import (  # noqa: E402
    FAULT_KINDS,
    SCENARIO_FAULTS,
    FaultEvent,
    FaultSchedule,
    perturbed_schedule,
    pinned_schedule,
    run_gauntlet,
    run_gauntlet_sweep,
    shrink_schedule,
)

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")

_AT = {"slice-loss": 4, "shard-failover": 2, "writer-crash": 6, "telemetry-blackout": 8}
PAIRS = [(a, b) for i, a in enumerate(FAULT_KINDS) for b in FAULT_KINDS[i + 1:]]
DECISIONS = ("schedule", "plane_records", "plane_per_host", "work_depth", "resends",
             "healed_pairs", "alert_timeline", "journal_deltas", "restore_step")
MESH_CHECK = ("trainer rebound to the surviving {} fsdp mesh with grad accumulation "
              "rescaled 1 -> 2 (global batch preserved)")


def _event(kind):
    return FaultEvent(kind, at_step=_AT[kind], duration=2 if kind == "telemetry-blackout" else 0,
                      shard=1 if kind == "shard-failover" else 0)


def _pair_schedule(a, b, seed=0):
    return FaultSchedule(seed=seed, events=tuple(_event(k) for k in
                                                 sorted((a, b), key=FAULT_KINDS.index)))


@pytest.fixture(scope="module")
def pinned(tmp_path_factory):
    """The port's pinned seed-0 incident from JAX's weights, and JAX's."""
    from tests.test_torch_chaos_catalog import mlp_weights

    weights = mlp_weights(0, tmp_path_factory.mktemp("gauntlet") / "mlp.pt")
    port = run_gauntlet(pinned_schedule(0), "cpu", weights)
    ref = json.loads(json.dumps(jscenarios.run_scenario("gauntlet", 0).to_dict()))
    return port, ref


@needs_jax
def test_pinned_incident_passes_with_jax_decisions(pinned):
    port, ref = pinned
    mine = port.to_dict()
    assert mine["passed"] and mine["violations"] == [], mine["violations"]
    assert ref["passed"]
    assert mine["faults"] == ref["faults"] == [
        {"kind": "slice-loss", "at_step": 3}, {"kind": "shard-failover", "at_step": 3, "shard": 0},
        {"kind": "writer-crash", "at_step": 5}]
    assert {k: mine["details"][k] for k in DECISIONS} == {k: ref["details"][k]
                                                           for k in DECISIONS}
    # JAX's invariants, the mesh named by its ranks.
    assert mine["invariants"] == [MESH_CHECK.format("2-rank") if s == MESH_CHECK.format(
        "4-device") else s for s in ref["invariants"]]
    assert port.observed["post_mesh"] == {"devices": 2, "axes": {"fsdp": 2}}
    assert port.observed["grad_accum"] == 2
    ranks = port.observed["ranks"]
    assert [r["left"] for r in ranks] == [False, False, True, True]
    assert ranks[1]["losses"] == ranks[0]["losses"] and len(ranks[2]["losses"]) == 3
    assert json.loads(json.dumps(mine)) == mine
    # The first run of its key trains the straight curve and checks against its own.
    assert port.observed["straight_ran"]
    assert mine["details"]["straight_losses"] == [round(v, 6) for v in port.observed["straight"]]


@needs_jax
def test_pinned_incident_losses_held_to_jax(pinned):
    port, ref = pinned
    d, r = port.to_dict()["details"], ref["details"]
    np.testing.assert_allclose(d["straight_losses"], r["straight_losses"], rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(d["gauntlet_losses"], r["gauntlet_losses"], rtol=5e-3, atol=1e-4)
    die = 3
    assert d["gauntlet_losses"][:die] == d["straight_losses"][:die]


@needs_jax
@pytest.mark.parametrize("seed", range(6))
def test_schedules_equal_jax(seed):
    assert perturbed_schedule(seed).to_dict() == jgauntlet.perturbed_schedule(seed).to_dict()
    assert pinned_schedule(seed).to_dict() == jgauntlet.pinned_schedule(seed).to_dict()
    sched = perturbed_schedule(seed)
    assert sched.validate() == jgauntlet.FaultSchedule.from_dict(sched.to_dict()).validate()


@needs_jax
def test_validate_rejects_unassertable_schedules_as_jax():
    def errs(module, events, **kw):
        return module.FaultSchedule(seed=0, events=tuple(
            module.FaultEvent(**e) for e in events), **kw).validate()

    bad = [
        ([dict(kind="slice-loss", at_step=4), dict(kind="slice-loss", at_step=4)], {}),
        ([dict(kind="disk-on-fire", at_step=3)], {}),
        ([dict(kind="slice-loss", at_step=4)], {"total_steps": 7}),
        ([dict(kind="slice-loss", at_step=10)], {}),
        ([dict(kind="slice-loss", at_step=4), dict(kind="writer-crash", at_step=3)], {}),
        ([dict(kind="shard-failover", at_step=2, shard=5)], {}),
        ([dict(kind="shard-failover", at_step=2),
          dict(kind="telemetry-blackout", at_step=3, duration=2)], {}),
    ]
    for events, kw in bad:
        mine = errs(__import__("deeplearning_cfn_tpu_torch.chaos.gauntlet",
                               fromlist=["x"]), events, **kw)
        assert mine and mine == errs(jgauntlet, events, **kw)
    assert not pinned_schedule(0).validate()


def test_run_gauntlet_refuses_invalid_schedule():
    bad = FaultSchedule(seed=0, events=(FaultEvent("slice-loss", at_step=0),))
    with pytest.raises(ValueError, match="slice-loss"):
        run_gauntlet(bad, "cpu")


def test_schedule_roundtrips_through_dict():
    for seed in range(6):
        sched = perturbed_schedule(seed)
        assert not sched.validate(), (seed, sched.validate())
        assert FaultSchedule.from_dict(sched.to_dict()) == sched
    assert perturbed_schedule(3) == perturbed_schedule(3)


class _StubReport:
    def __init__(self, passed: bool):
        self.passed = passed
        self.violations = [] if passed else ["stub violation"]


def test_shrinker_produces_stable_minimal_schedule():
    full = FaultSchedule(seed=9, events=tuple(_event(k) for k in FAULT_KINDS))
    assert not full.validate()

    def still_fails(sched):
        return {"writer-crash", "shard-failover"} <= {e.kind for e in sched.events}

    minimal = shrink_schedule(full, still_fails)
    assert [e.kind for e in minimal.events] == ["shard-failover", "writer-crash"]
    assert not minimal.validate()
    assert shrink_schedule(full, still_fails) == minimal


@needs_jax
def test_sweep_with_a_stub_runner_equals_jax():
    def runner(sched):
        return _StubReport(passed=not {"writer-crash", "shard-failover"}
                           <= {e.kind for e in sched.events})

    summary = run_gauntlet_sweep(n_seeds=8, base_seed=0, runner=runner)
    assert summary["seeds"] == 8
    assert summary["passed"] + len(summary["failures"]) == 8 and summary["failures"]
    for failure in summary["failures"]:
        assert [e["kind"] for e in failure["shrunk"]["events"]] == ["shard-failover",
                                                                    "writer-crash"]
    assert summary == run_gauntlet_sweep(n_seeds=8, base_seed=0, runner=runner)
    assert summary == jgauntlet.run_gauntlet_sweep(n_seeds=8, base_seed=0, runner=runner)


def test_gauntlet_journal_folds_into_status_and_prom(tmp_path, capsys):
    from deeplearning_cfn_tpu_torch.obs.recorder import FlightRecorder

    path = tmp_path / "flight.jsonl"
    rec = FlightRecorder(path=path)
    rec.record("gauntlet", event="run", seed=0, passed=True, faults=3, violations=0)
    rec.record("gauntlet", event="run", seed=1, passed=False, faults=2, violations=1)
    rec.record("gauntlet", event="sweep", seeds=20, base_seed=0, failures=0)
    rec.close()
    assert cli.main(["status", "--journal", str(path)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["gauntlet"]["runs_total"] == 2
    assert out["gauntlet"]["last_run"] == {"seed": 1, "passed": False, "faults": 2,
                                           "violations": 1}
    assert out["gauntlet"]["sweep"] == {"seeds": 20, "base_seed": 0, "failures": 0}
    assert cli.main(["status", "--journal", str(path), "--format", "prom"]) == 0
    text = capsys.readouterr().out
    for line in ("dlcfn_gauntlet_runs_total 2", 'dlcfn_gauntlet_passed{seed="1"} 0',
                 'dlcfn_gauntlet_violations{seed="1"} 1', "dlcfn_gauntlet_sweep_seeds 20",
                 "dlcfn_gauntlet_sweep_failures 0"):
        assert line in text


def test_a_run_and_a_sweep_journal_their_events(monkeypatch):
    from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

    def runner(sched):
        return _StubReport(passed=True)

    n = len([e for e in get_recorder().tail(4096) if e.get("kind") == "gauntlet"])
    run_gauntlet_sweep(n_seeds=2, base_seed=5, runner=runner)
    events = [e for e in get_recorder().tail(4096) if e.get("kind") == "gauntlet"][n:]
    assert [(e["event"], e["seeds"], e["base_seed"], e["failures"]) for e in events] == [
        ("sweep", 2, 5, 0)]


def test_cli_gauntlet_pinned_run(capsys):
    assert cli.main(["gauntlet", "--seed", "0", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["scenario"] == "gauntlet" and report["passed"] is True
    assert report["schema_version"] == 2
    assert [f["kind"] for f in report["faults"]] == ["slice-loss", "shard-failover",
                                                     "writer-crash"]


def test_cli_gauntlet_sweep_arg_validation(capsys):
    assert cli.main(["gauntlet", "--sweep", "0", "--device", "cpu"]) == 2
    assert "at least 1 seed" in capsys.readouterr().out


def test_cli_gauntlet_sweep_reports_its_ranks_kernel_launches(monkeypatch, capsys):
    import deeplearning_cfn_tpu_torch.chaos as chaos

    def run(schedule, device):
        rep = _StubReport(passed=True)
        rep.observed = {"kernel_launches": {"flash": schedule.seed, "fused_dense": 1}}
        return rep

    monkeypatch.setattr(chaos, "run_gauntlet", run)
    assert cli.main(["gauntlet", "--sweep", "3", "--seed", "4", "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert json.loads(out)["passed"] == 3  # stdout is the summary alone
    assert json.loads(err.splitlines()[-1]) == {"kernel_launches": {"flash": 4 + 5 + 6,
                                                                    "fused_dense": 3}}


def test_chaos_list_prints_fault_vocabulary(capsys):
    assert cli.main(["chaos", "--list"]) == 0
    out = capsys.readouterr().out
    assert "gauntlet" in out and "faults:" in out
    assert ", ".join(SCENARIO_FAULTS["gauntlet"]) in out


@pytest.mark.slow
@pytest.mark.parametrize("a,b", PAIRS, ids=[f"{a}+{b}" for a, b in PAIRS])
def test_pairwise_composition_holds_and_is_byte_deterministic(a, b):
    schedule = _pair_schedule(a, b)
    assert not schedule.validate()
    first = run_gauntlet(schedule, "cpu")
    assert first.passed, f"{a}+{b}: {first.violations}"
    second = run_gauntlet(schedule, "cpu")
    assert json.dumps(first.to_dict(), sort_keys=True) == json.dumps(second.to_dict(),
                                                                     sort_keys=True)
    assert [f["kind"] for f in first.to_dict()["faults"]] == sorted((a, b),
                                                                   key=FAULT_KINDS.index)


@pytest.mark.slow
def test_sweep_20_seeds_zero_failing_schedules():
    summary = run_gauntlet_sweep(n_seeds=20, base_seed=0, device="cpu")
    assert summary["passed"] == 20 and summary["failures"] == []
    assert all(summary["fault_counts"][k] > 0 for k in FAULT_KINDS)
