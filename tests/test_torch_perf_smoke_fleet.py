"""The port's perf-smoke gate: stage 6 (``fleet_sim``), the 10k-agent
sharded soak run twice at one seed on a virtual clock, on the CPU.

- It passes, and its snapshot equals the JAX script's stage
  (``scripts/perf_smoke.py``'s ``fleet_sim``) on the same seed.
- With a sleep planted in the soak (at 1000 agents, for time) it fails and
  names the sleep.
"""

import copy
import importlib.util
import time
from pathlib import Path

import pytest

from deeplearning_cfn_tpu_torch.analysis import schedules  # noqa: E402
from deeplearning_cfn_tpu_torch.scripts import perf_smoke as ps  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def test_fleet_sim_passes_and_equals_the_jax_scripts(monkeypatch):
    snap, failures = ps.fleet_sim("cpu")
    assert failures == []
    assert snap["agents"] == ps.FLEET_SIM_AGENTS and snap["lost_terminates"] == 0
    try:
        from deeplearning_cfn_tpu.analysis import schedules as jax_schedules
    except ImportError:
        pytest.skip("needs JAX, the reference")
    # JAX's stage runs its soak twice to check its own determinism; the
    # snapshot compared here is its first run, so one run serves both.
    runs = {}
    soak = jax_schedules.soak_fleet

    def once(**kw):
        key = tuple(sorted(kw.items()))
        if key not in runs:
            runs[key] = soak(**kw)
        return copy.deepcopy(runs[key])

    monkeypatch.setattr(jax_schedules, "soak_fleet", once)
    spec = importlib.util.spec_from_file_location("jax_perf_smoke",
                                                  REPO / "scripts" / "perf_smoke.py")
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    jax_snap, jax_failures = jax_script.fleet_sim()
    assert jax_failures == []
    assert snap == jax_snap


def test_a_planted_sleep_fails_the_stage_by_name(monkeypatch):
    soak = schedules.soak_fleet

    def sleepy(**kw):
        time.sleep(0)
        return soak(**kw)

    monkeypatch.setattr(schedules, "soak_fleet", sleepy)
    monkeypatch.setattr(ps, "FLEET_SIM_AGENTS", 1000)
    _, failures = ps.fleet_sim("cpu")
    assert any(f.startswith("fleet sim hot loop slept 2 time(s)") for f in failures), failures
