"""The port's perf-smoke gate (``deeplearning_cfn_tpu_torch/scripts/
perf_smoke.py``): the stages that put work on the device, 1-3, on the CPU.

- Each stage passes with ``--device cpu``: the uint8 stream's exact bytes,
  the profiler off by default and under its 2% budget, the stacked
  batches double-buffered and freed, the consumer holding one program.
- Each stage fails, and names the violation, when a fault is planted by
  monkeypatching: a uint8 stream that ships float32, a disabled profiler
  that wraps the source, a profiler whose ``step_done`` sleeps (its 2%
  budget), a ``donate_buffers`` that frees nothing.
- ``StepProfiler`` queues a step's records and folds them later: its
  snapshots equal those of JAX's profiler, which folds at each call, over
  a run that fills the queue many times, and the queue stays bounded.
- The script's stages, their order and its output line's keys are the
  JAX script's (``scripts/perf_smoke.py``); the whole script (slow) exits
  0 with one JSON line of those keys.

The comms stages (10, 11) are ``test_torch_perf_smoke_comms.py``'s; the
virtual-clock stages ``_planes.py`` and ``_fleet.py``'s.
"""

import ast
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning_cfn_tpu_torch.obs import profiler as profiler_mod  # noqa: E402
from deeplearning_cfn_tpu_torch.scripts import perf_smoke as ps  # noqa: E402
from deeplearning_cfn_tpu_torch.train import data  # noqa: E402

try:
    from deeplearning_cfn_tpu.obs import profiler as jax_profiler
except ImportError:  # the card's host has no JAX
    jax_profiler = None

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
JAX_SCRIPT = REPO / "scripts" / "perf_smoke.py"


def _jax_main_keys() -> list[str]:
    """The keys of the JSON object the JAX script's ``main`` prints, read
    from its source (the script needs 8 virtual devices to run whole)."""
    tree = ast.parse(JAX_SCRIPT.read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    dumps = next(n for n in ast.walk(main) if isinstance(n, ast.Call)
                 and getattr(n.func, "attr", None) == "dumps")
    return [k.value for k in dumps.args[0].keys]


def _jax_stage_order() -> list[str]:
    """The stage functions the JAX script's ``main`` calls, in order."""
    tree = ast.parse(JAX_SCRIPT.read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    calls = [n.func.id for n in ast.walk(main) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name)]
    order = []
    for c in calls:
        if c not in order:
            order.append(c)
    return order


# What each of the port's stages folds from the JAX script: stages 1 and 2
# are the gate in JAX's ``main`` over ``run_pipeline`` and
# ``profiler_overhead``.
JAX_STAGE_OF = {"pipeline": "run_pipeline", "profiler": "profiler_overhead",
                "overlap": "input_overlap", "serve": "serve_scheduler",
                "broker_failover": "broker_soak", "fleet_sim": "fleet_sim",
                "telemetry": "telemetry_overhead", "datastream": "datastream",
                "sched": "sched_placer", "comms": "comms_budget",
                "comms_overlap": "comms_overlap", "determinism": "determinism"}


def test_stages_and_output_keys_are_the_jax_scripts():
    order = [n for n in _jax_stage_order() if n in JAX_STAGE_OF.values()]
    assert [JAX_STAGE_OF[name] for name, _ in ps.STAGES] == order
    spread = {"pipeline": ["uint8", "float32", "bytes_ratio", "workers"],
              "profiler": ["profiler_overhead", "step_ms"]}
    keys = [k for name, _ in ps.STAGES for k in spread.get(name, [name])]
    assert keys == _jax_main_keys()
    assert set(ps.DEVICE_STAGES) == {"pipeline", "profiler", "overlap", "comms", "comms_overlap"}


STAGES = dict(ps.STAGES)
NAMES = ("pipeline", "profiler", "overlap")


@pytest.mark.parametrize("name", NAMES)
def test_stage_passes_on_the_cpu(name):
    snap, failures = STAGES[name]("cpu")
    assert failures == []
    if name == "pipeline":
        assert snap["uint8"]["bytes_transferred"] == ps.STEPS * ps.BATCH * (32 * 32 * 3 + 4)
        assert snap["uint8"]["batches"] == snap["float32"]["batches"] == ps.STEPS
        assert snap["bytes_ratio"] < 0.26
    elif name == "profiler":
        assert snap["profiler_overhead"]["overhead_fraction"] < ps.OVERHEAD_BUDGET
        assert 0 < snap["step_ms"]["p50"] <= snap["step_ms"]["p99"]
    else:
        assert snap == {"steps_per_call": 2, "calls": 5, "device_resident_stacks_peak": 3,
                        "donated_bytes": 5 * 2 * 8 * (32 * 32 * 3 + 4), "warmup_captures": 0,
                        "post_warmup_compiles": 0}


def _ship_float32(monkeypatch):
    monkeypatch.setattr(data.SyntheticDataset, "_quantize",
                        lambda self, x: x.astype(np.float32))
    return "uint8 pipeline delivered torch.float32"


def _wrapping_null_profiler(monkeypatch):
    monkeypatch.setattr(profiler_mod.NULL_PROFILER, "wrap_source", lambda it: (b for b in it))
    return "disabled profiler wraps the batch source"


def _slow_step_done(monkeypatch):
    """A profiler that sleeps 1 ms a step: ~5% of the CPU's step (JAX's
    1024 matmul on one thread, ~20 ms), past the 2% budget."""
    step_done = profiler_mod.StepProfiler.step_done

    def slow(self, *args, **kwargs):
        time.sleep(1e-3)
        return step_done(self, *args, **kwargs)

    monkeypatch.setattr(profiler_mod.StepProfiler, "step_done", slow)
    return "StepProfiler overhead"


def _donate_nothing(monkeypatch):
    monkeypatch.setattr(data, "donate_buffers", lambda tree: 0)
    return "consumed stack leaves survive donate_buffers"


# plant: (the stage it breaks, the plant)
PLANTS = {"pipeline": ("pipeline", _ship_float32),
          "profiler": ("profiler", _wrapping_null_profiler),
          "overlap": ("overlap", _donate_nothing),
          "profiler_step_cost": ("profiler", _slow_step_done)}


@pytest.mark.parametrize("name", PLANTS)
def test_a_planted_violation_fails_the_stage_by_name(name, monkeypatch):
    stage, plant = PLANTS[name]
    expected = plant(monkeypatch)
    _, failures = STAGES[stage]("cpu")
    assert any(expected in f for f in failures), failures


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _profiled_run(mod, steps: int) -> list:
    """``steps`` steps of phases, producer folds, k-step calls and sync
    boundaries on a virtual clock, with reads along the way."""
    clock = _Clock()
    prof = mod.StepProfiler(name="queued", clock=clock, window=64)
    rng = np.random.default_rng(0)
    reads = []
    prof.start()
    for i in range(steps):
        clock.t += float(rng.uniform(1e-4, 1e-3))
        with prof.phase("data_wait"):
            clock.t += float(rng.uniform(0, 2e-3))
        prof.fold("h2d", float(rng.uniform(0, 1e-3)), critical=bool(i % 3))
        with prof.phase("dispatch"):
            clock.t += float(rng.uniform(1e-3, 5e-3))
        if i % 10 == 9:
            with prof.sync_boundary(10):
                clock.t += float(rng.uniform(0, 1e-2))
        prof.step_done(step=i, steps=1 + i % 2)
        if i in (5, 300, 301):
            reads.append((prof.snapshot(), prof.recent_step_ms()))
    prof.start()
    clock.t += 0.5
    prof.step_done(step=steps)
    reads.append((prof.snapshot(), prof.recent_step_ms()))
    return reads


@pytest.mark.skipif(jax_profiler is None, reason="needs JAX, the reference")
def test_the_queued_profiler_folds_what_jax_folds_at_each_call():
    steps = 5 * profiler_mod.PENDING_CAP
    assert _profiled_run(profiler_mod, steps) == _profiled_run(jax_profiler, steps)


def test_the_profiler_queue_stays_bounded():
    prof = profiler_mod.StepProfiler(name="bounded")
    prof.start()
    for i in range(3 * profiler_mod.PENDING_CAP):
        with prof.phase("dispatch"):
            pass
        prof.step_done(step=i)
        assert len(prof._pending) < profiler_mod.PENDING_CAP
    for _ in range(3 * profiler_mod.PENDING_CAP):
        prof.fold("h2d", 1e-6, critical=False)
        assert len(prof._pending) < profiler_mod.PENDING_CAP
    assert prof.snapshot()["steps"] == 3 * profiler_mod.PENDING_CAP


@pytest.mark.slow
def test_the_whole_script_prints_one_line_of_the_jax_keys():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, "-m", "deeplearning_cfn_tpu_torch.scripts.perf_smoke",
                           "--device", "cpu"], env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    assert list(json.loads(lines[0])) == _jax_main_keys()
