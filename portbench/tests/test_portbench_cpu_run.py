"""Whole runs of the harness on the CPU at tiny sizes: the result line's
shape, the references against the program, a planted lower precision, and
the faults the comparison has to catch."""

import shutil
import subprocess
import sys

import pytest

from portbench import harness, spec
from portbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("workload", ["mistral7b-s4096", "resnet50-b256"])
def test_line_shape_and_agreement(workload):
    result, lines = tiny.run(workload)
    assert list(result) == KEYS  # the checks last
    assert result["correct"] is True, lines
    assert result["attempted"] > 0 and result["failed"] == 0
    e2e = {m["name"] for m in spec.load_benchmark()["end_to_end"]}
    assert set(result["metrics"]) == e2e - {"peak_mem_gib"}  # no card, no device memory
    assert result["device"]["platform"] == "cpu"
    assert lines[-len(result["checks"]):] == [f"{n} {c['value']!r} limit {c['limit']!r}"
                                              for n, c in result["checks"].items()]


@pytest.mark.parametrize("workload", ["mistral7b-s4096", "resnet50-b256"])
def test_a_lower_precision_fails(workload):
    result, lines = tiny.run(workload, dtype="bfloat16")
    assert result["correct"] is False, lines


@pytest.mark.parametrize("workload,plant", [
    ("mistral7b-s4096", "unchanged"), ("mistral7b-s4096", "half_batch"),
    ("mistral7b-s4096", "altered_loss"), ("resnet50-b256", "unchanged"),
    ("resnet50-b256", "half_batch"), ("resnet50-b256", "altered_loss")])
def test_a_planted_fault_fails(workload, plant):
    result, lines = tiny.run(workload, plant=plant)
    assert result["correct"] is False, lines


def test_traced_line_on_the_cpu_has_no_device_metric():
    result, _ = tiny.run("resnet50-b256", trace=True)
    assert "mfu" not in result["metrics"] and "idle_pct" not in result["metrics"]


def test_a_run_loads_no_jax():
    code = ("import sys; from portbench.tests import tiny; from portbench import harness; "
            "tiny.run('mistral7b-s4096'); print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=spec.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("deeplearning_cfn_tpu_torch_probe_", sys)
    try:
        assert "deeplearning_cfn_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["deeplearning_cfn_tpu_torch_probe_"]


def test_the_command_refuses_a_host_without_a_card():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "resnet50-b256",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_checkout_without_the_program_refuses_to_run(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "resnet50-b256",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "holds no deeplearning_cfn_tpu_torch" in out.stderr
