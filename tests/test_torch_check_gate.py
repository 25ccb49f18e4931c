"""The port's gate, ``deeplearning_cfn_tpu_torch/scripts/check.sh``, and
its lint wrapper, held to ``scripts/check.sh`` and ``scripts/lint.sh``:

- every command runs ``deeplearning_cfn_tpu_torch`` and none runs the JAX
  package or a JAX script;
- every stage of ``scripts/check.sh`` has its counterpart, in order, but
  the warn-only bench trajectory (the port's benchmark's), which the
  script names as left out;
- the chaos stage pins the same nine scenarios;
- the scripts parse, and the gate's SLO-schema stage passes.
"""

import re
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "deeplearning_cfn_tpu_torch" / "scripts" / "check.sh"
JAX = REPO / "scripts" / "check.sh"


def _headers(text: str) -> list[str]:
    """The stage labels: each ``echo "== label (...) =="``'s label."""
    return [re.split(r" \(| ==", h)[0] for h in re.findall(r'^echo "== (.*)"$', text, re.M)]


def _pinned(text: str) -> list[str]:
    block = re.search(r"for required in \((.*?)\):", text, re.S).group(1)
    return re.findall(r'"([^"]+)"', block)


def _commands(text: str) -> list[str]:
    """The script's lines that are not comments."""
    return [line for line in text.splitlines() if line.strip() and not line.lstrip().startswith("#")]


def test_every_command_runs_the_port():
    lines = _commands(PORT.read_text())
    modules = [m for line in lines for m in re.findall(r'\$PY"? -m ([\w.]+)', line) if m != "pytest"]
    modules += [m for line in lines for m in re.findall(r"^from (\S+) import", line)]
    assert modules and all(m.startswith("deeplearning_cfn_tpu_torch.") for m in modules), modules
    assert "$DLCFN" in PORT.read_text()
    assert 'DLCFN="$PY -m deeplearning_cfn_tpu_torch.cli"' in PORT.read_text()
    for line in lines:
        assert "deeplearning_cfn_tpu." not in line, line
        assert not re.search(r"\bscripts/\w+\.py", line), line
    # The tier-1 stage runs the port's tests only.
    assert "tests/test_torch_*.py" in PORT.read_text()


def test_every_stage_but_the_bench_trajectory_has_its_counterpart():
    jax = [h for h in _headers(JAX.read_text()) if h != "bench trajectory"]
    assert len(jax) == 9
    assert _headers(PORT.read_text()) == jax
    text = PORT.read_text()
    assert "bench trajectory" in text and "bench_compare.py" in text


def test_the_chaos_stage_pins_the_same_nine_scenarios():
    assert _pinned(PORT.read_text()) == _pinned(JAX.read_text())
    assert len(_pinned(PORT.read_text())) == 9


def test_the_scripts_parse_and_the_slo_stage_passes():
    for script in (PORT, PORT.with_name("lint.sh"), PORT.with_name("first-network-session.sh")):
        assert subprocess.run(["bash", "-n", str(script)]).returncode == 0, script
    slo = re.search(r'"\$PY" - <<\'EOF\' \|\| exit 1\n(from deeplearning_cfn_tpu_torch\.obs\.slo.*?)\nEOF',
                    PORT.read_text(), re.S).group(1)
    exec(compile(slo, "check.sh:slo-schema", "exec"), {})


def test_the_lint_wrapper_keeps_json():
    lint = PORT.with_name("lint.sh").read_text()
    jax = (REPO / "scripts" / "lint.sh").read_text()
    assert 'args+=(--format json)' in lint and 'args+=(--format json)' in jax
    assert "-m deeplearning_cfn_tpu_torch.cli lint" in lint
    proc = subprocess.run(["bash", str(PORT.with_name("lint.sh")), "--json",
                           str(PORT.parent / "perf_smoke.py")], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '"violations": []' in proc.stdout
