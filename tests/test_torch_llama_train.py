"""The port's Llama example end to end on the CPU, and the port's boundaries:
it imports nothing of JAX or of the JAX package, its entry points refuse to
fall back to the CPU, and ``chip_smoke.py`` refuses to run without a card or
outside the repository."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning_cfn_tpu_torch.examples import llama_train  # noqa: E402
from deeplearning_cfn_tpu_torch.parallel.mesh import MeshError  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "deeplearning_cfn_tpu"}


def test_main_runs_tiny_on_cpu():
    result = llama_train.main(
        ["--size", "tiny", "--steps", "3", "--device", "cpu", "--seq_len", "32",
         "--global_batch_size", "2", "--log_every", "1", "--eval_steps", "1"]
    )
    assert result["steps"] == 3 and result["device"] == "cpu"
    assert result["params"] > 0 and len(result["history"]) == 3
    assert all(torch.isfinite(torch.tensor(h["loss"])) for h in result["history"])
    assert result["final_loss"] == result["history"][-1]["loss"]
    assert "mfu" not in result["history"][0]  # no device peak on the CPU
    assert result["eval"]["examples"] == 2


def test_main_raises_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama_train.main(["--size", "tiny", "--steps", "1"])


@pytest.mark.parametrize(
    "flags",
    [["--tp", "2"], ["--sp", "2"], ["--pp", "2"], ["--ring_attention"],
     ["--data_dir", "/nonexistent"]],
)
def test_out_of_slice_flags_raise(flags):
    """--data_dir is ported: a directory that does not exist is the user's
    error.  --tp, --sp and --pp are ported (``tests/test_torch_distributed.py``
    and ``tests/test_torch_pipeline.py`` run them over ranks): on one
    process their mesh does not fit, as the JAX example's would not.
    --ring_attention is ported: on one process there is no sp to ring over,
    and the run is the dense one."""
    argv = ["--size", "tiny", "--steps", "1", "--device", "cpu", *flags]
    if flags == ["--ring_attention"]:
        assert np.isfinite(llama_train.main(argv)["final_loss"])
        return
    exc, match = {"--data_dir": (SystemExit, "none of"), "--pp": (MeshError, "devices"),
                  "--tp": (MeshError, "devices"), "--sp": (MeshError, "devices")}[flags[0]]
    with pytest.raises(exc, match=match):
        llama_train.main(argv)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((REPO / "deeplearning_cfn_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [
        (str(f.relative_to(REPO)), mod)
        for f in files
        for mod in _imported_modules(f)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert offenders == []


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_outside_the_repo(tmp_path, where):
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    res = subprocess.run(
        [sys.executable, str(script)], cwd=script.parent, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
    )
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
