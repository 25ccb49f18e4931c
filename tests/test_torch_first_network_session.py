"""The port's first-network session
(``deeplearning_cfn_tpu_torch/scripts/first-network-session.sh``) on
fixture data in the exact layouts the downloads produce
(``DLCFN_FNS_SRC``), on the CPU (``DLCFN_FNS_DEVICE=cpu``, the
counterpart of the ``JAX_PLATFORMS=cpu`` that JAX's test sets):

- CIFAR and MNIST: both conversions and the CIFAR stage (VGG-11 to a
  reachable target with a held-out eval), the summary's keys and counts;
- (slow) the JAX test's four datasets with its assertions on
  ``summary.json``, and every summary key the JAX script writes;
- the fixture writers (``scripts/fns_fixtures.py``) write what the JAX
  package's test writers write, from the same seeds.
"""

import gzip
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from deeplearning_cfn_tpu_torch.scripts import fns_fixtures

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "deeplearning_cfn_tpu_torch" / "scripts" / "first-network-session.sh"


def _run(tmp_path, datasets):
    src = fns_fixtures.write_sources(tmp_path / "src", datasets.split())
    env = dict(os.environ, DLCFN_FNS_SRC=str(src), DLCFN_FNS_WORK=str(tmp_path / "work"),
               DLCFN_FNS_DATASETS=datasets, DLCFN_FNS_DEVICE="cpu", PYTHON=sys.executable,
               OMP_NUM_THREADS="2", **fns_fixtures.SMOKE_ENV)
    proc = subprocess.run(["bash", str(SCRIPT), str(tmp_path / "work")], env=env,
                          capture_output=True, text=True, timeout=900, cwd=tmp_path)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr[-5000:]}"
    return json.loads((tmp_path / "work" / "summary.json").read_text())


def test_cifar_and_mnist_convert_and_cifar_trains_with_a_heldout_eval(tmp_path):
    summary = _run(tmp_path, "cifar mnist")
    assert sorted(summary) == ["cifar", "convert_cifar", "convert_mnist"]
    assert summary["convert_cifar"]["records"]["train"] == 128
    assert summary["convert_mnist"]["records"]["train"] == 32
    assert summary["cifar"]["steps"] >= 1
    assert "accuracy" in summary["cifar"]["eval"]
    assert summary["cifar"]["device"] == "cpu"


def _jax_summary_keys() -> set[str]:
    """Every key the JAX script records into ``summary.json``."""
    text = (REPO / "scripts" / "first-network-session.sh").read_text()
    return set(re.findall(r"^\s*record (\w+) ", text, re.M))


@pytest.mark.slow
def test_script_runs_all_stages_on_fixture_data(tmp_path):
    summary = _run(tmp_path, "cifar mnist coco imagenet")
    assert set(summary) == _jax_summary_keys()
    # The JAX test's assertions (tests/test_first_network_script.py).
    assert summary["convert_cifar"]["records"]["train"] == 128
    assert summary["convert_mnist"]["records"]["train"] == 32
    assert summary["convert_coco_train"]["records"]["train"] == 9
    assert summary["convert_coco_val"]["records"]["val"] == 3
    assert summary["cifar"]["steps"] >= 1
    assert "accuracy" in summary["cifar"]["eval"]
    assert summary["coco"]["steps"] == 2
    assert "map50" in summary["coco"]["eval"] or "mAP" in str(summary["coco"]["eval"])
    assert summary["convert_imagenet_train"]["stored_px"] == 40
    assert summary["convert_imagenet_val"]["stored_px"] == 32
    assert summary["imagenet"]["steps"] == 2
    assert summary["imagenet"]["target_reached"] is False
    assert "accuracy" in summary["imagenet"]["eval"]


def _tree(root: Path) -> dict:
    """Every file under ``root`` by relative path, gzip's content unpacked
    (its header carries a time)."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            data = p.read_bytes()
            out[str(p.relative_to(root))] = gzip.decompress(data) if p.suffix == ".gz" else data
    return out


def test_the_fixture_writers_write_the_jax_tests_bytes(tmp_path):
    try:
        from tests import test_datasets as jax_writers
    except ImportError:
        pytest.skip("needs the JAX package's tests, the reference")
    jax_writers.write_cifar10_fixture(tmp_path / "jax" / "cifar", n_per_batch=64, n_batches=2)
    jax_writers.write_mnist_fixture(tmp_path / "jax" / "mnist", n=32)
    jax_writers.write_imagefolder_fixture(tmp_path / "jax" / "in", per_class=4, seed=7)
    jax_writers.write_coco_fixture(tmp_path / "jax" / "coco", n_images=12)
    fns_fixtures.write_cifar10_fixture(tmp_path / "port" / "cifar", n_per_batch=64, n_batches=2)
    fns_fixtures.write_mnist_fixture(tmp_path / "port" / "mnist", n=32)
    fns_fixtures.write_imagefolder_fixture(tmp_path / "port" / "in", per_class=4, seed=7)
    fns_fixtures.write_coco_fixture(tmp_path / "port" / "coco", n_images=12)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
