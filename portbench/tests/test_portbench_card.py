"""On the card, at sizes a test can hold (Mistral's widths with 2 blocks;
ResNet-50 at batch 32): the program passes the cells' limits and the fp8
control fails one of them.  Run on the card with
``python -m pytest -m cuda portbench/tests``."""

import time

import pytest

from portbench import control, harness, spec

SEED = 3_400_000_001


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _cut(workload: str):
    bench = spec.load_benchmark()
    cell = spec.workload(bench, workload)
    cfg = spec.load_config(bench, cell["config"])
    tr = spec.load_traffic(cell["traffic"])
    if cfg["family"] == "decoder":
        cfg["num_hidden_layers"] = 2
        tr["global_batch"] = 2
    else:
        tr["global_batch"] = 32
    return cfg, tr


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mistral7b-s4096", "mistral7b-s1024", "resnet50-b256"])
def test_program_passes_and_fp8_control_fails(card, workload):
    cfg, tr = _cut(workload)
    result, lines = harness.run_cell(workload, SEED, 1.0, False, time.time(),
                                     config_override=cfg, traffic_override=tr)
    assert result["correct"], lines
    fp8 = control.control_readings(workload, SEED, ["fp8"], cfg, tr)[-1]["numbers"]
    assert any(v > tr["limits"][k] for k, v in fp8.items()), fp8
