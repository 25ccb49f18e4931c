"""The benchmark is found by name from data alone, and its file keeps to the
contract's shape."""

import importlib.util
import json
import re

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_each_cell_finds_its_files(cell):
    config = spec.load_config(BENCH, cell["config"])
    traffic = spec.load_traffic(cell["traffic"])
    assert hasattr(spec.driver(traffic["driver"]), "run")
    assert set(traffic["limits"]) and all(v > 0 for v in traffic["limits"].values())
    assert config["family"] in ("decoder", "resnet")
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    for key in ("name", "config", "traffic"):
        assert NAME.match(cell[key])


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert len({c["name"] for c in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert len({(c["config"], c["traffic"]) for c in BENCH["workloads"]}) == len(BENCH["workloads"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert sum(c["chips"] == 4 for c in BENCH["workloads"]) <= 1


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_metric_has_a_reader(metric):
    assert callable(spec.reader(metric["name"]).read)


def test_config_files_hold_the_published_sizes():
    mistral = spec.load_config(BENCH, "mistral7b-8of32")
    assert (mistral["hidden_size"], mistral["intermediate_size"], mistral["num_attention_heads"],
            mistral["num_key_value_heads"], mistral["vocab_size"]) == (4096, 14336, 32, 8, 32768)
    assert mistral["head_dim"] * mistral["num_attention_heads"] == mistral["hidden_size"]
    reduced = {c["name"]: c["reduced"] for c in BENCH["configs"]}
    assert reduced["mistral7b-8of32"] == ["num_hidden_layers"]
    assert spec.load_config(BENCH, "resnet50")["stage_sizes"] == [3, 4, 6, 3]


def test_per_layer_metrics_name_cells_that_report_what_they_move():
    cells = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m in spec.metrics_for(BENCH, cell, traced=True)


def test_a_new_metric_file_is_found_without_an_edit(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "new_metric.py").write_text("def read(run):\n    return 1.5\n")
    monkeypatch.setattr(spec, "HERE", tmp_path)
    assert spec.reader("new_metric").read(None) == 1.5


def test_no_module_of_the_benchmark_imports_jax_at_the_top():
    root = spec.HERE
    for path in root.rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax|deeplearning_cfn_tpu)\b(?!_torch)",
                             text, re.M), path
    assert importlib.util.find_spec("portbench.run") is not None


def test_the_references_import_nothing_of_the_program():
    for path in (spec.HERE / "reference").glob("*.py"):
        assert "deeplearning_cfn_tpu" not in path.read_text(), path
