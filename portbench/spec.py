"""``BENCHMARK.json`` and the files it names, found by name alone."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def config_path(bench: dict, name: str, root: Path = ROOT) -> Path:
    for c in bench["configs"]:
        if c["name"] == name:
            return root / c["file"]
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    return json.loads(config_path(bench, name, root).read_text())


def load_traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def metrics_for(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced.  A metric with ``workloads`` is reported in
    those cells; a per-layer one without, in every cell that reports the
    end-to-end metric it ``moves``."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def _module(folder: str, name: str):
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder[:-1]} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"portbench.{folder}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The module ``metrics/<metric>.py``: its ``read(run)``, and an
    optional ``probe(run)`` made while the program is alive."""
    return _module("metrics", metric)


def driver(name: str):
    """The module ``drivers/<name>.py`` that a traffic mix names."""
    return _module("drivers", name)
