"""One run of one cell: find its files by name, drive the program on the
card(s), read the metrics, decide ``correct``, and say so.

``run_cell`` returns the result line's object and the lines of the checks.
A cell on several chips runs one process a card (``spawn``), joined by a
TCP store on localhost; rank 0 checks against the reference and reads the
profile; the parent merges what the ranks report."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import socket
import statistics
import subprocess
import sys

from portbench import compare, spec
from portbench.record import Run

FORBIDDEN = {"jax", "jaxlib", "flax", "deeplearning_cfn_tpu"}
PROGRAM = "deeplearning_cfn_tpu_torch"


class CannotRun(RuntimeError):
    """The run cannot start: fewer cards than its cell asks for, or no
    program in the checkout."""


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that a run may not load, compared
    whole (``deeplearning_cfn_tpu_torch`` is the program, not the JAX package)."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def _probes(metrics: list[dict]):
    modules = [spec.reader(m["name"]) for m in metrics]

    def probe(run: Run, handles: dict) -> None:
        for module in modules:
            if hasattr(module, "probe"):
                module.probe(run, handles)

    return probe


def _device(rank: int, cpu: bool):
    import torch

    if cpu:
        return torch.device("cpu")
    torch.cuda.set_device(rank)
    return torch.device("cuda", rank)


def _one_rank(run: Run, metrics: list[dict], cpu: bool) -> Run:
    from portbench import plants

    run.device = _device(run.rank, cpu)
    if run.trace:
        run.probe_fn = _probes(metrics)
    with plants.planted(run.plant):
        spec.driver(run.traffic["driver"]).run(run)
    run.forbidden = forbidden_modules()
    return run


def _portable(run: Run) -> dict:
    d = {f.name: getattr(run, f.name) for f in dataclasses.fields(run)
         if f.name not in ("device", "probe_fn")}
    d["forbidden"] = getattr(run, "forbidden", [])
    if run.device is not None and run.device.type == "cuda":
        import torch

        d["kind"] = torch.cuda.get_device_name(run.device)
    return d


def _worker(rank: int, world: int, port: int, run: Run, metrics: list[dict], queue,
            cpu: bool) -> None:
    import torch
    import torch.distributed as dist

    try:
        init = f"tcp://127.0.0.1:{port}"
        if cpu:
            dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
        else:
            torch.cuda.set_device(rank)
            dist.init_process_group("nccl", init_method=init, world_size=world, rank=rank,
                                    device_id=torch.device("cuda", rank))
        run.rank = rank
        queue.put(("ok", rank, _portable(_one_rank(run, metrics, cpu))))
    except BaseException as e:  # reported to the parent, which fails the run
        import traceback

        queue.put(("error", rank, traceback.format_exc()))
        if not isinstance(e, Exception):
            raise
    finally:
        import gc

        gc.collect()  # a captured graph holding NCCL work blocks the group's teardown
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _many_ranks(run: Run, metrics: list[dict], cpu: bool) -> list[dict]:
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, run.world, port, run, metrics, queue, cpu))
             for r in range(run.world)]
    for p in procs:
        p.start()
    got: dict[int, dict] = {}
    errors = []
    try:
        while len(got) + len(errors) < run.world:
            status, rank, payload = queue.get(timeout=1500)
            if status == "ok":
                got[rank] = payload
            else:
                errors.append(f"rank {rank}:\n{payload}")
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [got[r] for r in range(run.world)]


def program_in_checkout(root=spec.ROOT) -> None:
    """The program under test is the checkout's own: a copy installed
    elsewhere, or none, fails the run before it starts."""
    import importlib.util
    from pathlib import Path

    found = importlib.util.find_spec(PROGRAM)
    if found is None or not Path(found.origin).resolve().is_relative_to(Path(root).resolve()):
        raise CannotRun(f"the checkout at {root} holds no {PROGRAM} package"
                       + (f" (one is installed at {found.origin})" if found else ""))


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t0_wall: float,
             cpu: bool = False, root=spec.ROOT, config_override: dict | None = None,
             traffic_override: dict | None = None,
             plant: str | None = None) -> tuple[dict, list[str]]:
    """The result object and the checks' lines.  For tests only, which the
    command line cannot reach: ``cpu`` runs on the CPU (several ranks on
    gloo), ``config_override`` and ``traffic_override`` stand in for the
    cell's files, and ``plant`` plants a fault of ``plants.py``."""
    program_in_checkout(root)
    bench = spec.load_benchmark(root)
    cell = spec.workload(bench, workload)
    config = config_override or spec.load_config(bench, cell["config"], root)
    traffic = traffic_override or spec.load_traffic(cell["traffic"])
    chips = int(cell["chips"])
    if not cpu:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise CannotRun(f"{workload} needs {chips} CUDA card(s); this host has "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    metrics = spec.metrics_for(bench, workload, trace)
    run = Run(cell=cell, config=config, traffic=traffic, seed=seed, seconds=seconds,
              trace=trace, world=chips, t0_wall=t0_wall, plant=plant)
    if chips == 1:
        ranks = [_portable(_one_rank(run, metrics, cpu))]
    else:
        ranks = _many_ranks(run, metrics, cpu)
    merged = _merge(ranks)
    found = sorted(set(forbidden_modules()).union(*(r["forbidden"] for r in ranks)))
    if found:
        raise RuntimeError(f"the run loaded modules it may not: {found}")
    return _result(merged, ranks, metrics, cpu)


def _merge(ranks: list[dict]) -> Run:
    first = dict(ranks[0])
    peaks = [r["peak_bytes"] for r in ranks if r["peak_bytes"] is not None]
    first["peak_bytes"] = max(peaks) if peaks else None
    first["busy_s"] = [r["profile"]["busy_s"] for r in ranks if r["profile"] is not None]
    kind = first.pop("kind", None)
    first.pop("forbidden", None)
    run = Run(**first)
    run.notes["kind"] = kind
    return run


def _result(run: Run, ranks: list[dict], metrics: list[dict], cpu: bool) -> tuple[dict, list[str]]:
    values = {}
    for m in metrics:
        v = spec.reader(m["name"]).read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = (compare.within(run.checks) and run.window_failed == 0 and run.window_steps > 0
               and bool(run.checks))
    device = {"platform": "cpu" if cpu else "gpu", "kind": run.notes.get("kind") or "cpu",
              "count": run.world, "memory_peak_bytes": run.peak_bytes or 0}
    if not cpu:
        device["power_limit"] = _power_limit()
    if run.trace and run.profile is not None:
        device["busy_s"] = statistics.fmean(run.busy_s)
        device["window_s"] = run.profile["window_s"]
    result = {"correct": correct, "attempted": run.window_steps, "failed": run.window_failed,
              "metrics": values, "device": device}
    if run.trace and run.profile is not None:
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    result["checks"] = {name: {"value": v if math.isfinite(v) else str(v), "limit": limit}
                        for name, v, limit in run.checks}
    notes = {k: v for k, v in run.notes.items() if k != "kind"}
    lines = [f"notes {json.dumps(notes, default=str)}"]
    lines += [f"{name} {v!r} limit {limit!r}" for name, v, limit in run.checks]
    return result, lines
