"""The readings that the limits of ``correct`` are set from, at a cell's own
size, on the card.  Not run by the benchmark's own runs.

    python -m portbench.control --workload <name> --program-seeds 1,2,3 \\
        --control-seeds 4,5,6 --variants fp8,half [--seconds 1]

``--program-seeds``: whole runs of the cell (a short window) in this
process, one after another: the program's numbers, the lower readings.
``--control-seeds``: the f32 reference, then each variant in the
program's place, read as the program's numbers are: ``fp8`` (the
control: every product's operands in fp8), ``half`` (half the batch left
out, the mean over the rest), ``alone`` (rank 0's share of the global
batch alone, its BatchNorm local: the exchange between chips left out).
One JSON line a reading."""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import harness, spec, traffic
from portbench.record import Run


def _rows(variant: str, batch: int, world: int):
    if variant == "half":
        return slice(0, batch // 2)
    if variant == "alone":
        return slice(0, batch // world)
    return None


def control_readings(workload: str, seed: int, variants: list[str],
                     config: dict | None = None, traffic_mix: dict | None = None) -> list[dict]:
    """The reference's readings, then each variant's numbers against them,
    on card 0 (``config``/``traffic_mix`` in place of the cell's files: the
    card's tests, at a size a test can hold)."""
    import torch

    bench = spec.load_benchmark()
    cell = spec.workload(bench, workload)
    run = Run(cell=cell, config=config or spec.load_config(bench, cell["config"]),
              traffic=traffic_mix or spec.load_traffic(cell["traffic"]), seed=seed, seconds=0,
              trace=False, world=int(cell["chips"]), device=torch.device("cuda", 0))
    drv = spec.driver(run.traffic["driver"])
    pool = traffic.pool_for(run.traffic, run.config, seed)
    t = time.time()
    reference = drv.reference_readings(run, pool)
    out = [{"what": "reference", "seed": seed, "seconds": time.time() - t,
            "losses": reference["losses"]}]
    for variant in variants:
        t = time.time()
        reading = drv.reference_readings(
            run, pool, precision="fp8" if variant == "fp8" else "f32",
            rows=_rows(variant, run.traffic["global_batch"], run.world))
        values, notes = drv.numbers(reading, reference)
        out.append({"what": variant, "seed": seed, "seconds": time.time() - t,
                    "numbers": dict(values), "worst_leaves": notes["worst_leaves"]})
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--variants", default="fp8,half")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    for s in filter(None, args.program_seeds.split(",")):
        result, lines = harness.run_cell(args.workload, int(s), args.seconds, False, time.time())
        print(json.dumps({"what": "program", "seed": int(s), "numbers": {
            k: v["value"] for k, v in result["checks"].items()},
            "metrics": result["metrics"], "notes": lines[0]}), flush=True)
    for s in filter(None, args.control_seeds.split(",")):
        for line in control_readings(args.workload, int(s), args.variants.split(",")):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
