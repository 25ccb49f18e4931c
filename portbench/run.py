"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, when the checkout holds no program,
when the host has fewer CUDA cards than the cell asks for, when the run
fails, or when it loaded JAX or the JAX package.  The last lines on standard error are the numbers compared, each
beside its limit; the last line on standard output is the result."""

import time

T0_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / ".cache"


def _fixed_caches() -> None:
    """Every kernel cache in a fixed directory inside the checkout (the
    port's own builds go to ``build/torch_kernels/`` there)."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _fixed_caches()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import harness

    try:
        result, checks = harness.run_cell(args.workload, args.seed, args.seconds,
                                          bool(args.trace), T0_WALL)
    except harness.CannotRun as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    for line in checks:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
