#!/usr/bin/env python3
"""Training step time of two checkouts of the port, side by side on one card.

From the root of the repository, with a second checkout unpacked under an
ignored directory (``git archive <commit> | tar -x -C build/parent``)::

    python3 deeplearning_cfn_tpu_torch/tools/step_ab.py \\
        --root build/parent --root . --order 0110

Each run is a fresh Python process that imports ``deeplearning_cfn_tpu_torch``
from its root (its kernels built there, from its own sources) and drives the
two training entry points with the flags a user would pass:
``examples.bert_pretrain`` (BERT-base, seq 128, batch 32, ``--use_pallas_mlp``,
40 adamw steps) and ``examples.llama_train`` (m435, seq 2048, batch 8, six
adamw steps).  The runs go in the order given (``0110``: the first root, the
second twice, the first again), so that drift of the card or the host over
the call falls on both alike.  Each run prints one JSON line: the root, the
card (``nvidia-smi`` name and power limit), and for each path the median
step time over steps 2.. (step 1 carries one-time set-up) and every step's
time.  Steps are timed on the host's clock, as the entry points report them.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

BERT_ARGS = ["--seq_len", "128", "--global_batch_size", "32", "--steps", "40",
             "--log_every", "1", "--device", "cuda", "--use_pallas_mlp"]
LLAMA_ARGS = ["--size", "435m", "--seq_len", "2048", "--global_batch_size", "8",
              "--steps", "6", "--log_every", "1", "--optimizer", "adamw",
              "--weight_decay", "0.1", "--device", "cuda"]


def _steps(result: dict, per_step: int) -> dict:
    """``per_step``: what the entry point's rate counts in a step (BERT:
    sequences; Llama: tokens)."""
    step_ms = [per_step / h["examples_per_sec"] * 1e3 for h in result["history"]]
    return {"median_step_ms": statistics.median(step_ms[1:]), "step_ms": step_ms}


def child(root: str) -> None:
    """One run: import the port from ``root`` and drive both entry points."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import deeplearning_cfn_tpu_torch
    from deeplearning_cfn_tpu_torch.examples import bert_pretrain, llama_train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    row = {"root": root, "package": deeplearning_cfn_tpu_torch.__file__, "nvidia_smi": smi,
           "bert": _steps(bert_pretrain.main(BERT_ARGS), 32),
           "llama": _steps(llama_train.main(LLAMA_ARGS), 8 * 2048)}
    torch.cuda.synchronize()
    print("STEP_AB " + json.dumps(row), flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", action="append", required=True,
                   help="a checkout's root; give it once for each checkout (two at most)")
    p.add_argument("--order", default="0110", help="which root each run takes, by index")
    p.add_argument("--child", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        child(args.child)
        return 0
    rows = []
    for i in args.order:
        root = args.root[int(i)]
        res = subprocess.run([sys.executable, __file__, "--root", root, "--child", root],
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("STEP_AB ")]
        if res.returncode != 0 or not lines:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"run on {root} failed with exit code {res.returncode}")
        rows.append(json.loads(lines[-1][len("STEP_AB "):]))
        print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for i, root in enumerate(args.root):
        mine = [r for r, k in zip(rows, args.order) if int(k) == i]
        summary[root] = {path: [r[path]["median_step_ms"] for r in mine]
                         for path in ("bert", "llama")}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
