"""``llama_train``'s model-parallel layouts over NCCL, one process a card.

Each layout runs ``examples.llama_train`` as one process a rank with the
cluster contract's environment (``DEEPLEARNING_WORKERS_COUNT``,
``DLCFN_PROCESS_ID``, ``DEEPLEARNING_COORDINATOR``): on the card the entry
point joins an NCCL group and puts process ``i`` on ``cuda:i``.  Its losses
are held against one process's run of the same flags without the layout, on
the same stream, to ``RTOL`` (the tiny preset is bf16; the CPU tests hold
the same flag cases to the same limit).  The layouts are the ones whose
point-to-point or collectives differ from the data-parallel path: GPipe
(``--pp``, its activations and gradients over ``parallel/p2p.py``, straight
through on NCCL), ring attention's exchange, MoE under tp and sp, sp inside
the stages, tp beyond the kv heads.

One JSON row a layout (its ranks' losses, the reference's, the largest
relative difference, seconds), then a summary row; exit 1 if a layout fails
or disagrees.  Needs as many cards as the widest layout's ranks (4):
``python -m deeplearning_cfn_tpu_torch.tools.nccl_layouts``.  With
``--device cpu`` the same runs go over gloo on the CPU (a rehearsal).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

RTOL = 2e-2
BASE = ["--size", "tiny", "--seq_len", "256", "--global_batch_size", "4", "--steps", "3",
        "--log_every", "1"]
LAYOUTS = {  # name: (ranks, flags, the one-process run's flags)
    "pp2": (2, ["--pp", "2"], []),
    "pp2_remat": (2, ["--pp", "2", "--remat"], ["--remat"]),
    "sp2_ring": (2, ["--sp", "2", "--ring_attention"], []),
    "moe_tp2": (2, ["--experts", "4", "--tp", "2"], ["--experts", "4"]),
    "moe_sp2": (2, ["--experts", "4", "--sp", "2"], ["--experts", "4"]),
    "sp2_pp2": (4, ["--sp", "2", "--pp", "2"], []),
    "tp4_kv2": (4, ["--tp", "4"], []),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(argv: list[str]) -> None:
    from deeplearning_cfn_tpu_torch.examples import llama_train

    out = llama_train.main(argv)
    print("RESULT " + json.dumps({"losses": [h["loss"] for h in out["history"]],
                                  "mesh": out["mesh"], "device": out["device"],
                                  "kernel_launches": out["kernel_launches"]}), flush=True)


def _run(n: int, argv: list[str], timeout: float) -> list[dict]:
    """``argv`` as ``n`` rank processes; each rank's result."""
    port = _free_port()
    procs = []
    for i in range(n):
        env = dict(os.environ, DEEPLEARNING_WORKERS_COUNT=str(n), DLCFN_PROCESS_ID=str(i),
                   DEEPLEARNING_COORDINATOR=f"127.0.0.1:{port}")
        if n == 1:  # one process: no cluster
            for key in ("DEEPLEARNING_WORKERS_COUNT", "DLCFN_PROCESS_ID",
                        "DEEPLEARNING_COORDINATOR"):
                env.pop(key)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deeplearning_cfn_tpu_torch.tools.nccl_layouts", "--worker",
             "--", *argv], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results, errors = [], []
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            rows = [line[7:] for line in out.splitlines() if line.startswith("RESULT ")]
            if p.returncode or not rows:
                errors.append(f"rank {i} exit {p.returncode}: {err[-2000:]}")
            else:
                results.append(json.loads(rows[-1]))
    except subprocess.TimeoutExpired:
        errors.append(f"timed out after {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors:
        raise RuntimeError("; ".join(errors))
    return results


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--layout", action="append", choices=sorted(LAYOUTS),
                   help="run only these (default: every layout)")
    p.add_argument("--timeout", type=float, default=300.0, help="seconds a run")
    args = p.parse_args(argv)
    base = BASE + ["--device", args.device]
    refs: dict[tuple, list[float]] = {}
    ok = True
    for name in args.layout or LAYOUTS:
        n, flags, ref_flags = LAYOUTS[name]
        t0 = time.perf_counter()
        row = {"layout": name, "ranks": n, "flags": flags, "backend":
               "nccl" if args.device == "cuda" else "gloo"}
        try:
            if tuple(ref_flags) not in refs:
                refs[tuple(ref_flags)] = _run(1, base + ref_flags, args.timeout)[0]["losses"]
            ref = refs[tuple(ref_flags)]
            ranks = _run(n, base + flags, args.timeout)
            losses = ranks[0]["losses"]
            diff = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
            agree = all(r["losses"] == losses for r in ranks)
            row.update(losses=losses, ref_losses=ref, max_rel_loss_diff=diff,
                       ranks_agree=agree, mesh=ranks[0]["mesh"],
                       devices=[r["device"] for r in ranks],
                       kernel_launches=[r["kernel_launches"] for r in ranks],
                       passed=agree and len(losses) == len(ref) and diff <= RTOL)
        except RuntimeError as e:
            row.update(passed=False, error=str(e))
        row["seconds"] = time.perf_counter() - t0
        ok &= row["passed"]
        print(json.dumps(row), flush=True)
    print(json.dumps({"layouts": len(args.layout or LAYOUTS), "passed": ok, "rtol": RTOL}))
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        _worker(sys.argv[3:] if sys.argv[2:3] == ["--"] else sys.argv[2:])
    else:
        sys.exit(main())
