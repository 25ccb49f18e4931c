#!/usr/bin/env python3
"""Time the fused-dense kernels of several source trees, in turns, on one card.

From the root of the repository, with other versions of ``ops/csrc`` copied
under an ignored directory::

    python3 deeplearning_cfn_tpu_torch/tools/kernel_ab.py \\
        --csrc build/ab/old/csrc --csrc deeplearning_cfn_tpu_torch/ops/csrc --order 0110

Each tree's ``fused_dense.cu`` is built (at its own hash, so the libraries do
not collide) and loaded once; then the runs go in the order given, each
swapping its tree's library in behind the wrappers of ``ops/_kernels.py``, so
that drift of the card over the call falls on every tree alike.  A run times,
at BERT-base's ``mlp_in`` (M 4096, K 768, N 3072, gelu), the int8-weight
kernel with a bf16 and with an f32 x, the bf16 fused dense, and the f32
fused dense there and at the ResNet-50 head (M 128, K 2048, N 1000), by CUDA
events over back-to-back calls (the median of ``--reps`` timings of
``--iters`` calls; where a call is shorter than the host's time to issue
it, events measure the host) and by device time (``torch.profiler``), and
checks each against its plain version.  One JSON
line a run and shape, then the card (``nvidia-smi`` name, power limit, SM
clock and power draw at the end) and a summary of the times by tree.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

M, K, N = 4096, 768, 3072
HEAD_M, HEAD_K, HEAD_N = 128, 2048, 1000
F32_TOL = (1e-5, 1e-5)  # chip_smoke.py's DENSE_TOL["float32"]
QUANT_F32_TOL = (1e-5, 1e-5)  # chip_smoke.py's QUANT_TOL["float32"]


def _events_ms(torch, fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--csrc", action="append", required=True,
                   help="a copy of ops/csrc; give it once for each tree")
    p.add_argument("--order", default="0110", help="which tree each run takes, by index")
    p.add_argument("--iters", type=int, default=50, help="calls a timing")
    p.add_argument("--reps", type=int, default=5, help="timings a run; the median is kept")
    p.add_argument("--case", action="append", default=[],
                   help="time only this case (give it once for each); all by default")
    p.add_argument("--unchecked", action="append", default=[],
                   help="index of a tree that is timed without the tolerance check "
                        "(a diagnostic copy that skips part of the work)")
    args = p.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    from chip_smoke import _device_ms

    from deeplearning_cfn_tpu_torch.ops import _kernels
    from deeplearning_cfn_tpu_torch.ops import fused_dense as fd
    from deeplearning_cfn_tpu_torch.ops.quant import quantize_weight

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device; this tool runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = []
    for csrc in args.csrc:
        _kernels.CSRC = Path(csrc).resolve()
        _kernels._libs.clear()
        libs.append(_kernels._load("fused_dense"))

    gen = torch.Generator(device="cuda").manual_seed(0)
    x32 = torch.randn(M, K, device="cuda", generator=gen)
    w = torch.randn(K, N, device="cuda", generator=gen) / K**0.5
    b32 = 0.1 * torch.randn(N, device="cuda", generator=gen)
    wq, scale = quantize_weight(w)
    x16, b16, w16 = x32.bfloat16(), b32.bfloat16(), w.bfloat16()
    xh = torch.randn(HEAD_M, HEAD_K, device="cuda", generator=gen)
    wh = torch.randn(HEAD_K, HEAD_N, device="cuda", generator=gen) / HEAD_K**0.5
    bh = 0.1 * torch.randn(HEAD_N, device="cuda", generator=gen)
    cases = {  # name: (call, plain version, (rtol, atol))
        "quant_bf16x": (lambda: _kernels.fused_dense_quantized(x16, wq, scale, b16, activation="gelu"),
                        lambda: fd._quant_reference(x16, wq, scale, b16, "gelu", torch.bfloat16),
                        (2**-7, 1e-5)),
        "quant_f32x": (lambda: _kernels.fused_dense_quantized(x32, wq, scale, b32, activation="gelu"),
                       lambda: fd._quant_reference(x32, wq, scale, b32, "gelu", torch.float32),
                       QUANT_F32_TOL),
        "dense_bf16": (lambda: _kernels.fused_dense(x16, w16, b16, activation="gelu"),
                       lambda: fd.fused_dense_reference(x16, w16, b16, "gelu"), (2**-7, 1e-5)),
        "dense_f32": (lambda: _kernels.fused_dense(x32, w, b32, activation="gelu"),
                      lambda: fd.fused_dense_reference(x32, w, b32, "gelu"), F32_TOL),
        "dense_f32_head": (lambda: _kernels.fused_dense(xh, wh, bh, activation=None),
                           lambda: fd.fused_dense_reference(xh, wh, bh, None), F32_TOL),
    }
    if args.case:
        cases = {name: cases[name] for name in args.case}
    refs = {name: plain() for name, (_, plain, _) in cases.items()}
    times: dict[str, dict[str, list[float]]] = {c: {n: [] for n in cases} for c in args.csrc}
    device_times: dict[str, dict[str, list[float]]] = {c: {n: [] for n in cases} for c in args.csrc}
    for i in args.order:
        csrc = args.csrc[int(i)]
        _kernels._libs["fused_dense"] = libs[int(i)]
        for name, (call, _, (rtol, atol)) in cases.items():
            _kernels.reset_launch_counts()
            got = call()
            torch.cuda.synchronize()
            variant = [k for k in _kernels.launch_counts if "/" in k]
            err = (got.float() - refs[name].float()).abs()
            within = bool((err <= atol + rtol * refs[name].float().abs()).all())
            reps = [_events_ms(torch, call, args.iters) for _ in range(args.reps)]
            ms = statistics.median(reps)
            device_ms = _device_ms(torch, call, args.iters)
            times[csrc][name].append(ms)
            device_times[csrc][name].append(device_ms)
            print(json.dumps({"csrc": csrc, "case": name, "variant": variant, "ms": ms,
                              "reps_ms": reps, "device_ms": device_ms,
                              "max_abs_err": err.max().item(),
                              "within_tolerance": within}), flush=True)
            if not within and i not in args.unchecked:
                raise SystemExit(f"{csrc} {name}: outside tolerance")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "summary": times, "device_summary": device_times}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
