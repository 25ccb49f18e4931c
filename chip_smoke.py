#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of the repository, on a host with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each:

1. env     the card (``nvidia-smi``), torch and CUDA versions; TF32 pinned off.
2. build   every kernel of the port built from ``ops/csrc`` with ``nvcc``,
           one compiler process per source, all started together.
3. kernel  each kernel against its plain PyTorch version on the card, at the
           shapes the main path gives it and at the edge shapes (GQA, ragged
           non-causal, f32), with its time beside the plain version's, the
           one PyTorch library call that computes the same function (timed
           here only as a yardstick; the port never calls it) and the bound.
4. grad    autograd through ``FlashAttention`` (kernel forward + torch
           backward) against autograd through the plain reference.
5. slice   the port's main path: ``examples.llama_train.main`` at the m435
           shape, seq 2048, batch 8, six adamw steps; the launch counters
           are zeroed just before and read just after, and every kernel of
           the path must have launched.  Then one forward with the kernel
           against one with the plain flash forward, on the same weights.
6. learn   six steps on one repeated batch at the same shape must lower the
           loss (the main path's synthetic tokens are uniform over the vocab,
           so its loss starts at the entropy floor and cannot fall); the last
           two steps are profiled by kernel.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``.  Any failed check raises,
and the script exits non-zero without the last line; with no CUDA card, or
outside the repository, it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

STEPS = 6
SLICE_ARGS = [
    "--size", "435m", "--seq_len", "2048", "--global_batch_size", "8",
    "--steps", str(STEPS), "--log_every", "1", "--optimizer", "adamw",
    "--weight_decay", "0.1", "--device", "cuda",
]
# Tolerances, kernel against its plain version on the same inputs:
# bf16 out: both round p to bf16 for p @ v, at different blockings (the
# kernel's running max moves every 64 keys, the reference's every 512), and
# round out to bf16, so they may differ by two bf16 ulps of |out| <= 1.
BF16_OUT_ATOL = 2e-2
# lse and f32 out: f32 sums of up to 2048 terms in another order, and
# another exp/log.
LSE_ATOL = 1e-3
F32_OUT_ATOL = 1e-5
# f32 gradients through the torch backward: the same backward on forwards
# that differ by f32 rounding.
F32_GRAD_ATOL = 1e-4
# Logits of the m435 model, kernel path against the plain flash forward:
# each layer's attention output differs by up to two bf16 ulps, carried
# through 24 residual layers into bf16 logits of magnitude about 1 at random
# init (ulp 2**-7), so a max of 8 ulps and a mean of 1e-2.
LOGITS_MAX_ATOL = 0.0625
LOGITS_MEAN_ATOL = 1e-2


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _attention_work(B, Sq, Sk, Hq, Hkv, D, causal, elt) -> tuple[float, float]:
    """(operations, bytes) one flash forward must do and move: two products
    per valid (query, key) pair, 2*D operations each; q, k, v read once,
    out and lse written once."""
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    flops = 4.0 * B * Hq * D * pairs
    nbytes = elt * (2 * B * Sq * Hq * D + 2 * B * Sk * Hkv * D) + 4 * B * Hq * Sq
    return flops, nbytes


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch.nn.functional as F

    from deeplearning_cfn_tpu_torch.examples import llama_train
    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.ops import _kernels
    from deeplearning_cfn_tpu_torch.ops.flash_attention import (
        FlashAttention,
        flash_attention_reference,
    )
    from deeplearning_cfn_tpu_torch.train.data import SyntheticTokenDataset, device_put_batch
    from deeplearning_cfn_tpu_torch.train.metrics import (
        peak_flops_per_chip,
        peak_hbm_bytes_per_chip,
    )
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    # 1. env
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = peak_flops_per_chip(name), peak_hbm_bytes_per_chip(name)
    _require(peak_flops is not None, f"no peak rates known for {name!r}")
    _emit({"phase": "env", "nvidia_smi": smi, "device": name, "torch": torch.__version__,
           "cuda": torch.version.cuda, "python": sys.version.split()[0],
           "peak_bf16_flops": peak_flops, "peak_hbm_bytes_per_s": peak_bw})

    # 2. build
    sources = ["flash_attn_fwd"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(_kernels.build, sources))
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for lib in libs for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    _emit({"phase": "build", "seconds": build_s, "libraries": [p.name for p in libs],
           "ptxas": ptxas})

    # 3. kernel vs plain, on the card
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(B, S, Hq, Hkv, D, dtype):
        return [torch.randn(B, S, h, D, device="cuda", generator=gen, dtype=torch.float32).to(dtype)
                for h in (Hq, Hkv, Hkv)]

    shapes = {  # name: (B, S, Hq, Hkv, D, causal, dtype)
        "slice": (8, 2048, 8, 8, 128, True, torch.bfloat16),
        "gqa": (1, 2048, 32, 8, 128, True, torch.bfloat16),
        "ragged-full": (2, 1000, 8, 8, 64, False, torch.bfloat16),
        "f32": (1, 300, 4, 2, 64, True, torch.float32),
    }
    kernel_rows = {}
    for label, (B, S, Hq, Hkv, D, causal, dtype) in shapes.items():
        q, k, v = qkv(B, S, Hq, Hkv, D, dtype)
        scale = D**-0.5
        out, lse = _kernels.flash_attn_fwd(q, k, v, causal=causal, sm_scale=scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_reference(q, k, v, causal=causal, sm_scale=scale)
        out_err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        out_tol = BF16_OUT_ATOL if dtype == torch.bfloat16 else F32_OUT_ATOL
        row = {"phase": "kernel", "shape": label, "B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D,
               "causal": causal, "dtype": str(dtype).replace("torch.", ""),
               "out_max_abs_err": out_err, "out_atol": out_tol,
               "lse_max_abs_err": lse_err, "lse_atol": LSE_ATOL,
               "finite": bool(torch.isfinite(out).all())}
        if dtype == torch.bfloat16:
            flops, nbytes = _attention_work(B, S, S, Hq, Hkv, D, causal, q.element_size())
            t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            row.update({
                "kernel_ms": _time_ms(torch, lambda: _kernels.flash_attn_fwd(
                    q, k, v, causal=causal, sm_scale=scale), iters=20),
                "plain_ms": _time_ms(torch, lambda: flash_attention_reference(
                    q, k, v, causal=causal, sm_scale=scale), iters=3, warmup=1),
                "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=Hq != Hkv), iters=20),
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            })
            row["tflops"] = flops / row["kernel_ms"] / 1e9
        _emit(row)
        _require(row["finite"], f"{label}: non-finite kernel output")
        _require(out_err <= out_tol, f"{label}: out error {out_err} > {out_tol}")
        _require(lse_err <= LSE_ATOL, f"{label}: lse error {lse_err} > {LSE_ATOL}")
        kernel_rows[label] = row
        del q, k, v, out, lse, ref_out, ref_lse
    torch.cuda.synchronize()

    # 4. grad: FlashAttention (kernel forward + torch backward) vs the reference's autograd
    B, S, Hq, Hkv, D = 2, 256, 4, 2, 64
    base = qkv(B, S, Hq, Hkv, D, torch.float32)
    w = torch.randn(B, S, Hq, D, device="cuda", generator=gen)
    kq, kk, kv = (x.clone().requires_grad_() for x in base)
    rq, rk, rv = (x.clone().requires_grad_() for x in base)
    (FlashAttention.apply(kq, kk, kv, True, D**-0.5) * w).sum().backward()
    (flash_attention_reference(rq, rk, rv, causal=True)[0] * w).sum().backward()
    grad_err = max((a.grad - b.grad).abs().max().item() for a, b in ((kq, rq), (kk, rk), (kv, rv)))
    _emit({"phase": "grad", "B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D, "dtype": "float32",
           "max_abs_err": grad_err, "atol": F32_GRAD_ATOL})
    _require(grad_err <= F32_GRAD_ATOL, f"grad error {grad_err} > {F32_GRAD_ATOL}")

    # 5. slice: the port's main path, through the entry point a user calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = llama_train.main(SLICE_ARGS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)
    peak_mem = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in result["history"]]
    steady = result["history"][1:]  # the first step includes one-time set-up
    tokens_per_step = 8 * 2048
    tok_s = statistics.median(h["examples_per_sec"] for h in steady)
    cfg = llama.LlamaConfig.m435(seq_len=2048)
    _emit({"phase": "slice", "args": SLICE_ARGS, "losses": losses,
           "step_ms": [tokens_per_step / h["examples_per_sec"] * 1e3 for h in result["history"]],
           "steady_step_ms": tokens_per_step / tok_s * 1e3, "tokens_per_s": tok_s,
           "mfu": statistics.median(h["mfu"] for h in steady),
           "first_step_s": result["first_step_s"], "wall_s": wall_s,
           "max_memory_allocated_bytes": peak_mem, "params": result["params"],
           "launches": launches,
           "flash_launches_per_step": launches["flash_attention_fwd"] / STEPS})
    _require(len(losses) == STEPS and all(math.isfinite(x) for x in losses), "non-finite loss")
    for kname, n in launches.items():
        _require(n > 0, f"kernel {kname} never launched on the main path")
    _require(launches["flash_attention_fwd"] >= cfg.n_layers * STEPS,
             f"flash kernel launched {launches['flash_attention_fwd']} times, "
             f"expected >= {cfg.n_layers} per step")

    # Same weights as the trainer started from (seed 0), one forward each way.
    model = llama.init_model(cfg, seed=0, device="cuda")
    tokens = torch.from_numpy(
        next(SyntheticTokenDataset(seq_len=2048, vocab_size=cfg.vocab_size, batch_size=2).batches(1)).x
    ).cuda()
    with torch.no_grad():
        logits_kernel = llama.forward(model, tokens)
        with llama.force_attention_kind("flash_reference"):
            logits_plain = llama.forward(model, tokens)
    diff = (logits_kernel - logits_plain).abs()
    logits_row = {"phase": "logits", "B": 2, "S": 2048, "max_abs_err": diff.max().item(),
                  "mean_abs_err": diff.mean().item(), "max_atol": LOGITS_MAX_ATOL,
                  "mean_atol": LOGITS_MEAN_ATOL, "logits_max_abs": logits_plain.abs().max().item(),
                  "finite": bool(torch.isfinite(logits_kernel).all())}
    _emit(logits_row)
    _require(logits_row["finite"], "non-finite logits")
    _require(logits_row["max_abs_err"] <= LOGITS_MAX_ATOL, "logits max error")
    _require(logits_row["mean_abs_err"] <= LOGITS_MEAN_ATOL, "logits mean error")
    del model, logits_kernel, logits_plain, diff

    # 6. learn: the synthetic tokens are uniform over the vocab, so the main
    # path's loss starts at the entropy floor ln(32000) = 10.373 and cannot
    # fall.  Learning is checked by overfitting one batch at the same shape
    # through the same trainer; its last two steps are profiled.
    trainer = llama.make_trainer(cfg, TrainerConfig(
        optimizer="adamw", learning_rate=3e-4, weight_decay=0.1, grad_clip_norm=1.0,
        strategy="fsdp", log_every=1), device="cuda")
    state = trainer.init(seed=0)
    batch = next(SyntheticTokenDataset(seq_len=2048, vocab_size=cfg.vocab_size, batch_size=8).batches(1))
    x, y = device_put_batch(batch, torch.device("cuda"))
    fit_losses = []
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
    for step in range(STEPS):
        if step == STEPS - 2:
            torch.cuda.synchronize()
            prof.start()
            t_prof = time.perf_counter()
        state, metrics = trainer.train_step(state, x, y)
        fit_losses.append(metrics["loss"])
    torch.cuda.synchronize()
    prof_wall_ms = (time.perf_counter() - t_prof) * 1e3 / 2
    prof.stop()
    fit_losses = torch.stack(fit_losses).tolist()
    _emit({"phase": "learn", "losses": fit_losses})
    _require(all(math.isfinite(v) for v in fit_losses), "non-finite loss on one batch")
    _require(fit_losses[-1] < fit_losses[0], f"loss on one repeated batch did not fall: {fit_losses}")
    kernels = [(e.key, e.self_device_time_total / 1e3 / 2, e.count // 2)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda r: -r[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    _emit({"phase": "profile", "steps": 2, "wall_ms_per_step": prof_wall_ms,
           "device_ms_per_step": device_ms,
           "idle_share": 1 - device_ms / prof_wall_ms if device_ms else None,
           "top": [{"name": n[:120], "ms_per_step": ms, "calls_per_step": c}
                   for n, ms, c in kernels[:25]]})
    del state, trainer, x, y

    slice_row = kernel_rows["slice"]
    _emit({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "deeplearning_cfn_tpu_torch/ops/csrc/flash_attn_fwd.cu",
        "replaces": "deeplearning_cfn_tpu/ops/pallas_attention.py:222",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": max(r["out_max_abs_err"] for r in kernel_rows.values()),
        "ms": slice_row["kernel_ms"],
        "kernel_ms": slice_row["kernel_ms"],
        "plain_ms": slice_row["plain_ms"],
        "bound_ms": slice_row["bound_ms"],
        "bound_by": slice_row["bound_by"],
        "library_ms": slice_row["library_ms"],
    }]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                   "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
