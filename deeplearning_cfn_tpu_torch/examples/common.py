"""Shared plumbing for the port's example trainers — the parts of
``deeplearning_cfn_tpu/examples/common.py`` that ``llama_train`` reads."""

from __future__ import annotations

import argparse
import os
import time

from deeplearning_cfn_tpu_torch.train.schedules import build_schedule


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--global_batch_size", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--strategy", choices=["dp", "fsdp"], default="dp")
    p.add_argument("--checkpoint_dir", default=os.environ.get("DLCFN_CHECKPOINT_DIR"))
    p.add_argument(
        "--data_dir",
        default=os.environ.get("DLCFN_DATA_DIR"),
        help="colon-separated candidate dirs of DLC1 record files; unset = synthetic data",
    )
    p.add_argument(
        "--lr_schedule", choices=["constant", "cosine", "step"], default="constant",
        help="LR schedule over --steps: warmup+cosine decay, or stepped decay",
    )
    p.add_argument(
        "--warmup_steps", type=int, default=None,
        help="linear LR warmup steps (default: 5%% of --steps capped at 1000 "
             "for cosine, 0 for step)",
    )
    p.add_argument(
        "--lr_boundaries", default=None,
        help="comma-separated step indices for --lr_schedule step "
             "(default: 50%%,75%%,90%% of --steps)",
    )
    p.add_argument(
        "--lr_decay_factor", type=float, default=0.1,
        help="multiplier applied at each step-schedule boundary",
    )
    p.add_argument(
        "--weight_decay", type=float, default=None,
        help="weight decay (None = the example's default); norm scales and "
             "biases are never decayed",
    )
    p.add_argument(
        "--grad_accum", type=int, default=1,
        help="microbatches per optimizer update",
    )
    p.add_argument(
        "--metrics_dir",
        default=os.environ.get("DLCFN_METRICS_DIR"),
        help="dir for structured per-worker JSONL metrics",
    )
    return p


def make_lr_schedule(args, base_lr: float, total_steps: int | None = None):
    """--lr_schedule/--warmup_steps/--lr_boundaries/--lr_decay_factor -> a
    ``step -> lr`` schedule for ``TrainerConfig.lr_schedule`` (None = constant)."""
    boundaries = None
    if getattr(args, "lr_boundaries", None):
        boundaries = [int(b) for b in str(args.lr_boundaries).split(",") if b]
    return build_schedule(
        getattr(args, "lr_schedule", "constant"),
        base_lr,
        total_steps or args.steps,
        warmup_steps=getattr(args, "warmup_steps", None),
        boundaries=boundaries,
        decay_factor=getattr(args, "lr_decay_factor", 0.1),
    )


def first_step_clock(trainer=None, t0: float | None = None):
    """Call with no args at entry for the start stamp; call with
    (trainer, stamp) after fit() for the seconds from entry to the first
    completed step."""
    if trainer is None:
        return time.perf_counter()
    if trainer.first_step_at is None:
        return None
    return trainer.first_step_at - t0


def metrics_sink(args, run_name: str):
    """JsonlMetricsSink for --metrics_dir, or None."""
    if not getattr(args, "metrics_dir", None):
        return None
    from deeplearning_cfn_tpu_torch.train.metrics import JsonlMetricsSink

    return JsonlMetricsSink.for_run(args.metrics_dir, run_name)
