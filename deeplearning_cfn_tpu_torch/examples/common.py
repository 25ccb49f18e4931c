"""Shared plumbing for the port's example trainers — the parts of
``deeplearning_cfn_tpu/examples/common.py`` that ``llama_train``,
``bert_pretrain``, ``resnet_imagenet`` and ``multiprocess_smoke`` read."""

from __future__ import annotations

import argparse
import os
import time

from deeplearning_cfn_tpu_torch.train.schedules import build_schedule


def maybe_init_distributed(device: str = "cuda") -> int:
    """Join the process group when the cluster contract says this process is
    one of many: ``DEEPLEARNING_WORKERS_COUNT`` processes, this one
    ``DLCFN_PROCESS_ID``, meeting at ``DEEPLEARNING_COORDINATOR``
    (``host:port``), the env the discovery agent publishes.  NCCL on the
    card (each process on ``cuda:<id mod cards>``), gloo on the CPU.
    Returns this process's id; a single process joins nothing."""
    import torch
    import torch.distributed as dist

    n = int(os.environ.get("DEEPLEARNING_WORKERS_COUNT", "1"))
    pid = int(os.environ.get("DLCFN_PROCESS_ID", "0"))
    coordinator = os.environ.get("DEEPLEARNING_COORDINATOR")
    if n > 1 and coordinator and not dist.is_initialized():
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.set_device(pid % torch.cuda.device_count())
        dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://{coordinator}",
                                world_size=n, rank=pid)
    return pid


def default_mesh(strategy: str = "dp"):
    """The flat mesh over every rank: all fsdp, or all dp.  A multi-slice
    cluster (``DEEPLEARNING_SLICES_COUNT`` > 1) needs the hybrid mesh, which
    raises."""
    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.parallel.mesh import (
        MeshSpec,
        build_mesh,
        hybrid_mesh_for_slices,
    )

    n = dist.get_world_size()
    n_slices = int(os.environ.get("DEEPLEARNING_SLICES_COUNT", "1") or "1")
    if n_slices > 1:
        return hybrid_mesh_for_slices(n_slices)
    return build_mesh(MeshSpec.fsdp_parallel(n) if strategy == "fsdp" else MeshSpec.data_parallel(n))


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
        "--augment_flip", action="store_true",
        help="horizontal-flip augmentation of image batches, on the device (train steps only)",
    )
    p.add_argument(
        "--augment_crop", action="store_true",
        help="random-crop augmentation of image batches, on the device: same-size images "
             "get the pad-and-crop recipe (see --crop_pad)",
    )
    p.add_argument(
        "--crop_pad", type=int, default=4,
        help="zero padding per side for --augment_crop on images at the model's input size",
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
        "--prefetch_workers", type=int, default=1,
        help="producer threads behind the device prefetcher (the order is kept)",
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


def resume_start_step(ckpt) -> int:
    """The data-stream resume position for a (possibly None) Checkpointer:
    the restored run must consume the batches the lost run never saw, not
    replay the head of the shuffle order.  One batch per step, so the
    loader position IS the checkpoint step."""
    if ckpt is None:
        return 0
    return int(ckpt.latest_step() or 0)


def open_checkpointer(args):
    """(checkpointer_or_None, start_step) for --checkpoint_dir — the ONE
    resume-wiring helper every example uses.  The ordering it encodes is
    load-bearing: the checkpoint's latest step must be read BEFORE the
    data loader is built (it is the loader's start_batch), and the state
    itself is restored later, after trainer.init provides the template
    (``Checkpointer.restore_latest(state)`` loads into it in place)."""
    if not getattr(args, "checkpoint_dir", None):
        return None, 0
    from deeplearning_cfn_tpu_torch.train.checkpoint import Checkpointer

    ckpt = Checkpointer(args.checkpoint_dir)
    return ckpt, resume_start_step(ckpt)


def close_checkpointer(ckpt, state) -> None:
    """The end-of-run save (a no-op when the policy already saved this
    step), then wait for the writes to land."""
    if ckpt is not None:
        ckpt.save(state.step, state)
        ckpt.close()


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


def device_image_pipeline(args, image_shape, fallback_ds):
    """``(batches_fn, input_stats, augment)`` for an image trainer: the
    synthetic dataset's stream, its uint8 ``input_stats`` (normalised on the
    device, in the step), and ``--augment_flip`` / ``--augment_crop`` as a
    ``train.augment.DeviceAugment`` for ``TrainerConfig.augment`` (None when
    it would do nothing).  ``--data_dir`` record streams are a later
    slice's."""
    from deeplearning_cfn_tpu_torch.train.augment import DeviceAugment

    if getattr(args, "data_dir", None):
        raise NotImplementedError("--data_dir (image records) is ported in a later slice "
                                  "of the PyTorch port")
    stats = getattr(fallback_ds, "input_stats", None)
    crop, pad = None, 0
    if getattr(args, "augment_crop", False):
        crop, pad = (int(image_shape[0]), int(image_shape[1])), int(getattr(args, "crop_pad", 4) or 0)
    aug = DeviceAugment(flip=bool(getattr(args, "augment_flip", False)), crop=crop, pad=pad)
    return fallback_ds.batches, stats, None if aug.is_identity else aug
