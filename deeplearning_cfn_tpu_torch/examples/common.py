"""Shared plumbing for the port's example trainers — the counterpart of
``deeplearning_cfn_tpu/examples/common.py``, its record half included:
``--data_dir`` (DLC1 record files, ``cli convert``'s output) resolved to a
split (:func:`record_paths`), token records for the language models
(:func:`token_record_loader`) and image records for the classifiers
(:func:`device_image_pipeline`, :func:`image_pipeline`), each through the
native loader (``train/native_loader.py``) with ``start_batch`` at the
resumed step."""

from __future__ import annotations

import argparse
import itertools
import os
import time
from pathlib import Path

from deeplearning_cfn_tpu_torch.train.schedules import build_schedule
from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.examples")

HELDOUT_STEMS = ("test", "val", "heldout")


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
    """The flat mesh over every rank: all fsdp, or all dp.  On a multi-slice
    cluster (``DEEPLEARNING_SLICES_COUNT`` > 1) the hybrid mesh: the strategy's
    axis over each node's ranks, dp across the nodes (gradient reduction the
    only traffic between them)."""
    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.parallel.mesh import (
        MeshSpec,
        build_mesh,
        hybrid_mesh_for_slices,
    )

    n = dist.get_world_size()
    n_slices = int(os.environ.get("DEEPLEARNING_SLICES_COUNT", "1") or "1")
    if n_slices > 1:
        per_slice = n // n_slices
        ici = (MeshSpec.fsdp_parallel(per_slice) if strategy == "fsdp"
               else MeshSpec.data_parallel(per_slice))
        return hybrid_mesh_for_slices(n_slices, ici_spec=ici, dcn_axis="dp")
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
        help="colon-separated candidate dirs of DLC1 record files (the first that exists "
             "is read); unset = synthetic data",
    )
    p.add_argument(
        "--augment_flip", action="store_true",
        help="horizontal-flip augmentation of image batches, on the device (train steps only)",
    )
    p.add_argument(
        "--augment_crop", action="store_true",
        help="random-crop augmentation of image batches, on the device: records stored with "
             "a margin get a random window, same-size images the pad-and-crop recipe "
             "(see --crop_pad)",
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


def synthetic_from(batches, start_step: int):
    """A synthetic stream's ``batches(steps)`` for a run resumed at
    ``start_step``: the batches the straight run trains on from that step
    (one a step), not the head of the stream again."""
    if not start_step:
        return batches
    return lambda steps: itertools.islice(batches(start_step + steps), start_step, None)


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


def kernel_launches_since(before: dict | None = None) -> dict:
    """Call with no args at entry for a copy of the port's kernel launch
    counts (``ops._kernels.launch_counts``, by kernel and by variant); call
    with that copy for the launches since, the nonzero ones."""
    from deeplearning_cfn_tpu_torch.ops import _kernels

    if before is None:
        return dict(_kernels.launch_counts)
    return {k: n - before.get(k, 0) for k, n in _kernels.launch_counts.items()
            if n != before.get(k, 0)}


def metrics_sink(args, run_name: str):
    """JsonlMetricsSink for --metrics_dir, or None."""
    if not getattr(args, "metrics_dir", None):
        return None
    from deeplearning_cfn_tpu_torch.train.metrics import JsonlMetricsSink

    return JsonlMetricsSink.for_run(args.metrics_dir, run_name)


def has_heldout_split(data_dir: str | None) -> bool:
    """Whether ``--data_dir`` holds a test/val/heldout record file: then an
    eval pass is held out, not an unshuffled pass over the training
    records."""
    if not data_dir:
        return False
    from deeplearning_cfn_tpu_torch.train.data import probe_data_source

    root = probe_data_source(data_dir.split(":"))
    if root is None:
        return False
    return any(p.stem in HELDOUT_STEMS for p in Path(root).glob("*.dlc"))


def record_paths(data_dir: str, eval_mode: bool = False):
    """``--data_dir`` -> ``(root, record paths)``: the first candidate
    directory that exists, then the split: eval reads the test/val/heldout
    files when there are any, training leaves them out.  Every record-reading
    example goes through here, so the split policy is one."""
    from deeplearning_cfn_tpu_torch.train.data import probe_data_source

    root = probe_data_source(data_dir.split(":"))
    if root is None:
        raise SystemExit(f"--data_dir: none of {data_dir!r} exists")
    paths = sorted(Path(root).glob("*.dlc"))
    if not paths:
        raise SystemExit(f"--data_dir: no .dlc record files under {root}")
    if eval_mode:
        evals = [p for p in paths if p.stem in HELDOUT_STEMS]
        paths = evals or paths
    elif len(paths) > 1:
        trains = [p for p in paths if p.stem not in HELDOUT_STEMS]
        paths = trains or paths
    return root, paths


def _record_loader(paths, spec, batch: int, eval_mode: bool, start_step: int):
    """The native loader as every example opens it: training shuffles and
    loops from ``start_step`` (the resumed step, one batch a step) on four
    threads (the C++ loader hands batches over in ticket order, so the
    stream is the same at any thread count); eval is one unshuffled pass on
    one thread that keeps the last, partial batch (a held-out score covers
    the whole split)."""
    from deeplearning_cfn_tpu_torch.train.native_loader import NativeRecordLoader

    return NativeRecordLoader(
        paths,
        spec,
        batch_size=batch,
        shuffle=not eval_mode,
        loop=not eval_mode,
        n_threads=1 if eval_mode else 4,
        start_batch=0 if eval_mode else start_step,
        drop_remainder=not eval_mode,
    )


def token_record_loader(
    args,
    batch: int,
    model_vocab_size: int,
    eval_mode: bool = False,
    reserve_ids: int = 0,
    start_step: int = 0,
):
    """Token records (``cli convert --format text``) -> ``(loader, spec,
    data_vocab)``, or None when ``--data_dir`` is unset.  The one place the
    ``tokenizer.json`` sidecar's vocabulary and window length are held to
    the model's and to ``--seq_len``.

    ``reserve_ids``: ids the caller needs past the data vocabulary (1 for
    an MLM mask id that must not collide with a real token); the model's
    embedding table must cover ``data_vocab + reserve_ids``."""
    if not args.data_dir:
        return None
    from deeplearning_cfn_tpu_torch.train.datasets import read_tokenizer_sidecar, token_spec

    root, paths = record_paths(args.data_dir, eval_mode)
    sidecar = read_tokenizer_sidecar(root)
    data_vocab = int(sidecar.get("vocab_size", 0)) if sidecar else None
    if data_vocab and data_vocab + reserve_ids > model_vocab_size:
        need = f"{data_vocab} + {reserve_ids} reserved" if reserve_ids else str(data_vocab)
        raise SystemExit(
            f"records were tokenized with vocab_size={data_vocab} but the "
            f"model's vocab is {model_vocab_size} (needs >= {need}); pick a "
            "matching config or reconvert with the model's tokenizer"
        )
    rec_seq = int(sidecar.get("seq_len", args.seq_len)) if sidecar else args.seq_len
    if rec_seq != args.seq_len:
        raise SystemExit(
            f"records hold {rec_seq}-token windows but --seq_len is "
            f"{args.seq_len}; pass --seq_len {rec_seq}"
        )
    spec = token_spec(rec_seq)
    return _record_loader(paths, spec, batch, eval_mode, start_step), spec, data_vocab


def _open_image_records(args, image_shape, batch: int, eval_mode: bool = False,
                        start_step: int = 0):
    """Open ``--data_dir`` image records: ``(loader, input_stats,
    margin_spec)``.  ``input_stats`` is the per-channel ``(mean, std)`` of
    uint8 records (None for float32 ones); ``margin_spec`` is set when the
    records are stored larger than the model's input and must be cropped.

    Float32 records, uint8 records at the input size and uint8 records with
    a margin are told apart by the file header and, for a margin, by the
    converter's layout sidecar, never by the record size alone (a float32
    record of side S has the bytes of a uint8 record of side 2S)."""
    from deeplearning_cfn_tpu_torch.train.datasets import (
        STATS,
        margin_spec_from_layout,
        read_stats_sidecar,
    )
    from deeplearning_cfn_tpu_torch.train.records import RecordSpec, read_header

    root, paths = record_paths(args.data_dir, eval_mode)
    record_size, _ = read_header(paths[0])
    spec = RecordSpec.classification(image_shape)
    u8_spec = RecordSpec.classification(image_shape, "uint8")
    is_u8 = record_size == u8_spec.record_size != spec.record_size
    margin_spec = None
    if is_u8:
        spec = u8_spec
    elif record_size != spec.record_size:
        # No layout sidecar: the loader's size check raises.
        margin_spec = margin_spec_from_layout(paths[0], record_size, image_shape)
        if margin_spec is not None:
            spec = margin_spec
            is_u8 = True
    loader = _record_loader(paths, spec, batch, eval_mode, start_step)
    log.info(
        "data%s: %d record files under %s (%d records, %d batches/epoch%s%s)",
        " [eval]" if eval_mode else "", len(paths), root,
        loader.shard_records, loader.batches_per_epoch,
        ", uint8 (in-step normalize)" if is_u8 else "",
        f", stored {spec.fields[0].shape[0]}px (crop to {image_shape[0]})"
        if margin_spec is not None else "",
    )
    if not is_u8:
        return loader, None, None
    # The converter pins the normalisation in stats.json; the guess from the
    # image shape is for hand-made record directories only.
    stats = read_stats_sidecar(root)
    if stats is None:
        channels = int(image_shape[-1])
        guess = {1: "mnist", 3: "cifar10" if image_shape[0] <= 64 else "imagenet"}.get(channels)
        if guess is None:
            raise SystemExit(
                f"--data_dir: uint8 records with {channels} channels and no "
                f"stats.json under {root}; rerun `cli convert` (it writes "
                "the sidecar) or add stats.json with mean/std"
            )
        log.warning("no stats.json under %s; guessing %s normalization from image shape %s "
                    "— convert with `cli convert` to pin it", root, guess, tuple(image_shape))
        stats = STATS[guess]
    input_stats = (tuple(stats.mean.tolist()), tuple(stats.std.tolist()))
    return loader, input_stats, margin_spec


def image_pipeline(args, image_shape, fallback_ds, eval_mode: bool = False,
                   start_step: int = 0):
    """``(batches_fn, input_stats)`` with the augmentation on the HOST (numpy
    a batch): records through the native loader when ``--data_dir`` is set,
    else the synthetic dataset.  uint8 records stream raw and ``input_stats``
    normalises them in the step; float records and synthetic data give
    None.  :func:`device_image_pipeline` moves the flips and crops into the
    step; this form serves the eval streams.  ``eval_mode`` is an unshuffled
    single pass over the test/val split when there is one."""
    if not args.data_dir:
        return synthetic_from(fallback_ds.batches, start_step), None
    batch = args.global_batch_size or fallback_ds.batch_size
    loader, input_stats, margin_spec = _open_image_records(
        args, image_shape, batch, eval_mode, start_step)
    if input_stats is None:
        return loader.batches, None
    flip = bool(getattr(args, "augment_flip", False)) and not eval_mode
    aug_crop = bool(getattr(args, "augment_crop", False)) and not eval_mode
    crop_pad = int(getattr(args, "crop_pad", 4) or 0)
    target_hw = (int(image_shape[0]), int(image_shape[1]))
    if margin_spec is None and not aug_crop and not flip:
        return loader.batches, input_stats
    from deeplearning_cfn_tpu_torch.train.datasets import (
        center_crop_batches,
        flipped_batches,
        random_crop_batches,
    )

    def batches(steps):
        stream = loader.batches(steps)
        cropped = True
        if margin_spec is not None:
            # Margin records must come down to the input size: a random
            # window with --augment_crop, else (and always in eval) the centre.
            if eval_mode or not aug_crop:
                stream = center_crop_batches(stream, target_hw)
            else:
                stream = random_crop_batches(stream, target_hw)
        elif aug_crop:
            stream = random_crop_batches(stream, target_hw, pad=crop_pad)
        else:
            cropped = False
        if flip:
            # Crops allocate fresh arrays (a flip in place is safe); decoded
            # batches are copied first.
            stream = flipped_batches(stream, copy=not cropped)
        return stream

    return batches, input_stats


def device_image_pipeline(args, image_shape, fallback_ds, eval_mode: bool = False,
                          start_step: int = 0):
    """``(batches_fn, input_stats, augment)`` for an image trainer: records
    stream raw (uint8 stays uint8 across PCIe), ``input_stats`` normalises
    them in the step, and ``--augment_flip`` / ``--augment_crop`` become a
    ``train.augment.DeviceAugment`` for ``TrainerConfig.augment`` (None when
    it would do nothing).  Without ``--data_dir``: the synthetic dataset
    and its own ``input_stats``.

    Records stored with a margin are cropped on the device: the step takes
    images at the stored size and the augment stage cuts the window (random
    with ``--augment_crop``, else the centre), so the model's first sample
    is at the stored size.  Eval streams are never augmented: margin
    records are centre-cropped on the host and ``augment`` is None."""
    from deeplearning_cfn_tpu_torch.train.augment import DeviceAugment

    target_hw = (int(image_shape[0]), int(image_shape[1]))
    flip = bool(getattr(args, "augment_flip", False)) and not eval_mode
    aug_crop = bool(getattr(args, "augment_crop", False)) and not eval_mode
    crop_pad = int(getattr(args, "crop_pad", 4) or 0)

    def build_augment(margin: bool):
        crop, pad, random_crop = None, 0, True
        if margin:
            crop, random_crop = target_hw, aug_crop
        elif aug_crop:
            crop, pad = target_hw, crop_pad
        aug = DeviceAugment(flip=flip, crop=crop, pad=pad, random_crop=random_crop)
        return None if aug.is_identity else aug

    if not args.data_dir:
        stats = getattr(fallback_ds, "input_stats", None)
        augment = None if eval_mode else build_augment(False)
        return synthetic_from(fallback_ds.batches, start_step), stats, augment
    batch = args.global_batch_size or fallback_ds.batch_size
    loader, input_stats, margin_spec = _open_image_records(
        args, image_shape, batch, eval_mode, start_step)
    if eval_mode:
        if margin_spec is not None:
            from deeplearning_cfn_tpu_torch.train.datasets import center_crop_batches

            def batches(steps):
                return center_crop_batches(loader.batches(steps), target_hw)

            return batches, input_stats, None
        return loader.batches, input_stats, None
    return loader.batches, input_stats, build_augment(margin_spec is not None)


def image_batches(args, image_shape, fallback_ds, eval_mode: bool = False):
    """:func:`image_pipeline` with uint8 records normalised on the HOST (the
    slow path), for an eval split whose statistics differ from training's."""
    import numpy as np

    from deeplearning_cfn_tpu_torch.train.datasets import normalized_batches

    batches, input_stats = image_pipeline(args, image_shape, fallback_ds, eval_mode)
    if input_stats is None:
        return batches
    mean = np.asarray(input_stats[0], np.float32)
    std = np.asarray(input_stats[1], np.float32)

    def host_normalized(steps):
        return normalized_batches(batches(steps), mean, std, flip=False)

    return host_normalized
