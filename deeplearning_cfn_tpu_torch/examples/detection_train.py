"""Dense-detector training, RetinaNet with the prototype-mask head — counterpart
of ``deeplearning_cfn_tpu/examples/detection_train.py``.

The same flags and the same result dict, plus ``--device`` (default
``cuda``; the run raises when CUDA is missing unless ``--device cpu`` was
given).  ``--data_dir`` trains on COCO-converted detection records
(``cli convert --format coco``, with ``--masks`` for ``--masks``) through
the native loader, uint8 images normalised in the step; the eval reads their
val/test split.  Without records the images are the synthetic detection
stream (``train.data.SyntheticDetectionDataset``): coloured rectangles, one
colour a class, with padded boxes (and masks with ``--masks``).  Over
several processes (the cluster contract's env) the trainer runs over
``default_mesh(--strategy)``: BatchNorm's statistics and the losses'
positive-anchor and mask-slot counts are the whole batch's.
``--backbone_ckpt`` starts the backbone from a ``resnet_imagenet``
checkpoint (its depths must match ``--backbone``).  ``--eval_steps``
scores mAP@0.5 (and mask mAP with ``--masks``) on held-out batches after
training.

Run: ``python -m deeplearning_cfn_tpu_torch.examples.detection_train --steps 50 --masks``
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from deeplearning_cfn_tpu_torch.device import resolve_device
from deeplearning_cfn_tpu_torch.examples.common import (
    base_parser,
    default_mesh,
    first_step_clock,
    kernel_launches_since,
    maybe_init_distributed,
    metrics_sink,
)
from deeplearning_cfn_tpu_torch.models import retinanet
from deeplearning_cfn_tpu_torch.train.data import SyntheticDetectionDataset, to_device
from deeplearning_cfn_tpu_torch.train.datasets import IMAGENET_MEAN, IMAGENET_STD
from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig, matmul_precision
from deeplearning_cfn_tpu_torch.utils.logging import get_logger

BACKBONES = {
    "tiny": (1, 1, 1, 1),  # tests / CPU
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
}


def record_batches(args, batch: int, eval_mode: bool = False):
    """COCO-converted detection records (``cli convert --format coco``) when
    ``--data_dir`` is set; None = synthetic (also for ``args`` built by a
    caller without the flag).  Eval reads the val/test split, unshuffled,
    one pass."""
    if not getattr(args, "data_dir", None):
        return None
    from deeplearning_cfn_tpu_torch.examples.common import record_paths
    from deeplearning_cfn_tpu_torch.train.datasets import (
        detection_batches,
        detection_spec,
        instance_spec,
    )
    from deeplearning_cfn_tpu_torch.train.native_loader import NativeRecordLoader
    from deeplearning_cfn_tpu_torch.train.records import read_header

    _, paths = record_paths(args.data_dir, eval_mode)
    record_size, _ = read_header(paths[0])
    if getattr(args, "masks", False):
        spec = instance_spec(args.image_size, args.max_boxes)
        # Val splits may hold finer mask rasters (convert --mask-stride 1 or
        # 2) for image-resolution mask mAP: the stride follows from the
        # record size.  Training needs the prototype stride, 8.
        if record_size != spec.record_size:
            for stride in (1, 2, 4, 16):
                candidate = instance_spec(args.image_size, args.max_boxes, mask_stride=stride)
                if candidate.record_size == record_size:
                    if not eval_mode:
                        raise SystemExit(
                            f"train records carry mask stride {stride}, but "
                            "the prototype-mask loss trains at stride 8; "
                            "reconvert the train split with --mask-stride 8 "
                            "(finer strides are for val splits)"
                        )
                    spec = candidate
                    break
    else:
        spec = detection_spec(args.image_size, args.max_boxes)
    # The likeliest cause of a size mismatch: records converted with the
    # other --masks setting (the bitmaps change the record layout).
    if record_size != spec.record_size:
        other = (
            detection_spec(args.image_size, args.max_boxes)
            if getattr(args, "masks", False)
            else instance_spec(args.image_size, args.max_boxes)
        )
        hint = ""
        if record_size == other.record_size:
            hint = (
                " — the records were converted with the opposite --masks "
                "setting; re-run `cli convert --format coco"
                + (" --masks`" if getattr(args, "masks", False) else "` without --masks")
            )
        raise SystemExit(
            f"{paths[0]}: record_size {record_size} != expected "
            f"{spec.record_size} for --image_size {args.image_size} "
            f"--max_boxes {args.max_boxes}{hint}"
        )
    several = dist.is_initialized() and dist.get_world_size() > 1
    loader = NativeRecordLoader(
        paths,
        spec,
        batch_size=batch,
        shuffle=not eval_mode,
        loop=not eval_mode,
        n_threads=1 if (eval_mode or several) else 4,
    )
    # normalize=False: uint8 crosses to the card; the step normalises it
    # (TrainerConfig.input_stats).
    return lambda steps: detection_batches(loader, spec, steps, normalize=False)


def _backbone_checkpoint(path: str) -> tuple[dict, int]:
    """The raw state and step of the newest checkpoint under ``path``."""
    from pathlib import Path

    from deeplearning_cfn_tpu_torch.train.checkpoint import Checkpointer

    # Checked before the Checkpointer is built: it creates its directory.
    if not Path(path).is_dir():
        raise SystemExit(f"--backbone_ckpt: {path} does not exist")
    ck = Checkpointer(path, async_save=False)
    raw = ck.restore_raw()
    ck.close()
    if raw is None:
        raise SystemExit(f"--backbone_ckpt: no checkpoint under {path}")
    return raw


def main(argv: list[str] | None = None) -> dict:
    t_main = first_step_clock()
    launches_before = kernel_launches_since()
    p = base_parser(__doc__)
    p.add_argument("--backbone", choices=sorted(BACKBONES), default="resnet50")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--num_classes", type=int, default=80)
    p.add_argument("--max_boxes", type=int, default=10)
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--freeze_backbone_norm", action="store_true")
    p.add_argument("--masks", action="store_true",
                   help="train the prototype-mask head too (instance segmentation)")
    p.add_argument("--backbone_ckpt", default=None,
                   help="resnet_imagenet checkpoint dir: initialize the detector backbone "
                        "from the trained classifier; depths must match --backbone")
    p.add_argument("--optimizer", choices=["momentum", "adamw"], default="momentum")
    p.add_argument("--eval_steps", type=int, default=0,
                   help="held-out batches for mAP@0.5 after training (0 = skip)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.image_size % 32:
        raise SystemExit("--image_size must be a multiple of 32 (C5 stride)")
    device = resolve_device(args.device)
    maybe_init_distributed(args.device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    batch = args.global_batch_size or 8 * n
    lr = args.learning_rate or 0.01
    mesh = default_mesh(args.strategy) if dist.is_initialized() else None
    arch = dict(num_classes=args.num_classes, backbone_stages=BACKBONES[args.backbone],
                dtype=torch.bfloat16 if args.bf16 else torch.float32,
                freeze_backbone_norm=args.freeze_backbone_norm, with_masks=args.masks)
    raw = _backbone_checkpoint(args.backbone_ckpt) if args.backbone_ckpt else None
    transferred = {}

    def model_fn(generator):
        model = retinanet.RetinaNet(**arch, generator=generator)
        if raw is not None:  # before the trainer lays the model out and builds the optimizer
            transferred["tensors"] = retinanet.load_pretrained_backbone(model, raw[0])
        return model

    anchors = torch.from_numpy(retinanet.generate_anchors(args.image_size)).to(device)

    def loss_fn(model, x, y):
        outputs = model(x, train=True)
        if args.masks:
            cls_out, box_out, coeff_out, protos = outputs
            return retinanet.detection_loss_with_masks(
                cls_out, box_out, coeff_out, protos, anchors, y["boxes"], y["classes"],
                y["masks"], args.num_classes)
        cls_out, box_out = outputs
        return retinanet.detection_loss(cls_out, box_out, anchors, y["boxes"], y["classes"],
                                        args.num_classes)

    trainer = Trainer(
        model_fn,
        TrainerConfig(
            strategy=args.strategy,
            learning_rate=lr,
            has_train_arg=True,
            optimizer=args.optimizer,
            weight_decay=args.weight_decay or 0.0,
            grad_clip_norm=10.0,
            grad_accum_steps=args.grad_accum,
            log_every=args.log_every,
            # uint8 record images are normalised in the step; the float
            # synthetic stream passes as it is.
            input_stats=(tuple(IMAGENET_MEAN.tolist()), tuple(IMAGENET_STD.tolist())),
        ),
        loss_fn=loss_fn,
        device=device,
        mesh=mesh,
        analytic_flops_fn=lambda x: retinanet.train_flops(arch, x.shape),
    )
    ds = SyntheticDetectionDataset(image_size=args.image_size, num_classes=args.num_classes,
                                   max_boxes=args.max_boxes, batch_size=batch,
                                   with_masks=args.masks)
    batches = record_batches(args, batch) or ds.batches
    # As in the JAX example, the sample is the stream's first batch.
    sample = next(iter(batches(1)))
    state = trainer.init(seed=0)
    if raw is not None:
        get_logger("dlcfn.examples").info(
            "backbone initialized from %s (step %d, %d tensors transferred)",
            args.backbone_ckpt, raw[1], transferred["tensors"])
    logger = trainer.throughput_logger(sample.x, examples_per_step=batch, name="detection",
                                       sink=metrics_sink(args, "detection"),
                                       log_every=args.log_every)
    state, losses = trainer.fit(state, batches(args.steps), steps=args.steps, logger=logger,
                                prefetch_workers=args.prefetch_workers)
    if logger.sink is not None:
        logger.sink.close()
    result = {
        "final_loss": losses[-1],
        "steps": len(losses),
        "history": logger.history,
        "first_step_s": first_step_clock(trainer, t_main),
        "device": str(trainer.device),
        "backbone_tensors_transferred": transferred.get("tensors", 0),
    }
    if args.eval_steps:
        result["eval"] = evaluate_map(trainer, state, anchors, args, batch,
                                      steps=args.eval_steps)
    result["kernel_launches"] = kernel_launches_since(launches_before)
    return result


def evaluate_map(trainer, state, anchors, args, batch, steps: int) -> dict:
    """mAP@0.5 on the held-out record split (``--data_dir``), else a held-out
    synthetic stream (the training task's colour templates, other samples):
    the eval forward and the fixed-shape ``predict`` on the device, greedy
    matching and AP on the host.  With ``--masks`` also mask mAP at image
    resolution (``mask_mAP``, predicted and ground-truth bitmaps upsampled)
    and at prototype stride (``mask_mAP_stride``).  Single-process only:
    several processes skip it with a warning."""
    from deeplearning_cfn_tpu_torch.train.detection_eval import (
        DetectionAccumulator,
        upsample_masks,
    )

    if dist.is_initialized() and dist.get_world_size() > 1:
        get_logger("dlcfn.examples").warning(
            "mAP evaluation is single-process; skipping on %d processes", dist.get_world_size())
        return {}
    with_masks = bool(getattr(args, "masks", False))
    model = state.model

    @torch.no_grad()
    def infer(x):
        outputs = model(trainer._normalize_input(x), train=False)
        if with_masks:
            cls_out, box_out, coeff_out, protos = outputs
            return retinanet.predict(cls_out, box_out, anchors, max_detections=50,
                                     coeffs=coeff_out, protos=protos)
        cls_out, box_out = outputs
        return retinanet.predict(cls_out, box_out, anchors, max_detections=50)

    eval_batches = record_batches(args, batch, eval_mode=True)
    if eval_batches is None:
        eval_batches = SyntheticDetectionDataset(
            image_size=args.image_size, num_classes=args.num_classes, max_boxes=args.max_boxes,
            batch_size=batch, seed=7_000, template_seed=0, with_masks=with_masks).batches
    acc = DetectionAccumulator(num_classes=args.num_classes)
    mask_acc = DetectionAccumulator(num_classes=args.num_classes, iou_kind="mask") \
        if with_masks else None
    mask_acc_stride = DetectionAccumulator(num_classes=args.num_classes, iou_kind="mask") \
        if with_masks else None
    full_hw = (args.image_size, args.image_size)
    model.eval()
    try:
        for batch_data in eval_batches(steps):
            x = to_device(batch_data.x, trainer.device)
            with matmul_precision(trainer.config.matmul_precision):
                dets = {k: v.cpu().numpy() for k, v in infer(x).items()}
            gt = batch_data.y
            for i in range(len(batch_data.x)):
                acc.add_image(dets["boxes"][i], dets["scores"][i], dets["classes"][i],
                              dets["valid"][i], gt["boxes"][i], gt["classes"][i])
                if mask_acc is None:
                    continue
                # Only the real instances are upsampled: the padding slots'
                # empty bitmaps would dominate the host's work.
                keep = np.asarray(dets["valid"][i]).astype(bool)
                real = np.asarray(gt["classes"][i]) >= 0
                picked = (dets["boxes"][i][keep], dets["scores"][i][keep],
                          dets["classes"][i][keep], keep[keep], gt["boxes"][i][real],
                          gt["classes"][i][real])
                mask_acc.add_image(
                    *picked, pred_masks=upsample_masks(dets["masks"][i][keep], full_hw),
                    gt_masks=upsample_masks(gt["masks"][i][real], full_hw))
                mask_acc_stride.add_image(
                    *picked, pred_masks=dets["masks"][i][keep],
                    gt_masks=upsample_masks(gt["masks"][i][real], dets["masks"][i].shape[1:]))
    finally:
        model.train()
    out = acc.result()
    out["per_class_ap"] = {str(k): v for k, v in out["per_class_ap"].items()}
    if mask_acc is not None:
        m = mask_acc.result()
        out["mask_mAP"] = m["mAP"]
        out["mask_per_class_ap"] = {str(k): v for k, v in m["per_class_ap"].items()}
        out["mask_mAP_stride"] = mask_acc_stride.result()["mAP"]
    return out


if __name__ == "__main__":
    print(main())
