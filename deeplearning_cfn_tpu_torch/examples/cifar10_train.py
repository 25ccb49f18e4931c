"""CIFAR-10-shaped training of VGG — counterpart of
``deeplearning_cfn_tpu/examples/cifar10_train.py``.

The same flags and result dict, plus ``--device`` (default ``cuda``; the run
raises when CUDA is missing unless ``--device cpu`` was given).
``--data_dir`` trains on image records (``cli convert --format cifar10``)
through the native loader, uint8 normalised in the step; the eval reads
``--eval_data_dir`` (a held-out record directory) or the test/val split of
``--data_dir`` (else an unshuffled pass over the training records, reported
as ``split="train"``), the whole held-out split with ``--full_eval``.
Without records the images are the synthetic CIFAR-shaped stream (32 × 32 ×
3, ten classes), and the held-out eval shares the training task
(``template_seed=0``) with other samples (``seed=10000``).
``--target_accuracy`` stops training once the train accuracy reaches it,
checked every ``--log_every`` steps (``Trainer.fit(stop_fn=)``).  Several
processes of the cluster contract's env train over ``default_mesh``,
BatchNorm on the whole batch's statistics.

Run: ``python -m deeplearning_cfn_tpu_torch.examples.cifar10_train --model vgg11``
"""

from __future__ import annotations

import argparse
import copy

import torch
import torch.distributed as dist

from deeplearning_cfn_tpu_torch.device import resolve_device
from deeplearning_cfn_tpu_torch.examples.common import (
    base_parser,
    close_checkpointer,
    default_mesh,
    device_image_pipeline,
    first_step_clock,
    has_heldout_split,
    image_batches,
    image_pipeline,
    kernel_launches_since,
    log,
    make_lr_schedule,
    maybe_init_distributed,
    metrics_sink,
    open_checkpointer,
)
from deeplearning_cfn_tpu_torch.models.vgg import CONFIGS, VGG
from deeplearning_cfn_tpu_torch.train.data import SyntheticDataset
from deeplearning_cfn_tpu_torch.train.metrics import ThroughputLogger
from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig

SHAPE = (32, 32, 3)


def main(argv: list[str] | None = None) -> dict:
    t_main = first_step_clock()
    launches_before = kernel_launches_since()
    p = base_parser(__doc__)
    p.add_argument("--model", choices=sorted(CONFIGS), default="vgg11")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--target_accuracy", type=float, default=None,
                   help="stop early when train accuracy reaches this (time-to-accuracy mode)")
    p.add_argument("--eval_steps", type=int, default=0,
                   help="held-out eval batches after training (0 = skip)")
    p.add_argument("--full_eval", action=argparse.BooleanOptionalAction, default=True,
                   help="when the eval split is held out, score the final eval on the whole "
                        "split (--eval_steps then only decides that eval runs)")
    p.add_argument("--eval_data_dir", default=None,
                   help="record dir(s) for a held-out eval split; unset with --data_dir = "
                        "the test/val split there, else an unshuffled pass over the "
                        "training records (split='train')")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    maybe_init_distributed(args.device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    batch = args.global_batch_size or 64 * n
    lr = args.learning_rate or 0.05
    mesh = default_mesh(args.strategy) if dist.is_initialized() else None
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    ds = SyntheticDataset(shape=SHAPE, num_classes=10, batch_size=batch, noise_scale=1.0)
    ckpt, start_step = open_checkpointer(args)
    batches, input_stats, augment = device_image_pipeline(args, SHAPE, ds,
                                                          start_step=start_step)
    trainer = Trainer(
        lambda g: VGG(config=CONFIGS[args.model], num_classes=10, dtype=dtype, generator=g),
        TrainerConfig(
            strategy=args.strategy,
            learning_rate=lr,
            lr_schedule=make_lr_schedule(args, lr),
            has_train_arg=True,
            optimizer="momentum",
            weight_decay=args.weight_decay or 0.0,
            grad_accum_steps=args.grad_accum,
            # The stop_fn's cadence: log_every=1 checks every step.
            log_every=args.log_every,
            input_stats=input_stats,
            augment=augment,
        ),
        device=device,
        mesh=mesh,
    )
    # As in the JAX example, the stream's first batch is the model's sample:
    # record runs train from the next one.
    next(iter(batches(1)))
    state = trainer.init(seed=0)
    if ckpt is not None:
        ckpt.restore_latest(state)
    sink = metrics_sink(args, args.model)
    logger = ThroughputLogger(global_batch_size=batch, log_every=args.log_every, name=args.model,
                              sink=sink)
    last_accuracy = {"value": 0.0}

    def stop_fn(metrics: dict) -> bool:
        last_accuracy["value"] = float(metrics["accuracy"])
        return bool(args.target_accuracy and last_accuracy["value"] >= args.target_accuracy)

    state, losses = trainer.fit(state, batches(args.steps), steps=args.steps, logger=logger,
                                stop_fn=stop_fn, checkpointer=ckpt,
                                prefetch_workers=args.prefetch_workers)
    close_checkpointer(ckpt, state)
    result = {
        "final_loss": losses[-1],
        "final_accuracy": last_accuracy["value"],
        "steps": len(losses),
        "start_step": start_step,
        "end_step": state.step,
        "device": str(trainer.device),
        "history": logger.history,
        "first_step_s": first_step_clock(trainer, t_main),
    }
    if args.eval_steps:
        def eval_pipeline(eargs):
            # Raw uint8 normalised in the step when the eval records pin the
            # training's statistics; else normalised on the host with their
            # own (held-out data is never normalised with other statistics).
            if input_stats is not None:
                batches_fn, eval_stats = image_pipeline(eargs, SHAPE, ds, eval_mode=True)
                if eval_stats == input_stats:
                    return batches_fn
                log.warning("eval records pin other normalization stats than training (%s vs "
                            "%s); using the eval dir's own stats host-side",
                            eval_stats, input_stats)
            return image_batches(eargs, SHAPE, ds, eval_mode=True)

        record_heldout = False  # only a record split has a whole to score
        if args.eval_data_dir:
            eval_args = copy.copy(args)
            eval_args.data_dir = args.eval_data_dir
            eval_batches, split, record_heldout = eval_pipeline(eval_args), "heldout", True
        elif args.data_dir:
            split = "heldout" if has_heldout_split(args.data_dir) else "train"
            eval_batches, record_heldout = eval_pipeline(args), split == "heldout"
        else:
            eval_ds = SyntheticDataset(shape=SHAPE, num_classes=10, batch_size=batch,
                                       seed=10_000, template_seed=0)
            eval_batches, split = eval_ds.batches, "heldout"
        if args.full_eval and record_heldout:
            result["eval"] = {"split": "heldout-full",
                              **trainer.evaluate(state, eval_batches(None))}
        else:
            result["eval"] = {"split": split,
                              **trainer.evaluate(state, eval_batches(args.eval_steps),
                                                 steps=args.eval_steps)}
        if sink is not None:
            sink.write({"event": "eval", "run": args.model, **result["eval"]})
    if sink is not None:
        sink.close()
    result["kernel_launches"] = kernel_launches_since(launches_before)
    return result


if __name__ == "__main__":
    print(main())
