"""ResNet ImageNet-shaped training on one device — counterpart of
``deeplearning_cfn_tpu/examples/resnet_imagenet.py``.

The same flags and the same result dict, plus ``--device`` (default ``cuda``;
the run raises when CUDA is missing unless ``--device cpu`` was given) and
``--use_pallas_head``, which sets the model's ``use_pallas_head``: the f32
classifier then runs through the CUDA fused-dense kernel.  ``--data_dir``
trains on image records (``cli convert``) through the native loader: uint8
records cross to the card as they are and are normalised in the step, the
flips and crops (``--augment_flip``, ``--augment_crop``) run on the device,
and records stored with a margin are cut to ``--image_size`` there.  The
held-out eval reads the val/test split (centre-cropped on the host), the
whole split with ``--full_eval``.  Without records the stream is synthetic
and the held-out one shares the training task (``template_seed=0``) with
other samples (``seed=10000``).  With ``--checkpoint_dir`` the run restores
the newest checkpoint there, continues the record stream from its step,
saves on the policy (every 60 s) and at the end.  ``--profile`` splits each
step into the ``obs.profiler`` phases (the result's ``profile``).

Run: ``python -m deeplearning_cfn_tpu_torch.examples.resnet_imagenet --depth 50 --steps 50 --global_batch_size 128 --use_pallas_head``
"""

from __future__ import annotations

import argparse

import torch

from deeplearning_cfn_tpu_torch.device import resolve_device
from deeplearning_cfn_tpu_torch.examples.common import (
    base_parser,
    close_checkpointer,
    device_image_pipeline,
    first_step_clock,
    has_heldout_split,
    image_pipeline,
    make_lr_schedule,
    metrics_sink,
    open_checkpointer,
)
from deeplearning_cfn_tpu_torch.obs.profiler import StepProfiler
from deeplearning_cfn_tpu_torch.models import resnet
from deeplearning_cfn_tpu_torch.train.data import SyntheticDataset
from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig

DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def main(argv: list[str] | None = None) -> dict:
    t_main = first_step_clock()
    p = base_parser(__doc__)
    p.add_argument("--depth", type=int, choices=sorted(DEPTHS), default=50)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--norm", choices=["batch", "group"], default="batch",
                   help="normalization layer: BatchNorm (default) or GroupNorm-32")
    p.add_argument("--eval_steps", type=int, default=0,
                   help="held-out eval batches after training (0 = skip; reads --data_dir's "
                        "val/test split when there is one); in --target_accuracy mode, the "
                        "batches of each mid-run eval")
    p.add_argument("--target_accuracy", type=float, default=None,
                   help="stop when held-out top-1 reaches this (eval every --eval_every steps)")
    p.add_argument("--full_eval", action=argparse.BooleanOptionalAction, default=True,
                   help="score the final eval, and confirm the target gate, on the whole "
                        "held-out record split (synthetic runs are unaffected)")
    p.add_argument("--eval_every", type=int, default=0,
                   help="steps between held-out evals in --target_accuracy mode "
                        "(default: --steps/10)")
    p.add_argument("--use_pallas_head", action="store_true",
                   help="run the f32 classifier through the fused-dense kernel")
    p.add_argument("--profile", action="store_true",
                   help="split each training step into data_wait, h2d, dispatch, compute "
                        "and host (obs/profiler.StepProfiler): the result's profile, and a "
                        "step_time event a step in the flight journal")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    batch = args.global_batch_size or 32
    lr = args.learning_rate or 0.1
    shape = (args.image_size, args.image_size, 3)
    arch = dict(stage_sizes=DEPTHS[args.depth],
                dtype=torch.bfloat16 if args.bf16 else torch.float32,
                norm=args.norm, use_pallas_head=args.use_pallas_head)
    ds = SyntheticDataset.imagenet_like(batch_size=batch, image_size=args.image_size)
    ckpt, start_step = open_checkpointer(args)
    # uint8 records stream raw; normalisation, flips and crops run in the step.
    batches, input_stats, augment = device_image_pipeline(args, shape, ds,
                                                          start_step=start_step)
    trainer = Trainer(
        lambda gen: resnet.ResNet(**arch, generator=gen),
        TrainerConfig(
            strategy=args.strategy,
            learning_rate=lr,
            lr_schedule=make_lr_schedule(args, lr),
            weight_decay=args.weight_decay or 0.0,
            has_train_arg=True,
            label_smoothing=0.1,
            grad_accum_steps=args.grad_accum,
            log_every=args.log_every,
            input_stats=input_stats,
            augment=augment,
        ),
        device=device,
        analytic_flops_fn=lambda x: resnet.train_flops(arch, x.shape),
    )
    # As in the JAX example, the sample is the stream's first batch (at the
    # stored size: margin records are cut in the step).
    sample = next(iter(batches(1)))
    state = trainer.init(seed=0)
    if ckpt is not None:
        ckpt.restore_latest(state)
    logger = trainer.throughput_logger(
        sample.x, examples_per_step=batch, name=f"resnet{args.depth}",
        sink=metrics_sink(args, f"resnet{args.depth}"), log_every=args.log_every,
    )

    # Each step's breakdown is journaled too (a ``step_time`` event a step).
    profiler = (StepProfiler(name=f"resnet{args.depth}", per_step_events=True)
                if args.profile else None)

    def eval_source():
        """A fresh held-out stream and its split name (a record eval is one
        pass, so each eval opens its own)."""
        if args.data_dir:
            eval_batches, _ = image_pipeline(args, shape, ds, eval_mode=True)
            return eval_batches, "heldout" if has_heldout_split(args.data_dir) else "train"
        held_out = SyntheticDataset(shape=shape, num_classes=1000, batch_size=batch,
                                    seed=10_000, template_seed=0)
        return held_out.batches, "heldout-synthetic"

    result: dict = {}
    if args.target_accuracy:
        eval_every = args.eval_every or max(1, args.steps // 10)
        eval_steps = args.eval_steps or 16
        train_iter = iter(batches(args.steps))
        losses: list[float] = []
        evals: list[dict] = []
        reached, done = False, 0
        while done < args.steps and not reached:
            chunk = min(eval_every, args.steps - done)
            state, chunk_losses = trainer.fit(state, train_iter, steps=chunk, logger=logger,
                                              checkpointer=ckpt,
                                              prefetch_workers=args.prefetch_workers,
                                              profiler=profiler)
            losses.extend(chunk_losses)
            done += chunk
            eval_batches, split = eval_source()
            ev = trainer.evaluate(state, eval_batches(eval_steps), steps=eval_steps)
            evals.append({"step": done, "split": split, **ev})
            hit = float(ev.get("accuracy", 0.0)) >= args.target_accuracy
            if hit and args.full_eval and split == "heldout":
                # The subsample only monitors: the claim is scored on the
                # whole split, its last partial batch included.
                full_batches, _ = eval_source()
                full = trainer.evaluate(state, full_batches(None))
                evals.append({"step": done, "split": "heldout-full", **full})
                reached = float(full.get("accuracy", 0.0)) >= args.target_accuracy
            else:
                reached = hit
        result.update(eval_history=evals, target_reached=reached, eval=evals[-1])
    else:
        state, losses = trainer.fit(state, batches(args.steps), steps=args.steps, logger=logger,
                                    checkpointer=ckpt, prefetch_workers=args.prefetch_workers,
                                    profiler=profiler)
        result["pipeline"] = trainer.last_pipeline_stats.snapshot()
        if args.eval_steps:
            eval_batches, split = eval_source()
            if args.full_eval and split == "heldout":
                result["eval"] = {"split": "heldout-full",
                                  **trainer.evaluate(state, eval_batches(None))}
            else:
                result["eval"] = {"split": split,
                                  **trainer.evaluate(state, eval_batches(args.eval_steps),
                                                     steps=args.eval_steps)}
    close_checkpointer(ckpt, state)
    if logger.sink is not None:
        logger.sink.close()
    if profiler is not None:
        result["profile"] = profiler.journal()
    result.update({
        "final_loss": losses[-1],
        "steps": len(losses),
        "start_step": start_step,
        "end_step": state.step,
        "device": str(device),
        "params": sum(p.numel() for p in state.model.parameters()),
        "history": logger.history,
        "first_step_s": first_step_clock(trainer, t_main),
    })
    return result


if __name__ == "__main__":
    print(main())
