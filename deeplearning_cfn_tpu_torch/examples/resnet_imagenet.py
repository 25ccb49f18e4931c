"""ResNet ImageNet-shaped training on one device — counterpart of
``deeplearning_cfn_tpu/examples/resnet_imagenet.py``.

The same flags and the same result dict, plus ``--device`` (default ``cuda``;
the run raises when CUDA is missing unless ``--device cpu`` was given) and
``--use_pallas_head``, which sets the model's ``use_pallas_head``: the f32
classifier then runs through the CUDA fused-dense kernel.  Images are the
port's synthetic ImageNet-shaped stream (``--data_dir`` records are a later
slice's); the held-out eval stream shares the training task
(``template_seed=0``) with other samples (``seed=10000``).  With
``--checkpoint_dir`` the run restores the newest checkpoint there, saves on
the policy (every 60 s) and at the end.

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
    make_lr_schedule,
    metrics_sink,
    open_checkpointer,
)
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
                   help="held-out synthetic batches scored after training (0 = skip); in "
                        "--target_accuracy mode, the batches of each mid-run eval")
    p.add_argument("--target_accuracy", type=float, default=None,
                   help="stop when held-out top-1 reaches this (eval every --eval_every steps)")
    p.add_argument("--full_eval", action=argparse.BooleanOptionalAction, default=True,
                   help="score the target gate on a whole staged split (record data only; "
                        "synthetic runs are unaffected)")
    p.add_argument("--eval_every", type=int, default=0,
                   help="steps between held-out evals in --target_accuracy mode "
                        "(default: --steps/10)")
    p.add_argument("--use_pallas_head", action="store_true",
                   help="run the f32 classifier through the fused-dense kernel")
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
    batches, input_stats, augment = device_image_pipeline(args, shape, ds)
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
    sample = next(iter(batches(1)))
    state = trainer.init(seed=0)
    if ckpt is not None:
        ckpt.restore_latest(state)
    logger = trainer.throughput_logger(
        sample.x, examples_per_step=batch, name=f"resnet{args.depth}",
        sink=metrics_sink(args, f"resnet{args.depth}"), log_every=args.log_every,
    )

    def eval_batches(steps):
        held_out = SyntheticDataset(shape=shape, num_classes=1000, batch_size=batch,
                                    seed=10_000, template_seed=0)
        return held_out.batches(steps)

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
                                              prefetch_workers=args.prefetch_workers)
            losses.extend(chunk_losses)
            done += chunk
            ev = trainer.evaluate(state, eval_batches(eval_steps), steps=eval_steps)
            evals.append({"step": done, "split": "heldout-synthetic", **ev})
            reached = float(ev.get("accuracy", 0.0)) >= args.target_accuracy
        result.update(eval_history=evals, target_reached=reached, eval=evals[-1])
    else:
        state, losses = trainer.fit(state, batches(args.steps), steps=args.steps, logger=logger,
                                    checkpointer=ckpt, prefetch_workers=args.prefetch_workers)
        if args.eval_steps:
            result["eval"] = {"split": "heldout-synthetic",
                              **trainer.evaluate(state, eval_batches(args.eval_steps),
                                                 steps=args.eval_steps)}
    close_checkpointer(ckpt, state)
    if logger.sink is not None:
        logger.sink.close()
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
