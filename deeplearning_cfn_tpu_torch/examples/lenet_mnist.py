"""LeNet on MNIST-shaped images, the first-training-run walkthrough —
counterpart of ``deeplearning_cfn_tpu/examples/lenet_mnist.py``.

The same flags and result dict, plus ``--device`` (default ``cuda``; the run
raises when CUDA is missing unless ``--device cpu`` was given).  Images are
the synthetic MNIST-shaped stream (``SyntheticDataset.mnist_like``); several
processes of the cluster contract's env train over ``default_mesh``.

Run: ``python -m deeplearning_cfn_tpu_torch.examples.lenet_mnist --steps 100``
"""

from __future__ import annotations

import torch.distributed as dist

from deeplearning_cfn_tpu_torch.device import resolve_device
from deeplearning_cfn_tpu_torch.examples.common import (
    base_parser,
    default_mesh,
    first_step_clock,
    maybe_init_distributed,
    metrics_sink,
)
from deeplearning_cfn_tpu_torch.models.lenet import LeNet
from deeplearning_cfn_tpu_torch.train.data import SyntheticDataset
from deeplearning_cfn_tpu_torch.train.metrics import ThroughputLogger
from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig


def main(argv: list[str] | None = None) -> dict:
    t_main = first_step_clock()
    p = base_parser(__doc__)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    maybe_init_distributed(args.device)
    batch = args.global_batch_size or 64
    lr = args.learning_rate or 0.05
    mesh = default_mesh(args.strategy) if dist.is_initialized() else None
    trainer = Trainer(
        lambda g: LeNet(num_classes=10, generator=g),
        TrainerConfig(
            strategy=args.strategy,
            learning_rate=lr,
            # Small f32 model: f32 products (no TF32), as the JAX example pins.
            matmul_precision="float32",
            grad_accum_steps=args.grad_accum,
            log_every=args.log_every,
        ),
        device=device,
        mesh=mesh,
    )
    ds = SyntheticDataset.mnist_like(batch_size=batch)
    state = trainer.init(seed=0)
    logger = ThroughputLogger(global_batch_size=batch, log_every=args.log_every, name="lenet",
                              sink=metrics_sink(args, "lenet"))
    state, losses = trainer.fit(state, ds.batches(args.steps), steps=args.steps, logger=logger)
    if logger.sink is not None:
        logger.sink.close()
    return {
        "final_loss": losses[-1],
        "steps": len(losses),
        "history": logger.history,
        "device": str(trainer.device),
        "first_step_s": first_step_clock(trainer, t_main),
    }


if __name__ == "__main__":
    print(main())
