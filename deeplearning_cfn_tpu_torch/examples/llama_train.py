"""Llama causal-LM training over the mesh of the processes that run it —
counterpart of ``deeplearning_cfn_tpu/examples/llama_train.py``.

The same flags, the same mesh arithmetic and the same result dict.  One
process trains on one device; processes started with the cluster contract's
env (``examples.common.maybe_init_distributed``) train over a mesh of
``--fsdp`` (default: every rank left after the other axes), ``--tp``,
``--sp``, ``--ep`` and dp (what remains), the experts of ``--experts``
split over ``ep``; ``--ring_attention`` runs attention as a ring over
``sp``; ``--pp`` splits the layers into that many GPipe stages
(``--pp_microbatches`` a step, default ``--pp``).  ``--device``
(default ``cuda``) picks the device, and the run raises when CUDA is missing
unless ``--device cpu`` was given.  At ``--seq_len`` 2048 and up, the
flash-attention presets (435m, 1b, 3b) run attention through the CUDA flash
kernel, as does ``--size 8b`` (Llama-3-8B, its weights drawn on the card).
``--data_dir`` trains on token records (``cli convert --format
text``) through the native loader, from the resumed step with
``--checkpoint_dir``; ``--eval_steps`` then scores the held-out split (the
val/test records when there are any).  The result's ``kernel_launches``
counts the port's kernel launches over the training run (``ops._kernels``'
counters, by kernel and by variant), so a process that ran the job, such as
``cli run``, can show which kernels its path went through.

Run: ``python -m deeplearning_cfn_tpu_torch.examples.llama_train --size 435m --seq_len 2048``
"""

from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist

from deeplearning_cfn_tpu_torch.device import resolve_device
from deeplearning_cfn_tpu_torch.examples.common import (
    base_parser,
    close_checkpointer,
    first_step_clock,
    has_heldout_split,
    make_lr_schedule,
    maybe_init_distributed,
    metrics_sink,
    open_checkpointer,
    synthetic_from,
    token_record_loader,
)
from deeplearning_cfn_tpu_torch.models import llama
from deeplearning_cfn_tpu_torch.ops import _kernels
from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from deeplearning_cfn_tpu_torch.train.data import SyntheticTokenDataset
from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

#: Past this many parameters the weights are drawn on the trainer's device:
#: a billion normals take the host a minute or more.
DEVICE_DRAW_PARAMS = 10**9


def token_record_batches(args, cfg, batch: int, eval_mode: bool = False, start_step: int = 0):
    """Token records (``cli convert --format text``) as causal-LM batches
    when ``--data_dir`` is set; None = synthetic."""
    from deeplearning_cfn_tpu_torch.train.datasets import token_batches

    loaded = token_record_loader(args, batch, cfg.vocab_size, eval_mode, start_step=start_step)
    if loaded is None:
        return None
    loader, spec, _ = loaded
    return lambda steps: token_batches(loader, spec, steps)


def main(argv: list[str] | None = None) -> dict:
    t_main = first_step_clock()
    p = base_parser(__doc__)
    p.add_argument("--size", choices=["tiny", "435m", "1b", "3b", "8b"], default="tiny")
    p.add_argument("--seq_len", type=int, default=512)
    p.add_argument("--optimizer", choices=["adamw", "adafactor"], default="adamw",
                   help="adafactor: factored second moments, no first moment (the "
                        "memory-lean rung)")
    p.add_argument("--fsdp", type=int, default=None,
                   help="fsdp axis size (default: every rank left after the other axes)")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--ring_attention", action="store_true")
    p.add_argument("--fused_qkv", action="store_true",
                   help="fuse q/k/v and gate/up projections into single wider matmuls")
    p.add_argument("--pp", type=int, default=1, help="pipeline stages")
    p.add_argument("--pp_microbatches", type=int, default=0)
    p.add_argument("--experts", type=int, default=0, help="MoE experts (0 = dense)")
    p.add_argument("--ep", type=int, default=1, help="expert-parallel axis size")
    p.add_argument("--eval_steps", type=int, default=0,
                   help="held-out batches for corpus perplexity after training (0 = skip; "
                        "reads the val/test split of --data_dir when there is one)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    maybe_init_distributed(args.device)

    n = dist.get_world_size() if dist.is_initialized() else 1
    tp, sp, pp, ep = args.tp, args.sp, args.pp, args.ep
    fsdp = args.fsdp or max(1, n // (tp * sp * pp * ep))
    dp = max(1, n // (fsdp * tp * sp * pp * ep))
    spec = MeshSpec(dp=dp, fsdp=fsdp, pp=pp, sp=sp, tp=tp, ep=ep).validate(n)
    mesh = build_mesh(spec) if dist.is_initialized() else None

    if args.size == "8b":
        # JAX's 8B config leaves attention to XLA on the TPU; on the card the
        # materialised path would hold [32, S, S] f32 scores a block, so the
        # 8B run takes the flash kernel, as the other presets do from 2048.
        cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), use_flash_attention=True)
    elif args.size == "3b":
        cfg = llama.LlamaConfig.b3(seq_len=args.seq_len)
    elif args.size == "1b":
        cfg = llama.LlamaConfig.b1(seq_len=args.seq_len)
    elif args.size == "435m":
        cfg = llama.LlamaConfig.m435(seq_len=args.seq_len)
    else:
        cfg = llama.LlamaConfig.tiny(vocab_size=512, seq_len=args.seq_len)
    if args.ring_attention:
        cfg = dataclasses.replace(cfg, use_ring_attention=True)
    if args.fused_qkv:
        cfg = dataclasses.replace(cfg, fused_qkv=True)
    if args.experts:
        cfg = dataclasses.replace(cfg, n_experts=args.experts)
    if pp > 1:
        cfg = dataclasses.replace(cfg, pp_stages=pp, pp_microbatches=args.pp_microbatches)

    # Default batch: divisible by the data shards and by the pipeline's
    # microbatch count, as the JAX example's.
    microbatches = (args.pp_microbatches or pp) if pp > 1 else 1
    batch = args.global_batch_size or max(1, dp * fsdp) * microbatches
    # Per-optimizer default: adafactor's clipped, parameter-scaled updates
    # want a much larger step than the adam family (the JAX example's sweep).
    lr = args.learning_rate or (1e-2 if args.optimizer == "adafactor" else 3e-4)
    trainer = llama.make_trainer(
        cfg,
        TrainerConfig(
            strategy="fsdp",
            optimizer=args.optimizer,
            learning_rate=lr,
            lr_schedule=make_lr_schedule(args, lr),
            weight_decay=args.weight_decay if args.weight_decay is not None else 0.1,
            grad_clip_norm=1.0,
            grad_accum_steps=args.grad_accum,
            log_every=args.log_every,
        ),
        device=device,
        mesh=mesh,
    )
    ckpt, start_step = open_checkpointer(args)
    ds = SyntheticTokenDataset(seq_len=args.seq_len, vocab_size=cfg.vocab_size, batch_size=batch)
    batches = (token_record_batches(args, cfg, batch, start_step=start_step)
               or synthetic_from(ds.batches, start_step))
    # As in the JAX example, the sample is the stream's first batch: record
    # runs train from the next one (a resumed run too, so its stream lines
    # up with the straight run's).
    sample = next(iter(batches(1)))
    # (A trainer on the CPU draws on the host either way.)
    big = llama.param_count(cfg) > DEVICE_DRAW_PARAMS
    state = trainer.init(seed=0, **({"draw_on_device": True} if big else {}))
    if ckpt is not None:
        ckpt.restore_latest(state)
    logger = trainer.throughput_logger(
        sample.x,
        examples_per_step=batch * args.seq_len,  # tokens/sec
        name="llama",
        sink=metrics_sink(args, "llama"),
        log_every=args.log_every,
    )
    launches_before = dict(_kernels.launch_counts)
    state, losses = trainer.fit(state, batches(args.steps), steps=args.steps, logger=logger,
                                checkpointer=ckpt)
    launches = {k: v - launches_before.get(k, 0) for k, v in _kernels.launch_counts.items()}
    close_checkpointer(ckpt, state)
    if logger.sink is not None:
        logger.sink.close()
    result = {
        "final_loss": losses[-1],
        "steps": len(losses),
        "start_step": start_step,
        "end_step": state.step,
        "device": str(trainer.device),
        "mesh": spec.axis_sizes(),
        "params": llama.param_count(cfg),
        "active_params": llama.active_param_count(cfg),
        "first_step_s": first_step_clock(trainer, t_main),
        "history": logger.history,
        "kernel_launches": {k: n for k, n in launches.items() if n},
    }
    if cfg.moe is not None:
        result["moe_aux_loss"] = float(trainer.last_metrics["moe_aux_loss"])
    if args.eval_steps:
        eval_batches = token_record_batches(args, cfg, batch, eval_mode=True)
        if eval_batches is None:
            eval_ds = SyntheticTokenDataset(
                seq_len=args.seq_len, vocab_size=cfg.vocab_size, batch_size=batch, seed=10_000
            )
            eval_batches, split = eval_ds.batches, "heldout-synthetic"
        else:
            split = "heldout" if has_heldout_split(args.data_dir) else "train"
        ev = trainer.evaluate(state, eval_batches(args.eval_steps), steps=args.eval_steps)
        # exp of the mean NLL, capped so a diverged run still reports.
        ev["perplexity"] = math.exp(min(ev["loss"], 700.0)) if "loss" in ev else None
        result["eval"] = {"split": split, **ev}
    return result


if __name__ == "__main__":
    print(main())
