"""BERT masked-LM pretraining on one device — counterpart of
``deeplearning_cfn_tpu/examples/bert_pretrain.py``.

The same flags and the same result dict, plus ``--device`` (default ``cuda``;
the run raises when CUDA is missing unless ``--device cpu`` was given) and
``--use_pallas_mlp``, which sets ``BertConfig.use_pallas_mlp``: the MLP then
runs through the CUDA fused-dense kernel.  Throughput is in sequences a
second.

Run: ``python -m deeplearning_cfn_tpu_torch.examples.bert_pretrain --use_pallas_mlp --seq_len 128 --global_batch_size 32``
"""

from __future__ import annotations

import dataclasses
import math

from deeplearning_cfn_tpu_torch.device import resolve_device
from deeplearning_cfn_tpu_torch.examples.common import (
    base_parser,
    close_checkpointer,
    first_step_clock,
    metrics_sink,
    open_checkpointer,
)
from deeplearning_cfn_tpu_torch.models import bert
from deeplearning_cfn_tpu_torch.train.data import SyntheticMLMDataset
from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

_LATER = "a later slice of the PyTorch port"


def main(argv: list[str] | None = None) -> dict:
    t_main = first_step_clock()
    p = base_parser(__doc__)
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--tiny", action="store_true", help="tiny config for smokes")
    p.add_argument("--vocab_size", type=int, default=None,
                   help="override the tiny config's vocabulary")
    p.add_argument("--eval_steps", type=int, default=0,
                   help="held-out synthetic batches scored after training (0 = skip)")
    p.add_argument("--use_pallas_mlp", action="store_true",
                   help="run the MLP through the fused-dense kernel")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.data_dir:
        raise NotImplementedError(f"--data_dir (record data) is ported in {_LATER}")
    device = resolve_device(args.device)
    if args.tiny:
        cfg = bert.BertConfig.tiny(seq_len=args.seq_len, vocab_size=args.vocab_size or 256)
    else:
        if args.vocab_size:
            raise SystemExit(
                "--vocab_size only applies with --tiny; BertConfig.base() is the "
                "fixed published 30522-token shape"
            )
        cfg = bert.BertConfig.base()
    cfg = dataclasses.replace(cfg, use_pallas_mlp=args.use_pallas_mlp)
    batch = args.global_batch_size or 8
    trainer = bert.make_trainer(
        cfg,
        TrainerConfig(
            strategy=args.strategy,
            optimizer="adamw",
            learning_rate=args.learning_rate or 1e-4,
            weight_decay=0.01,
            grad_clip_norm=1.0,
            grad_accum_steps=args.grad_accum,
            log_every=args.log_every,
        ),
        device=device,
    )
    ckpt, start_step = open_checkpointer(args)
    ds = SyntheticMLMDataset(seq_len=args.seq_len, vocab_size=cfg.vocab_size, batch_size=batch)
    sample = next(iter(ds.batches(1)))
    state = trainer.init(seed=0)
    if ckpt is not None:
        ckpt.restore_latest(state)
    logger = trainer.throughput_logger(
        sample.x, examples_per_step=batch, name="bert", sink=metrics_sink(args, "bert"),
        log_every=args.log_every,
    )
    state, losses = trainer.fit(state, ds.batches(args.steps), steps=args.steps, logger=logger,
                                checkpointer=ckpt)
    close_checkpointer(ckpt, state)
    if logger.sink is not None:
        logger.sink.close()
    result = {
        "final_loss": losses[-1],
        "steps": len(losses),
        "start_step": start_step,
        "end_step": state.step,
        "device": str(device),
        "params": bert.param_count(cfg),
        "first_step_s": first_step_clock(trainer, t_main),
        "history": logger.history,
    }
    if args.eval_steps:
        eval_ds = SyntheticMLMDataset(
            seq_len=args.seq_len, vocab_size=cfg.vocab_size, batch_size=batch, seed=10_000
        )
        ev = trainer.evaluate(state, eval_ds.batches(args.eval_steps), steps=args.eval_steps)
        # Masked-token perplexity: exp of the mean NLL over masked positions.
        ev["perplexity"] = math.exp(min(ev["loss"], 700.0)) if "loss" in ev else None
        result["eval"] = {"split": "heldout-synthetic", **ev}
    return result


if __name__ == "__main__":
    print(main())
