"""BERT masked-LM pretraining on one device — counterpart of
``deeplearning_cfn_tpu/examples/bert_pretrain.py``.

The same flags and the same result dict, plus ``--device`` (default ``cuda``;
the run raises when CUDA is missing unless ``--device cpu`` was given) and
``--use_pallas_mlp``, which sets ``BertConfig.use_pallas_mlp``: the MLP then
runs through the CUDA fused-dense kernel.  Throughput is in sequences a
second.  ``--data_dir`` trains on token records (``cli convert --format
text``), masked on the fly with the first id past the data vocabulary
(``mask_token`` in the result); ``--eval_steps`` then scores the held-out
split with masks from a fixed seed.

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
    has_heldout_split,
    log,
    metrics_sink,
    open_checkpointer,
    token_record_loader,
)
from deeplearning_cfn_tpu_torch.models import bert
from deeplearning_cfn_tpu_torch.train.data import SyntheticMLMDataset
from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig


def mlm_record_batches(args, cfg, batch: int, eval_mode: bool = False, start_step: int = 0):
    """``(batches_fn, mask_token)`` of token records masked on the fly for
    MLM when ``--data_dir`` is set; None = synthetic.  The mask id is one
    reserved past the data vocabulary (byte 0 and tokenizer id 0 are real
    tokens).  Eval reads the held-out split with masks from a fixed seed
    apart from training's, so every eval of a checkpoint masks the same
    positions."""
    from deeplearning_cfn_tpu_torch.train.datasets import mlm_batches

    loaded = token_record_loader(args, batch, cfg.vocab_size, eval_mode=eval_mode,
                                 reserve_ids=1, start_step=start_step)
    if loaded is None:
        return None
    loader, spec, data_vocab = loaded
    if data_vocab:
        mask_token = data_vocab  # the first id past the data vocabulary
    else:
        mask_token = 0
        log.warning("no tokenizer sidecar under --data_dir: using mask id 0, which may "
                    "collide with a real token; reconvert with `cli convert --format text` "
                    "to pin the vocabulary")
    seed = 10_000 if eval_mode else 0
    return (lambda steps: mlm_batches(loader, spec, steps, mask_token=mask_token, seed=seed),
            mask_token)


def main(argv: list[str] | None = None) -> dict:
    t_main = first_step_clock()
    p = base_parser(__doc__)
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--tiny", action="store_true", help="tiny config for smokes")
    p.add_argument("--vocab_size", type=int, default=None,
                   help="override the tiny config's vocabulary (byte-level token records "
                        "need >= 258: 257 data ids and the reserved mask id)")
    p.add_argument("--eval_steps", type=int, default=0,
                   help="held-out batches for masked-LM loss, accuracy and perplexity after "
                        "training (0 = skip; reads the val/test split of --data_dir when "
                        "there is one, with fixed eval masks)")
    p.add_argument("--use_pallas_mlp", action="store_true",
                   help="run the MLP through the fused-dense kernel")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
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
    records = mlm_record_batches(args, cfg, batch, start_step=start_step)
    batches, mask_token = records if records is not None else (ds.batches, None)
    # As in the JAX example, the sample is the stream's first batch.
    sample = next(iter(batches(1)))
    state = trainer.init(seed=0)
    if ckpt is not None:
        ckpt.restore_latest(state)
    logger = trainer.throughput_logger(
        sample.x, examples_per_step=batch, name="bert", sink=metrics_sink(args, "bert"),
        log_every=args.log_every,
    )
    state, losses = trainer.fit(state, batches(args.steps), steps=args.steps, logger=logger,
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
    if mask_token is not None:
        result["mask_token"] = mask_token
    if args.eval_steps:
        records = mlm_record_batches(args, cfg, batch, eval_mode=True)
        if records is None:
            eval_ds = SyntheticMLMDataset(
                seq_len=args.seq_len, vocab_size=cfg.vocab_size, batch_size=batch, seed=10_000
            )
            eval_batches, split = eval_ds.batches, "heldout-synthetic"
        else:
            eval_batches = records[0]
            split = "heldout" if has_heldout_split(args.data_dir) else "train"
        ev = trainer.evaluate(state, eval_batches(args.eval_steps), steps=args.eval_steps)
        # Masked-token perplexity: exp of the mean NLL over masked positions.
        ev["perplexity"] = math.exp(min(ev["loss"], 700.0)) if "loss" in ev else None
        result["eval"] = {"split": split, **ev}
    return result


if __name__ == "__main__":
    print(main())
