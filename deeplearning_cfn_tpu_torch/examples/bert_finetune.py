"""BERT sequence-classification fine-tuning on one device — counterpart of
``deeplearning_cfn_tpu/examples/bert_finetune.py``.

Optionally runs MLM pretraining in the same process, transfers the encoder
trunk into a classifier (``models.bert.transfer_trunk_params``), fine-tunes
it on a labelled synthetic task with the trainer's default classification
objective, and reports held-out accuracy.  ``--device`` as in
``bert_pretrain``.

Run: ``python -m deeplearning_cfn_tpu_torch.examples.bert_finetune --tiny --pretrain_steps 50 --steps 100``
"""

from __future__ import annotations

from functools import partial

from deeplearning_cfn_tpu_torch.device import resolve_device
from deeplearning_cfn_tpu_torch.examples.common import base_parser, metrics_sink
from deeplearning_cfn_tpu_torch.models import bert
from deeplearning_cfn_tpu_torch.train.data import (
    SyntheticMLMDataset,
    SyntheticSeqClassificationDataset,
)
from deeplearning_cfn_tpu_torch.train.metrics import ThroughputLogger
from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig


def main(argv: list[str] | None = None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--seq_len", type=int, default=64)
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--pretrain_steps", type=int, default=0,
                   help="MLM pretraining steps before the trunk transfer "
                        "(0 = fine-tune from random init)")
    p.add_argument("--eval_steps", type=int, default=4)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = bert.BertConfig.tiny(seq_len=args.seq_len) if args.tiny else bert.BertConfig.base()
    batch = args.global_batch_size or 8

    pretrained = None
    if args.pretrain_steps:
        pre_trainer = bert.make_trainer(
            cfg,
            TrainerConfig(strategy=args.strategy, optimizer="adamw", learning_rate=1e-3,
                          grad_clip_norm=1.0, log_every=args.log_every),
            device=device,
        )
        mlm = SyntheticMLMDataset(batch_size=batch, seq_len=args.seq_len, vocab_size=cfg.vocab_size)
        pre_state = pre_trainer.init(seed=0)
        pre_state, _ = pre_trainer.fit(
            pre_state, mlm.batches(args.pretrain_steps), steps=args.pretrain_steps
        )
        pretrained = pre_state.model.state_dict()

    trainer = Trainer(
        partial(bert.BertClassifier, cfg, args.num_classes),
        TrainerConfig(
            strategy=args.strategy,
            optimizer="adamw",
            learning_rate=args.learning_rate or 3e-4,
            grad_clip_norm=1.0,
            grad_accum_steps=args.grad_accum,
            log_every=args.log_every,
        ),
        device=device,
    )
    ds = SyntheticSeqClassificationDataset(
        batch_size=batch, seq_len=args.seq_len, vocab_size=cfg.vocab_size,
        num_classes=args.num_classes,
    )
    state = trainer.init(seed=1)
    if pretrained is not None:
        state.model.load_state_dict(
            bert.transfer_trunk_params(pretrained, state.model.state_dict())
        )
    sink = metrics_sink(args, "bert-ft")
    logger = ThroughputLogger(
        global_batch_size=batch, log_every=args.log_every, name="bert-ft", sink=sink
    )
    state, losses = trainer.fit(state, ds.batches(args.steps), steps=args.steps, logger=logger)
    held_out = SyntheticSeqClassificationDataset(
        batch_size=batch, seq_len=args.seq_len, vocab_size=cfg.vocab_size,
        num_classes=args.num_classes, seed=10_000, template_seed=0,
    )
    eval_metrics = trainer.evaluate(state, held_out.batches(args.eval_steps), steps=args.eval_steps)
    if sink is not None:
        sink.write({"event": "eval", "run": "bert-ft", **eval_metrics})
        sink.close()
    return {
        "final_loss": losses[-1],
        "steps": len(losses),
        "pretrained": bool(args.pretrain_steps),
        "eval": eval_metrics,
    }


if __name__ == "__main__":
    print(main())
