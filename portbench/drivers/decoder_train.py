"""Decoder training through the program's ``Trainer.fit``, eager.

The program is the port's ``models/llama.py`` at the configuration's sizes,
its weights the benchmark's (drawn from the seed on the card, bf16), AdamW
as the configuration's ``training`` block states, one step a call with the
loss read back after each.  The checks: the loss of each of the first
``reference_steps`` steps; each leaf's first gradient as AdamW got it,
read from its first moment after step 1 (``exp_avg = (1−β1)·g``); each
leaf's change after ``reference_steps`` steps; all against
``reference/decoder.py`` on the same weights and batches."""

from __future__ import annotations

import gc

import torch

from portbench import compare, flops, traffic, weights
from portbench.reference import decoder as ref
from portbench.reference.lowp import no_tf32
from portbench.training import optimizer_state, record_checks, run_window


def leaves(cfg: dict) -> dict:
    std = cfg["initializer_range"]
    return {n: (s, None if ref.is_norm(n) else std, 1.0) for n, s in ref.param_shapes(cfg).items()}


def program_config(cfg: dict, tr: dict):
    from deeplearning_cfn_tpu_torch.models import llama

    prog = cfg["program"]
    return llama.LlamaConfig(
        vocab_size=cfg["vocab_size"], dim=cfg["hidden_size"], n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
        mlp_dim=cfg["intermediate_size"], max_seq_len=tr["seq_len"], rope_theta=cfg["rope_theta"],
        norm_eps=cfg["rms_norm_eps"], dtype=getattr(torch, prog["dtype"]), remat=prog["remat"],
        remat_policy=prog["remat_policy"], tied_embeddings=cfg["tie_word_embeddings"],
        use_flash_attention=prog["use_flash_attention"])


def run(r) -> None:
    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.train.data import Batch
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    cfg, tr, opt = r.config, r.traffic, r.config["training"]
    dtype = getattr(torch, cfg["program"]["dtype"])
    lcfg = program_config(cfg, tr)
    if lcfg.head_dim != cfg["head_dim"]:
        raise ValueError(f"head_dim {cfg['head_dim']} is not hidden_size / heads")
    trainer = llama.make_trainer(lcfg, TrainerConfig(
        strategy="fsdp", optimizer="adamw", learning_rate=opt["learning_rate"],
        weight_decay=opt["weight_decay"], grad_clip_norm=opt["grad_clip_norm"], log_every=1),
        device=r.device)
    with torch.device("meta"):
        model = llama.Llama(lcfg)
    model = model.to_empty(device=r.device)
    weights.load_into(model, weights.draw(leaves(cfg), r.seed, r.device, dtype))
    state = trainer.init_from(model)
    pool = traffic.pool_for(tr, cfg, r.seed)
    n_ref = tr["reference_steps"]
    params = dict(model.named_parameters())
    seen: dict = {}

    def after_first():
        b1 = opt["betas"][0]
        seen["first_grad"] = {
            n: float(optimizer_state(state, p, "exp_avg").float().norm()) / (1 - b1)
            for n, p in params.items()}

    def after_reference_steps():
        start = weights.draw(leaves(cfg), r.seed, r.device, dtype)
        with torch.no_grad():
            seen["change"] = {n: float((p.float() - start[n].float()).norm())
                              for n, p in params.items()}
        del start

    batches = (Batch(x=x.astype("int32"), y=y.astype("int32")) for x, y in traffic.cycle(pool))
    losses = run_window(r, trainer, state, batches, steps_per_call=1,
                        warmup_steps=max(tr["warmup_steps"], n_ref + 1),
                        hooks={1: after_first, n_ref: after_reference_steps},
                        prefetch=tr["prefetch"])
    r.flops_per_step = (flops.decoder_train_flops_per_token(cfg, tr["seq_len"])
                        * tr["global_batch"] * tr["seq_len"])
    seen["losses"] = losses[:n_ref]
    r.notes["program_losses"] = seen["losses"]
    r.probe({"model": model, "trainer": trainer})
    del params, state, model, trainer
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    record_checks(r, *numbers(seen, reference_readings(r, pool)))


def reference_readings(r, pool, precision: str = "f32", rows=None) -> dict:
    """The reference's readings on the run's weights (drawn again, in the
    type they are served in) and its first batches."""
    cfg, tr = r.config, r.traffic
    start = weights.draw(leaves(cfg), r.seed, r.device, getattr(torch, cfg["program"]["dtype"]))
    batches = [(torch.from_numpy(x).to(r.device), torch.from_numpy(y).to(r.device))
               for x, y in pool[:tr["reference_steps"]]]
    with no_tf32():
        return ref.train(cfg, start, batches, tr["reference_steps"], precision, rows)


def numbers(seen: dict, reading: dict) -> tuple[list[tuple[str, float]], dict]:
    """The compared numbers of ``seen`` (the program's readings, or a
    control's) against the f32 reference's ``reading``, and what to note."""
    kept = compare.kept_leaves(reading["first_grad"])
    grad, grad_leaf = compare.worst_leaf_gap(seen["first_grad"], reading["first_grad"], kept)
    change, change_leaf = compare.worst_leaf_gap(seen["change"], reading["change"], kept)
    notes = {"worst_leaves": {"grad_gap": grad_leaf, "change_gap": change_leaf},
             "left_out": sorted(set(reading["first_grad"]) - kept),
             "reference_losses": reading["losses"]}
    return [("loss_gap", compare.loss_gap(seen["losses"], reading["losses"])),
            ("grad_gap", grad), ("change_gap", change),
            ("grad_median_gap", compare.median_leaf_gap(seen["first_grad"], reading["first_grad"], kept)),
            ("change_median_gap", compare.median_leaf_gap(seen["change"], reading["change"], kept))
            ], notes
