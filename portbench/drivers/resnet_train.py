"""ResNet training through the program's ``Trainer.fit``, captured.

The program is the port's ``models/resnet.py`` at the configuration's
sizes (bf16 compute, the f32 fused-dense head when ``use_pallas_head``),
its weights the benchmark's (drawn from the seed on the card, f32), SGD
with Nesterov momentum, uint8 images normalised inside the step, and
``steps_per_call`` steps captured as one CUDA graph a call, the losses read
back every ``log_every`` steps.  Over several
ranks (``strategy="dp"``) each rank takes its slice of the global batch,
the gradients go through the program's bucketed sync and BatchNorm's
statistics are the global batch's.

A captured call is indivisible, so the state is read after the first call:
the loss of each of its steps, each leaf's momentum trace (the
optimizer's state) and each leaf's change, against
``reference/resnet.py`` on the same weights and the same global batches."""

from __future__ import annotations

import gc
import math

import torch

from portbench import compare, flops, traffic, weights
from portbench.reference import resnet as ref
from portbench.reference.lowp import no_tf32
from portbench.training import optimizer_state, record_checks, run_window


def leaves(cfg: dict) -> dict:
    model = ref.ReferenceResNet(cfg)
    out = {}
    for n, s in model.param_shapes().items():
        const = model.initial_value(n)
        std = None if const is not None else math.sqrt(1.0 / model.fan_in(s))
        out[n] = (s, std, const)
    return out


def run(r) -> None:
    from deeplearning_cfn_tpu_torch.models import resnet
    from deeplearning_cfn_tpu_torch.train.data import Batch
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg, tr, opt = r.config, r.traffic, r.config["training"]
    prog = cfg["program"]
    k = opt["steps_per_call"]
    n_ref = tr["reference_steps"]
    if n_ref != k:
        raise ValueError("the checks read the state after the first captured call: "
                         "reference_steps must equal steps_per_call")
    mesh = None
    if r.world > 1:
        from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec, build_mesh

        mesh = build_mesh(MeshSpec(dp=r.world))
    with torch.device("meta"):
        model = resnet.ResNet(stage_sizes=tuple(cfg["stage_sizes"]),
                              num_classes=cfg["num_classes"], num_filters=cfg["num_filters"],
                              dtype=getattr(torch, prog["dtype"]), norm="batch",
                              use_pallas_head=prog["use_pallas_head"])
    model = model.to_empty(device=r.device)
    weights.load_into(model, weights.draw(leaves(cfg), r.seed, r.device, torch.float32),
                      buffers={".mean": 0.0, ".var": 1.0})
    mean, std = opt["input_stats"]
    trainer = Trainer(lambda gen: model, TrainerConfig(
        strategy="dp", optimizer="momentum", momentum=opt["momentum"],
        learning_rate=opt["learning_rate"], weight_decay=opt["weight_decay"],
        has_train_arg=True, label_smoothing=opt["label_smoothing"],
        log_every=opt["log_every"],
        input_stats=(tuple(mean), tuple(std))), device=r.device, mesh=mesh)
    state = trainer.init_from(model)
    pool = traffic.pool_for(tr, cfg, r.seed)
    params = dict(model.named_parameters())
    seen: dict = {}

    def after_first_call():
        seen["trace"] = {n: float(optimizer_state(state, p, "momentum_buffer").norm())
                         for n, p in params.items()}
        start = weights.draw(leaves(cfg), r.seed, r.device, torch.float32)
        with torch.no_grad():
            seen["change"] = {n: float((p - start[n]).norm()) for n, p in params.items()}
        del start

    batches = (Batch(x=x, y=y.astype("int32")) for x, y in traffic.cycle(pool))
    losses = run_window(r, trainer, state, batches, steps_per_call=k,
                        warmup_steps=max(tr["warmup_steps"], 2 * k), hooks={k: after_first_call},
                        prefetch=tr["prefetch"])
    r.flops_per_step = flops.resnet_train_flops(cfg, tr["global_batch"], tr["image_size"])
    r.probe({"model": model, "trainer": trainer})
    del params, state, model, trainer
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    seen["losses"] = losses[:k]
    r.notes["program_losses"] = seen["losses"]
    if r.rank == 0:
        record_checks(r, *numbers(seen, reference_readings(r, pool)))


def reference_readings(r, pool, precision: str = "f32", rows=None) -> dict:
    cfg, tr = r.config, r.traffic
    start = weights.draw(leaves(cfg), r.seed, r.device, torch.float32)
    batches = [(torch.from_numpy(x).to(r.device), torch.from_numpy(y).to(r.device))
               for x, y in pool[:tr["reference_steps"]]]
    with no_tf32():
        return ref.train(cfg, start, batches, tr["reference_steps"], precision, rows)


def numbers(seen: dict, reading: dict) -> tuple[list[tuple[str, float]], dict]:
    """The compared numbers of ``seen`` (the program's readings, or a
    control's) against the f32 reference's ``reading``, and what to note."""
    kept = compare.kept_leaves(reading["trace"])
    trace, trace_leaf = compare.worst_leaf_gap(seen["trace"], reading["trace"], kept)
    change, change_leaf = compare.worst_leaf_gap(seen["change"], reading["change"], kept)
    notes = {"worst_leaves": {"trace_gap": trace_leaf, "change_gap": change_leaf},
             "left_out": sorted(set(reading["trace"]) - kept),
             "reference_losses": reading["losses"]}
    return [("loss_gap", compare.loss_gap(seen["losses"], reading["losses"])),
            ("trace_gap", trace), ("change_gap", change),
            ("trace_median_gap", compare.median_leaf_gap(seen["trace"], reading["trace"], kept)),
            ("change_median_gap", compare.median_leaf_gap(seen["change"], reading["change"], kept))
            ], notes
