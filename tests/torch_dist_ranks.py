"""One rank of the port's multi-rank CPU checks (``test_torch_distributed.py``).

Run as a process of the cluster contract's env (``DEEPLEARNING_WORKERS_COUNT``,
``DLCFN_PROCESS_ID``, ``DEEPLEARNING_COORDINATOR``): it joins a gloo group
through ``examples.common.maybe_init_distributed``, then for each case of the
pickled input file builds the case's mesh, loads the JAX package's initial
weights (numpy, computed by the test), takes the global norm of the first
batch's gradients, runs the case's trainer steps, and writes what it saw to
``<input>.rank<id>``.  A checkpoint case (``mode``) saves after its first
steps, or restores and takes the rest.  A case with a ``model`` (ResNet,
BERT, RetinaNet) loads the port's state dict the test converted from the JAX
weights and reports every step's metrics and the final state.  A ``ring``
case runs ``parallel.ring_attention`` on this rank's block of the sequence
and reports its output and gradients; an ``argv`` case runs
``examples.llama_train.main`` with its flags.  A ``toy_pipeline`` case runs
``parallel.pipeline`` on a tanh stack; ``int8`` and ``sharded`` cases run
one bucket through ``parallel.overlap``'s exchanges.  A Llama case may be
pipelined (``pp`` in its mesh: each rank loads its stage from the JAX
stage-stacked weights), run with ``comms_overlap`` (the buckets it issued
reported), or built on a hybrid mesh (``hybrid``: ICI and DCN specs).  It
imports no JAX.

    python tests/torch_dist_ranks.py <input.pkl>
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.examples.common import maybe_init_distributed  # noqa: E402
from deeplearning_cfn_tpu_torch.models import llama  # noqa: E402
from deeplearning_cfn_tpu_torch.parallel.mesh import (  # noqa: E402
    MeshSpec,
    axis_rank,
    build_hybrid_mesh,
    build_mesh,
)
from deeplearning_cfn_tpu_torch.parallel.tensor_parallel import ModelParallel  # noqa: E402
from deeplearning_cfn_tpu_torch.train import trainer as trainer_lib  # noqa: E402
from deeplearning_cfn_tpu_torch.train.checkpoint import Checkpointer  # noqa: E402
from deeplearning_cfn_tpu_torch.train.reshard import mesh_topology  # noqa: E402


def _full(p: torch.Tensor) -> torch.Tensor:
    return p.full_tensor() if hasattr(p, "full_tensor") else p


def _mesh(case: dict):
    if "hybrid" in case:
        ici, dcn = case["hybrid"]
        return build_hybrid_mesh(MeshSpec(**ici), MeshSpec(**dcn))
    return build_mesh(MeshSpec(**case["mesh"]))


def _trainer(case: dict, mesh, seed: int = 0):
    """The case's trainer over ``mesh`` and its state, from the case's
    initial weights (numpy, the JAX tree's or the port's own) when it has
    them, else from ``seed``."""
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(dtype=torch.float32), **case["cfg"])
    init = case.get("init")
    weights = None
    if init is not None:
        pp = mesh.size(mesh.mesh_dim_names.index("pp"))
        pp_cut = dict(pp_rank=axis_rank(mesh, "pp"), pp_size=pp) if pp > 1 else {}
        weights = (interop.llama_params_from_jax(cfg, init, **pp_cut) if not case.get("torch_init")
                   else {k: torch.from_numpy(v) for k, v in init.items()
                         if k in _stage_names(cfg, mesh)})

    def model_fn(generator):
        model = llama.Llama(cfg, generator, mesh=mesh)
        if weights is not None:
            model.load_state_dict(weights)
        return model

    t = trainer_lib.Trainer(model_fn, trainer_lib.TrainerConfig(**case["trainer"]),
                            loss_fn=llama.causal_lm_loss, device="cpu", mesh=mesh,
                            param_specs=llama.param_specs(cfg))
    return t, t.init(seed=seed)


def _stage_names(cfg, mesh) -> set:
    """The parameter names a rank of ``mesh`` holds."""
    with torch.device("meta"):
        return {n for n, _ in llama.Llama(cfg, mesh=mesh).named_parameters()}


def run_checkpoint_case(case: dict) -> dict:
    """Save after ``case["steps"]`` steps, or restore into a state from
    another seed and take the remaining batches (``case["mode"]``)."""
    mesh = _mesh(case)
    save = case["mode"] == "save"
    t, state = _trainer(case if save else {**case, "init": None}, mesh, seed=0 if save else 1)
    ck = Checkpointer(case["dir"], interval_s=None, async_save=False)
    n = case["steps"]
    if not save:
        assert ck.restore_latest(state)[1] == n and state.step == n
    losses = []
    for x, y in case["batches"][:n] if save else case["batches"][n:]:
        state, metrics = t.train_step(state, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(float(metrics["loss"]))
    if save:
        ck.save(state.step, state)
    ck.close()
    params = {n: _full(p).detach().numpy().copy() for n, p in state.model.named_parameters()}
    out = {"losses": losses, "topology": mesh_topology(mesh), "params": params,
           "ep_rank": axis_rank(mesh, "ep"), "pp_rank": axis_rank(mesh, "pp")}
    if state.error_feedback is not None:
        out["residual"] = [r.cpu().numpy().copy() for r in state.error_feedback.residual]
    return out


def _model_case_parts(case: dict):
    """``(model_fn, loss_fn)`` of a ``model`` case."""
    from deeplearning_cfn_tpu_torch.models import bert, resnet, retinanet

    kind, arch = case["model"], case["arch"]
    if kind == "resnet":
        return (lambda g: resnet.ResNet(**arch, generator=g)), None
    if kind == "bert":
        cfg = bert.BertConfig.tiny(**arch)
        return (lambda g: bert.BertEncoder(cfg, g)), bert.mlm_loss
    anchors = torch.from_numpy(retinanet.generate_anchors(case["image_size"]))

    def loss_fn(model, x, y):
        return retinanet.detection_loss_with_masks(
            *model(x, train=True), anchors, y["boxes"], y["classes"], y["masks"],
            arch["num_classes"])

    return (lambda g: retinanet.RetinaNet(**arch, generator=g)), loss_fn


def run_model_case(case: dict) -> dict:
    """The case's trainer steps from the given state dict; every step's
    metrics, the final parameters and buffers."""
    from deeplearning_cfn_tpu_torch.train.data import tree_map

    mesh = build_mesh(MeshSpec(**case["mesh"]))
    model_fn, loss_fn = _model_case_parts(case)
    t = trainer_lib.Trainer(model_fn, trainer_lib.TrainerConfig(**case["trainer"]),
                            loss_fn=loss_fn, device="cpu", mesh=mesh)
    if case.get("expect_error"):  # a refusal: its message
        try:
            t.init(seed=0)
        except ValueError as e:
            return {"error": str(e)}
        return {"error": None}
    state = t.init(seed=0)
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in case["init"].items()})
    metrics = []
    for x, y in case["batches"]:
        state, m = t.train_step(state, torch.from_numpy(x), tree_map(torch.from_numpy, y))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "ddp": state.runner is not None,
            "state": {k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()}}


def run_ring_case(case: dict) -> dict:
    """Ring attention on this rank's block of the sequence: its output and
    the gradients of its blocks of q, k and v for the cotangent ``g``."""
    from deeplearning_cfn_tpu_torch.parallel.ring_attention import ring_attention

    mesh = build_mesh(MeshSpec(**case["mesh"]))
    sp, rank = mesh.size(mesh.mesh_dim_names.index("sp")), axis_rank(mesh, "sp")

    def block(a):
        n = a.shape[1] // sp
        return torch.from_numpy(a[:, rank * n:(rank + 1) * n].copy())

    q, k, v = (block(case[n]).requires_grad_() for n in "qkv")
    out = ring_attention(q, k, v, mesh.get_group("sp"), causal=True)
    out.backward(block(case["g"]))
    return {"sp_rank": rank, "out": out.detach().numpy(),
            **{f"d{n}": t.grad.numpy() for n, t in zip("qkv", (q, k, v))}}


def run_example_case(case: dict) -> dict:
    """``examples.llama_train.main`` with the case's flags over the ranks."""
    from deeplearning_cfn_tpu_torch.examples import llama_train

    out = llama_train.main(case["argv"])
    return {"losses": [h["loss"] for h in out["history"]], "mesh": out["mesh"]}


class ToyStage(torch.nn.Module):
    """One stage of a tanh stack: ``a <- tanh(a @ w[i])`` over its layers;
    with ``aux``, each stage adds the sum of its output to the carried aux."""

    def __init__(self, w, aux: bool):
        super().__init__()
        self.w = torch.nn.Parameter(w)
        self.aux = aux

    def forward(self, a, aux=None):
        for i in range(self.w.shape[0]):
            a = torch.tanh(a @ self.w[i])
        return (a, aux + a.sum()) if self.aux else a


def run_toy_pipeline_case(case: dict) -> dict:
    """``pipeline_apply`` forward (output and aux on every rank), then one
    GPipe step with the backward of ``sum(out)``: this stage's gradient."""
    from deeplearning_cfn_tpu_torch.parallel import pipeline

    mesh = build_mesh(MeshSpec(**case["mesh"]))
    rank = axis_rank(mesh, "pp")
    w = torch.from_numpy(case["W"])  # [n_stages, L/pp, D, D]
    x = torch.from_numpy(case["x"])
    n_stages, M = w.shape[0], case["M"]
    if "wrong_stages" in case:
        try:
            pipeline.pipeline_apply(ToyStage(w[0], False), x, mesh, M, n_stages=case["wrong_stages"])
        except pipeline.PipelineError as e:
            return {"error": str(e)}
        return {"error": None}
    stage = ToyStage(w[rank].clone(), case["aux"])
    out, aux = pipeline.pipeline_apply(stage, x, mesh, M, n_stages, aux=case["aux"])
    res = {"pp_rank": rank, "out": out.numpy(), "aux": float(aux)}
    if not case["aux"]:
        pipeline.run_schedule(stage, (x,), mesh, M, n_stages,
                              loss_fn=lambda o, t: o.sum(), target=torch.zeros(x.shape[0]))
        res["grad"] = stage.w.grad.numpy().copy()
    return res


def run_bucket_case(case: dict) -> dict:
    """One bucket through ``_sync_fused_int8`` (``int8``: this rank's flat
    and residual row; also its phase-1 int8 chunk) or ``_sync_sharded``
    (``sharded``: this rank's whole gradient)."""
    from deeplearning_cfn_tpu_torch.ops.quant import quantize_flat
    from deeplearning_cfn_tpu_torch.parallel import overlap

    mesh = build_mesh(MeshSpec(**case["mesh"]))
    rank, group = axis_rank(mesh, "dp"), mesh.get_group("dp")
    nd = mesh.size(mesh.mesh_dim_names.index("dp"))
    if "sharded" in case:
        g = torch.from_numpy(case["sharded"][rank])
        return {"rank": rank, "out": overlap._sync_sharded(g, group, case["dim"]).numpy()}
    flat = torch.from_numpy(case["int8"][rank])
    residual = torch.from_numpy(case["residual"][rank:rank + 1])
    v = torch.cat([flat, flat.new_zeros(residual.shape[1] - flat.shape[0])]) + residual[0]
    out, new_residual = overlap._sync_fused_int8(flat, residual, group, nd)
    return {"rank": rank, "out": out.numpy(), "residual": new_residual.numpy(),
            "q": quantize_flat(v)[0].numpy()}


def run_default_mesh_case(case: dict) -> dict:
    """``examples.common.default_mesh`` with ``DEEPLEARNING_SLICES_COUNT``
    set: its axis sizes and rank grid."""
    from deeplearning_cfn_tpu_torch.examples.common import default_mesh
    from deeplearning_cfn_tpu_torch.parallel.mesh import mesh_spec

    os.environ["DEEPLEARNING_SLICES_COUNT"] = str(case["slices"])
    try:
        mesh = default_mesh(case["default_mesh"])
    finally:
        del os.environ["DEEPLEARNING_SLICES_COUNT"]
    return {"sizes": mesh_spec(mesh).axis_sizes(), "grid": mesh.mesh.tolist()}


def run_case(case: dict) -> dict:
    if "default_mesh" in case:
        return run_default_mesh_case(case)
    if "toy_pipeline" in case:
        return run_toy_pipeline_case(case)
    if "int8" in case or "sharded" in case:
        return run_bucket_case(case)
    if "argv" in case:
        return run_example_case(case)
    if "mode" in case:
        return run_checkpoint_case(case)
    if "model" in case:
        return run_model_case(case)
    if "ring" in case:
        return run_ring_case(case)
    mesh = _mesh(case)
    t, state = _trainer(case, mesh)
    x0, y0 = (torch.from_numpy(a) for a in case["batches"][0])
    out = {}
    if case.get("logits"):
        with torch.no_grad():
            out["logits"] = llama.forward(state.model, t._local_batch(x0)).numpy()
        out["eval_loss"] = float(t.eval_step(state, x0, y0)["loss"])
    sync = state.grad_sync
    ef = state.error_feedback  # the norm's backward must leave the residuals as they are
    kept = [r.clone() for r in ef.residual] if ef is not None else []
    with t._data_ranks():  # as the step takes its gradients
        loss, _ = t._grads(state.runner or state.model, t._local_batch(x0), t._local_batch(y0),
                           sync)
    if sync is None:
        t._sync_replicated_grads()  # as the step does before its clip
    t._sum_grads_over_pp()
    t._sum_grads_over_sp(state.model)
    if case.get("grads"):
        out["grads"] = {n: _full(p.grad).detach().numpy().copy()
                        for n, p in state.model.named_parameters()}
    norm = trainer_lib.clip_by_global_norm(state.model.parameters(), float("inf"),
                                           t._clip_groups())
    state.optimizer.zero_grad(set_to_none=True)
    if ef is not None:
        for r, k in zip(ef.residual, kept):
            r.copy_(k)
    losses, aux = [], []
    for x, y in case["batches"]:
        state, metrics = t.train_step(state, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(float(metrics["loss"]))
        if "moe_aux_loss" in metrics:
            aux.append(float(metrics["moe_aux_loss"]))
    sharded = {n: [pl.dim for pl in p.placements if pl.is_shard()]
               for n, p in state.model.named_parameters() if hasattr(p, "placements")}
    params = {n: _full(p).detach().numpy().copy() for n, p in state.model.named_parameters()}
    out.update({"losses": losses, "aux": aux, "norm": float(norm), "params": params,
                "ep_rank": axis_rank(mesh, "ep"), "sharded": sharded,
                "tp_rank": axis_rank(mesh, "tp"), "pp_rank": axis_rank(mesh, "pp"),
                "data_index": t._data_index,
                "ddp": state.runner is not None, "mesh_grid": mesh.mesh.tolist()})
    if sync is not None:
        names = {id(p): n for n, p in state.model.named_parameters()}
        out["issued"] = list(sync.issued)
        out["members"] = [[names[id(p)] for p in ps] for ps in sync.members]
        out["plan"] = t.bucket_plan.to_dict()
        out["wire_bytes"] = sync.wire_bytes
        if state.error_feedback is not None:
            out["residual"] = [r.numpy().copy() for r in state.error_feedback.residual]
    mp = llama.model_parallel(state.model)
    if mp.tp > 1:  # the loss's logits: this rank's vocabulary, its nll the whole one's
        with torch.no_grad():
            xl, yl = t._local_batch(x0), t._local_batch(y0)
            part = state.model(xl, gather_logits=False)
            whole = state.model(xl)
            out["loss_logits_width"] = part.shape[-1]
            out["nll_gap"] = float((mp.nll(part, yl) - ModelParallel().nll(whole, yl)).abs().max())
    return out


def main() -> None:
    torch.set_num_threads(1)
    path = Path(sys.argv[1])
    cases = pickle.loads(path.read_bytes())
    pid = maybe_init_distributed("cpu")
    try:
        out = {name: run_case(case) for name, case in cases.items()}
    finally:
        dist.destroy_process_group()
    Path(f"{path}.rank{pid}").write_bytes(pickle.dumps(out))


if __name__ == "__main__":
    if int(os.environ.get("DEEPLEARNING_WORKERS_COUNT", "1")) < 2:
        raise SystemExit("run as one of several processes (the cluster contract's env)")
    main()
