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
one bucket through ``parallel.overlap``'s exchanges.  A ``reshard`` case
(:func:`run_reshard_case`) drives the live reshard on a small MLP: the golden
migration, ``fit(reshard=)`` with the cluster plane, the forced fallback and
its DCP restore; the ranks of the lost slice leave the case and wait at the
store (no collective) until the survivors are done.  A ``regrow`` case
(:func:`run_regrow_case`) shrinks the mesh by a slice and grows it back: the
slice's ranks park and rejoin, or (``rejoin`` false) never call ``rejoin``,
as processes that died, and the grow takes the fallback.  A Llama case may be
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


class MLP(torch.nn.Module):
    """The JAX reshard tests' ``_MLP`` (flatten, Dense 256, relu, Dense 256,
    relu, Dense 10) in ``nn.Linear`` layers of the same names."""

    def __init__(self, generator=None, d_in: int = 64):
        super().__init__()
        self.fc1 = torch.nn.Linear(d_in, 256)
        self.fc2 = torch.nn.Linear(256, 256)
        self.head = torch.nn.Linear(256, 10)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return self.head(x)


def _plane(case: dict):
    """``(contract, controller, manager, vclock)``: the 2-slice contract of
    the ranks (``workers``, four by default; one chip a worker), the
    elasticity controller on a virtual clock (10 s debounce) and the
    live-reshard manager on it."""
    from deeplearning_cfn_tpu_torch.analysis.schedules import VirtualClock
    from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract
    from deeplearning_cfn_tpu_torch.cluster.elasticity import ElasticityController, GroupPolicy
    from deeplearning_cfn_tpu_torch.cluster.recovery import LiveReshardManager
    from deeplearning_cfn_tpu_torch.provision.events import EventBus

    class Backend:
        def __init__(self):
            self.events = EventBus()

    ips = [f"10.0.0.{i + 1}" for i in range(case.get("workers", 4))]
    half = len(ips) // 2
    contract = ClusterContract.build(
        cluster_name="live", coordinator_ip=ips[0], other_worker_ips=ips[1:],
        chips_per_worker=1, storage_mount="/mnt/none",
        slices={"s0": ips[:half], "s1": ips[half:]})
    vclock = VirtualClock()
    controller = ElasticityController(backend=Backend(), coordinator_queue_name="coord",
                                      slice_loss_window_s=10.0, clock=vclock)
    controller.register(GroupPolicy("s0", 1, "sig-s0", coordinator=True))
    controller.register(GroupPolicy("s1", 1, "sig-s1"))
    controller.attach()
    manager = LiveReshardManager(contract)
    manager.attach(controller)
    return contract, controller, manager, vclock


def _mesh_for(case: dict):
    """The mesh of a contract over its workers' ranks: the case's per-slice
    fsdp on each slice, dp across the slices (``hybrid``), or all fsdp."""
    from deeplearning_cfn_tpu_torch.parallel.mesh import hybrid_mesh_for_slices
    from deeplearning_cfn_tpu_torch.train.reshard import survivor_ranks

    origin = _plane(case)[0]

    def mesh_for(contract):
        ranks = survivor_ranks(origin, contract)
        if case["reshard"] == "golden" or case.get("layout") == "fsdp":
            return build_mesh(MeshSpec(fsdp=len(ranks)), ranks=ranks)
        per_slice = len(ranks) // contract.slices_count
        return hybrid_mesh_for_slices(contract.slices_count, MeshSpec(fsdp=per_slice), "dp",
                                      device_type=case.get("device", "cpu"), ranks=ranks)

    return mesh_for


def _mlp_trainer(case: dict, mesh, accum: int = 1):
    from deeplearning_cfn_tpu_torch import interop

    weights = interop.dense_params_from_jax(case["init"])

    def model_fn(generator):
        model = MLP(generator)
        if generator is not None:
            model.load_state_dict(weights)
        return model

    cfg = trainer_lib.TrainerConfig(optimizer=case.get("optimizer", "adamw"),
                                    learning_rate=1e-3, strategy="fsdp",
                                    matmul_precision="float32", log_every=1,
                                    grad_accum_steps=accum)
    t = trainer_lib.Trainer(model_fn, cfg, device=case.get("device", "cpu"), mesh=mesh)
    return t, t.init(seed=0)


def _batches(case: dict, hook=None):
    from deeplearning_cfn_tpu_torch.train.data import Batch

    device = torch.device(case.get("device", "cpu"))
    for i, (x, y) in enumerate(case["batches"]):
        if hook is not None:
            hook(i)
        yield Batch(x=torch.from_numpy(x).to(device), y=torch.from_numpy(y).to(device))


def _golden(case: dict, mesh_for) -> dict:
    """fsdp 4 -> 2 after two AdamW steps: the migrated state against a fresh
    shard (``distribute_tensor``) of the state gathered before."""
    from torch.distributed.tensor import distribute_tensor

    from deeplearning_cfn_tpu_torch.train import reshard

    t, state = _mlp_trainer(case, build_mesh(MeshSpec(fsdp=4)))
    for x, y in case["batches"][:2]:
        state, _ = t.train_step(state, torch.from_numpy(x), torch.from_numpy(y))
    host = {k: (v.full_tensor() if hasattr(v, "device_mesh") else v).clone()
            for k, v in reshard._flat(state.state_dict()).items()}
    contract, _, manager, _ = _plane(case)
    survivors = reshard.survivor_ranks(contract, contract.surviving({"s1"}))
    if dist.get_rank() not in survivors:
        assert reshard.migrate_state(t, state, None) is None
        return {"left": True}
    mesh2 = mesh_for(contract.surviving({"s1"}))
    shardings = reshard.state_shardings_for(t, state, mesh2)
    reshard.ensure_hostable(state, shardings)
    migrated = reshard.migrate_state(t, state, shardings)
    equal, sharded = {}, []
    for k, v in reshard._flat(migrated.state_dict()).items():
        if hasattr(v, "device_mesh"):
            fresh = distribute_tensor(host[k], v.device_mesh, v.placements).to_local()
            if any(pl.is_shard() for pl in v.placements) and v.device_mesh.size() > 1:
                sharded.append(k)
        else:
            fresh = host[k]
        mine = v.to_local() if hasattr(v, "device_mesh") else v
        equal[k] = (mine.dtype == fresh.dtype and mine.shape == fresh.shape
                    and mine.numpy().tobytes() == fresh.numpy().tobytes())
    return {"left": False, "equal": equal, "sharded": sharded,
            "topology": reshard.mesh_topology(t.mesh), "opt_keys": sorted(
                {k.rsplit(".", 1)[1] for k in equal if k.startswith("optimizer.")})}


def _journal_count(kind: str) -> int:
    from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

    return sum(1 for e in get_recorder().tail(4096) if e.get("kind") == kind)


def run_reshard_case(case: dict) -> dict:
    """One live-reshard case on four ranks (module docstring); ``reshard``
    names it: ``golden``, ``straight`` (no loss), ``live`` (the terminate
    burst published while batch ``die_at`` is produced, on the ranks of
    ``events_on``; with ``dir`` every step checkpointed, the survivors' last
    save restored onto a fresh state on their mesh; with ``plant_leaf`` the
    survivors' model on the new mesh has a leaf the old state lacks),
    ``fallback`` (the same with ``force_fallback``, every step checkpointed,
    then the survivors' DCP restore and the remaining steps)."""
    import itertools

    from deeplearning_cfn_tpu_torch.parallel.mesh import data_group
    from deeplearning_cfn_tpu_torch.provision.events import EventKind, LifecycleEvent
    from deeplearning_cfn_tpu_torch.train import reshard
    from deeplearning_cfn_tpu_torch.train.optimizers import local_part

    mesh_for = _mesh_for(case)
    kind = case["reshard"]
    if kind == "golden":
        return _golden(case, mesh_for)
    contract, controller, manager, vclock = _plane(case)
    t, state = _mlp_trainer(case, mesh_for(contract))
    if kind == "straight":
        state, losses = t.fit(state, _batches(case), steps=len(case["batches"]), prefetch=0)
        return {"losses": losses, "step": state.step}
    die_at, rank = case["die_at"], dist.get_rank()

    def publish(i):
        if i == die_at and rank in case["events_on"]:
            for ip in case["burst"]:
                controller.backend.events.publish(LifecycleEvent(
                    kind=EventKind.INSTANCE_TERMINATE, group="s1", instance_id=ip,
                    detail={"reason": "preempted"}))
                vclock.advance(0.5)
            vclock.advance(11.0)

    plane = None
    if case.get("records"):
        from deeplearning_cfn_tpu_torch.train import datastream, records

        spec = records.RecordSpec((records.Field("x", "uint8", (2,)),
                                   records.Field("y", "int32", ())))
        plane = datastream.DataStreamPlane(contract, case["records"], spec, batch_size=2,
                                           seed=case["seed"])
        hook = publish

        def publish(i):  # each host reads its batch as the step's is made
            hook(i)
            if i < die_at:
                for host in plane.hosts:
                    next(plane.stream(host).batches(1))

    paused_at = []
    coordinator = reshard.LiveReshardCoordinator(
        manager=manager, mesh_for=mesh_for, flush=controller.flush_slice_losses, clock=vclock,
        force_fallback=kind == "fallback",
        on_commit=plane.reshard if plane is not None else None)
    execute = coordinator.execute

    def recorded(trainer, st, step):
        paused_at.append(step)
        return execute(trainer, st, step)

    coordinator.execute = recorded
    if case.get("plant_leaf"):
        make = t.model_fn

        def planted(generator):
            model = make(generator)
            if generator is None:  # the reshard's build on meta
                model.register_buffer("planted", torch.zeros(1))
            return model

        t.model_fn = planted
    ck = _sync_checkpointer(case["dir"]) if "dir" in case else None
    before = {k: _journal_count(k) for k in ("reshard", "reshard_fallback",
                                             "grad_accum_rescaled", "slice_loss_coalesced")}
    state, losses = t.fit(state, _batches(case, publish), steps=len(case["batches"]),
                          prefetch=0, reshard=coordinator, checkpointer=ck)
    out = {"losses": losses, "step": state.step, "paused_at": paused_at,
           "left": coordinator.departed, "live_total": coordinator.live_total,
           "fallback_total": coordinator.fallback_total,
           "journal": {k: _journal_count(k) - n for k, n in before.items()},
           "grad_accum": t.config.grad_accum_steps, "topology": reshard.mesh_topology(t.mesh),
           "slices": manager.contract.slices_count, "degraded": manager.contract.degraded,
           "data": (t._data_index, t._data_count)}
    if plane is not None:
        out["plane_states"] = plane.states()
    if kind == "live" and ck is not None and not coordinator.departed:
        # The survivors' saves after the pause went over their own group:
        # the last one restores, bitwise, onto a fresh state on their mesh.
        out["saved_steps"] = ck.all_steps()
        t2, state2 = _mlp_trainer(case, mesh_for(manager.contract), 2)
        ck2 = _sync_checkpointer(case["dir"], process_group=data_group(t2.mesh))
        state2, out["restored_step"] = ck2.restore_latest(state2)
        mine, restored = (reshard._flat(st.state_dict()) for st in (state, state2))
        out["restored_bitwise"] = mine.keys() == restored.keys() and all(
            torch.equal(local_part(v), local_part(mine[k])) for k, v in restored.items())
    if kind != "fallback" or coordinator.departed:
        return out
    ck.close()
    surviving = coordinator.fallback_contract
    mesh2 = mesh_for(surviving)
    accum = reshard.rescale_grad_accum(1, dist.get_world_size(), mesh2.size())
    t2, state2 = _mlp_trainer({**case, "init": case["init"]}, mesh2, accum)
    ck2 = _sync_checkpointer(case["dir"], process_group=data_group(mesh2))
    state2, restore_step = ck2.restore_latest(state2)
    rest = itertools.islice(_batches(case), restore_step, None)
    state2, losses2 = t2.fit(state2, rest, steps=len(case["batches"]) - restore_step, prefetch=0)
    ck2.close()
    out.update(restore_step=restore_step, resumed_losses=losses2, final_step=state2.step,
               restored_accum=accum, restored_topology=reshard.mesh_topology(mesh2))
    return out


def run_regrow_case(case: dict) -> dict:
    """Slice ``s1`` leaves at the boundary of batch ``die_at`` (its terminate
    burst on rank 0) and is armed to return at batch ``grow_at`` (rank 0's
    manager), with ``symmetric_accum``; with ``rejoin`` its ranks park and
    rejoin, training on from the grow's batch (without, they leave the case
    as a slice that died does) (a ``grow_at`` past the run:
    rank 0 releases them at its end).  ``layout`` ``"fsdp"`` runs one fsdp
    axis over every rank (the survivors' shards change at the grow) in
    place of 2 slices x fsdp 2.  Reports the losses, the accumulation and
    topology at every boundary, the fallback counters, and each rank's state
    right after the grow (a survivor's also right before it): its local
    parts, or with the fsdp layout every leaf whole (gathered over the mesh,
    by every rank of it alike)."""
    import itertools

    from deeplearning_cfn_tpu_torch.provision.events import EventKind, LifecycleEvent
    from deeplearning_cfn_tpu_torch.train import reshard
    from deeplearning_cfn_tpu_torch.train.optimizers import local_part

    case = {**case, "reshard": "live"}
    mesh_for = _mesh_for(case)
    contract, controller, manager, vclock = _plane(case)
    t, state = _mlp_trainer(case, mesh_for(contract))
    rank = dist.get_rank()

    def local(st) -> dict:
        if case.get("layout") == "fsdp":
            return {k: (v.full_tensor() if hasattr(v, "device_mesh") else v).detach().clone()
                    for k, v in sorted(reshard._flat(st.state_dict()).items())}
        return {k: local_part(v).detach().clone() for k, v in reshard._flat(st.state_dict()).items()}

    def hook(i):
        if rank != 0:
            return
        if i == case["die_at"]:
            for ip in case["burst"]:
                controller.backend.events.publish(LifecycleEvent(
                    kind=EventKind.INSTANCE_TERMINATE, group="s1", instance_id=ip,
                    detail={"reason": "sched-preempt"}))
                vclock.advance(0.5)
            vclock.advance(11.0)
        if i == case["grow_at"]:
            manager.arm_restore("s1", list(contract.slices["s1"]))

    coordinator = reshard.LiveReshardCoordinator(
        manager=manager, mesh_for=mesh_for, flush=controller.flush_slice_losses, clock=vclock,
        symmetric_accum=True)
    boundaries, snaps = [], {}
    execute = coordinator.execute

    def recorded(trainer, st, step):
        before = local(st)
        new, action = execute(trainer, st, step)
        boundaries.append({"step": step, "action": action,
                           "grad_accum": trainer.config.grad_accum_steps,
                           "topology": reshard.mesh_topology(trainer.mesh)})
        if step == case["grow_at"] and action == "resume":
            snaps.update(before=before, after=local(new))
        return new, action

    coordinator.execute = recorded
    n = len(case["batches"])
    before = {k: _journal_count(k) for k in ("reshard", "reshard_fallback",
                                             "grad_accum_rescaled", "slice_restore_armed")}
    state, losses = t.fit(state, _batches(case, hook), steps=n, prefetch=0, reshard=coordinator)
    rejoined_at = None
    if coordinator.departed and case["rejoin"]:
        state = coordinator.rejoin(t, state)
        if state is not None:
            rejoined_at = state.step
            snaps["after"] = local(state)
            boundaries.append({"step": state.step, "action": "rejoin",
                               "grad_accum": t.config.grad_accum_steps,
                               "topology": reshard.mesh_topology(t.mesh)})
            rest = itertools.islice(_batches(case), state.step, None)
            state, more = t.fit(state, rest, steps=n - state.step, prefetch=0,
                                reshard=coordinator)
            losses += more
    if rank == 0:
        coordinator.release()
    return {"losses": losses, "boundaries": boundaries, "rejoined_at": rejoined_at,
            "left": coordinator.departed, "live_total": coordinator.live_total,
            "fallback_total": coordinator.fallback_total,
            "fallback_pending": coordinator.fallback_pending,
            "fallback_reason": next((r.reason for r in coordinator.records
                                     if r.mode == "fallback"), None),
            "journal": {k: _journal_count(k) - v for k, v in before.items()},
            "grad_accum": t.config.grad_accum_steps, "topology": reshard.mesh_topology(t.mesh),
            "slices": manager.contract.slices_count,
            "step": state.step if state is not None else None,
            "snaps": {k: {n: v.numpy() for n, v in d.items()} for k, d in snaps.items()}}


def _sync_checkpointer(directory, process_group=None):
    """A synchronous DCP checkpointer saving every step."""
    return Checkpointer(directory, interval_s=None, every_steps=1, async_save=False,
                        process_group=process_group)


def run_case(case: dict) -> dict:
    if "regrow" in case:
        return run_regrow_case(case)
    if "reshard" in case:
        return run_reshard_case(case)
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
    if any(c.get("device") == "cuda" for c in cases.values()):
        torch.cuda.set_device(0)  # every rank on the one card, over gloo
    pid = maybe_init_distributed("cpu")
    store = dist.distributed_c10d._get_default_store()
    out = {}
    try:
        for name, case in cases.items():
            out[name] = run_case(case)
            if "reshard" in case or "regrow" in case:  # the lost slice's ranks wait
                key = f"reshard-case/{name}"
                if out[name].get("left"):
                    store.wait([key])
                elif pid == 0:
                    store.set(key, "done")
    finally:
        dist.destroy_process_group()
    Path(f"{path}.rank{pid}").write_bytes(pickle.dumps(out))


if __name__ == "__main__":
    if int(os.environ.get("DEEPLEARNING_WORKERS_COUNT", "1")) < 2:
        raise SystemExit("run as one of several processes (the cluster contract's env)")
    main()
