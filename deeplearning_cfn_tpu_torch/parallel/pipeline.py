"""Pipeline stages — counterpart of ``deeplearning_cfn_tpu/parallel/pipeline.py``.

GPipe over the ``pp`` mesh axis: each ``pp`` rank holds one stage's layers
and runs them on ``M`` microbatches of its data shard; activations pass from
stage to stage over the ``pp`` group.  The JAX package writes the schedule
as one ``lax.scan`` of ``M + pp - 1`` ticks inside a ``shard_map``; here it
is written by hand (:func:`run_schedule`), each stage running its
microbatches as they arrive, with JAX's semantics:

- M microbatches flow through pp stages in ``M + pp - 1`` ticks; a stage
  that waits for its first or after its last microbatch computes nothing,
  so the bubble contributes nothing to the output or to an aux term;
- an aux loss the stages carry (``aux=True``: each stage adds its own to
  the ``[1]`` tensor it receives) is summed over the stages and averaged
  over the M microbatches, so a per-call mean (MoE's balancing loss) keeps
  its unpipelined scale;
- a stage count that does not match the mesh's ``pp``, and a batch that
  does not split into M, are refused (:class:`PipelineError`).

With ``loss_fn`` the schedule is GPipe's: every microbatch forward, then
every microbatch backward in the same order, each stage receiving the
gradient of its outputs from the next stage and sending the gradient of its
inputs to the previous one; the gradients accumulate in the stage's
parameters.  The caller scales each microbatch's loss so that their sum is
the batch's objective (the schedule scales nothing).  Under
:func:`remat_stages` (``TrainerConfig.remat``: JAX's ``jax.checkpoint`` of
the whole loss) each stage's forward of each microbatch is checkpointed
(non-reentrant, with the contexts the trainer passes, nested as
``train/remat.py`` says) and recomputed in its backward.

Activations and their gradients cross the stages through
``parallel/p2p.py`` (staged through the host for CUDA tensors on a gloo
group, which takes no CUDA send; straight through on NCCL).  A stage's
shapes and dtypes go to the next stage before its first microbatch, as an
object list on the group's own device, the first time a schedule of these
inputs (and autocast state) runs: every microbatch has the same, and the
next stage keeps them on the stage module; a later send whose layout
differs raises :class:`PipelineError`.  So a schedule captured in a CUDA graph
(``Trainer.multi_step_fn`` over NCCL) exchanges no objects: its warm-up
step sent them.  The schedule is the port's own rather than
``torch.distributed.pipelining``'s: that posts its sends on the stage's
device, which gloo refuses, and learns its shapes from an extra call of the
loss.

The layer weights stay per-block modules in the port; :func:`stack_stages`
and :func:`unstack_stages` reshape JAX-layout trees (``[L, ...]`` <->
``[pp, L/pp, ...]``, numpy or torch leaves) for ``interop``, and
:func:`stage_layers` names the layers a stage holds.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Iterator

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from deeplearning_cfn_tpu_torch.parallel import p2p
from deeplearning_cfn_tpu_torch.parallel.sharding import stage_specs  # noqa: F401 (as JAX's)


class PipelineError(ValueError):
    pass


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_stages(layer_tree: Any, n_stages: int) -> Any:
    """Reshape layer-stacked leaves ``[L, ...]`` -> ``[pp, L/pp, ...]``
    (numpy arrays or tensors, in a dict tree or alone): stage ``s`` holds
    layers ``[s*L/pp, (s+1)*L/pp)``."""

    def reshape(x):
        L = x.shape[0]
        if L % n_stages:
            raise PipelineError(f"layer count {L} not divisible by pp={n_stages}")
        return x.reshape(n_stages, L // n_stages, *x.shape[1:])

    return _tree_map(reshape, layer_tree)


def unstack_stages(layer_tree: Any) -> Any:
    """Inverse of :func:`stack_stages`: ``[pp, L/pp, ...]`` -> ``[L, ...]``."""
    return _tree_map(lambda p: p.reshape(p.shape[0] * p.shape[1], *p.shape[2:]), layer_tree)


def stage_layers(n_layers: int, n_stages: int, stage: int) -> range:
    """The global indices of the layers stage ``stage`` holds."""
    if n_layers % n_stages:
        raise PipelineError(f"layer count {n_layers} not divisible by pp={n_stages}")
    per = n_layers // n_stages
    return range(stage * per, (stage + 1) * per)


def microbatch(x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """``[B, ...]`` -> ``[M, B/M, ...]``; B must divide evenly."""
    B = x.shape[0]
    if B % n_microbatches:
        raise PipelineError(f"batch {B} not divisible by n_microbatches={n_microbatches}")
    return x.reshape(n_microbatches, B // n_microbatches, *x.shape[1:])


_IN_STAGE: contextvars.ContextVar[bool] = contextvars.ContextVar("in_pipeline_stage",
                                                                 default=False)
_REMAT: contextvars.ContextVar[Callable | None] = contextvars.ContextVar(
    "remat_pipeline_stages", default=None)


def in_stage() -> bool:
    """Whether the caller runs as a stage of :func:`run_schedule` (a model
    whose forward is also its stage's, as the pipelined Llama's is)."""
    return _IN_STAGE.get()


@contextlib.contextmanager
def _flag(var: contextvars.ContextVar) -> Iterator[None]:
    token = var.set(True)
    try:
        yield
    finally:
        var.reset(token)


@contextlib.contextmanager
def remat_stages(contexts: Callable) -> Iterator[None]:
    """Inside it, a training :func:`run_schedule` checkpoints each stage's
    forward of each microbatch, with ``contexts(also)`` as the checkpoint's
    ``context_fn`` (``train/remat.outer_remat_contexts``): ``also`` makes
    the in-stage flag, which the recompute must set again."""
    token = _REMAT.set(contexts)
    try:
        yield
    finally:
        _REMAT.reset(token)


def _pp_group(mesh, axis: str, n_stages: int):
    pp = mesh.size(mesh.mesh_dim_names.index(axis))
    if pp <= 1:
        raise PipelineError(f"mesh axis {axis!r} has size {pp}; need > 1")
    if n_stages != pp:
        raise PipelineError(f"the layers are stacked into {n_stages} stages but mesh axis "
                            f"{axis!r} is {pp}")
    return mesh.get_group(axis), mesh.get_local_rank(axis), pp


def _send_tensors(tensors, dst: int, group, with_layout: bool) -> None:
    """Each tensor to global rank ``dst``; first, ``with_layout``, their
    shapes and dtypes, as an object list on the group's own device (the
    host for gloo, the card for NCCL)."""
    if with_layout:
        dist.send_object_list([[(tuple(t.shape), t.dtype) for t in tensors]], dst, group=group)
    for t in tensors:
        p2p.send(t, dst, group)


def _recv_layout(src: int, group) -> list:
    """The shapes and dtypes :func:`_send_tensors` sent ``with_layout``."""
    box = [None]
    dist.recv_object_list(box, src, group=group)
    return box[0]


def _layouts(stage: nn.Module) -> dict:
    """The layouts ``stage`` has sent (``("sent", key)``) and received
    (``("got", key)``), by :func:`_schedule_key`; a sent one is checked
    against each later send of its key (:func:`_check_layout`)."""
    if "_pp_layouts" not in stage.__dict__:
        stage._pp_layouts = {}
    return stage._pp_layouts


def _schedule_key(inputs: tuple, M: int, train: bool) -> tuple:
    """What decides the layouts a schedule sends, and is the same on every
    rank of the pp group: its inputs' shapes and dtypes, the microbatch
    count, training or not, and the autocast state (autocast turned on
    changes what every stage returns, so the layouts are exchanged anew)."""
    device = inputs[0].device.type
    autocast = (torch.get_autocast_dtype(device) if torch.is_autocast_enabled(device)
                else None)
    return (tuple((tuple(t.shape), t.dtype) for t in inputs), M, train, autocast)


def _check_layout(sent: list, outs: tuple, key: tuple) -> None:
    """A stage's outputs must have the layout its next stage keeps for
    ``key``; else that stage would receive into the wrong shapes or dtypes
    (a stage's own change, such as its parameters cast with ``.to()``, is
    not in the key, which every rank must compute alike)."""
    got = [(tuple(t.shape), t.dtype) for t in outs]
    if got != sent:
        raise PipelineError(f"a stage's outputs changed layout under one schedule key "
                            f"{key}: {sent} were sent before, now {got} (a stage's "
                            "parameters cast after its first schedule?)")


def _recv_tensors(src: int, group, device, layout) -> tuple[torch.Tensor, ...]:
    return tuple(p2p.recv(torch.empty(shape, dtype=dtype, device=device), src, group)
                 for shape, dtype in layout)


def _as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _stage_call(stage: nn.Module, args: tuple, contexts: Callable | None):
    """The stage on one microbatch; under :func:`remat_stages` checkpointed,
    its recompute (on the card in autograd's own thread) called as a stage
    too."""
    if contexts is None:
        return stage(*args)
    return checkpoint(stage, *args, use_reentrant=False,
                      context_fn=lambda: contexts(lambda: _flag(_IN_STAGE)))


def run_schedule(stage: nn.Module, inputs: tuple, mesh, n_microbatches: int, n_stages: int,
                 loss_fn: Callable | None = None, target: torch.Tensor | None = None,
                 axis: str = "pp"):
    """One GPipe step of this rank's ``stage`` over ``axis``.  ``inputs``
    (stage 0's arguments, the batch on dim 0) are split into
    ``n_microbatches`` along dim 0, as ``target`` is on the last stage;
    every rank of the pp group calls this with the same shapes.  A stage is
    called with the tensors the previous stage returned (a tensor or a
    tuple).  Returns, on the last stage, the merged outputs (without
    ``loss_fn``: each output's microbatches concatenated on dim 0) or the
    microbatch losses ``[M]`` (with it, after the backward); None on the
    other stages."""
    group, rank, pp = _pp_group(mesh, axis, n_stages)
    M = n_microbatches
    parts = [microbatch(t, M) for t in inputs]  # refuses a batch that does not split
    train = loss_fn is not None
    contexts = _REMAT.get() if train else None
    last = rank == pp - 1
    prev = dist.get_global_rank(group, rank - 1) if rank > 0 else None
    nxt = None if last else dist.get_global_rank(group, rank + 1)
    targets = microbatch(target, M) if train and last else None
    device = inputs[0].device
    key = _schedule_key(inputs, M, train)
    layouts = _layouts(stage)
    kept, results = [], []
    with _flag(_IN_STAGE):
        for m in range(M):  # the forwards, each as its input arrives
            if rank == 0:
                args = tuple(t[m] for t in parts)
            else:
                if ("got", key) not in layouts:
                    layouts[("got", key)] = _recv_layout(prev, group)
                args = _recv_tensors(prev, group, device, layouts[("got", key)])
                if train:
                    args = tuple(a.requires_grad_() if a.is_floating_point() else a
                                 for a in args)
            out = _stage_call(stage, args, contexts)
            if not last:
                outs = _as_tuple(out)
                sent = layouts.get(("sent", key))
                if sent is not None:
                    _check_layout(sent, outs, key)
                _send_tensors([o.detach() for o in outs], nxt, group, with_layout=sent is None)
                layouts[("sent", key)] = [(tuple(o.shape), o.dtype) for o in outs]
                if train:
                    kept.append((args, outs))
            elif train:
                loss = loss_fn(out, targets[m])
                results.append(loss.detach())
                kept.append((args, (loss,)))
            else:
                results.append(tuple(o.detach() for o in _as_tuple(out)))
        for args, outs in kept:  # the backwards, in the same order
            if last:
                torch.autograd.backward(outs[0])
            else:
                grads = [p2p.recv(torch.empty_like(o), nxt, group) if o.is_floating_point()
                         else None for o in outs]
                pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
                torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
            if rank > 0:
                for a in args:
                    if a.is_floating_point():
                        p2p.send(a.grad if a.grad is not None else torch.zeros_like(a),
                                 prev, group)
    if not last:
        return None
    if train:
        return torch.stack(results)
    merged = tuple(torch.cat(col) for col in zip(*results))
    return merged if len(merged) > 1 else merged[0]


def from_last_stage(values: list[torch.Tensor] | None, mesh, axis: str = "pp",
                    layout: list[tuple] | None = None) -> list[torch.Tensor]:
    """The last stage's ``values`` on every rank of the pp group: one
    broadcast of their shapes and dtypes (none where every rank knows them:
    ``layout``, a ``(shape, dtype)`` a value), then one a tensor."""
    group = mesh.get_group(axis)
    rank, pp = mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))
    src = dist.get_global_rank(group, pp - 1)
    if layout is None:
        meta = [[(tuple(v.shape), v.dtype) for v in values] if rank == pp - 1 else None]
        dist.broadcast_object_list(meta, src=src, group=group)
        layout = meta[0]
    out = []
    for i, (shape, dtype) in enumerate(layout):
        if rank == pp - 1:
            t = values[i].detach().contiguous()
        else:
            t = torch.empty(shape, dtype=dtype, device=_device_of(mesh))
        dist.broadcast(t, src=src, group=group)
        out.append(t)
    return out


def _device_of(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def pipeline_apply(stage: nn.Module, x: torch.Tensor, mesh, n_microbatches: int,
                   n_stages: int, aux: bool = False, axis: str = "pp"):
    """Run ``stage`` as this rank's stage of a pp-stage pipeline over
    microbatches of ``x``, forward only; returns ``(out, aux)`` on every
    rank of the pp group: the last stage's output ``[B, ...]`` and the aux
    loss summed over stages and averaged over the microbatches (0 unless
    ``aux``: then stage 0 is called as ``stage(x_m, aux_m)`` with a ``[1]``
    zero and every stage returns ``(act, aux)``)."""
    inputs = (x,)
    if aux:
        inputs += (torch.zeros(n_microbatches, dtype=torch.float32, device=x.device),)
    out = run_schedule(stage, inputs, mesh, n_microbatches, n_stages, axis=axis)
    if out is not None and not aux:
        out = (out,)
    merged = from_last_stage(None if out is None else list(out), mesh, axis)
    if aux:
        return merged[0], merged[1].mean()
    return merged[0], torch.zeros((), dtype=torch.float32, device=merged[0].device)
