"""Pipeline stages — counterpart of ``deeplearning_cfn_tpu/parallel/pipeline.py``.

GPipe over the ``pp`` mesh axis: each ``pp`` rank holds one stage's layers
and runs them on ``M`` microbatches of its data shard; activations pass from
stage to stage by send/recv over the ``pp`` group.  The JAX package writes
the schedule as one ``lax.scan`` of ``M + pp - 1`` ticks inside a
``shard_map``; here it is ``torch.distributed.pipelining``'s
``ScheduleGPipe`` over a ``PipelineStage`` for this rank's stage module.
The semantics are JAX's:

- M microbatches flow through pp stages in ``M + pp - 1`` ticks; a stage
  that waits for its first or after its last microbatch computes nothing,
  so the bubble contributes nothing to the output or to an aux term;
- an aux loss the stages carry (``aux=True``: each stage adds its own to
  the ``[1]`` tensor it receives) is summed over the stages and averaged
  over the M microbatches, so a per-call mean (MoE's balancing loss) keeps
  its unpipelined scale;
- a stage count that does not match the mesh's ``pp``, and a batch that
  does not split into M, are refused (:class:`PipelineError`).

With ``loss_fn`` the schedule backpropagates each microbatch's loss as soon
as the last stage has it (GPipe: all forwards, then all backwards), the
gradients accumulating in the stage's parameters; the caller scales each
microbatch's loss so that their sum is the batch's objective (the schedule
scales nothing).

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


def in_stage() -> bool:
    """Whether the caller runs as a stage of :func:`run_schedule` (a model
    whose forward is also its stage's, as the pipelined Llama's is)."""
    return _IN_STAGE.get()


@contextlib.contextmanager
def _stage_calls() -> Iterator[None]:
    token = _IN_STAGE.set(True)
    try:
        yield
    finally:
        _IN_STAGE.reset(token)


def _pp_group(mesh, axis: str, n_stages: int):
    pp = mesh.size(mesh.mesh_dim_names.index(axis))
    if pp <= 1:
        raise PipelineError(f"mesh axis {axis!r} has size {pp}; need > 1")
    if n_stages != pp:
        raise PipelineError(f"the layers are stacked into {n_stages} stages but mesh axis "
                            f"{axis!r} is {pp}")
    return mesh.get_group(axis), mesh.get_local_rank(axis), pp


def run_schedule(stage: nn.Module, inputs: tuple, mesh, n_microbatches: int, n_stages: int,
                 loss_fn: Callable | None = None, target: torch.Tensor | None = None,
                 axis: str = "pp"):
    """One GPipe step of this rank's ``stage`` over ``axis``.  ``inputs``
    (stage 0's arguments, the batch on dim 0) are split into
    ``n_microbatches`` along dim 0; every rank of the pp group calls this
    with the same shapes.  Returns, on the last stage, the merged outputs
    (without ``loss_fn``) or the microbatch losses ``[M]`` (with it, after
    the backward); None on the other stages.  The schedule and its stage
    are built once for each input shape and kept on ``stage``."""
    from torch.distributed.pipelining import PipelineStage, ScheduleGPipe

    group, rank, pp = _pp_group(mesh, axis, n_stages)
    for t in inputs:
        microbatch(t, n_microbatches)  # refuses a batch that does not split
    train = loss_fn is not None
    key = (n_microbatches, train, tuple((tuple(t.shape), t.dtype) for t in inputs))
    cache = stage.__dict__.setdefault("_pipeline_schedules", {})
    if key not in cache:
        pstage = PipelineStage(stage, rank, pp, inputs[0].device, group=group)
        call = [None]  # this step's loss_fn: the schedule is kept across steps
        cache[key] = call, ScheduleGPipe(
            pstage, n_microbatches, scale_grads=False,
            loss_fn=(lambda out, tgt: call[0](out, tgt)) if train else None)
    call, schedule = cache[key]
    call[0] = loss_fn
    losses: list[torch.Tensor] = []
    with _stage_calls():
        if rank == 0:
            out = schedule.step(*inputs)
        elif rank == pp - 1 and train:
            out = schedule.step(target=target, losses=losses)
        else:
            out = schedule.step()
    if rank != pp - 1:
        return None
    return torch.stack([l.detach() for l in losses]) if train else out


def from_last_stage(values: list[torch.Tensor] | None, mesh, axis: str = "pp") -> list[torch.Tensor]:
    """The last stage's ``values`` on every rank of the pp group (one
    broadcast of their shapes, then one a tensor)."""
    group = mesh.get_group(axis)
    rank, pp = mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))
    src = dist.get_global_rank(group, pp - 1)
    meta = [[(tuple(v.shape), v.dtype, v.device) for v in values] if rank == pp - 1 else None]
    dist.broadcast_object_list(meta, src=src, group=group)
    out = []
    for i, (shape, dtype, _) in enumerate(meta[0]):
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
