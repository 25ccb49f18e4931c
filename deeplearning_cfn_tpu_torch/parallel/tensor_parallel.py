"""Tensor and sequence parallelism with explicit collectives.

The JAX package leaves ``tp`` and ``sp`` to GSPMD: the parameter specs put
heads, MLP columns and the vocabulary on ``tp``, the batch spec puts the
sequence on ``sp``, and XLA inserts the collectives.  Here they are written
out, each as a ``torch.autograd.Function`` whose backward is the collective
the forward's transpose needs:

- :class:`CopyToGroup`: the identity forward, a sum over the group backward.
  It stands before the column-split products (``wq wk wv w_gate w_up`` on
  dim 1, ``output``): every rank reads the same input, and each rank's
  share of its gradient comes through its own columns.
- :class:`SumOverGroup`: a sum over the group forward, the identity
  backward.  It follows the row-split products (``wo w_down`` on dim 0),
  whose outputs are partial sums, and the vocab-parallel lookup.
- :class:`GatherFromGroup`: the local parts concatenated along a dim.  With
  ``sum_grads`` (each rank reads another part of the gathered tensor, as
  the fused ``wqkv`` and ``w_gate_up`` columns do, and the keys and values
  gathered over ``sp``) the backward sums the gradient over the group and
  keeps this rank's part; without it (every rank computes the same thing
  from the gathered tensor, as an eval forward does from the logits) it
  keeps this rank's part of the gradient as it is.

The loss is vocab-parallel (:meth:`ModelParallel.nll`): the logits stay
split over ``tp``, and only per-position scalars cross the group.

:class:`ModelParallel` holds a model's ``tp`` and ``sp`` groups, sizes and
ranks, read from the mesh; at size 1 every helper is the identity, so a
model without a mesh runs the ops it ran before.  Parameters whose spec has
a ``tp`` dim become ``DTensor`` s over the mesh's ``tp`` axis
(:func:`distribute_tp`), which FSDP2 then shards over ``fsdp`` on another
dim: the 2-D layout of the JAX specs, and ``full_tensor`` and DCP see the
global tensors.  Inside the forward a block reads the local part
(:func:`local`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from deeplearning_cfn_tpu_torch.parallel import sharding


def local(t: torch.Tensor) -> torch.Tensor:
    """The local part of a ``DTensor`` (differentiably), else ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


class SumOverGroup(torch.autograd.Function):
    """Forward: the sum over ``group``; backward: the identity (every rank
    of the group holds the same gradient of the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class CopyToGroup(torch.autograd.Function):
    """Forward: the identity; backward: the sum over ``group`` of the
    gradient (each rank's share of it comes through its own part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class GatherFromGroup(torch.autograd.Function):
    """Forward: the ranks' parts of ``x`` concatenated along ``dim`` in rank
    order; backward: this rank's part of the gradient, summed over the group
    first when ``sum_grads``."""

    @staticmethod
    def forward(ctx, x, group, dim: int, sum_grads: bool):
        ctx.group, ctx.dim, ctx.sum_grads = group, dim, sum_grads
        ctx.size = x.shape[dim]
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
        rank = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, rank * ctx.size, ctx.size), None, None, None


@dataclass
class ModelParallel:
    """A model's ``tp`` and ``sp`` groups (None at size 1), sizes and ranks."""

    tp: int = 1
    tp_rank: int = 0
    tp_group: object = None
    sp: int = 1
    sp_rank: int = 0
    sp_group: object = None

    @classmethod
    def from_mesh(cls, mesh) -> "ModelParallel":
        if mesh is None:
            return cls()
        out = {}
        for axis in ("tp", "sp"):
            size = mesh.size(mesh.mesh_dim_names.index(axis))
            out[axis] = size
            out[f"{axis}_rank"] = mesh.get_local_rank(axis) if size > 1 else 0
            out[f"{axis}_group"] = mesh.get_group(axis) if size > 1 else None
        return cls(**out)

    def __deepcopy__(self, memo):
        return self  # process groups are not copied with a model

    # --- tp ---------------------------------------------------------------
    def copy_to_tp(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else CopyToGroup.apply(x, self.tp_group)

    def sum_over_tp(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else SumOverGroup.apply(x, self.tp_group)

    def gather_tp(self, x: torch.Tensor, sum_grads: bool) -> torch.Tensor:
        """The tp ranks' column parts of ``x`` (last dim), concatenated."""
        return x if self.tp == 1 else GatherFromGroup.apply(x, self.tp_group, -1, sum_grads)

    def own_columns(self, full: torch.Tensor, widths: list[int]) -> list[torch.Tensor]:
        """Split ``full``'s last dim into the segments of ``widths`` (global
        widths: q, k, v or gate, up) and take this tp rank's contiguous
        share of each, as a split of each segment over ``tp`` gives it."""
        out, start = [], 0
        for w in widths:
            per = w // self.tp
            out.append(full[..., start + self.tp_rank * per:start + (self.tp_rank + 1) * per])
            start += w
        return out

    def embed(self, tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """Vocab-parallel lookup: this rank's rows of the table (``table``
        is its ``[V/tp, d]`` part), zeros for tokens outside them, summed
        over tp."""
        if self.tp == 1:
            return F.embedding(tokens, table)
        rows = table.shape[0]
        start = self.tp_rank * rows
        outside = (tokens < start) | (tokens >= start + rows)
        e = F.embedding((tokens - start).clamp(0, rows - 1), table)
        return self.sum_over_tp(e.masked_fill(outside[..., None], 0))

    def nll(self, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Each position's next-token loss, ``lse(logits) - gold`` in f32,
        reading the compute-dtype logits.  Under tp ``logits`` is this rank's
        block of the vocabulary (``[..., V/tp]``, the rows of ``embed`` or the
        columns of ``output`` it holds) and the loss is vocab-parallel: each
        rank's log-sum-exp, shifted by their largest, summed over tp; the gold
        logit from the rank that holds it, zeros elsewhere, summed over tp.
        No rank holds the whole vocabulary's logits."""
        if self.tp == 1:
            lse = torch.logsumexp(logits.to(torch.float32), dim=-1)
            gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
            return lse - gold.to(torch.float32)
        part = torch.logsumexp(logits.to(torch.float32), dim=-1)
        shift = part.detach().clone()
        dist.all_reduce(shift, op=dist.ReduceOp.MAX, group=self.tp_group)
        lse = shift + torch.log(self.sum_over_tp(torch.exp(part - shift)))
        rows = logits.shape[-1]
        local_id = targets.long() - self.tp_rank * rows
        outside = (local_id < 0) | (local_id >= rows)
        gold = torch.gather(logits, -1, local_id.clamp(0, rows - 1)[..., None])[..., 0]
        return lse - self.sum_over_tp(gold.to(torch.float32).masked_fill(outside, 0.0))

    # --- sp ---------------------------------------------------------------
    def gather_sp(self, x: torch.Tensor) -> torch.Tensor:
        """The sequence (dim 1) gathered over sp; the gradient summed back."""
        return x if self.sp == 1 else GatherFromGroup.apply(x, self.sp_group, 1, True)

    def sum_over_sp_value(self, partial: torch.Tensor) -> torch.Tensor:
        """A scalar whose value is ``partial`` summed over sp and whose
        gradient is ``partial``'s: each sp rank back-propagates its own
        part, and the trainer sums the parameters' gradients over sp."""
        if self.sp == 1:
            return partial
        total = partial.detach().clone()
        dist.all_reduce(total, group=self.sp_group)
        return partial + (total - partial.detach())


def model_parallel(model: nn.Module) -> ModelParallel:
    """The :class:`ModelParallel` of a model (or of its DDP wrapper's)."""
    return getattr(getattr(model, "module", model), "mp", None) or ModelParallel()


def distribute_tp(model: nn.Module, specs: dict[str, tuple], tp_mesh) -> None:
    """Every parameter whose spec names ``tp`` becomes a ``DTensor`` over
    ``tp_mesh`` (1-D), sharded on that dim: each rank keeps its contiguous
    chunk of the whole tensor it holds."""
    from torch.distributed.tensor import DTensor, Shard

    size, rank = tp_mesh.size(), tp_mesh.get_local_rank()
    for name, p in list(model.named_parameters()):
        d = sharding.tp_dim(specs[name])
        if d is None:
            continue
        if p.shape[d] % size:
            raise ValueError(f"{name} {tuple(p.shape)}: dim {d} does not split over tp={size}")
        chunk = p.detach().chunk(size, dim=d)[rank].contiguous()
        dt = DTensor.from_local(chunk, tp_mesh, [Shard(d)], run_check=False,
                                shape=p.shape, stride=p.stride())
        owner, leaf = model, name
        if "." in name:
            path, leaf = name.rsplit(".", 1)
            owner = model.get_submodule(path)
        setattr(owner, leaf, nn.Parameter(dt, requires_grad=p.requires_grad))
