"""Bucketed gradient sync — counterpart of ``deeplearning_cfn_tpu/parallel/overlap.py``.

The hookless data-parallel step lets DDP choose its own buckets (its byte
cap, reverse registration order).  Here the buckets are a plan, and each
bucket's collective is issued from the backward as soon as its last gradient
exists:

- :func:`plan_buckets` partitions a parameter tree (JAX's layout: a nested
  dict, paths as ``keystr`` gives them) deterministically, as JAX's does:
  leaves in sorted path order, each sharded leaf a bucket of its own, the
  replicated leaves filling fused buckets greedily up to the byte target.
- :class:`BucketedGradSync` runs a plan's fused buckets on a model's
  parameters: one ``register_post_accumulate_grad_hook`` a parameter counts
  the bucket's gradients down and issues its all-reduce (async) when the
  last one lands; :meth:`BucketedGradSync.finish` waits for them and writes
  the results back, before the optimizer steps.  The arithmetic is DDP's
  default hook's, element by element: each gradient times ``1/n`` as it is
  copied into the bucket, then summed over the ranks, after every backward
  (the accumulated gradient, as DDP syncs every microbatch); so on two ranks
  the step is bitwise the hookless DDP step's.  A leaf's flat is its
  blocks' gradients in layer order, the JAX ``[L, ...]`` leaf's flat.
- ``compress=True``: each fused bucket goes through the two-phase int8
  exchange (:func:`_sync_fused_int8`) with this rank's error-feedback row,
  held in :class:`ErrorFeedbackState` beside the optimizer state, saved and
  restored with it.
- Sharded (fsdp) leaves stay FSDP2's: its reduce-scatter a unit in the
  backward is the sharded bucket's sync; :func:`_sync_sharded` is that
  operation for one leaf's whole local gradient.

The gates (:func:`_resolve_sync_axes`, the single-rank and stateful-model
refusals) raise JAX's ``ValueError`` messages.  One difference: the port's
batch spec names ``sp`` on dim 1 only when the sequence is split (sp > 1),
so Llama at sp 1 is admitted, where JAX's Llama spec names ``sp`` always
and its gate refuses it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from deeplearning_cfn_tpu_torch.ops.quant import dequantize_flat, quantize_flat

DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024
SYNC_AXES = ("dp", "fsdp")


@dataclass(frozen=True)
class Bucket:
    """One sync unit of the plan: ``fused`` (replicated leaves, one
    all-reduce or int8 exchange) or ``sharded`` (one fsdp-sharded leaf).
    ``indices`` are positions in the tree's flatten order; bucket order is
    path order."""

    kind: str  # "fused" | "sharded"
    indices: tuple[int, ...]
    paths: tuple[str, ...]
    nbytes: int
    numel: int
    shard_dim: int | None = None
    shard_axes: Any = None

    def to_dict(self) -> dict:
        return {"kind": self.kind, "paths": list(self.paths), "nbytes": self.nbytes,
                "numel": self.numel, "shard_dim": self.shard_dim}


@dataclass(frozen=True)
class BucketPlan:
    buckets: tuple[Bucket, ...]
    total_bytes: int
    target_bytes: int

    @property
    def fused(self) -> tuple[Bucket, ...]:
        return tuple(b for b in self.buckets if b.kind == "fused")

    @property
    def sharded(self) -> tuple[Bucket, ...]:
        return tuple(b for b in self.buckets if b.kind == "sharded")

    def to_dict(self) -> dict:
        return {"target_bytes": self.target_bytes, "total_bytes": self.total_bytes,
                "buckets": [b.to_dict() for b in self.buckets]}


def flatten_with_path(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(keystr path, leaf)`` in the flatten order JAX gives a dict tree
    (keys sorted at every level)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], f"{prefix}[{k!r}]")
        return out
    return [(prefix, tree)]


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    import numpy as np

    return np.dtype(dtype).itemsize


def plan_buckets(abstract_params: Any, param_specs: Any,
                 target_bytes: int = DEFAULT_BUCKET_BYTES) -> BucketPlan:
    """Partition a parameter tree into size-targeted sync buckets.
    ``abstract_params`` and ``param_specs`` are nested dicts of the same
    structure (leaves with ``.shape`` and ``.dtype``; specs as tuples, one
    entry a dim); leaves are visited in sorted path order, so the same tree
    always gives the same plan on every rank."""
    if target_bytes <= 0:
        raise ValueError(f"target_bytes must be positive, got {target_bytes}")
    leaves = flatten_with_path(abstract_params)
    specs = [s for _, s in flatten_with_path(param_specs)]
    if len(specs) != len(leaves):
        raise ValueError(f"param_specs has {len(specs)} leaves for {len(leaves)} parameters")
    order = sorted(range(len(leaves)), key=lambda i: leaves[i][0])
    buckets: list[Bucket] = []
    cur: dict[str, Any] = {"idx": [], "paths": [], "bytes": 0, "numel": 0}

    def close_fused() -> None:
        if cur["idx"]:
            buckets.append(Bucket("fused", tuple(cur["idx"]), tuple(cur["paths"]), cur["bytes"],
                                  cur["numel"]))
            cur.update(idx=[], paths=[], bytes=0, numel=0)

    for i in order:
        path, leaf = leaves[i]
        spec = specs[i]
        shape = tuple(leaf.shape)
        sharded = [(d, axes) for d, axes in enumerate(tuple(spec)[:len(shape)])
                   if axes is not None]
        if len(sharded) > 1:
            raise ValueError(f"comms_overlap supports at most one sharded dimension per "
                             f"parameter; {path} has spec {spec}")
        numel = math.prod(shape) if shape else 1
        nbytes = numel * _itemsize(leaf.dtype)
        if sharded:
            close_fused()
            dim, axes = sharded[0]
            buckets.append(Bucket("sharded", (i,), (path,), nbytes, numel, dim, axes))
            continue
        cur["idx"].append(i)
        cur["paths"].append(path)
        cur["bytes"] += nbytes
        cur["numel"] += numel
        if cur["bytes"] >= target_bytes:
            close_fused()
    close_fused()
    return BucketPlan(tuple(buckets), sum(b.nbytes for b in buckets), target_bytes)


# --- int8 error feedback ------------------------------------------------------


class ErrorFeedbackState(NamedTuple):
    """The compressed sync's state beside the optimizer's: ``residual`` holds
    one ``[nd, padded_len]`` f32 array per fused bucket in JAX's layout, of
    which this rank keeps its own row (a ``[1, padded_len]`` tensor; the
    trainer saves it as that row of the global array).  ``inner`` is the
    optimizer whose state it rides beside."""

    residual: tuple
    inner: Any


def _padded_len(numel: int, nd: int) -> int:
    return numel + (-numel) % nd


def init_error_feedback(plan: BucketPlan, nd: int, inner: Any, rows: int | None = None,
                        device=None) -> ErrorFeedbackState:
    """Zero residuals for every fused bucket, wrapped around ``inner``:
    ``rows`` rows each (default ``nd``, the global array; a rank holds 1)."""
    rows = nd if rows is None else rows
    residual = tuple(torch.zeros((rows, _padded_len(b.numel, nd)), dtype=torch.float32,
                                 device=device) for b in plan.fused)
    return ErrorFeedbackState(residual=residual, inner=inner)


# --- per-bucket sync primitives -------------------------------------------------


def _sync_fused_int8(flat: torch.Tensor, residual: torch.Tensor, group,
                     nd: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-phase int8 all-reduce of one fused bucket with error feedback, on
    this rank's ``flat`` and its residual row ``[1, padded_len]``: add the
    residual and quantize the padded bucket with one scale; ``all_to_all``
    the int8 chunks so rank j holds every rank's chunk j, and all-gather the
    scales; dequantize-sum the chunk in f32, requantize it and all-gather
    the int8 chunks back to the whole bucket.  Returns the summed bucket
    (``numel`` values) and the new residual, the phase-1 quantization error
    (the phase-2 error is not fed back), as JAX's."""
    numel = flat.shape[0]
    length = residual.shape[1]
    v = flat.to(torch.float32)
    if length > numel:
        v = torch.cat([v, v.new_zeros(length - numel)])
    v = v + residual[0]
    q, scale = quantize_flat(v)
    new_residual = (v - dequantize_flat(q, scale))[None, :]
    chunk = length // nd
    peer_chunks = torch.empty_like(q)
    dist.all_to_all_single(peer_chunks, q, group=group)
    peer_scales = _all_gather(scale.reshape(1), group, nd)
    segment = torch.sum(peer_chunks.reshape(nd, chunk).to(torch.float32) * peer_scales[:, None],
                        dim=0)
    q2, scale2 = quantize_flat(segment)
    gathered = _all_gather(q2, group, nd)
    scales2 = _all_gather(scale2.reshape(1), group, nd)
    out = gathered.to(torch.float32) * torch.repeat_interleave(scales2, chunk)
    return out[:numel], new_residual


def _all_gather(t: torch.Tensor, group, nd: int) -> torch.Tensor:
    out = t.new_empty((nd * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def _sync_sharded(grad_full: torch.Tensor, shard_group, shard_dim: int,
                  other_groups=()) -> torch.Tensor:
    """Reduce-scatter a whole local gradient down to this rank's shard along
    ``shard_dim`` (contiguous shards in rank order, JAX's tiled
    ``psum_scatter``), then sum over the sync axes the shard does not
    consume (``other_groups``)."""
    n = dist.get_world_size(shard_group)
    g = grad_full.movedim(shard_dim, 0).contiguous()
    out = g.new_empty((g.shape[0] // n, *g.shape[1:]))
    dist.reduce_scatter_tensor(out, g, group=shard_group)
    for grp in other_groups:
        dist.all_reduce(out, group=grp)
    return out.movedim(0, shard_dim)


# --- the gates ----------------------------------------------------------------------


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _resolve_sync_axes(batch_spec: tuple, mesh_sizes: dict[str, int]) -> tuple[str, ...]:
    """The axes the batch's dim 0 is split over, after JAX's checks: the
    batch split on dim 0 only, over the data axes only, every other mesh
    axis trivial."""
    entries = tuple(batch_spec)
    dim0 = entries[0] if entries else None
    if dim0 is None:
        raise ValueError("comms_overlap needs the batch sharded over the data axes on "
                         f"dim 0; got batch spec {batch_spec}")
    for extra in entries[1:]:
        if extra is not None:
            raise ValueError(
                "comms_overlap supports batch sharding on dim 0 only; got "
                f"batch spec {batch_spec} (sequence-sharded inputs must use "
                "the monolithic path)")
    sync_axes = _names(dim0)
    if not set(sync_axes) <= set(SYNC_AXES):
        raise ValueError(f"comms_overlap syncs over {SYNC_AXES}; batch spec {batch_spec} "
                         "shards dim 0 over other mesh axes")
    for name, size in mesh_sizes.items():
        if name not in sync_axes and size != 1:
            raise ValueError(f"comms_overlap requires every non-data mesh axis to be "
                             f"trivial; axis {name!r} has size {size}")
    return sync_axes


def check_sync(plan: BucketPlan, sync_axes: tuple[str, ...], nd: int, accum: int = 1) -> None:
    """JAX's ``build_overlap_grad_fn`` refusals: accumulation below 1, a
    single rank on the data axes, a sharded leaf outside the sync axes."""
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    if nd <= 1:
        raise ValueError("comms_overlap needs more than one device on the data axes "
                         f"(got {nd}); use the monolithic path on a single device")
    for b in plan.sharded:
        shard_tuple = _names(b.shard_axes)
        if not set(shard_tuple) <= set(sync_axes):
            raise ValueError(f"sharded bucket {b.paths[0]} uses mesh axes {shard_tuple} "
                             f"outside the sync axes {sync_axes}")


def check_stateless(buffer_names: list[str]) -> None:
    if buffer_names:
        raise ValueError("comms_overlap requires stateless models (no mutable collections "
                         f"such as BatchNorm stats); got model_state keys {sorted(buffer_names)}")


# --- the engine -------------------------------------------------------------------------


@dataclass
class _Run:
    bucket: int
    flat: torch.Tensor
    work: Any = None
    result: torch.Tensor | None = None


@dataclass
class BucketedGradSync:
    """The plan's fused buckets on live parameters.  ``members[i]`` are the
    parameters of fused bucket ``i`` in its flat order (each leaf's parts in
    layer order); ``group`` the data ranks (``nd`` of them).  With
    ``error_feedback`` the buckets go through the int8 exchange and its
    residual rows are updated in place."""

    members: list[list[torch.nn.Parameter]]
    group: Any
    nd: int
    error_feedback: ErrorFeedbackState | None = None
    issued: list[int] = field(default_factory=list)  # bucket order of the last backward
    # Bytes this rank sent for the last backward's buckets: a ring
    # all-reduce sends 2(n-1)/n of the bucket; the int8 exchange (n-1)/n of
    # the int8 bucket twice, and its scales.
    wire_bytes: float = 0

    def __post_init__(self):
        self._bucket_of = {id(p): i for i, ps in enumerate(self.members) for p in ps}
        self._left = [len(ps) for ps in self.members]
        self._runs: list[_Run] = []
        self._handles = [p.register_post_accumulate_grad_hook(self._ready)
                         for ps in self.members for p in ps]

    def remove(self) -> None:
        for h in self._handles:
            h.remove()

    def _ready(self, p: torch.nn.Parameter) -> None:
        b = self._bucket_of[id(p)]
        self._left[b] -= 1
        if self._left[b] == 0:
            self._issue(b)

    def _flat(self, b: int) -> torch.Tensor:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.members[b]]
        dtype = grads[0].dtype
        for g in grads[1:]:
            dtype = torch.promote_types(dtype, g.dtype)
        # DDP's default arithmetic: the gradient times 1/n as it is copied in.
        return torch.cat([g.reshape(-1).to(dtype) for g in grads]) * (1.0 / self.nd)

    def _issue(self, b: int) -> None:
        run = _Run(b, self._flat(b))
        self.issued.append(b)
        if self.error_feedback is None:
            run.work = dist.all_reduce(run.flat, group=self.group, async_op=True)
            self.wire_bytes += 2 * (self.nd - 1) / self.nd * run.flat.numel() * run.flat.element_size()
        else:
            residual = self.error_feedback.residual[b]
            run.result, new_residual = _sync_fused_int8(run.flat, residual, self.group, self.nd)
            residual.copy_(new_residual)
            self.wire_bytes += 2 * (self.nd - 1) * (residual.shape[1] // self.nd + 4)
        self._runs.append(run)

    def begin(self) -> None:
        """Start a backward: every bucket waits for all its gradients."""
        self._left = [len(ps) for ps in self.members]
        self.issued = []
        self.wire_bytes = 0

    @torch.no_grad()
    def finish(self) -> None:
        """Issue what the backward left (parameters without a gradient sync
        zeros, in bucket order), wait for every bucket and write the summed
        gradients back; ready for the next backward."""
        for b, left in enumerate(self._left):
            if left:
                self._left[b] = 0
                self._issue(b)
        for run in self._runs:
            if run.work is not None:
                run.work.wait()
            out = run.flat if run.result is None else run.result
            offset = 0
            for p in self.members[run.bucket]:
                n = p.numel()
                part = out[offset:offset + n].view(p.shape).to(p.dtype)
                if p.grad is None:
                    p.grad = part.clone()
                else:
                    p.grad.copy_(part)
                offset += n
        self._runs = []
        self._left = [len(ps) for ps in self.members]
