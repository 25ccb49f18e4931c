"""Sharding rules — counterpart of ``deeplearning_cfn_tpu/parallel/sharding.py``.

A spec is a tuple with one entry a dimension: a mesh axis name, a tuple of
names, or ``None`` (replicated), as a JAX ``PartitionSpec`` holds them.  The
port reads two things from a parameter's spec:

- its ``fsdp`` dimension, which FSDP2 shards (``placement_fn``); FSDP2
  shards dim 0 unless told otherwise, while the JAX Llama shards the input
  dim of ``wq``/``wk``/``wv``/``w_gate``/``w_up`` and the output dim of
  ``wo``/``w_down``/``embed``;
- its ``ep`` dimension, the expert axis split over the ``ep`` ranks
  (``ops/moe.py``);
- its ``tp`` dimension, split over the ``tp`` ranks
  (``parallel/tensor_parallel.py``): heads and MLP columns on dim 1 of
  ``wq wk wv w_gate w_up output``, on dim 0 of ``wo w_down``, the
  vocabulary on dim 0 of ``embed``.  The JAX specs always put ``fsdp`` and
  ``tp`` on different dims.

A parameter whose spec names no ``fsdp`` dim (norms, the MoE router, arrays
the rule leaves whole) is replicated, as in JAX: the trainer keeps it out of
FSDP2 (``ignored_params``) and averages its gradient over the data ranks
itself.

Under pipeline stages the JAX tree stacks each layer weight into
``[pp, L/pp, ...]`` with the ``"stage"`` rule's ``pp`` on its leading dim
(:func:`stage_specs`); the port's blocks hold one layer each, and each ``pp``
rank holds its stage's blocks (``parallel/pipeline.py``).

The batch is split over ``("dp", "fsdp")`` and the sequence over ``sp``:
each rank takes its contiguous block of the global batch
(:func:`local_batch`), as ``BATCH_SPEC = P(("dp", "fsdp"), "sp")`` and
``make_array_from_process_local_data`` split it in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch

# Logical axis names -> mesh axes (or tuples, or None: replicated).
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("dp", "fsdp"),
    "sequence": "sp",
    "embed": "fsdp",
    "mlp": "tp",
    "heads": "tp",
    "kv": None,
    "vocab": "tp",
    "expert": "ep",
    "layers": None,
    "conv_kernel": None,
    "stage": "pp",
}

MIN_SHARD_ELEMS = 2**14


def spec_for(logical_axes: Sequence[str | None], rules: dict[str, Any] | None = None) -> tuple:
    rules = {**DEFAULT_RULES, **(rules or {})}
    return tuple(rules.get(a) if a is not None else None for a in logical_axes)


def stage_specs(layer_specs: dict[str, tuple]) -> dict[str, tuple]:
    """Prepend the ``pp`` axis to each per-layer spec: the specs of the
    stage-stacked ``[pp, L/pp, ...]`` leaves (JAX ``pipeline.stage_specs``
    over specs that already carry the layer axis)."""
    return {name: ("pp", *spec) for name, spec in layer_specs.items()}


def fsdp_spec_for_shape(shape: Sequence[int], fsdp: int,
                        min_shard_elems: int = MIN_SHARD_ELEMS) -> tuple:
    """The FSDP rule for an array the model gives no spec for: shard the
    largest dim the fsdp size divides; replicate small arrays (below
    ``min_shard_elems`` elements), where sharding buys nothing but latency."""
    shape = tuple(shape)
    if fsdp <= 1 or len(shape) == 0 or math.prod(shape) < min_shard_elems:
        return (None,) * len(shape)
    # Python's sort is stable, as is the JAX package's sorted() of the dims.
    for d in sorted(range(len(shape)), key=lambda d: shape[d], reverse=True):
        if shape[d] % fsdp == 0:
            return tuple("fsdp" if i == d else None for i in range(len(shape)))
    return (None,) * len(shape)


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_dim(spec: Sequence, axis: str) -> int | None:
    """The dim of ``spec`` sharded over mesh ``axis``, or None."""
    for d, entry in enumerate(spec):
        if axis in _names(entry):
            return d
    return None


def fsdp_dim(spec: Sequence) -> int | None:
    return axis_dim(spec, "fsdp")


def tp_dim(spec: Sequence) -> int | None:
    return axis_dim(spec, "tp")


def placement_fn(specs: dict[int, tuple]):
    """``shard_placement_fn`` for ``fully_shard``: each parameter (by
    ``id``) on its spec's ``fsdp`` dim."""
    from torch.distributed.tensor import Shard

    def fn(param: torch.nn.Parameter):
        d = fsdp_dim(specs[id(param)])
        if d is None:
            raise ValueError(f"a parameter {tuple(param.shape)} with no fsdp dim reached FSDP2")
        return Shard(d)

    return fn


def local_batch(x: torch.Tensor, index: int, count: int, sp_index: int = 0,
                sp_count: int = 1) -> torch.Tensor:
    """This data shard's contiguous slice of the global batch ``x``, and of
    its sequence (dim 1) this ``sp`` rank's contiguous block."""
    n = x.shape[0]
    if n % count:
        raise ValueError(f"global batch {n} does not split over {count} data shards")
    per = n // count
    x = x[index * per:(index + 1) * per]
    if sp_count == 1:
        return x
    s = x.shape[1]
    if s % sp_count:
        raise ValueError(f"sequence {s} does not split over sp={sp_count}")
    per = s // sp_count
    return x[:, sp_index * per:(sp_index + 1) * per]
