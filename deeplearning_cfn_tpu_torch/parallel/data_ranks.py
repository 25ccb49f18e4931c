"""Reductions over the whole batch when each rank holds a shard of it.

The JAX trainer's data-parallel step is one GSPMD program over the global
batch, so every reduction a model or a loss makes over the batch axis is the
global batch's: BatchNorm's statistics (``models/vgg.py``: "global batch
statistics under GSPMD = free SyncBN") and the count a loss divides by
(BERT's masked positions, RetinaNet's positive anchors).  The port runs the
model and the loss on each rank's shard and averages the gradients (the
dp step's sync, FSDP2) and the reported metrics.  The trainer names the ranks that split the
batch around each step (:func:`data_ranks`); inside it:

- :func:`global_sum` all-reduces a tensor over them, differentiably (its
  backward all-reduces the gradient, which the gradient average then divides
  back): BatchNorm's f32 sums;
- :func:`global_count` gives a count's detached sum over them (clamped at a
  floor) and what a rank's local sum divides by so that the mean over the
  data ranks is the global sum over that count: the count over the ranks.

With one data rank, or outside a trainer step, the sum is the identity and
the divisor the local count clamped at the floor, so a one-device step runs
the ops it ran before.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar

import torch
import torch.distributed as dist

_CURRENT: ContextVar[tuple | None] = ContextVar("data_ranks", default=None)


@contextlib.contextmanager
def data_ranks(group, count: int):
    """The ranks of ``group`` (``count`` of them) split the batch inside the
    block; ``count`` 1 means there is nothing to reduce over."""
    token = _CURRENT.set((group, count) if count > 1 else None)
    try:
        yield
    finally:
        _CURRENT.reset(token)


def current_data_ranks() -> tuple | None:
    """``(group, count)`` of the enclosing :func:`data_ranks`, or None."""
    return _CURRENT.get()


def data_rank_count() -> int:
    current = _CURRENT.get()
    return 1 if current is None else current[1]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data ranks, with a gradient; ``t`` on one rank."""
    current = _CURRENT.get()
    if current is None:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=current[0])


def global_count(count: torch.Tensor, floor: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """``(total, divisor)`` for a count-normalised mean: ``total`` is
    ``max(count summed over the data ranks, floor)``, detached (JAX's
    normaliser, the same on every rank), and ``divisor`` is ``total / ranks``,
    what a rank's local sum divides by, so that averaging the ranks'
    quotients (the gradient average, the metric average) gives the global
    sum over ``total``.  On one rank both are ``max(count, floor)``."""
    current = _CURRENT.get()
    if current is None:
        total = count.clamp_min(floor)
        return total, total
    total = count.detach().clone()
    dist.all_reduce(total, group=current[0])
    total = total.clamp_min(floor)
    return total, total / current[1]
