"""Remat that nests: whether an enclosing checkpoint recomputes the forward.

``TrainerConfig.remat`` checkpoints the whole loss (``jax.checkpoint`` on the
loss in JAX) and a model may checkpoint each block on its own.  In JAX the
inner policies decide what the outer recomputation saves, and the outer
remat only ever lowers memory.  In PyTorch a selective checkpoint (a
``context_fn`` that caches some ops' outputs) keeps its caches for as long
as the graph that made them: under the outer checkpoint the first forward's
caches stay alive through the outer recomputation, which makes a second set,
and the peak rises.  So the outer checkpoint runs its forward and its
recomputation inside :func:`outer_remat`, and a model that reads
:func:`under_outer_remat` checkpoints its blocks whole there: nothing is
cached, each block is rebuilt from its input in the backward, and the
values are the same.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Iterator

_OUTER: ContextVar[bool] = ContextVar("outer_remat", default=False)


@contextlib.contextmanager
def outer_remat() -> Iterator[None]:
    """Mark the code inside as run (or rerun) by an enclosing checkpoint."""
    token = _OUTER.set(True)
    try:
        yield
    finally:
        _OUTER.reset(token)


def under_outer_remat() -> bool:
    """True inside :func:`outer_remat`."""
    return _OUTER.get()


def outer_remat_contexts() -> tuple:
    """``context_fn`` for the enclosing ``torch.utils.checkpoint``: its
    forward and its recomputation both run inside :func:`outer_remat`."""
    return outer_remat(), outer_remat()
