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

The card's backward runs a recomputation in autograd's own thread, where the
caller's context variables are unset, so :func:`outer_remat_contexts` sets
again what the forward saw: the data ranks, the remat flags, and every
variable a module above this one registered with :func:`carry_into_recompute`
(Llama's forced attention kind).
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Callable, ContextManager, Iterator

from deeplearning_cfn_tpu_torch.parallel.data_ranks import current_data_ranks, data_ranks

_OUTER: ContextVar[bool] = ContextVar("outer_remat", default=False)
# Context variables a recomputation sets again (carry_into_recompute).
_CARRIED: list[ContextVar] = []


def carry_into_recompute(var: ContextVar) -> ContextVar:
    """Have every recomputation that :func:`outer_remat_contexts` wraps run
    with ``var`` at the value it had where the checkpoint was taken (``var``
    needs a default).  For the modules this one cannot import (a model's
    dispatch override); returns ``var``."""
    _CARRIED.append(var)
    return var


@contextlib.contextmanager
def _set(var: ContextVar, value) -> Iterator[None]:
    token = var.set(value)
    try:
        yield
    finally:
        var.reset(token)


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


def outer_remat_contexts(*also: Callable[[], ContextManager]) -> tuple:
    """``context_fn`` for the enclosing ``torch.utils.checkpoint``: its
    forward and its recomputation both run inside :func:`outer_remat`, over
    the data ranks the forward saw (``parallel/data_ranks.py``), and inside
    a context of each of ``also``, with the variables of
    :func:`carry_into_recompute` at their values here.  The card's backward
    runs the recomputation in autograd's own thread, where the caller's
    context variables are unset: it must set them again."""
    ranks = current_data_ranks()
    carried = [(var, var.get()) for var in _CARRIED]

    @contextlib.contextmanager
    def run() -> Iterator[None]:
        with contextlib.ExitStack() as stack:
            stack.enter_context(outer_remat())
            if ranks is not None:
                stack.enter_context(data_ranks(*ranks))
            for var, value in carried:
                stack.enter_context(_set(var, value))
            for make in also:
                stack.enter_context(make())
            yield

    return run(), run()
