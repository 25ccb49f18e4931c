"""Point-to-point between ranks, through the host where the group cannot
take the tensor.

gloo's collectives take CUDA tensors, but its ``send``/``recv`` and
``batch_isend_irecv`` do not: the TCP transport writes from the device
pointer and fails (``writev ... Bad address``, the rank aborted;
``tools/gloo_cuda_probe.py`` on an H100 with torch 2.11).  Every
point-to-point of the port goes through this module instead: GPipe's
activations and their gradients (``parallel/pipeline.py``) and ring
attention's k/v blocks (``parallel/ring_attention.py``).

- A CUDA tensor on a gloo group is staged: copied into a pinned host buffer
  (the copy waits for the stream's work that made it), sent from there; a
  receive lands in a pinned host buffer and is copied into the CUDA tensor
  on the current stream, in the stream's order.  Only the bytes on the wire
  pass through the host: the model, its activations and kernels stay on the
  card.
- A CPU tensor, or any tensor on another backend (NCCL), goes straight
  through ``torch.distributed``.

``staged_bytes`` counts the bytes this process sent through the host
staging (:func:`reset_staged_bytes` zeroes it).  :func:`force_staging`
stages CPU tensors too, through ordinary host buffers, so that the CPU
tests run the staged path.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

import torch
import torch.distributed as dist

#: Bytes this process has sent through the host staging.
staged_bytes = 0

_FORCE: contextvars.ContextVar[bool] = contextvars.ContextVar("p2p_force_staging",
                                                              default=False)


def reset_staged_bytes() -> None:
    global staged_bytes
    staged_bytes = 0


@contextlib.contextmanager
def force_staging() -> Iterator[None]:
    """Stage every tensor, CPU tensors too (through unpinned host buffers)."""
    token = _FORCE.set(True)
    try:
        yield
    finally:
        _FORCE.reset(token)


def staged(t: torch.Tensor, group=None) -> bool:
    """Whether ``t`` crosses ``group`` through a host buffer: a CUDA tensor
    on a gloo group (or any tensor under :func:`force_staging`)."""
    if _FORCE.get():
        return True
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _host_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=t.device.type == "cuda")


def _outgoing(t: torch.Tensor, group) -> torch.Tensor:
    """What goes on the wire for ``t``: ``t``, or its host copy."""
    global staged_bytes
    t = t.contiguous()
    if not staged(t, group):
        return t
    host = _host_like(t)
    host.copy_(t)  # waits for the work that made t
    staged_bytes += host.numel() * host.element_size()
    return host


def _incoming(t: torch.Tensor, group) -> torch.Tensor:
    """Where ``t``'s bytes arrive: ``t`` itself, or a host buffer."""
    return _host_like(t) if staged(t, group) else t


def _land(t: torch.Tensor, buf: torch.Tensor) -> None:
    if buf is not t:
        t.copy_(buf, non_blocking=buf.is_pinned())


def send(t: torch.Tensor, dst: int, group=None) -> None:
    """Send ``t`` to global rank ``dst`` of ``group``."""
    dist.send(_outgoing(t, group), dst, group=group)


def recv(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Receive into ``t`` (contiguous) from global rank ``src``; returns ``t``."""
    buf = _incoming(t, group)
    dist.recv(buf, src, group=group)
    _land(t, buf)
    return t


def exchange(sends: list[tuple[torch.Tensor, int]], recvs: list[tuple[torch.Tensor, int]],
             group=None) -> None:
    """Post every send ``(tensor, dst)`` and receive ``(tensor, src)`` at
    once (``batch_isend_irecv``) and wait for all of them; each receive
    fills its tensor (contiguous)."""
    ops, landing = [], []
    for t, dst in sends:
        ops.append(dist.P2POp(dist.isend, _outgoing(t, group), dst, group))
    for t, src in recvs:
        buf = _incoming(t, group)
        ops.append(dist.P2POp(dist.irecv, buf, src, group))
        landing.append((t, buf))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for t, buf in landing:
        _land(t, buf)


def rotate(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Each tensor sent to the next rank of ``group``'s ring (None: every
    rank's) and received from the previous one: the new tensors, in order."""
    group = dist.group.WORLD if group is None else group
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prev = dist.get_global_rank(group, (rank - 1) % n)
    out = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in tensors]
    exchange([(t, nxt) for t in tensors], [(r, prev) for r in out], group)
    return out
