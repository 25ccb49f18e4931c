"""Slot-based paged K/V cache — counterpart of
``deeplearning_cfn_tpu/serve/paged_cache.py``.

The pool is allocated once and every decode step sees the same shapes;
placement is data:

- the pool holds pages of ``block_size`` tokens, ``[L, pages, bs, Hkv, D]``;
- each active slot owns an ordered list of physical page ids (its block
  table); token ``p`` of a slot lives at ``(table[p // bs], p % bs)``;
- a finished request returns its pages to the host-side free list, so
  admission never reallocates device memory.

**The sink page.**  The pool has ``num_blocks + 1`` pages, one more than
the JAX package's.  JAX drops the writes of inactive slots and pad rows by
sending them to the out-of-range block id ``num_blocks`` under
``mode="drop"``.  In PyTorch an out-of-range ``index_put_`` on CUDA is a
device-side assert that kills the context, and a boolean mask would give
the write a data-dependent shape, which a CUDA graph cannot capture.  So
those writes go to page ``num_blocks``, the sink: no allocator hands it
out, no block table names it, and ``num_blocks`` reports the usable count.

Gathers through padded table entries (0) read live pages of other slots;
the attention validity mask zeroes their weights, so nothing leaks into
an output.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning_cfn_tpu_torch.device import resolve_device
from deeplearning_cfn_tpu_torch.models.llama import LlamaConfig


@dataclass(frozen=True)
class PagedKVCache:
    """Per-layer paged K/V pool, layer axis leading; the last page is the sink."""

    k: torch.Tensor  # [L, num_blocks + 1, block_size, Hkv, D]
    v: torch.Tensor

    @property
    def num_blocks(self) -> int:
        """Usable pages (the sink not counted)."""
        return self.k.shape[1] - 1

    @property
    def sink(self) -> int:
        """Id of the page that takes dropped writes."""
        return self.k.shape[1] - 1

    @property
    def block_size(self) -> int:
        return self.k.shape[2]


def init_paged_cache(
    cfg: LlamaConfig,
    num_blocks: int,
    block_size: int,
    device: torch.device | str | None = None,
) -> PagedKVCache:
    shape = (cfg.n_layers, num_blocks + 1, block_size, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
    )


class BlockAllocator:
    """Host-side free list over the pool's usable page ids.

    Allocation is all or nothing (a request needs its whole table before
    prefill) and lowest id first, so one admission order always gives one
    physical placement, and the soak reports are identical per seed.
    """

    def __init__(self, num_blocks: int):
        if num_blocks <= 0:
            raise ValueError(f"pool needs at least one block, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))  # pop() -> lowest id
        self.recycled = 0  # blocks returned by finished requests

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> list[int] | None:
        """``n`` block ids, or None (allocation deferred) if short."""
        if n <= 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            if not 0 <= b < self.num_blocks:
                raise ValueError(f"block id {b} outside pool of {self.num_blocks}")
            if b in self._free:
                raise ValueError(f"double free of block {b}")
        self._free.extend(blocks)
        self._free.sort(reverse=True)
        self.recycled += len(blocks)
