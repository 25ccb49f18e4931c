"""Input data — the port's own copy of the parts of
``deeplearning_cfn_tpu/train/data.py`` that the Llama slice uses.

``SyntheticTokenDataset`` draws the same numpy stream as the JAX package's
for the same seed, so both frameworks see byte-identical batches.  Batches
reach the card through pinned host memory with a non-blocking copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch


@dataclass
class Batch:
    x: np.ndarray
    y: np.ndarray


@dataclass
class SyntheticTokenDataset:
    """Synthetic LM token streams for BERT/Llama-style trainers."""

    seq_len: int = 512
    vocab_size: int = 32000
    batch_size: int = 8
    seed: int = 0

    def batches(self, steps: int) -> Iterator[Batch]:
        rng = np.random.default_rng(self.seed)
        for _ in range(steps):
            tokens = rng.integers(
                1, self.vocab_size, size=(self.batch_size, self.seq_len), dtype=np.int32
            )
            # Next-token targets: inputs shifted left (causal LM objective).
            yield Batch(x=tokens, y=np.roll(tokens, -1, axis=1))


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``.  For CUDA the array is staged in
    pinned memory and copied without blocking the host; PyTorch's pinned
    allocator keeps the staging buffer alive until the copy is done."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_put_batch(batch: Batch, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return to_device(batch.x, device), to_device(batch.y, device)
