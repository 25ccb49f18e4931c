"""Input data — the port's own copy of the parts of
``deeplearning_cfn_tpu/train/data.py`` that the Llama and BERT slices use.

``SyntheticTokenDataset``, ``SyntheticMLMDataset`` and
``SyntheticSeqClassificationDataset`` draw the same numpy streams as the JAX
package's for the same seeds, so both frameworks see byte-identical batches.  Batches
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


@dataclass
class SyntheticMLMDataset:
    """Masked-LM batches: 15% of tokens masked; targets are the original
    ids at masked positions and -1 (ignore) elsewhere.  Each token is a fixed
    permutation of the one before it, so the MLM loss can fall.  The
    permutation (the task) is seeded by ``structure_seed`` apart from the
    samples, so a held-out stream (another ``seed``) scores the same task."""

    seq_len: int = 128
    vocab_size: int = 1000
    batch_size: int = 8
    seed: int = 0
    mask_token: int = 0
    mask_prob: float = 0.15
    structure_seed: int = 0

    def batches(self, steps: int) -> Iterator[Batch]:
        rng = np.random.default_rng(self.seed)
        perm = np.random.default_rng(self.structure_seed).permutation(self.vocab_size)
        for _ in range(steps):
            tokens = np.empty((self.batch_size, self.seq_len), np.int32)
            tokens[:, 0] = rng.integers(1, self.vocab_size, self.batch_size)
            for i in range(1, self.seq_len):
                tokens[:, i] = perm[tokens[:, i - 1]]
            masked = rng.random((self.batch_size, self.seq_len)) < self.mask_prob
            x = np.where(masked, self.mask_token, tokens).astype(np.int32)
            y = np.where(masked, tokens, -1).astype(np.int32)
            yield Batch(x=x, y=y)


@dataclass
class SyntheticSeqClassificationDataset:
    """Labelled token sequences: each class has its own categorical
    distribution over the vocabulary (template logits), so labels are
    learnable from token statistics.  With ``template_seed`` the templates
    come from their own stream (the same task for another ``seed``)."""

    batch_size: int = 32
    seq_len: int = 32
    vocab_size: int = 64
    num_classes: int = 4
    seed: int = 0
    template_seed: int | None = None

    def batches(self, steps: int) -> Iterator[Batch]:
        rng = np.random.default_rng(self.seed)
        template_rng = (
            np.random.default_rng(self.template_seed) if self.template_seed is not None else rng
        )
        logits = 2.0 * template_rng.standard_normal((self.num_classes, self.vocab_size))
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        for _ in range(steps):
            y = rng.integers(0, self.num_classes, size=self.batch_size).astype(np.int32)
            x = np.stack(
                [rng.choice(self.vocab_size, size=self.seq_len, p=probs[label]) for label in y]
            ).astype(np.int32)
            yield Batch(x=x, y=y)


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
