"""The traffic generators: what a training cell is fed, from the seed alone.

Every run of a seed gets the same pool of batches in the same order; the
first ``distinct`` rows all differ (the pool is drawn whole, then cycled).
Tokens are uniform over the whole vocabulary, targets the next token (the
last position's target wraps and is not scored), as the port's
``SyntheticTokenDataset`` forms them.  Images are uniform uint8 ``[B, H, W,
3]`` with uniform labels; the program normalises them inside its step."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, stream])


def token_pool(seed: int, batches: int, batch: int, seq: int, vocab: int):
    rng = _rng(seed, 1)
    tokens = rng.integers(0, vocab, size=(batches, batch, seq), dtype=np.int64)
    return [(t, np.roll(t, -1, axis=1)) for t in tokens]


def image_pool(seed: int, batches: int, batch: int, size: int, classes: int):
    rng = _rng(seed, 2)
    labels = rng.integers(0, classes, size=(batches, batch), dtype=np.int64)
    images = rng.integers(0, 256, size=(batches, batch, size, size, 3), dtype=np.uint8)
    return [(x, y) for x, y in zip(images, labels)]


def cycle(pool) -> Iterator:
    """The pool's batches in order, again and again."""
    while True:
        yield from pool


def pool_for(traffic: dict, config: dict, seed: int):
    """The pool a traffic mix names (``kind``: ``tokens`` or ``images``)."""
    kind = traffic["kind"]
    if kind == "tokens":
        return token_pool(seed, traffic["pool_batches"], traffic["global_batch"],
                          traffic["seq_len"], config["vocab_size"])
    if kind == "images":
        return image_pool(seed, traffic["pool_batches"], traffic["global_batch"],
                          traffic["image_size"], config["num_classes"])
    raise ValueError(f"unknown traffic kind {kind!r}")
