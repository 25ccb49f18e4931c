"""Deterministic shard assignment math (docs/DATA.md §assignment) — a copy
of ``deeplearning_cfn_tpu/train/datastream/assignment.py``.

Everything here is a pure function of ``(seed, epoch, topology)`` — no
IO, no clocks, no process state — which is what makes the data plane
byte-deterministic per seed AND resumable from a fresh process: any host
can recompute any other host's assignment from the checkpoint envelope
alone.

Two levels of shuffle (the global-shuffle scheme of the native loader,
lifted to shard granularity so hosts never need the global record index):

- ``shard_permutation(seed, epoch, n_shards)``: one permutation of the
  shard ids per epoch.  Host ``i`` of ``H`` owns positions
  ``i, i+H, i+2H, ...`` of the permuted list — an exact partition for
  any (n_shards, H), never off by one.
- ``record_permutation(seed, epoch, shard_id, n)``: the within-shard
  read order.  It is keyed by shard id, NOT by host — so when a live
  reshard moves a half-read shard to a surviving host, the survivor
  continues the same permutation from the recorded offset and every
  record is still consumed exactly once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np


def _rng(*key: int) -> np.random.Generator:
    # SeedSequence hashes the whole key tuple; distinct (seed, epoch,
    # shard) tuples get statistically independent streams, and the same
    # tuple gives the identical stream on every host and every process.
    return np.random.default_rng(np.random.SeedSequence([int(k) for k in key]))


def shard_permutation(seed: int, epoch: int, n_shards: int) -> tuple[int, ...]:
    """The epoch's global shard order — the coarse half of the shuffle."""
    if n_shards <= 0:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    return tuple(int(s) for s in _rng(seed, epoch).permutation(n_shards))


def record_permutation(
    seed: int, epoch: int, shard_id: int, n_records: int
) -> np.ndarray:
    """Within-shard read order — the fine half of the shuffle.  Keyed by
    shard id so the order is host-independent (see module docstring)."""
    if n_records < 0:
        raise ValueError(f"n_records must be >= 0, got {n_records}")
    return _rng(seed, epoch, 1 + shard_id).permutation(n_records)


def assign_shards(
    hosts: Sequence[str], n_shards: int, seed: int, epoch: int
) -> dict[str, tuple[int, ...]]:
    """Exact per-host partition of the epoch's permuted shard list.

    ``hosts`` must already be in contract order
    (``ClusterContract.datastream_hosts()``): the assignment is positional,
    so every host computes the same answer without coordination.
    """
    if not hosts:
        raise ValueError("assign_shards needs at least one host")
    if len(set(hosts)) != len(hosts):
        raise ValueError(f"duplicate hosts in {hosts!r}")
    perm = shard_permutation(seed, epoch, n_shards)
    return {
        host: tuple(perm[i :: len(hosts)]) for i, host in enumerate(hosts)
    }


@dataclass(frozen=True)
class ShardWork:
    """One unit of remaining work: a shard plus how many records of its
    (seed, epoch, shard)-permuted order are already consumed."""

    shard_id: int
    offset: int = 0

    def to_json(self) -> list[int]:
        return [int(self.shard_id), int(self.offset)]

    @classmethod
    def from_json(cls, doc: Sequence[int]) -> "ShardWork":
        return cls(shard_id=int(doc[0]), offset=int(doc[1]))


def reassign_remaining(
    seed: int,
    epoch: int,
    n_shards: int,
    progress: Mapping[int, int],
    shard_sizes: Mapping[int, int],
    survivors: Sequence[str],
) -> dict[str, tuple[ShardWork, ...]]:
    """Redistribute this epoch's unfinished work over the survivors.

    ``progress`` maps shard id -> records already consumed of that
    shard's permuted order (gathered across ALL hosts, dead ones
    included — their cursors come from the last stream-state snapshot).
    Remaining work is every shard whose offset is short of
    ``shard_sizes[shard]``, ordered by the epoch's shard permutation so
    the reassignment itself is a pure function of (seed, epoch,
    progress, survivors) — byte-deterministic per seed.  Round-robin
    over survivors in contract order, same positional rule as
    :func:`assign_shards`.
    """
    if not survivors:
        raise ValueError("reassign_remaining needs at least one survivor")
    remaining: list[ShardWork] = []
    for shard in shard_permutation(seed, epoch, n_shards):
        done = int(progress.get(shard, 0))
        size = int(shard_sizes[shard])
        if done > size:
            raise ValueError(
                f"shard {shard}: progress {done} exceeds size {size}"
            )
        if done < size:
            remaining.append(ShardWork(shard_id=shard, offset=done))
    return {
        host: tuple(remaining[i :: len(survivors)])
        for i, host in enumerate(survivors)
    }
