"""Sharded streaming data plane (docs/DATA.md) — counterpart of
``deeplearning_cfn_tpu/train/datastream``, exporting the same names.

Deterministic shard assignment per (host, epoch) derived from the
ClusterContract topology, global shuffle via a seeded shard permutation,
and a resumable :class:`StreamState` that survives a *live reshard*:
shards are reassigned over the surviving topology with zero dropped and
zero duplicated records (chaos scenario ``data-reshard-live``).  Pairs
with :class:`AsyncShardedCheckpointer` — per-host state shards written
off the critical path by a background writer, manifest commit last.
"""

from deeplearning_cfn_tpu_torch.train.datastream.assignment import (
    assign_shards,
    reassign_remaining,
    record_permutation,
    shard_permutation,
    ShardWork,
)
from deeplearning_cfn_tpu_torch.train.datastream.stream import (
    DataStreamPlane,
    HostShardStream,
    StreamState,
)
from deeplearning_cfn_tpu_torch.train.datastream.async_ckpt import (
    AsyncShardedCheckpointer,
    decode_tree,
    encode_tree,
)

__all__ = [
    "AsyncShardedCheckpointer",
    "DataStreamPlane",
    "HostShardStream",
    "ShardWork",
    "StreamState",
    "assign_shards",
    "decode_tree",
    "encode_tree",
    "reassign_remaining",
    "record_permutation",
    "shard_permutation",
]
