"""Resumable per-host record streams over DLC1 shard files — a copy of
``deeplearning_cfn_tpu/train/datastream/stream.py``, its batches the port's
``train.data.Batch`` of numpy arrays (``Trainer.fit`` places them).

:class:`HostShardStream` is what one host actually iterates: the shards
:func:`~.assignment.assign_shards` gave it for the epoch, read in the
(seed, epoch, shard)-keyed record permutation, assembled into fixed-size
``train.data.Batch`` buffers (uint8 images stay uint8 — the trainer's
step normalises them on the device).  Its entire position is
a :class:`StreamState`: remaining (shard, offset) work units plus the
epoch RNG key, JSON-safe so the checkpoint envelope can carry it.

:class:`DataStreamPlane` owns one stream per contract host.  In a real
cluster each host runs only its own stream and the plane is the math
that tells everyone the same answer; in-process (tests, chaos) it holds
all of them, which makes it the ground truth a live reshard needs: on
``reshard(surviving_contract)`` it merges every host's cursor — lost
hosts included — and redistributes the epoch's unfinished work over the
survivors, zero dropped and zero duplicated records.

Production caveat, stated rather than hidden: after a *host crash* (as
opposed to the live-reshard path, where the training state survives),
lost cursors are recovered from the last stream-state snapshot, so up
to one checkpoint interval of that host's records may be re-consumed —
exactly-once within a live reshard, at-least-once across crash
recovery.  docs/DATA.md works the math.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterator, Mapping, Sequence

import numpy as np

from deeplearning_cfn_tpu_torch.train.data import Batch
from deeplearning_cfn_tpu_torch.train.datastream.assignment import (
    ShardWork,
    assign_shards,
    reassign_remaining,
    record_permutation,
)
from deeplearning_cfn_tpu_torch.train.records import RecordSpec, read_header
from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.datastream")


def epoch_rng_key(seed: int, epoch: int) -> int:
    """A stable per-epoch key for downstream augmentation RNG — part of
    the resumable state so a restored run draws the same augmentations."""
    return int(np.random.SeedSequence([int(seed), int(epoch), 2]).generate_state(1)[0])


@dataclass(frozen=True)
class StreamState:
    """One host's full stream position, captured at a batch boundary.

    ``work`` is the epoch's remaining (shard, offset) units in
    consumption order — the head unit's offset is the record cursor
    inside the shard currently being read.  ``done`` records the shards
    this host already finished this epoch (shard -> records consumed),
    which is what the plane needs to reconstruct global progress during
    a reshard.  Everything is JSON scalars: the checkpoint envelope
    carries ``to_json()`` verbatim.
    """

    seed: int
    epoch: int
    host: str
    work: tuple[ShardWork, ...]
    done: tuple[tuple[int, int], ...] = ()
    records_epoch: int = 0
    records_total: int = 0

    @property
    def rng_key(self) -> int:
        return epoch_rng_key(self.seed, self.epoch)

    def progress(self) -> dict[int, int]:
        """shard -> records consumed this epoch (done + in-flight)."""
        out = {int(s): int(n) for s, n in self.done}
        out.update({w.shard_id: w.offset for w in self.work})
        return out

    def to_json(self) -> dict[str, Any]:
        return {
            "seed": int(self.seed),
            "epoch": int(self.epoch),
            "host": self.host,
            "rng_key": self.rng_key,
            "work": [w.to_json() for w in self.work],
            "done": [[int(s), int(n)] for s, n in self.done],
            "records_epoch": int(self.records_epoch),
            "records_total": int(self.records_total),
        }

    @classmethod
    def from_json(cls, doc: Mapping[str, Any]) -> "StreamState":
        return cls(
            seed=int(doc["seed"]),
            epoch=int(doc["epoch"]),
            host=str(doc["host"]),
            work=tuple(ShardWork.from_json(w) for w in doc["work"]),
            done=tuple((int(s), int(n)) for s, n in doc.get("done", ())),
            records_epoch=int(doc.get("records_epoch", 0)),
            records_total=int(doc.get("records_total", 0)),
        )


class HostShardStream:
    """One host's deterministic, resumable batch iterator.

    Snapshots (``stream_state()``) and reshard splices
    (``apply_reshard()``) are only valid at batch boundaries — every
    record pulled from a shard is in a batch already yielded, so the
    recorded offsets never straddle a half-assembled batch.
    """

    def __init__(
        self,
        paths: Sequence[str | Path],
        spec: RecordSpec,
        batch_size: int,
        host: str,
        hosts: Sequence[str],
        seed: int = 0,
        drop_remainder: bool = False,
        loop: bool = True,
        state: StreamState | Mapping[str, Any] | None = None,
    ):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if host not in hosts:
            raise ValueError(f"host {host!r} not in topology {list(hosts)!r}")
        self.paths = [Path(p) for p in paths]
        self.spec = spec
        self.batch_size = int(batch_size)
        self.host = host
        self.hosts = tuple(hosts)
        self.seed = int(seed)
        self.drop_remainder = bool(drop_remainder)
        self.loop = bool(loop)
        # Shard id IS the index into ``paths`` — global, shared by every
        # host, so assignments transfer across processes by id alone.
        self.shard_sizes: dict[int, int] = {}
        for sid, p in enumerate(self.paths):
            record_size, n = read_header(p)
            if record_size != spec.record_size:
                raise ValueError(
                    f"{p}: record_size {record_size} != spec {spec.record_size}"
                )
            self.shard_sizes[sid] = int(n)
        self.records_total = 0
        self._shard_cache: dict[int, np.ndarray] = {}
        if state is not None:
            st = (
                state
                if isinstance(state, StreamState)
                else StreamState.from_json(state)
            )
            if st.seed != self.seed:
                raise ValueError(
                    f"restored stream seed {st.seed} != configured {self.seed}"
                )
            if st.host != host:
                raise ValueError(
                    f"restored stream is for host {st.host!r}, not {host!r}"
                )
            self.epoch = st.epoch
            self._work: list[ShardWork] = list(st.work)
            self._done: dict[int, int] = {s: n for s, n in st.done}
            self._records_epoch = st.records_epoch
            self.records_total = st.records_total
        else:
            self.epoch = 0
            self._work = self._epoch_work(0)
            self._done = {}
            self._records_epoch = 0

    # --- assignment -------------------------------------------------------
    def _epoch_work(self, epoch: int) -> list[ShardWork]:
        assigned = assign_shards(
            self.hosts, len(self.paths), self.seed, epoch
        )[self.host]
        return [ShardWork(shard_id=s) for s in assigned]

    # --- introspection ----------------------------------------------------
    @property
    def records_per_epoch(self) -> int:
        """This host's record count for the CURRENT epoch's work list."""
        consumed = self._records_epoch
        remaining = sum(
            self.shard_sizes[w.shard_id] - w.offset for w in self._work
        )
        return consumed + remaining

    @property
    def records_remaining(self) -> int:
        return sum(self.shard_sizes[w.shard_id] - w.offset for w in self._work)

    @property
    def rng_key(self) -> int:
        return epoch_rng_key(self.seed, self.epoch)

    def stream_state(self) -> StreamState:
        return StreamState(
            seed=self.seed,
            epoch=self.epoch,
            host=self.host,
            work=tuple(self._work),
            done=tuple(sorted(self._done.items())),
            records_epoch=self._records_epoch,
            records_total=self.records_total,
        )

    def progress(self) -> dict[int, int]:
        return self.stream_state().progress()

    # --- reshard seam -----------------------------------------------------
    def apply_reshard(
        self, work: Sequence[ShardWork], hosts: Sequence[str]
    ) -> None:
        """Splice in the post-reshard work list (from
        :func:`reassign_remaining`) and the surviving topology.  The new
        topology also governs every FUTURE epoch's assignment, so the
        whole run stays a pure function of (seed, loss events)."""
        if self.host not in hosts:
            raise ValueError(
                f"host {self.host!r} is not in the surviving topology"
            )
        self.hosts = tuple(hosts)
        self._work = list(work)
        # Offsets of shards this host had partially read but just lost
        # to another survivor stay OUT of ``done`` — their remaining
        # records are someone else's work units now.
        kept = {w.shard_id for w in self._work}
        self._done = {
            s: n
            for s, n in self._done.items()
            if n == self.shard_sizes[s] or s in kept
        }
        self._shard_cache = {
            s: a for s, a in self._shard_cache.items() if s in kept
        }

    # --- reading ----------------------------------------------------------
    def _shard_rows(self, shard_id: int) -> np.ndarray:
        rows = self._shard_cache.get(shard_id)
        if rows is None:
            n = self.shard_sizes[shard_id]
            raw = np.fromfile(
                self.paths[shard_id],
                dtype=np.uint8,
                offset=16,  # records.HEADER.size
                count=n * self.spec.record_size,
            )
            rows = raw.reshape(n, self.spec.record_size)
            self._shard_cache[shard_id] = rows
        return rows

    def _next_rows(self, want: int) -> np.ndarray | None:
        """Up to ``want`` records from the head of the work list; None at
        end of epoch.  Every returned record is committed to the cursor."""
        if not self._work:
            return None
        head = self._work[0]
        size = self.shard_sizes[head.shard_id]
        perm = record_permutation(self.seed, self.epoch, head.shard_id, size)
        take = min(want, size - head.offset)
        idx = perm[head.offset : head.offset + take]
        rows = self._shard_rows(head.shard_id)[idx]
        new_offset = head.offset + take
        if new_offset == size:
            self._done[head.shard_id] = size
            self._shard_cache.pop(head.shard_id, None)
            self._work.pop(0)
        else:
            self._work[0] = ShardWork(head.shard_id, new_offset)
        self._records_epoch += take
        self.records_total += take
        return rows

    def _advance_epoch(self) -> None:
        self.epoch += 1
        self._work = self._epoch_work(self.epoch)
        self._done = {}
        self._records_epoch = 0

    def batches(self, steps: int | None = None) -> Iterator[Batch]:
        """Decoded batches; crosses epochs when ``loop``.  A batch never
        spans an epoch boundary: the epoch tail is yielded partial
        (``drop_remainder=False``, the exactly-once default) or dropped
        (``drop_remainder=True``, for shape-static training loops)."""
        yielded = 0
        while steps is None or yielded < steps:
            parts: list[np.ndarray] = []
            have = 0
            while have < self.batch_size:
                rows = self._next_rows(self.batch_size - have)
                if rows is None:
                    break
                parts.append(rows)
                have += len(rows)
            if have < self.batch_size:
                # End of epoch mid-batch (or an empty assignment).
                if have and not self.drop_remainder:
                    yield self._decode(np.concatenate(parts))
                    yielded += 1
                if not self.loop:
                    return
                self._advance_epoch()
                if self.records_per_epoch == 0:
                    # This host owns nothing (more hosts than shards) —
                    # an empty stream, not an infinite spin.
                    return
                continue
            yield self._decode(np.concatenate(parts) if len(parts) > 1 else parts[0])
            yielded += 1

    def _decode(self, buf: np.ndarray) -> Batch:
        arrays = self.spec.decode_batch(np.ascontiguousarray(buf))
        return Batch(x=arrays["x"], y=arrays["y"])


class DataStreamPlane:
    """All hosts' streams plus the reshard/telemetry math over them.

    ``contract`` is a ``cluster.contract.ClusterContract`` (duck-typed:
    only ``datastream_hosts()`` is used); the host ordering it defines
    is load-bearing — see assignment.py.
    """

    def __init__(
        self,
        contract: Any,
        paths: Sequence[str | Path],
        spec: RecordSpec,
        batch_size: int,
        seed: int = 0,
        drop_remainder: bool = False,
        loop: bool = True,
        states: Mapping[str, Any] | None = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.contract = contract
        self.paths = [Path(p) for p in paths]
        self.spec = spec
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.hosts = tuple(contract.datastream_hosts())
        self._clock = clock
        self._t0 = clock()
        self.reshards = 0
        # Records consumed by hosts that later left the plane: their
        # streams are deleted at reshard, but what they ate this run is
        # still throughput — snapshot() must not count backwards.
        self._records_retired = 0
        self.streams: dict[str, HostShardStream] = {
            host: HostShardStream(
                self.paths,
                spec,
                batch_size,
                host=host,
                hosts=self.hosts,
                seed=self.seed,
                drop_remainder=drop_remainder,
                loop=loop,
                state=(states or {}).get(host),
            )
            for host in self.hosts
        }

    def stream(self, host: str) -> HostShardStream:
        return self.streams[host]

    def states(self) -> dict[str, dict[str, Any]]:
        return {h: s.stream_state().to_json() for h, s in self.streams.items()}

    # --- reshard ----------------------------------------------------------
    def reshard(self, surviving_contract: Any) -> dict[str, tuple[ShardWork, ...]]:
        """Redistribute the epoch's unfinished work over the survivors.

        Call at a batch boundary (the trainer's reshard seam is one).
        Lost hosts' cursors come from their in-plane streams — the
        authoritative live-reshard story; crash recovery instead feeds
        ``states=`` from the last checkpoint (module docstring).  Hosts
        mid-epoch on DIFFERENT epochs is a protocol violation and raises.
        """
        survivors = tuple(surviving_contract.datastream_hosts())
        lost = [h for h in self.hosts if h not in survivors]
        epochs = {s.epoch for s in self.streams.values()}
        if len(epochs) != 1:
            raise ValueError(
                f"streams disagree on epoch ({sorted(epochs)}); reshard "
                "must happen at a plane-wide batch boundary"
            )
        epoch = epochs.pop()
        progress: dict[int, int] = {}
        for stream in self.streams.values():
            for shard, n in stream.progress().items():
                progress[shard] = progress.get(shard, 0) + n
        sizes = next(iter(self.streams.values())).shard_sizes
        new_work = reassign_remaining(
            self.seed, epoch, len(self.paths), progress, sizes, survivors
        )
        for host in lost:
            self._records_retired += self.streams[host].records_total
            del self.streams[host]
        for host in survivors:
            self.streams[host].apply_reshard(new_work[host], survivors)
        self.hosts = survivors
        self.contract = surviving_contract
        self.reshards += 1
        moved = sum(len(w) for h, w in new_work.items())
        self._record(
            "reshard",
            epoch=epoch,
            lost_hosts=lost,
            survivors=list(survivors),
            work_units=moved,
            records_remaining=int(
                sum(sizes[w.shard_id] - w.offset for ws in new_work.values() for w in ws)
            ),
        )
        log.warning(
            "datastream reshard at epoch %d: lost %s, %d work units over %d survivors",
            epoch,
            lost,
            moved,
            len(survivors),
        )
        return new_work

    # --- telemetry --------------------------------------------------------
    def snapshot(self) -> dict[str, Any]:
        elapsed = max(self._clock() - self._t0, 1e-9)
        remaining = {h: s.records_remaining for h, s in self.streams.items()}
        total = self._records_retired + sum(
            s.records_total for s in self.streams.values()
        )
        return {
            "hosts": len(self.streams),
            "shards": len(self.paths),
            "records_total": int(total),
            "records_per_s": round(total / elapsed, 3),
            "shard_lag": int(max(remaining.values()) - min(remaining.values()))
            if remaining
            else 0,
            "reshards": self.reshards,
            "epoch": min((s.epoch for s in self.streams.values()), default=0),
        }

    def journal_progress(self) -> dict[str, Any]:
        """One plane-level ``datastream`` progress event plus one per
        host — the fold behind ``dlcfn_datastream_*`` gauges."""
        snap = self.snapshot()
        self._record("progress", **snap)
        for host, stream in self.streams.items():
            self._record(
                "host_progress",
                host=host,
                records=stream.records_total,
                remaining=stream.records_remaining,
                epoch=stream.epoch,
            )
        return snap

    def _record(self, event: str, **fields: Any) -> None:
        try:
            from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

            get_recorder().record("datastream", event=event, **fields)
        except Exception:  # pragma: no cover - journaling is best-effort
            pass
