"""Checkpoint / resume — counterpart of ``deeplearning_cfn_tpu/train/checkpoint.py``.

The reference delegates checkpointing to frameworks + shared FS (SURVEY §5):
TF MonitoredTrainingSession saves every 60 s to EFS and auto-restores on
restart (cifar10_multi_machine_train.py:103-107); durability comes from EFS
DeletionPolicy: Retain (deeplearning.template:456); recovery is documented
as "recreate the stack reusing the EFS, restart from checkpoint"
(examples/distributed-tensorflow/README.md:85-87).

Two families, as in the JAX package:

- :class:`Checkpointer` saves and restores a trainer's whole state (the
  ``TrainState``: parameters, buffers, optimizer state, step) with
  ``torch.distributed.checkpoint`` (DCP), where the JAX package uses Orbax.
  The same contract: an interval policy in seconds (the
  ``save_checkpoint_secs=60`` analog) plus every-N-steps, ``max_to_keep``,
  async saves that overlap the next steps, idempotent saves, and
  ``restore_latest`` — the recovery story: a recreated cluster pointing at
  retained storage picks up where the lost one stopped, on a mesh of
  another shape if need be (DCP reshards DTensors by their global
  offsets).  Each step is a directory ``step-<8 digits>`` written as
  ``.step-<8 digits>.tmp`` and renamed when complete, so a reader never
  sees half a step.
- The orbax-free envelope family (:class:`StateCheckpointer`,
  :class:`ObjectStoreCheckpointer`, :class:`FallbackCheckpointer`) for
  small JSON state, copied: the same envelope bytes as the JAX package's
  for the same state.

**In place.**  PyTorch updates the state in place where JAX donates it, so
two orderings are explicit here.  A save stages every tensor to host
memory first (:class:`_HostStaging`): on the card the copies run on a side
stream that waits for the step, and the training stream waits for their
event, so the next step's first in-place write comes after them and the
writer reads a consistent step.  A restore loads into the live tensors
(DCP loads in place), so every tensor keeps its address and a CUDA graph
captured before the restore (``trainer.CapturedSteps``) replays on the
restored state.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Sequence

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint import FileSystemReader, FileSystemWriter

from deeplearning_cfn_tpu_torch.utils.logging import get_logger
from deeplearning_cfn_tpu_torch.utils.resilience import CircuitBreaker
from deeplearning_cfn_tpu_torch.utils.timeouts import Clock, MonotonicClock

log = get_logger("dlcfn.checkpoint")

_STEP_DIR = re.compile(r"^step-(\d{8})$")


def _map_tensors(tree: Any, fn) -> Any:
    """``tree`` (dicts, lists, tuples) with ``fn`` applied to every tensor."""
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def _is_dtensor(t: torch.Tensor) -> bool:
    return hasattr(t, "device_mesh")


class _HostStaging:
    """Host copies of a state dict's tensors, taken before a save writes them.

    On the CPU each tensor is cloned.  On the card each is copied into a
    pinned host buffer (kept for the next save of the same structure) on a
    side stream that first waits for the training stream; the training
    stream then waits for the copies' event, so no later in-place update can
    overtake them, and the writer waits for the same event before it reads
    (``ready``).  ``device_ms`` is the copies' time on the card."""

    def __init__(self) -> None:
        self._buffers: dict[int, torch.Tensor] = {}  # by the tensor's place in the dict
        self._stream: torch.cuda.Stream | None = None
        self.ready: torch.cuda.Event | None = None
        self._start: torch.cuda.Event | None = None
        self.bytes = 0

    def stage(self, state_dict: dict) -> dict:
        leaves: list[torch.Tensor] = []
        _map_tensors(state_dict, leaves.append)
        devices = {_local(t).device for t in leaves if _local(t).is_cuda}
        self.bytes = sum(_local(t).numel() * _local(t).element_size() for t in leaves)
        if not devices:
            self.ready = self._start = None
            return _map_tensors(state_dict, lambda t: t.detach().clone())
        if len(devices) > 1:
            raise ValueError(f"a state on several cards: {sorted(map(str, devices))}")
        device = devices.pop()
        main = torch.cuda.current_stream(device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        self._stream.wait_stream(main)
        self._start = torch.cuda.Event(enable_timing=True)
        self.ready = torch.cuda.Event(enable_timing=True)
        index = iter(range(len(leaves)))
        with torch.cuda.stream(self._stream):
            self._start.record()
            staged = _map_tensors(state_dict, lambda t: self._copy(next(index), t))
            self.ready.record()
        main.wait_event(self.ready)
        return staged

    def _copy(self, i: int, t: torch.Tensor) -> torch.Tensor:
        local = _local(t).detach()
        if not local.is_cuda:
            return t.detach().clone()
        buf = self._buffers.get(i)
        if buf is None or not _same_layout(buf, t):
            if _is_dtensor(t):
                # A host DTensor with the card's placements; its local tensor
                # is then swapped for the pinned buffer.
                buf = t.detach().to("cpu")
                buf._local_tensor = torch.empty(local.shape, dtype=local.dtype, pin_memory=True)
            else:
                buf = torch.empty(local.shape, dtype=local.dtype, pin_memory=True)
            self._buffers[i] = buf
        _local(buf).copy_(local, non_blocking=True)
        return buf

    @property
    def device_ms(self) -> float | None:
        if self.ready is None:
            return None
        self.ready.synchronize()
        return self._start.elapsed_time(self.ready)


def _same_layout(buf: torch.Tensor, t: torch.Tensor) -> bool:
    if _is_dtensor(buf) != _is_dtensor(t):
        return False
    if _is_dtensor(t) and (buf.placements != t.placements or buf.shape != t.shape):
        return False
    a, b = _local(buf), _local(t)
    return a.shape == b.shape and a.dtype == b.dtype


class _StagedWriter(FileSystemWriter):
    """DCP's file writer over a state dict this module staged itself: no
    second staging copy, and no read of the host buffers before the copies
    into them have finished."""

    _synchronize_after_execute = False

    def __init__(self, path: Path, ready: torch.cuda.Event | None):
        super().__init__(path)
        self._ready = ready

    def stage(self, state_dict):
        return state_dict

    def write_data(self, plan, planner):
        if self._ready is not None:
            self._ready.synchronize()
        return super().write_data(plan, planner)


def _state_dict_of(state: Any) -> dict:
    """A ``TrainState`` (or module) as its state dict of live tensors; a
    dict of tensors as it is."""
    return state.state_dict() if hasattr(state, "state_dict") else state


@dataclass
class _PendingSave:
    step: int
    tmp: Path
    t0: float
    record: dict
    future: Future | None = None
    error: BaseException | None = None
    done: threading.Event = field(default_factory=threading.Event)


@dataclass
class Checkpointer:
    """Save/restore ``TrainState``s with ``torch.distributed.checkpoint``.

    ``interval_s`` mirrors the reference's save_checkpoint_secs=60;
    ``every_steps`` is the step-based alternative; either triggers a save.
    ``async_save`` returns once the state is staged to host memory and
    writes it on a background thread (``dcp.async_save``); a save waits for
    the one before it, as Orbax's manager does.  Over a process group every
    rank calls ``save``/``restore_latest``/``wait`` together, and DCP talks
    over a gloo group of its own (async writes must not share the training
    group): over every rank, or over ``process_group``'s ranks alone (the
    survivors of a slice loss restoring on their mesh: the default group
    still counts the lost ranks); :meth:`rebind` moves a live checkpointer
    onto the survivors after a live reshard.  ``last_save`` and
    ``last_restore`` hold the latest timings:
    bytes, ``blocking_ms`` (the caller's time in ``save``, of it ``wait_ms``
    for the save before), ``staging_ms`` (the copies' device time, on the
    card), ``write_s`` (save to commit; an async save's record is completed
    when it commits), and the restore's ``ms``."""

    directory: str | Path
    interval_s: float | None = 60.0
    every_steps: int | None = None
    max_to_keep: int = 3
    async_save: bool = True
    process_group: Any = None
    _last_save_t: float = field(default_factory=time.monotonic, repr=False)

    def __post_init__(self) -> None:
        self._dir = Path(self.directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._group = self._new_group()
        self._staging = _HostStaging()
        self._pending: _PendingSave | None = None
        self.last_save: dict = {}
        self.last_restore: dict = {}

    def _new_group(self) -> Any:
        """DCP's gloo group: over ``process_group``'s ranks, made among
        them alone, or over every rank."""
        if self.process_group is not None:
            return dist.new_group(dist.get_process_group_ranks(self.process_group),
                                  backend="gloo", use_local_synchronization=True)
        return dist.new_group(backend="gloo") if dist.is_initialized() else None

    def rebind(self, process_group: Any) -> None:
        """Save and restore over ``process_group``'s ranks from now on: the
        survivors of a live reshard (``Trainer.fit`` calls this on a
        ``"resume"``), whose next save must not wait for the ranks that
        left.  A save in flight spans the old group's ranks: every one of
        them calls :meth:`wait` before the loss (``fit`` does at the pause).
        The old group is left alone (a gloo teardown with peers gone may
        block)."""
        if self._pending is not None:
            raise RuntimeError("a save is in flight over the old ranks: wait() on every "
                               "one of them before rebind()")
        self.process_group = process_group
        self._group = self._new_group()

    def _rank(self) -> int:
        """This rank's index in the checkpoint's group (0 commits)."""
        return dist.get_rank(self._group) if self._group is not None else 0

    def _barrier(self) -> None:
        if self._group is not None:
            dist.barrier(group=self._group)

    def _step_dir(self, step: int) -> Path:
        return self._dir / f"step-{step:08d}"

    # --- policy ----------------------------------------------------------
    def should_save(self, step: int) -> bool:
        if self.every_steps and step > 0 and step % self.every_steps == 0:
            return True
        if self.interval_s is not None and (
            time.monotonic() - self._last_save_t >= self.interval_s
        ):
            return True
        return False

    # --- io ---------------------------------------------------------------
    def all_steps(self) -> list[int]:
        """The committed steps, oldest first."""
        out = []
        for p in self._dir.iterdir():
            m = _STEP_DIR.match(p.name)
            if m and (p / ".metadata").is_file():
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, step: int, state: Any) -> None:
        """Idempotent per step: a final end-of-run save can coincide with a
        step the in-loop policy already saved."""
        step = int(step)
        pending = self._pending
        if step in self.all_steps() or (pending is not None and pending.step == step):
            log.info("checkpoint for step %d already exists; skipping", step)
            return
        t0 = time.perf_counter()
        self._finish_pending()
        waited = time.perf_counter() - t0
        staged = self._staging.stage(_state_dict_of(state))
        tmp = self._dir / f".step-{step:08d}.tmp"
        if self._rank() == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        self._barrier()
        writer = _StagedWriter(tmp, self._staging.ready)
        record = {"step": step, "async": self.async_save, "staged_bytes": self._staging.bytes,
                  "wait_ms": waited * 1e3}
        self.last_save = record  # completed by the commit
        if self.async_save:
            self._pending = pending = _PendingSave(step, tmp, t0, record)
            pending.future = dcp.async_save(staged, storage_writer=writer,
                                            process_group=self._group)
            record["blocking_ms"] = (time.perf_counter() - t0) * 1e3
            pending.future.add_done_callback(lambda f, p=pending: self._written(p, f))
        else:
            dcp.save(staged, storage_writer=writer, process_group=self._group)
            record["blocking_ms"] = (time.perf_counter() - t0) * 1e3
            self._commit(step, tmp, t0, record)
            self._barrier()
        self._last_save_t = time.monotonic()

    def _written(self, pending: _PendingSave, future: Future) -> None:
        """The async write's completion (on the writer's thread): commit."""
        try:
            future.result()
            self._commit(pending.step, pending.tmp, pending.t0, pending.record)
        except BaseException as exc:  # raised to the caller by wait()
            pending.error = exc
        finally:
            pending.done.set()

    def _commit(self, step: int, tmp: Path, t0: float, record: dict) -> None:
        """Rename the complete step into place (rank 0), then drop the
        oldest beyond ``max_to_keep``."""
        final = self._step_dir(step)
        if self._rank() == 0:
            os.replace(tmp, final)
            record["bytes"] = sum(f.stat().st_size for f in final.iterdir())
            for stale in self.all_steps()[: -self.max_to_keep]:
                shutil.rmtree(self._step_dir(stale), ignore_errors=True)
        record["staging_ms"] = self._staging.device_ms
        record["write_s"] = time.perf_counter() - t0
        log.info("checkpoint saved at step %d -> %s", step, final)

    def _finish_pending(self) -> None:
        pending, self._pending = self._pending, None
        if pending is None:
            return
        pending.future.result()
        pending.done.wait()
        if pending.error is not None:
            raise pending.error
        self._barrier()

    def latest_step(self) -> int | None:
        """The newest committed step without restoring — available before
        any state exists, which is exactly when the DATA position must be
        decided: loaders take ``start_batch=latest_step()`` so a resumed
        run continues the record stream instead of replaying the head of
        the shuffle order."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(self, template_state: Any) -> tuple[Any, int] | None:
        """Restore the newest checkpoint into ``template_state`` (a live
        ``TrainState``, on this trainer's device and mesh; or a dict of
        tensors), in place.  Returns (state, step) or None when no
        checkpoint exists.  A ``TrainState``'s ``step`` becomes the saved
        one."""
        step = self.latest_step()
        if step is None:
            return None
        t0 = time.perf_counter()
        sd = _state_dict_of(template_state)
        dcp.load(sd, storage_reader=FileSystemReader(self._step_dir(step)),
                 process_group=self._group)
        if hasattr(template_state, "load_state_dict"):
            template_state.load_state_dict(sd)
        self.last_restore = {"step": step, "ms": (time.perf_counter() - t0) * 1e3}
        log.info("restored checkpoint step %d from %s", step, self.directory)
        return template_state, step

    def restore_raw(self, step: int | None = None) -> tuple[dict, int] | None:
        """Restore the newest checkpoint (or ``step``'s) WITHOUT a template —
        host tensors, whole, in the saved structure (``{"model": ...,
        "optimizer": ..., "step": ...}`` for a ``TrainState``).  The transfer
        path (a classifier checkpoint feeding a detector backbone, run.sh:94's
        BACKBONE.WEIGHTS analog) needs the source tree before any target
        state exists."""
        # DCP's own converter (format_utils.dcp_to_torch_save) loads so.
        from torch.distributed.checkpoint.default_planner import _EmptyStateDictLoadPlanner
        from torch.distributed.checkpoint.state_dict_loader import _load_state_dict

        step = self.latest_step() if step is None else step
        if step is None:
            return None
        sd: dict = {}
        _load_state_dict(sd, storage_reader=FileSystemReader(self._step_dir(step)),
                         planner=_EmptyStateDictLoadPlanner(), no_dist=True)
        log.info("restored raw checkpoint step %d from %s", step, self.directory)
        return sd, step

    def wait(self) -> None:
        """Block until async saves land (call before teardown)."""
        self._finish_pending()

    def close(self) -> None:
        self.wait()


# --- resilient control-plane checkpointing (orbax-free) ---------------------
#
# The classes below checkpoint small JSON-serializable state (trainer
# progress markers, controller bookkeeping) with the durability story the
# chaos suite exercises: every write is atomic (write-temp -> fsync ->
# rename), every restore verifies a content hash, and the
# FallbackCheckpointer degrades local -> object store behind per-tier
# circuit breakers instead of failing the run on the first bad disk.


class CheckpointIO:
    """Filesystem seam for checkpoint bytes; chaos injectors (the JAX
    package's TornDisk and SlowDisk) subclass this to corrupt or delay the
    raw write while the atomic rename protocol above it stays honest."""

    def write_bytes(self, path: Path, data: bytes) -> None:
        with open(path, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())

    def replace(self, src: Path, dst: Path) -> None:
        os.replace(src, dst)

    def read_bytes(self, path: Path) -> bytes:
        return path.read_bytes()


class CheckpointWriteError(OSError):
    """No checkpoint tier accepted the write."""


class TopologyMismatch(ValueError):
    """A checkpoint written on one mesh topology was asked to restore onto
    a different one.  Raised by ``restore_latest(expected_topology=...)``
    so callers get a typed, actionable error at restore time instead of a
    shape crash deep inside the first train step.  The live-reshard
    fallback path (train/reshard.py) restores deliberately-cross-topology
    via the orbax template path, which reshards; THIS checkpointer stores
    raw trees and cannot."""

    def __init__(self, expected: dict, found: dict, step: int):
        self.expected = expected
        self.found = found
        self.step = step
        super().__init__(
            f"checkpoint step {step} was written on topology {found}, "
            f"restore target is {expected}"
        )


# Envelope version 2 added the optional ``mesh_topology`` field; version 3
# adds the optional ``stream_state`` field (the data plane's resumable
# iterator position, train/datastream).  The sha256 covers the STATE body
# only, so every direction stays compatible: v1/v2 readers ignore the extra
# keys, and a v3 reader treats a v1/v2 envelope as having no topology
# constraint and no stream state.
ENVELOPE_VERSION = 3


def _envelope(
    step: int,
    state: dict,
    mesh_topology: dict | None = None,
    stream_state: dict | None = None,
) -> bytes:
    from deeplearning_cfn_tpu_torch.train.metrics import json_safe

    body = json.dumps(json_safe(state), sort_keys=True, allow_nan=False)
    env = {
        "step": step,
        "sha256": hashlib.sha256(body.encode()).hexdigest(),
        "state": json.loads(body),
    }
    if mesh_topology is not None:
        env["version"] = ENVELOPE_VERSION
        env["mesh_topology"] = json_safe(mesh_topology)
    if stream_state is not None:
        env["version"] = ENVELOPE_VERSION
        env["stream_state"] = json_safe(stream_state)
    return json.dumps(env, allow_nan=False).encode()


def _open_envelope(raw: bytes) -> tuple[dict, int, dict | None, dict | None] | None:
    """Parse + verify an envelope; None for torn/corrupt bytes.  The third
    element is the recorded mesh topology (None for v1 envelopes), the
    fourth the recorded stream state (None below v3)."""
    try:
        env = json.loads(raw.decode())
        body = json.dumps(env["state"], sort_keys=True, allow_nan=False)
        if hashlib.sha256(body.encode()).hexdigest() != env["sha256"]:
            return None
        topology = env.get("mesh_topology")
        stream_state = env.get("stream_state")
        return (
            env["state"],
            int(env["step"]),
            topology if isinstance(topology, dict) else None,
            stream_state if isinstance(stream_state, dict) else None,
        )
    except (ValueError, KeyError, TypeError, UnicodeDecodeError):
        return None


def _check_topology(
    expected: dict | None, found: dict | None, step: int
) -> None:
    """v1 envelopes (no recorded topology) and callers that don't care
    (expected=None) always pass; otherwise compare JSON-normalized."""
    if expected is None or found is None:
        return
    norm = lambda d: json.dumps(d, sort_keys=True)  # noqa: E731
    if norm(expected) != norm(found):
        raise TopologyMismatch(expected, found, step)


@dataclass
class StateCheckpointer:
    """Atomic JSON checkpoints: ``state-<step>.json`` written temp-first.

    The rename is the commit point — a writer dying (or a TornDisk
    raising) mid-write leaves only a dot-prefixed temp file that
    ``steps()`` never globs, so ``restore_latest`` cannot observe a
    half-written checkpoint.  The sha256 in the envelope is defense in
    depth against corruption below the rename (bit rot, lying disks).
    """

    directory: str | Path
    max_to_keep: int = 3
    io: CheckpointIO = field(default_factory=CheckpointIO)
    #: duck-typing marker Trainer.fit keys on before passing
    #: ``stream_state=`` (orbax and custom tiers may not accept it)
    accepts_stream_state = True

    def __post_init__(self) -> None:
        self._dir = Path(self.directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        #: the stream state of the last envelope ``restore_latest``
        #: returned (None when absent — v1/v2 envelopes, fresh runs)
        self.last_stream_state: dict | None = None

    def _file(self, step: int) -> Path:
        return self._dir / f"state-{step:08d}.json"

    def steps(self) -> list[int]:
        out = []
        for p in self._dir.glob("state-*.json"):
            try:
                out.append(int(p.stem.split("-", 1)[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(
        self,
        step: int,
        state: dict,
        mesh_topology: dict | None = None,
        stream_state: dict | None = None,
    ) -> Path:
        final = self._file(step)
        tmp = self._dir / f".{final.name}.tmp-{os.getpid()}"
        try:
            self.io.write_bytes(
                tmp, _envelope(step, state, mesh_topology, stream_state)
            )
            self.io.replace(tmp, final)
        finally:
            # A torn write must not litter: the temp either renamed away
            # or gets unlinked here, leaving the directory canonical.
            if tmp.exists():
                tmp.unlink(missing_ok=True)
        self._gc()
        return final

    def restore_latest(
        self, expected_topology: dict | None = None
    ) -> tuple[dict, int] | None:
        """Newest verifiable checkpoint, skipping any that fail the hash.

        ``expected_topology`` (a train/reshard.mesh_topology dict) makes a
        cross-topology restore fail fast with :class:`TopologyMismatch`;
        v1 envelopes carry no topology and are accepted unchanged."""
        for step in reversed(self.steps()):
            try:
                raw = self.io.read_bytes(self._file(step))
            except OSError:
                continue
            opened = _open_envelope(raw)
            if opened is not None:
                state, found_step, topology, stream_state = opened
                _check_topology(expected_topology, topology, found_step)
                self.last_stream_state = stream_state
                return state, found_step
            log.warning(
                "checkpoint step %d failed verification; skipping", step
            )
        return None

    def _gc(self) -> None:
        steps = self.steps()
        for stale in steps[: -self.max_to_keep]:
            self._file(stale).unlink(missing_ok=True)


@dataclass
class ObjectStoreCheckpointer:
    """The same envelope protocol against an ObjectStore (GCS in
    production, LocalObjectStore under test).  Object stores commit
    whole objects, so the put itself is the atomic rename."""

    store: Any  # ObjectStore protocol: put/get/list
    prefix: str = "checkpoints"
    accepts_stream_state = True

    def __post_init__(self) -> None:
        self.last_stream_state: dict | None = None

    def _key(self, step: int) -> str:
        return f"{self.prefix}/state-{step:08d}.json"

    def steps(self) -> list[int]:
        out = []
        for key in self.store.list(self.prefix):
            name = key.rsplit("/", 1)[-1]
            if name.startswith("state-") and name.endswith(".json"):
                try:
                    out.append(int(name[len("state-") : -len(".json")]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(
        self,
        step: int,
        state: dict,
        mesh_topology: dict | None = None,
        stream_state: dict | None = None,
    ) -> str:
        key = self._key(step)
        self.store.put(key, _envelope(step, state, mesh_topology, stream_state))
        return key

    def restore_latest(
        self, expected_topology: dict | None = None
    ) -> tuple[dict, int] | None:
        for step in reversed(self.steps()):
            try:
                raw = self.store.get(self._key(step))
            except (OSError, KeyError):
                continue
            opened = _open_envelope(bytes(raw))
            if opened is not None:
                state, found_step, topology, stream_state = opened
                _check_topology(expected_topology, topology, found_step)
                self.last_stream_state = stream_state
                return state, found_step
        return None


@dataclass
class FallbackCheckpointer:
    """Graceful degradation across checkpoint tiers (local, then object
    store): each tier sits behind its own circuit breaker, a failed write
    falls through to the next tier instead of failing the run, and the
    first open breaker marks the chain degraded (visible in the flight
    journal via the breaker's ``degraded`` event)."""

    tiers: Sequence[tuple[str, Any]]
    failure_threshold: int = 3
    reset_after_s: float = 60.0
    clock: Clock = field(default_factory=MonotonicClock)
    accepts_stream_state = True

    def __post_init__(self) -> None:
        if not self.tiers:
            raise ValueError("FallbackCheckpointer needs at least one tier")
        self.last_stream_state: dict | None = None
        self._breakers = {
            name: CircuitBreaker(
                name=f"checkpoint.{name}",
                failure_threshold=self.failure_threshold,
                reset_after_s=self.reset_after_s,
                clock=self.clock,
            )
            for name, _ in self.tiers
        }
        self.last_save_tier: str | None = None

    @property
    def degraded(self) -> bool:
        return any(b.state != "closed" for b in self._breakers.values())

    def breaker(self, name: str) -> CircuitBreaker:
        return self._breakers[name]

    def save(
        self,
        step: int,
        state: dict,
        mesh_topology: dict | None = None,
        stream_state: dict | None = None,
    ) -> str:
        """Write to the first healthy tier; returns the tier name used."""
        last_err: BaseException | None = None
        for name, tier in self.tiers:
            breaker = self._breakers[name]
            if not breaker.allow():
                continue
            try:
                # Custom tiers predating envelope v2/v3 may not accept
                # the kwargs; only pass what there is to record.
                kwargs: dict = {}
                if mesh_topology is not None:
                    kwargs["mesh_topology"] = mesh_topology
                if stream_state is not None and getattr(
                    tier, "accepts_stream_state", False
                ):
                    kwargs["stream_state"] = stream_state
                tier.save(step, state, **kwargs)
            except Exception as exc:
                breaker.record_failure()
                last_err = exc
                log.warning(
                    "checkpoint tier %r failed at step %d: %s", name, step, exc
                )
                continue
            breaker.record_success()
            if name != self.tiers[0][0]:
                self._record_fallback(name, step)
            self.last_save_tier = name
            return name
        raise CheckpointWriteError(
            f"no checkpoint tier accepted step {step} (last error: {last_err})"
        )

    def restore_latest(self) -> tuple[dict, int] | None:
        """Newest verifiable checkpoint across all tiers (a degraded run
        may have its freshest state on the fallback tier)."""
        best: tuple[dict, int] | None = None
        best_tier: Any = None
        for name, tier in self.tiers:
            try:
                found = tier.restore_latest()
            except Exception as exc:
                log.warning("checkpoint tier %r restore failed: %s", name, exc)
                continue
            if found is not None and (best is None or found[1] > best[1]):
                best = found
                best_tier = tier
        if best is not None:
            self.last_stream_state = getattr(best_tier, "last_stream_state", None)
        return best

    def _record_fallback(self, tier: str, step: int) -> None:
        try:
            from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

            get_recorder().record(
                "checkpoint_fallback", tier=tier, step=step
            )
        except Exception:  # pragma: no cover - journaling is best-effort
            pass
