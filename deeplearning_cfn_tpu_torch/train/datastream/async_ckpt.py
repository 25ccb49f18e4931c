"""Async sharded checkpointing: enqueue on the step path, write behind it —
counterpart of ``deeplearning_cfn_tpu/train/datastream/async_ckpt.py``,
over tensors, with the same shard and manifest files.

The step-path cost of ``save()`` is staging only and disk-free: every
leaf is snapshotted to host memory (``train.checkpoint._HostStaging``) —
on the card on a side stream that waits for the step, with the training
stream waiting for the copies' event — and the copies go into a
latest-wins pending slot.  The snapshot is load-bearing, not defensive:
the optimizer updates the state IN PLACE at the next step, so a
by-reference enqueue would hand the writer a later step's values (or a
mix of two).  No serialization, no IO on the step path.  The background
writer waits for the copies' event, then does everything expensive off
the critical path: JSON-encode the leaves into ``n_shards`` per-host
shard files (each written atomically: write-temp -> fsync -> rename,
:class:`~deeplearning_cfn_tpu_torch.train.checkpoint.CheckpointIO`
underneath so fault injectors compose), and LAST the manifest — the
commit point.  A writer dying anywhere before the manifest rename leaves
shard litter that ``restore_latest`` never reads and the previous
checkpoint fully restorable; the manifest itself rides the v3 envelope
(:func:`~deeplearning_cfn_tpu_torch.train.checkpoint._envelope`), so it
also carries the mesh topology and the data plane's stream state.

Latest-wins: if the writer is still on step N when steps N+k and N+2k
are enqueued, N+k is superseded (journaled) — checkpoint freshness
degrades under a slow disk, the step loop never does.

The files are the JAX package's, byte for byte, for the same tree: the
leaves in JAX's ``tree_leaves`` order (dict keys sorted, not in insertion
order as ``torch.utils._pytree`` walks them), dtypes under numpy's names,
and bfloat16 through float64 both ways (exact; no ``ml_dtypes``).  A
``TrainState`` is the tree of its ``state_dict()``.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np
import torch

from deeplearning_cfn_tpu_torch.train.checkpoint import (
    CheckpointIO,
    _check_topology,
    _envelope,
    _HostStaging,
    _map_tensors,
    _open_envelope,
)
from deeplearning_cfn_tpu_torch.train.optimizers import host_whole
from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.datastream.ckpt")


# --- exact pytree <-> JSON codec --------------------------------------------
#
# The envelope's JSON body must round-trip train state BIT-IDENTICALLY
# (the resume-reproduces-the-loss-sequence acceptance bar).  Python's
# repr of a float is the shortest string that round-trips the float64,
# and float32/bfloat16 -> float64 is exact, so tolist() -> json -> cast
# back to the recorded dtype loses nothing for every dtype the trainer
# uses.


def _is_state(tree: Any) -> bool:
    """A ``TrainState`` (or module): a tree through its state dict."""
    return hasattr(tree, "state_dict") and hasattr(tree, "load_state_dict")


def _leaves(tree: Any) -> list:
    """The leaves in ``jax.tree_util.tree_leaves``'s order: dict keys
    sorted, sequences in order, None empty."""
    if tree is None:
        return []
    if _is_state(tree):
        return _leaves(tree.state_dict())
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _leaf_doc(leaf: Any) -> dict[str, Any]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        # bfloat16 -> float64 is exact, and json takes float64.
        data = t.to(torch.float64).tolist() if t.dtype == torch.bfloat16 else t.tolist()
        return {"dtype": name, "shape": list(t.shape), "data": data}
    a = np.asarray(leaf)
    return {"dtype": a.dtype.name, "shape": list(a.shape), "data": a.tolist()}


def encode_tree(tree: Any) -> list[dict[str, Any]]:
    """Flatten a tree of tensors (numpy arrays and scalars too) into JSON
    leaf docs (dtype/shape/data)."""
    return [_leaf_doc(leaf) for leaf in _leaves(tree)]


def _leaf_tensor(doc: dict[str, Any]) -> torch.Tensor:
    shape = [int(s) for s in doc["shape"]]
    if doc["dtype"] == "bfloat16":
        a = torch.from_numpy(np.array(doc["data"], dtype=np.float64)).to(torch.bfloat16)
    else:
        a = torch.from_numpy(np.array(doc["data"], dtype=doc["dtype"]))
    return a.reshape(shape)


def _rebuild(template: Any, leaves: Any) -> Any:
    if template is None:
        return None
    if isinstance(template, dict):
        out = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def decode_tree(template: Any, docs: Sequence[dict[str, Any]]) -> Any:
    """Rebuild ``template``'s structure from leaf docs — host tensors with
    the recorded dtypes (bit-exact, see above).  A ``TrainState`` template
    is loaded in place (``TrainState.load_state_dict``) and returned."""
    n = len(_leaves(template))
    if n != len(docs):
        raise ValueError(f"template has {n} leaves, checkpoint has {len(docs)}")
    leaves = iter([_leaf_tensor(d) for d in docs])
    if _is_state(template):
        template.load_state_dict(_rebuild(template.state_dict(), leaves))
        return template
    return _rebuild(template, leaves)


def _snapshot(tree: Any) -> tuple[Any, Any]:
    """Host copies of every leaf, so the pending slot survives the in-place
    updates of the next steps; and the event the writer waits for before it
    reads them (None on the CPU, where the copies are done on return).
    Python scalars are immutable and stay as they are.  A ``DTensor`` (a
    state laid out over ranks) is gathered whole here, on the step path:
    the gather is a collective every rank makes at the same save, which
    the writer thread could not make in step with the others."""
    staging = _HostStaging()
    tree = tree.state_dict() if _is_state(tree) else tree
    tree = _map_tensors(tree, lambda t: host_whole(t) if hasattr(t, "device_mesh") else t)
    staged = staging.stage(tree)
    return _map_arrays(staged), staging.ready


def _map_arrays(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_arrays(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_arrays(v) for v in tree)
    return tree.copy() if isinstance(tree, np.ndarray) else tree


@dataclass
class _Pending:
    step: int
    state: Any
    ready: Any  # the staging copies' CUDA event, or None
    mesh_topology: dict | None
    stream_state: dict | None


@dataclass
class AsyncShardedCheckpointer:
    """Background sharded writer with StateCheckpointer's restore contract.

    ``save()`` never blocks on IO (the perf_smoke structural assert);
    ``wait()`` drains before teardown; ``restore_latest(template=...)``
    returns ``(state, step)`` like the other checkpointers, leaves the
    accompanying stream state on ``self.last_stream_state``, and skips
    any manifest whose shards fail verification — a crash mid-write is
    invisible.  ``n_shards`` is the per-host write fan-out (one shard
    file per writer host in production; any value works in-process).
    A state laid out over ranks is gathered by collectives in ``save()``,
    so its ranks must save at the same steps: with ``interval_s`` (each
    rank's own clock) they pass ``group``, the process group over them,
    and ``should_save`` is then their agreed decision (any rank due saves
    on all).  ``save()`` refuses such a state under ``interval_s`` without
    ``group``.
    """

    directory: str | Path
    every_steps: int | None = None
    interval_s: float | None = None
    n_shards: int = 2
    max_to_keep: int = 3
    io: CheckpointIO = field(default_factory=CheckpointIO)
    clock: Callable[[], float] = time.monotonic
    accepts_stream_state: bool = True
    group: Any = None

    def __post_init__(self) -> None:
        if self.n_shards <= 0:
            raise ValueError(f"n_shards must be positive, got {self.n_shards}")
        self._dir = Path(self.directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._work_ready = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._pending: _Pending | None = None
        self._busy = False
        self._stop = False
        self._last_save_t = self.clock()
        self.superseded_total = 0
        self.writes_total = 0
        self.write_failures = 0
        self.last_write_seconds = 0.0
        self.last_stream_state: dict | None = None
        self._thread = threading.Thread(
            target=self._writer_loop, name="async-ckpt-writer", daemon=True
        )
        self._thread.start()

    # --- policy (mirrors checkpoint.Checkpointer) ------------------------
    def should_save(self, step: int) -> bool:
        if self.every_steps and step > 0 and step % self.every_steps == 0:
            return True
        if self.interval_s is None:
            return False
        with self._lock:
            last = self._last_save_t
        due = self.clock() - last >= self.interval_s
        if self.group is not None:
            import torch.distributed as dist

            flag = torch.tensor([int(due)])
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
            due = bool(flag.item())
        return due

    # --- step path --------------------------------------------------------
    def save(
        self,
        step: int,
        state: Any,
        mesh_topology: dict | None = None,
        stream_state: dict | None = None,
    ) -> None:
        """Snapshot-and-enqueue; returns once the host copies are issued
        (on the card they run on a side stream the next step waits for).
        An unstarted pending save is superseded (latest wins)."""
        if self.interval_s is not None and self.group is None and any(
            hasattr(leaf, "device_mesh") for leaf in _leaves(state)
        ):
            raise ValueError("a state laid out over ranks saves on interval_s only with "
                             "group= (the ranks must agree when to save: the save gathers)")
        item = _Pending(int(step), *_snapshot(state), mesh_topology, stream_state)
        with self._lock:
            if self._stop:
                raise RuntimeError("checkpointer is closed")
            if self._pending is not None:
                self.superseded_total += 1
                self._record(
                    "checkpoint_superseded",
                    step=self._pending.step,
                    by=item.step,
                )
            self._pending = item
            self._last_save_t = self.clock()
            self._work_ready.notify()

    # --- background writer ------------------------------------------------
    def _writer_loop(self) -> None:
        while True:
            with self._lock:
                while self._pending is None and not self._stop:
                    self._work_ready.wait()
                if self._pending is None and self._stop:
                    return
                item, self._pending = self._pending, None
                self._busy = True
            try:
                self._write(item)
            except Exception as exc:
                # A failed write (bad disk, chaos injector) costs
                # freshness, never the run — the previous manifest is
                # still the newest valid checkpoint.
                with self._lock:
                    self.write_failures += 1
                self._record(
                    "checkpoint_write_failed", step=item.step, error=str(exc)
                )
                log.warning(
                    "async checkpoint at step %d failed: %s", item.step, exc
                )
            finally:
                with self._lock:
                    self._busy = False
                    self._idle.notify_all()

    def _shard_file(self, step: int, idx: int) -> Path:
        return self._dir / f"ckpt-{step:08d}.shard-{idx:02d}-of-{self.n_shards:02d}.json"

    def _manifest_file(self, step: int) -> Path:
        return self._dir / f"ckpt-{step:08d}.manifest.json"

    def _write(self, item: _Pending) -> None:
        t0 = time.perf_counter()
        if item.ready is not None:
            item.ready.synchronize()
        docs = encode_tree(item.state)
        shard_sha: dict[str, str] = {}
        for idx in range(self.n_shards):
            indices = list(range(idx, len(docs), self.n_shards))
            body = json.dumps(
                {
                    "step": item.step,
                    "shard": idx,
                    "of": self.n_shards,
                    "indices": indices,
                    "leaves": [docs[i] for i in indices],
                },
                allow_nan=False,
            ).encode()
            path = self._shard_file(item.step, idx)
            self._atomic(path, body)
            shard_sha[path.name] = hashlib.sha256(body).hexdigest()
        # Manifest LAST — the commit point.  Until its rename lands, the
        # shard files above are unreachable litter and the previous
        # checkpoint is still the one restore_latest returns.
        manifest = _envelope(
            item.step,
            {"n_leaves": len(docs), "shards": shard_sha},
            mesh_topology=item.mesh_topology,
            stream_state=item.stream_state,
        )
        self._atomic(self._manifest_file(item.step), manifest)
        seconds = time.perf_counter() - t0
        with self._lock:
            self.writes_total += 1
            self.last_write_seconds = seconds
        self._record(
            "checkpoint_write",
            step=item.step,
            seconds=round(seconds, 6),
            shards=self.n_shards,
            leaves=len(docs),
        )
        self._gc()

    def _atomic(self, path: Path, data: bytes) -> None:
        tmp = path.parent / f".{path.name}.tmp-w"
        try:
            self.io.write_bytes(tmp, data)
            self.io.replace(tmp, path)
        finally:
            if tmp.exists():
                tmp.unlink(missing_ok=True)

    # --- restore ----------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for p in sorted(self._dir.glob("ckpt-*.manifest.json")):
            try:
                out.append(int(p.name.split("-")[1].split(".")[0]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore_latest(
        self,
        template: Any = None,
        expected_topology: dict | None = None,
    ) -> tuple[Any, int] | None:
        """Newest manifest whose every shard verifies; skips torn or
        partially-written steps.  With ``template`` the leaf docs are
        rebuilt into its pytree structure; without, the raw docs are
        returned.  The manifest's stream state (if any) lands on
        ``self.last_stream_state``."""
        for step in reversed(self.steps()):
            try:
                raw = self.io.read_bytes(self._manifest_file(step))
            except OSError:
                continue
            opened = _open_envelope(raw)
            if opened is None:
                log.warning("manifest step %d failed verification; skipping", step)
                continue
            meta, found_step, topology, stream_state = opened
            docs = self._read_shards(meta)
            if docs is None:
                log.warning("step %d has torn/missing shards; skipping", step)
                continue
            _check_topology(expected_topology, topology, found_step)
            self.last_stream_state = stream_state
            state = docs if template is None else decode_tree(template, docs)
            return state, found_step
        return None

    def _read_shards(self, meta: dict) -> list[dict[str, Any]] | None:
        docs: dict[int, dict[str, Any]] = {}
        for name, sha in (meta.get("shards") or {}).items():
            try:
                body = self.io.read_bytes(self._dir / name)
            except OSError:
                return None
            if hashlib.sha256(body).hexdigest() != sha:
                return None
            try:
                shard = json.loads(body.decode())
            except ValueError:
                return None
            for i, doc in zip(shard["indices"], shard["leaves"]):
                docs[int(i)] = doc
        if len(docs) != int(meta.get("n_leaves", -1)):
            return None
        return [docs[i] for i in range(len(docs))]

    # --- lifecycle --------------------------------------------------------
    def wait(self, timeout_s: float = 60.0) -> None:
        """Block until the writer drains (call before reading files or
        at teardown).  Bounded — a wedged disk surfaces as an error."""
        deadline = self.clock() + timeout_s
        with self._lock:
            while self._pending is not None or self._busy:
                remaining = deadline - self.clock()
                if remaining <= 0:
                    raise TimeoutError("async checkpoint writer did not drain")
                self._idle.wait(timeout=min(remaining, 0.5))

    def close(self) -> None:
        with self._lock:
            self._stop = True
            self._work_ready.notify_all()
        self._thread.join(timeout=60.0)

    def __enter__(self) -> "AsyncShardedCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _gc(self) -> None:
        steps = self.steps()
        for stale in steps[: -self.max_to_keep]:
            self._manifest_file(stale).unlink(missing_ok=True)
            for idx in range(self.n_shards):
                self._shard_file(stale, idx).unlink(missing_ok=True)

    def _record(self, event: str, **fields: Any) -> None:
        try:
            from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

            get_recorder().record("datastream", event=event, **fields)
        except Exception:  # pragma: no cover - journaling is best-effort
            pass
