"""The native record loader — the port's own ``ctypes`` binding to
``native/dataloader/dataloader.cpp``, the counterpart of
``deeplearning_cfn_tpu/train/native_loader.py``.

C++ reader threads ``pread`` fixed-size records straight into pooled batch
buffers (record-level shuffle, round-robin sharding over workers, a bounded
queue) and hand finished batches over in ticket order, so the stream is the
same at any thread count; Python only decodes the fields.
``NativeRecordLoader.batches()`` yields the port's
:class:`~deeplearning_cfn_tpu_torch.train.data.Batch`.

The shared library is the port's own build of the unmodified C++ source:
``g++`` writes it under ``build/torch_native/`` at first use, named by a
hash of the source and the flags.  The build holds a file lock and moves a
finished temporary file into place, so processes that start together build
it once; a failed build raises :class:`LoaderError` with the compiler's
output.  :class:`PythonRecordLoader` is the pure-Python fallback with the
same interface and guarantees (not the same shuffle order), and
:func:`open_record_loader` journals a fall back to it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from deeplearning_cfn_tpu_torch.train.data import Batch
from deeplearning_cfn_tpu_torch.train.records import HEADER, RecordSpec, read_header
from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.loader")

_ROOT = Path(__file__).resolve().parents[2]
LOADER_SRC = _ROOT / "native" / "dataloader" / "dataloader.cpp"
BUILD_DIR = _ROOT / "build" / "torch_native"
# native/dataloader/Makefile's flags.
CXX_FLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-pthread", "-shared")

_libs: dict[Path, ctypes.CDLL] = {}


class LoaderError(RuntimeError):
    pass


class ShardFileError(LoaderError):
    """A shard file is missing or truncated: a staging problem (re-stage the
    shard), told apart from a loader problem (a failed build, bad arguments)
    by type.  ``reason`` is ``"missing"`` or ``"truncated"``; ``path`` is
    the file."""

    def __init__(self, path: str | Path, reason: str, detail: str = ""):
        self.path = Path(path)
        self.reason = reason
        msg = f"{path}: {reason} shard file"
        if detail:
            msg = f"{msg} ({detail})"
        super().__init__(msg)


def validate_shards(paths: Sequence[str | Path], spec: RecordSpec) -> None:
    """The checks every loader makes first: each file exists, its header's
    record size is the spec's, and it holds the records its header counts."""
    if not paths:
        raise LoaderError("no record files given")
    for p in paths:
        path = Path(p)
        if not path.exists():
            raise ShardFileError(path, "missing")
        record_size, n_records = read_header(path)
        if record_size != spec.record_size:
            raise LoaderError(
                f"{path}: record_size {record_size} != spec {spec.record_size}"
            )
        want = HEADER.size + n_records * record_size
        have = os.path.getsize(path)
        if have < want:
            raise ShardFileError(
                path,
                "truncated",
                f"header promises {n_records} records "
                f"({want} bytes), file has {have}",
            )


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """Where the loader is built: named by a hash of the source and flags."""
    h = hashlib.sha256(LOADER_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return Path(build_dir) / f"libdlcfn_loader-{h.hexdigest()[:12]}.so"


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``native/dataloader/dataloader.cpp`` into ``build_dir``
    unless it is there, under a file lock (test workers and ranks may start
    together); the output is written to a temporary file and moved into
    place.  Raises :class:`LoaderError` with the compiler's stderr."""
    out = library_path(build_dir)
    if out.exists():
        return out
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise LoaderError("building the native loader needs g++ (or $CXX); none found")
    with open(build_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():  # built by another process while this one waited
                return out
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            try:
                res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(LOADER_SRC)],
                                     capture_output=True, text=True, timeout=600)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise LoaderError(f"building the native loader failed: {e}") from e
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise LoaderError(f"building the native loader failed:\n{res.stderr}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def _load_library(build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """Build (at first use) and load the loader, every function's argument
    and result types declared."""
    path = library_path(build_dir)
    lib = _libs.get(path)
    if lib is not None:
        return lib
    try:
        lib = ctypes.CDLL(str(build_library(build_dir)))
    except OSError as e:
        raise LoaderError(f"loading the native loader failed: {e}") from e
    lib.dlcfn_loader_open.restype = ctypes.c_void_p
    lib.dlcfn_loader_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,  # n_paths
        ctypes.c_int,  # batch_size
        ctypes.c_int,  # n_threads
        ctypes.c_int,  # shard_index
        ctypes.c_int,  # shard_count
        ctypes.c_int,  # shuffle
        ctypes.c_int,  # drop_remainder
        ctypes.c_int,  # loop
        ctypes.c_uint64,  # seed
        ctypes.c_uint64,  # start_batch
        ctypes.c_char_p,  # err_out
        ctypes.c_int,  # err_cap
    ]
    lib.dlcfn_loader_record_size.restype = ctypes.c_uint32
    lib.dlcfn_loader_record_size.argtypes = [ctypes.c_void_p]
    lib.dlcfn_loader_shard_records.restype = ctypes.c_uint64
    lib.dlcfn_loader_shard_records.argtypes = [ctypes.c_void_p]
    lib.dlcfn_loader_batches_per_epoch.restype = ctypes.c_uint64
    lib.dlcfn_loader_batches_per_epoch.argtypes = [ctypes.c_void_p]
    lib.dlcfn_loader_next.restype = ctypes.c_int
    lib.dlcfn_loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.dlcfn_loader_error.restype = ctypes.c_char_p
    lib.dlcfn_loader_error.argtypes = [ctypes.c_void_p]
    lib.dlcfn_loader_close.restype = None
    lib.dlcfn_loader_close.argtypes = [ctypes.c_void_p]
    _libs[path] = lib
    return lib


@dataclass
class NativeRecordLoader:
    """Threaded shuffling reader over DLC1 files.

    ``shard_index``/``shard_count`` split the records round-robin over
    workers.  ``start_batch`` is the global batch index (across epochs) to
    start at: one batch a training step, so a run restored at step N passes
    N and the stream goes on where the lost run stopped; every epoch's
    permutation is a pure function of ``(seed, epoch)``."""

    paths: Sequence[str | Path]
    spec: RecordSpec
    batch_size: int
    n_threads: int = 4
    shard_index: int = 0
    shard_count: int = 1
    shuffle: bool = True
    drop_remainder: bool = True
    loop: bool = True
    seed: int = 0
    start_batch: int = 0
    _handle: int | None = field(default=None, repr=False)

    def __post_init__(self) -> None:
        validate_shards(self.paths, self.spec)
        lib = _load_library()
        c_paths = (ctypes.c_char_p * len(self.paths))(
            *[str(p).encode() for p in self.paths]
        )
        err = ctypes.create_string_buffer(512)
        handle = lib.dlcfn_loader_open(
            c_paths,
            len(self.paths),
            self.batch_size,
            self.n_threads,
            self.shard_index,
            self.shard_count,
            int(self.shuffle),
            int(self.drop_remainder),
            int(self.loop),
            self.seed,
            self.start_batch,
            err,
            len(err),
        )
        if not handle:
            raise LoaderError(err.value.decode() or "loader open failed")
        self._lib = lib
        self._handle = handle
        self._buf = np.empty((self.batch_size, self.spec.record_size), dtype=np.uint8)

    def _live_handle(self) -> int:
        if self._handle is None:
            raise LoaderError("loader is closed")
        return self._handle

    @property
    def shard_records(self) -> int:
        return int(self._lib.dlcfn_loader_shard_records(self._live_handle()))

    @property
    def batches_per_epoch(self) -> int:
        return int(self._lib.dlcfn_loader_batches_per_epoch(self._live_handle()))

    def next_raw(self, copy: bool = True) -> np.ndarray | None:
        """``[n, record_size]`` uint8 of the next batch, or None at the end.

        With ``copy=False`` the array is a view of the loader's one reuse
        buffer, valid only until the next call (which copies the next batch
        over it): consume it (decode, copy to the device) first."""
        handle = self._live_handle()
        n = self._lib.dlcfn_loader_next(
            handle, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if n < 0:
            raise LoaderError(self._lib.dlcfn_loader_error(handle).decode())
        if n == 0:
            return None
        out = self._buf[:n]
        return out.copy() if copy else out

    def batches(self, steps: int | None = None) -> Iterator[Batch]:
        """Decoded ``Batch(x, y)`` of the spec's ``x`` and ``y`` fields."""
        i = 0
        while steps is None or i < steps:
            # copy=False: decode_batch copies each field out of the reuse
            # buffer before the next call can overwrite it.
            raw = self.next_raw(copy=False)
            if raw is None:
                return
            arrays = self.spec.decode_batch(raw)
            yield Batch(x=arrays["x"], y=arrays["y"])
            i += 1

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dlcfn_loader_close(self._handle)
            self._handle = None

    def __enter__(self) -> "NativeRecordLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclass
class PythonRecordLoader:
    """The pure-Python fallback, with the native loader's interface and
    guarantees: round-robin sharding over the global record index, a fresh
    permutation each epoch that is a pure function of ``(seed, epoch)``,
    every record once an epoch, and ``start_batch``.  Its shuffle order is
    numpy's, not the C++ loader's (``std::shuffle`` over mt19937_64): a run
    finishes on the backend it started on, which is why
    :func:`open_record_loader` journals a fall back."""

    paths: Sequence[str | Path]
    spec: RecordSpec
    batch_size: int
    n_threads: int = 4  # accepted for the same interface; one thread
    shard_index: int = 0
    shard_count: int = 1
    shuffle: bool = True
    drop_remainder: bool = True
    loop: bool = True
    seed: int = 0
    start_batch: int = 0
    _rows: list[np.ndarray] = field(default_factory=list, repr=False)

    def __post_init__(self) -> None:
        validate_shards(self.paths, self.spec)
        if not (0 <= self.shard_index < self.shard_count):
            raise LoaderError(
                f"shard_index {self.shard_index} not in [0, {self.shard_count})"
            )
        starts, at = [], 0
        for p in self.paths:
            record_size, n = read_header(p)
            starts.append(at)
            at += n
            self._rows.append(
                np.memmap(p, dtype=np.uint8, mode="r", offset=HEADER.size,
                          shape=(n * record_size,)).reshape(n, record_size)
            )
        self._starts = np.asarray(starts, dtype=np.int64)
        self._shard_globals = np.arange(self.shard_index, at, self.shard_count, dtype=np.int64)
        n_batches = (
            len(self._shard_globals) // self.batch_size
            if self.drop_remainder
            else -(-len(self._shard_globals) // self.batch_size)
        )
        if n_batches == 0:
            raise LoaderError(
                f"shard has {len(self._shard_globals)} records, fewer than "
                f"one batch of {self.batch_size} (drop_remainder={self.drop_remainder})"
            )
        self._bpe = n_batches
        self._epoch = self.start_batch // n_batches
        self._next_in_epoch = self.start_batch % n_batches
        self._order = self._epoch_order(self._epoch)
        self._closed = False

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return self._shard_globals
        rng = np.random.default_rng(np.random.SeedSequence([int(self.seed), int(epoch)]))
        return self._shard_globals[rng.permutation(len(self._shard_globals))]

    @property
    def shard_records(self) -> int:
        return int(len(self._shard_globals))

    @property
    def batches_per_epoch(self) -> int:
        return int(self._bpe)

    def next_raw(self, copy: bool = True) -> np.ndarray | None:
        """A fresh ``[n, record_size]`` array (``copy`` is accepted for the
        same interface: nothing is reused)."""
        if self._closed:
            raise LoaderError("loader is closed")
        if self._next_in_epoch >= self._bpe:
            if not self.loop:
                return None
            self._epoch += 1
            self._next_in_epoch = 0
            self._order = self._epoch_order(self._epoch)
        lo = self._next_in_epoch * self.batch_size
        ids = self._order[lo: lo + self.batch_size]
        self._next_in_epoch += 1
        files = np.searchsorted(self._starts, ids, side="right") - 1
        out = np.empty((len(ids), self.spec.record_size), dtype=np.uint8)
        for i, (f, g) in enumerate(zip(files, ids)):
            out[i] = self._rows[f][g - self._starts[f]]
        return out

    def batches(self, steps: int | None = None) -> Iterator[Batch]:
        i = 0
        while steps is None or i < steps:
            raw = self.next_raw()
            if raw is None:
                return
            arrays = self.spec.decode_batch(raw)
            yield Batch(x=arrays["x"], y=arrays["y"])
            i += 1

    def close(self) -> None:
        self._closed = True
        self._rows = []

    def __enter__(self) -> "PythonRecordLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_record_loader(
    paths: Sequence[str | Path],
    spec: RecordSpec,
    batch_size: int,
    *,
    force_python: bool = False,
    **kwargs,
) -> NativeRecordLoader | PythonRecordLoader:
    """The native loader when its library builds and loads, else the
    pure-Python one, journaled as a ``datastream`` event with ``event:
    "native_fallback"`` (``obs/recorder``), never silent.  The shards are
    validated first: a missing or truncated shard raises
    :class:`ShardFileError` whatever the backend (the fallback is for loader
    failures, not data failures)."""
    validate_shards(paths, spec)
    if not force_python:
        try:
            return NativeRecordLoader(paths=paths, spec=spec, batch_size=batch_size, **kwargs)
        except ShardFileError:
            raise
        except LoaderError as exc:
            _record_fallback(str(exc))
            log.warning("native loader unavailable (%s); falling back to the "
                        "pure-Python reader", exc)
    return PythonRecordLoader(paths=paths, spec=spec, batch_size=batch_size, **kwargs)


def _record_fallback(error: str) -> None:
    from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

    get_recorder().record("datastream", event="native_fallback", error=error[:500])
