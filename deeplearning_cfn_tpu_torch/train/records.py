"""DLC1 record files — a copy of ``deeplearning_cfn_tpu/train/records.py``
(the port imports nothing of the JAX package), the record format of
``train/datastream``.

The framework's on-disk training-data format.

The reference stages datasets as tar archives on S3 and leaves record IO
to its external frameworks' loaders (prepare-s3-bucket.sh:23-50, SURVEY
C8).  Here the input path is first-party: fixed-size binary records in a
trivially seekable container, written once at staging time and read by the
native loader (native/dataloader/dataloader.cpp) with record-level shuffle
and per-worker sharding.

Format "DLC1": 4-byte magic ``DLC1``, u32 little-endian record_size,
u64 little-endian n_records, then ``n_records * record_size`` payload
bytes.  Fixed record size is a deliberate TPU-first constraint: a batch is
one contiguous buffer with a static shape — no per-example Python, no
ragged decode, one host→device transfer.

``RecordSpec`` maps the raw record bytes to typed arrays (e.g. an image
tensor and a label) by offset arithmetic, vectorized over the batch.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Iterator, Sequence

import numpy as np

from deeplearning_cfn_tpu_torch.utils.atomicio import atomic_writer

MAGIC = b"DLC1"
HEADER = struct.Struct("<4sIQ")  # magic, record_size, n_records


class RecordFormatError(ValueError):
    pass


@dataclass(frozen=True)
class Field:
    name: str
    dtype: str
    shape: tuple[int, ...]

    @property
    def nbytes(self) -> int:
        return int(np.dtype(self.dtype).itemsize * int(np.prod(self.shape or (1,))))


@dataclass(frozen=True)
class RecordSpec:
    """Typed layout of one record: fields laid out back to back."""

    fields: tuple[Field, ...]

    @property
    def record_size(self) -> int:
        return sum(f.nbytes for f in self.fields)

    def offsets(self) -> list[int]:
        offs, at = [], 0
        for f in self.fields:
            offs.append(at)
            at += f.nbytes
        return offs

    def encode(self, **arrays: np.ndarray) -> bytes:
        """One record from per-field arrays (shapes must match exactly)."""
        parts = []
        for f in self.fields:
            a = np.asarray(arrays[f.name], dtype=f.dtype)
            if tuple(a.shape) != tuple(f.shape):
                raise RecordFormatError(
                    f"field {f.name}: shape {a.shape} != spec {f.shape}"
                )
            parts.append(a.tobytes())
        return b"".join(parts)

    def decode_batch(self, buf: np.ndarray) -> dict[str, np.ndarray]:
        """[B, record_size] u8 -> {name: [B, *shape]}, EXACTLY one copy per
        field — never a view of ``buf``.  Strided field slices must be
        compacted before the dtype view anyway; the copy must also happen
        for a full-width field (where ``ascontiguousarray`` would be a
        no-op and return ``buf`` itself), because callers feed the native
        loader's reuse buffer (``next_raw(copy=False)``): a yielded view
        would be silently overwritten by the next batch while a prefetch
        transfer is still in flight."""
        if buf.ndim != 2 or buf.shape[1] != self.record_size:
            raise RecordFormatError(
                f"batch buffer {buf.shape} != [B, {self.record_size}]"
            )
        out = {}
        for f, off in zip(self.fields, self.offsets()):
            raw = buf[:, off : off + f.nbytes].copy()
            out[f.name] = raw.view(f.dtype).reshape(buf.shape[0], *f.shape)
        return out

    @classmethod
    def classification(
        cls, image_shape: Sequence[int], image_dtype: str = "float32"
    ) -> "RecordSpec":
        """The common (x: image, y: int32 label) layout."""
        return cls(
            (
                Field("x", image_dtype, tuple(image_shape)),
                Field("y", "int32", ()),
            )
        )


def write_records(path: str | Path, spec: RecordSpec, records: Iterator[bytes] | list[bytes]) -> int:
    """Write a DLC1 file; returns the record count.

    Atomic (utils/atomicio): the records stream into a dot-prefixed temp
    file — including the header count patched in by seek once the stream
    ends — and only a clean finish renames it into place.  A writer torn
    mid-stream (crash, raising generator) leaves NOTHING at ``path``, so
    ``read_header`` can never accept a half-written shard whose header
    already looked valid.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    n = 0
    with atomic_writer(path) as f:
        f.write(HEADER.pack(MAGIC, spec.record_size, 0))  # patched below
        for rec in records:
            if len(rec) != spec.record_size:
                raise RecordFormatError(
                    f"record {n} has {len(rec)} bytes, spec says {spec.record_size}"
                )
            f.write(rec)
            n += 1
        f.seek(0)
        f.write(HEADER.pack(MAGIC, spec.record_size, n))
    return n


def write_dataset(path: str | Path, spec: RecordSpec, batches: Iterator[Any], steps: int) -> int:
    """Stage a Batch iterator (e.g. SyntheticDataset.batches) to a file."""

    def gen():
        for i, b in enumerate(batches):
            if i >= steps:
                break
            for x, y in zip(b.x, b.y):
                yield spec.encode(x=x, y=y)

    return write_records(path, spec, gen())


def read_header(path: str | Path) -> tuple[int, int]:
    """(record_size, n_records); validates magic."""
    with open(path, "rb") as f:
        magic, record_size, n_records = HEADER.unpack(f.read(HEADER.size))
    if magic != MAGIC:
        raise RecordFormatError(f"{path}: bad magic {magic!r}")
    return record_size, n_records


def read_all(path: str | Path, spec: RecordSpec) -> dict[str, np.ndarray]:
    """Pure-Python reference reader (tests / fallback)."""
    record_size, n = read_header(path)
    if record_size != spec.record_size:
        raise RecordFormatError(
            f"{path}: record_size {record_size} != spec {spec.record_size}"
        )
    raw = np.fromfile(path, dtype=np.uint8, offset=HEADER.size)
    raw = raw[: n * record_size].reshape(n, record_size)
    return spec.decode_batch(raw)
