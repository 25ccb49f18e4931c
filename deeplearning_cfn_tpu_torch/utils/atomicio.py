"""Atomic file writes: write-temp -> fsync -> rename.  The streaming writer
of ``deeplearning_cfn_tpu/utils/atomicio.py``, copied (the DLC1 record
writer's).

Control-plane records (cluster contract, storage binding, checkpoints)
are read by *other* processes, possibly while the writer is being
killed — a torn ``write_text`` would hand the reader half a JSON
document.  ``os.replace`` on the same filesystem is atomic, so the
reader sees either the old complete file or the new complete file,
never a prefix.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from pathlib import Path
from typing import BinaryIO, Iterator


@contextmanager
def atomic_writer(path: str | Path) -> Iterator[BinaryIO]:
    """Streaming variant for writers too large (or too seek-happy) for
    one ``atomic_write_bytes`` buffer: yields a binary handle onto the
    temp file, and only a clean exit fsyncs + renames it into place.
    Any exception unlinks the temp — the destination is never touched,
    so readers see the old complete file or the new complete file,
    never a torn prefix (record shards: train/records.write_records)."""
    path = Path(path)
    tmp = path.parent / f".{path.name}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            yield fh
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink(missing_ok=True)
