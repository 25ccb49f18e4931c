"""The object-store seam of ``deeplearning_cfn_tpu/provision/objectstore.py``,
copied (the port imports nothing of the JAX package): the ``ObjectStore``
protocol and its directory-backed ``LocalObjectStore``, the fake-cloud
bucket behind ``train/checkpoint.ObjectStoreCheckpointer``.  The GCS store
needs the network and is not ported.
"""

from __future__ import annotations

import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Protocol


class ObjectStore(Protocol):
    def put(self, key: str, data: bytes) -> None: ...
    def get(self, key: str) -> bytes: ...
    def exists(self, key: str) -> bool: ...
    def list(self, prefix: str) -> list[str]: ...


@dataclass
class LocalObjectStore:
    """Directory-backed store — the fake-cloud bucket."""

    root: Path

    def _path(self, key: str) -> Path:
        p = (self.root / key).resolve()
        if self.root.resolve() not in p.parents and p != self.root.resolve():
            raise ValueError(f"key {key!r} escapes the store root")
        return p

    def put(self, key: str, data: bytes) -> None:
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)

    def put_path(self, key: str, path: Path) -> None:
        """Copy a file in without loading it into memory."""
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(path, p)

    def get(self, key: str) -> bytes:
        return self._path(key).read_bytes()

    def exists(self, key: str) -> bool:
        return self._path(key).is_file()

    def list(self, prefix: str) -> list[str]:
        base = self.root.resolve()
        return sorted(
            str(p.relative_to(base))
            for p in base.rglob("*")
            if p.is_file() and str(p.relative_to(base)).startswith(prefix)
        )
