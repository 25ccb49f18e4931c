"""The object-store seam of ``deeplearning_cfn_tpu/provision/objectstore.py``,
copied (the port imports nothing of the JAX package): the ``ObjectStore``
protocol, its directory-backed ``LocalObjectStore`` (the fake-cloud bucket
behind ``train/checkpoint.ObjectStoreCheckpointer``) and the ``Stager`` of
``cli stage`` (the prepare-s3-bucket.sh workflow as a library: artifacts
tarred into the store under a prefix), and ``GCSObjectStore``, the GCS
JSON-API store over an injectable transport (the same requests as the JAX
store, request by request; a deployment injects an authenticated session).
"""

from __future__ import annotations

import hashlib
import shutil
import tarfile
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Protocol

from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.stage")


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


@dataclass
class GCSObjectStore:
    """GCS JSON-API store over the injectable transport (no egress in CI;
    deployments inject an authenticated session).  The transport receives
    the object bytes under ``body["data"]`` (media upload); ``get`` reads
    them back from ``resp["data"]`` symmetrically."""

    bucket: str
    transport: Callable[[str, str, dict | None], dict]

    def put(self, key: str, data: bytes) -> None:
        self.transport(
            "POST",
            f"upload/storage/v1/b/{self.bucket}/o?uploadType=media&name={key}",
            {
                "data": data,
                "size": len(data),
                "md5": hashlib.md5(data).hexdigest(),
            },
        )

    def get(self, key: str) -> bytes:
        resp = self.transport("GET", f"b/{self.bucket}/o/{key}?alt=media", None)
        return resp.get("data", b"")

    def exists(self, key: str) -> bool:
        try:
            self.transport("GET", f"b/{self.bucket}/o/{key}", None)
            return True
        except KeyError:
            return False

    def list(self, prefix: str) -> list[str]:
        resp = self.transport("GET", f"b/{self.bucket}/o?prefix={prefix}", None)
        return [item["name"] for item in resp.get("items", [])]


@dataclass
class StagedArtifact:
    name: str
    key: str
    size_bytes: int
    sha256: str


@dataclass
class Stager:
    """Stages local files/directories as tar artifacts into an object store
    under ``{prefix}/`` — the prepare-s3-bucket.sh workflow as a library."""

    store: ObjectStore
    prefix: str = "dlcfn"
    manifest: list[StagedArtifact] = field(default_factory=list)

    def stage_path(self, path: str | Path, name: str | None = None) -> StagedArtifact:
        """Tar a file or directory and upload as ``{prefix}/{name}.tar``.

        The hash is computed streaming (datasets are multi-GB; never load
        them whole).  Stores that support ``put_path`` get the file handed
        over by path; others receive bytes."""
        src = Path(path)
        if not src.exists():
            raise FileNotFoundError(f"artifact path does not exist: {src}")
        name = name or src.name
        key = f"{self.prefix}/{name}.tar"
        with tempfile.NamedTemporaryFile(suffix=".tar") as tmp:
            with tarfile.open(tmp.name, "w") as tar:
                tar.add(src, arcname=src.name)
            tmp_path = Path(tmp.name)
            sha = hashlib.sha256()
            size = 0
            with open(tmp_path, "rb") as f:
                while chunk := f.read(1 << 20):
                    sha.update(chunk)
                    size += len(chunk)
            put_path = getattr(self.store, "put_path", None)
            if put_path is not None:
                put_path(key, tmp_path)
            else:
                self.store.put(key, tmp_path.read_bytes())
        art = StagedArtifact(
            name=f"{name}.tar",
            key=key,
            size_bytes=size,
            sha256=sha.hexdigest(),
        )
        self.manifest.append(art)
        log.info("staged %s -> %s (%d bytes)", src, key, art.size_bytes)
        return art

    def fetch_artifact(self, name: str, dest: str | Path) -> Path:
        """Download + extract an artifact (the worker-side boot step,
        mask-rcnn-cfn.yaml:790-827)."""
        key = f"{self.prefix}/{name}"
        data = self.store.get(key)
        dest = Path(dest)
        dest.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(suffix=".tar") as tmp:
            Path(tmp.name).write_bytes(data)
            with tarfile.open(tmp.name) as tar:
                try:
                    tar.extractall(dest, filter="data")
                except TypeError:
                    # filter= landed in 3.10.12/3.11.4; older patch
                    # releases take no keyword.
                    tar.extractall(dest)  # noqa: S202 (trusted self-staged tar)
        return dest
