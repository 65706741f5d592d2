"""Remote-storage clients: the verbs a cloud tier must support; the
counterpart of seaweedfs_tpu/remote_storage/client.py.

Equivalent of the reference's weed/remote_storage/remote_storage.go:71-87
(RemoteStorageClient: Traverse / ReadFile / WriteFile / DeleteFile /
WriteDirectory / RemoveDirectory) with a factory registry keyed by type
(remote_storage.go RemoteStorageClientMaker). Two implementations work
in any environment: a local directory (tests, NFS-style mounts — the
reference's localsink analogue) and any S3-compatible endpoint via the
in-tree SigV4 signer. The cold tier of the master's tiering controller
(master/tiering.py, storage/store.py tier_offload_ec) and the filer's
remote mounts (remote_storage/mount.py) are built from this registry;
the in-tree `gcs` and `azure` REST clients (gcs_client.py,
azure_client.py) register themselves here when the package is imported.
"""
from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass
from typing import Callable, Iterator


@dataclass
class RemoteEntry:
    """Metadata of one remote object (filer.proto RemoteEntry)."""

    key: str  # path within the storage, no leading slash
    size: int = 0
    mtime: float = 0.0
    etag: str = ""

    def to_extended(self) -> dict:
        return {"key": self.key, "size": self.size,
                "mtime": self.mtime, "etag": self.etag}


class RemoteStorageClient:
    def traverse(self, prefix: str = "") -> Iterator[RemoteEntry]:
        raise NotImplementedError

    def head(self, key: str) -> RemoteEntry | None:
        raise NotImplementedError

    def read_file(self, key: str, offset: int = 0,
                  size: int = -1) -> bytes:
        raise NotImplementedError

    def write_file(self, key: str, data: bytes) -> RemoteEntry:
        raise NotImplementedError

    def delete_file(self, key: str) -> None:
        raise NotImplementedError

    # object stores have no real directories; the local client does
    def write_directory(self, key: str) -> None:
        pass

    def remove_directory(self, key: str) -> None:
        pass

    def list_buckets(self) -> list[str]:
        """Top-level containers of this storage (remote.mount.buckets;
        remote_storage.go RemoteStorageClient ListBuckets)."""
        raise NotImplementedError


class LocalRemoteClient(RemoteStorageClient):
    """A plain directory as the remote (type "local")."""

    def __init__(self, root: str = "", **_):
        if not root:
            raise ValueError("local remote storage needs a root dir")
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _abs(self, key: str) -> str:
        p = os.path.normpath(os.path.join(self.root, key.lstrip("/")))
        if p != self.root and not p.startswith(self.root + os.sep):
            raise PermissionError(f"key escapes storage root: {key}")
        return p

    def traverse(self, prefix: str = "") -> Iterator[RemoteEntry]:
        for dirpath, _, files in sorted(os.walk(self.root)):
            for f in sorted(files):
                full = os.path.join(dirpath, f)
                key = os.path.relpath(full, self.root).replace(os.sep, "/")
                if prefix and not key.startswith(prefix.lstrip("/")):
                    continue
                st = os.stat(full)
                yield RemoteEntry(key=key, size=st.st_size,
                                  mtime=st.st_mtime)

    def head(self, key: str) -> RemoteEntry | None:
        try:
            st = os.stat(self._abs(key))
        except FileNotFoundError:
            return None
        return RemoteEntry(key=key.lstrip("/"), size=st.st_size,
                           mtime=st.st_mtime)

    def list_buckets(self) -> list[str]:
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d)))

    def read_file(self, key: str, offset: int = 0,
                  size: int = -1) -> bytes:
        with open(self._abs(key), "rb") as f:
            f.seek(offset)
            return f.read(None if size < 0 else size)

    def write_file(self, key: str, data: bytes) -> RemoteEntry:
        p = self._abs(key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)
        return RemoteEntry(key=key.lstrip("/"), size=len(data),
                           mtime=time.time(),
                           etag=hashlib.md5(data).hexdigest())

    def delete_file(self, key: str) -> None:
        try:
            os.remove(self._abs(key))
        except FileNotFoundError:
            pass

    def write_directory(self, key: str) -> None:
        os.makedirs(self._abs(key), exist_ok=True)

    def remove_directory(self, key: str) -> None:
        import shutil
        shutil.rmtree(self._abs(key), ignore_errors=True)


class S3RemoteClient(RemoteStorageClient):
    """Any S3-compatible endpoint (type "s3") — including this
    framework's own gateway (remote_storage/s3/s3_storage_client.go).
    HTTP mechanics live in the shared s3.client.S3Client."""

    def __init__(self, **conf):
        from ..s3.client import S3Client
        self._c = S3Client(**conf)

    @staticmethod
    def _entry(o) -> RemoteEntry:
        return RemoteEntry(key=o.key, size=o.size, mtime=o.mtime,
                           etag=o.etag)

    def traverse(self, prefix: str = "") -> Iterator[RemoteEntry]:
        for o in self._c.list_objects(prefix):
            yield self._entry(o)

    def head(self, key: str) -> RemoteEntry | None:
        o = self._c.head_object(key)
        return self._entry(o) if o else None

    def read_file(self, key: str, offset: int = 0,
                  size: int = -1) -> bytes:
        return self._c.get_object(key, offset, size)

    def write_file(self, key: str, data: bytes) -> RemoteEntry:
        return self._entry(self._c.put_object(key, data))

    def delete_file(self, key: str) -> None:
        self._c.delete_object(key)

    def list_buckets(self) -> list[str]:
        return self._c.list_buckets()


_makers: dict[str, Callable[..., RemoteStorageClient]] = {
    "local": LocalRemoteClient,
    "s3": S3RemoteClient,
}

# present in the reference via cloud SDKs not shipped in this image;
# named so configuration errors are explicit, not "unknown type".
# (gcs and azure are real in-tree REST clients; b2's S3-compatible
# endpoint works through type "s3".)
UNAVAILABLE_TYPES = ("aliyun", "tencent", "wasabi", "hdfs")


def register_remote(type_name: str,
                    maker: Callable[..., RemoteStorageClient]) -> None:
    _makers[type_name] = maker


def parse_remote_spec(spec: str) -> dict:
    """Parse a CLI/shell remote-tier spec into a client conf dict:
    full JSON (`{"type": "s3", ...}`) or the `local:<root>` shorthand
    (`-tier.remote=local:/mnt/cold`)."""
    spec = spec.strip()
    if not spec:
        raise ValueError("empty remote storage spec")
    if spec.startswith("{"):
        import json

        conf = json.loads(spec)
        if not isinstance(conf, dict) or "type" not in conf:
            raise ValueError(
                "remote storage spec JSON needs a 'type' field")
        return conf
    if ":" in spec:
        t, _, rest = spec.partition(":")
        if t == "local":
            return {"type": "local", "root": rest}
    raise ValueError(
        f"bad remote storage spec {spec!r}: use JSON with a 'type' "
        "field or the local:<root> shorthand")


def make_client(conf: dict) -> RemoteStorageClient:
    t = conf.get("type", "")
    if t in UNAVAILABLE_TYPES:
        raise KeyError(
            f"remote storage type {t!r} needs a cloud SDK not present "
            "in this build; available: " + ", ".join(sorted(_makers)))
    try:
        maker = _makers[t]
    except KeyError:
        raise KeyError(f"unknown remote storage type {t!r}; "
                       f"known: {sorted(_makers)}") from None
    return maker(**{k: v for k, v in conf.items() if k != "type"})
