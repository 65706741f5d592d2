"""VolumeInfo `.vif` sidecar: per-volume metadata surviving restarts.

Equivalent of the reference's weed/storage/volume_info/volume_info.go
(SaveVolumeInfo / MaybeLoadVolumeInfo) persisting the protobuf
`VolumeInfo{files: []RemoteFile, version}` (volume_server.proto). Here
the sidecar is JSON — same role: it records which storage backend holds
the volume's `.dat` once it has been tiered off local disk
(weed/storage/backend/s3_backend), so a restarted server reopens the
remote copy instead of concluding the volume is gone.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field


@dataclass
class RemoteFile:
    """One remote copy of the volume's .dat (pb.RemoteFile)."""

    backend_type: str = "s3"
    backend_id: str = "default"
    key: str = ""
    file_size: int = 0
    modified_time: int = 0

    @property
    def backend_name(self) -> str:
        """Registry key, e.g. "s3.default" (backend.go:42 registries)."""
        return f"{self.backend_type}.{self.backend_id}"


@dataclass
class VolumeInfo:
    version: int = 3
    replication: str = ""
    files: list[RemoteFile] = field(default_factory=list)
    # EC codec of this volume's shard set, "k.m" (empty = RS(10,4)
    # default). Beyond-reference: wide codes for cold collections.
    ec_codec: str = ""

    def remote_file(self) -> RemoteFile | None:
        return self.files[0] if self.files else None


def save_volume_info(path: str, vi: VolumeInfo) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(asdict(vi), f, indent=1)
    os.replace(tmp, path)


def maybe_load_volume_info(path: str) -> VolumeInfo | None:
    try:
        with open(path) as f:
            raw = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None
    return VolumeInfo(
        version=raw.get("version", 3),
        replication=raw.get("replication", ""),
        files=[RemoteFile(**rf) for rf in raw.get("files", [])],
        ec_codec=raw.get("ec_codec", ""))
