"""Filer entry model: a path plus attributes plus a list of file
chunks; the counterpart of seaweedfs_tpu/filer/entry.py, copied as is
(its JSON form is what the stores keep and the wire carries, so it
must match byte for byte).

Equivalent of SeaweedFS weed/filer/entry.go (Entry/Attr) and the
FileChunk message (weed/pb/filer.proto) — a file's bytes are a list of
(fid, offset, size, mtime) spans stored on volume servers; directories
are entries with no chunks and the directory mode bit set.
"""
from __future__ import annotations

import base64
import os
import time
from dataclasses import dataclass, field


@dataclass
class FileChunk:
    """One span of a file's content living at `fid` on a volume server.

    mtime_ns orders overlapping chunks: the latest write wins
    (weed/filer/filechunks.go readResolvedChunks).
    """
    fid: str
    offset: int
    size: int
    mtime_ns: int
    etag: str = ""  # hex md5 of the chunk bytes
    is_compressed: bool = False
    is_chunk_manifest: bool = False  # chunk holds a manifest, not data
    # per-chunk AES-256-GCM key (filer_pb FileChunk.cipher_key); the
    # stored bytes at `fid` are ciphertext when this is non-empty.
    # offset/size always describe the PLAINTEXT span.
    cipher_key: bytes = b""

    def to_dict(self) -> dict:
        d = {"fid": self.fid, "offset": self.offset, "size": self.size,
             "mtime_ns": self.mtime_ns}
        if self.etag:
            d["etag"] = self.etag
        if self.is_compressed:
            d["is_compressed"] = True
        if self.is_chunk_manifest:
            d["is_chunk_manifest"] = True
        if self.cipher_key:
            d["cipher_key"] = self.cipher_key.hex()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FileChunk":
        return cls(fid=d["fid"], offset=d["offset"], size=d["size"],
                   mtime_ns=d["mtime_ns"], etag=d.get("etag", ""),
                   is_compressed=d.get("is_compressed", False),
                   is_chunk_manifest=d.get("is_chunk_manifest", False),
                   cipher_key=bytes.fromhex(d.get("cipher_key", "")))


DIR_MODE_FLAG = 0o40000  # os.S_IFDIR bit, as the reference uses os.ModeDir


@dataclass
class Entry:
    full_path: str  # always absolute, '/'-separated, no trailing slash
    mtime: float = 0.0
    crtime: float = 0.0
    mode: int = 0o660
    uid: int = 0
    gid: int = 0
    mime: str = ""
    ttl_sec: int = 0
    md5: str = ""  # hex md5 of the whole file when known
    collection: str = ""
    replication: str = ""
    chunks: list[FileChunk] = field(default_factory=list)
    extended: dict[str, str] = field(default_factory=dict)
    hard_link_id: str = ""
    symlink_target: str = ""
    # small-file bytes stored INSIDE the metadata entry instead of a
    # volume chunk (filer_pb Entry.Content — the -saveToFilerLimit /
    # ?saveInside=true path, filer_server_handlers_write_upload.go:83)
    content: bytes = b""

    def __post_init__(self):
        if not self.mtime:
            self.mtime = time.time()
        if not self.crtime:
            self.crtime = self.mtime

    @property
    def dir_and_name(self) -> tuple[str, str]:
        d, n = os.path.split(self.full_path.rstrip("/"))
        return (d or "/", n)

    @property
    def name(self) -> str:
        return self.dir_and_name[1]

    @property
    def is_directory(self) -> bool:
        return bool(self.mode & DIR_MODE_FLAG)

    @property
    def file_size(self) -> int:
        return max(total_size(self.chunks), len(self.content))

    def is_expired(self, now: float | None = None) -> bool:
        if self.ttl_sec <= 0:
            return False
        return (now or time.time()) >= self.crtime + self.ttl_sec

    def to_dict(self) -> dict:
        d = {"full_path": self.full_path, "mtime": self.mtime,
             "crtime": self.crtime, "mode": self.mode}
        for k in ("uid", "gid", "ttl_sec"):
            if getattr(self, k):
                d[k] = getattr(self, k)
        for k in ("mime", "md5", "collection", "replication",
                  "hard_link_id", "symlink_target"):
            if getattr(self, k):
                d[k] = getattr(self, k)
        if self.chunks:
            d["chunks"] = [c.to_dict() for c in self.chunks]
        if self.extended:
            d["extended"] = dict(self.extended)
        if self.content:
            d["content"] = base64.b64encode(self.content).decode()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Entry":
        return cls(
            full_path=d["full_path"], mtime=d.get("mtime", 0.0),
            crtime=d.get("crtime", 0.0), mode=d.get("mode", 0o660),
            uid=d.get("uid", 0), gid=d.get("gid", 0),
            mime=d.get("mime", ""), ttl_sec=d.get("ttl_sec", 0),
            md5=d.get("md5", ""), collection=d.get("collection", ""),
            replication=d.get("replication", ""),
            chunks=[FileChunk.from_dict(c) for c in d.get("chunks", [])],
            extended=d.get("extended", {}),
            hard_link_id=d.get("hard_link_id", ""),
            symlink_target=d.get("symlink_target", ""),
            content=base64.b64decode(d["content"])
            if d.get("content") else b"")


def total_size(chunks: list[FileChunk]) -> int:
    """Max extent of the chunk list (weed/filer/filechunks.go TotalSize)."""
    size = 0
    for c in chunks:
        size = max(size, c.offset + c.size)
    return size


def entry_size(entry: dict | None) -> int:
    """total_size for a JSON entry dict (the gateways' wire shape).
    File size is max(offset+size) over chunks, NOT the chunk-size sum —
    overlapping rewrites keep superseded chunks in the list. Inline
    small files carry their bytes in `content` (base64) instead."""
    d = entry or {}
    chunk_max = max((c.get("offset", 0) + c["size"]
                     for c in d.get("chunks", [])), default=0)
    if d.get("content"):
        # 4 base64 chars encode 3 bytes; padding '=' trims the tail
        raw = d["content"]
        inline = len(raw) * 3 // 4 - raw.count("=")
        return max(chunk_max, inline)
    return chunk_max
