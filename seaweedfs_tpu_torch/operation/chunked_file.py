"""Volume-level chunked files: a needle whose body is a JSON manifest
of sub-fids; the counterpart of seaweedfs_tpu/operation/chunked_file.py.

Equivalent of SeaweedFS weed/operation/chunked_file.go ChunkManifest +
submit.go FilePart.Upload with maxMB. This is the pre-filer way of
storing files bigger than one volume entry: `upload -maxMB N` splits
the file into chunk needles and stores a manifest needle flagged
FLAG_IS_CHUNK_MANIFEST (set by POST ?cm=true,
needle_parse_upload.go:186); the volume server reassembles on GET and
cascades DELETE to the chunks. JSON keys mirror the reference's tags:
{"name","mime","size","chunks":[{"fid","offset","size"}]}.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..filer import FileChunk
from . import verbs


@dataclass
class ChunkInfo:
    fid: str
    offset: int
    size: int


@dataclass
class ChunkManifest:
    name: str = ""
    mime: str = ""
    size: int = 0
    chunks: list[ChunkInfo] = field(default_factory=list)

    def marshal(self) -> bytes:
        d: dict = {}
        if self.name:
            d["name"] = self.name
        if self.mime:
            d["mime"] = self.mime
        if self.size:
            d["size"] = self.size
        if self.chunks:
            d["chunks"] = [{"fid": c.fid, "offset": c.offset,
                            "size": c.size} for c in self.chunks]
        return json.dumps(d).encode()

    def as_file_chunks(self) -> list[FileChunk]:
        """The manifest's spans as filer FileChunks, so the one
        streaming reassembler (filer/stream_content) serves both the
        filer chunk model and these legacy volume manifests."""
        return [FileChunk(fid=c.fid, offset=c.offset, size=c.size,
                          mtime_ns=0)
                for c in sorted(self.chunks, key=lambda c: c.offset)]


def load_chunk_manifest(buffer: bytes,
                        is_compressed: bool = False) -> ChunkManifest:
    """chunked_file.go LoadChunkManifest."""
    if is_compressed:
        from ..utils import compression

        buffer = compression.ungzip(buffer)
    d = json.loads(buffer)
    return ChunkManifest(
        name=d.get("name", ""), mime=d.get("mime", ""),
        size=int(d.get("size", 0)),
        chunks=[ChunkInfo(fid=c["fid"], offset=int(c.get("offset", 0)),
                          size=int(c.get("size", 0)))
                for c in d.get("chunks", [])])


def delete_chunks(lookup_fid, manifest: ChunkManifest,
                  auth: str = "") -> list[str]:
    """Delete every chunk the manifest references; returns the fids
    that could not be deleted (chunked_file.go DeleteChunks — errors
    are reported, not fatal, so a half-deleted manifest can be retried)."""
    failed = []
    for c in manifest.chunks:
        try:
            verbs.delete(lookup_fid(c.fid), auth=auth)
        except (RuntimeError, LookupError, OSError):
            failed.append(c.fid)
    return failed


def upload_chunked(master_url: str, data_iter, total_size: int,
                   name: str, mime: str, chunk_size: int,
                   collection: str = "", replication: str = "",
                   ttl: str = "") -> tuple[str, int]:
    """submit.go FilePart.Upload (the maxMB>0 arm): assign + upload one
    needle per chunk_size span, then store the manifest at its own
    assigned fid with ?cm=true. Returns (manifest fid, stored size).
    On any chunk failure the already-uploaded chunks are deleted."""
    cm = ChunkManifest(name=name, mime=mime, size=total_size)
    try:
        offset = 0
        for piece in data_iter:
            a = verbs.assign(master_url, collection=collection,
                             replication=replication, ttl=ttl)
            verbs.upload(a, piece, name=f"{name}-{len(cm.chunks) + 1}",
                         auth=a.auth)
            cm.chunks.append(ChunkInfo(fid=a.fid, offset=offset,
                                       size=len(piece)))
            offset += len(piece)
        cm.size = offset
        a = verbs.assign(master_url, collection=collection,
                         replication=replication, ttl=ttl)
        url = f"http://{a.url}/{a.fid}?cm=true"
        verbs.upload(url, cm.marshal(), name=name,
                     mime="application/json", auth=a.auth)
        return a.fid, offset
    except Exception:
        from ..wdclient.client import MasterClient

        delete_chunks(MasterClient(master_url).lookup_file_id, cm)
        raise
