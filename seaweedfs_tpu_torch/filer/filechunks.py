"""Chunk-overlap algebra: resolve a chunk list into visible intervals;
the counterpart of seaweedfs_tpu/filer/filechunks.py.

Equivalent of SeaweedFS weed/filer/filechunks.go:183-307
(NonOverlappingVisibleIntervals / ViewFromChunks) and
filechunk_manifest.go (manifest chunks compressing huge chunk lists).
Later-modified chunks shadow earlier ones wherever they overlap.
Not here: encrypted chunks (-encryptVolumeData); a manifest chunk with
a cipher key raises NotImplementedError.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Callable

from .entry import FileChunk

# A file with more than this many chunks gets its chunk list folded into
# manifest chunks stored on volume servers (filechunk_manifest.go
# ManifestBatch).
MANIFEST_BATCH = 1000


@dataclass
class VisibleInterval:
    """A [start, stop) range of the file served by one chunk."""
    start: int
    stop: int
    fid: str
    mtime_ns: int
    offset_in_chunk: int  # where `start` falls inside the chunk's data
    chunk_size: int
    is_compressed: bool = False
    cipher_key: bytes = b""


@dataclass
class ChunkView:
    """A read instruction: fetch view_size bytes at offset_in_chunk of
    chunk `fid`, place them at view_offset of the file. A non-empty
    cipher_key means the stored bytes are AES-GCM ciphertext: readers
    must fetch the WHOLE chunk, decrypt, then slice (a ranged read of
    ciphertext is undecryptable)."""
    fid: str
    offset_in_chunk: int
    view_size: int
    view_offset: int
    is_compressed: bool = False
    cipher_key: bytes = b""


def non_overlapping_visible_intervals(
        chunks: list[FileChunk]) -> list[VisibleInterval]:
    """Resolve overlaps: chunks applied in mtime order, later wins."""
    visibles: list[VisibleInterval] = []
    for c in sorted(chunks, key=lambda c: (c.mtime_ns, c.fid)):
        visibles = _insert(visibles, c)
    return visibles


def _insert(visibles: list[VisibleInterval],
            c: FileChunk) -> list[VisibleInterval]:
    start, stop = c.offset, c.offset + c.size
    out: list[VisibleInterval] = []
    for v in visibles:
        if v.stop <= start or v.start >= stop:
            out.append(v)
            continue
        if v.start < start:  # left remnant survives
            out.append(VisibleInterval(
                v.start, start, v.fid, v.mtime_ns, v.offset_in_chunk,
                v.chunk_size, v.is_compressed, v.cipher_key))
        if v.stop > stop:  # right remnant survives
            out.append(VisibleInterval(
                stop, v.stop, v.fid, v.mtime_ns,
                v.offset_in_chunk + (stop - v.start), v.chunk_size,
                v.is_compressed, v.cipher_key))
    out.append(VisibleInterval(start, stop, c.fid, c.mtime_ns, 0, c.size,
                               c.is_compressed, c.cipher_key))
    out.sort(key=lambda v: v.start)
    return out


def view_from_chunks(chunks: list[FileChunk], offset: int = 0,
                     size: int | None = None) -> list[ChunkView]:
    """Chunk views covering [offset, offset+size) of the file
    (weed/filer/filechunks.go ViewFromChunks)."""
    visibles = non_overlapping_visible_intervals(chunks)
    stop = (1 << 62) if size is None else offset + size
    views: list[ChunkView] = []
    for v in visibles:
        s, e = max(offset, v.start), min(stop, v.stop)
        if s < e:
            views.append(ChunkView(
                fid=v.fid, offset_in_chunk=s - v.start + v.offset_in_chunk,
                view_size=e - s, view_offset=s,
                is_compressed=v.is_compressed, cipher_key=v.cipher_key))
    return views


def compact_file_chunks(
        chunks: list[FileChunk]
) -> tuple[list[FileChunk], list[FileChunk]]:
    """Split into (still-visible, garbage) chunks
    (weed/filer/filechunks.go CompactFileChunks)."""
    live_fids = {v.fid for v in non_overlapping_visible_intervals(chunks)}
    compacted = [c for c in chunks if c.fid in live_fids]
    garbage = [c for c in chunks if c.fid not in live_fids]
    return compacted, garbage


def etag_chunks(chunks: list[FileChunk]) -> str:
    """ETag from per-chunk md5s (weed/filer/filechunks.go ETagChunks)."""
    if not chunks:
        return hashlib.md5(b"").hexdigest()
    if len(chunks) == 1:
        return chunks[0].etag
    joined = b"".join(bytes.fromhex(c.etag) for c in chunks if c.etag)
    return f"{hashlib.md5(joined).hexdigest()}-{len(chunks)}"


# -- manifest chunks ----------------------------------------------------
# For files with huge chunk lists the list itself is stored as data on
# volume servers, and the entry keeps only small "manifest" chunks
# (filechunk_manifest.go maybeManifestize / ResolveChunkManifest).

def separate_manifest_chunks(
        chunks: list[FileChunk]
) -> tuple[list[FileChunk], list[FileChunk]]:
    manifests = [c for c in chunks if c.is_chunk_manifest]
    data = [c for c in chunks if not c.is_chunk_manifest]
    return manifests, data


def maybe_manifestize(
        save_fn: Callable[[bytes], str], chunks: list[FileChunk],
        batch: int = MANIFEST_BATCH) -> list[FileChunk]:
    """Fold runs of `batch` data chunks into manifest chunks. save_fn
    uploads bytes and returns the new fid — or (fid, cipher_key) when
    the payload was stored encrypted (the key lands on the manifest
    chunk so resolve_chunk_manifest can decrypt it)."""
    manifests, data = separate_manifest_chunks(chunks)
    if len(data) < batch:
        return chunks
    out = list(manifests)
    i = 0
    while i + batch <= len(data):
        group = data[i:i + batch]
        payload = json.dumps(
            {"chunks": [c.to_dict() for c in group]}).encode()
        res = save_fn(payload)
        fid, ckey = res if isinstance(res, tuple) else (res, b"")
        out.append(FileChunk(
            fid=fid, offset=min(c.offset for c in group),
            size=max(c.offset + c.size for c in group)
            - min(c.offset for c in group),
            mtime_ns=max(c.mtime_ns for c in group),
            etag=hashlib.md5(payload).hexdigest(),
            is_chunk_manifest=True, cipher_key=ckey))
        i += batch
    out.extend(data[i:])
    out.sort(key=lambda c: c.offset)
    return out


def resolve_chunk_manifest(
        read_fn: Callable[[str], bytes],
        chunks: list[FileChunk]) -> list[FileChunk]:
    """Expand manifest chunks back into their data chunks. read_fn
    fetches a fid's bytes."""
    out: list[FileChunk] = []
    for c in chunks:
        if not c.is_chunk_manifest:
            out.append(c)
            continue
        if c.cipher_key:
            raise NotImplementedError(
                f"manifest chunk {c.fid} is encrypted: -encryptVolumeData "
                "is not ported")
        raw = read_fn(c.fid)
        payload = json.loads(raw)
        nested = [FileChunk.from_dict(d) for d in payload["chunks"]]
        out.extend(resolve_chunk_manifest(read_fn, nested))
    return out
