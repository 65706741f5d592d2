"""Transparent upload compression; the counterpart of
seaweedfs_tpu/utils/compression.py, copied as is.

Equivalent of SeaweedFS weed/util/compression.go +
needle_parse_upload.go: compressible payloads (by mime/extension) are
gzipped at the volume-server write path and the needle carries
FLAG_IS_COMPRESSED; reads inflate transparently (or pass gzip through
when the client accepts it). Compression is kept only when it actually
saves space — high-entropy data is stored as-is.
"""
from __future__ import annotations

import gzip

MIN_SIZE = 128          # tiny payloads aren't worth the header
MIN_SAVINGS = 0.1       # keep gzip only if >= 10% smaller
LEVEL = 3               # the reference uses fast gzip levels

_COMPRESSIBLE_MIME_PREFIXES = ("text/",)
_COMPRESSIBLE_MIMES = {
    "application/json", "application/xml", "application/xhtml+xml",
    "application/javascript", "application/x-javascript",
    "application/rss+xml", "application/atom+xml", "image/svg+xml",
    "application/wasm", "application/x-ndjson",
}
_COMPRESSIBLE_EXTS = {
    ".txt", ".json", ".jsonl", ".ndjson", ".xml", ".html", ".htm",
    ".css", ".js", ".mjs", ".csv", ".tsv", ".md", ".svg", ".log",
    ".yaml", ".yml", ".toml", ".ini", ".conf", ".go", ".py", ".c",
    ".h", ".cc", ".java", ".rs", ".sql", ".sh", ".proto", ".wasm",
}


def is_compressible(mime: str = "", name: str = "") -> bool:
    """Mime/extension test (util/compression.go
    IsCompressableFileType)."""
    mime = (mime or "").split(";")[0].strip().lower()
    if mime.startswith(_COMPRESSIBLE_MIME_PREFIXES):
        return True
    if mime in _COMPRESSIBLE_MIMES:
        return True
    name = (name or "").lower()
    dot = name.rfind(".")
    return dot >= 0 and name[dot:] in _COMPRESSIBLE_EXTS


def maybe_gzip(data: bytes) -> tuple[bytes, bool]:
    """-> (stored bytes, compressed?). Only compresses when it pays."""
    if len(data) < MIN_SIZE:
        return data, False
    gz = gzip.compress(data, LEVEL, mtime=0)  # deterministic
    if len(gz) <= len(data) * (1 - MIN_SAVINGS):
        return gz, True
    return data, False


def is_gzipped(data: bytes) -> bool:
    return data[:2] == b"\x1f\x8b"


def ungzip(data: bytes) -> bytes:
    """Inflate stored needle bytes (single home for the codec policy)."""
    return gzip.decompress(data)
