"""ASCII armor for extended-attribute values riding HTTP headers; the
counterpart of seaweedfs_tpu/utils/extheaders.py, copied as is.

The filer and the S3 gateway exchange entry extended attributes (the
x-amz-meta-* user metadata among them) as `x-seaweed-ext-*` headers so
a GET costs one round trip. A non-ASCII value would not survive a
header, so it is percent-encoded on the wire: armor on emit, unarmor
on parse, store the true bytes. SeaweedFS carries the same metadata
inside protobuf entries (filer_pb Entry.Extended), so it never faces
the issue; this is the header-wire equivalent.
"""
from __future__ import annotations

import urllib.parse


def armor(value: str) -> str:
    """-> pure-ASCII form safe for an HTTP header value (no CR/LF/%,
    no leading/trailing whitespace ambiguity, no non-ASCII)."""
    return urllib.parse.quote(str(value), safe="/")


def unarmor(value: str) -> str:
    return urllib.parse.unquote(value)
