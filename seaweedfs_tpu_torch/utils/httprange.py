"""HTTP byte-range parsing and multipart/byteranges assembly (RFC
7233); the counterpart of seaweedfs_tpu/utils/httprange.py. The volume
server and the filer answer one range with a 206 and several with a
206 multipart/byteranges, as the reference. Parsing as in SeaweedFS
weed/server/common.go processRangeRequest:306-383:

- header absent / non-"bytes" unit: no range (serve 200 full) —
  RFC 7233 §3.1 lets a server ignore units it doesn't recognize
- any syntactically bad spec: malformed (caller answers 416)
- a spec whose start is past EOF: unsatisfiable; if EVERY spec is,
  the request is unsatisfiable (416 with "Content-Range: bytes */N")
- sum of range lengths > total size: probably an attack or a dumb
  client — ignore the header, serve 200 full (common.go:312-318)
- one satisfiable range: plain 206 with Content-Range
- several: 206 multipart/byteranges, one MIME part per range
"""
from __future__ import annotations

import secrets

MALFORMED = "malformed"
UNSATISFIABLE = "unsatisfiable"
IGNORE = "ignore"


def parse_range_header(spec: str, size: int):
    """-> list[(start, length)] | MALFORMED | UNSATISFIABLE | IGNORE.

    An empty list means "no range" (absent header / foreign unit):
    serve the full body. IGNORE means the header was valid but the
    ranges sum past the object — serve the full body too.
    """
    if not spec:
        return []
    if not spec.startswith("bytes="):
        return []  # unknown unit: ignored per RFC 7233
    ranges: list[tuple[int, int]] = []
    saw_spec = False
    for part in spec[len("bytes="):].split(","):
        part = part.strip()
        if not part:
            continue
        saw_spec = True
        start_s, dash, end_s = part.partition("-")
        if not dash:
            return MALFORMED
        start_s, end_s = start_s.strip(), end_s.strip()
        try:
            if not start_s:  # suffix form "-N": the LAST N bytes
                n_last = int(end_s)
                if n_last < 0:
                    return MALFORMED
                start = max(0, size - n_last)
                length = size - start
                if length == 0:
                    continue  # "-0", or any suffix of an empty object
            else:
                start = int(start_s)
                if start < 0:
                    return MALFORMED
                end = int(end_s) if end_s else size - 1
                if end < start:
                    return MALFORMED
                if start >= size:
                    continue  # past EOF: this spec is unsatisfiable
                end = min(end, size - 1)
                length = end - start + 1
        except ValueError:
            return MALFORMED
        ranges.append((start, length))
    if saw_spec and not ranges:
        return UNSATISFIABLE
    if sum(length for _, length in ranges) > size:
        return IGNORE
    return ranges


def content_range(start: int, length: int, size: int) -> str:
    return f"bytes {start}-{start + length - 1}/{size}"


def multipart_byteranges(parts: list[tuple[int, int, bytes]],
                         mime: str, size: int) -> tuple[bytes, str]:
    """Assemble the multipart/byteranges body for `parts` of
    (start, length, data). -> (body, Content-Type header value)."""
    boundary = secrets.token_hex(16)
    out: list[bytes] = []
    for start, length, data in parts:
        head = (f"--{boundary}\r\n"
                + (f"Content-Type: {mime}\r\n" if mime else "")
                + f"Content-Range: {content_range(start, length, size)}"
                + "\r\n\r\n")
        out.append(head.encode())
        out.append(data)
        out.append(b"\r\n")
    out.append(f"--{boundary}--\r\n".encode())
    return b"".join(out), f"multipart/byteranges; boundary={boundary}"
