"""aws-chunked payload decoding with SigV4 chunk-signature
verification; the counterpart of seaweedfs_tpu/s3/chunked.py, copied as
is but for a lock around its signing-key cache (the port's handlers
run on threads).

Equivalent of SeaweedFS weed/s3api/chunked_reader_v4.go: the AWS CLI /
SDKs upload large PUTs with
`x-amz-content-sha256: STREAMING-AWS4-HMAC-SHA256-PAYLOAD` and a body
of framed chunks, each carrying a signature chained from the previous
one (seed = the request's Authorization signature):

    <hex size>;chunk-signature=<64 hex>\r\n
    <size bytes>\r\n
    ...
    0;chunk-signature=<sig>\r\n
    [trailers]\r\n

Per-chunk string-to-sign (chunked_reader_v4.go getChunkSignature):

    AWS4-HMAC-SHA256-PAYLOAD\n<amz date>\n<scope>\n
    <previous signature>\nSHA256("")\nSHA256(chunk data)

`STREAMING-UNSIGNED-PAYLOAD-TRAILER` frames the same way without the
chunk-signature field (newer SDKs with trailing checksums).
"""
from __future__ import annotations

import hashlib
import hmac
import threading
from collections import OrderedDict

from ..utils import metrics

STREAMING_SIGNED = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
STREAMING_UNSIGNED = "STREAMING-UNSIGNED-PAYLOAD-TRAILER"

EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


class ChunkSignatureError(Exception):
    pass


_KEY_CACHE: OrderedDict[tuple[str, str, str, str], bytes] = OrderedDict()
_KEY_CACHE_CAP = 1024
_KEY_LOCK = threading.Lock()


def signing_key(secret: str, datestamp: str, region: str,
                service: str) -> bytes:
    """Derived AWS4 signing key, memoized: the derivation chain is 4
    HMACs but its inputs only change once per DAY per identity.
    LRU-bounded at 1024 entries, under a lock: the port's gateway
    verifies requests on many threads at once."""
    ck = (secret, datestamp, region, service)
    with _KEY_LOCK:
        hit = _KEY_CACHE.get(ck)
        if hit is not None:
            _KEY_CACHE.move_to_end(ck)
    if hit is not None:
        metrics.counter_add("s3_signing_key_cache_total",
                            labels={"outcome": "hit"})
        return hit
    k = hmac.new(("AWS4" + secret).encode(), datestamp.encode(),
                 hashlib.sha256).digest()
    for msg in (region, service, "aws4_request"):
        k = hmac.new(k, msg.encode(), hashlib.sha256).digest()
    metrics.counter_add("s3_signing_key_cache_total",
                        labels={"outcome": "miss"})
    with _KEY_LOCK:
        _KEY_CACHE[ck] = k
        evict = len(_KEY_CACHE) > _KEY_CACHE_CAP
        if evict:
            _KEY_CACHE.popitem(last=False)  # coldest (identity, day)
    if evict:
        metrics.counter_add("s3_signing_key_cache_total",
                            labels={"outcome": "evict"})
    return k


def chunk_signature(key: bytes, amz_date: str, scope: str,
                    prev_signature: str, chunk: bytes) -> str:
    sts = "\n".join([
        "AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope, prev_signature,
        EMPTY_SHA256, hashlib.sha256(chunk).hexdigest()])
    return hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()


def decode_chunked(payload: bytes, *, key: bytes | None = None,
                   amz_date: str = "", scope: str = "",
                   seed_signature: str = "",
                   expected_length: int | None = None) -> bytes:
    """Decode an aws-chunked body, verifying the signature chain when
    `key` is given (signed streaming) and skipping verification when it
    is None (unsigned streaming with trailers). The final zero-size
    chunk is mandatory — without it a truncated-at-a-frame-boundary
    stream would pass every per-chunk check — and `expected_length`
    (x-amz-decoded-content-length, a signed header) is enforced when
    given."""
    out = bytearray()
    prev = seed_signature
    pos = 0
    sealed = False
    n = len(payload)
    while pos < n:
        eol = payload.find(b"\r\n", pos)
        if eol < 0:
            raise ChunkSignatureError("truncated chunk header")
        header = payload[pos:eol].decode("ascii", "replace")
        size_part, _, ext = header.partition(";")
        try:
            size = int(size_part, 16)
        except ValueError:
            raise ChunkSignatureError(f"bad chunk size {size_part!r}")
        sig = ""
        if ext.startswith("chunk-signature="):
            sig = ext[len("chunk-signature="):]
        pos = eol + 2
        chunk = payload[pos:pos + size]
        if len(chunk) != size:
            raise ChunkSignatureError("truncated chunk data")
        pos += size
        if key is not None:
            expect = chunk_signature(key, amz_date, scope, prev, chunk)
            if not hmac.compare_digest(expect, sig):
                raise ChunkSignatureError("chunk signature mismatch")
            prev = expect
        if size == 0:
            sealed = True
            break  # final chunk; anything after is trailers
        out += chunk
        # data chunks are terminated by \r\n (tolerate its absence on
        # the final frame boundary)
        if payload[pos:pos + 2] == b"\r\n":
            pos += 2
    if not sealed:
        raise ChunkSignatureError("stream ended before the final chunk")
    if expected_length is not None and len(out) != expected_length:
        raise ChunkSignatureError(
            f"decoded {len(out)} bytes, declared {expected_length}")
    return bytes(out)


def encode_chunked(data: bytes, *, key: bytes | None = None,
                   amz_date: str = "", scope: str = "",
                   seed_signature: str = "",
                   chunk_size: int = 64 * 1024) -> bytes:
    """Client-side framing (tests + sigv4_client): signed when `key` is
    given, unsigned-trailer style otherwise."""
    out = bytearray()
    prev = seed_signature
    offsets = list(range(0, len(data), chunk_size)) + [len(data)]
    chunks = [data[a:b] for a, b in zip(offsets, offsets[1:])] + [b""]
    if not data:
        chunks = [b""]
    for chunk in chunks:
        if key is not None:
            prev = chunk_signature(key, amz_date, scope, prev, chunk)
            out += (f"{len(chunk):x};chunk-signature={prev}\r\n"
                    .encode())
        else:
            out += f"{len(chunk):x}\r\n".encode()
        out += chunk
        out += b"\r\n"
    return bytes(out)
