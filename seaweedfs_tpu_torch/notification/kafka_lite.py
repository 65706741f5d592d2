"""Minimal Kafka producer protocol client (stdlib only); the
counterpart of seaweedfs_tpu/notification/kafka_lite.py, with the
batch CRC32C from the port's native host codec (native/__init__.py
crc32c) instead of google_crc32c. The request bytes are the
reference's.

Implemented from the public Kafka protocol spec for the kafka
notification queue — the reference publishes through the sarama SDK
(SeaweedFS weed/notification/kafka/kafka_queue.go:15); here the
wire is in-tree like the filer stores' clients. Scope: Metadata v1
(leader discovery), Produce v3 with record-batch v2 framing (magic 2,
CRC32C over the post-crc section, zigzag-varint records), acks=1.
"""
from __future__ import annotations

import socket
import struct
import threading

from ..native import crc32c

API_PRODUCE = 0
API_METADATA = 3


class KafkaError(IOError):
    def __init__(self, code: int, where: str):
        super().__init__(f"kafka error {code} in {where}")
        self.code = code


def zigzag(n: int) -> bytes:
    """Signed varint (zigzag), protobuf-style."""
    u = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _str(s: str | None) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def _bytes(b: bytes | None) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


def encode_record(offset_delta: int, key: bytes, value: bytes) -> bytes:
    body = (b"\x00" +                       # attributes
            zigzag(0) +                     # timestamp delta
            zigzag(offset_delta) +
            zigzag(len(key)) + key +
            zigzag(len(value)) + value +
            zigzag(0))                      # headers count
    return zigzag(len(body)) + body


def encode_record_batch(records: list[tuple[bytes, bytes]],
                        first_timestamp_ms: int) -> bytes:
    """Record batch v2 (magic 2)."""
    recs = b"".join(encode_record(i, k, v)
                    for i, (k, v) in enumerate(records))
    # everything after the crc field is covered by CRC32C
    after_crc = (struct.pack(">hiqqqhi", 0,              # attributes
                             len(records) - 1,           # lastOffsetDelta
                             first_timestamp_ms,
                             first_timestamp_ms,
                             -1, -1,                     # producer id/epoch
                             -1) +                       # baseSequence
                 struct.pack(">i", len(records)) + recs)
    crc = crc32c(after_crc)
    head = (struct.pack(">q", 0) +                       # baseOffset
            struct.pack(">i", 4 + 1 + 4 + len(after_crc)) +  # batchLength
            struct.pack(">i", 0) +                       # leaderEpoch
            b"\x02" +                                    # magic
            struct.pack(">I", crc))
    return head + after_crc


class KafkaClient:
    """One broker connection, synchronous, one request in flight."""

    def __init__(self, host: str, port: int = 9092,
                 client_id: str = "seaweedfs-tpu",
                 timeout: float = 30.0):
        self._sock = socket.create_connection((host, int(port)), timeout)
        self._client_id = client_id
        self._corr = 0
        self._lock = threading.Lock()

    def _call(self, api_key: int, api_version: int,
              body: bytes) -> bytes:
        with self._lock:
            self._corr += 1
            corr = self._corr
            head = struct.pack(">hhi", api_key, api_version, corr) + \
                _str(self._client_id)
            msg = head + body
            self._sock.sendall(struct.pack(">i", len(msg)) + msg)
            raw = self._recv_exact(4)
            (size,) = struct.unpack(">i", raw)
            payload = self._recv_exact(size)
            (got_corr,) = struct.unpack_from(">i", payload)
            if got_corr != corr:
                self.close()
                raise IOError(
                    f"kafka correlation desync: {got_corr} != {corr}")
            return payload[4:]

    def _recv_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            piece = self._sock.recv(n - len(out))
            if not piece:
                raise IOError("kafka connection closed")
            out += piece
        return out

    # -- Metadata v1 ----------------------------------------------------
    def metadata(self, topics: list[str]) -> dict:
        """-> {"brokers": {id: (host, port)}, "topics": {name:
        {"partitions": {pid: leader}, "error": code}}}"""
        body = struct.pack(">i", len(topics)) + \
            b"".join(_str(t) for t in topics)
        p = self._call(API_METADATA, 1, body)
        at = 0
        (n_brokers,) = struct.unpack_from(">i", p, at)
        at += 4
        brokers = {}
        for _ in range(n_brokers):
            (node,) = struct.unpack_from(">i", p, at)
            at += 4
            (hlen,) = struct.unpack_from(">h", p, at)
            at += 2
            host = p[at:at + hlen].decode()
            at += hlen
            (port,) = struct.unpack_from(">i", p, at)
            at += 4
            (rlen,) = struct.unpack_from(">h", p, at)  # rack
            at += 2 + max(0, rlen)
            brokers[node] = (host, port)
        at += 4  # controller id
        (n_topics,) = struct.unpack_from(">i", p, at)
        at += 4
        topics_out = {}
        for _ in range(n_topics):
            (terr,) = struct.unpack_from(">h", p, at)
            at += 2
            (tlen,) = struct.unpack_from(">h", p, at)
            at += 2
            name = p[at:at + tlen].decode()
            at += tlen + 1  # is_internal
            (n_parts,) = struct.unpack_from(">i", p, at)
            at += 4
            parts = {}
            for _ in range(n_parts):
                _perr, pid, leader = struct.unpack_from(">hii", p, at)
                at += 10
                (n_rep,) = struct.unpack_from(">i", p, at)
                at += 4 + 4 * n_rep
                (n_isr,) = struct.unpack_from(">i", p, at)
                at += 4 + 4 * n_isr
                parts[pid] = leader
            topics_out[name] = {"error": terr, "partitions": parts}
        return {"brokers": brokers, "topics": topics_out}

    # -- Produce v3 -----------------------------------------------------
    def produce(self, topic: str, partition: int, key: bytes,
                value: bytes, timestamp_ms: int, acks: int = 1,
                timeout_ms: int = 30000) -> int:
        """-> base offset assigned by the broker."""
        batch = encode_record_batch([(key, value)], timestamp_ms)
        body = (_str(None) +                 # transactional id
                struct.pack(">hi", acks, timeout_ms) +
                struct.pack(">i", 1) + _str(topic) +
                struct.pack(">i", 1) + struct.pack(">i", partition) +
                _bytes(batch))
        p = self._call(API_PRODUCE, 3, body)
        at = 4  # topics array count (1)
        (tlen,) = struct.unpack_from(">h", p, at)
        at += 2 + tlen
        at += 4  # partitions array count (1)
        pid, err, base_offset = struct.unpack_from(">ihq", p, at)
        if err != 0:
            raise KafkaError(err, f"produce {topic}/{pid}")
        return base_offset

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
