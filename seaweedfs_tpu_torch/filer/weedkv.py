"""Embedded sorted-KV engine ("weedkv") — the leveldb-class store.

Equivalent of the role vendored goleveldb plays for the reference's
default filer store (SeaweedFS weed/filer/leveldb/
leveldb_store.go): an embedded, ordered, durable key-value log —
re-designed small instead of ported:

- writes go to a write-ahead log, then a memtable (dict)
- the memtable flushes to immutable sorted segment files (.sst, JSON
  lines sorted by key) when it grows past a threshold
- reads check memtable then segments newest-to-oldest; deletes are
  tombstones until compaction
- when segments pile up they are merge-compacted into one (tombstones
  dropped)
- reopen = load segment indexes + replay the WAL

Keys are bytes and sort lexicographically (the property the filer
store's directory scans rely on). Values are bytes.

The port's copy of seaweedfs_tpu/filer/weedkv.py: the same files, keys,
rows and request bytes, over the standard library only.
"""
from __future__ import annotations

import base64
import bisect
import heapq
import json
import os
import struct
import threading
import zlib

TOMBSTONE = None  # in-memory marker

MEMTABLE_FLUSH_ENTRIES = 4096
MEMTABLE_FLUSH_BYTES = 4 << 20
COMPACT_SEGMENT_COUNT = 8


def _enc(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _dec(s: str) -> bytes:
    return base64.b64decode(s)


def _encode_record(key: bytes, value: bytes | None) -> str:
    """One segment line: {"k": ..} + either "t" (tombstone) or
    "v". The single place the SEGMENT record format lives (segments
    are written at flush time, off the hot path; the WAL uses the
    binary v2 framing below)."""
    rec = {"k": _enc(key)}
    if value is None:
        rec["t"] = 1
    else:
        rec["v"] = _enc(value)
    return json.dumps(rec, separators=(",", ":")) + "\n"


# -- WAL v2 binary framing ----------------------------------------------
# The original WAL shared the segment's JSON-lines format; base64 +
# json.dumps per record measured as the single largest slice of the S3
# applier's create_entry budget. v2 frames are binary:
#   [u8 tag 0=tombstone 1=put][u32le klen][u32le vlen][key][value]
#   [u32le crc32(frame minus crc)]
# The trailing CRC gives the same torn-tail detection the JSON parse
# failure used to provide. Legacy (JSON) WALs are still replayed and
# are rewritten as v2 on open — see _replay_wal.
WAL2_MAGIC = b"WKV2\n"
_WAL2_HDR = struct.Struct("<BII")


def _encode_wal2(key: bytes, value: bytes | None) -> bytes:
    frame = _WAL2_HDR.pack(0 if value is None else 1,
                           len(key), len(value or b"")) + key + (
                               value or b"")
    return frame + struct.pack("<I", zlib.crc32(frame))


def _decode_record(d: dict) -> tuple[bytes, bytes | None]:
    return _dec(d["k"]), (None if d.get("t")
                          else _dec(d.get("v", "")))


class _Segment:
    """One immutable sorted file with its key index in memory."""

    def __init__(self, path: str,
                 items: list[tuple[bytes, bytes | None]] | None = None):
        """Load from `path`, or adopt already-sorted `items` without
        re-reading the file just written from them."""
        self.path = path
        self.keys: list[bytes] = []
        self.values: list[bytes | None] = []
        if items is not None:
            self.keys = [k for k, _ in items]
            self.values = [v for _, v in items]
            return
        with open(path, "r") as f:
            for line in f:
                if not line.strip():
                    continue
                k, v = _decode_record(json.loads(line))
                self.keys.append(k)
                self.values.append(v)

    def get(self, key: bytes) -> tuple[bool, bytes | None]:
        """-> (found, value-or-tombstone)."""
        i = bisect.bisect_left(self.keys, key)
        if i < len(self.keys) and self.keys[i] == key:
            return True, self.values[i]
        return False, None

    @staticmethod
    def write(path: str, items: list[tuple[bytes, bytes | None]]) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            for k, v in items:
                f.write(_encode_record(k, v))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)


class WeedKV:
    def __init__(self, dirpath: str):
        self.dir = dirpath
        os.makedirs(dirpath, exist_ok=True)
        self._lock = threading.RLock()
        self._mem: dict[bytes, bytes | None] = {}
        # sorted view of _mem's keys, maintained on write: a scan page
        # must cost O(log mem + page), not a full-memtable filter+sort
        # per page (the redis3 chunked-skiplist concern — a million-
        # entry directory pages through MANY scans while its inserts
        # keep landing in the memtable)
        self._mem_keys: list[bytes] = []
        self._mem_bytes = 0
        self._segments: list[_Segment] = []  # oldest .. newest
        self._next_seg = 0
        for name in sorted(os.listdir(dirpath)):
            if name.endswith(".sst"):
                self._segments.append(
                    _Segment(os.path.join(dirpath, name)))
                self._next_seg = max(self._next_seg,
                                     int(name[:-4]) + 1)
        self._wal_path = os.path.join(dirpath, "wal.log")
        self._flush_local = threading.local()
        self._replay_wal()
        self._mem_keys = sorted(self._mem)
        # binary + buffered: the hot path writes pre-encoded bytes
        # (a TextIOWrapper re-encodes every record on this path)
        self._open_wal(fresh=False)

    # -- WAL ------------------------------------------------------------
    def _open_wal(self, fresh: bool) -> None:
        """(Re)open self._wal for appending; a fresh/empty file gets
        the v2 magic so replay never misreads it as legacy JSON. The
        one place the 'start a v2 WAL' ritual lives."""
        self._wal = open(self._wal_path, "wb" if fresh else "ab")
        if self._wal.tell() == 0:
            self._wal.write(WAL2_MAGIC)
            self._wal.flush()

    def _replay_wal(self) -> None:
        if not os.path.exists(self._wal_path):
            return
        with open(self._wal_path, "rb") as f:
            raw = f.read()
        legacy = not raw.startswith(WAL2_MAGIC)
        good = self._replay_legacy(raw) if legacy \
            else self._replay_v2(raw)
        if legacy and raw:
            # migrate in place: rewrite the replayed records as v2 via
            # tmp+rename so a crash mid-rewrite still leaves the old
            # acknowledged WAL intact
            tmp = self._wal_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(WAL2_MAGIC)
                for k, v in self._mem.items():
                    f.write(_encode_wal2(k, v))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._wal_path)
        elif good < len(raw):
            # drop the torn tail NOW: appending new records after the
            # garbage would make every later replay stop at the same
            # spot and silently lose those acknowledged writes
            with open(self._wal_path, "r+b") as f:
                f.truncate(good)

    def _replay_legacy(self, raw: bytes) -> int:
        good = 0
        for line in raw.splitlines(keepends=True):
            try:
                k, v = _decode_record(json.loads(line))
            except (json.JSONDecodeError, UnicodeDecodeError,
                    KeyError, ValueError):
                break  # torn tail from a crash mid-append
            self._mem[k] = v
            self._mem_bytes += len(k) + len(v or b"")
            good += len(line)
        return good

    def _replay_v2(self, raw: bytes) -> int:
        off = len(WAL2_MAGIC)
        hdr = _WAL2_HDR.size
        while True:
            if off + hdr > len(raw):
                break
            tag, klen, vlen = _WAL2_HDR.unpack_from(raw, off)
            end = off + hdr + klen + vlen + 4
            if tag > 1 or end > len(raw):
                break  # torn/garbage tail
            (crc,) = struct.unpack_from("<I", raw, end - 4)
            if zlib.crc32(raw[off:end - 4]) != crc:
                break
            k = raw[off + hdr:off + hdr + klen]
            v = raw[off + hdr + klen:end - 4] if tag else None
            self._mem[k] = v
            self._mem_bytes += len(k) + len(v or b"")
            off = end
        return off

    def _wal_append(self, key: bytes, value: bytes | None) -> None:
        self._wal.write(_encode_wal2(key, value))
        if not getattr(self._flush_local, "deferred", False):
            self._wal.flush()

    def defer_flush(self, deferred: bool) -> None:
        """Group-commit window for THE CALLING THREAD only: while
        deferred, its puts skip the per-record WAL flush; turning
        deferral off flushes the accumulated tail. Thread-local on
        purpose — other writers sharing the store keep their
        flush-before-ack durability (their flush also carries any
        deferred records ahead of them in the sequential WAL, which is
        harmless over-flushing). The deferring caller must not ack its
        own batch until the window closes."""
        self._flush_local.deferred = deferred
        if not deferred:
            with self._lock:
                self._wal.flush()

    # -- core ops -------------------------------------------------------
    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._wal_append(key, value)
            if key not in self._mem:
                bisect.insort(self._mem_keys, key)
            self._mem[key] = value
            self._mem_bytes += len(key) + len(value)
            self._maybe_flush()

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._wal_append(key, None)
            if key not in self._mem:
                bisect.insort(self._mem_keys, key)
            self._mem[key] = TOMBSTONE
            self._mem_bytes += len(key)
            self._maybe_flush()

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            if key in self._mem:
                return self._mem[key]
            for seg in reversed(self._segments):
                found, v = seg.get(key)
                if found:
                    return v
            return None

    def scan(self, start: bytes, end: bytes,
             limit: int = 0) -> list[tuple[bytes, bytes]]:
        """Live (key, value) with start <= key < end, sorted; at most
        `limit` rows when given. Lazily k-way-merges the sorted sources
        so a paged directory listing doesn't materialize the whole
        range (the role of leveldb's iterator)."""

        with self._lock:
            def seg_rows(seg: _Segment, rank: int):
                lo = bisect.bisect_left(seg.keys, start)
                hi = bisect.bisect_left(seg.keys, end)
                for i in range(lo, hi):
                    yield seg.keys[i], rank, seg.values[i]

            sources = [seg_rows(seg, rank)
                       for rank, seg in enumerate(self._segments)]

            def mem_rows():
                lo = bisect.bisect_left(self._mem_keys, start)
                hi = bisect.bisect_left(self._mem_keys, end)
                rank = len(self._segments)
                for i in range(lo, hi):
                    k = self._mem_keys[i]
                    yield k, rank, self._mem[k]

            sources.append(mem_rows())
            out: list[tuple[bytes, bytes]] = []
            cur_key: bytes | None = None
            cur_rank, cur_val = -1, None
            for k, rank, v in heapq.merge(*sources):
                if k != cur_key:
                    if cur_key is not None and cur_val is not None:
                        out.append((cur_key, cur_val))
                        if limit and len(out) >= limit:
                            return out
                    cur_key, cur_rank, cur_val = k, rank, v
                elif rank > cur_rank:  # newer source shadows older
                    cur_rank, cur_val = rank, v
            if cur_key is not None and cur_val is not None:
                out.append((cur_key, cur_val))
            return out[:limit] if limit else out

    # -- flush / compact ------------------------------------------------
    def _maybe_flush(self) -> None:
        if len(self._mem) >= MEMTABLE_FLUSH_ENTRIES or \
                self._mem_bytes >= MEMTABLE_FLUSH_BYTES:
            self.flush()

    def flush(self) -> None:
        """Memtable -> a new sorted segment; truncate the WAL."""
        with self._lock:
            if not self._mem:
                return
            items = [(k, self._mem[k]) for k in self._mem_keys]
            path = os.path.join(self.dir, f"{self._next_seg:06d}.sst")
            _Segment.write(path, items)
            self._segments.append(_Segment(path, items=items))
            self._next_seg += 1
            self._mem = {}
            self._mem_keys = []
            self._mem_bytes = 0
            self._wal.close()
            self._open_wal(fresh=True)
            if len(self._segments) >= COMPACT_SEGMENT_COUNT:
                self.compact()

    SLOW_COMPACTION_SECONDS = 1.0

    def compact(self) -> None:
        """Merge all segments into one, dropping tombstones and
        shadowed versions. Reads and writes stall on the store lock
        for the whole merge — which is why the time and volume are
        first-class metrics (filer_store_compaction_*): a grown
        store's read p99 IS this pause."""
        import time

        from ..utils import glog, metrics

        with self._lock:
            if len(self._segments) <= 1:
                return
            t0 = time.perf_counter()
            n_segments = len(self._segments)
            merged: dict[bytes, bytes | None] = {}
            read_bytes = 0
            for seg in self._segments:  # oldest first
                for k, v in zip(seg.keys, seg.values):
                    merged[k] = v
                    read_bytes += len(k) + len(v or b"")
            live = sorted((k, v) for k, v in merged.items()
                          if v is not None)
            path = os.path.join(self.dir, f"{self._next_seg:06d}.sst")
            _Segment.write(path, live)
            old = self._segments
            self._segments = [_Segment(path, items=live)]
            self._next_seg += 1
            for seg in old:
                try:
                    os.remove(seg.path)
                except OSError:
                    pass
            dt = time.perf_counter() - t0
        metrics.histogram_observe("filer_store_compaction_seconds", dt)
        metrics.counter_add("filer_store_compaction_bytes_total",
                            read_bytes)
        if dt >= self.SLOW_COMPACTION_SECONDS:
            glog.warning(
                "slow compaction: %s merged %d segments "
                "(%d keys, %d bytes) in %.2fs — reads stalled for the "
                "duration", self.dir, n_segments, len(live),
                read_bytes, dt)
        else:
            glog.v(1, "compacted %s: %d segments -> 1 (%d keys, "
                   "%d bytes) in %.3fs", self.dir, n_segments,
                   len(live), read_bytes, dt)

    def close(self) -> None:
        with self._lock:
            self.flush()
            self._wal.close()
