"""File-id sequencers; the counterpart of seaweedfs_tpu/master/sequence.py
(SeaweedFS weed/sequence/sequence.go:3-7, snowflake_sequencer.go:16): a
monotonic in-memory counter, and a snowflake generator
(41-bit ms timestamp | 10-bit node | 12-bit sequence) that HA masters
use, since its ids stay unique across restarts and leader failovers
without replication.

`next_ids(count)` returns the first of `count` ids, and callers use
`first .. first+count-1` as needle keys (the filer assigns 128 at a
time). The snowflake sequencer therefore reserves a batch inside one
millisecond's sequence space: a batch that would run past sequence
4095 starts at 0 of the next millisecond, so no key of it reaches into
the node-id bits. The reference's loop hands out the batch's ids one
by one and wraps mid-batch, so the contiguous keys of such a batch
carry the next node id. A clock that steps back keeps the last
millisecond, so ids never repeat.
"""
from __future__ import annotations

import threading
import time

_EPOCH_MS = 1_577_836_800_000  # 2020-01-01
SEQ_BITS = 12
SEQ_SPACE = 1 << SEQ_BITS       # ids one node can mint per millisecond
NODE_BITS = 10


class MemorySequencer:
    def __init__(self, start: int = 1):
        self._next = start
        self._lock = threading.Lock()

    def next_ids(self, count: int = 1) -> int:
        """Reserve `count` ids; returns the first."""
        with self._lock:
            first = self._next
            self._next += count
            return first

    def set_max(self, seen: int) -> None:
        with self._lock:
            if seen >= self._next:
                self._next = seen + 1

    def peek(self) -> int:
        return self._next


class SnowflakeSequencer:
    def __init__(self, node_id: int = 0):
        self.node_id = node_id & ((1 << NODE_BITS) - 1)
        self._lock = threading.Lock()
        self._last_ms = 0
        self._seq = -1           # last sequence used in _last_ms

    @staticmethod
    def _now_ms() -> int:
        return int(time.time() * 1000) - _EPOCH_MS

    def next_ids(self, count: int = 1) -> int:
        """Reserve `count` contiguous ids of one millisecond; returns
        the first. At most SEQ_SPACE ids fit in a batch."""
        if not 1 <= count <= SEQ_SPACE:
            raise ValueError(f"a snowflake batch holds 1..{SEQ_SPACE} "
                             f"ids, not {count}")
        with self._lock:
            now = self._now_ms()
            if now <= self._last_ms:
                now = self._last_ms
                start = self._seq + 1
                if start + count > SEQ_SPACE:
                    # the batch does not fit in this millisecond
                    while now <= self._last_ms:
                        now = self._now_ms()
                    start = 0
            else:
                start = 0
            self._last_ms = now
            self._seq = start + count - 1
            return (now << (NODE_BITS + SEQ_BITS)) | \
                (self.node_id << SEQ_BITS) | start

    def set_max(self, seen: int) -> None:
        pass  # time-derived; nothing to advance
