"""File-id sequencer: a monotonic in-memory counter; the counterpart of
seaweedfs_tpu/master/sequence.py (SeaweedFS weed/sequence/sequence.go:3-7).
Not here: the snowflake sequencer, which only HA masters use.
"""
from __future__ import annotations

import threading


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
