"""Metadata event log: every namespace mutation, in order,
subscribable; the counterpart of seaweedfs_tpu/filer/event_log.py,
copied as is.

Equivalent of SeaweedFS weed/filer/filer_notify.go (EventNotify) +
weed/util/log_buffer/log_buffer.go:25-44 — the filer appends every
create/update/delete/rename to a local log that powers metadata
subscriptions, replication, filer.sync, S3 events and mount cache
invalidation. (The port's filer has no /ws/meta_subscribe yet: the log
is appended to and read in-process.)

Events are dicts:
  {"ts_ns": int, "directory": str,
   "old_entry": dict|None, "new_entry": dict|None,
   "signatures": [int, ...]}
old=None -> create; new=None -> delete; both -> update/rename.
Signatures mark which peers have already seen an event, preventing
active-active sync loops (weed/command/filer_sync.go).
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from typing import Callable

from .entry import Entry


class MetaEventLog:
    def __init__(self, capacity: int = 100_000, signature: int = 0):
        self.signature = signature or (hash(id(self)) & 0x7FFFFFFF)
        self._buf: deque[dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._subs: dict[int, queue.Queue] = {}
        self._sub_ids = itertools.count()
        self._last_ts_ns = 0
        # called INSIDE append, under the log lock (which is inside the
        # filer mutation lock): consumers that must observe mutations
        # in exact store order with no queue delay — e.g. the native S3
        # front's read cache, whose staleness window must be zero for
        # read-after-write consistency. Keep these callbacks tiny and
        # lock-free; exceptions are swallowed (a cache maintainer must
        # never fail a filer write).
        self.sync_listeners: list[Callable[[dict], None]] = []

    def append(self, directory: str, old_entry: Entry | None,
               new_entry: Entry | None,
               signatures: list[int] | None = None,
               new_dict: dict | None = None) -> dict:
        """new_dict: the caller's already-built new_entry.to_dict(),
        when it has one (the filer shares one dict between the store
        encode and this event on the hot path)."""
        with self._lock:
            ts = time.time_ns()
            if ts <= self._last_ts_ns:  # keep strictly ordered
                ts = self._last_ts_ns + 1
            self._last_ts_ns = ts
            if new_dict is None and new_entry is not None:
                new_dict = new_entry.to_dict()
            ev = {"ts_ns": ts, "directory": directory,
                  "old_entry": old_entry.to_dict() if old_entry else None,
                  "new_entry": new_dict,
                  "signatures": list(signatures or []) + [self.signature]}
            self._buf.append(ev)
            for q in self._subs.values():
                q.put(ev)
            for fn in self.sync_listeners:
                try:
                    fn(ev)
                except Exception:
                    pass
            return ev

    def subscribe(self, since_ts_ns: int = 0) -> tuple[int, queue.Queue]:
        """Register a live subscriber; returns (id, queue) with any
        buffered events newer than since_ts_ns already enqueued."""
        with self._lock:
            q: queue.Queue = queue.Queue()
            for ev in self._buf:
                if ev["ts_ns"] > since_ts_ns:
                    q.put(ev)
            sid = next(self._sub_ids)
            self._subs[sid] = q
            return sid, q

    def unsubscribe(self, sid: int) -> None:
        with self._lock:
            self._subs.pop(sid, None)

    def replay(self, since_ts_ns: int = 0,
               prefix: str | None = None) -> list[dict]:
        with self._lock:
            return [ev for ev in self._buf if ev["ts_ns"] > since_ts_ns
                    and (prefix is None
                         or ev["directory"].startswith(prefix))]


def event_kind(ev: dict) -> str:
    if ev["old_entry"] is None and ev["new_entry"] is not None:
        return "create"
    if ev["old_entry"] is not None and ev["new_entry"] is None:
        return "delete"
    if ev["old_entry"] is not None and ev["new_entry"] is not None:
        return "update"
    return "noop"


def iter_events(q: queue.Queue, stop: threading.Event,
                handler: Callable[[dict], None],
                poll_s: float = 0.2) -> None:
    """Drain a subscription queue until `stop` is set."""
    while not stop.is_set():
        try:
            ev = q.get(timeout=poll_s)
        except queue.Empty:
            continue
        handler(ev)
