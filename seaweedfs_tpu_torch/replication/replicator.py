"""Replicator: consume a filer's metadata event stream and mirror the
namespace into a sink, with resumable offsets; the counterpart of
seaweedfs_tpu/replication/replicator.py, over the port's
rpc/meta_subscriber.py and rpc/httpclient.

Equivalent of SeaweedFS weed/replication/replicator.go driven the way
command/filer_replicate.go drives it: subscribe to metadata events
under a path prefix, translate each event into sink calls, checkpoint
the last-applied ts_ns so restarts resume rather than recopy
(remote_storage/track_sync_offset.go's role, stored in the source
filer's KV). Kept as the reference has it: one KV PUT per event, and a
file's content read whole into memory before the sink gets it.
"""
from __future__ import annotations

from typing import Callable

from ..filer.entry import Entry
from ..rpc.httpclient import RequestException, session
from ..rpc.meta_subscriber import MetaSubscriber
from .sink import ReplicationSink


class Replicator:
    def __init__(self, source_filer: str, sink: ReplicationSink,
                 path_prefix: str = "/", offset_key: str = "",
                 exclude_signature: int = 0):
        """exclude_signature: skip events already signed by this id —
        the active-active loop guard (filer_sync.go)."""
        self.source = source_filer.rstrip("/") \
            if source_filer.startswith("http") else \
            f"http://{source_filer}"
        self.sink = sink
        self.prefix = path_prefix.rstrip("/") or "/"
        self.offset_key = offset_key or \
            f"replication/{sink.name}/offset"
        self.exclude_signature = exclude_signature
        self._sub: MetaSubscriber | None = None
        self.applied = 0
        self.skipped = 0
        self.failed = 0  # poison events skipped after a failed apply

    # -- offsets --------------------------------------------------------
    def _load_offset(self) -> int:
        try:
            r = session().get(f"{self.source}/kv/{self.offset_key}",
                              timeout=5)
            if r.status_code == 200:
                return int(r.content)
        except (RequestException, ValueError):
            pass
        return 0

    def _save_offset(self, ts_ns: int) -> None:
        try:
            session().put(f"{self.source}/kv/{self.offset_key}",
                          data=str(ts_ns).encode(), timeout=5)
        except RequestException:
            pass

    # -- the event pump -------------------------------------------------
    def start(self) -> None:
        self._sub = MetaSubscriber(self.source, self.prefix,
                                   self._handle,
                                   since_fn=self._load_offset)
        self._sub.start()

    def stop(self) -> None:
        if self._sub is not None:
            self._sub.stop()
            self._sub = None

    def _handle(self, ev: dict) -> None:
        """One event, called by the subscriber's worker thread."""
        try:
            self.apply(ev)
        except Exception:  # noqa: BLE001 — see below
            # poison event (e.g. create whose content is already deleted
            # at the source): count it and move on — replaying it forever
            # would wedge the stream behind it (a later event supersedes
            # it anyway)
            self.failed += 1
        self._save_offset(ev["ts_ns"])

    # -- event -> sink ---------------------------------------------------
    def _rel(self, full_path: str) -> str:
        if self.prefix != "/" and full_path.startswith(self.prefix):
            return full_path[len(self.prefix):] or "/"
        return full_path

    def _reader(self, full_path: str) -> Callable[[], bytes]:
        src = self.source

        def read() -> bytes:
            r = session().get(f"{src}{full_path}", timeout=300)
            r.raise_for_status()
            return r.content

        return read

    def apply(self, ev: dict) -> None:
        """Route one metadata event to the sink
        (replicator.go Replicate)."""
        if self.exclude_signature and \
                self.exclude_signature in ev.get("signatures", []):
            self.skipped += 1
            return
        old, new = ev.get("old_entry"), ev.get("new_entry")
        if old is None and new is None:
            return
        if new is None:  # delete
            e = Entry.from_dict(old)
            self.sink.delete_entry(self._rel(e.full_path),
                                   e.is_directory)
        elif old is None:  # create
            e = Entry.from_dict(new)
            self.sink.create_entry(self._rel(e.full_path), e,
                                   self._reader(e.full_path))
        else:  # update / rename
            oe, ne = Entry.from_dict(old), Entry.from_dict(new)
            if oe.full_path != ne.full_path:
                self.sink.delete_entry(self._rel(oe.full_path),
                                       oe.is_directory)
            self.sink.update_entry(self._rel(ne.full_path), ne,
                                   self._reader(ne.full_path))
        self.applied += 1
