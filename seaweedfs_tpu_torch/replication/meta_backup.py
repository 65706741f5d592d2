"""Continuous filer metadata backup into a local store; the
counterpart of seaweedfs_tpu/replication/meta_backup.py.

Equivalent of SeaweedFS weed/command/filer_meta_backup.go: apply the
metadata event stream to a FilerStore (the port's sqlite store, whose
file the reference's store reads too), checkpointing the last-applied
event in that store's KV (`meta_backup/offset`) so restarts resume.
The result is a queryable point-in-time copy of the namespace (not the
file bytes — that is the data replication sinks' job).
"""
from __future__ import annotations

from ..filer.entry import Entry
from ..filer.filerstore import make_store
from ..rpc.meta_subscriber import MetaSubscriber


class FilerMetaBackup:
    def __init__(self, source_filer: str, backup_path: str,
                 path_prefix: str = "/"):
        self.source = source_filer.rstrip("/") \
            if source_filer.startswith("http") else \
            f"http://{source_filer}"
        self.prefix = path_prefix
        self.store = make_store("sqlite", path=backup_path)
        self._sub: MetaSubscriber | None = None
        self.applied = 0

    def _offset(self) -> int:
        v = self.store.kv_get("meta_backup/offset")
        return int(v) if v else 0

    def _save_offset(self, ts_ns: int) -> None:
        self.store.kv_put("meta_backup/offset", str(ts_ns).encode())

    def apply(self, ev: dict) -> None:
        old, new = ev.get("old_entry"), ev.get("new_entry")
        if new is None and old is not None:
            self.store.delete_entry(old["full_path"])
        elif new is not None:
            if old is not None and old["full_path"] != new["full_path"]:
                self.store.delete_entry(old["full_path"])
            self.store.insert_entry(Entry.from_dict(new))
        self.applied += 1

    def _handle(self, ev: dict) -> None:
        self.apply(ev)
        self._save_offset(ev["ts_ns"])

    def start(self) -> None:
        self._sub = MetaSubscriber(self.source, self.prefix,
                                   self._handle, since_fn=self._offset)
        self._sub.start()

    def stop(self) -> None:
        if self._sub is not None:
            self._sub.stop()
            self._sub = None

    # -- restore/query ---------------------------------------------------
    def find_entry(self, path: str) -> Entry | None:
        return self.store.find_entry(path)

    def list_entries(self, dirpath: str) -> list[Entry]:
        return self.store.list_directory_entries(dirpath)
