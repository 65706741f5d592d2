"""filer.remote.sync: push local writes under a remote mount back to
the cloud; the counterpart of seaweedfs_tpu/remote_storage/sync.py.

Equivalent of SeaweedFS weed/command/filer_remote_sync.go +
filer_remote_sync_dir.go: subscribe to the filer's metadata events
under the mounted directory and mirror mutations outward — uploads for
creates/updates that carry local chunks, deletes for removals, a
delete+upload pair for renames. Events produced by our own bookkeeping
(placeholder entries from remote.meta.sync, remote-metadata refreshes)
carry no local chunks or already match the remote object, and are
skipped — that's the loop guard (the reference excludes by signature).
"""
from __future__ import annotations

import json
import time

from ..filer.entry import Entry
from ..rpc.httpclient import RequestException, session
from ..rpc.meta_subscriber import MetaSubscriber
from .mount import find_mount, load_conf, remote_key_for


class RemoteSyncWorker:
    def __init__(self, filer_url: str, dir: str):
        self.filer = filer_url.rstrip("/") \
            if filer_url.startswith("http") else f"http://{filer_url}"
        self.dir = "/" + dir.strip("/")
        conf = load_conf(self.filer)
        self.mount = find_mount(conf, self.dir)
        if self.mount is None:
            raise ValueError(f"{self.dir} is not a remote mount")
        storage_conf = conf.storages[self.mount.storage]
        from .client import make_client
        self.client = make_client(storage_conf)
        self.offset_key = f"remote.sync/{self.dir.strip('/')}/offset"
        self._sub: MetaSubscriber | None = None
        self.pushed = 0
        self.deleted = 0
        self.skipped = 0
        self.failed = 0

    # offsets persist in the filer KV so restarts resume (the
    # reference's remote_storage/track_sync_offset.go)
    def _load_offset(self) -> int:
        try:
            r = session().get(f"{self.filer}/kv/{self.offset_key}",
                             timeout=5)
            if r.status_code == 200:
                return int(r.content)
        except (RequestException, ValueError):
            pass
        return 0

    def _save_offset(self, ts_ns: int) -> None:
        try:
            session().put(f"{self.filer}/kv/{self.offset_key}",
                         data=str(ts_ns).encode(), timeout=5)
        except RequestException:
            pass

    def start(self) -> None:
        self._sub = MetaSubscriber(self.filer, self.dir, self._handle,
                                   since_fn=self._load_offset)
        self._sub.start()

    def stop(self) -> None:
        if self._sub is not None:
            self._sub.stop()
            self._sub = None

    RETRIES = 4

    def _handle(self, ev: dict) -> None:
        """Apply with bounded retries before giving up: a transient
        endpoint failure must not silently drop a one-time write (the
        offset only advances once we stop trying)."""
        for attempt in range(self.RETRIES):
            try:
                self.apply(ev)
                break
            except Exception:  # noqa: BLE001 — retried, then counted
                if attempt == self.RETRIES - 1:
                    self.failed += 1  # poison event: move on so the
                    break             # stream doesn't wedge behind it
                time.sleep(0.5 * (attempt + 1))
        self._save_offset(ev["ts_ns"])

    def _key(self, path: str) -> str:
        return remote_key_for(self.mount, path)

    def _in_mount(self, path: str) -> bool:
        return path == self.dir or \
            path.startswith(self.dir.rstrip("/") + "/")

    @staticmethod
    def _recorded_key(entry: Entry) -> str:
        return json.loads(
            entry.extended.get("remote", "{}")).get("key", "")

    def apply(self, ev: dict) -> None:
        """The filer emits a rename as create(new path) THEN
        delete(old path) (filer/_move), so the rename signal on the
        create side is the entry's recorded remote key disagreeing with
        the key its path implies — the object is copied to the new key
        there, and the later delete event (whose entry still records
        the old key) removes the old object."""
        old = Entry.from_dict(ev["old_entry"]) if ev.get("old_entry") \
            else None
        new = Entry.from_dict(ev["new_entry"]) if ev.get("new_entry") \
            else None
        if new is None and old is not None:  # delete
            if not self._in_mount(old.full_path):
                return
            if old.is_directory:
                self.client.remove_directory(self._key(old.full_path))
            else:
                # the recorded key survives renames; the path-derived
                # one is the fallback for plain local files
                self.client.delete_file(
                    self._recorded_key(old) or self._key(old.full_path))
            self.deleted += 1
            return
        if new is None:
            return
        if old is not None and old.full_path != new.full_path and \
                self._in_mount(old.full_path):
            # single-event rename (defensive: our filer splits renames)
            if old.is_directory:
                self.client.remove_directory(self._key(old.full_path))
            else:
                self.client.delete_file(
                    self._recorded_key(old) or self._key(old.full_path))
        if not self._in_mount(new.full_path) or new.is_directory:
            return
        expected_key = self._key(new.full_path)
        remote_meta = json.loads(new.extended.get("remote", "{}"))
        recorded = remote_meta.get("key", "")
        if recorded and recorded != expected_key:
            # renamed remote entry: copy to the new key BEFORE the
            # old object is dropped by the upcoming delete event —
            # for an uncached placeholder the old object is the only
            # copy of the bytes
            if new.chunks:
                r = session().get(f"{self.filer}{new.full_path}",
                                 timeout=600)
                r.raise_for_status()
                data = r.content
            else:
                data = self.client.read_file(recorded)
            re_ = self.client.write_file(expected_key, data)
            self._refresh_remote_meta(new, re_)
            self.pushed += 1
            return
        if not new.chunks:
            # placeholder/uncache bookkeeping — nothing local to push
            self.skipped += 1
            return
        if remote_meta.get("etag") and remote_meta.get("etag") == new.md5:
            self.skipped += 1  # our own post-upload metadata refresh
            return
        if remote_meta and not new.md5 and \
                remote_meta.get("size") == new.file_size:
            # remote.cache materialisation: chunks were read FROM the
            # remote object — pushing them back would be a no-op write
            self.skipped += 1
            return
        r = session().get(f"{self.filer}{new.full_path}", timeout=600)
        r.raise_for_status()
        data = r.content
        re_ = self.client.write_file(expected_key, data)
        self._refresh_remote_meta(new, re_)
        self.pushed += 1

    def _refresh_remote_meta(self, entry: Entry, re_) -> None:
        """Write the entry's remote metadata back (sets etag == md5 so
        the resulting event is recognised as ours and skipped).

        The event's entry snapshot may be stale by the time we run —
        posting it back verbatim would revert a concurrent newer write
        (and delete its chunks). Re-fetch the live entry and only attach
        the remote metadata if it is still the version we pushed."""
        r = session().get(f"{self.filer}{entry.full_path}",
                         params={"meta": "1"}, timeout=60)
        if r.status_code == 404:
            return  # deleted meanwhile; the delete event will mirror it
        r.raise_for_status()
        live = r.json()
        if entry.md5 and live.get("md5") and live["md5"] != entry.md5:
            return  # newer write in flight; its own event handles it
        ent = live
        ent.setdefault("extended", {})["remote"] = json.dumps(
            {"key": re_.key, "size": re_.size, "mtime": re_.mtime,
             "etag": entry.md5 or re_.etag})
        session().post(f"{self.filer}{entry.full_path}",
                      params={"meta": "1"}, data=json.dumps(ent),
                      timeout=60).raise_for_status()


def run_remote_sync(filer_url: str, dir: str) -> RemoteSyncWorker:
    w = RemoteSyncWorker(filer_url, dir)
    w.start()
    return w
