"""filer.remote.gateway: mirror bucket lifecycle + contents outward;
the counterpart of seaweedfs_tpu/remote_storage/gateway.py.

Equivalent of SeaweedFS weed/command/filer_remote_gateway.go +
filer_remote_gateway_buckets.go: subscribe to the filer's metadata
events under the buckets directory and

- on bucket creation, create a matching bucket in the primary remote
  storage (optionally with a random suffix to dodge global-name
  conflicts) and record the mount mapping;
- on bucket deletion, delete the remote bucket and drop the mapping;
- for every file mutation inside a mapped bucket, write the change
  back to its remote storage (same mirroring rules as
  filer.remote.sync, reusing RemoteSyncWorker.apply per bucket).

Progress is resumable: the event-stream offset persists in the filer
KV, like the reference's pb.AddOffsetFunc + remote_storage offset
tracking.
"""
from __future__ import annotations

import fnmatch
import time
import uuid

from ..filer.entry import Entry
from ..rpc.httpclient import RequestException, session
from ..rpc.meta_subscriber import MetaSubscriber
from .client import make_client
from .mount import RemoteMount, load_conf, save_conf
from .sync import RemoteSyncWorker


class RemoteGateway:
    RETRIES = 4

    def __init__(self, filer_url: str, create_bucket_at: str = "",
                 bucket_suffix: bool = False, include: str = "",
                 exclude: str = "", buckets_dir: str = "/buckets"):
        self.filer = filer_url.rstrip("/") \
            if filer_url.startswith("http") else f"http://{filer_url}"
        self.buckets_dir = "/" + buckets_dir.strip("/")
        self.include = include
        self.exclude = exclude
        self.bucket_suffix = bucket_suffix
        self.conf = load_conf(self.filer)
        self._conf_time = time.monotonic()
        if not create_bucket_at and len(self.conf.storages) == 1:
            create_bucket_at = next(iter(self.conf.storages))
        self.create_bucket_at = create_bucket_at
        self.offset_key = "remote.gateway/offset"
        self._workers: dict[str, RemoteSyncWorker] = {}
        self._sub: MetaSubscriber | None = None
        self.buckets_created = 0
        self.buckets_deleted = 0
        self.failed = 0

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        self._sub = MetaSubscriber(self.filer, self.buckets_dir,
                                   self._handle,
                                   since_fn=self._load_offset)
        self._sub.start()

    def stop(self) -> None:
        if self._sub is not None:
            self._sub.stop()
            self._sub = None

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

    # -- event routing --------------------------------------------------
    def _handle(self, ev: dict) -> None:
        for attempt in range(self.RETRIES):
            try:
                self.apply(ev)
                break
            except Exception:  # noqa: BLE001 — retried, then counted
                if attempt == self.RETRIES - 1:
                    self.failed += 1
                    break
                time.sleep(0.5 * (attempt + 1))
        self._save_offset(ev["ts_ns"])

    def _bucket_of(self, path: str) -> str | None:
        """/buckets/<name> -> name; deeper or shallower paths -> None."""
        prefix = self.buckets_dir.rstrip("/") + "/"
        if not path.startswith(prefix):
            return None
        rest = path[len(prefix):]
        return rest if rest and "/" not in rest else None

    def _name_allowed(self, name: str) -> bool:
        if self.include and not fnmatch.fnmatch(name, self.include):
            return False
        if self.exclude and fnmatch.fnmatch(name, self.exclude):
            return False
        return True

    def apply(self, ev: dict) -> None:
        old, new = ev.get("old_entry"), ev.get("new_entry")
        path = (new or old or {}).get("full_path", "")
        bucket = self._bucket_of(path)
        if bucket is not None:
            is_dir = Entry.from_dict(new or old).is_directory
            if is_dir and new is not None and old is None:
                self._create_bucket(bucket)
                return
            if is_dir and new is None and old is not None:
                self._delete_bucket(bucket)
                return
        self._mirror_content(ev, path)

    # -- bucket lifecycle ----------------------------------------------
    def _create_bucket(self, name: str) -> None:
        if not self._name_allowed(name):
            return
        mount_dir = f"{self.buckets_dir}/{name}"
        self._reload_conf()
        if mount_dir in self.conf.mounts:
            return  # replayed event / already mapped
        if not self.create_bucket_at:
            return  # no primary storage configured: local-only bucket
        storage = self.conf.storages.get(self.create_bucket_at)
        if storage is None:
            raise ValueError(
                f"un-configured remote storage {self.create_bucket_at}")
        remote_bucket = name
        if self.bucket_suffix:
            remote_bucket = f"{name}-{uuid.uuid4().hex[:8]}"
        client = make_client(storage)
        client.write_directory(remote_bucket)
        self.conf.mounts[mount_dir] = RemoteMount(
            dir=mount_dir, storage=self.create_bucket_at,
            remote_path=remote_bucket)
        save_conf(self.filer, self.conf)
        self._conf_time = time.monotonic()
        self.buckets_created += 1

    def _delete_bucket(self, name: str) -> None:
        mount_dir = f"{self.buckets_dir}/{name}"
        self._reload_conf()
        mount = self.conf.mounts.get(mount_dir)
        if mount is None:
            return
        storage = self.conf.storages.get(mount.storage)
        if storage is not None:
            make_client(storage).remove_directory(mount.remote_path)
        del self.conf.mounts[mount_dir]
        self._workers.pop(mount_dir, None)
        save_conf(self.filer, self.conf)
        self._conf_time = time.monotonic()
        self.buckets_deleted += 1

    # -- content mirroring ----------------------------------------------
    def _reload_conf(self, max_age: float = 0.0) -> None:
        if time.monotonic() - self._conf_time >= max_age:
            self.conf = load_conf(self.filer)
            self._conf_time = time.monotonic()

    def _worker_for(self, path: str) -> RemoteSyncWorker | None:
        for d in list(self.conf.mounts):
            if path == d or path.startswith(d.rstrip("/") + "/"):
                w = self._workers.get(d)
                if w is None:
                    try:
                        w = RemoteSyncWorker(self.filer, d)
                    except ValueError:
                        return None
                    self._workers[d] = w
                return w
        return None

    def _mirror_content(self, ev: dict, path: str) -> None:
        if not path:
            return
        w = self._worker_for(path)
        if w is None:
            # mappings may have changed under us (e.g. shell
            # remote.mount from elsewhere): refresh once and retry
            self._reload_conf(max_age=2.0)
            w = self._worker_for(path)
            if w is None:
                return
        w.apply(ev)


def run_remote_gateway(filer_url: str, **kw) -> RemoteGateway:
    g = RemoteGateway(filer_url, **kw)
    g.start()
    return g
