"""Remote-mount bookkeeping: which filer dirs map to which storages;
the counterpart of seaweedfs_tpu/remote_storage/mount.py, copied as is
(its JSON is the KV value both packages' filers and shells read).

Equivalent of the reference's remote configuration + mapping persisted
in the filer itself (SeaweedFS weed/filer/remote_storage.go —
/etc/remote.conf holding pb.RemoteConf and pb.RemoteStorageMapping,
read by shell remote.* commands and filer_remote_sync). Here the
document is JSON in the filer KV store under the same logical name, so
every filer (and the shell) sees one consistent copy.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..rpc.httpclient import session

CONF_KEY = "etc/remote.conf"


@dataclass
class RemoteMount:
    dir: str            # filer directory, e.g. /buckets/photos
    storage: str        # configured storage name
    remote_path: str    # key prefix within the storage ("" = root)


@dataclass
class RemoteConf:
    storages: dict[str, dict] = field(default_factory=dict)
    mounts: dict[str, RemoteMount] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({
            "storages": self.storages,
            "mounts": {d: {"storage": m.storage,
                           "remote_path": m.remote_path}
                       for d, m in self.mounts.items()}})

    @classmethod
    def from_json(cls, raw: str | bytes) -> "RemoteConf":
        d = json.loads(raw or "{}")
        return cls(
            storages=d.get("storages", {}),
            mounts={p: RemoteMount(dir=p, storage=m["storage"],
                                   remote_path=m.get("remote_path", ""))
                    for p, m in d.get("mounts", {}).items()})


def load_conf(filer_url: str) -> RemoteConf:
    r = session().get(f"{filer_url.rstrip('/')}/kv/{CONF_KEY}", timeout=30)
    if r.status_code == 404:
        return RemoteConf()
    r.raise_for_status()
    return RemoteConf.from_json(r.content)


def save_conf(filer_url: str, conf: RemoteConf) -> None:
    r = session().put(f"{filer_url.rstrip('/')}/kv/{CONF_KEY}",
                     data=conf.to_json().encode(), timeout=30)
    r.raise_for_status()


def find_mount(conf: RemoteConf, path: str) -> RemoteMount | None:
    """Longest-prefix mount lookup for a filer path."""
    best = None
    for d, m in conf.mounts.items():
        if path == d or path.startswith(d.rstrip("/") + "/"):
            if best is None or len(d) > len(best.dir):
                best = m
    return best


def remote_key_for(mount: RemoteMount, path: str) -> str:
    """filer path under the mount -> object key in the storage."""
    rel = path[len(mount.dir):].lstrip("/")
    prefix = mount.remote_path.strip("/")
    return f"{prefix}/{rel}" if prefix else rel
