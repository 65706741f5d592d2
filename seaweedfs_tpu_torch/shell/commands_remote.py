"""Shell remote.* commands: cloud-mount configuration and data motion;
the counterpart of seaweedfs_tpu/shell/commands_remote.py.

Equivalent of SeaweedFS weed/shell/command_remote_configure.go,
command_remote_mount.go, command_remote_unmount.go,
command_remote_meta_sync.go, command_remote_cache.go and
command_remote_uncache.go — operating on the remote-storage
configuration stored in the filer (remote_storage/mount.py) and the
filer server's cacheRemote/uncacheRemote verbs.
"""
from __future__ import annotations

import json

from ..remote_storage import (RemoteMount, find_mount, load_conf,
                              make_client, remote_key_for, save_conf)
from ..rpc.httpclient import session
from .commands_fs import _filer, _walk
from .env import CommandEnv, ShellError


def remote_configure(env: CommandEnv, name: str = "",
                     delete: bool = False, **conf) -> dict:
    """No args: show configured storages (secrets redacted). With
    -name/-type...: create or update one; -delete removes it."""
    rc = load_conf(_filer(env))
    if not name:
        return {n: {k: ("***" if "secret" in k else v)
                    for k, v in s.items()}
                for n, s in rc.storages.items()}
    env.confirm_locked()
    if delete:
        used_by = [d for d, m in rc.mounts.items() if m.storage == name]
        if used_by:
            raise ShellError(
                f"storage {name!r} is mounted at {used_by}; unmount first")
        if rc.storages.pop(name, None) is None:
            raise ShellError(f"no storage named {name!r}")
        save_conf(_filer(env), rc)
        return {"deleted": name}
    if not conf.get("type"):
        raise ShellError("remote.configure needs -type=(s3|local)")
    make_client(conf)  # validate before persisting
    rc.storages[name] = conf
    save_conf(_filer(env), rc)
    return {name: conf.get("type")}


def remote_mount(env: CommandEnv, dir: str = "",
                 remote: str = "") -> dict:
    """remote.mount -dir=/path -remote=storage[/key/prefix]; no args
    lists current mounts (command_remote_mount.go listExistingRemote
    StorageMounts)."""
    rc = load_conf(_filer(env))
    if not dir:
        return {d: f"{m.storage}/{m.remote_path}".rstrip("/")
                for d, m in rc.mounts.items()}
    env.confirm_locked()
    if not remote:
        raise ShellError("remote.mount needs -remote=storage[/prefix]")
    storage, _, prefix = remote.partition("/")
    if storage not in rc.storages:
        raise ShellError(f"storage {storage!r} not configured "
                         f"(known: {sorted(rc.storages)})")
    dir = "/" + dir.strip("/")
    rc.mounts[dir] = RemoteMount(dir=dir, storage=storage,
                                 remote_path=prefix)
    save_conf(_filer(env), rc)
    # make sure the mount dir exists, then pull metadata
    session().post(f"{_filer(env)}{dir}", params={"mkdir": "1"},
                  timeout=30)
    synced = remote_meta_sync(env, dir)
    return {"mounted": dir, **synced}


def remote_mount_buckets(env: CommandEnv, remote: str,
                         bucket_pattern: str = "") -> dict:
    """Mount every top-level bucket/dir of a remote storage under
    /buckets (command_remote_mount_buckets.go). -remote=storagename,
    optional -bucketPattern=glob filter."""
    import fnmatch

    env.confirm_locked()
    rc = load_conf(_filer(env))
    storage, _, _ = remote.partition("/")
    if storage not in rc.storages:
        raise ShellError(f"storage {storage!r} not configured "
                         f"(known: {sorted(rc.storages)})")
    client = make_client(rc.storages[storage])
    mounted = []
    for name in client.list_buckets():
        if bucket_pattern and not fnmatch.fnmatch(name, bucket_pattern):
            continue
        remote_mount(env, dir=f"/buckets/{name}",
                     remote=f"{storage}/{name}")
        mounted.append(name)
    return {"mounted": mounted}


def remote_unmount(env: CommandEnv, dir: str) -> dict:
    """Detach a dir from its storage. Local entries stay; uncached
    remote placeholders under it become dead metadata, so the reference
    requires the dir be cleaned up by the operator — mirrored here."""
    env.confirm_locked()
    rc = load_conf(_filer(env))
    dir = "/" + dir.strip("/")
    if rc.mounts.pop(dir, None) is None:
        raise ShellError(f"{dir} is not mounted")
    save_conf(_filer(env), rc)
    return {"unmounted": dir}


def _mount_for(env: CommandEnv, dir: str):
    rc = load_conf(_filer(env))
    dir = "/" + dir.strip("/")
    mount = find_mount(rc, dir)
    if mount is None:
        raise ShellError(f"{dir} is not under a remote mount")
    storage_conf = rc.storages.get(mount.storage)
    if storage_conf is None:
        raise ShellError(f"storage {mount.storage!r} vanished from conf")
    return dir, mount, make_client(storage_conf)


def remote_meta_sync(env: CommandEnv, dir: str) -> dict:
    """Pull the remote listing into filer metadata-only entries
    (command_remote_meta_sync.go): new/changed objects become (or
    refresh) uncached placeholders; local placeholders whose object
    vanished are removed. Cached or locally-written files keep their
    chunks unless the remote object changed."""
    env.confirm_locked()
    dir, mount, client = _mount_for(env, dir)
    prefix = remote_key_for(mount, dir)
    # '/'-terminated so sibling keys sharing the prefix string (e.g.
    # "photos2/x" for mount prefix "photos") are not swept in
    list_prefix = prefix.rstrip("/") + "/" if prefix else ""
    created = updated = removed = 0
    seen: set[str] = set()
    # one tree walk up front (a directory listing per dir) instead of a
    # meta-GET round trip per remote object — a 100k-object bucket
    # would otherwise issue 100k serial requests
    local: dict[str, dict] = {e["full_path"]: e
                              for e in _walk(env, dir)}
    for re_ in client.traverse(list_prefix):
        if list_prefix and not re_.key.startswith(list_prefix):
            continue
        rel = re_.key[len(list_prefix):]
        if not rel or rel.endswith("/"):
            continue  # bucket directory-marker objects aren't files
        path = f"{dir}/{rel}"
        seen.add(path)
        meta = {"key": re_.key, "size": re_.size, "mtime": re_.mtime,
                "etag": re_.etag}
        ent = local.get(path)
        if ent is None:
            entry = {"full_path": path, "mtime": re_.mtime or None,
                     "extended": {"remote": json.dumps(meta)}}
            session().post(f"{_filer(env)}{path}",
                          params={"meta": "1"},
                          data=json.dumps(entry), timeout=60
                          ).raise_for_status()
            created += 1
            continue
        old = json.loads(ent.get("extended", {}).get("remote", "{}"))
        if old.get("etag") == re_.etag and old.get("size") == re_.size \
                and old.get("etag"):
            continue  # unchanged
        ent.setdefault("extended", {})["remote"] = json.dumps(meta)
        ent["chunks"] = []  # changed upstream: drop the stale copy
        session().post(f"{_filer(env)}{path}", params={"meta": "1"},
                      data=json.dumps(ent), timeout=60).raise_for_status()
        updated += 1
    # prune placeholders whose remote object is gone (uncached only —
    # never delete local bytes on a listing hiccup); the snapshot from
    # before the sync is exact for this: entries created above are in
    # `seen`, and anything else that appeared mid-sync is left alone
    # for the next run
    for path, e in local.items():
        if path in seen or e.get("chunks") or \
                not e.get("extended", {}).get("remote"):
            continue
        # the snapshot is minutes old for big buckets: re-check the
        # LIVE entry so a placeholder that gained chunks (remote.cache
        # or a local write) mid-sync is never deleted with its bytes
        live = session().get(f"{_filer(env)}{path}",
                            params={"meta": "1"}, timeout=30)
        if live.status_code != 200:
            continue
        le = live.json()
        if le.get("chunks") or \
                not le.get("extended", {}).get("remote"):
            continue
        session().delete(f"{_filer(env)}{path}", timeout=30)
        removed += 1
    return {"created": created, "updated": updated, "removed": removed}


def remote_cache(env: CommandEnv, dir: str) -> dict:
    """Materialise every uncached remote file under `dir` into cluster
    chunks (command_remote_cache.go)."""
    env.confirm_locked()
    dir, _, _ = _mount_for(env, dir)
    cached = 0
    for e in _walk(env, dir):
        if e.get("chunks") or not e.get("extended", {}).get("remote"):
            continue
        r = session().post(f"{_filer(env)}{e['full_path']}",
                          params={"cacheRemote": "1"}, timeout=3600)
        if r.status_code != 200:
            raise ShellError(f"cache {e['full_path']}: {r.text}")
        cached += 1
    return {"cached": cached}


def remote_uncache(env: CommandEnv, dir: str) -> dict:
    """Drop local chunk copies of cached remote files under `dir`
    (command_remote_uncache.go)."""
    env.confirm_locked()
    dir, _, _ = _mount_for(env, dir)
    uncached = 0
    for e in _walk(env, dir):
        if not e.get("chunks") or \
                not e.get("extended", {}).get("remote"):
            continue
        r = session().post(f"{_filer(env)}{e['full_path']}",
                          params={"uncacheRemote": "1"}, timeout=600)
        if r.status_code != 200:
            raise ShellError(f"uncache {e['full_path']}: {r.text}")
        uncached += 1
    return {"uncached": uncached}
