"""Filesystem shell commands against the filer; the counterpart of
seaweedfs_tpu/shell/commands_fs.py.

Equivalents of the reference's fs.* shell family
(SeaweedFS weed/shell/command_fs_ls.go, command_fs_cat.go,
command_fs_du.go, command_fs_mv.go, command_fs_rm.go, command_fs_mkdir.go,
command_fs_tree.go, command_fs_meta_save.go, command_fs_meta_load.go,
command_fs_verify.go). All operate over the filer HTTP API; none require
the admin lock (they are namespace reads/writes, not cluster topology
mutations). `fs.meta.save` writes one JSON entry per line, the bytes
the JAX package writes, so either package's `fs.meta.load` reads the
other's file. `fs.meta.notify` sends one create event per walked entry
to the queue that the filer KV's `notification.conf` configures
(notification/queues.py).
"""
from __future__ import annotations

import json
import urllib.parse
from typing import Iterator

from ..filer.entry import entry_size
from ..rpc.httpclient import RequestException, session
from .env import CommandEnv, ShellError


DIR_MODE_FLAG = 0o40000


def _filer(env: CommandEnv) -> str:
    if not env.filer_url:
        raise ShellError("this command needs a filer: start the "
                         "shell with -filer")
    return env.filer_url


def _is_dir(e: dict) -> bool:
    return bool(e.get("mode", 0) & DIR_MODE_FLAG)


def _name(e: dict) -> str:
    return e["full_path"].rstrip("/").rsplit("/", 1)[-1]


def _size(e: dict) -> int:
    return entry_size(e)


def _list(env: CommandEnv, path: str,
          name_pattern: str = "") -> list[dict]:
    out: list[dict] = []
    last = ""
    while True:
        params = {"limit": "1024", "lastFileName": last}
        if name_pattern:
            params["namePattern"] = name_pattern
        resp = session().get(f"{_filer(env)}{path}",
                            params=params,
                            headers={"Accept": "application/json"},
                            timeout=60)
        if resp.status_code == 404:
            raise ShellError(f"not found: {path}")
        body = resp.json()
        entries = body.get("entries", [])
        out.extend(entries)
        if not body.get("shouldDisplayLoadMore"):
            return out
        last = body.get("lastFileName", "")
        if not last:
            return out


def _exists(env: CommandEnv, path: str) -> bool:
    # percent-encode: glob chars like ? must stay PATH bytes here, not
    # start a query string
    quoted = urllib.parse.quote(path, safe="/")
    resp = session().get(f"{_filer(env)}{quoted}", params={"meta": "1"},
                        timeout=60)
    return resp.status_code == 200


def _stat(env: CommandEnv, path: str) -> dict:
    resp = session().get(f"{_filer(env)}{path}", params={"meta": "1"},
                        timeout=60)
    if resp.status_code == 404:
        raise ShellError(f"not found: {path}")
    return resp.json()


def _walk(env: CommandEnv, path: str) -> Iterator[dict]:
    """Depth-first entry walk rooted at `path` (directories included,
    root excluded)."""
    for e in _list(env, path):
        yield e
        if _is_dir(e):
            yield from _walk(env, e["full_path"])


def fs_ls(env: CommandEnv, path: str = "/", long: bool = False) -> list:
    """fs.ls [-l] <dir>[/glob] (command_fs_ls.go) — a wildcard in the
    LAST path segment becomes a server-side namePattern filter
    (filer_search.go), so `fs.ls /logs/*.gz` pages only matches."""
    pattern = ""
    head, _, tail = path.rstrip("/").rpartition("/")
    if any(ch in tail for ch in "*?[") and not _exists(env, path):
        # glob chars in the tail — but a literal directory of that
        # exact name (checked first) still wins over the glob reading
        path, pattern = head or "/", tail
    entries = _list(env, path, name_pattern=pattern)
    if not long:
        return [_name(e) + ("/" if _is_dir(e) else "") for e in entries]
    return [{"name": _name(e), "is_directory": _is_dir(e),
             "size": _size(e), "mtime": e.get("mtime", 0),
             "chunks": len(e.get("chunks", []))} for e in entries]


def fs_cat(env: CommandEnv, path: str) -> bytes:
    resp = session().get(f"{_filer(env)}{path}", timeout=300)
    if resp.status_code >= 300:
        raise ShellError(f"cat {path}: {resp.status_code}")
    return resp.content


def fs_mkdir(env: CommandEnv, path: str) -> dict:
    resp = session().post(f"{_filer(env)}{path}", params={"mkdir": "1"},
                         timeout=60)
    if resp.status_code >= 300:
        raise ShellError(f"mkdir {path}: {resp.status_code}")
    return resp.json()


def fs_rm(env: CommandEnv, path: str, recursive: bool = False) -> None:
    resp = session().delete(
        f"{_filer(env)}{path}",
        params={"recursive": "true"} if recursive else {}, timeout=300)
    if resp.status_code >= 300:
        raise ShellError(f"rm {path}: {resp.status_code}")


def fs_mv(env: CommandEnv, src: str, dst: str) -> None:
    resp = session().put(f"{_filer(env)}{dst}", params={"mv.from": src},
                        timeout=300)
    if resp.status_code >= 300:
        raise ShellError(f"mv {src} {dst}: {resp.text}")


def fs_du(env: CommandEnv, path: str = "/") -> dict:
    """Recursive usage: bytes / file count / dir count
    (command_fs_du.go)."""
    total, files, dirs = 0, 0, 0
    for e in _walk(env, path):
        if _is_dir(e):
            dirs += 1
        else:
            files += 1
            total += _size(e)
    return {"path": path, "bytes": total, "files": files, "dirs": dirs}


def fs_tree(env: CommandEnv, path: str = "/") -> list[str]:
    """Indented recursive listing (command_fs_tree.go)."""
    root_depth = path.rstrip("/").count("/")
    lines = []
    for e in _walk(env, path):
        depth = e["full_path"].count("/") - root_depth - 1
        mark = "/" if _is_dir(e) else ""
        lines.append("  " * depth + _name(e) + mark)
    return lines


def fs_cd(env: CommandEnv, path: str = "/") -> str:
    """Change the shell's working directory (command_fs_cd.go); fs.*
    commands resolve relative paths against it."""
    target = env.resolve(path)
    if target != "/" and not _is_dir(_stat(env, target)):
        raise ShellError(f"not a directory: {target}")
    env.cwd = target
    return env.cwd


def fs_pwd(env: CommandEnv) -> str:
    """Print the shell's working directory (command_fs_pwd.go)."""
    return env.cwd


def fs_meta_cat(env: CommandEnv, path: str) -> dict:
    """Full stored metadata of one entry, chunks included
    (command_fs_meta_cat.go)."""
    return _stat(env, path)


def fs_meta_change_volume_id(env: CommandEnv, path: str,
                             mapping: str,
                             apply: bool = False) -> dict:
    """Rewrite chunk fids after volumes changed ids
    (command_fs_meta_change_volume_id.go): -mapping=old1:new1,old2:new2
    walks the subtree and rewrites every chunk whose volume id matches.
    Dry-run unless -apply (the reference's -force)."""
    if apply:
        env.confirm_locked()
    vid_map: dict[int, int] = {}
    for pair in mapping.split(","):
        old, _, new = pair.partition(":")
        if not (old.strip().isdigit() and new.strip().isdigit()):
            raise ShellError(f"bad mapping {pair!r} "
                             "(want old:new[,old:new...])")
        vid_map[int(old)] = int(new)
    entries = 0
    for e in _walk(env, path):
        if _is_dir(e):
            continue
        touched = False
        for c in e.get("chunks", []):
            fid = c.get("fid", "")
            vid_s, _, rest = fid.partition(",")
            if vid_s.isdigit() and int(vid_s) in vid_map:
                c["fid"] = f"{vid_map[int(vid_s)]},{rest}"
                touched = True
        if touched:
            entries += 1
            if apply:
                full = e["full_path"]
                e.pop("full_path", None)
                resp = session().put(f"{_filer(env)}{full}?meta=1",
                                    json=e, timeout=60)
                if resp.status_code >= 300:
                    raise ShellError(f"update {full}: {resp.text}")
    return {"entries_rewritten": entries, "applied": apply,
            "mapping": {str(k): v for k, v in vid_map.items()}}


def fs_meta_notify(env: CommandEnv, path: str = "/") -> dict:
    """Re-publish create events for every entry under `path` to the
    configured notification queue (command_fs_meta_notify.go) — used to
    prime a fresh downstream consumer."""
    from ..notification.queues import queue_from_config

    conf = session().get(f"{_filer(env)}/kv/notification.conf",
                         timeout=30)
    if conf.status_code != 200:
        raise ShellError("no notification.conf configured in the filer "
                         "KV store")
    q = queue_from_config(json.loads(conf.content))
    sent = 0
    try:
        for e in _walk(env, path):
            q.send(e["full_path"], {"event": "create", "entry": e})
            sent += 1
    finally:
        q.close()
    return {"notified": sent}


def mount_configure(env: CommandEnv, dir: str = "",
                    quota_mb: int = -1) -> dict:
    """Per-mount quota config stored in the filer KV space
    (command_mount_configure.go): FUSE mounts read it at start and on
    metadata events. -quotaMB=0 clears the quota."""
    key = "mount.conf"
    resp = session().get(f"{_filer(env)}/kv/{key}", timeout=30)
    if resp.status_code == 200:
        conf = json.loads(resp.content)
    elif resp.status_code == 404:
        conf = {}
    else:
        # a transient filer error must not read as "empty config" and
        # then wipe every other mount's quota on the write-back
        raise ShellError(f"read {key}: http {resp.status_code}")
    if not dir:
        return conf
    env.confirm_locked()
    dir = "/" + dir.strip("/")
    if quota_mb < 0:
        raise ShellError("mount.configure needs -quotaMB=<n> (0 clears)")
    if quota_mb == 0:
        conf.pop(dir, None)
    else:
        conf[dir] = {"quota_bytes": quota_mb << 20}
    r = session().put(f"{_filer(env)}/kv/{key}",
                     data=json.dumps(conf).encode(), timeout=30)
    if r.status_code >= 300:
        raise ShellError(f"mount.configure: {r.text}")
    return conf


def fs_meta_save(env: CommandEnv, path: str, out_file: str) -> int:
    """Snapshot the subtree's metadata to a JSONL file
    (command_fs_meta_save.go). Returns entry count."""
    n = 0
    with open(out_file, "w") as f:
        for e in _walk(env, path):
            f.write(json.dumps(e) + "\n")
            n += 1
    return n


def fs_meta_load(env: CommandEnv, in_file: str) -> int:
    """Recreate entries from a fs.meta.save snapshot
    (command_fs_meta_load.go). Chunks must still exist on the volume
    servers (metadata-only restore). Returns entry count."""
    n = 0
    with open(in_file) as f:
        for line in f:
            e = json.loads(line)
            path = e["full_path"]
            if _is_dir(e):
                fs_mkdir(env, path)
            else:
                resp = session().put(
                    f"{_filer(env)}{path}",
                    params={"meta": "1", "skipChunkDeletion": "true"},
                    data=json.dumps(e), timeout=60)
                if resp.status_code >= 300:
                    raise ShellError(f"meta.load {path}: {resp.text}")
            n += 1
    return n


def fs_verify(env: CommandEnv, path: str = "/") -> list[dict]:
    """Check every file's chunks are readable on their volume servers
    (command_fs_verify.go). Returns the list of broken files."""
    broken = []
    for e in _walk(env, path):
        if _is_dir(e):
            continue
        for c in e.get("chunks", []):
            fid = c["fid"]
            vid = fid.split(",")[0]
            ok = False
            for url in env.volume_locations(int(vid)):
                try:
                    r = session().head(f"http://{url}/{fid}", timeout=30)
                    if r.status_code == 200:
                        ok = True
                        break
                except RequestException:
                    continue
            if not ok:
                broken.append({"path": e["full_path"], "fid": fid})
                break
    return broken


def fs_configure(env: CommandEnv, location_prefix: str = "",
                 delete: bool = False, apply: bool = False,
                 **fields) -> dict:
    """Show or edit the per-path storage rules in `filer.conf`
    (command_fs_configure.go). With no -locationPrefix just prints the
    current rules; with one, stages a rule change and only persists it
    when -apply is given (the reference's dry-run-by-default semantics).
    """
    from ..filer.filer_conf import CONF_KEY, FilerConf, PathConf

    resp = session().get(f"{_filer(env)}/kv/{CONF_KEY}", timeout=60)
    conf = FilerConf.from_json(resp.content) \
        if resp.status_code == 200 else FilerConf()
    if not location_prefix:
        return json.loads(conf.to_json())
    if delete:
        if not conf.delete_rule(location_prefix):
            raise ShellError(f"no rule for {location_prefix}")
    else:
        rule = PathConf(location_prefix=location_prefix,
                        collection=fields.get("collection", ""),
                        replication=fields.get("replication", ""),
                        ttl=fields.get("ttl", ""),
                        disk_type=fields.get("diskType", ""),
                        fsync=fields.get("fsync", "") == "true",
                        read_only=fields.get("readOnly", "") == "true",
                        max_file_name_length=int(
                            fields.get("maxFileNameLength", "0")))
        conf.set_rule(rule)
    if apply:
        r = session().put(f"{_filer(env)}/kv/{CONF_KEY}",
                         data=conf.to_json().encode(), timeout=60)
        if r.status_code >= 300:
            raise ShellError(f"fs.configure: {r.text}")
    out = json.loads(conf.to_json())
    out["applied"] = apply
    return out
