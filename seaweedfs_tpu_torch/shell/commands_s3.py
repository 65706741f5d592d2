"""s3.* shell commands; the counterpart of
seaweedfs_tpu/shell/commands_s3.py.

Equivalents of SeaweedFS weed/shell/command_s3_configure.go,
command_s3_bucket_list.go, command_s3_bucket_create.go,
command_s3_bucket_delete.go, command_s3_circuitbreaker.go: manage the
S3 gateway's identities, buckets, and circuit-breaker limits. All of it
is filer state (/buckets/* entries + the s3/identities and
s3/circuit_breaker KV keys the gateways hot-reload), so these commands
talk to the filer, not to a gateway instance.
"""
from __future__ import annotations

import json

from ..rpc.httpclient import session
from .commands_fs import _filer, _is_dir, _list, _name
from .env import CommandEnv, ShellError

IDENTITIES_KEY = "s3/identities"
CIRCUIT_BREAKER_KEY = "s3/circuit_breaker"
BUCKETS_DIR = "/buckets"


def _kv_get(env: CommandEnv, key: str) -> dict:
    r = session().get(f"{_filer(env)}/kv/{key}", timeout=30)
    if r.status_code == 404:
        return {}
    if r.status_code >= 300:
        raise ShellError(f"read {key}: {r.text}")
    return json.loads(r.content)


def _kv_put(env: CommandEnv, key: str, value: dict) -> None:
    r = session().put(f"{_filer(env)}/kv/{key}",
                     data=json.dumps(value, indent=1).encode(),
                     timeout=30)
    if r.status_code >= 300:
        raise ShellError(f"write {key}: {r.text}")


def s3_configure(env: CommandEnv, user: str = "",
                 access_key: str = "", secret_key: str = "",
                 actions: str = "", delete: bool = False,
                 apply: bool = False) -> dict:
    """Show/edit S3 identities (command_s3_configure.go). Without
    -user just prints the config; edits are dry-run unless -apply."""
    conf = _kv_get(env, IDENTITIES_KEY)
    conf.setdefault("identities", [])
    if user:
        existing = next((i for i in conf["identities"]
                         if i.get("name") == user), None)
        conf["identities"] = [i for i in conf["identities"]
                              if i.get("name") != user]
        if not delete:
            # MERGE into the existing identity: an edit that only
            # broadens -actions must not wipe credentials the admin
            # didn't re-type (command_s3_configure.go:119-152)
            ident = existing or {"name": user, "credentials": [],
                                 "actions": ["Read", "Write", "List"]}
            if actions:
                ident["actions"] = [a.strip()
                                    for a in actions.split(",")
                                    if a.strip()]
            # note: an EXISTING identity with actions=[] stays deny-all
            # — key-only edits must not escalate privileges
            if access_key:
                ident["credentials"] = [
                    c for c in ident.get("credentials", [])
                    if c.get("accessKey") != access_key]
                ident["credentials"].append(
                    {"accessKey": access_key,
                     "secretKey": secret_key})
            conf["identities"].append(ident)
        if apply:
            _kv_put(env, IDENTITIES_KEY, conf)
    out = dict(conf)
    out["applied"] = apply or not user
    return out


def s3_bucket_list(env: CommandEnv) -> list[dict]:
    _filer(env)  # a missing -filer must error, not read as "no buckets"
    try:
        entries = _list(env, BUCKETS_DIR)  # paginates past 1024
    except ShellError as e:
        if "not found" in str(e):
            return []  # no /buckets dir yet: no buckets
        raise
    return [{"name": _name(e), "ctime": e.get("mtime", 0)}
            for e in entries if _is_dir(e)]


def s3_bucket_create(env: CommandEnv, name: str) -> dict:
    if not name:
        raise ShellError("s3.bucket.create needs -name")
    r = session().post(f"{_filer(env)}{BUCKETS_DIR}/{name}/",
                      params={"mkdir": "1"}, timeout=30)
    if r.status_code >= 300:
        raise ShellError(f"s3.bucket.create: {r.text}")
    return {"created": name}


def s3_bucket_delete(env: CommandEnv, name: str,
                     include_objects: bool = False) -> dict:
    if not name:
        raise ShellError("s3.bucket.delete needs -name")
    params = {"recursive": "true"} if include_objects else {}
    r = session().delete(f"{_filer(env)}{BUCKETS_DIR}/{name}",
                        params=params, timeout=60)
    if r.status_code == 409:
        raise ShellError(f"bucket {name} is not empty "
                         "(use -includeObjects)")
    if r.status_code >= 300 and r.status_code != 404:
        raise ShellError(f"s3.bucket.delete: {r.text}")
    return {"deleted": name}


def _bucket_usage_bytes(env: CommandEnv, name: str) -> int:
    from .commands_fs import _size, _walk

    total = 0
    for e in _walk(env, f"{BUCKETS_DIR}/{name}"):
        if not _is_dir(e):
            total += _size(e)
    return total


def s3_bucket_quota(env: CommandEnv, name: str,
                    quota_mb: int = -1) -> dict:
    """Show or set a bucket's size quota
    (command_s3_bucketquota.go): stored on the bucket entry; enforced
    by s3.bucket.quota.enforce. -quotaMB=0 removes the quota."""
    if not name:
        raise ShellError("s3.bucket.quota needs -name")
    from .commands_fs import _stat

    path = f"{BUCKETS_DIR}/{name}"
    meta = _stat(env, path)
    ext = dict(meta.get("extended", {}))
    if quota_mb < 0:
        return {"bucket": name,
                "quota_bytes": int(ext.get("s3_quota_bytes", 0)),
                "used_bytes": _bucket_usage_bytes(env, name)}
    env.confirm_locked()
    if quota_mb == 0:
        ext.pop("s3_quota_bytes", None)
    else:
        ext["s3_quota_bytes"] = str(quota_mb << 20)
    meta["extended"] = ext
    meta.pop("full_path", None)
    r = session().put(f"{_filer(env)}{path}?meta=1", json=meta,
                     timeout=30)
    if r.status_code >= 300:
        raise ShellError(f"s3.bucket.quota: {r.text}")
    return {"bucket": name,
            "quota_bytes": int(ext.get("s3_quota_bytes", 0))}


def s3_bucket_quota_enforce(env: CommandEnv) -> list[dict]:
    """Walk the buckets; mark a bucket's collection volumes read-only
    when over quota and writable again when back under — including
    buckets whose quota was since removed, tracked by an
    `s3_quota_enforced` latch on the bucket entry so clearing a quota
    releases the volumes instead of leaving them read-only forever
    (command_s3_bucketquota.go enforcement pass, run from the master
    maintenance cron in the reference)."""
    env.confirm_locked()
    from .commands_fs import _stat

    out = []
    for b in s3_bucket_list(env):
        name = b["name"]
        path = f"{BUCKETS_DIR}/{name}"
        meta = _stat(env, path)
        ext = dict(meta.get("extended", {}))
        quota = int(ext.get("s3_quota_bytes", 0) or 0)
        latched = ext.get("s3_quota_enforced") == "true"
        if quota <= 0 and not latched:
            continue
        used = _bucket_usage_bytes(env, name) if quota > 0 else 0
        over = quota > 0 and used > quota
        # bucket objects are written into collection=<bucket>.
        # Read-only marking is idempotent and re-runs WHILE over —
        # volumes auto-grown after the latch must be caught too; the
        # writable direction fires only on the latch TRANSITION so
        # volumes made read-only for other reasons (tiering, operator
        # volume.mark) are never blanket-flipped back
        touched = []
        if over or over != latched:
            for n in env.data_nodes():
                for vid in n["volumes"]:
                    if n.get("collections", {}).get(str(vid)) != name:
                        continue
                    vs_path = "/admin/mark_readonly" if over \
                        else "/admin/mark_writable"
                    env.vs_post(n["url"], vs_path, {"volume": vid})
                    touched.append(vid)
        if over != latched:
            if over:
                ext["s3_quota_enforced"] = "true"
            else:
                ext.pop("s3_quota_enforced", None)
            meta["extended"] = ext
            meta.pop("full_path", None)
            r = session().put(f"{_filer(env)}{path}?meta=1", json=meta,
                             timeout=30)
            if r.status_code >= 300:
                # a lost latch write would leave the volumes read-only
                # with nothing left to release them
                raise ShellError(
                    f"quota latch update for {name}: {r.text}")
        out.append({"bucket": name, "used": used, "quota": quota,
                    "over": over, "volumes": sorted(set(touched))})
    return out


def s3_clean_uploads(env: CommandEnv,
                     time_ago_seconds: int = 86400) -> list[str]:
    """Abort multipart uploads older than -timeAgo
    (command_s3_clean_uploads.go): removes stale .uploads/<id> dirs."""
    env.confirm_locked()
    import time as _time

    from .commands_fs import _list as _ls

    cutoff = _time.time() - time_ago_seconds
    removed = []
    for b in s3_bucket_list(env):
        updir = f"{BUCKETS_DIR}/{b['name']}/.uploads"
        try:
            uploads = _ls(env, updir)
        except ShellError:
            continue
        for u in uploads:
            if u.get("mtime", 0) < cutoff:
                full = u["full_path"]
                session().delete(f"{_filer(env)}{full}",
                                params={"recursive": "true"},
                                timeout=60)
                removed.append(full)
    return removed


def s3_circuit_breaker(env: CommandEnv, global_conf: str = "",
                       bucket: str = "", bucket_conf: str = "",
                       delete: bool = False,
                       apply: bool = False) -> dict:
    """Show/edit circuit-breaker limits (command_s3_circuitbreaker.go).
    -global/-bucketConf take JSON like '{"writeCount": 32}'."""
    conf = _kv_get(env, CIRCUIT_BREAKER_KEY)
    changed = False
    if delete and bucket:
        conf.get("buckets", {}).pop(bucket, None)
        changed = True
    elif delete:
        conf.pop("global", None)
        changed = True
    if global_conf:
        conf["global"] = json.loads(global_conf)
        changed = True
    if bucket and bucket_conf:
        conf.setdefault("buckets", {})[bucket] = json.loads(bucket_conf)
        changed = True
    if changed and apply:
        _kv_put(env, CIRCUIT_BREAKER_KEY, conf)
    out = dict(conf)
    out["applied"] = apply or not changed
    return out
