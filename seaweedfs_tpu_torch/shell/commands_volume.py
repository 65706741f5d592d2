"""Volume maintenance shell commands; the counterpart of
seaweedfs_tpu/shell/commands_volume.py.

Equivalents of SeaweedFS weed/shell/command_volume_fix_replication.go,
command_volume_balance.go, command_volume_vacuum.go (the vacuum pass
of topology_vacuum.go:20-216), command_volume_list.go and the rest of the
volume.* / collection.* family, with volume.scrub and its quarantine:
the self-healing plane's operator verbs. Not here: the remote tier
(volume.tier.upload / download / offload / recall, volume.tier.move).
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Iterator

from ..rpc.httpclient import RequestException, session
from ..storage.super_block import ReplicaPlacement
from .env import CommandEnv, ShellError


def volume_list(env: CommandEnv) -> list[dict]:
    out = []
    for n in env.data_nodes():
        for vid in n["volumes"]:
            out.append({"volume": vid, "server": n["url"],
                        "dc": n["dc"], "rack": n["rack"]})
        for vid_s, bits in n["ec_volumes"].items():
            out.append({"volume": int(vid_s), "server": n["url"],
                        "ec_shards": bin(bits).count("1")})
    return out


TTL_UNIT_SECONDS = {1: 60, 2: 3600, 3: 86400, 4: 604800,
                    5: 2592000, 6: 31536000}
TTL_GRACE_SECONDS = 60  # the reference waits a beat past expiry


def ttl_pair_seconds(ttl) -> int:
    count, unit = (list(ttl) + [0, 0])[:2]
    return int(count) * TTL_UNIT_SECONDS.get(int(unit), 0)


def volume_vacuum(env: CommandEnv,
                  garbage_threshold: float = 0.3) -> list[dict]:
    """Scan all volumes' garbage ratios; compact those above threshold,
    and destroy TTL volumes whose last write has expired
    (topology_vacuum.go:216 Vacuum + volume TTL expiry). Refuses to run
    while vacuum is disabled cluster-wide (volume.vacuum.disable)."""
    if env.master_get("/cluster/status").get("VacuumDisabled"):
        raise ShellError("vacuum is disabled cluster-wide "
                         "(volume.vacuum.enable to re-enable)")
    done = []
    now = time.time()
    nodes = env.data_nodes()  # one topology snapshot for both passes
    expired_vids: set[int] = set()
    for n in nodes:
        for vid_s, meta in n.get("volume_meta", {}).items():
            vid = int(vid_s)
            ttl_sec = ttl_pair_seconds(meta.get("ttl", (0, 0)))
            if not ttl_sec or vid in expired_vids:
                continue
            modified = meta.get("modified_at", 0)
            if modified and now > modified + ttl_sec + \
                    TTL_GRACE_SECONDS:
                expired_vids.add(vid)
    if expired_vids and not env.locked:
        # destroying volumes is a cluster mutation: only under the
        # admin lock (the admin scripts always hold it); plain unlocked
        # vacuums still compact
        done.append({"skipped_ttl_expiry": sorted(expired_vids),
                     "reason": "acquire the admin lock (`lock`) to "
                               "destroy expired TTL volumes"})
        expired_vids = set()
    for vid in sorted(expired_vids):
        deleted_on = []
        for url in env.volume_locations(vid):
            try:
                env.vs_post(url, "/admin/delete_volume", {"volume": vid})
                deleted_on.append(url)
            except ShellError:
                continue
        if deleted_on:  # only report what actually happened
            done.append({"volume": vid, "expired_ttl": True,
                         "deleted_on": deleted_on})
        else:
            done.append({"volume": vid, "expired_ttl": True,
                         "error": "no replica reachable; will retry "
                                  "next vacuum"})
    seen: set[int] = set(expired_vids)
    for n in nodes:
        for vid in n["volumes"]:
            if vid in seen:
                continue
            seen.add(vid)
            # check EVERY holder: replicas diverge when one missed a
            # previous pass, and a clean first holder must not hide a
            # garbage-heavy sibling
            compacted, worst = [], 0.0
            for url in env.volume_locations(vid):
                try:
                    check = env.vs_post(url, "/admin/vacuum_check",
                                        {"volume": vid})
                except ShellError:
                    continue
                ratio = check["garbage_ratio"]
                worst = max(worst, ratio)
                if ratio > garbage_threshold:
                    try:
                        env.vs_post(url, "/admin/vacuum_compact",
                                    {"volume": vid})
                        compacted.append(url)
                    except ShellError:
                        # one unreachable replica must not abort the
                        # cluster-wide pass; it catches up next run
                        continue
            if compacted:
                done.append({"volume": vid, "replicas": compacted,
                             "garbage_ratio": worst})
    return done


def volume_fix_replication(env: CommandEnv, volume_id: int = 0,
                           max_bps: float = 0) -> list[dict]:
    """Re-replicate under-replicated volumes: copy .dat/.idx from a
    healthy replica to a server that lacks the volume, chosen by
    master.placement.select_replica_targets (the same rack/DC spreading
    contract the master applies at write assignment). ``volume_id``
    restricts the pass to one volume (the repair queue's targeted
    repairs); ``max_bps`` shapes every copy against the nodes' repair
    token buckets. Forced spread breaks are reported per fix as
    ``placement_violations``."""
    from ..master import placement

    env.confirm_locked()
    nodes = env.data_nodes()
    by_vid: dict[int, list[dict]] = defaultdict(list)
    for n in nodes:
        for vid in n["volumes"]:
            by_vid[vid].append(n)
    fixes = []
    for vid, holders in by_vid.items():
        if volume_id and vid != volume_id:
            continue
        rp = _volume_replication(env, vid, holders)
        want = rp.copy_count
        if len(holders) >= want:
            continue
        targets, violations = placement.select_replica_targets(
            nodes, holders, rp, want - len(holders))
        src = holders[0]["url"]
        col = env.volume_collection(vid)
        for target in targets:
            out = env.vs_post(target["url"], "/admin/volume_copy",
                              {"volume": vid, "collection": col,
                               "source": src, "max_bps": max_bps})
            fixes.append({"volume": vid, "from": src,
                          "to": target["url"],
                          "bytes": out.get("bytes", 0),
                          "placement_violations": violations})
            violations = 0  # attribute the batch's count once
    return fixes


def _volume_replication(env: CommandEnv, vid: int,
                        holders: list[dict]) -> ReplicaPlacement:
    try:
        info = env.vs_post(holders[0]["url"],
                           "/admin/volume_replication", {"volume": vid})
        return ReplicaPlacement.parse(info.get("replication", "000"))
    except ShellError:
        return ReplicaPlacement.parse("000")


def volume_balance(env: CommandEnv) -> list[dict]:
    """Move volumes from overloaded to underloaded servers
    (command_volume_balance.go)."""
    env.confirm_locked()
    nodes = env.data_nodes()
    if len(nodes) < 2:
        return []
    counts = {n["url"]: len(n["volumes"]) for n in nodes}
    holdings = {n["url"]: list(n["volumes"]) for n in nodes}
    total = sum(counts.values())
    target = -(-total // len(nodes))
    moves = []
    for src in sorted(counts, key=counts.get, reverse=True):
        for dst in sorted(counts, key=counts.get):
            while counts[src] > target and counts[dst] < target and \
                    holdings[src]:
                vid = holdings[src].pop()
                if any(int(v) == int(vid) for v in holdings[dst]):
                    # dst already holds a replica: the copy would 409
                    continue
                env.vs_post(dst, "/admin/volume_copy",
                            {"volume": vid,
                             "collection": env.volume_collection(vid),
                             "source": src})
                env.vs_post(src, "/admin/delete_volume", {"volume": vid})
                counts[src] -= 1
                counts[dst] += 1
                moves.append({"volume": vid, "from": src, "to": dst})
    return moves


def cluster_check(env: CommandEnv) -> dict:
    """Basic cluster health summary (command_cluster_check.go)."""
    nodes = env.data_nodes()
    vols = volume_list(env)
    return {
        "nodes": len(nodes),
        "volumes": len([v for v in vols if "ec_shards" not in v]),
        "ec_entries": len([v for v in vols if "ec_shards" in v]),
    }


def volume_copy(env: CommandEnv, vid: int, source: str,
                target: str) -> dict:
    """Copy one volume's files to `target` and mount it there
    (command_volume_copy.go)."""
    env.confirm_locked()
    return env.vs_post(target, "/admin/volume_copy",
                       {"volume": vid,
                        "collection": env.volume_collection(vid),
                        "source": source})


def volume_move(env: CommandEnv, vid: int, source: str,
                target: str) -> dict:
    """Copy to target, then delete from source (command_volume_move.go).
    The source is read-only for the duration of the copy, so no write
    accepted after the .dat snapshot is lost with the source; reads go
    on throughout, and the target comes up writable."""
    env.confirm_locked()
    env.vs_post(source, "/admin/mark_readonly", {"volume": vid})
    try:
        out = volume_copy(env, vid, source, target)
    except Exception:
        env.vs_post(source, "/admin/mark_writable", {"volume": vid})
        raise
    env.vs_post(target, "/admin/mark_writable", {"volume": vid})
    env.vs_post(source, "/admin/delete_volume", {"volume": vid})
    return out


def volume_delete(env: CommandEnv, vid: int,
                  server: str = "") -> list[str]:
    """Delete a volume from one server or every replica
    (command_volume_delete.go)."""
    env.confirm_locked()
    targets = [server] if server else env.volume_locations(vid)
    for url in targets:
        env.vs_post(url, "/admin/delete_volume", {"volume": vid})
    return targets


def volume_mark(env: CommandEnv, vid: int, writable: bool) -> list[str]:
    """volume.mark -readonly / -writable on every replica
    (command_volume_mark.go)."""
    env.confirm_locked()
    path = "/admin/mark_writable" if writable else "/admin/mark_readonly"
    urls = env.volume_locations(vid)
    for url in urls:
        env.vs_post(url, path, {"volume": vid})
    return urls


def volume_mount(env: CommandEnv, vid: int, server: str) -> dict:
    env.confirm_locked()
    return env.vs_post(server, "/admin/volume_mount", {"volume": vid})


def volume_unmount(env: CommandEnv, vid: int, server: str) -> dict:
    env.confirm_locked()
    return env.vs_post(server, "/admin/volume_unmount", {"volume": vid})


def volume_grow(env: CommandEnv, count: int = 1, collection: str = "",
                replication: str = "", disk_type: str = "") -> dict:
    """Pre-grow writable volumes through the master (command_volume_grow,
    master /vol/grow); -disk targets servers of that disk class."""
    params = {"count": count}
    if collection:
        params["collection"] = collection
    if replication:
        params["replication"] = replication
    if disk_type:
        params["disk"] = disk_type
    return env.master_get("/vol/grow", **params)


def volume_evacuate(env: CommandEnv, server: str) -> list[dict]:
    """Move every volume off `server` onto the least-loaded other
    servers, then its EC shards (command_volume_server_evacuate.go).
    Servers already holding a replica of a volume are not candidates
    for it (the copy would 409)."""
    env.confirm_locked()
    nodes = env.data_nodes()
    me = next((n for n in nodes if n["url"] == server), None)
    if me is None:
        raise ShellError(f"unknown volume server {server}")
    others = [n for n in nodes if n["url"] != server]
    if not others:
        raise ShellError("no destination servers to evacuate to")
    moves = []
    counts = {n["url"]: len(n["volumes"]) for n in others}
    holders = {n["url"]: set(n["volumes"]) for n in others}
    collections = me.get("collections", {})
    for vid in list(me["volumes"]):
        candidates = [u for u in counts if vid not in holders[u]]
        if not candidates:
            moves.append({"volume": vid, "skipped":
                          "every other server already holds a replica"})
            continue
        dst = min(candidates, key=counts.get)
        env.vs_post(dst, "/admin/volume_copy",
                    {"volume": vid,
                     "collection": collections.get(str(vid), ""),
                     "source": server})
        env.vs_post(server, "/admin/delete_volume", {"volume": vid})
        counts[dst] += 1
        holders[dst].add(vid)
        moves.append({"volume": vid, "to": dst})
    # EC shards: re-spread each shard held here onto other servers
    for vid_s, bits in me.get("ec_volumes", {}).items():
        vid = int(vid_s)
        col = env.ec_collection(vid)
        for sid in [i for i in range(32) if bits >> i & 1]:
            dst = min(counts, key=counts.get)
            env.vs_post(dst, "/admin/ec/copy",
                        {"volume": vid, "collection": col,
                         "shard_ids": [sid], "source": server})
            env.vs_post(dst, "/admin/ec/mount",
                        {"volume": vid, "collection": col,
                         "shard_ids": [sid]})
            env.vs_post(server, "/admin/ec/unmount",
                        {"volume": vid, "shard_ids": [sid]})
            env.vs_post(server, "/admin/ec/delete",
                        {"volume": vid, "collection": col,
                         "shard_ids": [sid]})
            counts[dst] += 1
            moves.append({"volume": vid, "shard": sid, "to": dst})
    return moves


def volume_check_disk(env: CommandEnv, vid: int) -> dict:
    """Compare replica needle censuses and repair divergence needle by
    needle (command_volume_check_disk.go). Three cases:

    - a tombstone on any replica wins: propagate the delete (never
      resurrect from a stale live copy);
    - a needle live on some replicas, absent from others: copy it over;
    - a needle live everywhere but with different sizes (a missed
      overwrite): the record with the newest append_at_ns wins and
      overwrites the rest.
    """
    from ..storage import needle as ndl

    env.confirm_locked()
    urls = env.volume_locations(vid)
    if len(urls) < 2:
        return {"volume": vid, "replicas": len(urls), "diverged": False}
    live: dict[str, dict[int, int]] = {}     # url -> {key: size}
    deleted: dict[str, set[int]] = {}        # url -> tombstoned keys
    for url in urls:
        body = session().get(f"http://{url}/admin/needle_ids",
                             params={"volume": vid}, timeout=120).json()
        live[url] = {p[0]: p[1] for p in body["needles"]}
        deleted[url] = set(body.get("deleted", []))
    all_deleted: set[int] = set().union(*deleted.values())
    all_live: set[int] = set().union(*(set(c) for c in live.values()))
    repaired = []

    def read_raw(src: str, key: int) -> bytes:
        r = session().get(f"http://{src}/admin/needle_read",
                          params={"volume": vid, "key": key}, timeout=120)
        if r.status_code != 200:
            raise ShellError(f"read needle {key} of volume {vid} from "
                             f"{src}: {r.status_code}")
        return r.content

    def write_raw(dst: str, blob: bytes, force: bool = False) -> None:
        r = session().post(f"http://{dst}/admin/needle_write",
                           params={"volume": vid,
                                   **({"force": "1"} if force else {})},
                           data=blob, timeout=120)
        if r.status_code != 200:
            raise ShellError(f"write needle to {dst}: {r.text}")

    for key in sorted(all_live):
        if key in all_deleted:
            # tombstone wins: delete wherever it is still live
            for url in urls:
                if key in live[url]:
                    r = session().post(
                        f"http://{url}/admin/needle_delete",
                        json={"volume": vid, "key": key}, timeout=120)
                    if r.status_code != 200:
                        raise ShellError(
                            f"propagate tombstone for needle {key} to "
                            f"{url}: {r.status_code} {r.text}")
                    repaired.append({"needle": key, "deleted_on": url})
            continue
        holders = [u for u in urls if key in live[u]]
        absent = [u for u in urls if key not in live[u]]
        sizes = {live[u][key] for u in holders}
        if len(sizes) > 1:
            # content divergence: newest append wins everywhere
            records = {u: read_raw(u, key) for u in holders}
            newest = max(
                records,
                key=lambda u: ndl.Needle.from_bytes(
                    records[u]).append_at_ns)
            for u in holders:
                if u != newest and records[u] != records[newest]:
                    write_raw(u, records[newest], force=True)
                    repaired.append({"needle": key, "overwrote": u})
            for u in absent:
                write_raw(u, records[newest])
                repaired.append({"needle": key, "to": u})
        elif absent:
            blob = read_raw(holders[0], key)
            for u in absent:
                write_raw(u, blob)
                repaired.append({"needle": key, "to": u})
    return {"volume": vid, "replicas": len(urls),
            "diverged": bool(repaired), "repaired": repaired}


# the filer entry's directory bit (os.ModeDir as the filer stores it)
DIR_MODE_FLAG = 0o40000


def _filer_walk(env: CommandEnv, path: str) -> Iterator[dict]:
    """Depth-first walk of the filer's JSON listings rooted at `path`
    (directories included, root excluded) — the entry census of
    volume.fsck (commands_fs._walk in the reference)."""
    last = ""
    while True:
        resp = session().get(f"{env.filer_url}{path}",
                             params={"limit": "1024",
                                     "lastFileName": last},
                             headers={"Accept": "application/json"},
                             timeout=60)
        if resp.status_code == 404:
            raise ShellError(f"not found: {path}")
        body = resp.json()
        for e in body.get("entries", []):
            yield e
            if e.get("mode", 0) & DIR_MODE_FLAG:
                yield from _filer_walk(env, e["full_path"])
        last = body.get("lastFileName", "")
        if not body.get("shouldDisplayLoadMore") or not last:
            return


def volume_fsck(env: CommandEnv) -> dict:
    """Cross-check filer chunk fids against volume-server needle ids
    (command_volume_fsck.go): orphans = needles no filer entry points
    at; missing = chunks whose needle is gone."""
    from ..storage.types import parse_file_id

    if not env.filer_url:
        raise ShellError("volume.fsck needs a filer")
    # chunk census from the namespace
    referenced: dict[int, set[int]] = defaultdict(set)
    for e in _filer_walk(env, "/"):
        for c in e.get("chunks", []):
            vid, key, _cookie = parse_file_id(c["fid"])
            referenced[vid].add(key)
    # needle census from the servers
    on_disk: dict[int, set[int]] = defaultdict(set)
    for n in env.data_nodes():
        for vid in list(n["volumes"]) + \
                [int(v) for v in n["ec_volumes"]]:
            try:
                resp = session().get(
                    f"http://{n['url']}/admin/needle_ids",
                    params={"volume": vid}, timeout=120)
            except RequestException:
                continue
            if resp.status_code != 200:
                continue
            on_disk[vid] |= {p[0] for p in resp.json()["needles"]}
    orphans = {vid: sorted(on_disk[vid] - referenced.get(vid, set()))
               for vid in on_disk
               if on_disk[vid] - referenced.get(vid, set())}
    missing = {vid: sorted(referenced[vid] - on_disk.get(vid, set()))
               for vid in referenced
               if referenced[vid] - on_disk.get(vid, set())}
    return {"orphans": orphans, "missing": missing,
            "volumes_checked": len(on_disk)}


def volume_configure_replication(env: CommandEnv, vid: int,
                                 replication: str) -> list[dict]:
    """Rewrite the replica placement in every replica's superblock
    (command_volume_configure_replication.go). It takes effect on the
    next heartbeat; volume.fix.replication then creates copies to
    match."""
    env.confirm_locked()
    ReplicaPlacement.parse(replication)  # validate before touching disks
    urls = env.volume_locations(vid)
    if not urls:
        raise ShellError(f"volume {vid} not found")
    return [{"server": u,
             **env.vs_post(u, "/admin/volume_replication",
                           {"volume": vid, "replication": replication})}
            for u in urls]


def volume_delete_empty(env: CommandEnv,
                        quiet_for_seconds: int = 86400,
                        force: bool = False) -> list[dict]:
    """Delete volumes with no live files that have been quiet for
    `quietFor` (command_volume_delete_empty.go). -force skips the
    quiet-period check."""
    env.confirm_locked()
    now = time.time()
    deleted = []
    for n in env.data_nodes():
        # live counts come from the server's status report (the
        # topology snapshot carries no file counts)
        resp = session().get(f"http://{n['url']}/status", timeout=30)
        vols = {v["id"]: v for v in resp.json().get("volumes", [])}
        for vid in n["volumes"]:
            v = vols.get(vid)
            if v is None:
                continue
            live = v.get("file_count", 0) - v.get("delete_count", 0)
            modified = v.get("modified_at", 0)
            # a never-written volume reports its .dat's mtime, so
            # quietFor covers it; 0 means the stat failed: not reaped
            # without -force
            quiet = (now - modified) if modified else 0.0
            if live <= 0 and (force or quiet >= quiet_for_seconds):
                env.vs_post(n["url"], "/admin/delete_volume",
                            {"volume": vid})
                deleted.append({"volume": vid, "server": n["url"]})
    return deleted


def volume_server_leave(env: CommandEnv, server: str) -> dict:
    """Ask one volume server to stop heartbeating and leave the cluster
    (command_volume_server_leave.go); it serves on until shut down."""
    env.confirm_locked()
    return env.vs_post(server, "/admin/leave", {})


def volume_vacuum_toggle(env: CommandEnv, disable: bool) -> dict:
    """volume.vacuum.disable / enable: the master-side switch the admin
    scripts and the manual vacuum consult."""
    env.confirm_locked()
    path = "/vol/vacuum/disable" if disable else "/vol/vacuum/enable"
    resp = env.master_request("POST", path, timeout=30)
    if resp.status_code >= 300:
        raise ShellError(f"{path}: {resp.text}")
    return resp.json()


def collection_list(env: CommandEnv) -> list[str]:
    """command_collection_list.go."""
    cols = set()
    for n in env.data_nodes():
        cols.update(n.get("collections", {}).values())
    return sorted(cols)


def collection_delete(env: CommandEnv, collection: str) -> list[int]:
    """Delete every volume of a collection
    (command_collection_delete.go)."""
    env.confirm_locked()
    deleted = []
    for n in env.data_nodes():
        for vid_s, col in n.get("collections", {}).items():
            if col == collection:
                vid = int(vid_s)
                try:
                    env.vs_post(n["url"], "/admin/delete_volume",
                                {"volume": vid})
                except ShellError:
                    continue
                deleted.append(vid)
    return sorted(set(deleted))


def volume_scrub(env: CommandEnv, volume_id: int = 0,
                 collection: str = "", limit: int = 0,
                 quarantine: bool = True) -> list[dict]:
    """Full-read needle verification across the cluster (the per-volume
    arm of cluster scrub; ec.verify is the EC arm): every replica of
    every targeted volume re-reads its live needles, so disk reads, size
    checks and CRC32C all fire.

    With ``quarantine`` (default) a replica with CRC mismatches is taken
    out of service and a re-replication is enqueued on the master's
    repair queue, instead of only being reported."""
    targets: list[tuple[int, str]] = []
    if volume_id:
        for url in env.volume_locations(volume_id):
            targets.append((volume_id, url))
        if not targets:
            raise ShellError(f"volume {volume_id} not found")
    else:
        for n in env.data_nodes():
            for vid_s in n["volumes"]:
                vid = int(vid_s)
                if collection and \
                        env.volume_collection(vid) != collection:
                    continue
                targets.append((vid, n["url"]))
    out = []
    for vid, url in targets:
        r = env.vs_post(url, "/admin/volume_scrub",
                        {"volume": vid, "limit": limit})
        r["server"] = url
        if quarantine and r.get("bad"):
            r["quarantine"] = _quarantine_corrupt_replica(env, vid, url)
        out.append(r)
    return out


def _quarantine_corrupt_replica(env: CommandEnv, vid: int,
                                url: str) -> dict:
    """Self-healing arm of scrub: with a healthy replica elsewhere the
    corrupt copy is unmounted (its files stay on disk for forensics) and
    a targeted re-replication goes on the master's repair queue; a
    last-copy volume is only marked readonly — dropping it would take
    the remaining good needles offline too."""
    others = [u for u in env.volume_locations(vid) if u != url]
    if not others:
        try:
            env.vs_post(url, "/admin/mark_readonly", {"volume": vid})
        except ShellError as e:
            return {"action": "error", "error": str(e)}
        return {"action": "readonly", "repair_enqueued": False}
    try:
        env.vs_post(url, "/admin/volume_unmount", {"volume": vid})
    except ShellError as e:
        return {"action": "error", "error": str(e)}
    return {"action": "unmounted",
            "repair_enqueued": enqueue_repair(env, vid, "replica",
                                              "scrub")}


def enqueue_repair(env: CommandEnv, vid: int, kind: str, reason: str,
                   collection: str = "") -> bool:
    """Put one repair on the master's watchdog queue (POST
    /debug/repair); False when the master is unreachable — the
    watchdog's own deficit scan still picks the loss up."""
    try:
        resp = env.master_request("POST", "/debug/repair",
                                  json={"volume": vid, "kind": kind,
                                        "reason": reason,
                                        "collection": collection},
                                  timeout=30)
    except RequestException:
        return False
    return resp.status_code < 300
