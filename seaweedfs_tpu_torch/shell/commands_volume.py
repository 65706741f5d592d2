"""Volume shell commands; the counterpart of
seaweedfs_tpu/shell/commands_volume.py, trimmed to `volume.list`,
`cluster.check`, `volume.fix.replication` and the repair-queue request
of ec.verify's quarantine (command_volume_list.go,
command_cluster_check.go, command_volume_fix_replication.go).
"""
from __future__ import annotations

from collections import defaultdict

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


def cluster_check(env: CommandEnv) -> dict:
    """Basic cluster health summary (command_cluster_check.go)."""
    nodes = env.data_nodes()
    vols = volume_list(env)
    return {
        "nodes": len(nodes),
        "volumes": len([v for v in vols if "ec_shards" not in v]),
        "ec_entries": len([v for v in vols if "ec_shards" in v]),
    }


def volume_fix_replication(env: CommandEnv, volume_id: int = 0,
                           max_bps: float = 0) -> list[dict]:
    """Re-replicate under-replicated volumes: copy .dat/.idx from a
    healthy replica to a server that lacks the volume, chosen by
    master.placement.select_replica_targets (the same rack/DC spreading
    contract the master applies at write assignment). ``volume_id``
    restricts the pass to one volume; ``max_bps`` shapes every copy
    against the nodes' repair token buckets."""
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


def enqueue_repair(env: CommandEnv, vid: int, kind: str, reason: str,
                   collection: str = "") -> bool:
    """Put one repair on the master's watchdog queue (POST
    /debug/repair); False when the master has no such queue or is
    unreachable."""
    try:
        resp = session().post(f"{env.master_url}/debug/repair",
                              json={"volume": vid, "kind": kind,
                                    "reason": reason,
                                    "collection": collection},
                              timeout=30)
    except RequestException:
        return False
    return resp.status_code < 300
