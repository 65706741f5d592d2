"""Cluster inspection shell commands; the counterpart of
seaweedfs_tpu/shell/commands_cluster.py.

Equivalents of SeaweedFS weed/shell/command_cluster_ps.go (every node
the cluster knows), command_cluster_raft_ps.go (raft status of each
master) and command_cluster_raft_server_add.go / _remove.go (a
single-server membership change committed through the raft log).
"""
from __future__ import annotations

from ..rpc.httpclient import RequestException, session
from .env import CommandEnv, ShellError

# timeout of one master's /cluster/leader probe in cluster.raft.ps
PROBE_TIMEOUT = 3.0


def cluster_ps(env: CommandEnv) -> dict:
    """Processes in the cluster: masters (raft peers), volume servers
    (from the topology), filers and brokers (from their announces)."""
    status = env.master_get("/cluster/status")
    masters = status.get("Peers") or [env.master_url.split("//", 1)[-1]]
    out = {"masters": masters,
           "leader": status.get("Leader", ""),
           "volume_servers": [n["url"] for n in env.data_nodes()],
           "filers": [], "brokers": []}
    try:
        nodes = env.master_get("/cluster/nodes")
        for n in nodes.get("nodes", []):
            kind = n.get("type", "")
            if kind == "filer":
                out["filers"].append(n.get("address", ""))
            elif kind == "broker":
                out["brokers"].append(n.get("address", ""))
    except ShellError:
        pass
    return out


def cluster_raft_change(env: CommandEnv, peer: str, add: bool) -> dict:
    """cluster.raft.add / cluster.raft.remove. A newly added server must
    be started with the full -peers list so it catches up from the
    leader."""
    env.confirm_locked()
    if not peer:
        raise ShellError("needs -peer=host:port")
    verb = "add" if add else "remove"
    # a follower 307s to the leader; the client re-POSTs there
    resp = env.master_request("POST", f"/cluster/raft/{verb}",
                              params={"peer": peer}, timeout=30)
    if resp.status_code >= 300:
        try:
            err = resp.json().get("error", resp.text)
        except ValueError:
            err = resp.text
        raise ShellError(f"cluster.raft.{verb}: {err}")
    return resp.json()


def cluster_raft_ps(env: CommandEnv) -> dict:
    """Raft status of each master peer."""
    status = env.master_get("/cluster/status")
    peers = status.get("Peers") or []
    if not peers:
        return {"peers": [{"address": env.master_url, "leader": True,
                           "reachable": True}]}
    out = []
    for p in peers:
        url = p if p.startswith("http") else f"http://{p}"
        try:
            d = session().get(f"{url}/cluster/leader",
                              timeout=PROBE_TIMEOUT).json()
            out.append({"address": p, "leader": d.get("IsLeader", False),
                        "reachable": True})
        except (RequestException, ValueError):
            out.append({"address": p, "leader": False,
                        "reachable": False})
    return {"peers": out}
