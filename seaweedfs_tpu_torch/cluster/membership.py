"""Cluster membership: which filers/brokers are alive, by node type; the
counterpart of seaweedfs_tpu/cluster/membership.py.

Equivalent of SeaweedFS weed/cluster/cluster.go — the master
tracks non-volume cluster members (filer, broker) keyed by node type
and filer group; members announce periodically and expire by TTL
(the reference keeps them alive via the KeepConnected stream; here an
announce beat over HTTP carries the same liveness signal).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

FILER = "filer"
BROKER = "broker"
MASTER = "master"


@dataclass
class ClusterNode:
    address: str
    node_type: str
    filer_group: str = ""
    version: str = ""
    created_at: float = field(default_factory=time.time)
    last_seen: float = field(default_factory=time.monotonic)


class ClusterMembership:
    def __init__(self, ttl_seconds: float = 15.0):
        self.ttl = ttl_seconds
        self._nodes: dict[tuple[str, str], ClusterNode] = {}
        self._lock = threading.Lock()

    def announce(self, address: str, node_type: str,
                 filer_group: str = "", version: str = "") -> None:
        key = (node_type, address)
        with self._lock:
            node = self._nodes.get(key)
            if node is None:
                self._nodes[key] = ClusterNode(
                    address, node_type, filer_group, version)
            else:
                node.last_seen = time.monotonic()
                node.filer_group = filer_group or node.filer_group

    def leave(self, address: str, node_type: str) -> None:
        with self._lock:
            self._nodes.pop((node_type, address), None)

    def list_nodes(self, node_type: str = "",
                   filer_group: str = "") -> list[ClusterNode]:
        now = time.monotonic()
        with self._lock:
            # expire the dead while listing
            dead = [k for k, n in self._nodes.items()
                    if now - n.last_seen > self.ttl]
            for k in dead:
                del self._nodes[k]
            out = [n for n in self._nodes.values()
                   if (not node_type or n.node_type == node_type) and
                   (not filer_group or n.filer_group == filer_group)]
        return sorted(out, key=lambda n: n.address)

    def to_dict(self, node_type: str = "") -> list[dict]:
        return [{"address": n.address, "type": n.node_type,
                 "filerGroup": n.filer_group, "version": n.version,
                 "createdAt": n.created_at}
                for n in self.list_nodes(node_type)]
