"""Cluster topology: Topology -> DataCenter -> Rack -> DataNode, volume
layouts and replica-aware volume growth; the counterpart of
seaweedfs_tpu/master/topology.py.

Equivalent of SeaweedFS weed/topology/ (Topology topology.go:28,
PickForWrite :211, VolumeLayout volume_layout.go:107, placement algorithm
volume_growth.go:134-230 findEmptySlotsForOneVolume) and the master-side
EC shard registry (topology_ec.go:69-137). Pure in-memory state machine —
no IO — so placement/balance logic is testable with fake clusters, the
reference's own test strategy (SURVEY.md section 4).

The port has no circuit breakers (utils/retry.py), so registration
resets none and the topology dump carries no per-node "breaker" state.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

from ..ec import geometry as geo
from ..storage.super_block import ReplicaPlacement


@dataclass
class VolumeInfo:
    vid: int
    collection: str = ""
    size: int = 0
    file_count: int = 0
    delete_count: int = 0
    deleted_bytes: int = 0
    read_only: bool = False
    replica_placement: str = "000"
    ttl: tuple[int, int] = (0, 0)
    version: int = 3
    modified_at: int = 0  # unix seconds of the last write
    # heat signals for the tiering controller (heartbeat-reported;
    # defaults keep old construction sites and tests valid)
    last_read_at: float = 0.0
    read_count: int = 0
    remote: bool = False


class DataNode:
    def __init__(self, node_id: str, ip: str, port: int, public_url: str,
                 max_volumes: int, rack: "Rack", disk_type: str = "hdd"):
        self.id = node_id
        self.ip = ip
        self.port = port
        self.public_url = public_url
        self.max_volumes = max_volumes
        self.disk_type = disk_type
        self.rack = rack
        self.volumes: dict[int, VolumeInfo] = {}
        self.ec_shards: dict[int, int] = {}  # vid -> shard bits
        # layout key each vid was registered under — needed to leave
        # the OLD layout when replication/ttl/disk class changes
        self.volume_layout_keys: dict[int, "LayoutKey"] = {}
        # last heartbeated repair token-bucket state
        # ({"rate","burst","fill","debt"}) — None until the node has
        # ever shaped repair traffic
        self.repair_bw: dict | None = None
        # ditto for the tier bucket (bulk offload/recall shaping)
        self.tier_bw: dict | None = None
        self.last_seen = time.monotonic()

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def free_slots(self) -> int:
        ec_slots = sum(bin(b).count("1") for b in self.ec_shards.values())
        return self.max_volumes - len(self.volumes) - \
            (ec_slots + geo.TOTAL_SHARDS - 1) // geo.TOTAL_SHARDS

    @property
    def dc(self) -> "DataCenter":
        return self.rack.dc


class Rack:
    def __init__(self, rack_id: str, dc: "DataCenter"):
        self.id = rack_id
        self.dc = dc
        self.nodes: dict[str, DataNode] = {}

    def free_slots(self) -> int:
        return sum(n.free_slots() for n in self.nodes.values())


class DataCenter:
    def __init__(self, dc_id: str):
        self.id = dc_id
        self.racks: dict[str, Rack] = {}

    def free_slots(self) -> int:
        return sum(r.free_slots() for r in self.racks.values())


def norm_disk(disk_type: str) -> str:
    """'' and 'hdd' are the same disk class (the reference's
    types.ToDiskType maps empty to HardDriveType)."""
    return disk_type or "hdd"


@dataclass
class LayoutKey:
    collection: str
    replication: str
    ttl: tuple[int, int]
    disk_type: str = "hdd"

    def __hash__(self):
        return hash((self.collection, self.replication, self.ttl,
                     self.disk_type))


class VolumeLayout:
    """Writable-set maintenance for one (collection, replication, ttl)
    class of volumes (volume_layout.go:107)."""

    def __init__(self, key: LayoutKey, volume_size_limit: int):
        self.key = key
        self.volume_size_limit = volume_size_limit
        self.locations: dict[int, list[DataNode]] = {}
        self.writable: set[int] = set()
        self.readonly: set[int] = set()

    def register(self, v: VolumeInfo, node: DataNode) -> None:
        nodes = self.locations.setdefault(v.vid, [])
        if node not in nodes:
            nodes.append(node)
        if v.read_only:
            self.readonly.add(v.vid)
            self.writable.discard(v.vid)
        elif v.size < self.volume_size_limit:
            rp = ReplicaPlacement.parse(v.replica_placement)
            if len(nodes) >= rp.copy_count:
                self.writable.add(v.vid)
        else:
            self.writable.discard(v.vid)

    def unregister(self, vid: int, node: DataNode) -> None:
        nodes = self.locations.get(vid)
        if nodes and node in nodes:
            nodes.remove(node)
        if not nodes:
            self.locations.pop(vid, None)
            self.writable.discard(vid)
            self.readonly.discard(vid)
        else:
            rp = ReplicaPlacement.parse(self.key.replication)
            if len(nodes) < rp.copy_count:
                self.writable.discard(vid)

    def pick_for_write(self, rng: random.Random,
                       preferred_dc: str = "") -> tuple[int, list[DataNode]]:
        if not self.writable:
            raise NoWritableVolume(
                f"no writable volumes for {self.key.collection!r} "
                f"rp={self.key.replication}")
        candidates = sorted(self.writable)
        if preferred_dc:
            # ?dataCenter= assign affinity (volume_layout.go
            # PickForWrite's option.DataCenter filter). A HARD filter,
            # like the reference: no writable volume in the dc raises,
            # and the master's grow path then creates one THERE
            candidates = [vid for vid in candidates
                          if any(n.rack.dc.id == preferred_dc
                                 for n in self.locations.get(vid, []))]
            if not candidates:
                raise NoWritableVolume(
                    f"no writable volumes in dc {preferred_dc!r} for "
                    f"{self.key.collection!r}")
        vid = rng.choice(candidates)
        return vid, self.locations[vid]


class NoWritableVolume(Exception):
    pass


class NoFreeSlots(Exception):
    pass


class Topology:
    def __init__(self, volume_size_limit: int = 30 << 30,
                 pulse_seconds: float = 5.0, seed: int | None = None):
        self.dcs: dict[str, DataCenter] = {}
        self.nodes: dict[str, DataNode] = {}
        self.layouts: dict[LayoutKey, VolumeLayout] = {}
        # EC registry: vid -> shard id -> [DataNode]
        self.ec_locations: dict[int, dict[int, list[DataNode]]] = {}
        self.ec_collections: dict[int, str] = {}
        self.ec_codecs: dict[int, str] = {}  # vid -> "k.m" wide codes
        # tiering: per-node EC heat/remote report,
        # vid -> node id -> {"remote", "last_read_at", "read_count"}
        self.ec_meta: dict[int, dict[str, dict]] = {}
        self.volume_size_limit = volume_size_limit
        self.pulse_seconds = pulse_seconds
        self.max_volume_id = 0
        self.lock = threading.RLock()
        self.rng = random.Random(seed)

    # -- registration (heartbeat driven) ------------------------------
    def register_node(self, node_id: str, ip: str, port: int,
                      public_url: str, max_volumes: int,
                      dc: str = "DefaultDataCenter",
                      rack: str = "DefaultRack",
                      disk_type: str = "hdd") -> DataNode:
        with self.lock:
            node = self.nodes.get(node_id)
            if node is None:
                dc_obj = self.dcs.setdefault(dc, DataCenter(dc))
                rack_obj = dc_obj.racks.setdefault(rack, Rack(rack, dc_obj))
                node = DataNode(node_id, ip, port, public_url, max_volumes,
                                rack_obj, norm_disk(disk_type))
                rack_obj.nodes[node_id] = node
                self.nodes[node_id] = node
            node.disk_type = norm_disk(disk_type)
            node.last_seen = time.monotonic()
            return node

    def sync_node_volumes(self, node: DataNode,
                          volumes: list[VolumeInfo]) -> None:
        """Full-state heartbeat sync (topology.go:303
        SyncDataNodeRegistration): register new/changed, unregister gone."""
        with self.lock:
            new = {v.vid: v for v in volumes}
            for vid in list(node.volumes):
                if vid not in new:
                    self._unregister_volume(node.volumes[vid], node)
                    del node.volumes[vid]
            for vid, v in new.items():
                # a volume whose replication/ttl (or the node's disk
                # class) changed must leave its OLD layout, or the
                # stale key keeps serving it as writable with the old
                # placement contract (volume.configure.replication's
                # takes-effect-on-heartbeat path)
                prev_key = node.volume_layout_keys.get(vid)
                new_key = self._layout_key(v, node)
                if prev_key is not None and prev_key != new_key:
                    layout = self.layouts.get(prev_key)
                    if layout is not None:
                        layout.unregister(vid, node)
                node.volumes[vid] = v
                self._register_volume(v, node)
                self.max_volume_id = max(self.max_volume_id, vid)

    def sync_node_ec_shards(self, node: DataNode,
                            shards: list[tuple]) -> None:
        """shards: [(vid, collection, shard_bits, codec)] with an
        optional 5th element — the node's tiering meta dict
        ({"remote", "last_read_at", "read_count"})
        (topology_ec.go:16; codec '' = RS(10,4), 'k.m' = wide tier)."""
        with self.lock:
            new = {s[0]: s[2] for s in shards}
            # unregister shards no longer reported
            for vid in list(node.ec_shards):
                old_bits = node.ec_shards[vid]
                now_bits = new.get(vid, 0)
                for sid in range(geo.MAX_SHARD_COUNT):
                    if old_bits >> sid & 1 and not now_bits >> sid & 1:
                        self._unregister_ec_shard(vid, sid, node)
                if now_bits == 0:
                    node.ec_shards.pop(vid, None)
                    meta = self.ec_meta.get(vid)
                    if meta is not None:
                        meta.pop(node.id, None)
            for vid, col, bits, codec, *rest in shards:
                if bits == 0:
                    continue
                if rest and rest[0]:
                    self.ec_meta.setdefault(vid, {})[node.id] = rest[0]
                node.ec_shards[vid] = bits
                self.ec_collections[vid] = col
                if codec:
                    self.ec_codecs[vid] = codec
                else:
                    # default-codec heartbeat overwrites a stale wide
                    # marker from a previous encode/decode cycle
                    self.ec_codecs.pop(vid, None)
                vol = self.ec_locations.setdefault(vid, {})
                for sid in range(geo.MAX_SHARD_COUNT):
                    if bits >> sid & 1:
                        nodes = vol.setdefault(sid, [])
                        if node not in nodes:
                            nodes.append(node)
                self.max_volume_id = max(self.max_volume_id, vid)

    def unregister_data_node(self, node_id: str) -> None:
        """Node death: drop all its volumes/shards from the maps
        (master_grpc_server.go:61-130 defer UnRegister)."""
        with self.lock:
            node = self.nodes.pop(node_id, None)
            if node is None:
                return
            for v in node.volumes.values():
                self._unregister_volume(v, node)
            for vid in node.ec_shards:
                for sid in range(geo.MAX_SHARD_COUNT):
                    if node.ec_shards[vid] >> sid & 1:
                        self._unregister_ec_shard(vid, sid, node)
                meta = self.ec_meta.get(vid)
                if meta is not None:
                    meta.pop(node_id, None)
            node.rack.nodes.pop(node_id, None)

    def _layout(self, collection: str, replication: str,
                ttl: tuple[int, int],
                disk_type: str = "hdd") -> VolumeLayout:
        key = LayoutKey(collection, replication, ttl,
                        norm_disk(disk_type))
        layout = self.layouts.get(key)
        if layout is None:
            layout = VolumeLayout(key, self.volume_size_limit)
            self.layouts[key] = layout
        return layout

    def _layout_key(self, v: VolumeInfo, node: DataNode) -> LayoutKey:
        return LayoutKey(v.collection, v.replica_placement, v.ttl,
                         norm_disk(node.disk_type))

    def _register_volume(self, v: VolumeInfo, node: DataNode) -> None:
        # a volume's disk class is its server's (volume layouts are
        # keyed (collection, rp, ttl, diskType), volume_layout.go:107)
        self._layout(v.collection, v.replica_placement, v.ttl,
                     node.disk_type).register(v, node)
        node.volume_layout_keys[v.vid] = self._layout_key(v, node)

    def _unregister_volume(self, v: VolumeInfo, node: DataNode) -> None:
        # prefer the key recorded at registration: the node's disk
        # class (or the volume's attributes) may have changed since
        key = node.volume_layout_keys.pop(v.vid, None) or \
            self._layout_key(v, node)
        layout = self.layouts.get(key)
        if layout is not None:
            layout.unregister(v.vid, node)

    def _unregister_ec_shard(self, vid: int, sid: int,
                             node: DataNode) -> None:
        vol = self.ec_locations.get(vid)
        if vol is None:
            return
        nodes = vol.get(sid)
        if nodes and node in nodes:
            nodes.remove(node)
        if nodes == []:
            vol.pop(sid, None)
        if not vol:
            self.ec_locations.pop(vid, None)
            self.ec_collections.pop(vid, None)
            self.ec_codecs.pop(vid, None)
            self.ec_meta.pop(vid, None)

    def ec_tier_view(self, vid: int) -> dict:
        """Cluster-wide tier view of one EC volume: remote only when
        EVERY reporting holder says its shards are remote; heat is the
        hottest/most-read signal across holders."""
        with self.lock:
            metas = list(self.ec_meta.get(vid, {}).values())
            return {
                "remote": bool(metas) and
                all(m.get("remote") for m in metas),
                "last_read_at": max(
                    (m.get("last_read_at", 0.0) for m in metas),
                    default=0.0),
                "read_count": sum(
                    m.get("read_count", 0) for m in metas),
            }

    # -- lookup ---------------------------------------------------------
    def lookup(self, vid: int) -> list[DataNode]:
        with self.lock:
            for layout in self.layouts.values():
                nodes = layout.locations.get(vid)
                if nodes:
                    return list(nodes)
            vol = self.ec_locations.get(vid)
            if vol:
                out: list[DataNode] = []
                for nodes in vol.values():
                    for n in nodes:
                        if n not in out:
                            out.append(n)
                return out
            return []

    def lookup_ec_shards(self, vid: int) -> dict[int, list[DataNode]]:
        with self.lock:
            return {sid: list(nodes)
                    for sid, nodes in self.ec_locations.get(vid, {}).items()}

    # -- write assignment ------------------------------------------------
    def pick_for_write(self, collection: str = "", replication: str = "000",
                       ttl: tuple[int, int] = (0, 0),
                       count: int = 1,
                       disk_type: str = "",
                       preferred_dc: str = "") -> tuple[int, list[DataNode]]:
        with self.lock:
            layout = self._layout(collection, replication, ttl,
                                  disk_type)
            return layout.pick_for_write(self.rng, preferred_dc)

    def next_volume_id(self) -> int:
        with self.lock:
            self.max_volume_id += 1
            return self.max_volume_id

    # -- growth placement -------------------------------------------------
    def find_empty_slots(self, replication: str = "000",
                         preferred_dc: str | None = None,
                         disk_type: str = "",
                         preferred_rack: str | None = None,
                         preferred_node: str | None = None
                         ) -> list[DataNode]:
        """Choose servers for one volume + replicas honoring the xyz
        placement (volume_growth.go:134-230): randomized main-node pick
        among candidates with enough free slots in the required
        dc/rack/server spread. `disk_type` restricts candidates to
        servers of that disk class; preferred_rack/preferred_node pin
        the MAIN copy (the /vol/grow rack/dataNode params)."""
        rp = ReplicaPlacement.parse(replication)
        disk = norm_disk(disk_type)
        with self.lock:
            dcs = [d for d in self.dcs.values()
                   if preferred_dc is None or d.id == preferred_dc]
            self.rng.shuffle(dcs)
            for dc in dcs:
                result = self._pick_in_dc(dc, rp, disk,
                                          preferred_rack,
                                          preferred_node)
                if result is not None:
                    return result
            raise NoFreeSlots(
                f"no free slots for replication {replication} "
                f"on disk type {disk!r}")

    def _pick_in_dc(self, dc: DataCenter, rp, disk: str,
                    preferred_rack: str | None = None,
                    preferred_node: str | None = None
                    ) -> list[DataNode] | None:
        def fits(n: DataNode) -> bool:
            return n.free_slots() > 0 and n.disk_type == disk

        def rack_fits(r: Rack) -> bool:
            return any(fits(n) for n in r.nodes.values())

        racks = [r for r in dc.racks.values()
                 if rack_fits(r) and (preferred_rack is None
                                      or r.id == preferred_rack)]
        self.rng.shuffle(racks)
        for rack in racks:
            nodes = [n for n in rack.nodes.values() if fits(n)]
            if len(nodes) < rp.same_rack + 1:
                continue
            self.rng.shuffle(nodes)
            if preferred_node is not None:
                # the MAIN copy is pinned; replicas spread normally
                mains = [n for n in nodes if n.id == preferred_node]
                if not mains:
                    continue
                nodes.remove(mains[0])
                nodes.insert(0, mains[0])
            main, same_rack = nodes[0], nodes[1:rp.same_rack + 1]
            # replicas on other racks in this dc
            other_racks: list[DataNode] = []
            candidates = [r for r in dc.racks.values()
                          if r is not rack and rack_fits(r)]
            self.rng.shuffle(candidates)
            for r in candidates[:rp.diff_rack]:
                ns = [n for n in r.nodes.values() if fits(n)]
                if ns:
                    other_racks.append(self.rng.choice(ns))
            if len(other_racks) < rp.diff_rack:
                continue
            # replicas in other dcs
            other_dcs: list[DataNode] = []
            dc_candidates = [d for d in self.dcs.values()
                             if d is not dc and any(
                                 rack_fits(r) for r in d.racks.values())]
            self.rng.shuffle(dc_candidates)
            for d in dc_candidates[:rp.diff_dc]:
                ns = [n for r in d.racks.values()
                      for n in r.nodes.values() if fits(n)]
                if ns:
                    other_dcs.append(self.rng.choice(ns))
            if len(other_dcs) < rp.diff_dc:
                continue
            return [main] + same_rack + other_racks + other_dcs
        return None

    # -- liveness ----------------------------------------------------------
    def dead_nodes(self, timeout_factor: float = 5.0) -> list[str]:
        cutoff = time.monotonic() - self.pulse_seconds * timeout_factor
        with self.lock:
            return [nid for nid, n in self.nodes.items()
                    if n.last_seen < cutoff]

    # -- introspection ------------------------------------------------------
    def to_dict(self) -> dict:
        with self.lock:
            return {
                "max_volume_id": self.max_volume_id,
                "datacenters": [{
                    "id": dc.id,
                    "racks": [{
                        "id": r.id,
                        "nodes": [{
                            "id": n.id, "url": n.url,
                            "public_url": n.public_url,
                            "volumes": sorted(n.volumes),
                            "collections": {
                                str(v): info.collection
                                for v, info in n.volumes.items()},
                            "volume_meta": {
                                str(v): {"ttl": list(info.ttl),
                                         "modified_at":
                                             info.modified_at,
                                         "size": info.size}
                                for v, info in n.volumes.items()},
                            "ec_volumes": {str(v): b for v, b in
                                           n.ec_shards.items()},
                            "max_volumes": n.max_volumes,
                            "disk_type": n.disk_type,
                            "repair_bw": n.repair_bw,
                            "tier_bw": n.tier_bw,
                        } for n in r.nodes.values()],
                    } for r in dc.racks.values()],
                } for dc in self.dcs.values()],
            }
