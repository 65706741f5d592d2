"""The port's master state machine against the JAX package's: topology
(registration, volume and EC-shard sync, layouts, lookups, write picks,
growth placement, liveness, the dump the shell reads), placement
(EC spread order, rebuilder choice, replica targets) and the file-id
sequencer, on the same seeded clusters (tolerance 0: equal answers)."""
import types

import numpy as np
import pytest

from seaweedfs_tpu.master import placement as ref_pl
from seaweedfs_tpu.master import sequence as ref_seq
from seaweedfs_tpu.master import topology as ref_topo
from seaweedfs_tpu_torch.master import placement as pl
from seaweedfs_tpu_torch.master import sequence as seq
from seaweedfs_tpu_torch.master import topology as topo

SEEDS = list(range(8))
REPLICATIONS = ["000", "001", "010", "100", "011", "200"]


def _cluster_spec(seed: int) -> dict:
    """A seeded cluster: nodes in dcs / racks, their volumes and EC
    shards (plain data, fed identically to both packages)."""
    rng = np.random.default_rng(seed)
    nodes = []
    for d in range(int(rng.integers(1, 4))):
        for r in range(int(rng.integers(1, 4))):
            for i in range(int(rng.integers(1, 4))):
                nodes.append({
                    "id": f"10.{d}.{r}.{i}:8080", "ip": f"10.{d}.{r}.{i}",
                    "port": 8080, "public_url": f"pub{d}{r}{i}:80",
                    "max_volumes": int(rng.integers(2, 9)),
                    "dc": f"dc{d}", "rack": f"rack{r}",
                    "disk": str(rng.choice(["hdd", "ssd", ""]))})
    volumes = {}
    for n in nodes:
        vols = []
        for vid in rng.choice(40, int(rng.integers(0, 5)), replace=False):
            vols.append(dict(
                vid=int(vid) + 1, collection=str(rng.choice(["", "pics"])),
                size=int(rng.integers(0, 1500)),
                file_count=int(rng.integers(0, 50)),
                read_only=bool(rng.random() < 0.2),
                replica_placement=str(rng.choice(["000", "001", "010"])),
                modified_at=int(rng.integers(0, 10**6))))
        volumes[n["id"]] = vols
    ec = {}
    for n in nodes:
        ec[n["id"]] = [(int(vid) + 100, str(rng.choice(["", "cold"])),
                        int(rng.integers(1, 1 << 14)),
                        str(rng.choice(["", "28.4"])))
                       for vid in rng.choice(6, int(rng.integers(0, 3)),
                                             replace=False)]
    return {"nodes": nodes, "volumes": volumes, "ec": ec}


def _build(mod, spec: dict, seed: int):
    t = mod.Topology(volume_size_limit=1000, pulse_seconds=1.0, seed=seed)
    for n in spec["nodes"]:
        node = t.register_node(n["id"], n["ip"], n["port"],
                               n["public_url"], n["max_volumes"],
                               n["dc"], n["rack"], n["disk"])
        t.sync_node_volumes(node, [mod.VolumeInfo(**v)
                                   for v in spec["volumes"][n["id"]]])
        t.sync_node_ec_shards(node, spec["ec"][n["id"]])
    return t


def _dump(t) -> dict:
    # every node carries its "breaker" state: closed in both packages,
    # since a fresh registration resets it
    return t.to_dict()


def _pair(seed: int):
    spec = _cluster_spec(seed)
    return _build(ref_topo, spec, seed), _build(topo, spec, seed), spec


def _data_nodes(dump: dict) -> list[dict]:
    """The shell's view (CommandEnv.data_nodes) of a topology dump."""
    out = []
    for dc in dump["datacenters"]:
        for rack in dc["racks"]:
            for n in rack["nodes"]:
                out.append(dict(n, dc=dc["id"], rack=rack["id"]))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_dump_and_lookups_match(seed):
    ref, port, spec = _pair(seed)
    assert _dump(port) == _dump(ref)
    for vid in range(1, 110):
        assert [n.id for n in port.lookup(vid)] == \
            [n.id for n in ref.lookup(vid)]
        assert {s: [n.id for n in ns]
                for s, ns in port.lookup_ec_shards(vid).items()} == \
            {s: [n.id for n in ns]
             for s, ns in ref.lookup_ec_shards(vid).items()}
    assert port.ec_collections == ref.ec_collections
    assert port.ec_codecs == ref.ec_codecs
    assert port.ec_meta == ref.ec_meta
    for vid in range(100, 106):
        assert port.ec_tier_view(vid) == ref.ec_tier_view(vid)


@pytest.mark.parametrize("seed", SEEDS)
def test_write_picks_and_growth_match(seed):
    ref, port, spec = _pair(seed)
    for col in ("", "pics", "none"):
        for rp in ("000", "001", "010"):
            for disk in ("", "ssd"):
                for _ in range(4):
                    got = []
                    for t, mod in ((ref, ref_topo), (port, topo)):
                        try:
                            vid, nodes = t.pick_for_write(
                                col, rp, disk_type=disk)
                            got.append((vid, [n.id for n in nodes]))
                        except mod.NoWritableVolume as e:
                            got.append(("none", str(e)))
                    assert got[0] == got[1]
    for rp in REPLICATIONS:
        for dc in (None, "dc0", "dc1"):
            for disk in ("", "hdd", "ssd"):
                got = []
                for t, mod in ((ref, ref_topo), (port, topo)):
                    try:
                        got.append([n.id for n in t.find_empty_slots(
                            rp, dc, disk_type=disk)])
                    except mod.NoFreeSlots as e:
                        got.append(str(e))
                assert got[0] == got[1], (rp, dc, disk)
    for node in spec["nodes"]:
        if ref.nodes[node["id"]].free_slots() <= 0:
            continue
        pinned = [[n.id for n in t.find_empty_slots(
            "000", preferred_node=node["id"], disk_type=node["disk"])]
            for t in (ref, port)]
        assert pinned[0] == pinned[1] == [node["id"]]
    assert port.next_volume_id() == ref.next_volume_id()


@pytest.mark.parametrize("seed", SEEDS)
def test_resync_unregister_and_liveness_match(seed, monkeypatch):
    ref, port, spec = _pair(seed)
    rng = np.random.default_rng(seed + 100)
    victim = spec["nodes"][int(rng.integers(0, len(spec["nodes"])))]
    for t, mod in ((ref, ref_topo), (port, topo)):
        node = t.nodes[victim["id"]]
        # drop the node's first volume and half its EC bits
        vols = [mod.VolumeInfo(**v) for v in spec["volumes"][victim["id"]]]
        t.sync_node_volumes(node, vols[1:])
        t.sync_node_ec_shards(node, [(vid, col, bits & 0x2AAA, codec)
                                     for vid, col, bits, codec in
                                     spec["ec"][victim["id"]]])
    assert _dump(port) == _dump(ref)
    other = spec["nodes"][-1]["id"]
    for t in (ref, port):
        t.unregister_data_node(other)
    assert _dump(port) == _dump(ref)
    # liveness: the same silent nodes are dead for the same clock
    clock = types.SimpleNamespace(monotonic=lambda: 1000.0)
    for mod in (ref_topo, topo):
        monkeypatch.setattr(mod, "time", clock)
    for t in (ref, port):
        for i, n in enumerate(sorted(t.nodes)):
            t.nodes[n].last_seen = 1000.0 - i
    for factor in (0.5, 2.0, 5.0):
        assert port.dead_nodes(factor) == ref.dead_nodes(factor)


@pytest.mark.parametrize("seed", SEEDS)
def test_placement_matches(seed):
    ref, port, spec = _pair(seed)
    nodes = _data_nodes(_dump(port))
    assert nodes == _data_nodes(_dump(ref))
    rng = np.random.default_rng(seed + 200)
    for total in (14, 16, 32):
        assert [n["url"] for n in pl.ec_spread_order(nodes, total)] == \
            [n["url"] for n in ref_pl.ec_spread_order(nodes, total)]
    for n in nodes:
        assert pl.free_slots(n) == ref_pl.free_slots(n)
    for _ in range(6):
        vid = int(rng.integers(100, 106))
        urls = [n["url"] for n in nodes]
        locs = {int(s): [str(u) for u in rng.choice(
            urls, int(rng.integers(1, 3)), replace=True)]
            for s in rng.choice(14, int(rng.integers(1, 14)), replace=False)}
        got = pl.select_ec_rebuilder(nodes, vid, locs)
        want = ref_pl.select_ec_rebuilder(nodes, vid, locs)
        assert (got[0] and got[0]["url"], got[1]) == \
            (want[0] and want[0]["url"], want[1])
        holders = [nodes[int(i)] for i in rng.choice(
            len(nodes), int(rng.integers(1, min(3, len(nodes)) + 1)),
            replace=False)]
        for rp in REPLICATIONS:
            need = int(rng.integers(1, 3))
            got_t, got_v = pl.select_replica_targets(nodes, holders, rp, need)
            want_t, want_v = ref_pl.select_replica_targets(nodes, holders,
                                                           rp, need)
            assert ([n["url"] for n in got_t], got_v) == \
                ([n["url"] for n in want_t], want_v)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_memory_sequencer_matches(seed):
    rng = np.random.default_rng(seed)
    a, b = ref_seq.MemorySequencer(), seq.MemorySequencer()
    for _ in range(50):
        if rng.random() < 0.2:
            seen = int(rng.integers(0, 500))
            a.set_max(seen)
            b.set_max(seen)
        n = int(rng.integers(1, 10))
        assert b.next_ids(n) == a.next_ids(n)
        assert b.peek() == a.peek()
