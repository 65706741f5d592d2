"""Placement-aware repair target selection; the counterpart of
seaweedfs_tpu/master/placement.py.

The write path already spreads copies with the xyz replica-placement
digits (topology.find_empty_slots / _pick_in_dc); repair must honor
the SAME contract or a healed cluster is quietly weaker than a fresh
one — a replica recreated in the rack that just failed can be lost to
the next failure of that rack. These helpers pick repair destinations
from the master's topology dump (the dc/rack-labelled node dicts the
shell's CommandEnv.data_nodes() returns), so the watchdog's repair
verbs and the property tests share one pure implementation.

A selection NEVER violates spread while a spread-preserving node with
free slots exists; when the survivors leave no such node (rack count
shrank below the placement's needs), the repair still proceeds —
redundancy beats placement — but the forced co-location is counted
and surfaced (`repair_placement_violations_total`, /cluster/status),
because it is an operator signal that the cluster needs racks, not
that repair failed.
"""
from __future__ import annotations

from ..ec import geometry as geo
from ..storage.super_block import ReplicaPlacement


def free_slots(node: dict) -> int:
    """DataNode.free_slots over a topology-dump node dict."""
    ec_slots = sum(bin(b).count("1")
                   for b in node.get("ec_volumes", {}).values())
    return (node["max_volumes"] - len(node.get("volumes", []))
            - (ec_slots + geo.TOTAL_SHARDS - 1) // geo.TOTAL_SHARDS)


def select_replica_targets(nodes: list[dict], holders: list[dict],
                           rp: ReplicaPlacement | str,
                           need: int) -> tuple[list[dict], int]:
    """Choose ``need`` repair destinations for a volume whose live
    copies sit on ``holders``.

    Returns (targets, violations). Hard rules: never a node already
    holding a copy, never a node without free slots. Soft (spread)
    rules, counted as one violation per forced break: when the
    placement requires dc spread that the survivors lost, prefer a new
    dc; when it requires rack spread, prefer a new rack; tie-break by
    emptiest node so repair also rebalances.
    """
    if isinstance(rp, str):
        rp = ReplicaPlacement.parse(rp)
    holder_urls = {h["url"] for h in holders}
    holder_dcs = {h["dc"] for h in holders}
    holder_racks = {(h["dc"], h["rack"]) for h in holders}
    targets: list[dict] = []
    violations = 0
    for _ in range(need):
        candidates = [n for n in nodes
                      if n["url"] not in holder_urls
                      and free_slots(n) > 0]
        if not candidates:
            break
        # want_dcs/racks: the spread the xyz digits promise for the
        # FULL copy set (1 main + diff_dc other dcs, + diff_rack other
        # racks inside a dc)
        want_dcs = 1 + rp.diff_dc
        want_racks = 1 + rp.diff_rack
        need_new_dc = rp.diff_dc > 0 and len(holder_dcs) < want_dcs
        need_new_rack = rp.diff_rack > 0 and len(
            {r for d, r in holder_racks}) < want_racks

        def rank(n: dict) -> tuple:
            new_dc = n["dc"] not in holder_dcs
            new_rack = (n["dc"], n["rack"]) not in holder_racks
            return (
                # spread the placement REQUIRES comes first …
                not (need_new_dc and new_dc),
                not (need_new_rack and new_rack),
                # … then spread for free even when not required
                not new_rack,
                len(n.get("volumes", [])),
                -free_slots(n),
                n["url"],
            )

        chosen = min(candidates, key=rank)
        if need_new_dc and chosen["dc"] in holder_dcs:
            violations += 1
        elif need_new_rack and (chosen["dc"],
                                chosen["rack"]) in holder_racks:
            violations += 1
        targets.append(chosen)
        holder_urls.add(chosen["url"])
        holder_dcs.add(chosen["dc"])
        holder_racks.add((chosen["dc"], chosen["rack"]))
    return targets, violations


def select_ec_rebuilder(nodes: list[dict], vid: int,
                        shard_locations: dict[int, list[str]]
                        ) -> tuple[dict | None, int]:
    """Choose the server that reconstructs a missing EC shard.

    The rebuilt shard lives where it is rebuilt, so the rebuilder IS
    the placement decision: prefer a node holding no shard of this
    volume, in the rack currently hosting the fewest of its shards
    (rack loss then costs the fewest shards), tie-break by free
    slots. Returns (node, violations): one violation when every
    free-slot node already holds a shard of the volume and the repair
    must co-locate.
    """
    holder_urls: set[str] = set()
    rack_load: dict[tuple[str, str], int] = {}
    url_to_rack = {n["url"]: (n["dc"], n["rack"]) for n in nodes}
    for urls in shard_locations.values():
        for u in urls:
            holder_urls.add(u)
            rack = url_to_rack.get(u)
            if rack is not None:
                rack_load[rack] = rack_load.get(rack, 0) + 1
    candidates = [n for n in nodes if free_slots(n) > 0]
    if not candidates:
        return None, 0

    def shards_held(n: dict) -> int:
        bits = n.get("ec_volumes", {}).get(str(vid), 0)
        return bin(bits).count("1")

    def rank(n: dict) -> tuple:
        return (
            n["url"] in holder_urls,
            rack_load.get((n["dc"], n["rack"]), 0),
            shards_held(n),
            -free_slots(n),
            n["url"],
        )

    chosen = min(candidates, key=rank)
    violations = 1 if chosen["url"] in holder_urls else 0
    return chosen, violations


def ec_spread_order(nodes: list[dict], total: int) -> list[dict]:
    """Shard -> node assignment for spreading a fresh shard set:
    rack-aware round-robin so each rack ends up with as equal a share
    as the node census allows (a rack loss then costs the minimum
    number of shards), nodes inside a rack ordered by free capacity.
    Returns a list of length ``total`` (nodes repeat once every node
    in the rotation has been used)."""
    by_rack: dict[tuple[str, str], list[dict]] = {}
    for n in sorted(nodes, key=lambda n: (-free_slots(n), n["url"])):
        by_rack.setdefault((n["dc"], n["rack"]), []).append(n)
    # racks with the most capacity first so the +1 remainder shards
    # land where there is room
    racks = sorted(by_rack.values(),
                   key=lambda ns: -sum(max(0, free_slots(n))
                                       for n in ns))
    order: list[dict] = []
    idx = [0] * len(racks)
    while len(order) < total:
        progressed = False
        for i, rack_nodes in enumerate(racks):
            if len(order) >= total:
                break
            order.append(rack_nodes[idx[i] % len(rack_nodes)])
            idx[i] += 1
            progressed = True
        if not progressed:  # no nodes at all
            break
    return order
