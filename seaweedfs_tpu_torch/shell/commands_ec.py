"""EC orchestration shell commands; the counterpart of
seaweedfs_tpu/shell/commands_ec.py.

Equivalents of SeaweedFS weed/shell/command_ec_encode.go (freeze ->
generate -> spread -> delete original, :95-192), command_ec_rebuild.go
(:58-229), command_ec_balance.go + command_ec_common.go:111-170, and
command_ec_decode.go.
"""
from __future__ import annotations

from collections import defaultdict

from ..ec import geometry as geo
from ..utils import tracing
from .env import CommandEnv, ShellError


def ec_encode(env: CommandEnv, volume_id: int,
              collection: str = "", codec: str = "") -> dict:
    """Mark readonly, generate the shard set on the source server,
    spread shards across servers by free slots, then delete the
    original volume everywhere (command_ec_encode.go:95-192).
    `codec` selects the code family — "k.m" (e.g. "28.4") a wide RS
    tier, "lrc-k.l.g" (e.g. "lrc-12.3.2") a locally-repairable code;
    empty falls back to the process `-ec.code` default, then
    RS(10,4)."""
    env.confirm_locked()
    if not codec:
        from ..ec.backend import default_code_spec

        codec = default_code_spec()
    k, m = geo.parse_codec(codec)
    total = k + m
    sources = env.volume_locations(volume_id)
    if not sources:
        raise ShellError(f"volume {volume_id} not found")
    if not collection:
        collection = env.volume_collection(volume_id)
    for url in sources:
        env.vs_post(url, "/admin/mark_readonly", {"volume": volume_id})
    source = sources[0]
    env.vs_post(source, "/admin/ec/generate",
                {"volume": volume_id, "collection": collection,
                 "codec": codec})
    placement = spread_ec_shards(env, volume_id, collection, source,
                                 total=total)
    # delete original replicas now that shards are mounted
    for url in sources:
        env.vs_post(url, "/admin/delete_volume", {"volume": volume_id})
    env.wait_for_ec_registration(volume_id, total)
    return {sid: url for sid, url in placement.items()}


def spread_ec_shards(env: CommandEnv, vid: int, collection: str,
                     source: str,
                     total: int = geo.TOTAL_SHARDS) -> dict[int, str]:
    """Allocate shards to servers rack-aware (command_ec_encode.go:145
    spreadEcShards): round-robin across RACKS first, nodes inside a
    rack by free capacity, so a rack loss costs the fewest shards of
    any one volume — the same spreading contract repair preserves
    (master.placement)."""
    from ..master import placement as pl

    nodes = env.data_nodes()
    if not nodes:
        raise ShellError("no data nodes")
    order = pl.ec_spread_order(nodes, total)
    placement: dict[int, str] = {}
    per_node: dict[str, list[int]] = defaultdict(list)
    for sid in range(total):
        node = order[sid]
        placement[sid] = node["url"]
        per_node[node["url"]].append(sid)
    for url, sids in per_node.items():
        if url != source:
            env.vs_post(url, "/admin/ec/copy",
                        {"volume": vid, "collection": collection,
                         "shard_ids": sids, "source": source,
                         "copy_ecx": True, "copy_ecj": True})
        env.vs_post(url, "/admin/ec/mount",
                    {"volume": vid, "collection": collection,
                     "shard_ids": sids})
    # source keeps only its assigned shards
    source_keeps = set(per_node.get(source, []))
    drop = [sid for sid in range(total)
            if sid not in source_keeps]
    if drop:
        env.vs_post(source, "/admin/ec/delete",
                    {"volume": vid, "shard_ids": drop})
    return placement


def ec_rebuild(env: CommandEnv, volume_id: int,
               collection: str = "", max_bps: float = 0,
               partial: bool = True) -> dict:
    """Rebuild missing shards of an EC volume
    (command_ec_rebuild.go:58-229).

    The rebuilder is chosen by master.placement.select_ec_rebuilder —
    a node holding no shard of the volume, in the rack with the fewest
    of its shards — because the rebuilt shard lives where it is
    rebuilt.  When ``partial`` (default) and <= m shards are missing,
    the rebuilder's /admin/ec/rebuild_partial streams only the k shard
    ranges reconstruction needs (mode="partial" byte accounting)
    instead of borrowing every surviving shard file; the classic
    full-stripe path remains as fallback (mode="full").  ``max_bps``
    shapes all transfers against each node's repair bucket."""
    from ..master import placement as pl

    env.confirm_locked()
    reg_collection, code, locations = env.ec_full_info(volume_id)
    k, m = code.k, code.m
    if not collection:
        collection = reg_collection
    present = set(locations)
    missing = [sid for sid in range(k + m)
               if sid not in present]
    if not missing:
        return {"rebuilt": []}
    if not code.recoverable(sorted(present)):
        raise ShellError(
            f"volume {volume_id}: shards {sorted(present)} cannot "
            f"rebuild {code.spec}")
    nodes = env.data_nodes()
    node, violations = pl.select_ec_rebuilder(nodes, volume_id,
                                              locations)
    if node is None:  # every node full: fall back to emptiest
        node = max(nodes,
                   key=lambda n: n["max_volumes"] - len(n["volumes"]))
    rebuilder = node["url"]
    if partial and len(missing) <= m:
        try:
            out = env.vs_post(rebuilder, "/admin/ec/rebuild_partial",
                              {"volume": volume_id,
                               "collection": collection,
                               "shard_ids": missing,
                               "max_bps": max_bps})
            env.wait_for_ec_registration(volume_id, k + m)
            return {"rebuilt": out["rebuilt_shards"],
                    "rebuilder": rebuilder, "mode": "partial",
                    "rebuilt_bytes": out.get("rebuilt_bytes", 0),
                    "read_bytes": out.get("read_bytes", 0),
                    "placement_violations": violations}
        except ShellError:
            pass  # stale holder map / peer down: full path below
    local = set()
    for sid, urls in locations.items():
        if rebuilder in urls:
            local.add(sid)
    # copy ALL present-elsewhere shards to the rebuilder so the local
    # rebuild regenerates exactly the globally-missing ones
    # (prepareDataToRecover, command_ec_rebuild.go:193)
    borrowed = []
    for sid in sorted(present - local):
        src = locations[sid][0]
        env.vs_post(rebuilder, "/admin/ec/copy",
                    {"volume": volume_id, "collection": collection,
                     "shard_ids": [sid], "source": src,
                     "copy_ecx": not local and not borrowed,
                     "copy_ecj": False, "max_bps": max_bps,
                     "repair": True})
        borrowed.append(sid)
    out = env.vs_post(rebuilder, "/admin/ec/rebuild",
                      {"volume": volume_id})
    rebuilt = out["rebuilt_shards"]
    env.vs_post(rebuilder, "/admin/ec/mount",
                {"volume": volume_id, "collection": collection,
                 "shard_ids": rebuilt})
    if borrowed:
        env.vs_post(rebuilder, "/admin/ec/delete",
                    {"volume": volume_id, "shard_ids": borrowed})
    env.wait_for_ec_registration(volume_id, k + m)
    return {"rebuilt": rebuilt, "rebuilder": rebuilder, "mode": "full",
            "rebuilt_bytes": out.get("rebuilt_bytes", 0),
            "placement_violations": violations}


def ec_balance(env: CommandEnv, collection: str = "") -> list[dict]:
    """Even out shard counts across servers (command_ec_balance.go):
    move shards from overloaded to underloaded nodes."""
    env.confirm_locked()
    nodes = env.data_nodes()
    if not nodes:
        return []
    shard_count = {n["url"]: sum(bin(b).count("1")
                                 for b in n["ec_volumes"].values())
                   for n in nodes}
    holdings: dict[str, list[tuple[int, int]]] = defaultdict(list)
    for n in nodes:
        for vid_s, bits in n["ec_volumes"].items():
            for sid in range(geo.MAX_SHARD_COUNT):
                if bits >> sid & 1:
                    holdings[n["url"]].append((int(vid_s), sid))
    total = sum(shard_count.values())
    target = -(-total // len(nodes))  # ceil
    moves = []
    under = [u for u in shard_count if shard_count[u] < target]
    for src in sorted(shard_count, key=shard_count.get, reverse=True):
        while shard_count[src] > target and under:
            dst = under[0]
            vid, sid = holdings[src].pop()
            col = collection or env.ec_collection(vid)
            env.vs_post(dst, "/admin/ec/copy",
                        {"volume": vid, "collection": col,
                         "shard_ids": [sid], "source": src,
                         "copy_ecx": True, "copy_ecj": True})
            env.vs_post(dst, "/admin/ec/mount",
                        {"volume": vid, "collection": col,
                         "shard_ids": [sid]})
            env.vs_post(src, "/admin/ec/delete",
                        {"volume": vid, "shard_ids": [sid]})
            shard_count[src] -= 1
            shard_count[dst] += 1
            moves.append({"volume": vid, "shard": sid,
                          "from": src, "to": dst})
            if shard_count[dst] >= target:
                under.pop(0)
            if not under:
                break
    return moves


def ec_decode(env: CommandEnv, volume_id: int,
              collection: str = "") -> dict:
    """Collect all shards onto one server and decode back to a normal
    volume (command_ec_decode.go)."""
    env.confirm_locked()
    reg_collection, (k, m), locations = env.ec_info(volume_id)
    if not collection:
        collection = reg_collection
    if not locations:
        raise ShellError(f"ec volume {volume_id} not found")
    present = set(locations)
    if len(present) < k:
        raise ShellError(f"only {len(present)} shards survive")
    # choose the server with most shards as the collector
    count_by_server: dict[str, int] = defaultdict(int)
    for sid, urls in locations.items():
        for u in urls:
            count_by_server[u] += 1
    collector = max(count_by_server, key=count_by_server.get)
    have = {sid for sid, urls in locations.items() if collector in urls}
    need = sorted((present - have))[:k + m]
    for sid in need:
        src = locations[sid][0]
        env.vs_post(collector, "/admin/ec/copy",
                    {"volume": volume_id, "collection": collection,
                     "shard_ids": [sid], "source": src,
                     "copy_ecx": False, "copy_ecj": True})
    env.vs_post(collector, "/admin/ec/mount",
                {"volume": volume_id, "collection": collection,
                 "shard_ids": need})
    env.vs_post(collector, "/admin/ec/to_volume",
                {"volume": volume_id, "collection": collection})
    # drop shards elsewhere
    for sid, urls in locations.items():
        for u in urls:
            if u != collector:
                env.vs_post(u, "/admin/ec/delete",
                            {"volume": volume_id, "shard_ids": [sid]})
    return {"volume": volume_id, "server": collector}


def ec_verify(env: CommandEnv, volume_id: int, sample_mb: int = 4,
              backend: str = "numpy", quarantine: bool = True) -> dict:
    """Parity-check an EC volume's spread shards: fetch the same
    aligned prefix of every shard from its holder and run the codec
    backend's RS verify (batched GF(256) matmul; `backend` names any
    codec of the registry: numpy, native, torch, cuda). Any aligned
    prefix of all 14 shards is itself a valid codeword set, so
    `sample_mb` bounds IO while still exercising every shard
    end-to-end; 0 means full shards.

    With ``quarantine`` (default), a parity mismatch that pinpoints to
    exactly one corrupt shard deletes that shard on its holder and
    asks the master's repair queue for a rebuild (POST /debug/repair;
    `repair_enqueued` says whether the master took it). With
    -repair.enabled the watchdog then rebuilds the shard through the
    volume servers' codec.

    Runs under a span `ec.verify` (peer: the backend): the shard GETs'
    client spans and `ec.verify.stack` are its children."""
    with tracing.span("ec.verify", peer=str(backend)):
        return _ec_verify(env, volume_id, sample_mb, backend, quarantine)


def _ec_verify(env: CommandEnv, volume_id: int, sample_mb: int,
               backend: str, quarantine: bool) -> dict:
    import numpy as np

    from ..ec.backend import ReedSolomon
    from ..rpc.httpclient import session

    _col, code, locs = env.ec_full_info(volume_id)
    k, m = code.k, code.m
    missing = [sid for sid in range(k + m) if sid not in locs]
    if missing:
        return {"volume": volume_id, "verified": False,
                "missing_shards": missing}
    sample = sample_mb << 20
    shards = []
    for sid in range(k + m):
        url = locs[sid][0]
        params = {"volume": str(volume_id), "shard": str(sid),
                  "offset": "0"}
        if sample:
            params["size"] = str(sample)
        resp = session().get(f"http://{url}/admin/ec/shard_read",
                            params=params, timeout=600)
        if resp.status_code != 200:
            return {"volume": volume_id, "verified": False,
                    "missing_shards": [sid],
                    "error": f"shard {sid} read from {url}: "
                             f"{resp.status_code}"}
        shards.append(np.frombuffer(resp.content, dtype=np.uint8))
    n = min(len(s) for s in shards)
    with tracing.span("ec.verify.stack"):
        stack = np.stack([s[:n] for s in shards])
    rs = ReedSolomon(k, m, backend=backend, code=code)
    ok = bool(rs.verify(stack))
    out = {"volume": volume_id, "verified": ok,
           "bytes_checked_per_shard": int(n), "backend": backend}
    if not ok and quarantine:
        rows = {sid: stack[sid] for sid in range(k + m)}
        corrupt = _locate_corrupt_shard(rs, rows)
        out["corrupt_shard"] = corrupt
        if corrupt is not None:
            # the shard is regenerable from the other k+m-1: delete it
            # (a merely-unmounted file would poison a later local
            # rebuild on the same server) and let the repair queue
            # rebuild it through the codec router
            from .commands_volume import enqueue_repair

            env.vs_post(locs[corrupt][0], "/admin/ec/delete",
                        {"volume": volume_id, "shard_ids": [corrupt]})
            out["quarantined"] = True
            out["repair_enqueued"] = enqueue_repair(
                env, volume_id, "ec", "scrub", collection=_col)
    return out


def _locate_corrupt_shard(rs, rows: dict) -> int | None:
    """Pinpoint a single corrupt shard by reconstruction: decode the
    codeword from k clean shards and the one id whose fetched bytes
    disagree with the reconstruction is the corruption.  When the
    first basis (lowest k ids) contains the corrupt shard the decode
    disagrees in many places; retry excluding one basis member at a
    time.  None = not attributable to exactly one shard (multiple
    corruptions or systematic failure) — caller reports only."""
    import numpy as np

    total = rs.k + rs.m

    def mismatches(basis: list[int]) -> list[int] | None:
        try:
            recon = rs.reconstruct({sid: rows[sid] for sid in basis},
                                   missing=[i for i in range(total)
                                            if i not in basis])
        except ValueError:
            # dependent basis (possible for structured codes): this
            # basis can't decode — inconclusive, try the next
            return None
        return [i for i in range(total) if i not in basis and
                not np.array_equal(recon[i], rows[i])]

    basis = list(range(rs.k))
    bad = mismatches(basis)
    if bad is not None and len(bad) == 1:
        return bad[0]
    if not bad:
        return None
    for c in basis:
        alt = [i for i in range(total) if i != c][:rs.k]
        if mismatches(alt) == [c]:
            return c
    return None
