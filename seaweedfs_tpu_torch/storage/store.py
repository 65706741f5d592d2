"""Store: the per-server registry of disk locations, volumes and EC
volumes — the engine behind every volume-server handler; the
counterpart of seaweedfs_tpu/storage/store.py.

Equivalent of the reference's weed/storage/store.go (WriteVolumeNeedle
:386, ReadVolumeNeedle :410, CollectHeartbeat :249) and store_ec.go (EC
mount/read/delete incl. the degraded-read ladder: local shard -> remote
shard fetch -> on-the-fly reconstruction from >= k shards,
store_ec.go:199-393). Remote fetch is injected as a callback so the
transport lives in the server layer.

Where the codecs run:

* `generate_ec_shards` (.dat -> shards + .ecx) and `rebuild_ec_shards`
  (regenerate lost shard files) run the configured `ec_backend`:
  "auto" (the default: the measured router, which needs a GPU and
  raises without one on first use), "cuda" (the hand-written kernel
  csrc/coded_matmul.cu through the staged feed; raises at construction
  without a GPU), a host codec ("native", "numpy"), or a codec
  instance such as `CudaCodec(device="cpu")`.
* A degraded read reconstructs one needle interval (a few KB to a MB)
  on the GET's critical path. `_rs_for(interval=True)` routes it to
  the CPU codec (`cpu_backend_name()`: native, else numpy) whatever
  `ec_backend` says. This is the reference's own routing, not a
  fallback: the device is never tried for it, because a dispatch and
  its transfers are latency with no throughput to gain at that size.
  Each interval's gather and decode is a span, `ec.degraded_interval`,
  and the decode alone `ec.reconstruct`, under the GET's server span
  beside the shard fetches' client spans (/debug/traces).

The cold tier (the master's tiering controller's offload and recall
arms): `tier_offload_ec` moves this server's local shards of an EC
volume to a remote_storage client under deterministic keys
(`tier_shard_key`) and mounts remote-backed shards in their place;
`tier_recall_ec` brings them back. The `.rsm` manifest records every
offloaded shard (atomic tmp + fsync + rename after each one), so both
resume after a crash without duplicate objects, and a restarted store
re-mounts the offloaded shards remote-backed.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Iterable

import numpy as np

from ..ec import geometry as geo
from ..ec.backend import CodecBackend, ReedSolomon
from ..ec.backend import cpu_backend_name as ec_cpu_backend
from ..ec.encoder import rebuild_ec_files, write_ec_files, write_sorted_ecx
from ..ec.volume import EcVolume
from ..utils import sketch as _sketch
from ..utils import tracing
from .disk_location import DiskLocation
from .needle import Needle
from .super_block import ReplicaPlacement

# fetch(vid, shard_id, offset, size) -> bytes | None
RemoteShardReader = Callable[[int, int, int, int], "bytes | None"]

# fan-out fetch(vid, candidate_sids, offset, size, need, deadline_s)
# -> {sid: bytes}; returns as soon as `need` shards arrive (first-k-wins)
RemoteShardsFetcher = Callable[[int, list, int, int, int, float],
                               "dict[int, bytes]"]

# byte-rate shaping hook for bulk tier movement: fn(n_bytes) blocks
# until the bytes are admitted (volume server wires the "tier" bucket)
TierThrottle = Callable[[int], None]


def tier_shard_key(collection: str, vid: int, sid: int) -> str:
    """Deterministic remote object key for one offloaded EC shard.
    Determinism is the no-duplicate-objects guarantee: a transition
    retried after a crash overwrites the same key instead of minting a
    new object."""
    return f"tier-ec/{collection or 'default'}/{vid}/{sid:02d}.ec"


# one remote client per distinct config, process-wide (clients are
# stateless wrappers; S3 ones hold a signing-key cache worth sharing)
_remote_clients: dict[str, object] = {}
_remote_lock = threading.Lock()


def remote_client_for(conf: dict):
    from ..remote_storage.client import make_client

    key = json.dumps(conf, sort_keys=True)
    with _remote_lock:
        c = _remote_clients.get(key)
        if c is None:
            c = _remote_clients[key] = make_client(conf)
        return c


class Store:
    def __init__(self, dirnames: Iterable[str], ip: str = "localhost",
                 port: int = 8080, public_url: str = "",
                 ec_backend: str | CodecBackend = "auto",
                 needle_map_kind: str = "memory"):
        self.locations = [
            DiskLocation(d, needle_map_kind=needle_map_kind)
            for d in dirnames]
        self.ip = ip
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        self.ec_backend = ec_backend
        self.ec_volumes: dict[int, EcVolume] = {}
        self.remote_shard_reader: RemoteShardReader | None = None
        self.remote_shards_fetcher: RemoteShardsFetcher | None = None
        # wall-clock budget for one degraded read's remote fan-out: a
        # single hung peer must not stall the read ladder indefinitely
        # (the reference bounds this with per-rpc contexts,
        # store_ec.go:349-393)
        self.ec_read_deadline = 10.0
        self._rs = ReedSolomon(geo.DATA_SHARDS, geo.PARITY_SHARDS,
                               backend=ec_backend)
        # per-volume heat: last read/write wall time + cumulative
        # counts, reported in heartbeats so the master's tiering
        # controller can age volumes by real access, not just write
        # mtime
        self._heat: dict[int, dict] = {}
        self._heat_lock = threading.Lock()
        # per-volume workload sketches (read/write inter-access gaps +
        # request sizes) behind the same short lock; compact encodings
        # ride the heartbeat `workload` key when telemetry is enabled
        self._wl: dict[int, dict] = {}
        # node-level foreground byte-rate accounting: current-second
        # tally, last completed second, all-time per-second peak — the
        # repair-cap advisor's headroom inputs
        self._bps_sec = 0
        self._bps_cur = 0
        self._bps_last = 0
        self._bps_peak = 0
        for loc in self.locations:
            loc.load_existing()
            for vid, entry in loc.ec_shards.items():
                ecv = EcVolume(loc.dir, entry.collection, vid)
                for sid in entry.shard_ids:
                    if os.path.exists(
                            ecv.base_name() + geo.shard_ext(sid)):
                        ecv.mount_shard(sid)
                self.ec_volumes[vid] = ecv
                # shards offloaded to the cold tier re-mount
                # remote-backed from the manifest (restart survival)
                try:
                    self._mount_manifest_shards(ecv)
                except Exception as e:
                    loc.load_errors.append(
                        (vid, f"remote shards: {type(e).__name__}: {e}"))

    # -- volume management --------------------------------------------
    def find_volume(self, vid: int):
        for loc in self.locations:
            v = loc.volumes.get(vid)
            if v is not None:
                return v
        return None

    def has_volume(self, vid: int) -> bool:
        return self.find_volume(vid) is not None

    def needle_size(self, vid: int, needle_id: int) -> int:
        """Cheap O(1) size estimate from the needle map (no disk IO);
        0 when unknown — feeds in-flight download accounting."""
        v = self.find_volume(vid)
        if v is None:
            return 0
        loc = v.nm.get(needle_id)
        return int(loc[1]) if loc else 0

    def add_volume(self, vid: int, collection: str = "",
                   replication: str = "000", ttl: bytes = b"\x00\x00"):
        if self.find_volume(vid) is not None:
            raise FileExistsError(f"volume {vid} already exists")
        loc = min(self.locations, key=lambda l: l.volume_count)
        return loc.new_volume(
            collection, vid,
            replica_placement=ReplicaPlacement.parse(replication), ttl=ttl)

    def delete_volume(self, vid: int) -> None:
        for loc in self.locations:
            if vid in loc.volumes:
                loc.delete_volume(vid)
                return
        raise KeyError(f"volume {vid} not found")

    def mark_readonly(self, vid: int, read_only: bool = True) -> None:
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        v.read_only = read_only

    def unmount_volume(self, vid: int) -> None:
        """Close a volume and drop it from memory, keeping its files on
        disk (volume_grpc_admin.go VolumeUnmount). It disappears from the
        next heartbeat; `mount_volume` brings it back."""
        for loc in self.locations:
            v = loc.volumes.get(vid)
            if v is not None:
                v.close()
                del loc.volumes[vid]
                return
        raise KeyError(f"volume {vid} not found")

    def mount_volume(self, vid: int) -> None:
        """Reload an unmounted volume from its on-disk .dat/.idx
        (volume_grpc_admin.go VolumeMount)."""
        if self.find_volume(vid) is not None:
            return
        for loc in self.locations:
            if loc.try_load_volume(vid):
                return
        raise KeyError(f"volume {vid} has no files on disk")

    def read_raw_needle(self, vid: int, key: int) -> bytes:
        """Serialized on-disk record of one live needle — the transfer
        unit of volume.check.disk's needle-level replica sync."""
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        n = v.read_needle(key)
        return n.to_bytes(v.version)

    def append_raw_needle(self, vid: int, blob: bytes,
                          force: bool = False) -> int:
        """Append a record produced by `read_raw_needle` on a peer
        replica. Skips keys that are already live unless `force` (the
        content-divergence repair, where the newer record must win)."""
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        n = Needle.from_bytes(blob, v.version)
        if not force and v.nm.get(n.id) is not None:
            return n.id
        v.append_needle(n)
        return n.id

    def needle_ids(self, vid: int) -> tuple[list[tuple[int, int]],
                                            list[int]]:
        """(live (needle_id, size) pairs, deleted needle_ids) of a local
        volume or EC volume — feeds volume.fsck / volume.check.disk
        (command_volume_fsck.go). Deleted ids matter: replica sync must
        propagate tombstones, never resurrect from a stale live copy."""
        v = self.find_volume(vid)
        if v is not None:
            return ([(key, size) for key, _, size in v.nm.live_items()],
                    sorted(v.nm.deleted_keys()))
        ecv = self.ec_volumes.get(vid)
        if ecv is not None:
            return ecv.live_needle_ids(), sorted(ecv.deleted)
        raise KeyError(f"volume {vid} not found")

    # -- needle IO ------------------------------------------------------
    def write_needle(self, vid: int, n: Needle) -> tuple[int, int]:
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        res = v.append_needle(n)
        self.record_write(vid, nbytes=res[1])
        return res

    def read_needle(self, vid: int, needle_id: int,
                    cookie: int | None = None,
                    read_deleted: bool = False) -> Needle:
        v = self.find_volume(vid)
        if v is not None:
            out = v.read_needle(needle_id, cookie,
                                read_deleted=read_deleted)
            self.record_read(vid, nbytes=out.size)
            return out
        if vid in self.ec_volumes:
            return self.read_ec_needle(vid, needle_id, cookie)
        raise KeyError(f"volume {vid} not found")

    @staticmethod
    def _new_heat() -> dict:
        return {"last_read_at": 0.0, "read_count": 0,
                "last_write_at": 0.0, "write_count": 0}

    def _wl_for(self, vid: int) -> dict:
        # caller holds _heat_lock; rg/wg = read/write inter-access
        # gaps, rs/ws = read/write request sizes
        wl = self._wl.get(vid)
        if wl is None:
            wl = self._wl[vid] = {k: _sketch.windowed()
                                  for k in ("rg", "rs", "wg", "ws")}
        return wl

    def _account_bytes(self, nbytes: int, now: float) -> None:
        # caller holds _heat_lock
        sec = int(now)
        if sec != self._bps_sec:
            if self._bps_sec:
                self._bps_last = self._bps_cur
                if self._bps_cur > self._bps_peak:
                    self._bps_peak = self._bps_cur
            self._bps_sec = sec
            self._bps_cur = 0
        if nbytes > 0:
            self._bps_cur += int(nbytes)

    def record_read(self, vid: int, nbytes: int = 0) -> None:
        """Heat accounting for one serving read of a volume — cheap
        enough for the GET hot path (dict store under a short lock).
        With telemetry on, also sketches the inter-read gap and the
        needle size into the volume's sliding-window histograms."""
        now = time.time()
        tele = _sketch.enabled()
        with self._heat_lock:
            h = self._heat.get(vid)
            if h is None:
                h = self._heat[vid] = self._new_heat()
            prev = h["last_read_at"]
            h["last_read_at"] = now
            h["read_count"] += 1
            if tele:
                wl = self._wl_for(vid)
                if prev:
                    wl["rg"].record(now - prev, now)
                if nbytes > 0:
                    wl["rs"].record(nbytes, now)
                self._account_bytes(nbytes, now)

    def record_write(self, vid: int, nbytes: int = 0) -> None:
        """Write-side twin of record_read, tapped from write_needle."""
        now = time.time()
        tele = _sketch.enabled()
        with self._heat_lock:
            h = self._heat.get(vid)
            if h is None:
                h = self._heat[vid] = self._new_heat()
            prev = h["last_write_at"]
            h["last_write_at"] = now
            h["write_count"] += 1
            if tele:
                wl = self._wl_for(vid)
                if prev:
                    wl["wg"].record(now - prev, now)
                if nbytes > 0:
                    wl["ws"].record(nbytes, now)
                self._account_bytes(nbytes, now)

    def volume_heat(self, vid: int) -> dict:
        with self._heat_lock:
            h = self._heat.get(vid)
            return dict(h) if h else self._new_heat()

    def workload_payload(self, now: float | None = None) -> dict:
        """Compact per-volume sketch encodings + node byte rates for
        the heartbeat `workload` key (empty sketches are skipped so an
        idle node costs a few bytes)."""
        now = time.time() if now is None else now
        with self._heat_lock:
            vols = {}
            for vid, wl in self._wl.items():
                enc = {k: s.to_dict(now) for k, s in wl.items()}
                enc = {k: d for k, d in enc.items() if d.get("n")}
                if enc:
                    vols[str(vid)] = enc
            # fg_bps: the most recent complete-or-partial second's
            # foreground bytes, 0 when the node has gone idle. The
            # roll in _account_bytes only happens on the NEXT record,
            # so a just-ended second still sits in _bps_cur here.
            sec = int(now)
            if sec == self._bps_sec:
                fg = max(self._bps_cur, self._bps_last)
            elif sec - self._bps_sec == 1:
                fg = self._bps_cur  # that full second just ended
            else:
                fg = 0
            # _bps_cur is always a valid single-second tally, even if
            # the roll hasn't folded it into _bps_peak yet — a burst
            # must count toward the peak before the next request lands
            return {"alpha": _sketch.alpha(), "volumes": vols,
                    "fg_bps": fg,
                    "peak_bps": max(self._bps_peak, self._bps_cur)}

    def delete_needle(self, vid: int, needle_id: int) -> int:
        v = self.find_volume(vid)
        if v is not None:
            return v.delete_needle(needle_id)
        if vid in self.ec_volumes:
            self.ec_volumes[vid].delete_needle(needle_id)
            return 0
        raise KeyError(f"volume {vid} not found")

    # -- EC lifecycle ---------------------------------------------------
    def generate_ec_shards(self, vid: int, codec: str = "") -> None:
        """VolumeEcShardsGenerate (volume_grpc_erasure_coding.go:38):
        .dat -> shard files + .ecx, using the configured codec backend.
        `codec` ("k.m") selects a wide code (beyond-reference tier)."""
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        v.sync()
        base = v.file_name()
        write_ec_files(base, backend=self.ec_backend, codec=codec)
        write_sorted_ecx(base)

    def rebuild_ec_shards(self, vid: int) -> list[int]:
        """VolumeEcShardsRebuild (:84): regenerate missing local shards."""
        base = self._ec_base(vid)
        if base is None:
            raise KeyError(f"ec volume {vid} not found")
        return rebuild_ec_files(base, backend=self.ec_backend)

    def mount_ec_shards(self, vid: int, collection: str,
                        shard_ids: Iterable[int]) -> None:
        ecv = self.ec_volumes.get(vid)
        if ecv is None:
            loc = self._loc_with_ec_files(vid, collection)
            ecv = EcVolume(loc.dir, collection, vid)
            self.ec_volumes[vid] = ecv
        for sid in shard_ids:
            ecv.mount_shard(sid)
            for loc in self.locations:
                if loc.dir == ecv.dir:
                    loc.add_ec_shard(collection, vid, sid)

    def unmount_ec_shards(self, vid: int, shard_ids: Iterable[int]) -> None:
        ecv = self.ec_volumes.get(vid)
        if ecv is None:
            return
        for sid in shard_ids:
            ecv.unmount_shard(sid)
        if not ecv.shards:
            self.ec_volumes.pop(vid, None)

    def delete_ec_shards(self, vid: int,
                         shard_ids: Iterable[int] | None = None) -> None:
        ids = set(shard_ids) if shard_ids is not None else None
        self.unmount_ec_shards(vid, ids or range(geo.MAX_SHARD_COUNT))
        for loc in self.locations:
            loc.remove_ec_shards(vid, ids)

    def _ec_base(self, vid: int) -> str | None:
        for loc in self.locations:
            entry = loc.ec_shards.get(vid)
            if entry is not None:
                return entry.base_name(loc.dir)
            # also look for shard files not yet registered
            v = loc.volumes.get(vid)
            if v is not None and os.path.exists(
                    v.file_name() + geo.shard_ext(0)):
                return v.file_name()
        ecv = self.ec_volumes.get(vid)
        return ecv.base_name() if ecv is not None else None

    def _loc_with_ec_files(self, vid: int, collection: str) -> DiskLocation:
        for loc in self.locations:
            name = f"{collection}_{vid}" if collection else str(vid)
            for sid in range(geo.MAX_SHARD_COUNT):
                if os.path.exists(os.path.join(
                        loc.dir, name + geo.shard_ext(sid))):
                    return loc
        return self.locations[0]

    # -- EC degraded read ladder ----------------------------------------
    def read_ec_needle(self, vid: int, needle_id: int,
                       cookie: int | None = None) -> Needle:
        """ReadEcShardNeedle (store_ec.go:136): locate via .ecx, read each
        interval locally, else via remote fetch, else reconstruct."""
        ecv = self.ec_volumes.get(vid)
        if ecv is None:
            raise KeyError(f"ec volume {vid} not found")
        intervals, size = ecv.needle_intervals(needle_id)
        blob = b"".join(self._read_interval(ecv, iv) for iv in intervals)
        n = Needle.from_bytes(blob)
        if n.size != size:
            raise ValueError(f"size mismatch: ecx {size} vs disk {n.size}")
        if cookie is not None and n.cookie != cookie:
            raise PermissionError("cookie mismatch")
        self.record_read(vid, nbytes=n.size)
        return n

    def _read_interval(self, ecv: EcVolume, iv: geo.Interval) -> bytes:
        data = ecv.read_interval_local(iv)
        if data is not None:
            return data
        sid, off = iv.to_shard_and_offset()
        if self.remote_shards_fetcher is not None:
            # direct fetch of the owning shard gets only a SLICE of the
            # read budget: if its holder is hung, the remaining budget
            # must still cover the reconstruction fan-out (the old
            # ladder burned the whole deadline on this hop first)
            got = self.remote_shards_fetcher(
                ecv.vid, [sid], off, iv.size, 1,
                min(2.0, self.ec_read_deadline * 0.25))
            if sid in got:
                return got[sid]
        elif self.remote_shard_reader is not None:
            data = self.remote_shard_reader(ecv.vid, sid, off, iv.size)
            if data is not None:
                return data
        # the degraded read's gather and decode, one span (the shard
        # fetches below it are the client's spans)
        with tracing.span("ec.degraded_interval"):
            return self._reconstruct_interval(ecv, sid, off, iv.size)

    def _reconstruct_interval(self, ecv: EcVolume, missing_sid: int,
                              offset: int, size: int) -> bytes:
        """recoverOneRemoteEcShardInterval (store_ec.go:339): gather the
        same byte range from >= k other shards and reconstruct.

        Local shards are read first (cheap); the remaining need is
        fanned out CONCURRENTLY to every remote candidate via
        remote_shards_fetcher, first-k-wins under ec_read_deadline —
        the reference fans out one goroutine per shard the same way
        (store_ec.go:349-393); a serial walk would pay ≥10 sequential
        RTTs and a single hung peer would stall the read forever.

        Structured codes first consult their repair plan: an LRC heals
        a single lost shard from its locality group (fan-in k/l), so
        the ladder reads a handful of shards instead of k. The generic
        gather below stays as the fallback for multi-loss and for plan
        shards that turn out unreachable — it collects shards until
        their encode rows reach GF(256) rank k, NOT until k shards are
        in hand: structured codes carry dependent rows (an LRC local
        parity is the XOR of its group), so a first-k-by-count set can
        be rank-deficient while independent shards sit reachable."""
        if not ecv.code.is_rs:
            data = self._reconstruct_planned(ecv, missing_sid, offset,
                                             size)
            if data is not None:
                return data
        code = ecv.code
        rows: dict[int, np.ndarray] = {}
        span: list[int] = []   # shard ids backing rows; full-rank by invariant

        def grows(sid: int) -> bool:
            # for RS any <= k distinct shards are independent, so rank
            # is the count and the matrix check is skipped
            if len(span) >= ecv.k:
                return False
            if code.is_rs:
                return True
            from ..ops import rs_matrix

            return rs_matrix.rank_of(code, span + [sid]) > len(span)

        candidates: list[int] = []
        for sid in range(ecv.total):
            if sid == missing_sid:
                continue
            shard = ecv.shards.get(sid)
            if shard is None:
                candidates.append(sid)
            elif grows(sid):
                rows[sid] = np.frombuffer(
                    shard.read_at(offset, size), dtype=np.uint8)
                span.append(sid)
        while len(span) < ecv.k and candidates:
            need = ecv.k - len(span)
            got: dict[int, bytes] = {}
            if self.remote_shards_fetcher is not None:
                got = self.remote_shards_fetcher(
                    ecv.vid, candidates, offset, size, need,
                    self.ec_read_deadline)
            elif self.remote_shard_reader is not None:
                # legacy serial fallback (tools / tests without a server)
                for sid in list(candidates):
                    if len(got) >= need:
                        break
                    candidates.remove(sid)  # tried: never re-asked
                    data = self.remote_shard_reader(
                        ecv.vid, sid, offset, size)
                    if data is not None:
                        got[sid] = data
            if not got:
                break
            for sid in sorted(got):
                if grows(sid):
                    rows[sid] = np.frombuffer(got[sid], dtype=np.uint8)
                    span.append(sid)
            # responders that didn't grow the span are dropped from the
            # candidate list so the retry round asks for NEW shards
            candidates = [s for s in candidates if s not in got]
        if len(span) < ecv.k:
            raise IOError(
                f"cannot reconstruct shard {missing_sid} of volume "
                f"{ecv.vid}: only {len(rows)} shards reachable")
        with tracing.span("ec.reconstruct"):
            rec = self._rs_for(ecv, interval=True).reconstruct(
                rows, [missing_sid])
        return rec[missing_sid].tobytes()

    def _reconstruct_planned(self, ecv: EcVolume, missing_sid: int,
                             offset: int, size: int) -> bytes | None:
        """Repair-plan fast path: read exactly the code's planned
        fan-in for this single loss (the locality group for an LRC
        data/local shard). Returns None — falling back to the generic
        >= k ladder — when the plan doesn't beat k reads or one of its
        shards is unreachable."""
        plan = ecv.code.repair_plan(
            [missing_sid],
            [s for s in range(ecv.total) if s != missing_sid])
        if plan is None or plan.fanin >= ecv.k:
            return None
        rows: dict[int, np.ndarray] = {}
        remote: list[int] = []
        for sid in plan.reads:
            shard = ecv.shards.get(sid)
            if shard is not None:
                rows[sid] = np.frombuffer(
                    shard.read_at(offset, size), dtype=np.uint8)
            else:
                remote.append(sid)
        if remote:
            if self.remote_shards_fetcher is not None:
                got = self.remote_shards_fetcher(
                    ecv.vid, remote, offset, size, len(remote),
                    self.ec_read_deadline)
                for sid, data in got.items():
                    rows[sid] = np.frombuffer(data, dtype=np.uint8)
            elif self.remote_shard_reader is not None:
                for sid in remote:
                    data = self.remote_shard_reader(
                        ecv.vid, sid, offset, size)
                    if data is not None:
                        rows[sid] = np.frombuffer(data, dtype=np.uint8)
        if set(rows) != set(plan.reads):
            return None
        with tracing.span("ec.reconstruct"):
            rec = self._rs_for(ecv, interval=True).reconstruct(
                rows, [missing_sid])
        return rec[missing_sid].tobytes()

    def _rs_for(self, ecv: EcVolume, *,
                interval: bool = False) -> ReedSolomon:
        """Per-codec ReedSolomon, cached — wide-code volumes carry their
        own (k, m) from the .vif sidecar.

        interval=True pins the CPU codec (native/numpy) regardless of
        the configured device backend, as the reference does: a
        single-needle degraded read reconstructs a few KB on a GET's
        critical path, where a device dispatch (the feed's set-up and
        its host<->device copies) is pure latency with zero throughput
        payoff. Whole-volume encode/rebuild keeps the configured
        backend — that's where the device's bandwidth can win."""
        backend = ec_cpu_backend() if interval else self.ec_backend
        # a real EcVolume carries .code from the .vif sidecar; bare
        # (k, m) stand-ins fall back to the plain RS family
        code = getattr(ecv, "code", None) or \
            geo.parse_code("%d.%d" % (ecv.k, ecv.m))
        if not interval and code.is_rs and \
                (ecv.k, ecv.m) == (geo.DATA_SHARDS, geo.PARITY_SHARDS):
            return self._rs
        cache = getattr(self, "_rs_cache", None)
        if cache is None:
            cache = self._rs_cache = {}
        rs = cache.get((code.spec, backend))
        if rs is None:
            rs = cache[(code.spec, backend)] = ReedSolomon(
                ecv.k, ecv.m, backend=backend, code=code)
        return rs

    # -- cold-tier offload / recall (remote_storage clients) -------------
    def _manifest_path(self, ecv: EcVolume) -> str:
        return ecv.base_name() + ".rsm"

    def _load_manifest(self, ecv: EcVolume) -> dict | None:
        try:
            with open(self._manifest_path(ecv), encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def _save_manifest(self, ecv: EcVolume, man: dict) -> None:
        """Atomic write: a crash mid-offload must leave either the old
        or the new shard inventory, never a torn one."""
        path = self._manifest_path(ecv)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(man, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _mount_manifest_shards(self, ecv: EcVolume) -> None:
        """Re-mount remote-backed shards recorded in the manifest
        (volume-server restart while the volume is cold)."""
        man = self._load_manifest(ecv)
        if man is None:
            return
        client = remote_client_for(man["remote"])
        for sid_s, ent in man.get("shards", {}).items():
            sid = int(sid_s)
            prev = ecv.shards.get(sid)
            if prev is not None and not prev.remote:
                continue  # local file won a race with the manifest
            ecv.mount_remote_shard(sid, ent["key"], int(ent["size"]),
                                   client.read_file)

    def tier_offload_ec(self, vid: int, remote_conf: dict,
                        throttle: TierThrottle | None = None) -> dict:
        """Move this server's local shards of one EC volume to a
        remote tier; reads keep working through the remote-backed
        shard objects (degraded-read guard intact). Idempotent: shards
        already offloaded are skipped, keys are deterministic, and the
        manifest is persisted after every shard — a crash mid-offload
        resumes without duplicate remote objects or lost bytes."""
        ecv = self.ec_volumes.get(vid)
        if ecv is None:
            raise KeyError(f"ec volume {vid} not found")
        client = remote_client_for(remote_conf)
        man = self._load_manifest(ecv) or {
            "volume": vid, "collection": ecv.collection,
            "remote": remote_conf, "shards": {}}
        moved = 0
        offloaded: list[int] = []
        for sid in sorted(ecv.shards):
            shard = ecv.shards[sid]
            if shard.remote:
                continue  # already cold (resume after crash)
            key = tier_shard_key(ecv.collection, vid, sid)
            size = shard.size
            if throttle is not None:
                throttle(size)
            data = shard.read_at(0, size)
            client.write_file(key, data)
            # manifest BEFORE deleting the local file: worst case after
            # a crash is a re-upload over the same key, never data loss
            man["shards"][str(sid)] = {"key": key, "size": size}
            self._save_manifest(ecv, man)
            path = getattr(shard, "path", "")
            ecv.mount_remote_shard(sid, key, size, client.read_file)
            if path:
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass
            moved += size
            offloaded.append(sid)
        return {"volume": vid, "moved_bytes": moved,
                "offloaded": offloaded,
                "remote_shards": sorted(int(s) for s in man["shards"])}

    def tier_recall_ec(self, vid: int,
                       throttle: TierThrottle | None = None,
                       delete_remote: bool = True) -> dict:
        """Bring this server's offloaded shards back to local disk.
        Idempotent mirror of tier_offload_ec: already-local shards are
        skipped, downloads land via tmp+rename, and the remote objects
        plus manifest are removed only once every shard is local."""
        ecv = self.ec_volumes.get(vid)
        if ecv is None:
            raise KeyError(f"ec volume {vid} not found")
        man = self._load_manifest(ecv)
        if man is None:
            return {"volume": vid, "moved_bytes": 0, "recalled": []}
        client = remote_client_for(man["remote"])
        base = ecv.base_name()
        moved = 0
        recalled: list[int] = []
        for sid_s, ent in sorted(man.get("shards", {}).items()):
            sid = int(sid_s)
            shard = ecv.shards.get(sid)
            if shard is not None and not shard.remote:
                continue  # already recalled (resume after crash)
            size = int(ent["size"])
            if throttle is not None:
                throttle(size)
            data = client.read_file(ent["key"])
            path = base + geo.shard_ext(sid)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            if shard is not None:
                ecv.unmount_shard(sid)
            ecv.mount_shard(sid)
            for loc in self.locations:
                if loc.dir == ecv.dir:
                    loc.add_ec_shard(ecv.collection, vid, sid)
            moved += len(data)
            recalled.append(sid)
        if delete_remote:
            for ent in man.get("shards", {}).values():
                client.delete_file(ent["key"])
        try:
            os.remove(self._manifest_path(ecv))
        except FileNotFoundError:
            pass
        return {"volume": vid, "moved_bytes": moved,
                "recalled": recalled}

    def ec_remote_shards(self, vid: int) -> list[int]:
        ecv = self.ec_volumes.get(vid)
        if ecv is None:
            return []
        return sorted(sid for sid, s in ecv.shards.items() if s.remote)

    # -- heartbeat -------------------------------------------------------
    def collect_heartbeat(self) -> dict:
        """CollectHeartbeat (store.go:249): full volume + EC shard report
        for the master."""
        volumes = []
        for loc in self.locations:
            for vid, v in loc.volumes.items():
                volumes.append({
                    "id": vid,
                    "collection": v.collection,
                    "size": v.content_size(),
                    "file_count": v.nm.file_count,
                    "delete_count": v.nm.deleted_count,
                    "deleted_bytes": v.nm.deleted_bytes,
                    "read_only": v.read_only,
                    "replica_placement":
                        str(v.super_block.replica_placement),
                    "ttl": list(v.super_block.ttl),
                    "version": v.version,
                    # volume-TTL expiry decisions need the last write
                    # time (volume ttl, needle/volume_ttl.go)
                    "modified_at": v.modified_at_second(),
                    # heat signals for the master's tiering controller
                    **self.volume_heat(vid),
                })
        ec_shards = [
            {"id": vid, "collection": ecv.collection,
             "shard_bits": ecv.shard_bits().bits,
             # the .vif spec string, NOT a (k, m)-derived name: an LRC
             # can share RS(10,4)'s geometry (lrc-10.2.2) yet be a
             # different code, and the master's registry drives repair
             # planning for structured codes
             "codec": ecv.codec,
             # tiering: are this node's shards offloaded to the remote
             # tier, and how hot is the EC volume still being read
             "remote": bool(ecv.shards) and
             all(s.remote for s in ecv.shards.values()),
             **self.volume_heat(vid)}
            for vid, ecv in self.ec_volumes.items()
        ]
        hb = {
            "ip": self.ip, "port": self.port, "public_url": self.public_url,
            "max_volume_count": sum(l.max_volumes for l in self.locations),
            "volumes": volumes, "ec_shards": ec_shards,
        }
        if _sketch.enabled():
            # compact sketch encodings for the master's workload
            # aggregator; unknown keys are ignored by older masters
            hb["workload"] = self.workload_payload()
        return hb

    def close(self) -> None:
        for loc in self.locations:
            loc.close()
        for ecv in self.ec_volumes.values():
            ecv.close()
