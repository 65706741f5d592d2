"""Volume server: the data plane by fid, the admin API the shell drives
and the heartbeat to the master; the counterpart of
seaweedfs_tpu/server/volume_server.py.

Equivalents: SeaweedFS weed/server/volume_server_handlers_read.go:31
(GetOrHeadHandler), _write.go:18 (PostHandler), the VolumeServer admin
rpcs (volume_grpc_admin.go, volume_grpc_erasure_coding.go:38-407,
volume_grpc_copy.go file streaming) and the heartbeat loop
(volume_grpc_client_to_master.go:50-120).

Where the codec runs: `ec/generate` (Store.generate_ec_shards),
`ec/rebuild` (Store.rebuild_ec_shards), `ec/rebuild_partial` (a
ReedSolomon on the store's `ec_backend`, one reconstruct per chunk of
shard ranges fetched from peers) and `ec/to_volume` (write_dat_file,
which regenerates lost data shards first) run the configured backend —
with "cuda", the hand-written kernel. Each runs on the handler thread
of its request; a codec error answers 500 (or 400 for a ValueError, as
the reference's error middleware) and reaches the shell as a
ShellError. A degraded GET reconstructs its interval on the CPU codec
(Store._rs_for(interval=True)), the reference's routing.

The heartbeat is the reference's stream: a thread holds one websocket
to the leader's /ws/heartbeat (`wss://` for an https master) and sends
the Store's full report on it every pulse, and at once when
`poke_heartbeat` wakes it, waiting at most 4 pulses for each reply. The
master unregisters the server the moment the stream ends, so `stop()`
and `leave` close it, as a process that dies does. A closed stream or
a reply that does not come sends the thread, after min(1 s, a pulse),
back to /cluster/leader for the raft leader (`_find_leader`, the
reference's :401-416) and a new stream: a follower ends a stream at its
first report. Network errors retry forever, as the reference's loop.
The pulse is its own or the shorter one the master's replies name (the
reference's servers keep their own). An admin route that changes what
the master knows (volumes, mounted shards) replies once the leader has
acknowledged the new report. The EC holder map that remote shard
reads use comes from the master's /cluster/ec_shards through a
MasterClient cache (EC_HOLDERS_TTL); a fan-out that comes back short
reads the map again unless it is under EC_HOLDERS_RETRY_AGE old, in
place of the reference's KeepConnected subscription.

A write or delete on a replicated volume fans out to the replicas the
master lists (store_replicate.go:24) before it is acknowledged, and a
peer whose circuit breaker is open fails the fan-out at once (the
shared registry of utils/retry.py, which the HTTP client feeds); a
GET of a volume held elsewhere is redirected to a replica whose
breaker is not open when there is one. And
`volume_copy` pulls a replica's .dat/.idx for volume.fix.replication.
Peers come from a lookup cache (LOOKUP_TTL); a delete that a peer
answers with 404 looks the peers up again and reaches any new replica,
where the reference counts the 404 as done and a replica repaired
within the TTL keeps the needle.

The volume admin routes of the self-healing plane: volume_scrub (the
per-volume arm of cluster scrub), vacuum_check / vacuum_compact,
volume_mount / volume_unmount, volume_info, leave (stop heartbeating),
and the needle-level routes volume.check.disk and volume.fsck call
(needle_ids / needle_read / needle_write / needle_delete).

A write whose name or mime is compressible (utils/compression) is
stored gzipped with FLAG_IS_COMPRESSED when that saves 10%, as the
reference; the filer passes the name for such chunks.

The remote tier: `tier_backends` configures the backend storages a
volume's .dat can be uploaded to (`tier_upload` / `tier_download`, the
shell's volume.tier.upload / download), and `tier_offload` /
`tier_recall` move this server's shards of an EC volume to and from a
cold remote_storage client (the tiering controller's offload and
recall arms, volume.tier.offload / recall). Bulk tier bytes debit the
node-wide "tier" token bucket and count in
`tier_bytes_moved_total{dir}`; the bucket's fill and debt ride the
heartbeat as `tier_bw`. A GET runs on its connection's own thread
here, so a remote-backed volume's ranged reads never block another
request: the reference's guard that keeps them off its inline fast
path has no fast path to guard.

Every route runs behind the tracing, deadline and fault middlewares
(rpc/http.server_middlewares) with the reference's 256 MiB body cap;
/debug/traces and /debug/breakers serve this process's spans and
breakers.

The write path's guarantees (volume_server_handlers_write.go, the
reference's :952-1021): with `jwt_secret` every write and delete by fid
needs `Authorization: Bearer <token>` for that fid (utils/security.Guard;
a `_N` batch slot takes its base fid's token), else 401 with the
reason, and the fan-out forwards the client's token to the replicas,
whose guards check it again. Every append is acked under the server's
`commit_durability` (storage/commit.py): `buffered` after the append,
`batch` after the group-commit fsync that covers it, `sync` (and
`?fsync=true`, forwarded to the replicas) after an inline fsync; each
201 names its contract in X-Sw-Durability. The fan-out to the replicas
runs while the batch's fsync is pending, so only the ack waits on
both. `write_commit_seconds{stage=queue|fsync|replicate|ack}`,
`write_commit_batches_total`, `write_commit_fsyncs_total` and the
`write_commit_queue_depth` gauge are in /metrics; /debug/commit
serves the scheduler's snapshot.

The native data plane (native/dataplane.py, the reference's
`-dataplane native`): `enable_native(public_port, backend_port)` starts
the C++ front on the public port, hands it the write guard's secret
(`dp.config`), the ack contract (`dp.set_commit`) and this service's
share of -fault.spec (`dp.set_faults`), and attaches every plain
local-disk volume. The front then serves GET, HEAD, POST and DELETE by
fid itself — JWT check, group commit and replica fan-out included — and
relays everything else to this app on the loopback backend port. A
volume is re-attached after allocate, mount, copy, tier download and
ec.to_volume, and detached (`_dp_detached`) for vacuum and ec generate;
the tier detaches it itself. A refresher thread keeps each replicated
volume's peer list in the front (only a complete placement may fan out
natively). /status carries `native_dataplane` and `native_front`,
/debug/commit `native`, and /metrics the `native_front_*`,
`native_fronts_*{front=}` and `native_commit_*` families. Requests the
front answers never reach the Python taps (spans, workload sketches,
the in-process commit scheduler): run `-dataplane python` to see them.

The data verbs of the reference's handlers_read.go / _write.go: a
needle past STREAM_READ_LIMIT (1 MiB) is served in pread windows
(Volume.read_needle_streamed); a chunk-manifest needle (written with
?cm=true, as `upload -maxMB` does) is reassembled on GET and HEAD from
only the chunks a Range touches (?cm=false serves the manifest), and
its DELETE removes the chunks first; several ranges answer 206
multipart/byteranges; a multipart/form-data POST stores its first
part with the part's file name and type (`first_form_part` reads that
part as aiohttp's multipart reader hands it to the reference). The
admin routes
/admin/query (JSON lines of the projected, filtered documents),
/admin/volume_sync_status, /admin/volume_incremental_copy,
/admin/volume_tail and /admin/volume_tail_receive (what `backup` and
a tailing replica pull) and the status page at / and /ui/index.html
are the reference's. The native front relays each of these to this
app.

In-flight limits (the reference's -concurrentUploadLimitMB /
-concurrentDownloadLimitMB, volume_server.go:24-28): a GET or HEAD by
fid counts its needle's size, a POST or PUT its Content-Length, on a
byte tally (InFlightLimiter); while a tally is over its limit a new
request waits, and after 30 s it answers 429. A streamed reply keeps
its bytes on the tally until it is sent. /metrics exports both tallies
as `volume_server_in_flight_{upload,download}_bytes`. Requests the
native front answers are not counted, as in the reference.

Image renditions (images/, the reference's :798-840): a whole-body
GET with `crop_x1..crop_y2` crops a png, jpeg or gif first, then
`width` / `height` / `mode` resize it; a gzipped body is inflated
before. Without PIL the stored bytes are served, as the reference's.
"""
from __future__ import annotations

import contextlib
import contextvars
import gzip
import json
import os
import sys
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import numpy as np

from .. import images
from ..ec import geometry as geo
from ..ec.decoder import find_dat_size, write_dat_file, write_idx_from_ecx
from ..rpc.http import (App, Request, Response, debug_index_factory,
                        file_response, json_response, server_middlewares,
                        text_response)
from ..rpc import websocket
from ..rpc.httpclient import RequestException, session
from ..storage import backend
from ..storage import needle as ndl
from ..storage import types as t
from ..storage import volume_info as vinfo
from ..storage.commit import CommitScheduler
from ..storage.store import Store
from ..storage.super_block import ReplicaPlacement
from ..storage.volume import Volume
from ..utils import (compression, faults, glog, httprange, metrics,
                     ratelimit, retry, tracing)
from ..utils.security import Guard
from ..wdclient.client import MasterClient, find_leader

# timeout of a heartbeat stream's connect and of each send on it
HEARTBEAT_TIMEOUT = 5.0
# timeout of one ec/copy file pull (connect, read between pieces)
COPY_TIMEOUT = (5.0, 120.0)
# longest an admin reply waits for the master to acknowledge its change
SYNC_HEARTBEAT_TIMEOUT = 5.0
# per-peer cap for replica fan-out writes; clipped further by the
# request's remaining X-Sw-Deadline budget
REPLICATE_TIMEOUT = 30.0
# age limit of a cached volume lookup (replica peers, redirects)
LOOKUP_TTL = 10.0


def first_form_part(body: bytes, content_type: str
                    ) -> tuple[bytes, str, str] | None:
    """The first part of a multipart/form-data body, as aiohttp's
    `MultipartReader.next()` gives it to the reference's upload path:
    (raw bytes, its filename or "", its Content-Type or ""). None when
    the form holds no part; ValueError (-> 400) when the body is not a
    multipart form of the named boundary."""
    import email.message

    ctm = email.message.Message()
    ctm["Content-Type"] = content_type
    boundary = ctm.get_param("boundary")
    if not boundary or not isinstance(boundary, str):
        raise ValueError("multipart body without a boundary")
    delim = b"--" + boundary.encode("latin-1")
    at = body.find(delim)
    if at < 0:
        raise ValueError("multipart body without its boundary")
    at += len(delim)
    if body[at:at + 2] == b"--":
        return None  # the closing delimiter: an empty form
    if body[at:at + 2] != b"\r\n":
        raise ValueError("malformed multipart delimiter line")
    head_end = body.find(b"\r\n\r\n", at + 2)
    if head_end < 0:
        raise ValueError("multipart part without a header end")
    headers = email.message.Message()
    for line in body[at + 2:head_end].split(b"\r\n"):
        if line:
            # aiohttp's part-header parser decodes them so
            name, sep, value = line.decode(
                "utf-8", "surrogateescape").partition(":")
            if not sep:
                raise ValueError(f"malformed part header {line!r}")
            headers[name.strip()] = value.strip()
    data_start = head_end + 4
    end = body.find(b"\r\n" + delim, data_start)
    if end < 0:
        raise ValueError("multipart part without a closing boundary")
    filename = ""
    if headers.get("Content-Disposition"):
        filename = headers.get_filename("") or ""
    return body[data_start:end], filename, headers.get("Content-Type", "")


class InFlightLimiter:
    """Byte-based in-flight accounting with backpressure on a
    `threading.Condition` (the reference's InFlightLimiter, after
    volume_server.go:24-28 inFlightUpload/DownloadDataSize and its
    sync.Cond): a request WAITS while the tally is over the limit (so
    one oversized request cannot starve), is admitted as soon as it
    drops to the limit, and is refused after `timeout` seconds of
    waiting. limit <= 0 means account only (no backpressure)."""

    def __init__(self, limit: int, timeout: float = 30.0):
        self.limit = limit
        self.timeout = timeout
        self.value = 0
        self._cond = threading.Condition()

    def wait_admit(self) -> bool:
        if self.limit <= 0:
            return True
        with self._cond:
            return self._cond.wait_for(lambda: self.value <= self.limit,
                                       self.timeout)

    def add(self, n: int) -> None:
        with self._cond:
            self.value += n

    def release(self, n: int) -> None:
        with self._cond:
            self.value -= n
            self._cond.notify_all()


class _ReleasedOnClose:
    """A streamed reply's body that gives its bytes back to an
    InFlightLimiter once the reply is done: the reference's handler
    holds the tally while it writes a streamed body."""

    def __init__(self, stream, release):
        self._stream = stream
        self._release = release

    def __iter__(self):
        return iter(self._stream)

    def close(self) -> None:
        release, self._release = self._release, None
        try:
            close = getattr(self._stream, "close", None)
            if close is not None:
                close()
        finally:
            if release is not None:
                release()


class VolumeServer:
    # age limits of the cached EC holder map: any read, and the retry
    # after a fan-out that came back short
    EC_HOLDERS_TTL = 10.0
    EC_HOLDERS_RETRY_AGE = 1.0

    def __init__(self, store: Store, master_url: str,
                 data_center: str = "DefaultDataCenter",
                 rack: str = "DefaultRack",
                 pulse_seconds: float = 5.0,
                 disk_type: str = "hdd",
                 tier_backends: dict[str, dict] | None = None,
                 jwt_secret: str = "",
                 commit_durability: str = "buffered",
                 commit_max_delay: float = 0.002,
                 commit_max_bytes: int = 4 << 20,
                 concurrent_upload_limit: int = 256 << 20,
                 concurrent_download_limit: int = 256 << 20):
        self.store = store
        self.guard = Guard(jwt_secret)
        self._upload_flight = InFlightLimiter(concurrent_upload_limit)
        self._download_flight = InFlightLimiter(concurrent_download_limit)
        # the group-commit pipeline runs in every mode: buffered rides
        # it for the .idx flush cadence, batch gates acks on the
        # covering fsync (sync fsyncs inline and never enqueues)
        self.commit = CommitScheduler(durability=commit_durability,
                                      max_delay=commit_max_delay,
                                      max_bytes=commit_max_bytes)
        self.disk_type = disk_type
        self.masters = [
            m if m.startswith("http") else f"http://{m}"
            for m in (s.strip().rstrip("/") for s in master_url.split(","))
            if m]
        self.master_url = self.masters[0]
        self.data_center = data_center
        self.rack = rack
        self.pulse_seconds = pulse_seconds
        # native C++ data plane (native/dataplane.cc): set by
        # enable_native(); None = pure-Python serving
        self.dp = None
        self._dp_maint: dict[int, int] = {}  # vid -> open windows
        self._dp_maint_lock = threading.Lock()
        self._peer_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._hb_wake = threading.Event()
        # heartbeat generations: pokes asked for, and the newest one the
        # master acknowledged (poke_heartbeat(wait=True) waits on it)
        self._hb_cond = threading.Condition()
        self._hb_poked = 0
        self._hb_acked = 0
        self._hb_thread: threading.Thread | None = None
        self._hb_ws: websocket.WebSocket | None = None
        self._mc = MasterClient(self.masters)
        # (vid, key) of big needles the paged read path cannot serve
        self._no_stream: set[tuple[int, int]] = set()
        self._fetch_pool: ThreadPoolExecutor | None = None
        self._pool_lock = threading.Lock()
        self.store.remote_shards_fetcher = self._remote_shards_fetch_sync
        # tier destinations, e.g. {"s3.default": {"endpoint":..,"bucket":..}}
        # (the reference receives these from master.toml [storage.backend]
        # via the heartbeat response, volume_grpc_client_to_master.go)
        for name, conf in (tier_backends or {}).items():
            backend.configure_storage(name, **conf)
        self.app = self._build_app()

    def _build_app(self) -> App:
        # the reference's error middleware: malformed input answers 400
        app = App(bad_request=(json.JSONDecodeError, KeyError, ValueError,
                               TypeError),
                  middlewares=server_middlewares("volume"),
                  max_body=256 << 20)
        app.get("/", self.handle_ui)
        app.get("/ui/index.html", self.handle_ui)
        app.get("/status", self.handle_status)
        app.get("/metrics", self.handle_metrics)
        app.get("/debug", debug_index_factory("volume", {
            "/debug/traces": "recent spans recorded in-process",
            "/debug/breakers": "circuit breaker states",
            "/debug/ec": "EC codec router: probe curve + backends",
            "/debug/commit": "group-commit pipeline: window, "
                             "queue depth, durability mode",
        }))
        app.get("/debug/traces", tracing.handle_debug_traces)
        app.get("/debug/breakers", retry.handle_debug_breakers)
        app.get("/debug/ec", self.handle_debug_ec)
        app.get("/debug/commit", self.handle_debug_commit)
        app.post("/admin/assign_volume", self.handle_assign_volume)
        app.post("/admin/delete_volume", self.handle_delete_volume)
        app.post("/admin/mark_readonly", self.handle_mark_readonly)
        app.post("/admin/mark_writable", self.handle_mark_writable)
        app.post("/admin/volume_copy", self.handle_volume_copy)
        app.post("/admin/volume_mount", self.handle_volume_mount)
        app.post("/admin/volume_unmount", self.handle_volume_unmount)
        app.get("/admin/needle_ids", self.handle_needle_ids)
        app.get("/admin/needle_read", self.handle_needle_read)
        app.post("/admin/needle_write", self.handle_needle_write)
        app.post("/admin/needle_delete", self.handle_needle_delete)
        app.post("/admin/leave", self.handle_leave)
        app.post("/admin/volume_replication",
                 self.handle_volume_replication)
        app.post("/admin/volume_scrub", self.handle_volume_scrub)
        app.post("/admin/vacuum_check", self.handle_vacuum_check)
        app.post("/admin/vacuum_compact", self.handle_vacuum_compact)
        app.get("/admin/volume_info", self.handle_volume_info)
        app.post("/admin/tier_upload", self.handle_tier_upload)
        app.post("/admin/tier_download", self.handle_tier_download)
        app.post("/admin/tier_offload", self.handle_tier_offload)
        app.post("/admin/tier_recall", self.handle_tier_recall)
        app.post("/admin/ec/generate", self.handle_ec_generate)
        app.post("/admin/ec/rebuild", self.handle_ec_rebuild)
        app.post("/admin/ec/rebuild_partial",
                 self.handle_ec_rebuild_partial)
        app.post("/admin/ec/copy", self.handle_ec_copy)
        app.post("/admin/ec/mount", self.handle_ec_mount)
        app.post("/admin/ec/unmount", self.handle_ec_unmount)
        app.post("/admin/ec/delete", self.handle_ec_delete)
        app.post("/admin/ec/to_volume", self.handle_ec_to_volume)
        app.get("/admin/ec/shard_read", self.handle_ec_shard_read)
        app.get("/admin/copy_file", self.handle_copy_file)
        app.get("/admin/volume_sync_status",
                self.handle_volume_sync_status)
        app.get("/admin/volume_incremental_copy",
                self.handle_volume_incremental_copy)
        app.get("/admin/volume_tail", self.handle_volume_tail)
        app.post("/admin/volume_tail_receive",
                 self.handle_volume_tail_receive)
        app.post("/admin/query", self.handle_query)
        # `_N` suffix = assign?count batch slot (ParsePath:121-141)
        app.route("*", "/{fid:[0-9]+,[0-9a-fA-F]+(_[0-9]+)?}",
                  self.handle_fid)
        app.on_startup.append(self.start)
        app.on_cleanup.append(self.stop)
        return app

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        self._stop.clear()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="volume-heartbeat",
            daemon=True)
        self._hb_thread.start()

    def stop(self) -> None:
        """Stop heartbeating (the stream's close tells the master at
        once), drop the fetch pool, stop the native front, close the
        store."""
        self._stop_heartbeat()
        for attr in ("_hb_thread", "_peer_thread"):
            t = getattr(self, attr)
            if t is not None:
                t.join(timeout=10)
                setattr(self, attr, None)
        with self._pool_lock:
            pool, self._fetch_pool = self._fetch_pool, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
        self.disable_native()
        # what is queued commits before the volumes close
        self.commit.stop()
        self.store.close()

    # ------------------------------------------------------------------
    # the native data plane
    # ------------------------------------------------------------------
    def enable_native(self, public_port: int, backend_port: int,
                      workers: int = 2,
                      listen_ip: str = "0.0.0.0") -> int:
        """Start the C++ HTTP front on `public_port` (0 = ephemeral),
        relaying what it does not serve to this app listening on
        `backend_port`, and attach every eligible volume. Returns the
        bound public port."""
        from ..native.dataplane import DataPlane

        dp = DataPlane()
        port = dp.start(public_port, backend_port, workers,
                        listen_ip=listen_ip)
        dp.config(self.guard.enabled, self.guard.secret)
        dp.set_commit(self.commit.durability, self.commit.max_delay,
                      self.commit.max_bytes)
        # this service's share of -fault.spec, so requests the front
        # answers natively see the same chaos as relayed ones (all
        # zeros when no spec is set)
        dp.set_faults(*faults.native_params("volume"), seed=faults.seed())
        self.dp = dp
        for loc in self.store.locations:
            for v in list(loc.volumes.values()):
                self._dp_attach(v)
        self._peer_thread = threading.Thread(
            target=self._peer_refresh_loop, name="volume-native-peers",
            daemon=True)
        self._peer_thread.start()
        return port

    def disable_native(self) -> None:
        if self.dp is None:
            return
        for loc in self.store.locations:
            for v in list(loc.volumes.values()):
                v.detach_native()
        self.dp.stop()
        self.dp = None

    def _dp_attach(self, v) -> None:
        """Attach one volume to the native plane (no-op when the plane
        is off, the volume isn't a plain local-disk one, or another
        maintenance window still holds it)."""
        if self.dp is None or v is None:
            return
        with self._dp_maint_lock:
            if self._dp_maint.get(v.vid, 0) > 0:
                return  # a concurrent _dp_detached window is still open
            try:
                v.attach_native(self.dp)
            except OSError as e:
                glog.warning(
                    f"native attach of volume {v.vid} failed: {e}")

    @contextlib.contextmanager
    def _dp_detached(self, vid: int):
        """Exclusive Python ownership of a volume for maintenance
        (vacuum, ec generate); reattaches on exit only when the LAST
        overlapping window closes — two concurrent admin ops on one
        volume must not reattach it under each other."""
        with self._dp_maint_lock:
            self._dp_maint[vid] = self._dp_maint.get(vid, 0) + 1
        v = self.store.find_volume(vid)
        if v is not None:
            v.detach_native()
        try:
            yield v
        finally:
            with self._dp_maint_lock:
                left = self._dp_maint.get(vid, 1) - 1
                if left > 0:
                    self._dp_maint[vid] = left
                else:
                    self._dp_maint.pop(vid, None)
            if left <= 0:
                self._dp_attach(self.store.find_volume(vid))

    PEER_REFRESH_SECONDS = 2.0

    def _peer_refresh_loop(self) -> None:
        """Keep the native front's replica peer lists fresh so primary
        writes to replicated volumes fan out in C++ (the reference's
        masterClient vidMap feeding store_replicate.go:191). A fan-out
        failure marks the list stale — the front relays those writes to
        the Python path until the next push here."""
        while not self._stop.wait(self.PEER_REFRESH_SECONDS):
            dp = self.dp
            if dp is None:
                continue
            try:
                me = f"{self.store.ip}:{self.store.port}"
                for loc in self.store.locations:
                    for v in list(loc.volumes.values()):
                        if v.delegate is None:
                            continue
                        copies = \
                            v.super_block.replica_placement.copy_count
                        if copies <= 1:
                            continue
                        try:
                            if dp.peers_stale(v.vid):
                                # a peer died or moved: look it up anew
                                self._mc.invalidate(v.vid)
                        except KeyError:
                            continue  # detached meanwhile
                        peers = [loc_["url"] for loc_ in
                                 self._mc.lookup(v.vid, LOOKUP_TTL)
                                 if loc_["url"] != me]
                        # only a COMPLETE placement may fan out natively;
                        # anything short relays to Python, which fails
                        # the write rather than under-replicate
                        if len(peers) == copies - 1:
                            try:
                                dp.set_peers(v.vid, peers)
                            except KeyError:
                                pass
            except Exception as e:  # noqa: BLE001 — next tick retries
                glog.v(1, "native peer refresh failed: %s", e)

    # ------------------------------------------------------------------
    # heartbeat (volume_grpc_client_to_master.go:50 doHeartbeat)
    # ------------------------------------------------------------------
    def _find_leader(self) -> str:
        """The raft leader among self.masters, or the first master."""
        if len(self.masters) == 1:
            return self.masters[0]
        return find_leader(self.masters) or self.masters[0]

    def heartbeat_payload(self) -> dict:
        hb = self.store.collect_heartbeat()
        hb["data_center"] = self.data_center
        hb["rack"] = self.rack
        hb["disk_type"] = self.disk_type
        bw = ratelimit.snapshot().get("repair")
        if bw is not None:
            hb["repair_bw"] = bw
            metrics.gauge_set("repair_bw_fill_bytes", bw["fill"])
            metrics.gauge_set("repair_bw_debt_bytes", bw["debt"])
        tbw = ratelimit.snapshot().get("tier")
        if tbw is not None:
            hb["tier_bw"] = tbw
            metrics.gauge_set("tier_bw_fill_bytes", tbw["fill"])
            metrics.gauge_set("tier_bw_debt_bytes", tbw["debt"])
        return hb

    def _heartbeat_loop(self) -> None:
        while self.store.port == 0 and not self._stop.is_set():
            # ephemeral listen port not resolved yet (set by the
            # caller right after the server binds): don't register :0
            self._stop.wait(0.02)
        while not self._stop.is_set():
            self.master_url = self._find_leader()
            try:
                self._heartbeat_stream()
                # closed by the master (e.g. a follower refusing the
                # stream while no leader exists): re-probe
                glog.v(1, "heartbeat stream to %s closed; re-probing",
                       self.master_url)
            except Exception as e:  # noqa: BLE001 — retry forever
                glog.v(1, "heartbeat to %s failed: %s; retrying",
                       self.master_url, e)
            self._stop.wait(min(1.0, self.pulse_seconds))

    def _heartbeat_stream(self) -> None:
        """One stream to self.master_url: a report every pulse or poke,
        each answered within 4 pulses. Returns when the master closes
        it or the server stops; raises when the connect, a send or a
        reply fails."""
        ws = websocket.connect(f"{self.master_url}/ws/heartbeat",
                               timeout=HEARTBEAT_TIMEOUT)
        with self._hb_cond:
            self._hb_ws = ws
        try:
            while not self._stop.is_set():
                # cleared, and the generation read, BEFORE the report
                # is taken: a poke that lands after this point sends
                # another beat, none is lost
                self._hb_wake.clear()
                with self._hb_cond:
                    gen = self._hb_poked
                ws.send_json(self.heartbeat_payload())
                data = ws.receive(timeout=4 * self.pulse_seconds)
                if data is None:
                    return
                # beat at the master's pulse where it is shorter: what
                # it shows of this server (volumes, heat, bucket fill)
                # is then at most one of its pulses old
                pulse = json.loads(data).get("pulse_seconds")
                if pulse:
                    self.pulse_seconds = min(self.pulse_seconds, pulse)
                with self._hb_cond:
                    self._hb_acked = max(self._hb_acked, gen)
                    self._hb_cond.notify_all()
                self._hb_wake.wait(self.pulse_seconds)
        finally:
            with self._hb_cond:
                self._hb_ws = None
            ws.close()

    def _stop_heartbeat(self) -> None:
        """End the heartbeat loop and close its stream now."""
        self._stop.set()
        self._hb_wake.set()
        with self._hb_cond:
            ws = self._hb_ws
            self._hb_cond.notify_all()
        if ws is not None:
            ws.close()

    def poke_heartbeat(self, wait: bool = False) -> None:
        """Send a heartbeat now. With `wait`, return once the master
        has acknowledged a report taken after this call (at most
        SYNC_HEARTBEAT_TIMEOUT later): an admin reply then never races
        ahead of the master's view, so the shell's next lookup sees the
        change. The reference replies at once and lets the next beat
        catch up."""
        with self._hb_cond:
            self._hb_poked += 1
            want = self._hb_poked
        self._hb_wake.set()
        if wait:
            with self._hb_cond:
                self._hb_cond.wait_for(
                    lambda: self._hb_acked >= want or self._stop.is_set(),
                    timeout=SYNC_HEARTBEAT_TIMEOUT)

    # ------------------------------------------------------------------
    # repair bandwidth shaping: one node-wide "repair" token bucket
    # shared by every repair role this server plays (copy source via
    # ?bps= on copy_file/shard_read, copy destination via max_bps in
    # ec/copy bodies, partial-rebuild fetcher)
    # ------------------------------------------------------------------
    @staticmethod
    def _repair_throttle_sync(max_bps: float, n: int) -> None:
        if n <= 0:
            return
        metrics.counter_add("repair_bw_bytes_total", n)
        if max_bps and max_bps > 0:
            ratelimit.bucket("repair", max_bps).acquire(n)

    # ------------------------------------------------------------------
    # data plane: GET/HEAD/POST/PUT/DELETE /<vid>,<fid>
    # ------------------------------------------------------------------
    def handle_fid(self, req: Request) -> Response:
        fid = req.match_info["fid"]
        try:
            vid, key, cookie = t.parse_file_id(fid)
        except ValueError as e:
            return text_response(str(e), status=400)
        if req.method in ("GET", "HEAD"):
            # byte-based in-flight download backpressure
            # (volume_server.go:25 + the handlers' cond-var wait)
            return self._in_flight(
                self._download_flight, "too many in-flight downloads",
                self.store.needle_size(vid, key),
                lambda: self._read_fid(req, vid, key, cookie))
        if req.method in ("POST", "PUT"):
            return self._in_flight(
                self._upload_flight, "too many in-flight uploads",
                req.content_length or 0,
                lambda: self._write_fid(req, fid, vid, key, cookie))
        if req.method == "DELETE":
            return self._delete_fid(req, fid, vid, key)
        return Response(status=405)

    @staticmethod
    def _in_flight(flight: InFlightLimiter, refusal: str, est: int,
                   serve) -> Response:
        """Run `serve` with `est` bytes on the `flight` tally: 429 with
        `refusal` when the tally stays over its limit, and a streamed
        reply keeps its bytes on the tally until it is sent."""
        if not flight.wait_admit():
            return text_response(refusal, status=429)
        flight.add(est)
        resp = None
        try:
            resp = serve()
        finally:
            if resp is None or resp.stream is None:
                flight.release(est)
        if resp.stream is not None:
            resp.stream = _ReleasedOnClose(resp.stream,
                                           lambda: flight.release(est))
        return resp

    @staticmethod
    def _needle_headers(n) -> dict:
        headers = {"Etag": f'"{n.etag()}"'}
        if n.pairs:
            try:
                for k, v in json.loads(n.pairs).items():
                    if k.lower().startswith("seaweed-"):
                        headers[k] = str(v)
            except (json.JSONDecodeError, AttributeError):
                pass
        if n.last_modified:
            headers["Last-Modified"] = time.strftime(
                "%a, %d %b %Y %H:%M:%S GMT", time.gmtime(n.last_modified))
        return headers

    def _serve_chunked_manifest(self, req: Request, manifest_body: bytes,
                                is_gzip: bool, headers: dict) -> Response:
        """GET/HEAD of a chunk-manifest needle (the reference's
        :553-631): fetch only the bytes the request asks for — a HEAD
        reads nothing, a ranged read fetches its spans, and a full GET
        streams chunk by chunk (filer/stream.iter_content), so a
        multi-GB chunked file never sits in memory."""
        from ..filer.stream import iter_content, stream_content
        from ..operation.chunked_file import load_chunk_manifest

        cm = load_chunk_manifest(manifest_body, is_gzip)
        chunks = cm.as_file_chunks()
        total = cm.size
        headers["X-File-Store"] = "chunked"
        ct = "application/octet-stream"
        if cm.mime and not cm.mime.startswith(
                "application/octet-stream"):
            ct = cm.mime
        elif cm.name:
            import mimetypes

            ct = mimetypes.guess_type(cm.name)[0] \
                or "application/octet-stream"
        if req.method == "HEAD":
            headers["Content-Length"] = str(total)
            return Response(status=200, headers=headers, content_type=ct)

        def span(off: int, ln: int) -> bytes:
            return stream_content(self._lookup_fid_url, chunks, off, ln)

        rng = req.headers.get("Range")
        if rng:
            ranges = httprange.parse_range_header(rng, total)
            if ranges in (httprange.MALFORMED, httprange.UNSATISFIABLE):
                return Response(status=416, headers={
                    "Content-Range": f"bytes */{total}"})
            if ranges and ranges is not httprange.IGNORE:
                if len(ranges) == 1:
                    s, ln = ranges[0]
                    headers["Content-Range"] = httprange.content_range(
                        s, ln, total)
                    return Response(span(s, ln), 206, headers,
                                    content_type=ct)
                mbody, mct = httprange.multipart_byteranges(
                    [(s, ln, span(s, ln)) for s, ln in ranges], ct, total)
                headers["Content-Type"] = mct
                return Response(mbody, 206, headers)
        headers["Content-Type"] = ct
        return Response(status=200, headers=headers, length=total,
                        stream=iter_content(self._lookup_fid_url, chunks))

    def _lookup_fid_url(self, fid: str) -> str:
        """fid -> url through the master client (chunk-manifest
        reassembly and the delete cascade look up other volumes)."""
        return self._mc.lookup_file_id(fid, max_age=LOOKUP_TTL)

    def invalidate_fid(self, fid: str) -> None:
        """filer/stream.read_fid calls this on its lookup's owner when a
        chunk's read failed, then reads once more from a fresh lookup:
        a manifest read rides out a holder lost since the cached one
        (the reference reads its cached url only)."""
        self._mc.invalidate(int(fid.split(",")[0]))

    # needles past this many bytes are served in pread windows
    # (PagedReadLimit, volume_read.go:15)
    STREAM_READ_LIMIT = 1 << 20
    STREAM_WINDOW = 4 << 20
    # memo of big compressed / manifest needles, which the paged path
    # cannot serve: their repeat GETs skip its probe preads
    NO_STREAM_MAX = 4096

    def _maybe_stream_big_needle(self, req: Request, vid: int, key: int,
                                 cookie: int) -> Response | None:
        """Serve a plain needle past STREAM_READ_LIMIT in pread windows
        instead of reading it whole (the reference's :633-743). None =
        not eligible: compressed and manifest needles, image
        parameters, multi-range, readDeleted, EC and remote-backed
        volumes take the whole-body path."""
        if req.method != "GET":
            return None
        if set(req.query) & {"width", "height", "mode", "crop_x1",
                             "crop_y1", "crop_x2", "crop_y2",
                             "readDeleted", "cm"}:
            return None
        v = self.store.find_volume(vid)
        if v is None or getattr(v.dat, "remote", True) \
                or vid in self.store.ec_volumes:
            return None
        try:
            if self.store.needle_size(vid, key) <= self.STREAM_READ_LIMIT:
                return None
        except KeyError:
            return None
        if (vid, key) in self._no_stream:
            return None
        try:
            n, data_size, reader = v.read_needle_streamed(key, cookie)
        except KeyError:
            return Response(status=404)
        except PermissionError:
            return Response(status=403)
        except (ValueError, IOError):
            return None  # surprises re-run through the checked path
        if n.is_compressed or n.is_chunk_manifest:
            # the flags live after the data: known only once opened
            if len(self._no_stream) >= self.NO_STREAM_MAX:
                self._no_stream.clear()
            self._no_stream.add((vid, key))
            return None
        headers = self._needle_headers(n)
        ct = n.mime.decode() if n.mime else "application/octet-stream"
        start_i, length = 0, data_size
        status = 200
        rng = req.headers.get("Range")
        if rng:
            ranges = httprange.parse_range_header(rng, data_size)
            if ranges in (httprange.MALFORMED, httprange.UNSATISFIABLE):
                return Response(status=416, headers={
                    "Content-Range": f"bytes */{data_size}"})
            if ranges and ranges is not httprange.IGNORE:
                if len(ranges) > 1:
                    return None  # multipart assembly: whole-body path
                start_i, length = ranges[0]
                status = 206
                headers["Content-Range"] = httprange.content_range(
                    start_i, length, data_size)
        headers["Content-Type"] = ct
        metrics.counter_add("volume_server_paged_reads_total", 1)

        def windows():
            t0 = time.perf_counter()
            sent = 0
            while sent < length:
                try:
                    piece = reader(start_i + sent,
                                   min(self.STREAM_WINDOW, length - sent))
                except (ValueError, OSError):
                    # a vacuum commit closed the captured handle: end
                    # short, the client sees a cut body (a retry reads
                    # the compacted volume)
                    return
                if not piece:
                    return
                yield piece
                sent += len(piece)
            metrics.histogram_observe("volume_server_read_seconds",
                                      time.perf_counter() - t0)

        return Response(status=status, headers=headers, length=length,
                        stream=windows())

    def _read_fid(self, req: Request, vid: int, key: int,
                  cookie: int) -> Response:
        start = time.perf_counter()
        if not self.store.has_volume(vid) and \
                vid not in self.store.ec_volumes:
            # not local: redirect via master lookup (handlers_read.go:48)
            urls = [loc["url"] for loc in
                    self._mc.lookup(vid, max_age=LOOKUP_TTL)]
            if urls:
                # redirect clients away from a replica whose breaker
                # is open
                healthy = [u for u in urls
                           if retry.breaker_for(u).state != retry.OPEN]
                return Response(status=301, headers={
                    "Location": f"http://{(healthy or urls)[0]}/"
                                f"{req.match_info['fid']}"})
            return text_response(f"volume {vid} not found", status=404)
        streamed = self._maybe_stream_big_needle(req, vid, key, cookie)
        if streamed is not None:
            return streamed
        try:
            n = self.store.read_needle(
                vid, key, cookie,
                read_deleted=req.query.get("readDeleted") == "true")
        except KeyError:
            return Response(status=404)
        except PermissionError:
            return Response(status=403)
        except (ValueError, IOError) as e:
            return text_response(str(e), status=500)
        metrics.histogram_observe("volume_server_read_seconds",
                                  time.perf_counter() - start)
        headers = self._needle_headers(n)
        body = n.data
        is_gzip = n.is_compressed
        ct = n.mime.decode() if n.mime else "application/octet-stream"
        if n.is_chunk_manifest and req.query.get("cm") != "false":
            # a chunked file: the body is a manifest of sub-fids,
            # reassembled here (handlers_read.go:254
            # tryHandleChunkedFile); ?cm=false serves the manifest
            try:
                return self._serve_chunked_manifest(
                    req, body, is_gzip, headers)
            except (ValueError, KeyError, LookupError, OSError) as e:
                return text_response(f"chunked manifest: {e}",
                                     status=500)
        body, is_gzip = self._rendition(req, body, is_gzip, ct)
        rng = req.headers.get("Range")
        if is_gzip:
            # ranges address the original bytes: inflate for them and
            # for clients that do not take gzip
            if rng or "gzip" not in (req.headers.get("Accept-Encoding")
                                     or ""):
                body = gzip.decompress(body)
            else:
                headers["Content-Encoding"] = "gzip"
        headers["Content-Type"] = ct
        if rng and req.method != "HEAD":
            # one range answers 206 with its bytes, several answer 206
            # multipart/byteranges (common.go processRangeRequest)
            ranges = httprange.parse_range_header(rng, len(body))
            if ranges in (httprange.MALFORMED, httprange.UNSATISFIABLE):
                return Response(status=416, headers={
                    "Content-Range": f"bytes */{len(body)}"})
            if ranges and ranges is not httprange.IGNORE:
                if len(ranges) == 1:
                    start_i, length = ranges[0]
                    headers["Content-Range"] = httprange.content_range(
                        start_i, length, len(body))
                    return Response(body[start_i:start_i + length], 206,
                                    headers)
                mbody, mct = httprange.multipart_byteranges(
                    [(s, ln, body[s:s + ln]) for s, ln in ranges], ct,
                    len(body))
                headers["Content-Type"] = mct  # carries the boundary
                return Response(mbody, 206, headers)
        return Response(body, 200, headers)

    @staticmethod
    def _rendition(req: Request, body: bytes, is_gzip: bool,
                   ct: str) -> tuple[bytes, bool]:
        """The image renditions (handlers_read.go:294-353, the
        reference's :798-840): crop first, then resize, as its
        conditionallyCropImages -> conditionallyResizeImages chain; a
        compressed image is inflated before PIL sees it. -> (body,
        still gzipped)."""
        q = req.query
        if "crop_x2" in q or "crop_y2" in q:
            try:
                x1 = int(q.get("crop_x1", "0") or 0)
                y1 = int(q.get("crop_y1", "0") or 0)
                x2 = int(q.get("crop_x2", "0") or 0)
                y2 = int(q.get("crop_y2", "0") or 0)
            except ValueError:
                x1 = y1 = x2 = y2 = 0
            croppable = ct.split(";")[0].strip().lower() in (
                "image/png", "image/jpeg", "image/gif")
            if x2 > x1 and y2 > y1 and croppable:
                if is_gzip:
                    body, is_gzip = gzip.decompress(body), False
                with tracing.span("images.cropped"):
                    body = images.cropped(body, ct, x1, y1, x2, y2)
        if "width" in q or "height" in q:
            try:
                want_w = int(q.get("width", "0") or 0)
                want_h = int(q.get("height", "0") or 0)
            except ValueError:
                want_w = want_h = 0  # the reference ignores bad sizes
            if images.is_image_mime(ct) and (want_w or want_h):
                if is_gzip:
                    body, is_gzip = gzip.decompress(body), False
                with tracing.span("images.resized"):
                    body = images.resized(body, ct, want_w, want_h,
                                          q.get("mode", ""))
        return body, is_gzip

    def _write_fid(self, req: Request, fid: str, vid: int, key: int,
                   cookie: int) -> Response:
        start = time.perf_counter()
        try:
            self.guard.check(req.headers.get("Authorization"), fid)
        except PermissionError as e:
            return text_response(str(e), status=401)
        if not self.store.has_volume(vid):
            return text_response(f"volume {vid} not found", status=404)
        ctype = req.content_type
        n = ndl.Needle(id=key, cookie=cookie)
        if ctype.startswith("multipart/"):
            # a form upload (curl -F, the reference's `upload`): the
            # first part is the file (needle_parse_upload.go)
            part = first_form_part(req.read(),
                                   req.headers.get("Content-Type") or "")
            if part is None:
                return text_response("empty multipart body", status=400)
            n.data, filename, pct = part
            if filename:
                n.name = filename.encode()
            if pct and pct != "application/octet-stream":
                n.mime = pct.encode()
        else:
            n.data = req.read()
            if ctype and ctype != "application/octet-stream":
                n.mime = ctype.encode()
        is_replicate = req.query.get("type") == "replicate"
        if req.query.get("name"):
            if is_replicate:
                # server-to-server: latin-1 maps bytes 1:1 so the
                # primary's exact name bytes survive the query string
                n.name = req.query["name"].encode("latin-1", "replace")
            else:
                n.name = req.query["name"].encode()  # client text
        if is_replicate and req.query.get("mime"):
            n.mime = req.query["mime"].encode("latin-1", "replace")
        if req.query.get("ts"):
            n.last_modified = int(req.query["ts"])
        if req.query.get("cm") in ("true", "1"):
            # the body is a chunk manifest of sub-fids
            # (needle_parse_upload.go:186 IsChunkedFile): reads
            # reassemble it, deletes cascade to the chunks
            n.flags |= ndl.FLAG_IS_CHUNK_MANIFEST
        # custom metadata pairs: Seaweed-* headers stored as JSON in
        # the needle (needle_parse_upload.go parsePairs)
        pairs = {k: v for k, v in req.headers.items()
                 if k.lower().startswith("seaweed-")}
        if pairs:
            n.pairs = json.dumps(pairs, separators=(",", ":")).encode()
            n.flags |= ndl.FLAG_HAS_PAIRS
        # transparent compression (needle_parse_upload.go): compressible
        # names and mimes are stored gzipped when that saves >= 10%
        if req.query.get("compressed") == "1" and \
                compression.is_gzipped(n.data):
            # replica fan-out ships the primary's stored bytes verbatim
            # (gzip magic required: the param is client-forgeable and a
            # false flag would make the needle unreadable forever)
            n.flags |= ndl.FLAG_IS_COMPRESSED
        elif "gzip" in (req.headers.get("Content-Encoding") or "") and \
                compression.is_gzipped(n.data):
            n.flags |= ndl.FLAG_IS_COMPRESSED
        elif compression.is_compressible(
                n.mime.decode("utf-8", "replace"),
                n.name.decode("utf-8", "replace")):
            body, did = compression.maybe_gzip(n.data)
            if did:
                n.data = body
                n.flags |= ndl.FLAG_IS_COMPRESSED
        durability = self.commit.durability
        want_fsync = req.query.get("fsync") in ("true", "1")
        ticket = None
        try:
            self.store.write_needle(vid, n)
            v_w = self.store.find_volume(vid)
            if durability == "sync" or want_fsync:
                # the per-write fsync, and the ?fsync=true contract (the
                # filer forwards its own ?fsync / filer.conf rule here)
                if v_w is not None:
                    v_w.sync()
            elif v_w is not None:
                # the group-commit pipeline: in batch mode the ack
                # below waits for the covering fsync; buffered mode
                # never waits but feeds the batched .idx flushes
                ticket = self.commit.submit(v_w, len(n.data))
        except KeyError:
            return Response(status=404)
        except PermissionError as e:
            return text_response(str(e), status=409)
        # the replica fan-out (store_replicate.go:24) runs now, while
        # the committer's fsync of this batch is pending: only the ack
        # waits on both, network and disk overlap
        err = None
        if not is_replicate:
            t_repl = time.perf_counter()
            err = self._replicate(req, fid, n.data, "POST", needle=n)
            metrics.histogram_observe(
                "write_commit_seconds", time.perf_counter() - t_repl,
                {"stage": "replicate"})
        if durability == "batch" and ticket is not None:
            ticket.wait()
            if ticket.error is not None:
                return text_response(f"commit failed: {ticket.error}",
                                     status=500)
        if err:
            return text_response(err, status=500)
        self.poke_heartbeat()
        elapsed = time.perf_counter() - start
        metrics.histogram_observe("volume_server_write_seconds", elapsed)
        metrics.histogram_observe("write_commit_seconds", elapsed,
                                  {"stage": "ack"})
        return json_response(
            {"name": n.name.decode("utf-8", "replace") if n.name else "",
             "size": len(n.data), "eTag": n.etag()}, status=201,
            headers={"X-Sw-Durability": "sync" if want_fsync
                     else durability})

    def _delete_fid(self, req: Request, fid: str, vid: int,
                    key: int) -> Response:
        try:
            self.guard.check(req.headers.get("Authorization"), fid)
        except PermissionError as e:
            return text_response(str(e), status=401)
        manifest_size = 0
        # a chunk manifest's chunks are deleted FIRST
        # (volume_server_handlers_write.go:112-124), so a manifest-only
        # delete orphans no data. Only the primary cascades: a
        # ?type=replicate delete is the fan-out of one that already did
        if req.query.get("type") != "replicate":
            try:
                n = self.store.read_needle(vid, key)
            except (KeyError, PermissionError, ValueError, IOError):
                n = None  # absent or unreadable: the plain delete decides
            if n is not None and n.is_chunk_manifest:
                from ..operation.chunked_file import (delete_chunks,
                                                      load_chunk_manifest)

                try:
                    cm = load_chunk_manifest(n.data, n.is_compressed)
                except ValueError as e:
                    return json_response(
                        {"error": f"load chunks manifest: {e}"},
                        status=500)
                failed = delete_chunks(self._lookup_fid_url, cm)
                if failed:
                    return json_response(
                        {"error": f"delete chunks failed: {failed}"},
                        status=500)
                manifest_size = cm.size
        try:
            size = self.store.delete_needle(vid, key)
        except KeyError:
            return Response(status=404)
        size = manifest_size or size
        if req.query.get("type") != "replicate":
            err = self._replicate(req, fid, b"", "DELETE")
            if err:
                return text_response(err, status=500)
        return json_response({"size": size}, status=202)

    def _replicate(self, req: Request, fid: str, data: bytes, method: str,
                   needle: "ndl.Needle | None" = None) -> str | None:
        """Fan a write or delete out to the replica peers the master
        lists, excluding self (DistributedOperation,
        store_replicate.go:171). The secondary write carries the
        needle's identity — name, mime, mtime, pairs — so replicas never
        diverge. -> an error string, or None when every peer took it."""
        vid = int(fid.split(",")[0])
        v = self.store.find_volume(vid)
        # single-copy volumes have no peers: no master round trip
        if v is not None and v.super_block.replica_placement.copy_count <= 1:
            return None
        me = f"{self.store.ip}:{self.store.port}"
        peers = [loc["url"] for loc in self._mc.lookup(vid, LOOKUP_TTL)
                 if loc["url"] != me]
        if not peers:
            # peers are EXPECTED: an empty lookup must fail the write,
            # not ack it under-replicated
            self._mc.invalidate(vid)
            return f"volume {vid}: no replica peers resolvable"
        params = {"type": "replicate"}
        if req.query.get("fsync") in ("true", "1"):
            params["fsync"] = "true"
        headers = {}
        if req.headers.get("Authorization"):
            headers["Authorization"] = req.headers["Authorization"]
        if needle is not None:
            if needle.name:
                params["name"] = needle.name.decode("latin-1")
            if needle.last_modified:
                params["ts"] = str(needle.last_modified)
            if needle.mime:
                # query param, not Content-Type: non-ASCII mime bytes
                # would be re-encoded on the other side
                params["mime"] = needle.mime.decode("latin-1")
            if needle.pairs:
                headers.update({k: str(val) for k, val in
                                json.loads(needle.pairs).items()
                                if k.lower().startswith("seaweed-")})
            if needle.is_compressed:
                # marker param, not Content-Encoding: the replica
                # appends these bytes verbatim
                params["compressed"] = "1"
            if needle.is_chunk_manifest:
                # the replica stores the manifest flag too, so a read
                # or delete there reassembles or cascades as here
                params["cm"] = "true"
        budget = retry.remaining(default=REPLICATE_TIMEOUT) or \
            REPLICATE_TIMEOUT
        timeout = (5.0, max(0.1, min(REPLICATE_TIMEOUT, budget)))
        done: set[str] = set()
        for fresh in (False, True):
            if fresh:
                # a peer answered a delete with 404: the needle is gone
                # there, or the cached peer no longer holds the volume
                # (a replica moved or was repaired elsewhere). Look the
                # peers up again and fan out to the new ones, so a
                # repaired replica never misses a delete.
                self._mc.invalidate(vid)
                peers = [loc["url"] for loc in
                         self._mc.lookup(vid, LOOKUP_TTL)
                         if loc["url"] != me and loc["url"] not in done]
            not_found = False
            for peer in peers:
                url = f"http://{peer}/{fid}"
                # the client consults the peer's breaker on every
                # attempt: an open one refuses before any connect
                try:
                    if method == "POST":
                        r = session().post(url, params=params, data=data,
                                           headers=headers,
                                           timeout=timeout)
                    else:
                        r = session().delete(url, params=params,
                                             headers=headers,
                                             timeout=timeout)
                except retry.BreakerOpenError:
                    self._mc.invalidate(vid)
                    return f"replicate to {peer}: circuit open"
                except RequestException as e:
                    self._mc.invalidate(vid)
                    return f"replicate to {peer}: {e}"
                if method != "POST" and r.status_code == 404:
                    not_found = True
                elif r.status_code >= 300:
                    self._mc.invalidate(vid)
                    return f"replicate to {peer}: {r.status_code}"
                done.add(peer)
            if not not_found:
                break
        return None

    # ------------------------------------------------------------------
    # admin: volume lifecycle
    # ------------------------------------------------------------------
    def handle_assign_volume(self, req: Request) -> Response:
        body = req.json()
        vid = int(body["volume"])
        try:
            self.store.add_volume(vid, body.get("collection", ""),
                                  body.get("replication", "000"),
                                  bytes(body.get("ttl", (0, 0))))
        except FileExistsError as e:
            return json_response({"error": str(e)}, status=409)
        self._dp_attach(self.store.find_volume(vid))
        self.poke_heartbeat(wait=True)
        return json_response({"volume": vid})

    def handle_delete_volume(self, req: Request) -> Response:
        body = req.json()
        try:
            self.store.delete_volume(int(body["volume"]))
        except KeyError as e:
            return json_response({"error": str(e)}, status=404)
        self.poke_heartbeat(wait=True)
        return json_response({})

    def _mark(self, req: Request, read_only: bool) -> Response:
        body = req.json()
        try:
            self.store.mark_readonly(int(body["volume"]), read_only)
        except KeyError as e:
            return json_response({"error": str(e)}, status=404)
        self.poke_heartbeat(wait=True)
        return json_response({})

    def handle_mark_readonly(self, req: Request) -> Response:
        return self._mark(req, True)

    def handle_mark_writable(self, req: Request) -> Response:
        return self._mark(req, False)

    def handle_volume_copy(self, req: Request) -> Response:
        """VolumeCopy (volume_grpc_copy.go): pull .dat/.idx from a source
        server and mount the volume locally."""
        body = req.json()
        vid = int(body["volume"])
        collection = body.get("collection", "")
        source = body["source"]
        max_bps = float(body.get("max_bps", 0) or 0)
        if self.store.has_volume(vid):
            return json_response({"error": "volume exists"}, status=409)
        loc = min(self.store.locations, key=lambda l: l.volume_count)
        base = loc.base_name(collection, vid)
        copied = 0
        for ext in (".dat", ".idx"):
            resp = session().get(
                f"http://{source}/admin/copy_file",
                params={"volume": vid, "collection": collection,
                        "ext": ext, "bps": max_bps},
                timeout=COPY_TIMEOUT, stream=True)
            try:
                if resp.status_code != 200:
                    return json_response(
                        {"error": f"copy {ext} from {source}: "
                                  f"{resp.status_code}"}, status=502)
                with open(base + ext, "wb") as f:
                    for piece in resp.iter_content(1 << 20):
                        # destination-side debit of the shared repair
                        # bucket; the source debits its own via ?bps=
                        self._repair_throttle_sync(max_bps, len(piece))
                        f.write(piece)
                        copied += len(piece)
            finally:
                resp.close()
        loc.volumes[vid] = Volume(loc.dir, collection, vid)
        self._dp_attach(loc.volumes[vid])
        self.poke_heartbeat(wait=True)
        return json_response({"volume": vid, "bytes": copied})

    def handle_volume_unmount(self, req: Request) -> Response:
        """VolumeUnmount (volume_grpc_admin.go): close and forget a
        volume, keeping its files — the offline half of volume.move and
        scrub's quarantine."""
        body = req.json()
        try:
            self.store.unmount_volume(int(body["volume"]))
        except KeyError as e:
            return json_response({"error": str(e)}, status=404)
        self.poke_heartbeat(wait=True)
        return json_response({})

    def handle_volume_mount(self, req: Request) -> Response:
        body = req.json()
        try:
            self.store.mount_volume(int(body["volume"]))
        except KeyError as e:
            return json_response({"error": str(e)}, status=404)
        self._dp_attach(self.store.find_volume(int(body["volume"])))
        self.poke_heartbeat(wait=True)
        return json_response({})

    def handle_leave(self, req: Request) -> Response:
        """volume.server.leave (VolumeServerLeave): end the heartbeat
        stream, so the master drops this node; reads go on being served
        until the server is shut down."""
        self._stop_heartbeat()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=10)
            self._hb_thread = None
        return json_response({"left": True})

    # ------------------------------------------------------------------
    # admin: needle level (volume.check.disk, volume.fsck)
    # ------------------------------------------------------------------
    def handle_needle_read(self, req: Request) -> Response:
        """Raw needle record for replica sync (volume.check.disk)."""
        try:
            blob = self.store.read_raw_needle(int(req.query["volume"]),
                                              int(req.query["key"]))
        except KeyError as e:
            return json_response({"error": str(e)}, status=404)
        return Response(blob, content_type="application/octet-stream")

    def handle_needle_write(self, req: Request) -> Response:
        """Append a raw needle record pulled from a peer replica.
        ?force=1 overwrites an existing live needle (content-divergence
        repair where the newer record wins)."""
        try:
            key = self.store.append_raw_needle(
                int(req.query["volume"]), req.read(),
                req.query.get("force") == "1")
        except KeyError as e:
            return json_response({"error": str(e)}, status=404)
        except (ValueError, PermissionError) as e:
            return json_response({"error": str(e)}, status=400)
        return json_response({"key": key})

    def handle_needle_delete(self, req: Request) -> Response:
        """Tombstone a needle by key without cookie check or replica
        fan-out — tombstone propagation for volume.check.disk."""
        body = req.json()
        try:
            self.store.delete_needle(int(body["volume"]), int(body["key"]))
        except KeyError as e:
            return json_response({"error": str(e)}, status=404)
        except PermissionError as e:
            return json_response({"error": str(e)}, status=403)
        return json_response({})

    def handle_needle_ids(self, req: Request) -> Response:
        """Live needle-id census of one volume — the server side of
        volume.fsck / volume.check.disk."""
        vid = int(req.query["volume"])
        try:
            live, deleted = self.store.needle_ids(vid)
        except KeyError as e:
            return json_response({"error": str(e)}, status=404)
        return json_response(
            {"volume": vid, "needles": [[k, s] for k, s in live],
             "deleted": deleted})

    # ------------------------------------------------------------------
    # admin: scrub and vacuum
    # ------------------------------------------------------------------
    def handle_volume_scrub(self, req: Request) -> Response:
        """Full-read needle verification of one local volume (the
        per-volume arm of cluster scrub)."""
        body = req.json()
        vid = int(body["volume"])
        v = self.store.find_volume(vid)
        if v is None:
            return text_response(f"volume {vid}", status=404)
        return json_response(v.scrub(int(body.get("limit", 0))))

    def handle_vacuum_check(self, req: Request) -> Response:
        body = req.json()
        v = self.store.find_volume(int(body["volume"]))
        if v is None:
            return json_response({"error": "not found"}, status=404)
        return json_response({"garbage_ratio": v.garbage_ratio()})

    def handle_vacuum_compact(self, req: Request) -> Response:
        body = req.json()
        vid = int(body["volume"])
        v = self.store.find_volume(vid)
        if v is None:
            return json_response({"error": "not found"}, status=404)
        # vacuum swaps .dat/.idx wholesale: the native plane hands the
        # volume back to Python for the duration
        with self._dp_detached(vid):
            v.compact()
        self.poke_heartbeat(wait=True)
        return json_response({"size": v.content_size()})

    def handle_volume_info(self, req: Request) -> Response:
        vid = int(req.query["volume"])
        v = self.store.find_volume(vid)
        if v is None:
            return json_response({"error": "not found"}, status=404)
        remote = v.volume_info.remote_file() if v.volume_info else None
        return json_response({
            "volume": vid, "size": v.content_size(),
            "file_count": v.nm.file_count,
            "deleted_bytes": v.nm.deleted_bytes,
            "garbage_ratio": v.garbage_ratio(),
            "read_only": v.read_only,
            "remote": ({"backend": remote.backend_name, "key": remote.key,
                        "file_size": remote.file_size}
                       if remote else None),
        })

    # ------------------------------------------------------------------
    # admin: tiering (volume_grpc_tier_upload.go / _download.go)
    # ------------------------------------------------------------------
    def handle_tier_upload(self, req: Request) -> Response:
        body = req.json()
        v = self.store.find_volume(int(body["volume"]))
        if v is None:
            return json_response({"error": "not found"}, status=404)
        keep = bool(body.get("keepLocalDatFile", False))
        try:
            adopt = body.get("adopt")
            if adopt:
                # another replica already uploaded the object: just
                # record it and drop the local copy
                rf = vinfo.RemoteFile(**adopt)
                v.tier_adopt(rf, keep)
            else:
                storage = backend.get_storage(
                    body.get("dest", "s3.default"))
                rf = v.tier_upload(storage, keep)
        except (KeyError, ValueError) as e:
            return json_response({"error": str(e)}, status=400)
        self.poke_heartbeat(wait=True)
        return json_response({
            "volume": v.vid, "backend": rf.backend_name, "key": rf.key,
            "backend_type": rf.backend_type, "backend_id": rf.backend_id,
            "file_size": rf.file_size, "modified_time": rf.modified_time})

    def handle_tier_download(self, req: Request) -> Response:
        body = req.json()
        v = self.store.find_volume(int(body["volume"]))
        if v is None:
            return json_response({"error": "not found"}, status=404)
        try:
            v.tier_download(bool(body.get("deleteRemote", True)))
        except (ValueError, KeyError) as e:
            return json_response({"error": str(e)}, status=400)
        self._dp_attach(v)  # local disk again: back onto the fast path
        self.poke_heartbeat(wait=True)
        return json_response({"volume": v.vid, "size": v.content_size()})

    # ------------------------------------------------------------------
    # admin: EC-shard cold tier (master/tiering.py offload/recall arms)
    # ------------------------------------------------------------------
    @staticmethod
    def _tier_throttle_sync(max_bps: float, direction: str):
        """Per-shard shaping hook for bulk tier movement: debit the
        node-wide "tier" token bucket (so overlapping offloads and
        recalls share one cap) and account the bytes by direction."""
        def throttle(n: int) -> None:
            if n <= 0:
                return
            metrics.counter_add("tier_bytes_moved_total", n,
                                {"dir": direction})
            if max_bps and max_bps > 0:
                ratelimit.bucket("tier", max_bps).acquire(n)
        return throttle

    def handle_tier_offload(self, req: Request) -> Response:
        """Move this server's local shards of one EC volume to the
        remote tier named by `remote` (a remote_storage client conf);
        reads keep flowing through the remote-backed shard objects."""
        body = req.json()
        vid = int(body["volume"])
        remote_conf = body["remote"]
        if not isinstance(remote_conf, dict) or "type" not in remote_conf:
            return json_response(
                {"error": "remote must be a client conf with a type"},
                status=400)
        max_bps = float(body.get("max_bps", 0) or 0)
        try:
            result = self.store.tier_offload_ec(
                vid, remote_conf, self._tier_throttle_sync(max_bps,
                                                           "offload"))
        except KeyError as e:
            return json_response({"error": str(e)}, status=404)
        except (ValueError, OSError) as e:
            return json_response({"error": str(e)}, status=502)
        self.poke_heartbeat(wait=True)
        return json_response(result)

    def handle_tier_recall(self, req: Request) -> Response:
        """Bring this server's offloaded shards back to local disk
        (the first half of a recall; the controller then runs
        ec.decode to re-materialize the plain volume)."""
        body = req.json()
        vid = int(body["volume"])
        max_bps = float(body.get("max_bps", 0) or 0)
        try:
            result = self.store.tier_recall_ec(
                vid, self._tier_throttle_sync(max_bps, "recall"),
                bool(body.get("deleteRemote", True)))
        except KeyError as e:
            return json_response({"error": str(e)}, status=404)
        except (ValueError, OSError) as e:
            return json_response({"error": str(e)}, status=502)
        self.poke_heartbeat(wait=True)
        return json_response(result)

    def handle_volume_replication(self, req: Request) -> Response:
        """The replica placement of a volume — rewritten in the super
        block when the body carries `replication` (VolumeConfigure,
        command_volume_configure_replication.go)."""
        body = req.json()
        v = self.store.find_volume(int(body["volume"]))
        if v is None:
            return json_response({"error": "not found"}, status=404)
        if "replication" in body:
            try:
                rp = ReplicaPlacement.parse(body["replication"])
            except ValueError as e:
                return json_response({"error": str(e)}, status=400)
            v.super_block.replica_placement = rp
            v.dat.write_at(v.super_block.to_bytes(), 0)
            dp = self.dp
            if dp is not None and v.delegate is not None:
                # the native front fans out by its own copy of the
                # placement: a volume moved to 001 must stop acking
                # from C++ with one copy. Its peer list is emptied, so
                # its writes relay to _replicate until the refresher
                # pushes the new complete placement
                self._mc.invalidate(v.vid)
                try:
                    dp.set_replicas(v.vid, rp.copy_count > 1)
                    dp.set_peers(v.vid, [])
                except KeyError:
                    pass  # detached meanwhile: the next attach reads it
            self.poke_heartbeat(wait=True)
        return json_response(
            {"replication": str(v.super_block.replica_placement)})

    # ------------------------------------------------------------------
    # admin: erasure coding (volume_grpc_erasure_coding.go)
    # ------------------------------------------------------------------
    def handle_ec_generate(self, req: Request) -> Response:
        body = req.json()
        vid = int(body["volume"])
        try:
            # the encoder reads the .dat and .idx whole: Python owns
            # the volume while it runs
            with self._dp_detached(vid):
                self.store.generate_ec_shards(vid, body.get("codec", ""))
        except KeyError as e:
            return json_response({"error": str(e)}, status=404)
        return json_response({"volume": vid})

    def handle_ec_rebuild(self, req: Request) -> Response:
        body = req.json()
        vid = int(body["volume"])
        try:
            rebuilt = self.store.rebuild_ec_shards(vid)
        except (KeyError, ValueError) as e:
            return json_response({"error": str(e)}, status=400)
        rebuilt_bytes = 0
        base = self.store._ec_base(vid)
        if base:
            for sid in rebuilt:
                try:
                    rebuilt_bytes += os.path.getsize(
                        base + geo.shard_ext(sid))
                except OSError:
                    pass
        return json_response({"rebuilt_shards": rebuilt,
                              "rebuilt_bytes": rebuilt_bytes})

    def handle_ec_rebuild_partial(self, req: Request) -> Response:
        """Traffic-minimal shard reconstruction: stream only the k
        shard ranges the codec needs through the first-k-wins fan-out
        and rebuild the missing shard(s) chunk by chunk, instead of
        borrowing every surviving shard file (the ec/copy + ec/rebuild
        path). Bytes fetched count as
        repair_read_bytes_total{mode="partial"}."""
        body = req.json()
        vid = int(body["volume"])
        collection = body.get("collection", "")
        missing = sorted({int(s) for s in body["shard_ids"]})
        max_bps = float(body.get("max_bps", 0) or 0)
        chunk = int(body.get("chunk", 4 << 20))
        if not missing or chunk <= 0:
            return json_response(
                {"error": "need shard_ids and chunk > 0"}, status=400)
        try:
            result = self._partial_ec_rebuild_sync(vid, collection,
                                                   missing, max_bps, chunk)
        except (KeyError, ValueError) as e:
            return json_response({"error": str(e)}, status=400)
        self.store.mount_ec_shards(vid, collection, missing)
        self.poke_heartbeat(wait=True)
        return json_response(result)

    def _loc_for_ec(self, vid: int):
        """The disk location new files of EC volume `vid` belong in:
        beside its mounted shards, else the first location."""
        ecv = self.store.ec_volumes.get(vid)
        if ecv is not None:
            for cand in self.store.locations:
                if cand.dir == ecv.dir:
                    return cand
        return self.store.locations[0]

    def _partial_ec_rebuild_sync(self, vid: int, collection: str,
                                 missing: list[int], max_bps: float,
                                 chunk: int) -> dict:
        from ..ec.backend import ReedSolomon
        from ..ec.encoder import code_of

        loc = self._loc_for_ec(vid)
        ecv = self.store.ec_volumes.get(vid)
        base = loc.base_name(collection, vid)
        me = f"{self.store.ip}:{self.store.port}"
        # an admin operation plans from the master's current map, not
        # from a cache a degraded read filled before the shards moved
        self._mc.invalidate(vid)
        holders = {int(s): [h for h in urls if h != me]
                   for s, urls in self._ec_holders(vid).items()}
        local_sids = sorted(s for s in (ecv.shards if ecv else {})
                            if s not in missing)
        remote_sids = sorted(s for s, urls in holders.items()
                             if urls and s not in missing
                             and s not in local_sids)
        hosts: list[str] = []
        for urls in holders.values():
            for u in urls:
                if u not in hosts:
                    hosts.append(u)
        net_bytes = 0
        # the sorted needle index (and codec sidecar) must exist
        # locally before the rebuilt shard can be mounted
        if not os.path.exists(base + ".ecx"):
            for ext in (".ecx", ".vif"):
                blob = None
                for h in hosts:
                    try:
                        r = session().get(
                            f"http://{h}/admin/copy_file",
                            params={"volume": vid,
                                    "collection": collection,
                                    "ext": ext, "bps": max_bps},
                            timeout=60)
                    except RequestException:
                        continue
                    if r.status_code == 200:
                        blob = r.content
                        break
                if blob is None:
                    if ext == ".ecx":
                        raise ValueError(f"vid {vid}: no holder "
                                         f"serves .ecx")
                    try:  # no .vif anywhere = default RS(10,4)
                        os.unlink(base + ".vif")
                    except FileNotFoundError:
                        pass
                    continue
                with open(base + ext, "wb") as f:
                    f.write(blob)
                self._repair_throttle_sync(max_bps, len(blob))
                net_bytes += len(blob)
        code = code_of(base)
        k, m = code.k, code.m
        avail = sorted(set(local_sids) | set(remote_sids))
        # the code's repair plan picks the read set: an LRC single
        # loss streams its locality group (fan-in k/l), and even a
        # global solve gets an INDEPENDENT input row set
        plan = None if code.is_rs else code.repair_plan(missing, avail)
        if code.is_rs:
            if len(avail) < k:
                raise ValueError(
                    f"vid {vid}: {len(avail)} shards reachable, "
                    f"need {k}")
        elif plan is None:
            raise ValueError(
                f"vid {vid}: shards {avail} cannot rebuild "
                f"{code.spec} shards {missing}")
        shard_size = None
        if local_sids:
            shard_size = ecv.shards[local_sids[0]].size
        else:
            for s in remote_sids:
                for h in holders[s]:
                    try:
                        r = session().get(
                            f"http://{h}/admin/ec/shard_read",
                            params={"volume": vid, "shard": s,
                                    "stat": "1"}, timeout=10)
                    except RequestException:
                        continue
                    if r.status_code == 200:
                        shard_size = int(r.json()["size"])
                        break
                if shard_size is not None:
                    break
        if not shard_size:
            raise ValueError(f"vid {vid}: cannot stat shard size")
        rs = ReedSolomon(k, m, backend=self.store.ec_backend, code=code)
        # planned reads (structured codes): a planned remote that does
        # not answer is marked dead and the plan recomputed without it;
        # only when no plan survives does the chunk fall back to the
        # generic rank-k gather
        dead: set[int] = set()
        plan_local = plan_remote = None

        def split_plan() -> None:
            nonlocal plan_local, plan_remote
            plan_local = [s for s in plan.reads if s in local_sids]
            plan_remote = [s for s in plan.reads if s not in local_sids]

        if plan is not None:
            split_plan()
        fetch_deadline = max(30.0, self.store.ec_read_deadline)

        def gather_planned(off: int, n: int):
            nonlocal plan, net_bytes
            while plan is not None:
                rows: dict[int, object] = {}
                for s in plan_local:
                    rows[s] = np.frombuffer(
                        ecv.shards[s].read_at(off, n), dtype=np.uint8)
                if not plan_remote:
                    return rows
                # pace the loop BEFORE the fan-out so the burst the
                # fetch admits is already paid for
                self._repair_throttle_sync(max_bps, len(plan_remote) * n)
                fetched = self._remote_shards_fetch_sync(
                    vid, plan_remote, off, n, need=len(plan_remote),
                    deadline=fetch_deadline, bps=max_bps)
                net_bytes += len(fetched) * n
                short = [s for s in plan_remote if s not in fetched]
                if not short:
                    for s in plan_remote:
                        rows[s] = np.frombuffer(fetched[s], dtype=np.uint8)
                    return rows
                dead.update(short)
                plan = code.repair_plan(
                    missing, [s for s in avail if s not in dead])
                if plan is not None:
                    split_plan()
            return None

        def gather_generic(off: int, n: int) -> dict:
            """Span-growing gather over ALL reachable shards: rank k
            over the code's encode rows, which for RS is first-k."""
            nonlocal net_bytes
            from ..ops import rs_matrix

            rows: dict[int, object] = {}
            span: list[int] = []

            def grows(s: int) -> bool:
                if len(span) >= k:
                    return False
                if code.is_rs:
                    return True
                return rs_matrix.rank_of(code, span + [s]) > len(span)

            for s in local_sids:
                if grows(s):
                    rows[s] = np.frombuffer(
                        ecv.shards[s].read_at(off, n), dtype=np.uint8)
                    span.append(s)
            cands = list(remote_sids)
            while len(span) < k and cands:
                need = k - len(span)
                self._repair_throttle_sync(max_bps, need * n)
                fetched = self._remote_shards_fetch_sync(
                    vid, cands, off, n, need=need,
                    deadline=fetch_deadline, bps=max_bps)
                net_bytes += len(fetched) * n
                if not fetched:
                    break
                for s in sorted(fetched):
                    if grows(s):
                        rows[s] = np.frombuffer(fetched[s], dtype=np.uint8)
                        span.append(s)
                cands = [s for s in cands if s not in fetched]
            if len(span) < k:
                raise ValueError(
                    f"vid {vid}: only {len(rows)}/{k} shard "
                    f"ranges at +{off}")
            return rows

        written = 0
        files = {s: open(base + geo.shard_ext(s), "wb") for s in missing}
        try:
            for off in range(0, shard_size, chunk):
                n = min(chunk, shard_size - off)
                rows = gather_planned(off, n) if plan is not None \
                    else None
                if rows is None:
                    rows = gather_generic(off, n)
                rec = rs.reconstruct(rows, missing=missing)
                for s in missing:
                    row = np.asarray(rec[s], dtype=np.uint8).tobytes()
                    files[s].write(row)
                    written += len(row)
        except BaseException:
            for s, f in files.items():
                f.close()
                try:  # never leave a torn shard for ec.mount to find
                    os.unlink(base + geo.shard_ext(s))
                except FileNotFoundError:
                    pass
            raise
        for f in files.values():
            f.close()
        metrics.counter_add("repair_read_bytes_total", net_bytes,
                            {"mode": "partial"})
        metrics.counter_add("ec_repair_read_bytes_by_code_total",
                            net_bytes, {"mode": "partial",
                                        "code": code.spec})
        return {"rebuilt_shards": missing, "rebuilt_bytes": written,
                "read_bytes": net_bytes}

    def handle_ec_copy(self, req: Request) -> Response:
        """VolumeEcShardsCopy (:126): pull shard files (and optionally
        .ecx/.ecj) from a source server's copy_file endpoint."""
        body = req.json()
        vid = int(body["volume"])
        collection = body.get("collection", "")
        shard_ids = body["shard_ids"]
        source = body["source"]
        max_bps = float(body.get("max_bps", 0) or 0)
        # repair=true marks shards borrowed for a FULL-stripe rebuild,
        # so repair_read_bytes_total{mode} can contrast full vs partial
        is_repair = bool(body.get("repair", False))
        base = self._loc_for_ec(vid).base_name(collection, vid)
        exts = [geo.shard_ext(sid) for sid in shard_ids]
        if body.get("copy_ecx", True):
            exts += [".ecx"]
        if body.get("copy_ecj", False):
            exts += [".ecj"]
        # the .vif sidecar names the volume's EC codec: a wide-code
        # shard set copied without it would be misread as RS(10,4)
        exts += [".vif"]
        copied = 0
        for ext in exts:
            resp = session().get(
                f"http://{source}/admin/copy_file",
                params={"volume": vid, "collection": collection,
                        "ext": ext, "bps": max_bps},
                timeout=COPY_TIMEOUT, stream=True)
            try:
                if resp.status_code == 404 and ext in (".ecj", ".vif"):
                    if ext == ".vif":
                        # source has no codec sidecar (default RS(10,4)):
                        # a stale local one would poison this shard set
                        try:
                            os.unlink(base + ext)
                        except FileNotFoundError:
                            pass
                    continue
                if resp.status_code != 200:
                    return json_response(
                        {"error": f"copy {ext} from {source}: "
                                  f"{resp.status_code}"}, status=502)
                with open(base + ext, "wb") as f:
                    for piece in resp.iter_content(1 << 20):
                        self._repair_throttle_sync(max_bps, len(piece))
                        f.write(piece)
                        copied += len(piece)
            finally:
                resp.close()
        if is_repair and copied:
            metrics.counter_add("repair_read_bytes_total", copied,
                                {"mode": "full"})
            from ..ec.encoder import code_of

            metrics.counter_add("ec_repair_read_bytes_by_code_total",
                                copied, {"mode": "full",
                                         "code": code_of(base).spec})
        return json_response({"copied": exts, "bytes": copied})

    def handle_ec_mount(self, req: Request) -> Response:
        body = req.json()
        self.store.mount_ec_shards(int(body["volume"]),
                                   body.get("collection", ""),
                                   body["shard_ids"])
        self.poke_heartbeat(wait=True)
        return json_response({})

    def handle_ec_unmount(self, req: Request) -> Response:
        body = req.json()
        self.store.unmount_ec_shards(int(body["volume"]), body["shard_ids"])
        self.poke_heartbeat(wait=True)
        return json_response({})

    def handle_ec_delete(self, req: Request) -> Response:
        body = req.json()
        self.store.delete_ec_shards(int(body["volume"]),
                                    body.get("shard_ids"))
        self.poke_heartbeat(wait=True)
        return json_response({})

    def handle_ec_to_volume(self, req: Request) -> Response:
        """VolumeEcShardsToVolume (:407): decode shards back to .dat/.idx
        and mount as a normal volume."""
        body = req.json()
        vid = int(body["volume"])
        collection = body.get("collection", "")
        ecv = self.store.ec_volumes.get(vid)
        if ecv is None:
            return json_response({"error": "ec volume not mounted"},
                                 status=404)
        base = ecv.base_name()
        dat_size = find_dat_size(base)
        write_dat_file(base, dat_size, backend=self.store.ec_backend)
        write_idx_from_ecx(base)
        self.store.delete_ec_shards(vid, None)
        for loc in self.store.locations:
            if os.path.dirname(base) == loc.dir:
                loc.volumes[vid] = Volume(loc.dir, collection, vid)
                self._dp_attach(loc.volumes[vid])
        self.poke_heartbeat(wait=True)
        return json_response({"volume": vid})

    def handle_ec_shard_read(self, req: Request) -> Response:
        """VolumeEcShardRead (:309): a byte range of a local shard."""
        vid = int(req.query["volume"])
        sid = int(req.query["shard"])
        offset = int(req.query.get("offset", 0))
        size = int(req.query.get("size", -1))
        ecv = self.store.ec_volumes.get(vid)
        shard = ecv.shards.get(sid) if ecv else None
        if shard is None:
            return text_response("shard not found", status=404)
        if req.query.get("stat") == "1":
            # size probe: the partial rebuilder plans its chunk loop
            # from a peer's shard length without moving shard bytes
            return json_response({"volume": vid, "shard": sid,
                                  "size": shard.size})
        if size < 0:
            size = shard.size - offset
        data = shard.read_at(offset, size)
        bps = float(req.query.get("bps", 0) or 0)
        if bps > 0:  # repair pull: shape the source side too
            self._repair_throttle_sync(bps, len(data))
        return Response(data, content_type="application/octet-stream")

    def handle_copy_file(self, req: Request) -> Response:
        """CopyFile rpc (volume_grpc_copy.go): stream any volume/shard
        file by extension."""
        vid = int(req.query["volume"])
        collection = req.query.get("collection", "")
        ext = req.query["ext"]
        if ext not in {".dat", ".idx", ".ecx", ".ecj", ".vif"} and \
                not (ext.startswith(".ec") and ext[3:].isdigit()):
            return text_response(f"bad ext {ext}", status=400)
        if ext in (".dat", ".idx"):
            v = self.store.find_volume(vid)
            if v is not None:
                v.sync()
        path = None
        for loc in self.store.locations:
            cand = loc.base_name(collection, vid) + ext
            if os.path.exists(cand):
                path = cand
                break
        if path is None:
            return text_response(f"{ext} not found", status=404)
        # ?bps= marks a repair pull and shapes the SOURCE side against
        # this node's shared repair bucket
        bps = float(req.query.get("bps", 0) or 0)
        pace = (lambda n: self._repair_throttle_sync(bps, n)) \
            if bps > 0 else None
        return file_response(path, pace=pace)

    # ------------------------------------------------------------------
    # degraded reads: fetch remote shard intervals (called from store
    # threads, store_ec.go:299 readRemoteEcShardInterval)
    # ------------------------------------------------------------------
    def _ec_holders(self, vid: int, max_age: float | None = None) -> dict:
        """{shard_id_str: [host:port, ...]} from the TTL cache."""
        shards = self._mc.lookup_ec(
            vid, max_age=self.EC_HOLDERS_TTL if max_age is None else max_age)
        return {str(sid): urls for sid, urls in shards.items()}

    def _fetch_shard_from_holders(self, vid: int, sid: int,
                                  holders: list, offset: int, size: int,
                                  deadline_t: float,
                                  bps: float = 0.0) -> bytes | None:
        for holder in holders:
            remaining = deadline_t - time.monotonic()
            if remaining <= 0:
                return None
            params = {"volume": vid, "shard": sid,
                      "offset": offset, "size": size}
            if bps > 0:  # repair pull: let the source shape its side
                params["bps"] = bps
            try:
                r = session().get(
                    f"http://{holder}/admin/ec/shard_read",
                    params=params, timeout=min(remaining, 10.0))
            except RequestException:
                continue
            if r.status_code == 200:
                return r.content
        return None

    def _pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._fetch_pool is None:
                self._fetch_pool = ThreadPoolExecutor(
                    max_workers=16, thread_name_prefix="ec-fetch")
            return self._fetch_pool

    def _remote_shards_fetch_sync(self, vid: int, sids: list, offset: int,
                                  size: int, need: int,
                                  deadline: float,
                                  bps: float = 0.0) -> dict:
        """Concurrent first-k-wins shard-range fan-out for degraded
        reads (store_ec.go:349-393): every candidate shard is requested
        at once; returns as soon as `need` arrive or the deadline
        passes. When every request came back and fewer than `need`
        succeeded, the holder map may be stale: unless it was read in
        the last EC_HOLDERS_RETRY_AGE seconds it is read again from the
        master, and the shards not yet fetched are asked for once more."""
        deadline_t = time.monotonic() + deadline
        out: dict[int, bytes] = {}
        for max_age in (self.EC_HOLDERS_TTL, self.EC_HOLDERS_RETRY_AGE):
            pending = self._fan_out(vid, [s for s in sids if s not in out],
                                    offset, size, need, deadline_t, bps,
                                    out, max_age)
            if len(out) >= need or pending or \
                    time.monotonic() >= deadline_t:
                break
        return out

    def _fan_out(self, vid: int, sids: list, offset: int, size: int,
                 need: int, deadline_t: float, bps: float,
                 out: dict, max_age: float) -> int:
        """One first-k-wins round into `out`; -> requests still pending
        when it stopped (abandoned; bounded by their timeouts)."""
        me = f"{self.store.ip}:{self.store.port}"
        holders_map = self._ec_holders(vid, max_age)
        pool = self._pool()
        futs = {}
        for sid in sids:
            holders = [h for h in holders_map.get(str(sid), []) if h != me]
            if holders:
                # copy_context: pool.submit drops contextvars, which
                # would lose the trace and the deadline
                futs[pool.submit(
                    contextvars.copy_context().run,
                    self._fetch_shard_from_holders, vid, sid, holders,
                    offset, size, deadline_t, bps)] = sid
        pending = set(futs)
        while pending and len(out) < need:
            remaining = deadline_t - time.monotonic()
            if remaining <= 0:
                break
            done, pending = wait(pending, timeout=remaining,
                                 return_when=FIRST_COMPLETED)
            for fut in done:
                data = fut.result()
                if data is not None:
                    out[futs[fut]] = data
        for fut in pending:
            fut.cancel()
        return len(pending)

    # ------------------------------------------------------------------
    def handle_debug_ec(self, req: Request) -> Response:
        from ..ec import backend as ec_backend

        snap = ec_backend.probe_snapshot()
        # per-volume view: which code each mounted EC volume runs
        vols = {}
        for vid, ecv in sorted(self.store.ec_volumes.items()):
            code = ecv.code
            vols[str(vid)] = {
                "code": code.spec, "kind": code.kind, "k": code.k,
                "locals": code.n_local, "globals": code.n_global,
                "shards": sorted(ecv.shards),
            }
        snap["volumes"] = vols
        return json_response(snap)

    def handle_metrics(self, req: Request) -> Response:
        """Prometheus exposition, the master federator's scrape target;
        the disk gauges are recomputed at scrape time (the reference's
        volume/EC size gauges, stats/metrics.go + store_ec.go:41)."""
        by_col: dict[str, dict] = {}
        for loc in self.store.locations:
            for v in list(loc.volumes.values()):
                s = by_col.setdefault(v.collection,
                                      {"n": 0, "bytes": 0, "files": 0})
                s["n"] += 1
                s["bytes"] += v.content_size()
                s["files"] += v.nm.file_count
        for col, s in by_col.items():
            lab = {"collection": col or "default"}
            metrics.gauge_set("volume_server_volumes", s["n"], lab)
            metrics.gauge_set("volume_server_total_disk_size",
                              s["bytes"], lab)
            metrics.gauge_set("volume_server_file_count", s["files"], lab)
        ec_by_col: dict[str, dict] = {}
        for ecv in list(self.store.ec_volumes.values()):
            s = ec_by_col.setdefault(ecv.collection,
                                     {"shards": 0, "bytes": 0})
            n = ecv.shard_bits().count()
            s["shards"] += n
            if n:
                s["bytes"] += n * ecv.shard_size
        for col, s in ec_by_col.items():
            lab = {"collection": col or "default"}
            metrics.gauge_set("volume_server_ec_shards", s["shards"], lab)
            metrics.gauge_set("volume_server_ec_bytes", s["bytes"], lab)
        metrics.gauge_set(
            "volume_server_max_volumes",
            sum(l.max_volumes for l in self.store.locations))
        metrics.gauge_set("volume_server_in_flight_upload_bytes",
                          self._upload_flight.value)
        metrics.gauge_set("volume_server_in_flight_download_bytes",
                          self._download_flight.value)
        metrics.gauge_set("write_commit_queue_depth",
                          self.commit.snapshot()["queue_depth"])
        # the CUDA kernel's launches in this process (its wrapper's
        # count), once a codec has loaded it: a seal or rebuild run on
        # this server is read here by whoever drove it
        codec_cuda = sys.modules.get(
            __package__.rsplit(".", 1)[0] + ".ops.codec_cuda")
        if codec_cuda is not None:
            metrics.gauge_set("cuda_kernel_launches",
                              codec_cuda.coded_matmul.launches,
                              {"kernel": "coded_matmul"})
        return text_response(metrics.render()
                             + self._native_front_exposition()
                             + self._native_commit_exposition())

    def _native_commit_exposition(self) -> str:
        """The native front's commit-queue counters: monotonic snapshots
        owned by the C library, rendered directly (counter_add would
        count them again on every scrape)."""
        dp = self.dp
        if dp is None:
            return ""
        st = dp.commit_stats()
        lines = []
        for name in ("batches", "fsyncs", "writes", "bytes"):
            lines.append(f"# TYPE native_commit_{name}_total counter")
            lines.append(f"native_commit_{name}_total {st[name]}")
        lines.append("# TYPE native_commit_fsync_seconds_total counter")
        lines.append("native_commit_fsync_seconds_total "
                     f"{st['fsync_seconds']:.6f}")
        lines.append("# TYPE native_commit_queue_depth gauge")
        lines.append(f"native_commit_queue_depth {st['queue_depth']}")
        return "\n".join(lines) + "\n"

    def _native_front_exposition(self) -> str:
        """The native fronts' response and byte counters, rendered
        directly as _native_commit_exposition. `native_front_*` is the
        volume front; `native_fronts_*{front=...}` breaks all three
        roles out — the S3 and filer fronts run in this process
        (combined-server mode shares the one C library), so their
        counters federate through this volume server's /metrics."""
        dp = self.dp
        if dp is None:
            return ""
        from ..native import dataplane as dpmod

        st = dp.front_stats()
        lines = ["# TYPE native_front_requests_total counter"]
        for code in ("2xx", "3xx", "4xx", "5xx"):
            lines.append(f'native_front_requests_total{{code="{code}"}} '
                         f'{st[code]}')
        lines.append("# TYPE native_front_bytes_total counter")
        for direction in ("in", "out"):
            lines.append(
                f'native_front_bytes_total{{direction="{direction}"}} '
                f'{st["bytes_" + direction]}')
        per_role = [(front, dp.role_front_stats(role)) for front, role in
                    (("volume", dpmod.ROLE_VOLUME), ("s3", dpmod.ROLE_S3),
                     ("filer", dpmod.ROLE_FILER))]
        lines.append("# TYPE native_fronts_requests_total counter")
        for front, rst in per_role:
            for code in ("2xx", "3xx", "4xx", "5xx"):
                lines.append(
                    f'native_fronts_requests_total{{front="{front}"'
                    f',code="{code}"}} {rst[code]}')
        lines.append("# TYPE native_fronts_bytes_total counter")
        for front, rst in per_role:
            for direction in ("in", "out"):
                lines.append(
                    f'native_fronts_bytes_total{{front="{front}"'
                    f',direction="{direction}"}} '
                    f'{rst["bytes_" + direction]}')
        return "\n".join(lines) + "\n"

    def handle_debug_commit(self, req: Request) -> Response:
        """The group-commit pipeline's snapshot: durability mode, the
        open window, queue depth, counters, batch size and bytes — and
        the native front's commit counters when the C++ plane serves
        the hot path (its commit queue is a second instance of the same
        design, so both views matter)."""
        snap = self.commit.snapshot()
        dp = self.dp
        if dp is not None:
            snap["native"] = dp.commit_stats()
        return json_response(snap)

    # ------------------------------------------------------------------
    # server-side query (volume_grpc_query.go, query/json)
    # ------------------------------------------------------------------
    def handle_query(self, req: Request) -> Response:
        """VolumeServer.Query rpc: scan the JSON bodies of local
        needles and stream back only the projected, filtered records
        (JSON lines); compressed needles are inflated first."""
        from ..query import Filter, query_json_bytes
        from ..query.json_query import OPS

        body = req.json()
        fids = body.get("from", {}).get("file_ids") or body.get("fids")
        if not fids:
            return json_response({"error": "query needs fids"},
                                 status=400)
        selections = body.get("selections", [])
        fd = body.get("filter", {})
        filt = Filter(field=fd.get("field", ""),
                      op=fd.get("operand", fd.get("op", "=")),
                      value=str(fd.get("value", "")))
        # everything that can refuse the query is checked before the
        # 200 goes out
        if filt.op not in OPS:
            return json_response({"error": f"bad operand {filt.op!r}"},
                                 status=400)
        try:
            parsed = [t.parse_file_id(fid) for fid in fids]
        except ValueError as e:
            return json_response({"error": str(e)}, status=400)

        def rows():
            for vid, key, cookie in parsed:
                v = self.store.find_volume(vid)
                if v is None:
                    continue  # only local volumes are queried
                try:
                    n = v.read_needle(key, cookie)
                except (KeyError, PermissionError, ValueError):
                    continue
                payload = n.data
                if n.is_compressed:
                    try:
                        payload = compression.ungzip(payload)
                    except OSError:
                        continue
                out = [json.dumps(doc, separators=(",", ":"))
                       for doc in query_json_bytes(payload, selections,
                                                   filt)]
                if out:
                    yield ("\n".join(out) + "\n").encode()

        return Response(status=200, content_type="application/x-ndjson",
                        stream=rows())

    # ------------------------------------------------------------------
    # incremental sync and tail (volume_backup.go, volume_grpc_tail.go)
    # ------------------------------------------------------------------
    TAIL_POLL = 0.1     # seconds between a tail's looks at the .dat
    SEGMENT = 1 << 20   # bytes per read of a streamed .dat span

    def handle_volume_sync_status(self, req: Request) -> Response:
        """VolumeSyncStatus rpc: tail offset, compact revision and last
        append stamp, what an incremental copy negotiates with."""
        v = self.store.find_volume(int(req.query["volume"]))
        if v is None:
            return text_response("volume not found", status=404)
        v.sync()
        return json_response(v.sync_status())

    def handle_volume_incremental_copy(self, req: Request) -> Response:
        """VolumeIncrementalCopy rpc: the raw .dat records appended
        strictly after since_ns."""
        v = self.store.find_volume(int(req.query["volume"]))
        if v is None:
            return text_response("volume not found", status=404)
        since_ns = int(req.query.get("since_ns", "0"))
        v.sync()
        offset = v.offset_for_append_at_ns(since_ns)
        end = v.dat.size()

        def segments(offset=offset):
            # capped at the captured end: later appends must not run
            # past the declared length, and a compaction swapping the
            # file ends the stream short
            while offset < end:
                chunk = v.read_segment(offset,
                                       min(self.SEGMENT, end - offset))
                if not chunk:
                    raise ConnectionResetError(
                        f"volume {v.vid} changed under incremental copy")
                yield chunk
                offset += len(chunk)

        return Response(status=200, content_type="application/octet-stream",
                        length=end - offset, stream=segments())

    def handle_volume_tail(self, req: Request) -> Response:
        """VolumeTailSender rpc: the records after since_ns, then new
        appends as they land, until idle for idle_timeout seconds."""
        v = self.store.find_volume(int(req.query["volume"]))
        if v is None:
            return text_response("volume not found", status=404)
        since_ns = int(req.query.get("since_ns", "0"))
        idle_timeout = float(req.query.get("idle_timeout", "3"))
        start = v.offset_for_append_at_ns(since_ns)

        def follow():
            offset, idle = start, 0.0
            while idle < idle_timeout:
                # size() flushes the write buffer: enough to read what
                # was appended, without an fsync per poll
                end = v.dat.size()
                if end < offset:
                    return  # compaction rewrote history: end the tail
                if offset < end:
                    idle = 0.0
                    while offset < end:
                        chunk = v.read_segment(
                            offset, min(self.SEGMENT, end - offset))
                        if not chunk:
                            return  # the volume was swapped mid-read
                        yield chunk
                        offset += len(chunk)
                else:
                    time.sleep(self.TAIL_POLL)
                    idle += self.TAIL_POLL

        return Response(status=200, content_type="application/octet-stream",
                        stream=follow())

    def handle_volume_tail_receive(self, req: Request) -> Response:
        """VolumeTailReceiver rpc: follow another server's tail of a
        volume and append its records to the local copy."""
        body = req.json()
        vid = int(body["volume"])
        source = body["source"]
        v = self.store.find_volume(vid)
        if v is None:
            return json_response({"error": "volume not found"},
                                 status=404)
        since_ns = int(body.get("since_ns", v.last_append_at_ns))
        idle_timeout = float(body.get("idle_timeout", 3))
        # appending raw segments needs the tail to itself (a
        # multi-record append, truncated on error): the volume is off
        # the native plane for the whole stream
        with self._dp_detached(vid):
            applied, left = 0, bytearray()
            with session().get(f"http://{source}/admin/volume_tail",
                               params={"volume": vid, "since_ns": since_ns,
                                       "idle_timeout": idle_timeout},
                               stream=True,
                               timeout=(5.0, idle_timeout + 60.0)) as r:
                if r.status_code != 200:
                    return json_response(
                        {"error": f"tail from {source}: {r.status_code}"},
                        status=502)
                for chunk in r.iter_content(1 << 20):
                    left.extend(chunk)
                    whole = ndl.whole_records_prefix(left, v.version)
                    if whole:
                        applied += v.append_raw_segment(
                            bytes(memoryview(left)[:whole]))
                        del left[:whole]
        if left:
            return json_response(
                {"error": f"tail stream ended mid-record "
                          f"({len(left)} trailing bytes)",
                 "applied": applied}, status=502)
        self.poke_heartbeat()
        return json_response({"applied": applied})

    def handle_ui(self, req: Request) -> Response:
        """Status page (server/volume_server_ui/ equivalent)."""
        import html as _html

        hb = self.store.collect_heartbeat()
        rows = "".join(
            f"<tr><td>{v['id']}</td>"
            f"<td>{_html.escape(v['collection']) or '-'}</td>"
            f"<td>{v['size']:,}</td><td>{v['file_count']}</td>"
            f"<td>{v['delete_count']}</td>"
            f"<td>{'ro' if v['read_only'] else 'rw'}</td>"
            f"<td>{v['replica_placement']}</td></tr>"
            for v in hb["volumes"])
        ec_rows = "".join(
            f"<tr><td>{e['id']}</td>"
            f"<td>{_html.escape(e['collection']) or '-'}</td>"
            f"<td>{e['shard_bits']:014b}</td></tr>"
            for e in hb["ec_shards"])
        return text_response(
            f"<html><body><h1>seaweedfs-tpu volume server</h1>"
            f"<p>{_html.escape(hb['public_url'])} &middot; master "
            f"{self.master_url} &middot; "
            f"{len(hb['volumes'])} volumes, "
            f"{len(hb['ec_shards'])} ec volumes</p>"
            f"<table border=1 cellpadding=4><tr><th>id</th>"
            f"<th>collection</th><th>size</th><th>files</th>"
            f"<th>deleted</th><th>mode</th><th>rp</th></tr>"
            f"{rows}</table>"
            f"<h2>ec shards</h2>"
            f"<table border=1 cellpadding=4><tr><th>id</th>"
            f"<th>collection</th><th>shard bits</th></tr>"
            f"{ec_rows}</table>"
            f"<p><a href='/metrics'>metrics</a> &middot; "
            f"<a href='/status'>status</a></p></body></html>",
            content_type="text/html; charset=utf-8")

    def handle_status(self, req: Request) -> Response:
        out = {"Version": "seaweedfs-tpu-torch",
               **self.store.collect_heartbeat()}
        dp = self.dp
        if dp is not None:
            out["native_dataplane"] = dp.http_stats()
            out["native_front"] = dp.front_stats()
        return json_response(out)
