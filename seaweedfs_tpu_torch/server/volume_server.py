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

The heartbeat is a thread that POSTs the Store's full report to the
master's /heartbeat every pulse, and at once when `poke_heartbeat`
wakes it; network errors retry forever, as the reference's loop. With
several masters (`master_url` a comma list) it first asks them
/cluster/leader for the raft leader (`_find_leader`, the reference's
:401-416) and heartbeats there; a failed beat, or one a follower
refuses (its reply names the leader), sends it to find the leader
again. An admin route that changes what the master knows (volumes,
mounted shards) replies once the leader has acknowledged the new
report. The
EC holder map that remote shard reads use comes from the master's
/cluster/ec_shards through a MasterClient cache (EC_HOLDERS_TTL); a
fan-out that comes back short reads the map again unless it is under
EC_HOLDERS_RETRY_AGE old, in place of the reference's KeepConnected
subscription.

A write or delete on a replicated volume fans out to the replicas the
master lists (store_replicate.go:24) before it is acknowledged, and
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

Not here: JWT guard, multipart uploads, chunk manifests, multi-range
replies, the native data plane, the commit
scheduler, query, tiering, tail / sync.
"""
from __future__ import annotations

import contextvars
import gzip
import json
import os
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import numpy as np

from ..ec import geometry as geo
from ..ec.decoder import find_dat_size, write_dat_file, write_idx_from_ecx
from ..rpc.http import (App, Request, Response, debug_index_factory,
                        file_response, json_response, text_response)
from ..rpc.httpclient import RequestException, session
from ..storage import needle as ndl
from ..storage import types as t
from ..storage.store import Store
from ..storage.super_block import ReplicaPlacement
from ..storage.volume import Volume
from ..utils import compression, glog, httprange, metrics, ratelimit, retry
from ..wdclient.client import MasterClient, find_leader

# timeout of one heartbeat POST beyond the pulse it covers
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


def _named_leader(resp) -> str:
    """The leader a follower's refusal names, or ""."""
    try:
        return str(resp.json().get("leader") or "")
    except (ValueError, AttributeError):
        return ""


class VolumeServer:
    # age limits of the cached EC holder map: any read, and the retry
    # after a fan-out that came back short
    EC_HOLDERS_TTL = 10.0
    EC_HOLDERS_RETRY_AGE = 1.0

    def __init__(self, store: Store, master_url: str,
                 data_center: str = "DefaultDataCenter",
                 rack: str = "DefaultRack",
                 pulse_seconds: float = 5.0,
                 disk_type: str = "hdd"):
        self.store = store
        self.disk_type = disk_type
        self.masters = [
            m if m.startswith("http") else f"http://{m}"
            for m in (s.strip().rstrip("/") for s in master_url.split(","))
            if m]
        self.master_url = self.masters[0]
        self.data_center = data_center
        self.rack = rack
        self.pulse_seconds = pulse_seconds
        self._stop = threading.Event()
        self._hb_wake = threading.Event()
        # heartbeat generations: pokes asked for, and the newest one the
        # master acknowledged (poke_heartbeat(wait=True) waits on it)
        self._hb_cond = threading.Condition()
        self._hb_poked = 0
        self._hb_acked = 0
        self._hb_thread: threading.Thread | None = None
        self._mc = MasterClient(self.masters)
        self._fetch_pool: ThreadPoolExecutor | None = None
        self._pool_lock = threading.Lock()
        self.store.remote_shards_fetcher = self._remote_shards_fetch_sync
        self.app = self._build_app()

    def _build_app(self) -> App:
        # the reference's error middleware: malformed input answers 400
        app = App(bad_request=(json.JSONDecodeError, KeyError, ValueError,
                               TypeError))
        app.get("/status", self.handle_status)
        app.get("/debug", debug_index_factory("volume", {
            "/debug/ec": "EC codec router: probe curve + backends",
        }))
        app.get("/debug/ec", self.handle_debug_ec)
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
        """Stop heartbeating, drop the fetch pool, close the store."""
        self._stop.set()
        self._hb_wake.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=10)
            self._hb_thread = None
        with self._pool_lock:
            pool, self._fetch_pool = self._fetch_pool, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
        self.store.close()

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
        return hb

    def _heartbeat_loop(self) -> None:
        while self.store.port == 0 and not self._stop.is_set():
            # ephemeral listen port not resolved yet (set by the
            # caller right after the server binds): don't register :0
            self._stop.wait(0.02)
        timeout = (HEARTBEAT_TIMEOUT,
                   HEARTBEAT_TIMEOUT + 4 * self.pulse_seconds)
        self.master_url = self._find_leader()
        redirected = False
        while not self._stop.is_set():
            # cleared, and the generation read, BEFORE the report is
            # taken: a poke that lands after this point sends another
            # beat, none is lost
            self._hb_wake.clear()
            with self._hb_cond:
                gen = self._hb_poked
            try:
                resp = session().post(f"{self.master_url}/heartbeat",
                                      json=self.heartbeat_payload(),
                                      timeout=timeout)
                if resp.status_code != 200:
                    leader = _named_leader(resp)
                    if leader and not redirected:
                        # a follower refused the beat and named the
                        # leader: go there at once (once in a row)
                        self.master_url = f"http://{leader}"
                        redirected = True
                        continue
                    raise RequestException(
                        f"heartbeat: {resp.status_code} {resp.text}")
            except Exception as e:  # noqa: BLE001 — retry forever
                glog.v(1, "heartbeat to %s failed: %s; retrying",
                       self.master_url, e)
                self._stop.wait(min(1.0, self.pulse_seconds))
                if not self._stop.is_set():
                    self.master_url = self._find_leader()
                redirected = False
                continue
            redirected = False
            with self._hb_cond:
                self._hb_acked = max(self._hb_acked, gen)
                self._hb_cond.notify_all()
            self._hb_wake.wait(self.pulse_seconds)

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
            return self._read_fid(req, vid, key, cookie)
        if req.method in ("POST", "PUT"):
            return self._write_fid(req, fid, vid, key, cookie)
        if req.method == "DELETE":
            return self._delete_fid(req, fid, vid, key)
        return Response(status=405)

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

    def _read_fid(self, req: Request, vid: int, key: int,
                  cookie: int) -> Response:
        start = time.perf_counter()
        if not self.store.has_volume(vid) and \
                vid not in self.store.ec_volumes:
            # not local: redirect via master lookup (handlers_read.go:48)
            locs = self._mc.lookup(vid, max_age=LOOKUP_TTL)
            if locs:
                return Response(status=301, headers={
                    "Location":
                        f"http://{locs[0]['url']}/{req.match_info['fid']}"})
            return text_response(f"volume {vid} not found", status=404)
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
        ct = n.mime.decode() if n.mime else "application/octet-stream"
        rng = req.headers.get("Range")
        if n.is_compressed:
            # ranges address the original bytes: inflate for them and
            # for clients that do not take gzip
            if rng or "gzip" not in (req.headers.get("Accept-Encoding")
                                     or ""):
                body = gzip.decompress(body)
            else:
                headers["Content-Encoding"] = "gzip"
        headers["Content-Type"] = ct
        if rng:
            ranges = httprange.parse_range_header(rng, len(body))
            if ranges in (httprange.MALFORMED, httprange.UNSATISFIABLE):
                return Response(status=416, headers={
                    "Content-Range": f"bytes */{len(body)}"})
            if ranges and ranges is not httprange.IGNORE and \
                    len(ranges) == 1:
                start_i, length = ranges[0]
                headers["Content-Range"] = httprange.content_range(
                    start_i, length, len(body))
                return Response(body[start_i:start_i + length], 206,
                                headers)
        return Response(body, 200, headers)

    def _write_fid(self, req: Request, fid: str, vid: int, key: int,
                   cookie: int) -> Response:
        start = time.perf_counter()
        if not self.store.has_volume(vid):
            return text_response(f"volume {vid} not found", status=404)
        ctype = req.content_type
        if ctype.startswith("multipart/"):
            return text_response("multipart uploads are not ported; "
                                 "send the raw body", status=415)
        n = ndl.Needle(id=key, cookie=cookie)
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
        try:
            self.store.write_needle(vid, n)
        except KeyError:
            return Response(status=404)
        except PermissionError as e:
            return text_response(str(e), status=409)
        if not is_replicate:
            err = self._replicate(req, fid, n.data, "POST", needle=n)
            if err:
                return text_response(err, status=500)
        self.poke_heartbeat()
        metrics.histogram_observe("volume_server_write_seconds",
                                  time.perf_counter() - start)
        return json_response(
            {"name": n.name.decode("utf-8", "replace") if n.name else "",
             "size": len(n.data), "eTag": n.etag()}, status=201,
            headers={"X-Sw-Durability": "buffered"})

    def _delete_fid(self, req: Request, fid: str, vid: int,
                    key: int) -> Response:
        try:
            size = self.store.delete_needle(vid, key)
        except KeyError:
            return Response(status=404)
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
                try:
                    if method == "POST":
                        r = session().post(url, params=params, data=data,
                                           headers=headers,
                                           timeout=timeout)
                    else:
                        r = session().delete(url, params=params,
                                             headers=headers,
                                             timeout=timeout)
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
        self.poke_heartbeat(wait=True)
        return json_response({})

    def handle_leave(self, req: Request) -> Response:
        """volume.server.leave (VolumeServerLeave): stop heartbeating so
        the master drops this node; reads go on being served until the
        server is shut down."""
        self._stop.set()
        self._hb_wake.set()
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
        v = self.store.find_volume(int(body["volume"]))
        if v is None:
            return json_response({"error": "not found"}, status=404)
        v.compact()
        self.poke_heartbeat(wait=True)
        return json_response({"size": v.content_size()})

    def handle_volume_info(self, req: Request) -> Response:
        vid = int(req.query["volume"])
        v = self.store.find_volume(vid)
        if v is None:
            return json_response({"error": "not found"}, status=404)
        # a .vif naming a remote .dat does not load in the port, so a
        # mounted volume is always local
        return json_response({
            "volume": vid, "size": v.content_size(),
            "file_count": v.nm.file_count,
            "deleted_bytes": v.nm.deleted_bytes,
            "garbage_ratio": v.garbage_ratio(),
            "read_only": v.read_only,
            "remote": None,
        })

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

    def handle_status(self, req: Request) -> Response:
        return json_response({"Version": "seaweedfs-tpu-torch",
                              **self.store.collect_heartbeat()})
