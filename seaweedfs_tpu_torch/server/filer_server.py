"""Filer server: the namespace over HTTP, its KV side channel and the
DLM's lock routes; the counterpart of seaweedfs_tpu/server/filer_server.py.

Equivalents: SeaweedFS weed/server/filer_server_handlers_write_autochunk.go:25-130
(upload auto-chunking), filer_server_handlers_read.go (ranged streaming
reads), _read_dir.go (listing), filer_grpc_server_kv.go (KV),
filer_grpc_server_dlm.go (the distributed lock manager) and the rename
rpc (filer_grpc_server_rename.go) via `mv.from`.

Uploads split the body into `-maxMB` chunks (8 MiB): each is assigned a
fid at the master (assigns batched `count=ASSIGN_BATCH` at a time) and
posted straight to a volume server, UPLOAD_WINDOW chunks in flight while
the next is read off the socket; the filer never stores file bytes
itself. A compressible name is passed to the volume server, which
stores such chunks gzipped. A GET streams the entry's chunks to the
client piece by piece with the whole Content-Length up front (one chunk
read ahead, never the whole file in memory); a range of several parts
answers multipart/byteranges. Dead chunks of overwrites and deletes are
freed by a deletion thread every DELETION_INTERVAL (filer_deletion.go).

A membership thread announces this filer to the master every
`announce_pulse` seconds and rebuilds the DLM's lock ring from the
master's live filer list, as the reference's loop (`:261`); the master's
watchdog and admin scripts find this filer through the same list and
take its `admin` lock. With HA masters (`master_url` a comma list) the
announce, the filer list and the assigns follow the raft leader: a
follower 307s them to it, and a master that does not answer rotates to
the next. A new leader's membership starts empty, so a shrunken filer
list is adopted into the lock ring only once it has held for
RING_SHRINK_PULSES announces; otherwise two filers could both claim a
lock's home.

Threads take the place of the reference's asyncio tasks: the handlers
run on their connection's thread, the chunk uploads of a PUT on a
shared pool. Not here: /ws/meta_subscribe, remote storage mounts
(cacheRemote / uncacheRemote), -encryptVolumeData, the sharded and
caching stores, the browser (text/html) listing view, qos and
fault-injection middleware, /debug/traces.
"""
from __future__ import annotations

import base64
import binascii
import collections
import email
import email.policy
import hashlib
import json
import mimetypes
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable

from ..cluster.lock_manager import (DistributedLockManager, LockMoved,
                                    LockNotOwned, RingEmpty)
from ..filer import (Entry, FileChunk, Filer, etag_chunks, iter_content,
                     maybe_manifestize, norm_path, read_fid,
                     resolve_chunk_manifest, stream_content)
from ..filer.filechunks import MANIFEST_BATCH
from ..filer.filer import DirectoryNotEmptyError
from ..filer.filer_conf import CONF_KEY as FILER_CONF_KEY
from ..filer.filer_conf import FilerConf
from ..operation import verbs
from ..rpc.http import (App, Request, Response, debug_index_factory,
                        json_response, text_response)
from ..rpc.httpclient import session
from ..utils import compression, extheaders, glog, httprange, metrics
from ..wdclient.client import MasterClient

DEFAULT_CHUNK_SIZE = 8 << 20  # autochunk default (`-maxMB=8` upstream)
UPLOAD_WINDOW = 3  # chunk uploads of one PUT in flight (<= 24 MiB held)
# how long the filer trusts a cached volume location; a read that fails
# on every cached location looks the volume up again at once
LOOKUP_TTL = 10.0
# how long stop waits for each background thread
JOIN_TIMEOUT = 10.0
# announces a smaller filer list must hold before the ring shrinks
RING_SHRINK_PULSES = 3

Handler = Callable[[Request], Response]


def _errors(handler: Handler) -> Handler:
    """The reference's error middleware: filesystem errors to 404 /
    409, failed volume reads to 502, malformed input to 400; each as
    JSON {"error": ...}, and the request time observed."""
    def wrapped(req: Request) -> Response:
        start = time.perf_counter()
        try:
            return handler(req)
        except FileNotFoundError as e:
            return json_response({"error": str(e)}, status=404)
        except (FileExistsError, IsADirectoryError, NotADirectoryError,
                DirectoryNotEmptyError) as e:
            return json_response({"error": str(e)}, status=409)
        except OSError as e:  # failed volume reads etc. are 5xx
            return json_response({"error": str(e)}, status=502)
        except (json.JSONDecodeError, KeyError, ValueError,
                TypeError) as e:
            return json_response({"error": f"bad request: {e}"},
                                 status=400)
        finally:
            metrics.histogram_observe(
                "filer_request_seconds", time.perf_counter() - start,
                labels={"method": req.method})
    return wrapped


class FilerServer:
    ASSIGN_BATCH = 128
    DELETION_INTERVAL = 0.3
    _FILER_CONF_TTL = 2.0  # backstop for edits via another filer

    def __init__(self, master_url: str, store: str = "memory",
                 store_path: str = ":memory:",
                 collection: str = "", replication: str = "",
                 chunk_size: int = DEFAULT_CHUNK_SIZE,
                 signature: int = 0,
                 announce_pulse: float = 3.0,
                 save_to_filer_limit: int = 0):
        self.masters = MasterClient(master_url)
        self.collection = collection
        self.replication = replication
        self.chunk_size = chunk_size
        # -saveToFilerLimit: bodies under this many bytes live INSIDE
        # the metadata entry (entry.content) — zero volume round trips
        # for tiny files (command/filer.go:85, uploadReaderToChunks:83)
        self.save_to_filer_limit = save_to_filer_limit
        self.filer = Filer(store, on_delete_chunks=self._delete_chunks,
                           signature=signature, path=store_path)
        # this filer's address is set by the runner once the listen
        # socket is bound (the volume servers' store.port likewise)
        self.address = ""
        self.filer_group = ""
        self.announce_pulse = announce_pulse
        self.dlm = DistributedLockManager(me="")
        self._deletion_q: collections.deque = collections.deque()
        self._fid_pools: dict[tuple, collections.deque] = {}
        self._fid_lock = threading.Lock()
        self._filer_conf_cache: tuple[FilerConf, float] | None = None
        self._uploads = ThreadPoolExecutor(max_workers=16,
                                           thread_name_prefix="filer-up")
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.app = self._build_app()
        self.app.on_startup.append(self._start_background)
        self.app.on_cleanup.append(self._stop_background)

    @property
    def master_url(self) -> str:
        """The master this filer talks to now (the leader, once a
        follower's 307 or an unreachable master moved it on)."""
        return self.masters.master_url

    # -- lifecycle ------------------------------------------------------
    def _start_background(self) -> None:
        self._stop.clear()
        self._threads = [
            threading.Thread(target=self._membership_loop,
                             name="filer-membership", daemon=True),
            threading.Thread(target=self._deletion_loop,
                             name="filer-deletion", daemon=True)]
        for t in self._threads:
            t.start()

    def _stop_background(self) -> None:
        """Stop the announce and deletion threads, free every chunk
        still queued (orphans would survive only as vacuum work), and
        tell the master this filer left."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=JOIN_TIMEOUT)
        self._threads = []
        try:
            while self._deletion_q:
                self._drain_deletions()
        except Exception as e:  # noqa: BLE001 — vacuum reclaims them
            glog.warning("filer: chunk deletions left at stop: %s", e)
        self._uploads.shutdown(wait=True)
        if self.address:
            try:
                session().post(f"{self.master_url}/cluster/announce",
                               json={"address": self.address,
                                     "type": "filer", "leave": True},
                               timeout=2)
            except OSError:
                pass            # the master forgets it after its TTL

    # -- membership + lock ring (cluster.go + lock_ring.go) ------------
    def _membership_loop(self) -> None:
        """Announce to the master and refresh the DLM lock ring from
        the live filer list."""
        while not self.address:
            if self._stop.wait(0.02):
                return
        self.dlm.me = self.address
        shrink_streak = 0
        while True:
            try:
                session().post(
                    f"{self.master_url}/cluster/announce",
                    json={"address": self.address, "type": "filer",
                          "filerGroup": self.filer_group}, timeout=5)
                nodes = session().get(
                    f"{self.master_url}/cluster/nodes",
                    params={"type": "filer"}, timeout=5).json()["nodes"]
                servers = {n["address"] for n in nodes}
                servers.add(self.address)
                current = set(self.dlm.ring.servers())
                if servers >= current:
                    # growth or steady state applies immediately
                    self.dlm.ring.set_servers(sorted(servers))
                    shrink_streak = 0
                else:
                    # a shrunken list is adopted only once it is
                    # stable: collapsing the ring early would let two
                    # filers both claim lock homes
                    shrink_streak += 1
                    if shrink_streak >= RING_SHRINK_PULSES:
                        self.dlm.ring.set_servers(sorted(servers))
                        shrink_streak = 0
            except (OSError, ValueError, KeyError) as e:
                # master unreachable: keep serving with the last ring,
                # and try the next master
                glog.v(1, "filer: announce to %s failed: %s",
                       self.master_url, e)
                self.masters.failover()
            if self._stop.wait(self.announce_pulse):
                return

    # -- plumbing -------------------------------------------------------
    def _build_app(self) -> App:
        app = App()
        app.get("/status", self.handle_status)
        app.get("/metrics", self.handle_metrics)
        # /debug index BEFORE the catch-all path routes below, or the
        # filer would treat it as a file read
        app.get("/debug", debug_index_factory("filer", {
            "/status": "master, store and signature",
            "/metrics": "Prometheus text exposition",
        }))
        app.post("/dlm/lock", _errors(self.handle_dlm_lock))
        app.post("/dlm/unlock", _errors(self.handle_dlm_unlock))
        app.post("/dlm/find", _errors(self.handle_dlm_find))
        app.route("GET", "/kv/{key:.*}", _errors(self.handle_kv_get))
        app.route("PUT", "/kv/{key:.*}", _errors(self.handle_kv_put))
        app.route("DELETE", "/kv/{key:.*}", _errors(self.handle_kv_delete))
        app.route("GET", "/{path:.*}", _errors(self.handle_get))
        app.route("POST", "/{path:.*}", _errors(self.handle_put))
        app.route("PUT", "/{path:.*}", _errors(self.handle_put))
        app.route("DELETE", "/{path:.*}", _errors(self.handle_delete))
        return app

    # -- distributed lock manager (filer_grpc_server_dlm.go) -----------
    def handle_dlm_lock(self, req: Request) -> Response:
        d = req.json()
        try:
            token = self.dlm.lock(d["name"], d.get("owner", ""),
                                  float(d.get("ttl", 10.0)),
                                  d.get("token", ""))
        except LockMoved as e:
            return json_response({"moved": e.host}, status=409)
        except RingEmpty as e:
            return json_response({"error": str(e)}, status=503)
        except (PermissionError, LockNotOwned) as e:
            return json_response({"error": str(e)}, status=403)
        return json_response({"token": token})

    def handle_dlm_unlock(self, req: Request) -> Response:
        d = req.json()
        try:
            self.dlm.unlock(d["name"], d.get("token", ""))
        except LockNotOwned as e:
            return json_response({"error": str(e)}, status=403)
        return json_response({"ok": True})

    def handle_dlm_find(self, req: Request) -> Response:
        d = req.json()
        try:
            owner = self.dlm.find_owner(d["name"])
        except LockMoved as e:
            return json_response({"moved": e.host}, status=409)
        except RingEmpty as e:
            return json_response({"error": str(e)}, status=503)
        return json_response({"owner": owner})

    # -- volume locations -----------------------------------------------
    def _lookup_fid(self, fid: str) -> str:
        return self.masters.lookup_file_id(fid, max_age=LOOKUP_TTL)

    def lookup_file_id_urls(self, fid: str) -> list[str]:
        """Every location of a fid — lets stream.read_fid hedge and
        fail over when `self._lookup_fid` is the lookup fn."""
        return self.masters.lookup_file_id_urls(fid, max_age=LOOKUP_TTL)

    def invalidate_fid(self, fid: str) -> None:
        """A read failed on every cached location: the volume moved
        (ec.encode) or a server died; read the master again."""
        self.masters.invalidate(int(fid.split(",")[0]))

    # -- chunk uploads (filer_server_handlers_write_autochunk.go) ------
    def _assign(self, collection: str, replication: str, ttl: str,
                disk_type: str, fresh: bool = False,
                data_center: str = "") -> tuple[str, str, str]:
        """-> (volume url, fid, auth) from the batched allocator: one
        /dir/assign?count=N feeds the next N chunk uploads of the same
        placement. `fresh` bypasses the pool after an upload failure
        (the pooled placement may have gone read-only or full)."""
        key = (collection, replication, ttl, disk_type, data_center)
        with self._fid_lock:
            pool = self._fid_pools.setdefault(key, collections.deque())
            if fresh:
                pool.clear()
            elif pool:
                return pool.popleft()
        for left in range(len(self.masters.masters) - 1, -1, -1):
            try:
                a = verbs.assign(self.master_url,
                                 count=1 if fresh else self.ASSIGN_BATCH,
                                 collection=collection,
                                 replication=replication, ttl=ttl,
                                 disk_type=disk_type,
                                 data_center=data_center)
                break
            except OSError:
                if not left:
                    raise
                self.masters.failover()     # that master is down
        # slot fids share the base fid's volume and cookie
        # (ParsePath:121-141)
        with self._fid_lock:
            pool.extend((a.url, f"{a.fid}_{i}", a.auth)
                        for i in range(1, int(a.count)))
        return a.url, a.fid, a.auth

    def _upload_chunk(self, data: bytes, name: str, collection: str,
                      replication: str, ttl: str, disk_type: str = "",
                      fsync: bool = False,
                      data_center: str = "") -> tuple[str, str]:
        """-> (fid, etag). A compressible name is shipped so the volume
        server stores the chunk gzipped; opaque payloads omit it."""
        etag = hashlib.md5(data).hexdigest()
        params = {}
        if fsync:  # ?fsync=true / filer.conf rule: durable before ack
            params["fsync"] = "true"
        if name and compression.is_compressible(
                mimetypes.guess_type(name)[0] or "", name):
            params["name"] = name
        last = ""
        for attempt in range(3):
            url, fid, auth = self._assign(collection, replication, ttl,
                                          disk_type, fresh=attempt > 0,
                                          data_center=data_center)
            headers = {"Content-Type": "application/octet-stream"}
            if auth:
                headers["Authorization"] = f"Bearer {auth}"
            try:
                resp = session().post(f"http://{url}/{fid}", data=data,
                                      params=params, headers=headers,
                                      timeout=60)
                if resp.status_code < 300:
                    return fid, etag
                last = f"{resp.status_code} {resp.text}"
            except OSError as e:
                last = str(e)
        raise RuntimeError(f"chunk upload failed: {last}")

    # -- chunk deletion (weed/filer/filer_deletion.go) ------------------
    def _delete_chunks(self, chunks: list[FileChunk]) -> None:
        """Filer callback: enqueue only; the deletion thread frees them
        (an overwrite must not pay its predecessor's deletes)."""
        self._deletion_q.extend(chunks)

    def _deletion_loop(self) -> None:
        while not self._stop.wait(self.DELETION_INTERVAL):
            try:
                self._drain_deletions()
            except Exception as e:  # noqa: BLE001 — vacuum reclaims them
                glog.warning("filer: chunk deletion failed: %s", e)

    def _drain_deletions(self) -> None:
        q = self._deletion_q
        batch: list[FileChunk] = []
        while q and len(batch) < 4096:
            batch.append(q.popleft())
        if batch:
            self._delete_chunks_now(batch)

    def _delete_chunks_now(self, chunks: list[FileChunk]) -> None:
        # manifest chunks must be expanded first or the data chunks
        # they reference would be orphaned forever
        try:
            data_chunks = resolve_chunk_manifest(
                lambda fid: read_fid(self._lookup_fid, fid), chunks)
        except Exception:  # noqa: BLE001 — free what is in hand
            data_chunks = [c for c in chunks if not c.is_chunk_manifest]
        manifests = [c for c in chunks if c.is_chunk_manifest]
        for c in data_chunks + manifests:
            try:
                verbs.delete(self._lookup_fid(c.fid))
            except Exception:  # noqa: BLE001 — volume.fsck / vacuum
                pass

    # -- per-path storage rules (weed/filer/filer_conf.go) --------------
    def _filer_conf(self) -> FilerConf:
        cached = self._filer_conf_cache
        now = time.monotonic()
        if cached is not None and now - cached[1] < self._FILER_CONF_TTL:
            return cached[0]
        raw = self.filer.store.kv_get(FILER_CONF_KEY)
        conf = FilerConf.from_json(raw) if raw else FilerConf()
        self._filer_conf_cache = (conf, now)
        return conf

    # -- read path ------------------------------------------------------
    def handle_get(self, req: Request) -> Response:
        path = norm_path("/" + req.match_info["path"])
        entry = self.filer.find_entry(path)
        if entry is None:
            return json_response({"error": f"not found: {path}"},
                                 status=404)
        # ?metadata=true is the reference's param name
        # (filer_server_handlers_read.go:118); ?meta=1 the older local
        # spelling. Checked before the dir branch: directory entries
        # have metadata too.
        if "meta" in req.query or req.query.get("metadata") == "true":
            d = entry.to_dict()
            if req.query.get("resolveManifest") == "true" \
                    and entry.chunks:
                try:
                    resolved = resolve_chunk_manifest(
                        lambda fid: read_fid(self._lookup_fid, fid),
                        entry.chunks)
                except Exception as e:  # noqa: BLE001 — reported
                    return json_response(
                        {"error": f"failed to resolve chunk "
                                  f"manifest: {e}"}, status=500)
                d["chunks"] = [c.to_dict() for c in resolved]
            return json_response(d)
        if entry.is_directory:
            return self._list_dir(req, path)
        size = entry.file_size
        etag = entry.md5 or etag_chunks(entry.chunks)
        mime = (entry.mime or mimetypes.guess_type(path)[0]
                or "application/octet-stream")
        headers = {"ETag": f'"{etag}"', "Accept-Ranges": "bytes",
                   "Last-Modified": time.strftime(
                       "%a, %d %b %Y %H:%M:%S GMT",
                       time.gmtime(entry.mtime)),
                   # lets the S3 gateway serve a GET from ONE filer
                   # round trip: entry kind + s3 metadata ride the data
                   # response instead of a separate ?meta=1 probe
                   "X-Seaweed-Entry": "file"}
        for k, v in entry.extended.items():
            if k.startswith("s3_"):
                headers[f"x-seaweed-ext-{k}"] = extheaders.armor(v)
        if req.headers.get("If-None-Match") == f'"{etag}"':
            return Response(status=304, headers=headers)
        offset, length, status = 0, size, 200
        multi: list[tuple[int, int]] | None = None
        rng = req.headers.get("Range", "")
        if rng:
            ranges = httprange.parse_range_header(rng, size)
            if ranges in (httprange.MALFORMED, httprange.UNSATISFIABLE):
                return Response(status=416, headers={
                    "Content-Range": f"bytes */{size}"})
            if ranges and ranges is not httprange.IGNORE:
                if len(ranges) == 1:
                    offset, length = ranges[0]
                    status = 206
                    headers["Content-Range"] = httprange.content_range(
                        offset, length, size)
                else:  # multipart/byteranges (common.go:348-383)
                    multi = ranges
                    status = 206
        headers["Content-Type"] = mime
        if req.method == "HEAD":
            # a HEAD with several ranges has no single Content-Range to
            # advertise: answer as a plain HEAD of the whole object
            headers["Content-Length"] = str(size if multi else length)
            return Response(status=200 if multi else status,
                            headers=headers)
        if entry.content and not entry.chunks:
            # inline small file (entry.Content, filer/stream.go:28):
            # the bytes live in the metadata entry — no volume trip
            if multi is not None:
                parts = [(s, ln, entry.content[s:s + ln])
                         for s, ln in multi]
                mbody, mct = httprange.multipart_byteranges(
                    parts, mime, size)
                headers["Content-Type"] = mct
                return Response(mbody, 206, headers)
            return Response(entry.content[offset:offset + length],
                            status, headers)
        if multi is not None:
            parts = [(m_off, m_len,
                      stream_content(self._lookup_fid, entry.chunks,
                                     m_off, m_len))
                     for m_off, m_len in multi]
            mbody, mct = httprange.multipart_byteranges(parts, mime, size)
            headers["Content-Type"] = mct  # carries the boundary
            metrics.counter_add("filer_read_bytes", len(mbody))
            return Response(mbody, 206, headers)
        metrics.counter_add("filer_read_bytes", length)
        return Response(status=status, headers=headers, length=length,
                        stream=iter_content(self._lookup_fid,
                                            entry.chunks, offset, length))

    def _list_dir(self, req: Request, path: str) -> Response:
        limit = int(req.query.get("limit", "1024"))
        last = req.query.get("lastFileName", "")
        prefix = req.query.get("prefix", "")
        # shell-glob name filters (filer_server_handlers_read_dir.go:34)
        pattern = req.query.get("namePattern", "")
        pattern_exclude = req.query.get("namePatternExclude", "")
        entries = self.filer.list_entries(
            path, start_from=last, limit=limit, prefix=prefix,
            name_pattern=pattern, name_pattern_exclude=pattern_exclude)
        # a short page proves end-of-directory (list_entries pages past
        # expired/filtered entries itself); only a FULL page needs the
        # one-entry probe to drive the more-flag honestly
        more = False
        if entries and len(entries) == limit:
            more = bool(self.filer.list_entries(
                path, start_from=entries[-1].name, limit=1,
                prefix=prefix, name_pattern=pattern,
                name_pattern_exclude=pattern_exclude))
        return json_response({
            "path": path,
            "entries": [e.to_dict() for e in entries],
            "lastFileName": entries[-1].name if entries else "",
            "shouldDisplayLoadMore": more,
        }, headers={"X-Seaweed-Entry": "dir"})

    # -- write path -----------------------------------------------------
    def handle_put(self, req: Request) -> Response:
        raw_path = "/" + req.match_info["path"]
        path = norm_path(raw_path)
        # replication/sync peers tag writes with the signatures of
        # filers that already saw the event (command/filer_sync.go)
        signatures = _parse_signatures(req.query.get("signatures", ""))
        # per-path rules, checked before every mutating verb
        # (detectStorageOption, filer_server_handlers_write.go:219)
        rule = self._filer_conf().match(path)
        if rule.read_only:
            return json_response(
                {"error": f"{rule.location_prefix or path} is read-only "
                          "by filer.conf rule"}, status=403)
        name_len = len(path.rsplit("/", 1)[-1])
        if rule.max_file_name_length and \
                name_len > rule.max_file_name_length:
            return json_response(
                {"error": f"file name longer than the "
                          f"{rule.max_file_name_length}-byte limit set "
                          "by filer.conf"}, status=400)
        if "mv.from" in req.query:  # rename verb
            # the SOURCE path's rules apply too: renaming out of a
            # read-only subtree is a delete there in disguise
            src = norm_path(req.query["mv.from"])
            src_rule = self._filer_conf().match(src)
            if src_rule.read_only:
                return json_response(
                    {"error": f"{src_rule.location_prefix or src} is "
                              "read-only by filer.conf rule"}, status=403)
            try:
                self.filer.rename(src, path, signatures=signatures)
            except ValueError as e:  # move-into-own-subtree guard
                return json_response({"error": str(e)}, status=400)
            return json_response({"path": path})
        if "link.from" in req.query:  # hard link verb
            e = self.filer.link(req.query["link.from"], path,
                                signatures=signatures)
            return json_response(e.to_dict(), status=201)
        if "meta" in req.query:
            # raw entry create: the body is an Entry dict whose chunks
            # point at already-uploaded fids (filer_pb CreateEntry —
            # how the S3 gateway stitches multipart uploads). Old-chunk
            # GC happens inside create_entry's mutation lock.
            d = json.loads(req.read().decode())
            d["full_path"] = path
            entry = Entry.from_dict(d)
            self.filer.create_entry(entry, signatures=signatures,
                                    gc_old_chunks=True)
            return json_response(entry.to_dict(), status=201)
        if "mkdir" in req.query or (raw_path.endswith("/")
                                    and req.content_length in (None, 0)):
            e = self.filer.mkdir(path, signatures=signatures)
            return json_response(e.to_dict(), status=201)
        return self._upload(req, path, rule, signatures)

    def _upload(self, req: Request, path: str, rule,
                signatures: list[int] | None) -> Response:
        collection = req.query.get("collection", "") or rule.collection \
            or self.collection
        replication = req.query.get("replication", "") \
            or rule.replication or self.replication
        ttl = req.query.get("ttl", "") or rule.ttl
        disk_type = req.query.get("disk", "") or rule.disk_type
        # durable-before-ack chunk writes: the query param or a
        # filer.conf rule (detectStorageOption, handlers_write.go:86)
        fsync = req.query.get("fsync") == "true" or rule.fsync
        data_center = req.query.get("dataCenter", "")
        chunk_size = int(req.query.get("maxMB", "0")) << 20 or \
            self.chunk_size
        filename = path.rsplit("/", 1)[-1]
        # aiohttp's default for a body without a Content-Type
        content_type = req.content_type or "application/octet-stream"
        if content_type.startswith("multipart/"):
            # a form upload: the 'file' part is the content (held
            # whole — browser forms, not the bulk path)
            data, part_name, mime = _form_file(
                req.read(), req.headers.get("Content-Type", ""))
            filename = part_name or filename
            view = memoryview(data)
            at = [0]

            def read_piece(n: int) -> bytes:
                piece = bytes(view[at[0]:at[0] + n])
                at[0] += len(piece)
                return piece
        else:
            mime = content_type
            read_piece = req.read_exactly

        # The whole-stream md5 is computed only when the client sent
        # Content-MD5 (verified below) or asked via ?fullmd5=1 (the S3
        # gateway does, for AWS-exact object ETags); otherwise
        # multi-chunk ETags use the reference's ETagChunks fallback and
        # single-chunk entries inherit their chunk's md5.
        content_md5 = req.headers.get("Content-MD5", "")
        md5_want = b""
        if content_md5:
            try:  # validated BEFORE the body is read
                md5_want = base64.b64decode(content_md5, validate=True)
            except binascii.Error:
                md5_want = b""
            if len(md5_want) != 16:
                return json_response(
                    {"error": "malformed Content-MD5 header"}, status=400)
        md5_all = hashlib.md5() if content_md5 \
            or "fullmd5" in req.query else None
        # inline threshold: the per-request ?saveInside=true or the
        # filer-wide -saveToFilerLimit
        inline_limit = 0
        save_inside = req.query.get("saveInside", "")
        if save_inside == "true":
            inline_limit = self.chunk_size
        elif save_inside == "false":
            # explicit opt-out: S3 multipart parts must keep chunks
            inline_limit = 0
        elif self.save_to_filer_limit > 0:
            inline_limit = min(self.save_to_filer_limit, self.chunk_size)

        chunks: list[FileChunk] = []
        pending: list[tuple[int, int, Future]] = []
        small_content = b""
        total = offset = 0

        def collect_oldest() -> None:
            poff, psize, fut = pending.pop(0)
            fid, etag = fut.result()
            chunks.append(FileChunk(fid=fid, offset=poff, size=psize,
                                    mtime_ns=time.time_ns(), etag=etag))

        try:
            while True:
                piece = read_piece(chunk_size)
                if not piece:
                    break
                if md5_all is not None:
                    md5_all.update(piece)
                if offset == 0 and 0 < len(piece) < chunk_size \
                        and len(piece) < inline_limit:
                    # the WHOLE body, under the inline limit: store it
                    # in the entry (uploadReaderToChunks:83)
                    small_content = piece
                    total = len(piece)
                    break
                pending.append((offset, len(piece), self._uploads.submit(
                    self._upload_chunk, piece, filename, collection,
                    replication, ttl, disk_type, fsync, data_center)))
                offset += len(piece)
                total += len(piece)
                while len(pending) >= UPLOAD_WINDOW:
                    collect_oldest()
                if len(piece) < chunk_size:
                    break
            while pending:
                collect_oldest()
        except BaseException:
            # chunks already uploaded for the failed PUT are orphans:
            # queue them for the deletion thread, uploads still in
            # flight included once they finish
            for poff, psize, fut in pending:
                fut.cancel()
                try:
                    fid, _etag = fut.result()
                    chunks.append(FileChunk(fid=fid, offset=poff,
                                            size=psize, mtime_ns=0))
                except BaseException:  # noqa: BLE001 — never uploaded
                    pass
            if chunks:
                self._delete_chunks(chunks)
            raise

        if content_md5 and md5_want != md5_all.digest():
            self._delete_chunks(chunks)
            return json_response({"error": "Content-MD5 mismatch"},
                                 status=400)
        if len(chunks) >= MANIFEST_BATCH:
            chunks = maybe_manifestize(
                lambda b: self._upload_chunk(
                    b, filename, collection, replication, ttl, disk_type,
                    fsync=fsync, data_center=data_center)[0], chunks)
        # extended attributes carried on the upload itself (atomic with
        # the entry create): the S3 gateway ships x-amz-meta-* so
        extended = {k.lower()[len("x-seaweed-ext-"):]:
                    extheaders.unarmor(v)
                    for k, v in req.headers.items()
                    if k.lower().startswith("x-seaweed-ext-")}
        if md5_all is not None:
            md5_hex = md5_all.hexdigest()
        elif small_content:
            md5_hex = hashlib.md5(small_content).hexdigest()
        elif len(chunks) == 1 and not chunks[0].is_chunk_manifest:
            md5_hex = chunks[0].etag  # the chunk md5 IS the file md5
        else:
            md5_hex = ""  # readers fall back to ETagChunks
        entry = Entry(full_path=path, mime=mime,
                      ttl_sec=_ttl_seconds(ttl),
                      md5=md5_hex, collection=collection,
                      replication=replication, chunks=chunks,
                      extended=extended, content=small_content)
        self.filer.create_entry(entry, signatures=signatures,
                                gc_old_chunks=True)
        metrics.counter_add("filer_write_bytes", total)
        return json_response(
            {"name": filename, "size": total,
             "etag": entry.md5 or etag_chunks(chunks)}, status=201)

    def handle_delete(self, req: Request) -> Response:
        path = norm_path("/" + req.match_info["path"])
        if self._filer_conf().match(path).read_only:
            return json_response(
                {"error": f"{path} is read-only by filer.conf rule"},
                status=403)
        recursive = req.query.get("recursive", "") in ("true", "1")
        delete_chunks = req.query.get("skipChunkDeletion", "") \
            not in ("true", "1")
        try:
            self.filer.delete_entry(
                path, recursive=recursive, delete_chunks=delete_chunks,
                signatures=_parse_signatures(
                    req.query.get("signatures", "")))
        except OSError:
            # mid-walk failure on a recursive delete: the reference's
            # ?ignoreRecursiveError=true keeps what was deleted
            if not (recursive and req.query.get(
                    "ignoreRecursiveError") == "true"):
                raise
        return json_response({}, status=204)

    # -- KV (filer_grpc_server_kv.go) -----------------------------------
    def handle_kv_get(self, req: Request) -> Response:
        v = self.filer.store.kv_get(req.match_info["key"])
        if v is None:
            return json_response({"error": "not found"}, status=404)
        return Response(v, content_type="application/octet-stream")

    def handle_kv_put(self, req: Request) -> Response:
        key = req.match_info["key"]
        self.filer.store.kv_put(key, req.read())
        if key == FILER_CONF_KEY:
            self._filer_conf_cache = None
        return json_response({})

    def handle_kv_delete(self, req: Request) -> Response:
        self.filer.store.kv_delete(req.match_info["key"])
        return json_response({}, status=204)

    # -- misc -----------------------------------------------------------
    def handle_status(self, req: Request) -> Response:
        return json_response({
            "master": self.master_url, "store": self.filer.store.name,
            "signature": self.filer.meta_log.signature,
            "cipher": False})

    def handle_metrics(self, req: Request) -> Response:
        return text_response(metrics.render(),
                             content_type="text/plain; version=0.0.4")


def _form_file(payload: bytes, content_type: str
               ) -> tuple[bytes, str, str]:
    """A multipart/form-data body -> (the 'file' part's bytes, its file
    name, its Content-Type)."""
    msg = email.message_from_bytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + payload,
        policy=email.policy.HTTP)
    for part in msg.iter_parts():
        if part.get_param("name", header="content-disposition") == "file":
            return (part.get_payload(decode=True) or b"",
                    part.get_filename("") or "",
                    part.get_content_type()
                    if part.get("Content-Type") else "")
    raise ValueError("multipart body without a 'file' part")


def _parse_signatures(raw: str) -> list[int] | None:
    if not raw:
        return None
    try:
        return [int(s) for s in raw.split(",") if s]
    except ValueError:
        return None


def _ttl_seconds(ttl: str) -> int:
    """'3m'/'4h'/'5d'... -> seconds (storage/needle/volume_ttl.go)."""
    if not ttl:
        return 0
    units = {"s": 1, "m": 60, "h": 3600, "d": 86400, "w": 604800,
             "M": 2592000, "y": 31536000}
    if ttl[-1] in units:
        return int(ttl[:-1]) * units[ttl[-1]]
    return int(ttl)
