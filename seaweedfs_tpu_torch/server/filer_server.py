"""Filer server: the namespace over HTTP, its KV side channel, the
DLM's lock routes, the metadata subscription stream and remote mounts;
the counterpart of seaweedfs_tpu/server/filer_server.py.

Equivalents: SeaweedFS weed/server/filer_server_handlers_write_autochunk.go:25-130
(upload auto-chunking), filer_server_handlers_read.go (ranged streaming
reads), _read_dir.go (listing), filer_grpc_server_kv.go (KV),
filer_grpc_server_dlm.go (the distributed lock manager),
filer_grpc_server_sub_meta.go (metadata subscription — here a
websocket), filer_grpc_server_remote.go (remote mounts) and the rename
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
shared pool. Every route runs behind the tracing, deadline (an edge
server: it mints the budget when the client sent none) and fault
middlewares (rpc/http.server_middlewares) with the reference's 1 TiB
body cap; /debug/traces, /debug/breakers, /debug/ec and /debug/filer
serve this process's spans, breakers, codec router and store. Replica
urls come breaker-healthy first (wdclient.lookup_file_id_urls).

Per-tenant qos (utils/qos.py) sits between the deadline and the fault
middlewares, as in the reference: the tenant is a path's first
segment, the control-plane routes (/dlm/, /kv/, /debug/, /status,
/metrics) are never shaped, /debug/qos serves the registry and /metrics
exports the tenants' demand gauges. Under a jwt secret each chunk
upload carries the assign's token, and a pooled batch slot older than
`_FID_TOKEN_MAX_AGE` is skipped (tokens are valid 10 s).

The native filer front (filer/native_front.py, `server -filer.native`)
owns the public port when it runs: this app serves what it relays, and
`native_writes_ok` is the gate that lets the front take PUT and DELETE
while this server would apply its defaults verbatim.

/ws/meta_subscribe (`path_prefix`, `since_ns`, `client_id`) streams the
event log (filer/event_log.py) as one text frame of event JSON per
mutation under the prefix, from the first event after `since_ns`. Each
subscription holds its connection's thread; stop ends every one of them
(their sockets are shut down and their loops see the stop flag).

Remote mounts (remote_storage/mount.py, the KV key etc/remote.conf):
an entry under a mount with no chunks and an `extended["remote"]`
record is read through to its cloud object, whole or ranged (streamed
in `-maxMB` pieces); `?cacheRemote` copies its bytes into volumes in
`-maxMB` chunks of the entry's collection, `?uncacheRemote` drops them
again (the deletion thread frees them); both verbs pass a read-only
filer.conf rule, as they move bytes, not content. A KV write of the
conf drops the cached conf and clients at once (another filer's edit
is seen within _REMOTE_CONF_TTL).

-encryptVolumeData seals every chunk with AES-256-GCM under a key of
its own (utils/cipher.py), kept in the entry; reads decrypt whole
chunks. `-filer.store.shards` wraps the store kind in `sharded`, and
`-filer.cache.*` puts the read-through CachingStore in front of it,
invalidated by the meta log's sync listener.

A directory GET that accepts text/html and not application/json gets
the reference's browser listing: an HTML table with escaped names,
percent-encoded links and a next-page link that keeps the filters.
"""
from __future__ import annotations

import base64
import binascii
import collections
import contextvars
import email
import email.policy
import functools
import hashlib
import json
import mimetypes
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable

from ..cluster.lock_manager import (DistributedLockManager, LockMoved,
                                    LockNotOwned, RingEmpty)
from ..filer import (CachingStore, Entry, FileChunk, Filer, etag_chunks,
                     iter_content, make_store, maybe_manifestize,
                     norm_path, read_fid, resolve_chunk_manifest,
                     stream_content)
from ..filer.filechunks import MANIFEST_BATCH
from ..filer.filer import DirectoryNotEmptyError
from ..filer.filer_conf import CONF_KEY as FILER_CONF_KEY
from ..filer.filer_conf import FilerConf
from ..filer.store_cache import DEFAULT_ENTRIES, DEFAULT_PAGES
from ..operation import verbs
from ..rpc.http import (App, Request, Response, debug_index_factory,
                        server_middlewares,
                        json_response, text_response)
from ..rpc.httpclient import session
from ..rpc.websocket import WebSocket, upgrade
from ..utils import (cipher as cip, compression, extheaders, glog,
                     httprange, metrics, qos, retry, tracing)
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
    JSON {"error": ...}, and the request time observed. Keeps the
    handler's name, which names its server span."""
    @functools.wraps(handler)
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
    # a pooled slot older than this is skipped under a jwt secret: the
    # master's write tokens are valid 10 s
    _FID_TOKEN_MAX_AGE = 7.0
    DELETION_INTERVAL = 0.3
    _FILER_CONF_TTL = 2.0  # backstop for edits via another filer
    _REMOTE_CONF_TTL = 2.0  # backstop for conf edits via another filer
    # how often an idle subscription looks at its stop flag
    SUBSCRIBE_POLL = 0.25

    def __init__(self, master_url: str, store: str = "memory",
                 store_path: str = ":memory:",
                 collection: str = "", replication: str = "",
                 chunk_size: int = DEFAULT_CHUNK_SIZE,
                 signature: int = 0,
                 announce_pulse: float = 3.0,
                 store_options: dict | None = None,
                 cipher: bool = False,
                 save_to_filer_limit: int = 0,
                 store_shards: int = 0,
                 cache_entries: int = 0,
                 cache_pages: int = 0):
        self.masters = MasterClient(master_url)
        self.collection = collection
        self.replication = replication
        self.chunk_size = chunk_size
        # -saveToFilerLimit: bodies under this many bytes live INSIDE
        # the metadata entry (entry.content) — zero volume round trips
        # for tiny files (command/filer.go:85, uploadReaderToChunks:83)
        self.save_to_filer_limit = save_to_filer_limit
        # -encryptVolumeData: every chunk this filer writes is AES-GCM
        # ciphertext under a per-chunk key kept in the entry metadata
        # (filer_server_handlers_write_cipher.go; util/cipher.go)
        self.cipher = cipher
        # -filer.store.shards: partition the namespace across N child
        # engines of the requested kind (filer/sharded_store.py) so
        # compaction parallelizes and stays per-shard
        if store_shards > 1 and isinstance(store, str) \
                and store != "sharded":
            store = make_store("sharded", path=store_path,
                               shards=store_shards, child=store,
                               child_options=store_options or {})
        self.filer = Filer(store, on_delete_chunks=self._delete_chunks,
                           signature=signature, path=store_path,
                           **(store_options or {}))
        # -filer.cache.*: read-through entry + listing-page cache,
        # exactly invalidated through the meta event log (zero
        # staleness for the Python and the native mutation paths)
        if cache_entries > 0 or cache_pages > 0:
            cached = CachingStore(
                self.filer.store,
                entries=cache_entries or DEFAULT_ENTRIES,
                pages=cache_pages or DEFAULT_PAGES)
            cached.attach(self.filer.meta_log)
            self.filer.store = cached
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
        self._remote_conf_cache = None
        self._remote_clients: dict[tuple, object] = {}
        self._subscribers: set[WebSocket] = set()
        self._subs_lock = threading.Lock()
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
        with self._subs_lock:
            subscribers = list(self._subscribers)
        for ws in subscribers:
            ws.abort()      # a subscriber blocked on a send ends too
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
        app = App(middlewares=server_middlewares(
                      "filer", edge=True, qos_tenant=qos.filer_tenant),
                  max_body=1 << 40)
        app.get("/status", self.handle_status)
        app.get("/metrics", self.handle_metrics)
        # /debug index BEFORE the catch-all path routes below, or the
        # filer would treat it as a file read
        app.get("/debug", debug_index_factory("filer", {
            "/status": "master, store and signature",
            "/metrics": "Prometheus text exposition",
            "/debug/traces": "recent spans recorded in-process",
            "/debug/breakers": "circuit breaker states",
            "/debug/qos": "per-tenant admission buckets + shed counts",
            "/debug/ec": "EC codec router: probe curve + backends",
            "/debug/filer": "metadata store kind and entries",
        }))
        app.get("/debug/traces", tracing.handle_debug_traces)
        app.get("/debug/breakers", retry.handle_debug_breakers)
        app.get("/debug/qos", qos.handle_debug_qos)
        app.get("/debug/ec", self.handle_debug_ec)
        app.get("/debug/filer", self.handle_debug_filer)
        app.get("/ws/meta_subscribe", self.handle_meta_subscribe)
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
            now = time.monotonic()
            while pool:
                url, fid, auth, ts = pool.popleft()
                if auth and now - ts > self._FID_TOKEN_MAX_AGE:
                    continue    # a signed slot expires with its jwt
                return url, fid, auth
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
        # slot fids share the base fid's volume, cookie and token
        # (ParsePath:121-141; the guard strips the _N before its check)
        ts = time.monotonic()
        with self._fid_lock:
            pool.extend((a.url, f"{a.fid}_{i}", a.auth, ts)
                        for i in range(1, int(a.count)))
        return a.url, a.fid, a.auth

    def _upload_chunk(self, data: bytes, name: str, collection: str,
                      replication: str, ttl: str, disk_type: str = "",
                      fsync: bool = False,
                      data_center: str = "") -> tuple[str, str, bytes]:
        """-> (fid, etag, cipher_key). A compressible name is shipped
        so the volume server stores the chunk gzipped; opaque payloads
        omit it. With -encryptVolumeData the volume server receives only
        ciphertext (never compressed); the etag stays the md5 of the
        PLAINTEXT so content addressing (S3 ETag, sync signatures) is
        cipher-independent."""
        etag = hashlib.md5(data).hexdigest()
        ckey = b""
        if self.cipher:
            ckey = cip.gen_cipher_key()
            data = cip.encrypt(data, ckey)
        params = {}
        if fsync:  # ?fsync=true / filer.conf rule: durable before ack
            params["fsync"] = "true"
        if not self.cipher and name and compression.is_compressible(
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
                    return fid, etag, ckey
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

    # -- remote storage (weed/filer/remote_storage.go) ------------------
    def _remote_conf(self):
        """Cached remote conf: dropped on local KV writes of the conf
        key, TTL-refreshed otherwise — read-through GETs must not pay a
        store read + JSON parse per request."""
        from ..remote_storage import RemoteConf
        from ..remote_storage.mount import CONF_KEY

        cached = self._remote_conf_cache
        now = time.monotonic()
        if cached is not None and now - cached[1] < self._REMOTE_CONF_TTL:
            return cached[0]
        raw = self.filer.store.kv_get(CONF_KEY)
        conf = RemoteConf.from_json(raw) if raw else RemoteConf()
        self._remote_conf_cache = (conf, now)
        return conf

    def _invalidate_remote_conf(self, key: str) -> None:
        from ..remote_storage.mount import CONF_KEY

        if key == CONF_KEY:
            self._remote_conf_cache = None
            self._remote_clients = {}
        if key == FILER_CONF_KEY:
            self._filer_conf_cache = None

    def _remote_client_for(self, path: str):
        """-> (client, object key) for a path under a remote mount, or
        None when the path isn't mounted. Clients are memoized per
        storage name and conf."""
        from ..remote_storage import find_mount, make_client, remote_key_for

        conf = self._remote_conf()
        mount = find_mount(conf, path)
        if mount is None:
            return None
        storage = conf.storages.get(mount.storage)
        if storage is None:
            return None
        clients = self._remote_clients
        ck = (mount.storage, json.dumps(storage, sort_keys=True))
        if ck not in clients:
            clients[ck] = make_client(storage)
        return clients[ck], remote_key_for(mount, path)

    def native_writes_ok(self) -> bool:
        """The native filer front's writes gate (filer/native_front.py):
        True while a PUT here would be a pure default single-chunk
        create — no filer.conf rule (ttl, fsync, read-only, per-path
        collection...), no -saveToFilerLimit inlining, no replicated
        default placement, no -encryptVolumeData — so the front may
        take PUT/DELETE itself."""
        if self.cipher or self.save_to_filer_limit > 0 or \
                self.replication not in ("", "000"):
            return False
        try:
            return not self._filer_conf().rules
        except Exception:  # noqa: BLE001 — an unreadable conf relays
            return False

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
        # an uncached remote entry: metadata only, the bytes still in
        # the cloud — read through (cache explicitly with remote.cache)
        remote_meta = None
        if not entry.chunks and entry.extended.get("remote"):
            remote_meta = json.loads(entry.extended["remote"])
        size = int(remote_meta["size"]) if remote_meta \
            else entry.file_size
        etag = entry.md5 or (remote_meta or {}).get("etag") \
            or etag_chunks(entry.chunks)
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
        if entry.content and not entry.chunks and remote_meta is None:
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
        if remote_meta is not None:
            return self._read_through(path, remote_meta, multi, offset,
                                      length, status, headers, mime, size)
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

    def _read_through(self, path: str, remote_meta: dict,
                      multi: list[tuple[int, int]] | None, offset: int,
                      length: int, status: int, headers: dict, mime: str,
                      size: int) -> Response:
        """The bytes of an uncached remote entry, from its cloud object:
        several ranges as multipart/byteranges, else one span streamed
        in chunk_size pieces (an empty span streams nothing)."""
        found = self._remote_client_for(path)
        if found is None:
            return json_response(
                {"error": f"{path} is remote but its mount/storage is no "
                          "longer configured"}, status=502)
        client, _ = found
        key = remote_meta["key"]
        if multi is not None:
            parts = [(m_off, m_len, client.read_file(key, m_off, m_len))
                     for m_off, m_len in multi]
            mbody, mct = httprange.multipart_byteranges(parts, mime, size)
            headers["Content-Type"] = mct
            return Response(mbody, 206, headers)
        end = offset + length

        def read(at: int) -> bytes:
            piece = client.read_file(key, at, min(self.chunk_size, end - at))
            if not piece:
                raise IOError(f"remote object {key} ended at {at}, "
                              f"expected {end} bytes")
            return piece

        # the first piece before the status goes out: a cloud that fails
        # is answered as an error, as the reference answers it
        first = read(offset) if length else b""

        def pieces():
            at = offset + len(first)
            if first:
                yield first
            while at < end:
                piece = read(at)
                at += len(piece)
                yield piece

        return Response(status=status, headers=headers, length=length,
                        stream=pieces())

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
        accept = req.headers.get("Accept", "")
        if "text/html" in accept and "application/json" not in accept:
            # browser view (server/filer_ui/ equivalent); API clients
            # send Accept: application/json (or nothing) and get JSON.
            # Names are client-chosen: escape text and percent-encode
            # hrefs or an uploaded filename becomes stored XSS.
            import html as _html
            import urllib.parse as _up

            rows = []
            for e in entries:
                label = _html.escape(
                    e.name + ("/" if e.is_directory else ""))
                href = (_up.quote(path.rstrip("/"), safe="/") + "/"
                        + _up.quote(e.name, safe=""))
                size = "-" if e.is_directory else f"{e.file_size:,}"
                mtime = time.strftime("%Y-%m-%d %H:%M:%S",
                                      time.localtime(e.mtime))
                rows.append(
                    f'<tr><td><a href="{href}">{label}</a></td>'
                    f"<td>{size}</td><td>{mtime}</td></tr>")
            up = path.rstrip("/").rsplit("/", 1)[0] or "/"
            more = ""
            if len(entries) == limit:  # browser pagination — keep the
                # listing filters on the next-page link
                qs = {"lastFileName": entries[-1].name,
                      "limit": str(limit)}
                for k, v in (("prefix", prefix),
                             ("namePattern", pattern),
                             ("namePatternExclude", pattern_exclude)):
                    if v:
                        qs[k] = v
                more = (f'<p><a href="?{_up.urlencode(qs)}">'
                        f"next page &raquo;</a></p>")
            page = (f"<html><body><h1>seaweedfs-tpu filer</h1>"
                    f"<p>{_html.escape(path)}</p>"
                    f'<p><a href="{_up.quote(up, safe="/")}">..</a>'
                    f"</p>"
                    f"<table border=1 cellpadding=4><tr><th>name</th>"
                    f"<th>size</th><th>modified</th></tr>"
                    f"{''.join(rows)}</table>{more}</body></html>")
            # aiohttp's text= reply names its charset
            return Response(page.encode(),
                            content_type="text/html; charset=utf-8",
                            headers={"X-Seaweed-Entry": "dir"})
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
        # remote cache / uncache are exempt: they move bytes, not content
        rule = self._filer_conf().match(path)
        if rule.read_only and "cacheRemote" not in req.query \
                and "uncacheRemote" not in req.query:
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
        if "cacheRemote" in req.query:
            return self._cache_remote(path, signatures)
        if "uncacheRemote" in req.query:
            return self._uncache_remote(path, signatures)
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
        # filer-wide -saveToFilerLimit; never under -encryptVolumeData
        # (inline bytes would bypass the cipher)
        inline_limit = 0
        save_inside = req.query.get("saveInside", "")
        if not self.cipher:
            if save_inside == "true":
                inline_limit = self.chunk_size
            elif save_inside == "false":
                # explicit opt-out: S3 multipart parts must keep chunks
                inline_limit = 0
            elif self.save_to_filer_limit > 0:
                inline_limit = min(self.save_to_filer_limit,
                                   self.chunk_size)

        chunks: list[FileChunk] = []
        pending: list[tuple[int, int, Future]] = []
        small_content = b""
        total = offset = 0

        def collect_oldest() -> None:
            poff, psize, fut = pending.pop(0)
            fid, etag, ckey = fut.result()
            chunks.append(FileChunk(fid=fid, offset=poff, size=psize,
                                    mtime_ns=time.time_ns(), etag=etag,
                                    cipher_key=ckey))

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
                # copy_context: pool.submit drops contextvars, which
                # would lose the trace and the deadline
                pending.append((offset, len(piece), self._uploads.submit(
                    contextvars.copy_context().run,
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
                    fid = fut.result()[0]
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
            def save_manifest(b: bytes) -> tuple[str, bytes]:
                fid, _etag, ckey = self._upload_chunk(
                    b, filename, collection, replication, ttl, disk_type,
                    fsync=fsync, data_center=data_center)
                return fid, ckey

            chunks = maybe_manifestize(save_manifest, chunks)
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

    def _cache_remote(self, path: str,
                      signatures: list[int] | None) -> Response:
        """Pull a remote entry's bytes into cluster chunks
        (CacheRemoteObjectToLocalCluster, filer_grpc_server_remote.go):
        afterwards reads are local; the remote metadata stays so uncache
        can drop the copy again."""
        entry = self.filer.find_entry(path)
        if entry is None or entry.is_directory:
            return json_response({"error": f"no file at {path}"},
                                 status=404)
        if not entry.extended.get("remote"):
            return json_response(
                {"error": f"{path} is not a remote entry"}, status=400)
        if entry.chunks:  # already cached
            return json_response(entry.to_dict())
        meta = json.loads(entry.extended["remote"])
        found = self._remote_client_for(path)
        if found is None:
            return json_response(
                {"error": "mount/storage no longer configured"},
                status=502)
        client, _ = found
        name = path.rsplit("/", 1)[-1]
        chunks, offset = [], 0
        size = int(meta["size"])
        while offset < size:  # empty files need no chunks
            want = min(self.chunk_size, size - offset)
            piece = client.read_file(meta["key"], offset, want)
            if not piece:
                self._delete_chunks(chunks)
                return json_response(
                    {"error": f"remote object {meta['key']} ended at "
                              f"{offset}, expected {size} bytes"},
                    status=502)
            fid, etag, ckey = self._upload_chunk(
                piece, name, entry.collection, entry.replication, "")
            chunks.append(FileChunk(fid=fid, offset=offset,
                                    size=len(piece),
                                    mtime_ns=time.time_ns(), etag=etag,
                                    cipher_key=ckey))
            offset += len(piece)
        entry.chunks = chunks
        self.filer.create_entry(entry, signatures=signatures)
        return json_response(entry.to_dict())

    def _uncache_remote(self, path: str,
                        signatures: list[int] | None) -> Response:
        """Drop the local chunk copy of a cached remote entry, leaving
        metadata that reads through to the cloud again
        (shell command_remote_uncache.go)."""
        entry = self.filer.find_entry(path)
        if entry is None or entry.is_directory:
            return json_response({"error": f"no file at {path}"},
                                 status=404)
        if not entry.extended.get("remote"):
            return json_response(
                {"error": f"{path} is not a remote entry"}, status=400)
        dead = entry.chunks
        entry.chunks = []
        self.filer.create_entry(entry, signatures=signatures)
        self._delete_chunks(dead)  # queued; the deletion thread frees them
        return json_response(entry.to_dict())

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
        self._invalidate_remote_conf(key)
        return json_response({})

    def handle_kv_delete(self, req: Request) -> Response:
        self.filer.store.kv_delete(req.match_info["key"])
        return json_response({}, status=204)

    # -- metadata subscription (filer_grpc_server_sub_meta.go) ----------
    def handle_meta_subscribe(self, req: Request) -> Response:
        """Push metadata events (filer.proto:57-60 SubscribeMetadata).
        Query: path_prefix, since_ns, client_id (signature)."""
        prefix = req.query.get("path_prefix", "/")
        since = int(req.query.get("since_ns", "0"))
        under = prefix.rstrip("/") + "/"

        def serve(ws: WebSocket) -> None:
            ended = threading.Event()

            def read() -> None:    # answers pings; sees the client go
                while ws.receive() is not None:
                    pass
                ended.set()

            sid, q = self.filer.meta_log.subscribe(since_ts_ns=since)
            with self._subs_lock:
                self._subscribers.add(ws)
            threading.Thread(target=read, name="meta-subscribe-read",
                             daemon=True).start()
            try:
                while not ended.is_set() and not self._stop.is_set():
                    try:
                        ev = q.get(timeout=self.SUBSCRIBE_POLL)
                    except queue.Empty:
                        continue
                    if (ev["directory"] + "/").startswith(under):
                        ws.send_json(ev)
            except OSError:
                pass            # the client went away mid-send
            finally:
                self.filer.meta_log.unsubscribe(sid)
                with self._subs_lock:
                    self._subscribers.discard(ws)
        return upgrade(req, serve)

    # -- misc -----------------------------------------------------------
    def handle_status(self, req: Request) -> Response:
        return json_response({
            "master": self.master_url, "store": self.filer.store.name,
            "signature": self.filer.meta_log.signature,
            # mounts/clients writing chunks directly must match the
            # filer's encryption (GetFilerConfiguration.cipher)
            "cipher": self.cipher})

    def handle_debug_filer(self, req: Request) -> Response:
        """GET /debug/filer — metadata-store snapshot: shard geometry
        and sizes, cache hit/negative/evict counters, compaction debt
        (segments awaiting merge per engine)."""
        from ..filer.sharded_store import _child_snapshot

        store = self.filer.store
        snap = getattr(store, "debug_snapshot", None)
        return json_response({
            "store": store.name,
            "snapshot": snap() if snap else _child_snapshot(store),
        })

    def handle_debug_ec(self, req: Request) -> Response:
        """GET /debug/ec — the codec router's probe curve and
        decisions, from its cache (never a sweep)."""
        from ..ec import backend as ec_backend

        return json_response(ec_backend.probe_snapshot())

    def handle_metrics(self, req: Request) -> Response:
        # sharded/cached stores refresh their gauges per scrape so the
        # master's federation picks up live per-shard + cache numbers
        publish = getattr(self.filer.store, "publish_metrics", None)
        if publish is not None:
            publish()
        # per-tenant demand sketches -> workload_tenant_* gauges: tenant
        # demand rides the federation to the master's aggregator
        qos.export_demand_metrics()
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
