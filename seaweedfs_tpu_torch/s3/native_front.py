"""Native S3 front orchestration (combined `server -s3 -s3.native`
mode); the counterpart of seaweedfs_tpu/s3/native_front.py.

The C++ front (native/dataplane.cc, ROLE_S3) owns the public S3 port
and serves small-object SigV4 PUT/GET/HEAD/DELETE and part uploads
natively against the volumes this process's volume front has attached;
everything else relays to the Python gateway on its loopback port. This
module is its control plane:

- the APPLIER thread: receives entry records over a socketpair and
  applies them through the in-process `Filer.create_entry` /
  `delete_entry` (parent dirs, old-chunk GC, event log — the metadata
  semantics keep their one implementation), then acks so the front can
  answer the PUT.
- the META listener: registered as a sync listener on the filer's
  event log (`filer.meta_log.sync_listeners`, called under the
  mutation lock), it keeps the front's read cache, bucket set and
  in-flight multipart uploads in exact store order — any mutation path,
  native or Python, invalidates or refreshes the cache with a ZERO
  staleness window (read-after-write holds, as on AWS).
- the REFILL thread: keeps per-bucket pre-assigned fid pools topped up
  from the master (one `?count=N` slot batch per refill) and re-pushes
  the identity table when the IAM config reloads.

Reference equivalents: s3api_object_handlers_put.go (the compiled PUT
path this front mirrors), auth_credentials.go (identity sync),
s3api_bucket_registry (the bucket set).
"""
from __future__ import annotations

import socket
import threading
import time

from ..filer import Entry, FileChunk
from ..utils import faults
from .auth import ACTION_ADMIN, ACTION_READ, ACTION_WRITE

BUCKETS_DIR = "/buckets"
UPLOADS_DIR = ".uploads"
POOL_LOW = 512
POOL_BATCH = 2048
CACHEABLE_MAX = 8 << 20


class NativeS3Front:
    def __init__(self, s3_server, filer, master_url: str,
                 listen_port: int, backend_port: int,
                 listen_ip: str = ""):
        from ..native.dataplane import S3Front

        self.s3 = s3_server  # S3ApiServer (for iam)
        self.filer = filer   # the in-process Filer
        self.master_url = master_url.rstrip("/")
        self.front = S3Front()
        self._stop = threading.Event()
        self._iam_snapshot = None
        self._buckets: set[str] = set()
        # C++ end / python end of the entry channel
        self._chan_c, self._chan_py = socket.socketpair(
            socket.AF_UNIX, socket.SOCK_STREAM)
        self.port = self.front.start(listen_port, backend_port,
                                     self._chan_c.fileno(),
                                     listen_ip=listen_ip)
        # the C side now owns that fd (dp_s3_stop closes it): detach so
        # this object's GC can't double-close a number the OS may have
        # already handed to an unrelated socket
        self._chan_c.detach()
        # this front's share of -fault.spec (service 's3'), the same
        # mirror-at-spawn contract as the volume front
        self.front.set_faults(*faults.native_params("s3"),
                              seed=faults.seed())
        self._sync_identities()
        self._load_buckets()
        self._load_uploads()
        self.filer.meta_log.sync_listeners.append(self._on_meta_event)
        self._applier = threading.Thread(target=self._applier_loop,
                                         daemon=True,
                                         name="s3front-applier")
        self._applier.start()
        self._refill = threading.Thread(target=self._refill_loop,
                                        daemon=True,
                                        name="s3front-refill")
        self._refill.start()

    def stop(self) -> None:
        self._stop.set()
        try:
            self.filer.meta_log.sync_listeners.remove(self._on_meta_event)
        except ValueError:
            pass
        try:
            self._chan_py.close()
        except OSError:
            pass
        self.front.stop()  # closes the C side of the channel

    def stats(self) -> dict:
        return self.front.stats()

    # -- identities -----------------------------------------------------
    def _sync_identities(self) -> None:
        """Project the IAM config into the front's flat table: per
        access key, global/bucket-scoped read+write booleans (anything
        richer relays to python per request)."""
        iam = self.s3.iam
        with iam._lock:
            idents = list(iam._identities)
        snapshot = [(i.name, tuple(sorted(i.actions)),
                     tuple(c["accessKey"] for c in i.credentials))
                    for i in idents]
        if snapshot == self._iam_snapshot:
            return
        self._iam_snapshot = snapshot
        rows = []
        for ident in idents:
            flags = ""
            if ACTION_ADMIN in ident.actions:
                flags += "A"
            if ACTION_WRITE in ident.actions:
                flags += "W"
            if ACTION_READ in ident.actions:
                flags += "R"
            wr = ",".join(sorted(
                a.split(":", 1)[1] for a in ident.actions
                if a.startswith(f"{ACTION_WRITE}:")))
            rd = ",".join(sorted(
                a.split(":", 1)[1] for a in ident.actions
                if a.startswith(f"{ACTION_READ}:")))
            for cred in ident.credentials:
                rows.append((cred["accessKey"], cred["secretKey"],
                             flags, wr, rd))
        self.front.set_identities(rows)

    # -- buckets --------------------------------------------------------
    def _load_buckets(self) -> None:
        buckets = set()
        entries = self.filer.list_entries(BUCKETS_DIR, limit=10000)
        for e in entries:
            if e.is_directory:
                buckets.add(e.name)
        self._buckets = buckets
        self.front.set_buckets(sorted(buckets))

    def _load_uploads(self) -> None:
        """Mark multipart uploads already in flight at spawn; the meta
        listener keeps the set exact from here on."""
        for bucket in self._buckets:
            entries = self.filer.list_entries(
                f"{BUCKETS_DIR}/{bucket}/{UPLOADS_DIR}", limit=10000)
            for e in entries:
                if e.is_directory:
                    self.front.upload_mark(bucket, e.name, True)

    # -- meta events (SYNC: under the filer mutation lock) --------------
    def _on_meta_event(self, ev: dict) -> None:
        d = ev["directory"]
        if not (d == BUCKETS_DIR or d.startswith(BUCKETS_DIR + "/")):
            return
        for which in ("old_entry", "new_entry"):
            ent = ev[which]
            if ent is None:
                continue
            full = ent["full_path"]
            rel = full[len(BUCKETS_DIR):]
            if not rel:
                continue
            is_dir = bool(ent.get("mode", 0) & 0o40000)
            if rel.count("/") == 1:  # /bucket — bucket set changes
                name = rel[1:]
                if is_dir:
                    if which == "old_entry" and ev["new_entry"] is None:
                        self._buckets.discard(name)
                        self.front.invalidate(rel + "/", prefix=True)
                    else:
                        self._buckets.add(name)
                    self.front.set_buckets(sorted(self._buckets))
                continue
            # /bucket/.uploads/<id> marker dirs gate the native
            # part-upload path: present from initiate until
            # complete/abort deletes the directory
            segs = rel.split("/")
            if is_dir and len(segs) == 4 and segs[2] == UPLOADS_DIR:
                present = not (which == "old_entry"
                               and ev["new_entry"] is None)
                self.front.upload_mark(segs[1], segs[3], present)
            if which == "old_entry" or ev["new_entry"] is None \
                    or is_dir:
                self.front.invalidate(rel, prefix=is_dir)
                continue
            self._maybe_cache(rel, ent)

    def _maybe_cache(self, s3_path: str, ent: dict) -> None:
        chunks = ent.get("chunks") or []
        if (len(chunks) != 1 or ent.get("hard_link_id")
                or ent.get("symlink_target") or ent.get("ttl_sec")):
            # TTL'd entries never enter the cache: python-side expiry
            # (filer._expire) emits no meta event, so a cached copy
            # would outlive the object
            self.front.invalidate(s3_path)
            return
        ch = chunks[0]
        if (ch.get("offset", 0) != 0 or ch.get("cipher_key")
                or ch.get("is_compressed") or ch.get("is_chunk_manifest")
                or ch.get("size", 0) > CACHEABLE_MAX):
            self.front.invalidate(s3_path)
            return
        etag = ent.get("md5") or ch.get("etag", "")
        meta_lines = []
        for k, v in (ent.get("extended") or {}).items():
            if not k.startswith("s3_meta_"):
                continue
            if not (isinstance(v, str) and v.isascii() and v.isprintable()):
                self.front.invalidate(s3_path)
                return
            meta_lines.append(f"x-amz-meta-{k[8:]}: {v}\r\n")
        try:
            self.front.cache_put(
                s3_path, ch["fid"], ch.get("size", 0), etag,
                ent.get("mime") or "", "".join(meta_lines),
                int(ent.get("mtime", 0)))
        except ValueError:
            self.front.invalidate(s3_path)

    # -- the applier ----------------------------------------------------
    def _applier_loop(self) -> None:
        buf = b""
        sock = self._chan_py
        while not self._stop.is_set():
            try:
                data = sock.recv(1 << 16)
            except OSError:
                break
            if not data:
                break
            buf += data
            acks = []
            store = self.filer.store
            store.begin_batch()  # ONE WAL flush for the whole burst
            try:
                while True:
                    nl = buf.find(b"\n")
                    if nl < 0:
                        break
                    line, buf = buf[:nl], buf[nl + 1:]
                    acks.append(self._apply_one(line))
            finally:
                store.end_batch()  # durable BEFORE any ack goes out
            if acks:
                try:
                    sock.sendall("".join(acks).encode())
                except OSError:
                    break

    def _apply_one(self, line: bytes) -> str:
        # TSV record from the front (see s3_handle_put/_delete/_part):
        #   id \t put \t bucket \t key \t fid \t size \t etag \t mime
        #   [\t k=v]...          |  id \t del \t bucket \t key
        #   |  id \t part \t bucket \t upload_id \t part_number \t fid
        #   \t size \t etag
        rec_id = b"0"
        try:
            cols = line.split(b"\t")
            rec_id = cols[0]
            op = cols[1]
            bucket = cols[2].decode()
            key = cols[3].decode()
            if op == b"part":
                # same entry _upload_part's filer POST would create:
                # part md5 = md5 of the PART bytes (fullmd5), one chunk,
                # never inlined (saveInside=false)
                etag = cols[7].decode()
                path = (f"{BUCKETS_DIR}/{bucket}/{UPLOADS_DIR}/{key}/"
                        f"{int(cols[4]):05d}.part")
                entry = Entry(
                    full_path=path, mime="application/octet-stream",
                    md5=etag, collection=bucket,
                    chunks=[FileChunk(fid=cols[5].decode(), offset=0,
                                      size=int(cols[6]),
                                      mtime_ns=time.time_ns(),
                                      etag=etag)])
                self.filer.create_entry(entry, gc_old_chunks=True)
                return f"{rec_id.decode()} 200\n"
            path = f"{BUCKETS_DIR}/{bucket}/{key}"
            if op == b"del":
                # delete_entry of a missing path is a no-op — S3
                # DeleteObject answers 204 either way
                self.filer.delete_entry(path)
                return f"{rec_id.decode()} 200\n"
            etag = cols[6].decode()
            extended = {}
            for pair in cols[8:]:
                k, _, v = pair.partition(b"=")
                extended[f"s3_meta_{k.decode()}"] = v.decode()
            entry = Entry(
                full_path=path,
                mime=cols[7].decode(), md5=etag, collection=bucket,
                chunks=[FileChunk(fid=cols[4].decode(), offset=0,
                                  size=int(cols[5]),
                                  mtime_ns=time.time_ns(), etag=etag)],
                extended=extended)
            self.filer.create_entry(entry, gc_old_chunks=True)
            return f"{rec_id.decode()} 200\n"
        except Exception:
            try:
                return f"{int(rec_id)} 500\n"
            except ValueError:
                return "0 500\n"

    # -- fid pools + identity refresh -----------------------------------
    def _refill_loop(self) -> None:
        from ..operation import verbs

        while not self._stop.wait(0.1):
            try:
                self._sync_identities()
            except Exception:
                pass
            for bucket in list(self._buckets):
                try:
                    if self.front.pool_level(bucket) >= POOL_LOW:
                        continue
                    a = verbs.assign(self.master_url, count=POOL_BATCH,
                                     collection=bucket)
                    self.front.push_fids(bucket, a.fid, a.count)
                except Exception:
                    pass  # master busy/unreachable: PUTs relay meanwhile
