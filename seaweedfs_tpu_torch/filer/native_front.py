"""Native filer front orchestration (combined `server -filer
-filer.native` mode); the counterpart of seaweedfs_tpu/filer/
native_front.py.

The C++ front (native/dataplane.cc, ROLE_FILER) owns the public filer
port and serves GET/PUT/HEAD/DELETE of plain files natively against the
volumes this process's volume front has attached, relaying every other
verb and path class to the Python filer on its loopback port. This
module is its control plane, mirroring s3/native_front.py:

- the APPLIER thread: receives entry mutations over a socketpair and
  applies them through the in-process `Filer.create_entry` /
  `delete_entry` (parent dirs, old-chunk GC, event log — the metadata
  semantics keep their one implementation), then acks so the front can
  answer the PUT/DELETE.
- the META listener: registered as a sync listener on the filer's
  event log (called under the mutation lock), it keeps the front's
  entry cache in exact store order — any mutation path, native or
  Python, invalidates or refreshes the cache with a ZERO staleness
  window across both fronts.
- the REFILL thread: keeps the pre-assigned fid pool topped up from
  the master and re-evaluates the WRITES GATE each tick
  (FilerServer.native_writes_ok) — the native PUT/DELETE fast path is
  enabled only while the Python filer would apply its defaults
  verbatim, so a rule edit flips hot writes back to the Python path
  within a tick.
"""
from __future__ import annotations

import mimetypes
import socket
import threading
import time

from ..utils import extheaders, faults, metrics
from .entry import Entry, FileChunk

POOL_LOW = 512
POOL_BATCH = 2048
CACHEABLE_MAX = 8 << 20


class NativeFilerFront:
    def __init__(self, filer_server, master_url: str,
                 listen_port: int, backend_port: int,
                 listen_ip: str = "", workers: int = 2):
        from ..native.dataplane import FilerFront

        self.fs = filer_server        # the FilerServer (python app)
        self.filer = filer_server.filer
        self.master_url = master_url.rstrip("/")
        self.front = FilerFront()
        self._stop = threading.Event()
        self._writes_on = False
        # C++ end / python end of the entry channel
        self._chan_c, self._chan_py = socket.socketpair(
            socket.AF_UNIX, socket.SOCK_STREAM)
        self.port = self.front.start(listen_port, backend_port,
                                     self._chan_c.fileno(),
                                     workers=workers, listen_ip=listen_ip)
        # the C side now owns that fd (dp_filer_stop closes it): detach
        # so this object's GC can't double-close a number the OS may
        # have already handed to an unrelated socket
        self._chan_c.detach()
        # this front's share of -fault.spec (service 'filer'), the
        # same mirror-at-spawn contract as the volume front
        self.front.set_faults(*faults.native_params("filer"),
                              seed=faults.seed())
        self._check_writes_gate()
        self.filer.meta_log.sync_listeners.append(self._on_meta_event)
        self._applier = threading.Thread(target=self._applier_loop,
                                         daemon=True,
                                         name="filerfront-applier")
        self._applier.start()
        self._refill = threading.Thread(target=self._refill_loop,
                                        daemon=True,
                                        name="filerfront-refill")
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

    # -- meta events (SYNC: under the filer mutation lock) --------------
    def _on_meta_event(self, ev: dict) -> None:
        for which in ("old_entry", "new_entry"):
            ent = ev[which]
            if ent is None:
                continue
            full = ent["full_path"]
            if full == "/":
                continue
            is_dir = bool(ent.get("mode", 0) & 0o40000)
            if which == "old_entry" or ev["new_entry"] is None or is_dir:
                self.front.invalidate(full, prefix=is_dir)
                continue
            self._maybe_cache(full, ent)

    def _maybe_cache(self, path: str, ent: dict) -> None:
        """Admit only entries the C front can serve byte-identically to
        handle_get: one plain local chunk, nothing that changes the
        read path (inline content, manifests, cipher, compression,
        links, TTL expiry — python-side expiry emits no meta event, so
        a cached copy would outlive the object)."""
        chunks = ent.get("chunks") or []
        if (len(chunks) != 1 or ent.get("content")
                or ent.get("hard_link_id") or ent.get("symlink_target")
                or ent.get("ttl_sec")):
            self.front.invalidate(path)
            return
        ch = chunks[0]
        if (ch.get("offset", 0) != 0 or ch.get("cipher_key")
                or ch.get("is_compressed") or ch.get("is_chunk_manifest")
                or ch.get("size", 0) > CACHEABLE_MAX):
            self.front.invalidate(path)
            return
        # the exact header set handle_get derives per request,
        # precomputed once per mutation
        etag = ent.get("md5") or ch.get("etag", "")
        mime = (ent.get("mime") or mimetypes.guess_type(path)[0]
                or "application/octet-stream")
        ext_lines = [f"x-seaweed-ext-{k}: {extheaders.armor(v)}\r\n"
                     for k, v in (ent.get("extended") or {}).items()
                     if k.startswith("s3_")]
        try:
            self.front.cache_put(
                path, ch["fid"], ch.get("size", 0), etag, mime,
                "".join(ext_lines), int(ent.get("mtime", 0)))
        except ValueError:
            self.front.invalidate(path)

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
        # TSV record from the front (see filer_handle_put/_delete):
        #   id \t put \t path \t fid \t size \t etag \t mime
        #   |  id \t del \t path
        rec_id = b"0"
        try:
            cols = line.split(b"\t")
            rec_id = cols[0]
            op = cols[1]
            path = cols[2].decode()
            if op == b"del":
                # same call handle_delete makes (non-recursive,
                # chunks reclaimed); missing path is a no-op — the
                # python DELETE answers 204 either way
                self.filer.delete_entry(path)
                return f"{rec_id.decode()} 200\n"
            size = int(cols[4])
            etag = cols[5].decode()
            # the entry handle_put would create for a single-chunk
            # body: chunk md5 IS the file md5, server-default
            # collection/replication (the writes gate guarantees no
            # filer.conf rule would have said otherwise)
            entry = Entry(
                full_path=path, mime=cols[6].decode(), md5=etag,
                collection=self.fs.collection,
                replication=self.fs.replication,
                chunks=[FileChunk(fid=cols[3].decode(), offset=0,
                                  size=size, mtime_ns=time.time_ns(),
                                  etag=etag)])
            self.filer.create_entry(entry, gc_old_chunks=True)
            metrics.counter_add("filer_write_bytes", size)
            return f"{rec_id.decode()} 200\n"
        except Exception:
            try:
                return f"{int(rec_id)} 500\n"
            except ValueError:
                return "0 500\n"

    # -- writes gate + fid pool -----------------------------------------
    def _check_writes_gate(self) -> None:
        """Native PUT/DELETE only while the Python write path would be
        a pure default single-chunk create (FilerServer.native_writes_ok)."""
        ok = self.fs.native_writes_ok()
        if ok != self._writes_on:
            self._writes_on = ok
            self.front.set_writes(ok)

    def _refill_loop(self) -> None:
        from ..operation import verbs

        while not self._stop.wait(0.1):
            try:
                self._check_writes_gate()
            except Exception:
                pass
            if not self._writes_on:
                continue
            try:
                if self.front.pool_level() >= POOL_LOW:
                    continue
                a = verbs.assign(self.master_url, count=POOL_BATCH,
                                 collection=self.fs.collection)
                self.front.push_fids(a.fid, a.count)
            except Exception:
                pass  # master busy/unreachable: PUTs relay meanwhile
