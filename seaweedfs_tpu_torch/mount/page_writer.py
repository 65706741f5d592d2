"""Dirty-page writer: buffers writes per open file in fixed-size chunk
slots, seals completed slots, and uploads sealed chunks through a
bounded concurrent pipeline while writes continue; the counterpart of
seaweedfs_tpu/mount/page_writer.py.

Equivalent of SeaweedFS weed/mount/page_writer/ +
dirty_pages_chunked.go: "moving" chunks accept writes; a chunk is
sealed (and queued for upload) when the write cursor moves past it or
on flush; the upload pipeline bounds in-flight chunk uploads
(upload_pipeline.go) so a big sequential write streams at pipeline
depth instead of buffering the whole file. Random writes inside a
not-yet-sealed chunk mutate the buffer in place; writes into an
already-sealed slot start a fresh version whose later mtime wins
overlap resolution (filer/filechunks.py) — the same last-writer-wins
the reference gets from chunk mtimes.

Dirty memory is BOUNDED (page_writer.go MemoryChunkPages +
swapfile_chunk_pages: sealed chunks past the cap live in a swap file):
slot buffers and retained sealed payloads are byte-accounted against
`memory_limit`; sealed payloads past the cap spill to an append-only
swap file (reads overlay from disk, uploads materialize lazily in the
pipeline worker), and when unsealed slots alone exceed the cap the
least-recently-written slots are force-sealed. A random-write load far
larger than the cap therefore runs in O(cap) RSS instead of OOMing the
mount.
"""
from __future__ import annotations

import contextvars
import os
import tempfile
import threading
from concurrent.futures import Future, ThreadPoolExecutor

from ..filer.entry import FileChunk


class _SwapFile:
    """Append-only spill space for sealed-but-unflushed payloads.

    Reset (truncated) whenever a flush drains every pending upload, so
    steady-state size tracks one flush interval's spill, not file
    history. Thread-safe via pread/pwrite on a raw fd."""

    def __init__(self, directory: str | None):
        fd, path = tempfile.mkstemp(
            prefix="weedmount-swap-", dir=directory or None)
        os.unlink(path)  # anonymous: vanishes with the fd
        self._fd = fd
        self._tail = 0
        self._lock = threading.Lock()

    def put(self, data: bytes) -> tuple[int, int]:
        with self._lock:
            off = self._tail
            self._tail += len(data)
        os.pwrite(self._fd, data, off)
        return off, len(data)

    def get(self, off: int, size: int) -> bytes:
        return os.pread(self._fd, size, off)

    def reset(self) -> None:
        with self._lock:
            os.ftruncate(self._fd, 0)
            self._tail = 0

    @property
    def size(self) -> int:
        return self._tail

    def close(self) -> None:
        try:
            os.close(self._fd)
        except OSError:
            pass


class _Slot:
    """One chunk-sized window of the file being written."""

    __slots__ = ("index", "buf", "spans", "seq")

    def __init__(self, index: int, chunk_size: int):
        self.index = index
        self.buf = bytearray(chunk_size)
        self.spans: list[tuple[int, int]] = []  # merged [start, end)
        self.seq = 0  # last-write order, for force-seal LRU

    def write(self, off: int, data: bytes) -> None:
        self.buf[off:off + len(data)] = data
        self.spans = _merge(self.spans + [(off, off + len(data))])

    def read_into(self, out: bytearray, slot_off: int, out_off: int,
                  n: int) -> list[tuple[int, int]]:
        """Copy the written parts of [slot_off, slot_off+n) into out;
        returns the covered (absolute-in-slot) ranges."""
        covered = []
        for s, e in self.spans:
            lo, hi = max(s, slot_off), min(e, slot_off + n)
            if lo < hi:
                out[out_off + lo - slot_off:out_off + hi - slot_off] = \
                    self.buf[lo:hi]
                covered.append((lo, hi))
        return covered

    @property
    def extent(self) -> int:
        return self.spans[-1][1] if self.spans else 0


def _merge(spans: list[tuple[int, int]]) -> list[tuple[int, int]]:
    spans = sorted(spans)
    out: list[tuple[int, int]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class DirtyPages:
    """Per-filehandle dirty state + upload pipeline."""

    def __init__(self, upload_fn, chunk_size: int = 8 << 20,
                 pipeline: ThreadPoolExecutor | None = None,
                 memory_limit: int = 64 << 20,
                 swap_dir: str | None = None):
        """upload_fn(bytes) -> fid or (fid, cipher_key); pipeline is
        shared across handles (the mount's bounded concurrent-upload
        budget). memory_limit bounds this handle's dirty RAM (slot
        buffers + retained sealed payloads); spill past it goes to a
        swap file in swap_dir."""
        self.upload_fn = upload_fn
        self.chunk_size = chunk_size
        self.memory_limit = memory_limit
        self._swap_dir = swap_dir
        self._swap: _SwapFile | None = None
        self._slots: dict[int, _Slot] = {}
        # sealed-but-unflushed uploads keep their payload so overlay
        # reads between seal and flush still see the bytes; the payload
        # ref is bytes (RAM) or an (offset, size) pair in the swap file
        self._uploads: list[tuple[Future, int, int, int, object]] = []
        self._ram_payload_bytes = 0
        self._seq = 0
        self._pipeline = pipeline or ThreadPoolExecutor(max_workers=4)
        self._owns_pipeline = pipeline is None
        self._lock = threading.Lock()
        self._mtime_ns = 0
        # upper bound of bytes this handle has buffered/uploaded since
        # the last flush (rewrites double-count) — quota accounting
        self.written_bytes = 0

    def write(self, offset: int, data: bytes) -> None:
        with self._lock:
            self.written_bytes += len(data)
            pos = 0
            while pos < len(data):
                idx = (offset + pos) // self.chunk_size
                slot_off = (offset + pos) % self.chunk_size
                n = min(self.chunk_size - slot_off, len(data) - pos)
                slot = self._slots.get(idx)
                if slot is None:
                    slot = _Slot(idx, self.chunk_size)
                    self._slots[idx] = slot
                slot.write(slot_off, data[pos:pos + n])
                self._seq += 1
                slot.seq = self._seq
                pos += n
            # seal every full slot strictly before the write cursor:
            # sequential writers stream instead of accumulating
            last_idx = (offset + len(data) - 1) // self.chunk_size
            for idx in sorted(self._slots):
                s = self._slots[idx]
                if idx < last_idx and \
                        s.spans == [(0, self.chunk_size)]:
                    self._seal_and_upload(idx, pop=True)
            # dirty-memory bound: random writes scattering over many
            # slots force-seal the least-recently-written ones (their
            # payloads spill to the swap file below), so RSS stays
            # O(memory_limit) no matter the write pattern
            cur_idx = (offset + len(data)) // self.chunk_size
            while len(self._slots) > 1 and \
                    self._dirty_ram() > self.memory_limit:
                victim = min(
                    (s for i, s in self._slots.items() if i != cur_idx),
                    key=lambda s: s.seq, default=None)
                if victim is None:
                    break
                self._seal_and_upload(victim.index, pop=True)

    def _dirty_ram(self) -> int:
        return len(self._slots) * self.chunk_size + self._ram_payload_bytes

    def _payload_bytes(self, ref) -> bytes:
        if isinstance(ref, tuple):
            off, size = ref
            return self._swap.get(off, size)
        return ref

    def _upload_ref(self, ref):
        # materialized in the pipeline worker: at most pipeline-width
        # spilled chunks are in RAM at once
        return self.upload_fn(self._payload_bytes(ref))

    def _seal_and_upload(self, idx: int, pop: bool) -> None:
        """Queue one slot's written spans for upload (lock held)."""
        slot = self._slots[idx]
        if pop:
            del self._slots[idx]
        base = idx * self.chunk_size
        for s, e in slot.spans:
            payload = bytes(slot.buf[s:e])
            if self._dirty_ram() + len(payload) > self.memory_limit:
                if self._swap is None:
                    self._swap = _SwapFile(self._swap_dir)
                ref: object = self._swap.put(payload)
                del payload
            else:
                ref = payload
                self._ram_payload_bytes += len(payload)
            # copy_context: keep the writer's trace/deadline on the
            # upload thread (pool.submit drops contextvars)
            fut = self._pipeline.submit(
                contextvars.copy_context().run, self._upload_ref, ref)
            self._uploads.append((fut, base + s, e - s,
                                  self._next_mtime_ns(), ref))

    def _next_mtime_ns(self) -> int:
        import time as _t

        self._mtime_ns = max(self._mtime_ns + 1, _t.time_ns())
        return self._mtime_ns

    def read_overlay(self, offset: int, size: int,
                     out: bytearray) -> list[tuple[int, int]]:
        """Copy dirty bytes overlapping [offset, offset+size) into out
        (same indexing); returns the absolute file ranges covered — the
        read path lays these over the committed chunk data. Sealed
        uploads apply first (oldest writes), then moving slots (newest)
        so later writes win just as their mtimes will after flush."""
        covered = []
        with self._lock:
            for _, file_off, size_u, _, ref in self._uploads:
                lo = max(offset, file_off)
                hi = min(offset + size, file_off + size_u)
                if lo < hi:
                    if isinstance(ref, tuple):
                        # spilled payload: read just the needed window
                        soff, _ssize = ref
                        piece = self._swap.get(
                            soff + (lo - file_off), hi - lo)
                        out[lo - offset:hi - offset] = piece
                    else:
                        out[lo - offset:hi - offset] = \
                            ref[lo - file_off:hi - file_off]
                    covered.append((lo, hi))
            for idx, slot in self._slots.items():
                base = idx * self.chunk_size
                lo = max(offset, base)
                hi = min(offset + size, base + self.chunk_size)
                if lo >= hi:
                    continue
                for s, e in slot.read_into(out, lo - base, lo - offset,
                                           hi - lo):
                    covered.append((base + s, base + e))
        return sorted(covered)

    def flush(self) -> list[FileChunk]:
        """Seal everything, wait for the pipeline, and return the new
        FileChunks in upload order (mtimes strictly increasing so
        overlap resolution prefers later writes)."""
        with self._lock:
            # pop as we seal: a kept slot would keep counting against
            # _dirty_ram() and push flush-time payloads to the swap
            # file needlessly
            for idx in sorted(self._slots):
                self._seal_and_upload(idx, pop=True)
            self._slots.clear()
            uploads, self._uploads = self._uploads, []
        chunks = []
        try:
            for fut, file_off, size, mtime_ns, _ in uploads:
                res = fut.result()
                # upload_fn returns fid, or (fid, cipher_key) when the
                # filer namespace is encrypted
                fid, ckey = res if isinstance(res, tuple) else (res, b"")
                chunks.append(FileChunk(fid=fid, offset=file_off,
                                        size=size, mtime_ns=mtime_ns,
                                        cipher_key=ckey))
        except Exception:
            # an upload failed: restore everything so a retried flush
            # can still commit — but FAILED futures must be replaced
            # with fresh submissions (a Future replays its cached
            # exception forever, so restoring it verbatim would make
            # every retry fail even after the volume server recovers)
            restored = []
            for fut, file_off, size, mtime_ns, ref in uploads:
                if fut.done() and fut.exception() is not None:
                    fut = self._pipeline.submit(
                        contextvars.copy_context().run,
                        self._upload_ref, ref)
                restored.append((fut, file_off, size, mtime_ns, ref))
            with self._lock:
                self._uploads = restored + self._uploads
            raise
        # decrement exactly what this flush drained — writes may have
        # raced in more RAM payloads while we waited on the futures
        drained = sum(len(r) for *_, r in uploads
                      if not isinstance(r, tuple))
        with self._lock:
            self._ram_payload_bytes -= drained
            # everything spilled has been uploaded and committed:
            # recycle the swap space for the next flush interval
            if self._swap is not None and not self._uploads \
                    and not self._slots:
                self._swap.reset()
        return chunks

    def has_dirty(self) -> bool:
        with self._lock:
            return bool(self._slots) or bool(self._uploads)

    @property
    def dirty_ram_bytes(self) -> int:
        """Current RAM held by dirty state (observability + tests)."""
        with self._lock:
            return self._dirty_ram()

    @property
    def swap_bytes(self) -> int:
        with self._lock:
            return self._swap.size if self._swap is not None else 0

    def close(self) -> None:
        if self._owns_pipeline:
            self._pipeline.shutdown(wait=False)
        if self._swap is not None:
            self._swap.close()
