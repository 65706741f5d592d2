"""Assemble file bytes from chunk views via volume-server reads; the
counterpart of seaweedfs_tpu/filer/stream.py, over rpc/httpclient.

Equivalent of SeaweedFS weed/filer/stream.go:69-144 — turn an entry's
chunk list into ranged HTTP reads against volume servers, with manifest
resolution, a small per-reader chunk cache and one-chunk readahead
(reader_cache.go's role). A fid on several volume servers (replicas, or
the holders of an EC volume's shards, which read through their
degraded-read ladder) is read hedged: first success wins.

Departures from the reference, for the port's client: a volume server
that no longer holds the volume answers 301 to its new home, which
`read_fid` follows once (http.client does not follow redirects); and a
read whose every location failed drops the fid's cached locations
(`invalidate_fid` of the lookup's owner) and tries once more, since the
port's master client has no KeepConnected stream to learn that a server
died. `iter_content` yields a range piece by piece for streamed replies,
where the reference's aiohttp handler wrote the pieces itself.
Not here: encrypted chunks (-encryptVolumeData) raise
NotImplementedError.
"""
from __future__ import annotations

import contextvars
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Iterator

from ..rpc.httpclient import session
from ..utils import metrics

from .entry import FileChunk
from .filechunks import resolve_chunk_manifest, view_from_chunks

LookupFn = Callable[[str], str]  # fid -> full http url

# seconds the primary replica gets before a hedged read fires the next
# (the reference's retry.HEDGE_DELAY default)
HEDGE_DELAY = 0.35
# largest piece iter_content yields
PIECE = 8 << 20

# shared hedge pool for sync replica reads; sized small on purpose —
# a hedge is the exception (one slow replica), not the common path
_hedge_pool: ThreadPoolExecutor | None = None


def _hedge_pool_get() -> ThreadPoolExecutor:
    global _hedge_pool
    if _hedge_pool is None:
        _hedge_pool = ThreadPoolExecutor(max_workers=8,
                                         thread_name_prefix="hedge")
    return _hedge_pool


def _owner(lookup: LookupFn):
    return getattr(lookup, "__self__", None)


def _replica_urls(lookup: LookupFn, fid: str) -> list[str]:
    """All replica urls for a fid when the lookup's owner can list
    them (FilerServer exposes lookup_file_id_urls), else the single url
    the plain lookup returns."""
    fn = getattr(_owner(lookup), "lookup_file_id_urls", None)
    if fn is not None:
        return fn(fid)
    return [lookup(fid)]


def _hedged_fetch(fetch: Callable[[str], bytes], urls: list[str],
                  hedge_delay: float) -> bytes:
    """First-success-wins across the primary and (after hedge_delay,
    or at once on primary failure) the alternates, one at a time. A
    replica that is slow costs at most hedge_delay extra, not its whole
    timeout; one that is dead costs its failed connect."""
    pool = _hedge_pool_get()
    futs = {pool.submit(contextvars.copy_context().run, fetch, urls[0])}
    rest = list(urls[1:])
    errors: list[BaseException] = []
    hedges = set()
    while futs:
        done, _ = wait(futs, timeout=hedge_delay if rest else None,
                       return_when=FIRST_COMPLETED)
        for fut in done:
            futs.discard(fut)
            exc = fut.exception()
            if exc is None:
                if fut in hedges:
                    metrics.counter_add("replica_read_hedge_wins", 1)
                for p in futs:
                    p.cancel()
                return fut.result()
            errors.append(exc)
        if rest and (not done or not futs):
            # primary slow, or every racer failed: fire the next one
            metrics.counter_add("replica_read_hedges", 1)
            hedge = pool.submit(contextvars.copy_context().run, fetch,
                                rest.pop(0))
            hedges.add(hedge)
            futs.add(hedge)
    raise errors[-1]


class ReaderPattern:
    """Sequential-vs-random read classifier (reader_pattern.go:17):
    a read resuming exactly where the last one stopped bumps a
    saturating counter, anything else decrements it; negative =
    random mode, where whole-chunk caching and readahead are pure
    amplification (a 4KB random read must not fetch an 8MB chunk)."""

    MODE_CHANGE_LIMIT = 3

    def __init__(self):
        self._counter = 0
        self._last_stop = 0

    def monitor(self, offset: int, size: int) -> None:
        last, self._last_stop = self._last_stop, offset + size
        if last == offset:
            if self._counter < self.MODE_CHANGE_LIMIT:
                self._counter += 1
        elif self._counter > -self.MODE_CHANGE_LIMIT:
            self._counter -= 1

    @property
    def is_random(self) -> bool:
        return self._counter < 0

    @property
    def is_streaming(self) -> bool:
        """Saturated-sequential: enough consecutive reads to justify
        whole-chunk caching for SUB-chunk views (a one-shot ranged
        read never warms up, so it never pays 8MB for 64KB)."""
        return self._counter >= self.MODE_CHANGE_LIMIT


def _fetch_url(url: str, fid: str, headers: dict) -> bytes:
    resp = session().get(url, headers=headers, timeout=60)
    if resp.status_code in (301, 302, 307) and \
            resp.headers.get("Location"):
        # the volume moved (ec.encode dropped the replica this server
        # held): its new home is named in the redirect
        resp = session().get(resp.headers["Location"], headers=headers,
                             timeout=60)
    if resp.status_code not in (200, 206):
        raise IOError(f"read {fid}: http {resp.status_code}")
    return resp.content


def read_fid(lookup: LookupFn, fid: str, offset: int = 0,
             size: int | None = None) -> bytes:
    headers = {}
    if size is not None:
        headers["Range"] = f"bytes={offset}-{offset + size - 1}"
    elif offset:
        headers["Range"] = f"bytes={offset}-"

    def fetch(url: str) -> bytes:
        return _fetch_url(url, fid, headers)

    def once() -> bytes:
        urls = _replica_urls(lookup, fid)
        if len(urls) == 1:
            return fetch(urls[0])
        return _hedged_fetch(fetch, urls, HEDGE_DELAY)

    try:
        return once()
    except OSError:
        invalidate = getattr(_owner(lookup), "invalidate_fid", None)
        if invalidate is None:
            raise
        invalidate(fid)
        return once()


class ChunkStreamReader:
    """Random-access reads over an entry's chunks, caching whole chunks
    (weed/filer/reader_cache.go keeps recently-read chunks in memory for
    sequential readers)."""

    def __init__(self, lookup: LookupFn, chunks: list[FileChunk],
                 cache_chunks: int = 8, readahead: bool = True):
        self.lookup = lookup
        self.chunks = resolve_chunk_manifest(
            lambda fid: read_fid(lookup, fid), chunks)
        if any(c.cipher_key for c in self.chunks):
            raise NotImplementedError(
                "encrypted chunks: -encryptVolumeData is not ported")
        self._cache: dict[str, bytes] = {}
        self._cache_order: list[str] = []
        self._cache_chunks = cache_chunks
        self.pattern = ReaderPattern()
        self._readahead = readahead
        self._prefetch = {}  # fid -> Future[bytes]
        self._pool = None
        # offset-ordered chunks, for next-chunk readahead
        self._seq = sorted(
            (c for c in self.chunks if not c.is_chunk_manifest),
            key=lambda c: c.offset)

    @property
    def size(self) -> int:
        return max((c.offset + c.size for c in self.chunks), default=0)

    def _cache_put(self, fid: str, data: bytes) -> bytes:
        self._cache[fid] = data
        self._cache_order.append(fid)
        if len(self._cache_order) > self._cache_chunks:
            self._cache.pop(self._cache_order.pop(0), None)
        return data

    def _chunk_bytes(self, fid: str) -> bytes:
        if fid in self._cache:
            return self._cache[fid]
        fut = self._prefetch.pop(fid, None)
        if fut is not None:
            try:
                return self._cache_put(fid, fut.result(timeout=60))
            except Exception:  # noqa: BLE001 — readahead is best-effort
                pass
        return self._cache_put(fid, read_fid(self.lookup, fid))

    def _maybe_readahead(self, cur_fid: str, limit_off: int) -> None:
        """Sequential mode: start fetching the chunk AFTER `cur_fid`
        on a background thread so network and assembly overlap
        (reader_cache.go MaybeCache). One chunk ahead, best-effort.
        `limit_off` bounds the prefetch to chunks this read actually
        touches — a per-request reader must never fetch a chunk past
        its range just to throw it away on close()."""
        if not self._readahead or self.pattern.is_random:
            return
        nxt = None
        for i, c in enumerate(self._seq):
            if c.fid == cur_fid and i + 1 < len(self._seq):
                nxt = self._seq[i + 1]
                break
        if nxt is None or nxt.offset >= limit_off \
                or nxt.fid in self._cache or nxt.fid in self._prefetch:
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1)
        # copy_context: keep the reader's trace/deadline on the
        # prefetch thread (pool.submit drops contextvars)
        self._prefetch[nxt.fid] = self._pool.submit(
            contextvars.copy_context().run, read_fid, self.lookup,
            nxt.fid)

    def read(self, offset: int = 0, size: int | None = None,
             limit_off: int | None = None) -> bytes:
        """[offset, offset+size) of the file; `limit_off` (default the
        read's end) bounds readahead for callers that read a larger
        range in pieces."""
        if size is None:
            size = self.size - offset
        size = max(0, min(size, self.size - offset))
        if size == 0:
            return b""
        self.pattern.monitor(offset, size)
        chunk_sizes = {c.fid: c.size for c in self.chunks}
        out = bytearray(size)  # sparse gaps read as zeros
        views = view_from_chunks(self.chunks, offset, size)
        streaming = self.pattern.is_streaming
        for v in views:
            full = v.view_size >= chunk_sizes.get(v.fid, 0)
            whole = (v.fid in self._cache or full or
                     v.fid in self._prefetch or streaming)
            if whole:
                self._maybe_readahead(v.fid, limit_off or offset + size)
                # warmed-up sequential readers take whole chunks so the
                # NEXT sub-chunk reads hit the cache, not the network
                data = self._chunk_bytes(v.fid)
                piece = data[v.offset_in_chunk:
                             v.offset_in_chunk + v.view_size]
            else:
                # partial view of an uncached chunk on a cold or random
                # reader: ranged read, no whole-chunk amplification
                piece = read_fid(self.lookup, v.fid, v.offset_in_chunk,
                                 v.view_size)
            at = v.view_offset - offset
            out[at:at + len(piece)] = piece
        return bytes(out)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None


def stream_content(lookup: LookupFn, chunks: list[FileChunk],
                   offset: int = 0, size: int | None = None) -> bytes:
    r = ChunkStreamReader(lookup, chunks)
    try:
        return r.read(offset, size)
    finally:
        r.close()


def iter_content(lookup: LookupFn, chunks: list[FileChunk],
                 offset: int = 0, size: int | None = None
                 ) -> Iterator[bytes]:
    """[offset, offset+size) as pieces of at most PIECE bytes, cut at
    chunk boundaries, with the next chunk read ahead while a piece is
    written — a streamed reply holds two chunks, never the file."""
    r = ChunkStreamReader(lookup, chunks, cache_chunks=2)
    try:
        end = offset + (r.size - offset if size is None else size)
        end = min(end, r.size)
        cuts = sorted({c.offset for c in r.chunks} |
                      {c.offset + c.size for c in r.chunks})
        pos = offset
        while pos < end:
            nxt = next((c for c in cuts if c > pos), end)
            n = min(nxt, end, pos + PIECE) - pos
            yield r.read(pos, n, limit_off=end)
            pos += n
    finally:
        r.close()
