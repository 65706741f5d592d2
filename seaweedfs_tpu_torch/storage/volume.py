"""Volume: one append-only needle log (.dat) plus its index (.idx) — the
counterpart of seaweedfs_tpu/storage/volume.py.

Engine equivalent of the reference's weed/storage/volume*.go — append
(volume_write.go:123 writeNeedle2), read (volume_read.go:19 readNeedle),
delete-as-tombstone, load with torn-tail integrity check
(volume_checking.go:17), and two-phase vacuum compaction
(volume_vacuum.go:67 Compact2 / :102 CommitCompact).

Differences from the reference are deliberate simplifications, not
omissions: no async write queue (the server layer batches), and the
needle map is one of storage.needle_map's three kinds.

The remote tier: a .dat the .vif records as uploaded to a backend
storage (storage/backend.py S3BackendStorage) opens as a read-only
S3RangeFile, so reads become ranged GETs (`tier_upload` /
`tier_adopt` / `tier_download` move it there and back; compaction
refuses a remote .dat, and `destroy` deletes the remote object).

`commit_batch` is the group-commit step of storage/commit.py: a durable
batch fdatasyncs the .dat once for every write it covers, a buffered one
flushes the .idx (it replaced the needle map's commit cadence, as in the
reference).

The native data plane (native/dataplane.py): `attach_native` hands a
plain local-disk volume's hot path to the C++ library, which is then
the single authority for its needle map, .dat tail and .idx log — every
append and delete here routes through `delegate`, the map becomes a
NativeNeedleMap view, and compaction, raw segment application and the
tier refuse or detach first (`detach_native` reloads the map from the
.idx). While attached, `commit_batch` fdatasyncs the .dat but flushes
no .idx through Python's buffer (the front's appends are unbuffered
pwrites), and `sync` fsyncs the .idx through Python's own handle.

`rebuild_index`
scans an on-disk .dat with the native record walker
(`native.dat_scan`) and an in-memory one with the Python loop; a
native library that does not build raises.
"""
from __future__ import annotations

import os
import struct
import threading
import time

import numpy as np

from .. import native
from . import backend as bk
from . import idx as idxmod
from . import needle as ndl
from . import needle_map as nmap
from . import types as t
from . import volume_info as vinfo
from .super_block import ReplicaPlacement, SuperBlock


class Volume:
    def __init__(self, dirname: str, collection: str, vid: int,
                 replica_placement: ReplicaPlacement | None = None,
                 ttl: bytes = b"\x00\x00", create: bool = False,
                 backend_kind: str = "disk",
                 needle_map_kind: str = "memory"):
        self.dir = dirname
        self.collection = collection
        self.vid = vid
        self.needle_map_kind = needle_map_kind
        # native data-plane delegation (native/dataplane.py): while set,
        # the C++ library is the single authority for this volume's
        # needle map, .dat tail and .idx log — every mutation below
        # routes through it instead of touching the files directly
        self.delegate = None
        self.read_only = False
        self._backend_kind = backend_kind
        # serializes mutations (append/delete/raw-append) against each
        # other and against compact's snapshot + commit phases — the
        # reference's per-volume write lock around Compact2/CommitCompact
        self.write_lock = threading.RLock()
        base = self.file_name()
        exists = os.path.exists(base + ".dat")
        self.volume_info = vinfo.maybe_load_volume_info(base + ".vif")
        remote = self.volume_info.remote_file() if self.volume_info else None
        if remote is not None and not exists:
            # .dat tiered off to a backend storage: open the remote copy
            # (disk_location.go loadVolumeInfo → s3 BackendStorageFile)
            storage = bk.get_storage(remote.backend_name)
            self.dat = storage.open_file(remote.key, remote.file_size)
            self.read_only = True
        elif remote is not None:
            # tiered with keepLocalDatFile: serve from the local copy
            # but stay read-only — appends would silently diverge from
            # the remote object recorded in the .vif
            self.dat = bk.DiskFile(base + ".dat")
            self.read_only = True
        elif backend_kind in ("disk", "mmap"):
            self.dat = bk.create(backend_kind, base + ".dat",
                                 create=create or not exists)
        else:
            self.dat = bk.create(backend_kind, base + ".dat")
        if (exists or remote is not None) and self.dat.size() >= 8:
            self.super_block = self._read_super_block()
        else:
            self.super_block = SuperBlock(
                replica_placement=replica_placement or ReplicaPlacement(),
                ttl=ttl)
            self.dat.write_at(self.super_block.to_bytes(), 0)
            self.dat.sync()
        self.nm = nmap.load_needle_map(base + ".idx",
                                       kind=needle_map_kind)
        self._idx_f = open(base + ".idx", "ab")
        self.last_append_at_ns = 0
        if exists:
            # the integrity walk checks CRCs through the native library
            # and reads any failure as a torn record to cut: load it
            # first, so a library that does not build raises here
            native.load()
            self.check_integrity()
            self.last_append_at_ns = self._recover_last_append_at_ns()

    # -- naming --------------------------------------------------------
    def file_name(self) -> str:
        name = f"{self.collection}_{self.vid}" if self.collection else \
            str(self.vid)
        return os.path.join(self.dir, name)

    # -- super block ---------------------------------------------------
    def _read_super_block(self) -> SuperBlock:
        head = self.dat.read_at(64 << 10, 0)
        return SuperBlock.from_bytes(head)

    # -- native data-plane delegation ----------------------------------
    @property
    def read_only(self) -> bool:
        return self._read_only

    @read_only.setter
    def read_only(self, value: bool) -> None:
        self._read_only = bool(value)
        if self.delegate is not None:
            self.delegate.set_readonly(self.vid, self._read_only)

    @property
    def last_append_at_ns(self) -> int:
        if self.delegate is not None:
            return self.delegate.stats(self.vid)["last_append_ns"]
        return self._last_append_at_ns

    @last_append_at_ns.setter
    def last_append_at_ns(self, value: int) -> None:
        self._last_append_at_ns = int(value)

    def attach_native(self, dp) -> bool:
        """Hand the hot path to the native data plane `dp`. Only plain
        local-disk volumes qualify — remote/tiered and mmap stay
        Python. Returns True when attached."""
        if self.delegate is not None:
            return True
        if self._backend_kind != "disk" or not isinstance(
                self.dat, bk.DiskFile):
            return False
        base = self.file_name()
        with self.write_lock:
            self.dat.flush()
            self._idx_f.flush()
            from ..native.dataplane import NativeNeedleMap

            dp.attach(self.vid, base + ".dat", base + ".idx",
                      self.version, self.read_only,
                      self.super_block.replica_placement.copy_count > 1,
                      self.dat.size(), self._last_append_at_ns)
            if hasattr(self.nm, "close"):
                self.nm.close()  # btree: persists its watermark
            self.nm = NativeNeedleMap(dp, self.vid)
            self.delegate = dp
        return True

    def detach_native(self, reload_map: bool = True) -> None:
        """Take the volume back from the native plane (vacuum, tier,
        EC, unmount all need exclusive Python ownership)."""
        if self.delegate is None:
            return
        base = self.file_name()
        with self.write_lock:
            dp = self.delegate
            self.delegate = None
            _tail, last_ns = dp.detach(self.vid)
            self._last_append_at_ns = max(self._last_append_at_ns,
                                          last_ns)
            # reopen the .idx append handle at the true EOF and rebuild
            # the Python map from the .idx log (the btree sidecar's
            # watermark catch-up consumes exactly the natively appended
            # tail)
            self._idx_f.close()
            self._idx_f = open(base + ".idx", "ab")
            if reload_map:
                self.nm = nmap.load_needle_map(
                    base + ".idx", kind=self.needle_map_kind)
            else:
                self.nm = nmap.new_needle_map(
                    self.needle_map_kind, idx_path=base + ".idx") \
                    if self.needle_map_kind != "btree" else \
                    nmap.NeedleMap()

    # -- write path ----------------------------------------------------
    def append_needle(self, n: ndl.Needle) -> tuple[int, int]:
        """Append; returns (byte offset, body size). Pads .dat so offsets
        stay 8-aligned (reference appends already-padded records)."""
        if self.read_only:
            raise PermissionError(f"volume {self.vid} is read only")
        with self.write_lock:
            return self._append_needle_locked(n)

    def _append_needle_locked(self, n: ndl.Needle) -> tuple[int, int]:
        if not n.append_at_ns:
            # wall clock, not monotonic: append_at_ns orders records
            # ACROSS restarts for incremental sync (volume_backup.go);
            # the max() guard keeps it strictly increasing regardless
            n.append_at_ns = max(time.time_ns(),
                                 self.last_append_at_ns + 1)
        self.last_append_at_ns = n.append_at_ns
        blob = n.to_bytes(self.version)
        if self.delegate is not None:
            # native plane owns the tail, map and .idx for this volume
            offset = self.delegate.append(self.vid, blob, n.id, n.size,
                                          n.append_at_ns)
            return offset, n.size
        offset = self.dat.append(blob)
        if offset % t.NEEDLE_PADDING:
            # torn previous write: realign (reference truncates on load)
            pad = t.NEEDLE_PADDING - offset % t.NEEDLE_PADDING
            raise IOError(f".dat misaligned by {pad} bytes")
        # data reaches the OS before the index entry does — the recovery
        # path assumes index entries never point past .dat EOF
        self.dat.flush()
        stored = t.actual_to_offset(offset)
        self.nm.put(n.id, stored, n.size)
        idxmod.append_entry(self._idx_f, n.id, stored, n.size)
        self._idx_f.flush()
        return offset, n.size

    def delete_needle(self, needle_id: int) -> int:
        """Tombstone a needle; returns reclaimed data size (0 if absent).
        Appends an empty needle to .dat and a tombstone .idx entry, as the
        reference does (volume_write.go deleteNeedle2)."""
        if self.read_only:
            raise PermissionError(f"volume {self.vid} is read only")
        with self.write_lock:
            tomb = ndl.Needle(id=needle_id)
            tomb.append_at_ns = max(time.time_ns(),
                                    self.last_append_at_ns + 1)
            if self.delegate is not None:
                # the native side checks existence, appends the
                # tombstone record + .idx entry atomically
                return self.delegate.delete(self.vid, needle_id,
                                            tomb.to_bytes(self.version),
                                            tomb.append_at_ns)
            existing = self.nm.get(needle_id)
            if existing is None:
                return 0
            self.last_append_at_ns = tomb.append_at_ns
            self.dat.append(tomb.to_bytes(self.version))
            reclaimed = self.nm.delete(needle_id)
            idxmod.append_entry(self._idx_f, needle_id, 0,
                                t.TOMBSTONE_SIZE)
            self._idx_f.flush()
            return reclaimed

    # -- read path -----------------------------------------------------
    def read_needle(self, needle_id: int, cookie: int | None = None,
                    read_deleted: bool = False) -> ndl.Needle:
        try:
            return self._read_needle_once(needle_id, cookie, read_deleted)
        except PermissionError:
            raise  # cookie mismatch is definitive, never retry-worthy
        except (ValueError, OSError, struct.error):
            # a vacuum commit can swap .dat/.idx under an unlocked
            # reader (closed file, or stale offsets against the new
            # file). The commit holds write_lock through the swap, so
            # one retry serialized behind it reads consistent state;
            # a repeat failure is real corruption and propagates.
            with self.write_lock:
                return self._read_needle_once(needle_id, cookie,
                                              read_deleted)

    def _read_needle_once(self, needle_id: int,
                          cookie: int | None = None,
                          read_deleted: bool = False) -> ndl.Needle:
        loc = self.nm.get(needle_id)
        if loc is None and read_deleted:
            # ?readDeleted=true (volume_read.go:29): the tombstoned
            # map entry keeps the ORIGINAL offset until vacuum/reload;
            # the magnitude lives in the needle's own header on disk
            raw = getattr(self.nm, "get_any", lambda _k: None)(needle_id)
            # offset 0 = superblock, never needle data: a tombstone
            # REloaded from .idx carries offset 0 (append_entry writes
            # it that way), so post-restart the original offset is
            # genuinely unknown and the read must 404, not decode the
            # superblock as a needle header
            if raw is not None and raw[0] != 0 \
                    and t.size_is_deleted(raw[1]):
                hdr_off = t.offset_to_actual(raw[0])
                hdr = self.dat.read_at(t.NEEDLE_HEADER_SIZE, hdr_off)
                if len(hdr) == t.NEEDLE_HEADER_SIZE:
                    disk_sz = t.u32_to_size(
                        struct.unpack_from(">I", hdr, 12)[0])
                    if t.size_is_valid(disk_sz):
                        loc = (raw[0], disk_sz)
        if loc is None:
            raise KeyError(f"needle {needle_id} not found")
        stored_offset, size = loc
        offset = t.offset_to_actual(stored_offset)
        blob = self.dat.read_at(ndl.disk_size(size, self.version), offset)
        n = ndl.Needle.from_bytes(blob, self.version)
        if n.id != needle_id:
            # a stale offset after a vacuum swap can land on a DIFFERENT
            # valid record of the same size — without this check the
            # wrong needle's data would be served silently
            raise ValueError(
                f"needle id mismatch: want {needle_id} got {n.id}")
        if n.size != size:
            raise ValueError(
                f"size mismatch: index {size} vs disk {n.size}")
        if cookie is not None and n.cookie != cookie:
            raise PermissionError("cookie mismatch")
        return n

    def read_needle_streamed(self, needle_id: int,
                             cookie: int | None = None):
        """Open a big needle for WINDOWED serving without materializing
        its data (the reference's streamed read path — PagedReadLimit,
        volume_read.go:41 AttemptMetaOnly + paged ReadNeedleDataInto):
        two small preads fetch the header and the post-data metadata;
        -> (meta_needle_with_empty_data, data_size, reader) where
        reader(off, ln) preads the data span [off, off+ln).

        The reader captures THIS DiskFile handle: a concurrent vacuum
        commit swaps in a new file but the old fd keeps serving a
        consistent snapshot until it is closed.
        """
        loc = self.nm.get(needle_id)
        if loc is None:
            raise KeyError(f"needle {needle_id} not found")
        stored_offset, size = loc
        offset = t.offset_to_actual(stored_offset)
        dat = self.dat
        head = dat.read_at(t.NEEDLE_HEADER_SIZE + 4, offset)
        if len(head) < t.NEEDLE_HEADER_SIZE + 4:
            raise ValueError("needle header truncated")
        ck, nid, size_u32, data_size = struct.unpack(">IQII", head)
        if nid != needle_id:
            raise ValueError(
                f"needle id mismatch: want {needle_id} got {nid}")
        if t.u32_to_size(size_u32) != size:
            raise ValueError(f"size mismatch: index {size} vs "
                             f"disk {t.u32_to_size(size_u32)}")
        if cookie is not None and ck != cookie:
            raise PermissionError("cookie mismatch")
        if data_size + 5 > size:
            raise ValueError("corrupt needle: data_size exceeds body")
        n = ndl.Needle(id=nid, cookie=ck)
        n.size = size
        data_off = offset + t.NEEDLE_HEADER_SIZE + 4
        # post-data tail: [flags][name][mime][lm][ttl][pairs][crc]...
        tail_len = size - 4 - data_size + 4  # meta + stored crc
        tail = dat.read_at(tail_len, data_off + data_size)
        try:
            n._parse_meta(tail, 0)
        except (IndexError, struct.error) as e:
            raise ValueError(f"corrupt needle meta: {e}") from e
        # the stored crc IS the etag; streaming can't re-verify the
        # payload before bytes go out, and the reference's paged path
        # does exactly this (needle_read_page.go:75 sets Checksum to
        # the RAW stored value, while the materialized read normalizes
        # to the computed crc) — so a legacy-transform .dat shows the
        # same streamed-vs-small etag split there too
        if len(tail) >= 4:
            n.checksum = struct.unpack_from(">I", tail, len(tail) - 4)[0]

        def reader(off: int, ln: int) -> bytes:
            return dat.read_at(ln, data_off + off)

        return n, data_size, reader

    # -- maintenance ---------------------------------------------------
    @property
    def version(self) -> int:
        return self.super_block.version

    def content_size(self) -> int:
        return self.dat.size()

    def garbage_ratio(self) -> float:
        used = self.nm.file_bytes + self.nm.deleted_bytes
        return (self.nm.deleted_bytes / used) if used else 0.0

    def check_integrity(self) -> None:
        """Crash recovery on load (CheckAndFixVolumeDataIntegrity,
        volume_checking.go:17, extended for group commit):

        1. truncate a torn .dat tail to the 8-byte record grid;
        2. torn-BATCH tail: a group-commit window can die mid-flush
           (kill between a batch's appends), leaving CRC-good records
           and then a partial one beyond the last indexed record. Walk
           that unindexed tail, REPLAY every CRC-clean record into the
           needle map + .idx (the batch committer fsyncs only the
           .dat — acked idx entries are regained right here), and cut
           the .dat at the first corrupt one — the torn batch suffix
           drops as one unit while every record before the cut
           survives bit-for-bit. Batch-mode acks release only after
           the covering .dat fsync, so an acked needle always sits
           below the cut and is re-indexed, never dropped;
        3. drop index entries pointing at/past the .dat EOF (idx flushed
           ahead of an unwritten data record);
        4. spot-check the last live entry parses with the right id — a
           mismatch means the whole index is stale (e.g. torn compact
           commit) and is rebuilt by scanning the .dat.
        """
        size = self.dat.size()
        aligned = size - (size % t.NEEDLE_PADDING)
        if aligned != size:
            self.dat.truncate(aligned)
            size = aligned
        anchor = self.super_block.block_size
        for key, off, sz in self.nm.live_items():
            end = t.offset_to_actual(off) + ndl.disk_size(sz, self.version)
            if end <= size:
                anchor = max(anchor, end)
        cut = self._recover_tail(anchor, size)
        if cut is not None:
            self.dat.truncate(cut)
            size = cut
        stale = []
        last = None
        for key, off, sz in self.nm.live_items():
            end = t.offset_to_actual(off) + ndl.disk_size(sz, self.version)
            if end > size:
                stale.append(key)
            elif last is None or off > last[1]:
                last = (key, off, sz)
        consistent = not stale
        if consistent and last is None and \
                size > self.super_block.block_size:
            consistent = False  # data present but index knows nothing
        if consistent and last is not None:
            key, off, sz = last
            try:
                blob = self.dat.read_at(
                    ndl.disk_size(sz, self.version), t.offset_to_actual(off))
                n = ndl.Needle.from_bytes(blob, self.version)
                if n.id != key or n.size != sz:
                    consistent = False
            except Exception:
                consistent = False
        if not consistent:
            self.rebuild_index()

    def _recover_tail(self, offset: int, size: int) -> int | None:
        """Walk .dat records in [offset, size) verifying each parses
        CRC-clean (tombstones have no payload and pass trivially), and
        REPLAY every sound record into the needle map + .idx. The .idx
        appends in the same order as the .dat under the write lock, so
        an idx loss is always a suffix: the batch committer fsyncs only
        the .dat and relies on this replay to regain the covering idx
        entries after a crash. The anchor is a safe underestimate
        (live-entry maximum), so already-indexed records re-apply
        idempotently — the nm state check skips their idx re-append to
        keep clean reloads byte-stable.
        -> the byte offset of the first bad/partial record — the
        torn-batch truncation cut — or None when the tail is sound."""
        while offset + t.NEEDLE_HEADER_SIZE <= size:
            try:
                head = self.dat.read_at(t.NEEDLE_HEADER_SIZE, offset)
                _, nid, size_u32 = struct.unpack(">IQI", head)
                nsize = max(t.u32_to_size(size_u32), 0)
                disk = ndl.disk_size(nsize, self.version)
                if offset + disk > size:
                    return offset  # partial record: torn mid-append
                blob = self.dat.read_at(disk, offset)
                ndl.Needle.from_bytes(blob, self.version)
            except Exception:
                return offset
            stored = t.actual_to_offset(offset)
            if nsize > 0:
                if self.nm.get(nid) != (stored, nsize):
                    self.nm.put(nid, stored, nsize)
                    idxmod.append_entry(self._idx_f, nid, stored, nsize)
            elif self.nm.get(nid) is not None:
                try:
                    self.nm.delete(nid)
                except KeyError:
                    pass
                else:
                    idxmod.append_entry(self._idx_f, nid, 0,
                                        t.TOMBSTONE_SIZE)
            offset += disk
        if offset != size:
            return offset  # sub-header residue on the record grid
        return None

    def rebuild_index(self) -> None:
        """Offline .idx reconstruction by scanning the .dat — the
        `weed fix` tool (command/fix.go:24-40) as an engine method, also
        the recovery path for a torn compact commit. A .dat on disk is
        scanned by the native C++ record walker (the scan itself drops
        from seconds to milliseconds on large volumes; end-to-end ~2x
        since the needle-map replay dominates); an in-memory .dat by the
        Python loop below, the semantic reference. The JAX package also
        walks a disk .dat in Python when its native library is missing;
        here that library is required (it computes every needle CRC), so
        a failed build raises."""
        base = self.file_name()
        if isinstance(self.dat, (bk.DiskFile, bk.MmapFile)):
            self._rebuild_index_native(base)
            return
        self._idx_f.close()
        if hasattr(self.nm, "close"):
            self.nm.close()
        self.nm = nmap.new_needle_map(self.needle_map_kind,
                                      idx_path=base + ".idx")
        with open(base + ".idx", "wb") as idxf:
            offset = self.super_block.block_size
            size = self.dat.size()
            while offset + t.NEEDLE_HEADER_SIZE <= size:
                head = self.dat.read_at(t.NEEDLE_HEADER_SIZE, offset)
                _, nid, size_u32 = struct.unpack(">IQI", head)
                nsize = t.u32_to_size(size_u32)
                if nsize < 0:
                    nsize = 0
                disk = ndl.disk_size(nsize, self.version)
                if offset + disk > size:
                    self.dat.truncate(offset)
                    break
                stored = t.actual_to_offset(offset)
                if nsize > 0:
                    self.nm.put(nid, stored, nsize)
                    idxmod.append_entry(idxf, nid, stored, nsize)
                else:
                    self.nm.delete(nid)
                    idxmod.append_entry(idxf, nid, 0, t.TOMBSTONE_SIZE)
                offset += disk
        self._idx_f = open(base + ".idx", "ab")

    def scrub(self, limit: int = 0) -> dict:
        """Verify every live needle end-to-end: disk read, size check,
        CRC32C (needle.from_bytes raises on mismatch). The per-volume
        arm of cluster scrub (BASELINE config #5); the EC arm is the
        shell's ec.verify parity check. `limit` bounds the record
        count (0 = all)."""
        checked = 0
        bad: list[dict] = []
        with self.write_lock:  # stable snapshot vs concurrent puts
            snapshot = list(self.nm.live_items())
        for key, _off, _size in snapshot:
            if limit and checked >= limit:
                break
            checked += 1
            try:
                self.read_needle(key)
            except (ValueError, IOError, KeyError, struct.error):
                # A needle legitimately deleted — or a vacuum commit
                # swapping the .dat mid-read — is not corruption. The
                # retry must run under write_lock: the commit holds it
                # through the .dat close/replace/reopen, so the locked
                # retry is serialized after the swap and reads the
                # fresh map + file instead of a torn pair.
                with self.write_lock:
                    if self.nm.get(key) is None:
                        continue
                    try:
                        self.read_needle(key)
                    except (ValueError, IOError, KeyError,
                            struct.error) as e2:
                        bad.append({"id": key, "error": str(e2)})
        return {"volume": self.vid, "checked": checked, "bad": bad}

    def _rebuild_index_native(self, base: str) -> None:
        """C++ path of rebuild_index: bulk-scan the .dat, write the .idx
        vectorized, reload the map through the standard loader."""
        path = self.dat.name
        self.dat.flush()
        size = self.dat.size()
        start = self.super_block.block_size
        if size <= start:
            ids = offs = sizes = np.empty(0, dtype=np.int64)
            end = size
        else:
            dat = np.memmap(path, dtype=np.uint8, mode="r", shape=(size,))
            ids, offs, sizes, end = native.dat_scan(
                dat, start, self.version)
            del dat
        if end < size:
            self.dat.truncate(end)  # torn tail after the last record
        self._idx_f.close()
        arr = np.empty(len(ids), dtype=idxmod.IDX_DTYPE)
        live = sizes > 0
        arr["key"] = ids
        arr["offset"] = np.where(live, offs // t.NEEDLE_PADDING, 0)
        arr["size"] = np.where(live, sizes.astype(np.int64),
                               t.size_to_u32(t.TOMBSTONE_SIZE))
        idxmod.write_index(base + ".idx", arr)
        if hasattr(self.nm, "close"):
            self.nm.close()
        if self.needle_map_kind == "btree":
            # the .idx was rewritten wholesale: a stale sidecar with a
            # coincidentally-equal watermark would serve wrong offsets
            nmap.drop_btree_sidecar(base + ".idx")
        self.nm = nmap.load_needle_map(base + ".idx",
                                       self.needle_map_kind)
        self._idx_f = open(base + ".idx", "ab")
        return True

    # -- incremental sync (volume_backup.go, volume_grpc_copy_incremental.go)
    def _walk_records(self, start: int, end: int | None = None):
        """Yield (offset, needle_id, size, disk_size) for every record
        (live or tombstone) from byte offset `start` to `end` (EOF by
        default), stopping at a torn tail."""
        offset = start
        if end is None:
            end = self.dat.size()
        while offset + t.NEEDLE_HEADER_SIZE <= end:
            head = self.dat.read_at(t.NEEDLE_HEADER_SIZE, offset)
            _, nid, size_u32 = struct.unpack(">IQI", head)
            nsize = max(t.u32_to_size(size_u32), 0)
            disk = ndl.disk_size(nsize, self.version)
            if offset + disk > end:
                return
            yield offset, nid, nsize, disk
            offset += disk

    def _append_at_ns_at(self, offset: int, nsize: int) -> int:
        """Read a record's append_at_ns stamp (v3 tail field)."""
        if self.version != ndl.VERSION3:
            return 0
        pos = offset + t.NEEDLE_HEADER_SIZE + nsize + ndl.CHECKSUM_SIZE
        raw = self.dat.read_at(8, pos)
        return struct.unpack(">Q", raw)[0] if len(raw) == 8 else 0

    def _recover_last_append_at_ns(self) -> int:
        """Stamp of the last record on disk. Starts the scan at the
        newest live offset the index knows (one vectorized idx read)
        so only trailing tombstones are walked record-by-record."""
        base = self.file_name()
        start = self.super_block.block_size
        try:
            entries = idxmod.read_index(base + ".idx")
            live = entries[entries["offset"] != 0]  # tombstones store 0
            if len(live):
                start = max(start,
                            int(live["offset"].max()) * t.NEEDLE_PADDING)
        except (OSError, ValueError):
            pass
        last = (0, 0)
        for offset, _nid, nsize, _disk in self._walk_records(start):
            last = (offset, nsize)
        return self._append_at_ns_at(*last) if last != (0, 0) else 0

    def offset_for_append_at_ns(self, since_ns: int) -> int:
        """Byte offset of the first record appended strictly after
        `since_ns` (EOF when none) — the reference's
        BinarySearchByAppendAtNs. Stamps are strictly increasing and
        the .idx file is in append order, so a binary search over the
        live index entries lands next to the answer; a short forward
        scan from there covers interleaved tombstone records (which
        have no index offset to probe)."""
        start = self.super_block.block_size
        if since_ns <= 0:
            return start
        if self.version == ndl.VERSION3:
            try:
                entries = idxmod.read_index(self.file_name() + ".idx")
                live = entries[entries["offset"] != 0]
            except (OSError, ValueError):
                live = ()
            if len(live):
                offsets = live["offset"].astype("int64") * t.NEEDLE_PADDING
                sizes = live["size"].astype("int64")
                lo, hi, best = 0, len(live) - 1, -1
                while lo <= hi:
                    mid = (lo + hi) // 2
                    stamp = self._append_at_ns_at(
                        int(offsets[mid]), int(sizes[mid]))
                    if stamp <= since_ns:
                        best, lo = mid, mid + 1
                    else:
                        hi = mid - 1
                if best >= 0:
                    start = int(offsets[best]) + ndl.disk_size(
                        int(sizes[best]), self.version)
        for offset, _nid, nsize, _disk in self._walk_records(start):
            if self._append_at_ns_at(offset, nsize) > since_ns:
                return offset
        return self.dat.size()

    def read_segment(self, offset: int, limit: int = 1 << 20) -> bytes:
        return self.dat.read_at(min(limit, self.dat.size() - offset),
                                offset)

    def append_raw_segment(self, data: bytes) -> int:
        """Append already-encoded records (an incremental-copy stream)
        and index them; returns the number of records applied. Only
        whole records are appended — a trailing partial record is an
        error, the transport must frame on record boundaries."""
        if self.delegate is not None:
            raise RuntimeError(
                f"volume {self.vid} is natively attached; detach "
                "before applying raw segments")
        if self.read_only:
            raise PermissionError(f"volume {self.vid} is read only")
        # the write lock spans append AND the error-path truncate: a
        # concurrent client write landing right after this segment
        # would otherwise be chopped off by truncate(end) (its index
        # entry left pointing past EOF)
        with self.write_lock:
            start = self.dat.append(data)
            self.dat.flush()
            applied = 0
            end = start
            for offset, nid, nsize, disk in self._walk_records(
                    start, start + len(data)):
                stored = t.actual_to_offset(offset)
                if nsize > 0:
                    self.nm.put(nid, stored, nsize)
                    idxmod.append_entry(self._idx_f, nid, stored, nsize)
                else:
                    self.nm.delete(nid)
                    idxmod.append_entry(self._idx_f, nid, 0,
                                        t.TOMBSTONE_SIZE)
                self.last_append_at_ns = max(
                    self.last_append_at_ns,
                    self._append_at_ns_at(offset, nsize))
                applied += 1
                end = offset + disk
            self._idx_f.flush()
            if end != start + len(data):
                self.dat.truncate(end)
                raise IOError(
                    f"incremental segment ends mid-record at {end}; "
                    f"{start + len(data) - end} trailing bytes dropped")
            return applied

    def modified_at_second(self) -> int:
        """Unix seconds of the last write, falling back to the .dat
        file mtime when no stamped record exists yet — a TTL volume
        that was assigned but never written must still age out
        (reference initializes lastModifiedTsSeconds from file mtime)."""
        if self.last_append_at_ns:
            return self.last_append_at_ns // 1_000_000_000
        try:
            return int(os.path.getmtime(self.file_name() + ".dat"))
        except OSError:
            return 0

    def sync_status(self) -> dict:
        """Volume state for sync negotiation (VolumeSyncStatusResponse,
        volume_server.proto)."""
        return {"volume": self.vid,
                "tail_offset": self.dat.size(),
                "compact_revision": self.super_block.compaction_revision,
                "last_append_at_ns": self.last_append_at_ns,
                "read_only": self.read_only}

    # -- tiering -------------------------------------------------------
    @property
    def is_remote(self) -> bool:
        """True when the .dat lives on a backend storage (tiered)."""
        return isinstance(self.dat, bk.S3RangeFile)

    def tier_upload(self, storage: "bk.S3BackendStorage",
                    keep_local: bool = False) -> vinfo.RemoteFile:
        """Move the .dat to a backend storage and record it in .vif
        (VolumeTierMoveDatToRemote, volume_grpc_tier_upload.go;
        shell command_volume_tier_upload.go). The volume becomes
        read-only; the .idx stays local."""
        if self.is_remote or (self.volume_info and
                              self.volume_info.remote_file()):
            raise ValueError(f"volume {self.vid} is already tiered")
        self.detach_native()  # the .dat is about to be closed/removed
        base = self.file_name()
        was_read_only = self.read_only
        self.read_only = True
        self.sync()
        key = storage.object_key(base + ".dat")
        try:
            size = storage.upload_file(self.dat, key)
        except Exception:
            # a failed upload must not wedge the volume read-only
            self.read_only = was_read_only
            raise
        rf = vinfo.RemoteFile(
            backend_type="s3", backend_id=storage.id, key=key,
            file_size=size, modified_time=int(time.time()))
        self._adopt_remote(rf, keep_local, storage)
        return rf

    def tier_adopt(self, rf: vinfo.RemoteFile, keep_local: bool = False) \
            -> None:
        """Record an already-uploaded remote copy in the .vif and drop
        the local .dat — used by replicas after one of them did the
        actual upload, so an N-replica tier.upload transfers the bytes
        once, not N times."""
        if self.is_remote:
            raise ValueError(f"volume {self.vid} is already tiered")
        self.detach_native()
        self.read_only = True
        self.sync()
        self._adopt_remote(rf, keep_local, bk.get_storage(rf.backend_name))

    def _adopt_remote(self, rf: vinfo.RemoteFile, keep_local: bool,
                      storage: "bk.S3BackendStorage") -> None:
        base = self.file_name()
        self.volume_info = vinfo.VolumeInfo(
            version=self.version,
            replication=str(self.super_block.replica_placement),
            files=[rf])
        vinfo.save_volume_info(base + ".vif", self.volume_info)
        if not keep_local:
            self.dat.close()
            os.remove(base + ".dat")
            self.dat = storage.open_file(rf.key, rf.file_size)

    def tier_download(self, delete_remote: bool = True) -> None:
        """Bring a tiered .dat back to local disk
        (VolumeTierMoveDatFromRemote, volume_grpc_tier_download.go)."""
        remote = self.volume_info.remote_file() if self.volume_info else None
        if remote is None:
            raise ValueError(f"volume {self.vid} is not tiered")
        storage = bk.get_storage(remote.backend_name)
        base = self.file_name()
        if not os.path.exists(base + ".dat"):
            storage.download_to(remote.key, base + ".dat")
        self.dat.close()
        self.dat = bk.DiskFile(base + ".dat")
        self.volume_info = None
        try:
            os.remove(base + ".vif")
        except FileNotFoundError:
            pass
        if delete_remote:
            storage.delete(remote.key)
        self.read_only = False

    def compact(self) -> None:
        """Two-phase vacuum: write surviving live needles to .cpd/.cpx,
        then atomically swap (Compact2 + CommitCompact,
        volume_vacuum.go:67,102)."""
        if self.is_remote:
            raise PermissionError(
                f"volume {self.vid} is tiered; download before compacting")
        if self.delegate is not None:
            raise RuntimeError(
                f"volume {self.vid} is natively attached; detach "
                "before compacting")
        base = self.file_name()
        cpd, cpx = base + ".cpd", base + ".cpx"
        new_sb = SuperBlock(
            version=self.super_block.version,
            replica_placement=self.super_block.replica_placement,
            ttl=self.super_block.ttl,
            compaction_revision=(self.super_block.compaction_revision + 1)
            & 0xFFFF)
        with self.write_lock:
            # snapshot under the write lock: a concurrent put would
            # otherwise mutate the dict mid-iteration, and the idx
            # watermark must match the item set exactly
            items = sorted(self.nm.live_items(), key=lambda kv: kv[1])
            self._idx_f.flush()
            idx_snapshot = os.path.getsize(base + ".idx")
        with open(cpd, "wb") as datf, open(cpx, "wb") as idxf:
            datf.write(new_sb.to_bytes())
            write_offset = datf.tell()
            for key, stored_off, size in items:
                blob = self.dat.read_at(
                    ndl.disk_size(size, self.version),
                    t.offset_to_actual(stored_off))
                datf.write(blob)
                idxmod.append_entry(
                    idxf, key, t.actual_to_offset(write_offset), size)
                write_offset += len(blob)
        self._commit_compact(cpd, cpx, idx_snapshot)

    def _commit_compact(self, cpd: str, cpx: str,
                        idx_snapshot: int) -> None:
        """Swap in the compacted files, first replaying every index
        entry appended since the snapshot (writes and tombstones that
        raced the compaction) into them (CommitCompact makeupDiff,
        volume_vacuum.go:200). Holds the write lock so nothing lands
        between the replay and the swap."""
        base = self.file_name()
        with self.write_lock:
            self._idx_f.flush()
            with open(base + ".idx", "rb") as f:
                f.seek(idx_snapshot)
                delta = f.read()
            if delta:
                with open(cpd, "ab") as datf, open(cpx, "ab") as idxf:
                    write_offset = os.path.getsize(cpd)
                    step = t.NEEDLE_MAP_ENTRY_SIZE
                    for i in range(0, len(delta) - step + 1, step):
                        nv = t.NeedleValue.from_bytes(delta[i:i + step])
                        if t.size_is_valid(nv.size) and nv.offset > 0:
                            blob = self.dat.read_at(
                                ndl.disk_size(nv.size, self.version),
                                t.offset_to_actual(nv.offset))
                            datf.write(blob)
                            idxmod.append_entry(
                                idxf, nv.key,
                                t.actual_to_offset(write_offset),
                                nv.size)
                            write_offset += len(blob)
                        else:
                            idxmod.append_entry(idxf, nv.key, 0,
                                                t.TOMBSTONE_SIZE)
            self.dat.close()
            self._idx_f.close()
            if self.needle_map_kind == "btree":
                # drop the sidecar BEFORE the .idx swap: a crash in
                # between leaves no sidecar (full rebuild next open)
                # instead of a stale one whose size-only watermark
                # could coincidentally match the rewritten .idx
                nmap.drop_btree_sidecar(base + ".idx")
            os.replace(cpd, base + ".dat")
            os.replace(cpx, base + ".idx")
            # reopen with the volume's configured local backend so an
            # mmap volume stays mmap after its first vacuum
            if self._backend_kind in ("disk", "mmap"):
                self.dat = bk.create(self._backend_kind, base + ".dat")
            else:
                self.dat = bk.DiskFile(base + ".dat")
            self.super_block = self._read_super_block()
            if hasattr(self.nm, "close"):
                self.nm.close()
            self.nm = nmap.load_needle_map(base + ".idx",
                                           kind=self.needle_map_kind)
            self._idx_f = open(base + ".idx", "ab")

    def commit_batch(self, durable: bool) -> None:
        """One group-commit step (the storage/commit.py committer).

        durable=True fdatasyncs the .dat ONLY — one journal commit per
        batch, not two. The .idx is flushed to the OS but rides the
        page cache: acked index entries are recoverable from the synced
        .dat by check_integrity's tail replay (the .idx appends in .dat
        order, so any loss is a suffix the replay regains).
        durable=False is buffered mode's commit: flush the .idx and
        the btree watermark, no fsync. Takes no lock, as sync() — the
        committer waits behind a vacuum swap itself. While the volume is
        natively attached there is no .idx buffer here to flush: the
        front's appends are unbuffered pwrites."""
        if durable:
            dat = self.dat
            (dat.datasync if hasattr(dat, "datasync") else dat.sync)()
        if self.delegate is not None:
            return
        self._idx_f.flush()
        if hasattr(self.nm, "set_watermark"):
            self.nm.set_watermark(self._idx_f.tell())

    def sync(self) -> None:
        self.dat.sync()
        if self.delegate is not None:
            # native writes are unbuffered pwrites; fsync the .idx
            # through our own handle to the same file
            os.fsync(self._idx_f.fileno())
            return
        self._idx_f.flush()
        os.fsync(self._idx_f.fileno())
        if hasattr(self.nm, "set_watermark"):
            # btree sidecar: remember how much .idx the committed db
            # reflects, so reopen replays only the tail past it
            self.nm.set_watermark(self._idx_f.tell())

    def close(self) -> None:
        self.detach_native(reload_map=False)
        try:
            self.sync()
        finally:
            self.dat.close()
            self._idx_f.close()
            if hasattr(self.nm, "close"):
                self.nm.close()

    def destroy(self) -> None:
        remote = self.volume_info.remote_file() if self.volume_info else None
        self.close()
        if remote is not None:
            try:
                bk.get_storage(remote.backend_name).delete(remote.key)
            except KeyError:
                pass  # backend no longer configured; leave the object
        base = self.file_name()
        exts = [".dat", ".idx"]
        # ec.encode deletes the source volume AFTER generating shards:
        # the .vif now carries the shard set's codec record and must
        # survive as long as any shard file does
        from ..ec import geometry as _geo

        if not any(os.path.exists(base + _geo.shard_ext(i))
                   for i in range(_geo.MAX_SHARD_COUNT)):
            exts.append(".vif")
        for ext in exts:
            try:
                os.remove(base + ext)
            except FileNotFoundError:
                pass
        # a leftover sidecar would poison a future same-vid volume
        # copied in from a peer (its watermark could pass the size check)
        nmap.drop_btree_sidecar(base + ".idx")
