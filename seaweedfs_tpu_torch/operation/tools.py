"""Offline volume file tools: fix, compact, export, see.dat, see.idx;
the counterpart of seaweedfs_tpu/operation/tools.py.

Equivalents of SeaweedFS weed/command/fix.go (offline .idx
reconstruction by scanning the .dat), command/compact.go (offline
vacuum) and command/export.go (dump live needles out of a volume into a
tar archive). These operate directly on volume files with the server
stopped — the recovery toolbox when an index is corrupt or a server
won't start.
"""
from __future__ import annotations

import io
import os
import tarfile
import time

from ..storage import types as t
from ..storage.volume import Volume


def _require_dat(dirname: str, vid: int, collection: str) -> None:
    """Opening a Volume auto-creates missing files; an offline tool
    pointed at a wrong id must error, not fabricate an empty volume."""
    name = f"{collection}_{vid}" if collection else str(vid)
    dat = os.path.join(dirname, name + ".dat")
    if not os.path.exists(dat):
        raise FileNotFoundError(f"no volume file {dat}")


def fix_volume(dirname: str, vid: int, collection: str = "") -> dict:
    """Rebuild <vid>.idx from the .dat (command/fix.go:24-40)."""
    _require_dat(dirname, vid, collection)
    v = Volume(dirname, collection, vid)
    try:
        v.rebuild_index()
        return {"volume": vid, "records": v.nm.file_count,
                "idx": v.file_name() + ".idx"}
    finally:
        v.close()


def compact_volume(dirname: str, vid: int, collection: str = "") -> dict:
    """Offline vacuum: drop deleted/overwritten records
    (command/compact.go)."""
    _require_dat(dirname, vid, collection)
    v = Volume(dirname, collection, vid)
    try:
        before = v.dat.size()
        v.compact()
        return {"volume": vid, "before_bytes": before,
                "after_bytes": v.dat.size(), "records": v.nm.file_count}
    finally:
        v.close()


def export_volume(dirname: str, vid: int, out_tar: str,
                  collection: str = "", newer_than_ns: int = 0) -> dict:
    """Write every live needle to a tar archive, named by its stored
    file name when present else its hex id (command/export.go). Deleted
    records are skipped; `newer_than_ns` filters by append stamp."""
    _require_dat(dirname, vid, collection)
    v = Volume(dirname, collection, vid)
    count, total = 0, 0
    try:
        with tarfile.open(out_tar, "w") as tar:
            for offset, nid, nsize, _disk in v._walk_records(
                    v.super_block.block_size):
                if nsize <= 0:
                    continue
                loc = v.nm.get(nid)
                if loc is None or t.offset_to_actual(loc[0]) != offset:
                    continue  # overwritten or deleted later
                if newer_than_ns and v._append_at_ns_at(
                        offset, nsize) <= newer_than_ns:
                    continue
                n = v.read_needle(nid)
                name = n.name.decode("utf-8", "replace") if n.name \
                    else f"{nid:x}"
                if n.is_compressed and not name.endswith(".gz"):
                    name += ".gz"  # export.go:248 marks gzipped bodies
                info = tarfile.TarInfo(name=f"vol{vid}/{name}")
                info.size = len(n.data)
                info.mtime = n.last_modified or int(time.time())
                tar.addfile(info, io.BytesIO(n.data))
                count += 1
                total += len(n.data)
        return {"volume": vid, "files": count, "bytes": total,
                "tar": os.path.abspath(out_tar)}
    finally:
        v.close()


def see_dat(dirname: str, vid: int, collection: str = ""):
    """Yield one dict per record in .dat order — the unmaintained
    see_dat inspector: full needle decode (name/mime/flags/ttl),
    deleted records included. For spot-checking volume files."""
    from ..storage import needle as ndl

    _require_dat(dirname, vid, collection)
    v = Volume(dirname, collection, vid)
    try:
        import struct

        offset = v.super_block.block_size
        size = v.dat.size()
        while offset + t.NEEDLE_HEADER_SIZE <= size:
            head = v.dat.read_at(t.NEEDLE_HEADER_SIZE, offset)
            _, nid, size_u32 = struct.unpack(">IQI", head)
            nsize = t.u32_to_size(size_u32)
            disk = ndl.disk_size(max(nsize, 0), v.version)
            if offset + disk > size:
                break
            rec = {"offset": offset, "id": nid, "size": nsize,
                   "deleted": nsize <= 0}
            if nsize > 0:
                try:
                    n = ndl.Needle.from_bytes(
                        v.dat.read_at(disk, offset), v.version)
                    rec.update({
                        "cookie": n.cookie,
                        "name": n.name.decode("utf-8", "replace"),
                        "mime": n.mime.decode("utf-8", "replace"),
                        "data_bytes": len(n.data),
                        "flags": n.flags,
                        "last_modified": n.last_modified,
                        "crc_ok": True,
                    })
                except ValueError as e:
                    rec["crc_ok"] = False
                    rec["error"] = str(e)
            yield rec
            offset += disk
    finally:
        v.close()


def see_idx(dirname: str, vid: int, collection: str = ""):
    """Yield (key, offset, size) per .idx entry in file order — the
    unmaintained see_idx inspector."""
    from ..storage import idx as idxmod

    name = f"{collection}_{vid}" if collection else str(vid)
    path = os.path.join(dirname, name + ".idx")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no index file {path}")
    for e in idxmod.iter_entries(path):
        yield {"key": e.key, "offset": e.offset,
               "byte_offset": t.offset_to_actual(e.offset),
               "size": e.size, "deleted": e.size <= 0}
