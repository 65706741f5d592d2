"""The storage layer of the torch port against the JAX package's, byte for
byte (tolerance 0): needle records (v2 and v3, every field, the padding
quirk, CRC32C from the port's native library against google_crc32c,
corruption and the legacy CRC), the super block and replica placement,
file ids, the storage backends, the three needle-map kinds, and volumes
driven through the same write / overwrite / delete sequence with the
clock pinned in both packages — .dat and .idx equal after the writes,
after a reload, after compact and after rebuild_index — plus the
workload sketches. The last test reruns the volume, EC-volume and
Store tests with WEED_5BYTES_OFFSET=1 (17-byte index entries)."""
import os
import struct
import subprocess
import sys
import types as pytypes

import google_crc32c
import numpy as np
import pytest

from seaweedfs_tpu.storage import backend as ref_bk
from seaweedfs_tpu.storage import idx as ref_idx
from seaweedfs_tpu.storage import needle as ref_ndl
from seaweedfs_tpu.storage import needle_map as ref_nmap
from seaweedfs_tpu.storage import super_block as ref_sb
from seaweedfs_tpu.storage import types as ref_t
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu.utils import sketch as ref_sketch
from seaweedfs_tpu_torch import native
from seaweedfs_tpu_torch.storage import backend as bk
from seaweedfs_tpu_torch.storage import idx as idxmod
from seaweedfs_tpu_torch.storage import needle as ndl
from seaweedfs_tpu_torch.storage import needle_map as nmap
from seaweedfs_tpu_torch.storage import super_block as sb
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage import volume as volume_mod
from seaweedfs_tpu_torch.utils import sketch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_760_000_000_123_456_789   # the pinned wall clock, ns


@pytest.fixture()
def pinned_clock(monkeypatch):
    """Both packages' volumes read one fixed clock: append_at_ns is then
    max(T0, last + 1) in each, so records match byte for byte."""
    clock = pytypes.SimpleNamespace(time_ns=lambda: T0,
                                    time=lambda: T0 / 1e9)
    for mod in (ref_volume, volume_mod):
        monkeypatch.setattr(mod, "time", clock)


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# -- CRC32C ---------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 3, 7, 8, 9, 15, 16, 17, 31, 63, 64,
                               65, 1000, 4097, (1 << 20) + 3])
def test_crc32c_matches_google(n):
    rng = np.random.default_rng(n)
    data = rng.bytes(n)
    want = google_crc32c.value(data)
    assert ndl.crc32c(data) == native.crc32c(data) == want
    assert ndl.crc32c(data) == ref_ndl.crc32c(data)
    head = rng.bytes(13)
    assert ndl.crc32c(data, ndl.crc32c(head)) == \
        google_crc32c.extend(google_crc32c.value(head), data) == \
        google_crc32c.value(head + data)
    rows = rng.integers(0, 256, (3, n), dtype=np.uint8)
    assert native.crc32c_batch(rows).tolist() == \
        [google_crc32c.value(r.tobytes()) for r in rows]


def test_legacy_crc_value_matches():
    for c in (0, 1, 0xFFFFFFFF, 0x12345678, google_crc32c.value(b"x")):
        assert ndl.legacy_crc_value(c) == ref_ndl.legacy_crc_value(c)


# -- needle records ----------------------------------------------------------

def _needle_cases():
    rng = np.random.default_rng(7)
    yield "simple", dict(id=0x1234, cookie=0xDEADBEEF, data=b"hello world")
    yield "all fields", dict(
        id=7, cookie=9, data=rng.bytes(100), name=b"a.txt",
        mime=b"text/plain", pairs=b'{"k":"v"}', last_modified=1700000000,
        ttl=b"\x05\x02", append_at_ns=T0)
    yield "tombstone", dict(id=42)
    yield "empty data with a name", dict(id=43, cookie=1, name=b"n")
    for size in range(1, 10):
        yield f"data of {size} B", dict(id=size, cookie=size,
                                       data=rng.bytes(size))
    yield "long name truncated", dict(id=5, data=b"x", name=b"n" * 300)
    yield "flags kept", dict(id=6, data=b"gz", flags=ndl.FLAG_IS_COMPRESSED
                             | ndl.FLAG_IS_CHUNK_MANIFEST)
    yield "max cookie and id", dict(id=2**64 - 1, cookie=2**32 - 1,
                                    data=rng.bytes(4096))


NEEDLE_CASES = list(_needle_cases())


def _fields(n) -> tuple:
    return (n.id, n.cookie, bytes(n.data), bytes(n.name), bytes(n.mime),
            bytes(n.pairs), n.flags, n.last_modified, bytes(n.ttl),
            n.checksum, n.append_at_ns, n.size)


@pytest.mark.parametrize("version", [2, 3])
@pytest.mark.parametrize("case", [c[0] for c in NEEDLE_CASES])
def test_needle_record_bytes(case, version):
    kw = dict(NEEDLE_CASES)[case]
    port, ref = ndl.Needle(**kw), ref_ndl.Needle(**kw)
    blob = port.to_bytes(version)
    assert blob == ref.to_bytes(version)
    assert _fields(port) == _fields(ref)
    # the padding quirk: disk_size agrees with the record written, a
    # full 8 bytes of padding when the unpadded record is aligned
    assert len(blob) == ndl.disk_size(port.size, version) == \
        ref_ndl.disk_size(ref.size, version)
    assert len(blob) % t.NEEDLE_PADDING == 0
    back = ndl.Needle.from_bytes(blob, version)
    assert _fields(back) == _fields(ref_ndl.Needle.from_bytes(blob, version))
    assert bytes(back.data) == bytes(port.data)
    if port.data:
        assert back.checksum == google_crc32c.value(bytes(port.data))
    assert back.etag() == ref_ndl.Needle.from_bytes(blob, version).etag()


@pytest.mark.parametrize("version", [2, 3])
@pytest.mark.parametrize("size", range(0, 17))
def test_padding_quirk(size, version):
    assert ndl.padding_length(size, version) == \
        ref_ndl.padding_length(size, version)
    assert 1 <= ndl.padding_length(size, version) <= 8
    assert ndl.body_length(size, version) == \
        ref_ndl.body_length(size, version)
    unpadded = t.NEEDLE_HEADER_SIZE + size + ndl.CHECKSUM_SIZE + \
        (t.TIMESTAMP_SIZE if version == 3 else 0)
    if unpadded % 8 == 0:
        assert ndl.padding_length(size, version) == 8


@pytest.mark.parametrize("version", [2, 3])
def test_needle_crc_on_read(version):
    n = ndl.Needle(id=1, cookie=2, data=b"payload bytes, odd length!")
    blob = bytearray(n.to_bytes(version))
    crc_at = t.NEEDLE_HEADER_SIZE + n.size
    # the legacy transform of the CRC reads in both packages
    actual = google_crc32c.value(b"payload bytes, odd length!")
    struct.pack_into(">I", blob, crc_at, ndl.legacy_crc_value(actual))
    for mod in (ndl, ref_ndl):
        back = mod.Needle.from_bytes(bytes(blob), version)
        assert back.data == b"payload bytes, odd length!"
        assert back.checksum == actual
    # a flipped data byte, or a wrong stored CRC, is corruption
    flipped = bytearray(n.to_bytes(version))
    flipped[t.NEEDLE_HEADER_SIZE + 5] ^= 0xFF
    wrong = bytearray(n.to_bytes(version))
    struct.pack_into(">I", wrong, crc_at, actual ^ 1)
    for bad in (flipped, wrong):
        for mod in (ndl, ref_ndl):
            with pytest.raises(ValueError, match="CRC"):
                mod.Needle.from_bytes(bytes(bad), version)
            assert mod.Needle.from_bytes(bytes(bad), version,
                                         verify_crc=False).size == n.size
    # a flipped length byte reads as corruption, not a crash
    torn = bytearray(ndl.Needle(id=3, data=b"d", name=b"nm",
                                mime=b"m").to_bytes(version))
    torn[t.NEEDLE_HEADER_SIZE + 4 + 1 + 1] = 0xFF    # the name length
    for mod in (ndl, ref_ndl):
        with pytest.raises(ValueError):
            mod.Needle.from_bytes(bytes(torn), version)


@pytest.mark.parametrize("field,value", [
    ("mime", b"m" * 256), ("pairs", b"p" * 0x10000)])
def test_needle_limits_raise_in_both(field, value):
    for mod in (ndl, ref_ndl):
        with pytest.raises(ValueError):
            mod.Needle(id=1, data=b"x", **{field: value}).to_bytes()
    for mod in (ndl, ref_ndl):
        with pytest.raises(ValueError, match="version"):
            mod.Needle(id=1, data=b"x").to_bytes(4)


def test_whole_records_prefix():
    rng = np.random.default_rng(3)
    stream = b"".join(ndl.Needle(id=i, data=rng.bytes(i * 7)).to_bytes()
                      for i in range(1, 12))
    for cut in (0, 15, 16, 40, len(stream) - 1, len(stream)):
        assert ndl.whole_records_prefix(stream[:cut]) == \
            ref_ndl.whole_records_prefix(stream[:cut])
    assert ndl.whole_records_prefix(stream) == len(stream)


# -- super block, replica placement, file ids --------------------------------

@pytest.mark.parametrize("spec", ["000", "001", "010", "100", "012", "112",
                                  "222", "", "1", "20"])
def test_replica_placement(spec):
    p, r = sb.ReplicaPlacement.parse(spec), ref_sb.ReplicaPlacement.parse(spec)
    assert (p.to_byte(), str(p), p.copy_count) == \
        (r.to_byte(), str(r), r.copy_count)
    assert sb.ReplicaPlacement.from_byte(p.to_byte()) == p


@pytest.mark.parametrize("bad", ["9", "300", "013"[:1] + "3"])
def test_replica_placement_rejects(bad):
    for mod in (sb, ref_sb):
        with pytest.raises(ValueError):
            mod.ReplicaPlacement.parse(bad)


@pytest.mark.parametrize("version,extra", [(2, b""), (3, b""),
                                           (3, b"\x08\x01extra"), (1, b"")])
def test_super_block_bytes(tmp_path, version, extra):
    kw = dict(version=version, ttl=b"\x03\x01", compaction_revision=0xFFFE,
              extra=extra)
    p = sb.SuperBlock(replica_placement=sb.ReplicaPlacement.parse("012"),
                      **kw)
    r = ref_sb.SuperBlock(
        replica_placement=ref_sb.ReplicaPlacement.parse("012"), **kw)
    blob = p.to_bytes()
    assert blob == r.to_bytes()
    assert p.block_size == r.block_size
    back = sb.SuperBlock.from_bytes(blob)
    assert back.to_bytes() == blob and back.extra == extra
    path = tmp_path / "x.dat"
    path.write_bytes(blob + b"\x00" * 40)
    with open(path, "rb") as f:
        f.seek(17)
        assert sb.SuperBlock.read_from(f).to_bytes() == blob
        assert f.tell() == 17
    with pytest.raises(ValueError):
        sb.SuperBlock.from_bytes(blob[:7])


@pytest.mark.parametrize("fid", ["3,01637037d6", "3,01637037d6_1",
                                 "3,01637037d6_15", "7,ff00000000ab",
                                 "3,01637037d6_x", "3,1234", "3,"])
def test_file_ids(fid):
    try:
        want = ref_t.parse_file_id(fid)
    except ValueError:
        with pytest.raises(ValueError):
            t.parse_file_id(fid)
        return
    assert t.parse_file_id(fid) == want
    assert t.format_file_id(*want) == ref_t.format_file_id(*want)
    assert t.MAX_VOLUME_SIZE == ref_t.MAX_VOLUME_SIZE


# -- storage backends ---------------------------------------------------------

@pytest.mark.parametrize("kind", ["disk", "memory", "mmap"])
def test_storage_files(tmp_path, kind):
    args = ({"create": True} if kind != "memory" else {})
    port = bk.create(kind, str(tmp_path / "p.dat"), **args)
    ref = ref_bk.create(kind, str(tmp_path / "r.dat"), **args)
    blob = np.random.default_rng(5).bytes(3 << 20)
    for f in (port, ref):
        assert f.append(b"A" * 10) == 0
        f.write_at(b"BB", 4)
        assert f.append(blob) == 10     # grows an mmap past a remap
    assert port.size() == ref.size() == 10 + (3 << 20)
    for size, off in ((10, 0), (100, 5), (7, (3 << 20) + 5), (50, 1 << 40)):
        assert port.read_at(size, off) == ref.read_at(size, off)
    port.truncate(1000)
    ref.truncate(1000)
    assert port.read_at(2000, 0) == ref.read_at(2000, 0)
    for f in (port, ref):
        f.flush()
        f.sync()
        f.close()
    if kind != "memory":
        assert _read(str(tmp_path / "p.dat")) == _read(str(tmp_path / "r.dat"))


def test_storage_backend_registry():
    with pytest.raises(RuntimeError, match="rclone"):
        bk.create("rclone", "remote:path")
    with pytest.raises(KeyError, match="unknown storage backend"):
        bk.create("s3", "bucket/key")
    with pytest.raises(FileNotFoundError):
        bk.DiskFile("/nonexistent-dir-for-test/x.dat")


# -- needle maps --------------------------------------------------------------

def _map_ops(seed: int, n: int = 400):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        key = int(rng.integers(1, 120))
        if rng.random() < 0.2:
            ops.append(("delete", key))
        else:
            ops.append(("put", key, int(rng.integers(1, 1 << 20)),
                        int(rng.integers(1, 5000))))
    return ops


def _state(m) -> tuple:
    return (sorted(m.items()), sorted(m.live_items()),
            sorted(m.deleted_keys()), m.file_count, m.deleted_count,
            m.file_bytes, m.deleted_bytes, m.max_key)


@pytest.mark.parametrize("kind", ["memory", "compact", "btree"])
def test_needle_maps(tmp_path, kind, monkeypatch):
    if kind == "compact":   # exercise the overlay merges
        monkeypatch.setattr(nmap.CompactNeedleMap, "OVERLAY_LIMIT", 16)
        monkeypatch.setattr(ref_nmap.CompactNeedleMap, "OVERLAY_LIMIT", 16)
    port = nmap.new_needle_map(kind, idx_path=str(tmp_path / "p.idx"))
    ref = ref_nmap.new_needle_map(kind, idx_path=str(tmp_path / "r.idx"))
    rows = []
    for op in _map_ops(11):
        if op[0] == "put":
            assert port.put(*op[1:]) == ref.put(*op[1:])
            rows.append((op[1], op[2], op[3]))
        else:
            assert port.delete(op[1]) == ref.delete(op[1])
            rows.append((op[1], 0, t.size_to_u32(t.TOMBSTONE_SIZE)))
        assert port.get(op[1]) == ref.get(op[1])
        assert port.get_any(op[1]) == ref.get_any(op[1])
    assert _state(port) == _state(ref)
    assert len(port) == len(ref)
    for m in (port, ref):
        if hasattr(m, "close"):
            m.close()
    # the same .idx replays to the same map in both packages
    idxmod.write_index(str(tmp_path / "x.idx"),
                       np.array(rows, dtype=idxmod.IDX_DTYPE))
    ref_idx.write_index(str(tmp_path / "y.idx"),
                        np.array(rows, dtype=ref_idx.IDX_DTYPE))
    assert _read(str(tmp_path / "x.idx")) == _read(str(tmp_path / "y.idx"))
    port = nmap.load_needle_map(str(tmp_path / "x.idx"), kind)
    ref = ref_nmap.load_needle_map(str(tmp_path / "y.idx"), kind)
    assert _state(port) == _state(ref)
    for m in (port, ref):
        if hasattr(m, "close"):
            m.close()
    with pytest.raises(ValueError):
        nmap.load_needle_map(str(tmp_path / "x.idx"), "leveldb")
    if kind == "btree":
        assert os.path.exists(str(tmp_path / "x.idx.bdb"))
        nmap.drop_btree_sidecar(str(tmp_path / "x.idx"))
        assert not os.path.exists(str(tmp_path / "x.idx.bdb"))


def test_btree_watermark_tail_replay(tmp_path):
    """A .bdb sidecar behind its .idx catches up from the tail, in both
    packages, to the same map."""
    rows = [(k, k * 8, 100 + k) for k in range(1, 50)]
    for mod, imod, name in ((nmap, idxmod, "p"), (ref_nmap, ref_idx, "r")):
        path = str(tmp_path / f"{name}.idx")
        imod.write_index(path, np.array(rows[:30], dtype=imod.IDX_DTYPE))
        m = mod.load_needle_map(path, "btree")
        m.close()
        with open(path, "ab") as f:
            for k, off, size in rows[30:]:
                imod.append_entry(f, k, off, size)
            imod.append_entry(f, 3, 0, t.TOMBSTONE_SIZE)
    port = nmap.load_needle_map(str(tmp_path / "p.idx"), "btree")
    ref = ref_nmap.load_needle_map(str(tmp_path / "r.idx"), "btree")
    assert _state(port) == _state(ref)
    assert port.get(3) is None and port.get(49) == (49 * 8, 149)
    port.close()
    ref.close()


# -- volumes ------------------------------------------------------------------

def _write_sequence(ndl_mod, v, seed: int) -> list:
    """Seeded appends (every field on some), 8 overwrites, 6 deletes,
    one delete of an absent id -> what each call returned."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(60):
        kw = dict(id=int(rng.integers(1, 1 << 40)),
                  cookie=int(rng.integers(0, 1 << 32)),
                  data=rng.bytes(int(rng.integers(0, 3000))))
        if i % 5 == 0:
            kw.update(name=b"f%d.bin" % i, mime=b"application/x",
                      last_modified=1700000000 + i, ttl=b"\x03\x01",
                      pairs=b'{"i":%d}' % i)
        out.append(("put", kw["id"], v.append_needle(ndl_mod.Needle(**kw))))
    keys = [o[1] for o in out]
    for j in range(8):
        key = keys[j * 7]
        out.append(("over", key, v.append_needle(ndl_mod.Needle(
            id=key, cookie=j, data=rng.bytes(int(rng.integers(1, 500)))))))
    for j in range(6):
        out.append(("del", keys[j * 9 + 1], v.delete_needle(keys[j * 9 + 1])))
    out.append(("del", 12345, v.delete_needle(12345)))
    return out


def _reads(v, keys) -> list:
    out = []
    for key in keys:
        try:
            n = v.read_needle(key)
            out.append(_fields(n))
        except KeyError:
            out.append(None)
    return out


def _pair(tmp_path, kind, backend="disk", collection="col"):
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    port = volume_mod.Volume(str(tmp_path / "p"), collection, 9, create=True,
                             needle_map_kind=kind, backend_kind=backend)
    ref = ref_volume.Volume(str(tmp_path / "r"), collection, 9, create=True,
                            needle_map_kind=kind, backend_kind=backend)
    return port, ref


def _files_equal(port, ref, exts=(".dat", ".idx")):
    for ext in exts:
        assert _read(port.file_name() + ext) == _read(ref.file_name() + ext), \
            ext


@pytest.mark.parametrize("kind", ["memory", "compact", "btree"])
def test_volume_matches_reference(tmp_path, pinned_clock, kind):
    port, ref = _pair(tmp_path, kind)
    got = _write_sequence(ndl, port, 21)
    assert got == _write_sequence(ref_ndl, ref, 21)
    keys = sorted({g[1] for g in got})
    assert _reads(port, keys) == _reads(ref, keys)
    assert port.last_append_at_ns == ref.last_append_at_ns > T0
    assert port.garbage_ratio() == ref.garbage_ratio() > 0
    assert port.scrub() == ref.scrub()
    # streamed reads: metadata, data size and every window
    for key in keys[:20]:
        try:
            meta, size, reader = port.read_needle_streamed(key)
        except KeyError:
            with pytest.raises(KeyError):
                ref.read_needle_streamed(key)
            continue
        rmeta, rsize, rreader = ref.read_needle_streamed(key)
        assert (_fields(meta), size) == (_fields(rmeta), rsize)
        assert reader(0, size) == rreader(0, size)
        assert reader(size // 3, 17) == rreader(size // 3, 17)
    # a tombstoned needle read with read_deleted
    dead = next(g[1] for g in got if g[0] == "del")
    assert _fields(port.read_needle(dead, read_deleted=True)) == \
        _fields(ref.read_needle(dead, read_deleted=True))
    live = next(k for k in keys if port.nm.get(k) is not None)
    wrong = port.read_needle(live).cookie ^ 1
    for v in (port, ref):
        with pytest.raises(PermissionError):
            v.read_needle(live, cookie=wrong)
    assert port.sync_status() == ref.sync_status()
    assert port.modified_at_second() == ref.modified_at_second()
    for since in (0, T0 - 1, T0 + 10, T0 + 40, T0 + 10**6):
        assert port.offset_for_append_at_ns(since) == \
            ref.offset_for_append_at_ns(since)
    assert port.read_segment(8, 5000) == ref.read_segment(8, 5000)
    for v in (port, ref):
        v.sync()
    _files_equal(port, ref)
    port.close()
    ref.close()

    # reload: integrity check and append_at_ns recovery agree
    port = volume_mod.Volume(str(tmp_path / "p"), "col", 9,
                             needle_map_kind=kind)
    ref = ref_volume.Volume(str(tmp_path / "r"), "col", 9,
                            needle_map_kind=kind)
    assert port.last_append_at_ns == ref.last_append_at_ns
    assert _reads(port, keys) == _reads(ref, keys)
    _files_equal(port, ref)

    # compact: .dat / .idx rewritten the same way, reads unchanged
    port.compact()
    ref.compact()
    _files_equal(port, ref)
    assert port.super_block.compaction_revision == 1
    assert _reads(port, keys) == _reads(ref, keys)
    assert (port.nm.file_count, port.nm.deleted_count) == \
        (ref.nm.file_count, ref.nm.deleted_count)

    # rebuild_index from the .dat (the native record walker)
    port.rebuild_index()
    ref.rebuild_index()
    _files_equal(port, ref)
    assert _reads(port, keys) == _reads(ref, keys)
    assert sorted(port.nm.live_items()) == sorted(ref.nm.live_items())
    port.close()
    ref.close()


@pytest.mark.parametrize("kind", ["memory", "btree"])
def test_volume_rebuild_index_after_writes(tmp_path, pinned_clock, kind):
    """rebuild_index on a volume with tombstone records (no compact in
    between) gives the reference's .idx; on an in-memory .dat it is the
    Python walk, on disk the native walker."""
    for backend in ("disk", "memory"):
        root = tmp_path / backend
        root.mkdir()
        port, ref = _pair(root, kind, backend=backend)
        _write_sequence(ndl, port, 5)
        _write_sequence(ref_ndl, ref, 5)
        port.rebuild_index()
        ref.rebuild_index()
        assert _read(port.file_name() + ".idx") == \
            _read(ref.file_name() + ".idx")
        assert port.dat.read_at(1 << 20, 0) == ref.dat.read_at(1 << 20, 0)
        keys = sorted(k for k, _, _ in ref.nm.items())
        assert _reads(port, keys) == _reads(ref, keys)
        port.close()
        ref.close()


@pytest.mark.parametrize("tail", ["partial record", "sub-header residue",
                                  "unaligned bytes", "corrupt crc"])
def test_volume_torn_tail_recovery(tmp_path, pinned_clock, tail):
    port, ref = _pair(tmp_path, "memory")
    for v, mod in ((port, ndl), (ref, ref_ndl)):
        _write_sequence(mod, v, 8)
        v.close()
    rng = np.random.default_rng(2)
    extra = ndl.Needle(id=77, cookie=1, data=rng.bytes(300),
                       append_at_ns=T0 + 999).to_bytes()
    garbage = {"partial record": extra[:-40],
               "sub-header residue": b"\x00" * 8,
               "unaligned bytes": b"\x01\x02\x03",
               "corrupt crc": extra[:40] + bytes([extra[40] ^ 1]) +
               extra[41:]}[tail]
    for v in (port, ref):
        with open(v.file_name() + ".dat", "ab") as f:
            f.write(extra + garbage)       # one whole unindexed record
    port = volume_mod.Volume(str(tmp_path / "p"), "col", 9)
    ref = ref_volume.Volume(str(tmp_path / "r"), "col", 9)
    _files_equal(port, ref)
    assert port.read_needle(77).data == ref.read_needle(77).data
    assert port.last_append_at_ns == ref.last_append_at_ns == T0 + 999
    port.close()
    ref.close()


def test_volume_raw_segments(tmp_path, pinned_clock):
    """A record stream copied out of one volume applies to another the
    same way; a segment ending mid-record is cut and raises."""
    port, ref = _pair(tmp_path, "memory")
    for v, mod in ((port, ndl), (ref, ref_ndl)):
        _write_sequence(mod, v, 13)
    seg = port.read_segment(port.super_block.block_size, 1 << 30)
    assert seg == ref.read_segment(ref.super_block.block_size, 1 << 30)
    for root, vmod in ((tmp_path / "p2", volume_mod),
                       (tmp_path / "r2", ref_volume)):
        root.mkdir()
        dst = vmod.Volume(str(root), "col", 9, create=True)
        assert dst.append_raw_segment(seg) == 74   # 60 + 8 + 6 records
        with pytest.raises(IOError, match="mid-record"):
            dst.append_raw_segment(seg[:100])
        dst.close()
    for ext in (".dat", ".idx"):
        assert _read(str(tmp_path / "p2" / "col_9") + ext) == \
            _read(str(tmp_path / "r2" / "col_9") + ext)
    port.close()
    ref.close()


def test_volume_read_only_and_destroy(tmp_path, pinned_clock):
    port, ref = _pair(tmp_path, "btree", collection="")
    port.read_only = True
    with pytest.raises(PermissionError):
        port.append_needle(ndl.Needle(id=1, data=b"x"))
    with pytest.raises(PermissionError):
        port.delete_needle(1)
    port.destroy()
    ref.destroy()
    assert os.listdir(tmp_path / "p") == os.listdir(tmp_path / "r") == []


def test_volume_refuses_a_tiered_dat(tmp_path):
    """A .vif naming a remote .dat on a backend storage this process has
    not configured: both packages refuse to open the volume with the
    same KeyError. (Since the remote tier was ported, a configured one
    opens read-only through ranged GETs: tests/test_torch_remote_tier.py.)"""
    from seaweedfs_tpu.storage import volume as ref_volume
    from seaweedfs_tpu_torch.storage import volume_info as vinfo

    vinfo.save_volume_info(str(tmp_path / "4.vif"), vinfo.VolumeInfo(
        files=[vinfo.RemoteFile(backend_id="nosuchtier", key="k",
                                file_size=8)]))
    errs = []
    for mod in (ref_volume, volume_mod):
        with pytest.raises(KeyError, match="not configured") as ei:
            mod.Volume(str(tmp_path), "", 4)
        errs.append(str(ei.value).split("; known")[0])
    assert errs[1] == errs[0]
    assert os.listdir(tmp_path) == ["4.vif"]


# -- workload sketches -------------------------------------------------------

def test_sketches_match_reference():
    rng = np.random.default_rng(17)
    vals = np.concatenate([rng.lognormal(0, 3, 3000), [0.0, -1.0, 1e-12]])
    port, ref = sketch.QuantileSketch(), ref_sketch.QuantileSketch()
    small, ref_small = (sketch.QuantileSketch(max_buckets=8),
                        ref_sketch.QuantileSketch(max_buckets=8))
    for v in vals:
        for s in (port, ref, small, ref_small):
            s.record(float(v))
    qs = (0, 0.01, 0.5, 0.9, 0.99, 1)
    assert port.to_dict() == ref.to_dict()
    assert port.quantiles(qs) == ref.quantiles(qs)
    assert small.to_dict() == ref_small.to_dict()
    assert port.summary() == ref.summary()
    assert port.fraction_below(2.0) == ref.fraction_below(2.0)
    back = sketch.QuantileSketch.from_dict(ref.to_dict())
    assert back.to_dict() == ref.to_dict()
    assert port.merge(small).to_dict() == ref.merge(ref_small).to_dict()
    w, rw = sketch.WindowedSketch(window=60), ref_sketch.WindowedSketch(
        window=60)
    for i, v in enumerate(vals[:500]):
        w.record(float(v), 1000.0 + i * 0.3)
        rw.record(float(v), 1000.0 + i * 0.3)
    for now in (1000.0, 1100.0, 1150.0, 1500.0):
        assert w.to_dict(now) == rw.to_dict(now)
    with pytest.raises(ValueError):
        sketch.QuantileSketch(alpha=1.5)
    assert (sketch.enabled(), sketch.alpha(), sketch.window()) == \
        (ref_sketch.enabled(), ref_sketch.alpha(), ref_sketch.window())


# -- 5-byte offsets -----------------------------------------------------------

def test_five_byte_offsets():
    """WEED_5BYTES_OFFSET=1 (17-byte .idx entries) is process-wide, as in
    tests/test_offset_5bytes.py: rerun this file's map and volume tests,
    the EC-volume tests and the Store lifecycle (native codec) in a
    subprocess with it set."""
    env = dict(os.environ, WEED_5BYTES_OFFSET="1", PYTHONPATH=REPO,
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c",
         "from seaweedfs_tpu_torch.storage import types as t; "
         "from seaweedfs_tpu.storage import types as r; "
         "assert t.OFFSET_SIZE == r.OFFSET_SIZE == 5; "
         "assert t.NEEDLE_MAP_ENTRY_SIZE == 17; print('5-byte')"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "5-byte" in out.stdout, out.stderr
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-x", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-k", "volume or needle_maps or ec_volume "
         "or locate or (lifecycle and native)", "tests/test_torch_storage.py",
         "tests/test_torch_ec_volume.py", "tests/test_torch_store.py"],
        env=env, capture_output=True, text=True, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    assert " passed" in out.stdout and " failed" not in out.stdout


def test_volume_load_raises_when_the_crc_library_fails(tmp_path,
                                                       monkeypatch):
    """The reference's CRC cannot fail; the port's comes from a library
    built at first use. A build that fails must raise on load, not read
    as a torn tail that check_integrity cuts off."""
    v = volume_mod.Volume(str(tmp_path), "", 2, create=True)
    for i in range(1, 6):
        v.append_needle(ndl.Needle(id=i, data=b"d" * 100 * i))
    v.close()
    # the last record unindexed, as after a crash between the .dat and
    # the .idx append: the integrity walk must CRC-check it
    idx = str(tmp_path / "2.idx")
    os.truncate(idx, os.path.getsize(idx) - t.NEEDLE_MAP_ENTRY_SIZE)
    before = _read(str(tmp_path / "2.dat"))

    def broken():
        raise RuntimeError("native codec build failed (g++ exit 1)")

    monkeypatch.setattr(native, "load", broken)
    with pytest.raises(RuntimeError, match="build failed"):
        volume_mod.Volume(str(tmp_path), "", 2)
    assert _read(str(tmp_path / "2.dat")) == before
