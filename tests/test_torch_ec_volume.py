"""The mounted EC volume of the torch port against the JAX package's,
byte for byte (tolerance 0): geometry.locate / Interval over boundary
sizes (the large->small row switch, shard boundaries, an exact multiple
of the large block), EcVolume.derived_dat_size over sparse shard files
of odd sizes, ShardBits, the .ecx search, needle intervals and local
interval reads on a real volume encoded by each package, the .ecj
journal, and DiskLocation's file-name parsing and shard bookkeeping."""
import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec import geometry as ref_geo
from seaweedfs_tpu.ec import volume as ref_ecvol
from seaweedfs_tpu.storage import disk_location as ref_dl
from seaweedfs_tpu.storage import volume_info as ref_vinfo
from seaweedfs_tpu_torch.ec import encoder
from seaweedfs_tpu_torch.ec import geometry as geo
from seaweedfs_tpu_torch.ec import volume as ecvol
from seaweedfs_tpu_torch.storage import disk_location as dl
from seaweedfs_tpu_torch.storage import needle as ndl
from seaweedfs_tpu_torch.storage import volume_info as port_vinfo
from seaweedfs_tpu_torch.storage.volume import Volume

LB, SB = 4096, 512
GB, MB = geo.LARGE_BLOCK, geo.SMALL_BLOCK


def _ivs(intervals, lb: int = LB, sb: int = SB) -> list:
    return [(iv.block_index, iv.inner_offset, iv.size, iv.is_large_block,
             iv.large_block_rows, iv.data_shards, iv.to_shard_and_offset(
                 lb, sb)) for iv in intervals]


def _dat_sizes(k: int) -> list:
    row, small = k * LB, k * SB
    out = [1, small - 1, small, small + 1, row - 1, row, row + 1,
           row + small - 1, row + small, row + small + 1, 2 * row,
           2 * row + 1, 3 * row - small, 3 * row + 7 * SB + 3]
    return sorted(set(out))


@pytest.mark.parametrize("k", [10, 28])
@pytest.mark.parametrize("which", range(14))
def test_locate_matches_reference(k, which):
    dat_size = _dat_sizes(k)[which]
    n_large, _ = geo.row_layout(dat_size, LB, SB, k)
    rng = np.random.default_rng(dat_size)
    spans = [(0, 1), (0, dat_size)]
    # ranges across the large->small switch and across block edges
    edge = n_large * k * LB
    for at in (edge, LB, SB, 2 * LB, edge + SB, edge + 3 * SB):
        for before in (1, 7, SB + 3):
            if 0 <= at - before < dat_size:
                spans.append((at - before, min(2 * before + 1,
                                               dat_size - at + before)))
    for _ in range(20):
        off = int(rng.integers(0, dat_size))
        spans.append((off, int(rng.integers(1, dat_size - off + 1))))
    for off, size in spans:
        got = geo.locate(dat_size, off, size, LB, SB, data_shards=k)
        want = ref_geo.locate(dat_size, off, size, LB, SB, data_shards=k)
        assert _ivs(got) == _ivs(want), (off, size)
        assert sum(iv.size for iv in got) == size
        # a run never crosses a block: each interval sits in one shard
        for iv in got:
            block = LB if iv.is_large_block else SB
            assert iv.inner_offset + iv.size <= block


@pytest.mark.parametrize("dat_size,off,size", [
    ((1 << 30) * 10 + 5, (1 << 30) * 10 - 3, 10),     # across the switch
    ((1 << 30) * 20, (1 << 30) * 10 - 3, 10),          # exact 2 rows
    ((1 << 30) * 20 + 1, (1 << 30) * 20 - 2, 3),
    (1 << 30, (1 << 20) * 3 - 1, 2),                   # shard 2 -> 3
])
def test_locate_at_real_block_sizes(dat_size, off, size):
    got = geo.locate(dat_size, off, size)
    want = ref_geo.locate(dat_size, off, size)
    assert _ivs(got, GB, MB) == _ivs(want, GB, MB)
    assert len(got) == 2     # each range straddles one boundary


def _sparse_shard(root, name: str, size: int) -> None:
    with open(os.path.join(root, name), "wb") as f:
        f.truncate(size)


@pytest.mark.parametrize("shard_size", [
    MB, 2 * MB, 1024 * MB - MB, GB, GB + MB, GB + 1023 * MB, 2 * GB,
    2 * GB + MB, 3 * GB - MB])
@pytest.mark.parametrize("codec", ["", "28.4"])
def test_derived_dat_size(tmp_path, shard_size, codec):
    """An exact multiple of the large block is (n_large - 1) large rows
    plus 1024 small rows; row_layout of the derived size gives back the
    shard size."""
    roots = []
    for pkg, vinfo in (("p", port_vinfo), ("r", ref_vinfo)):
        root = tmp_path / pkg
        root.mkdir()
        roots.append(str(root))
        _sparse_shard(str(root), "5" + geo.shard_ext(3), shard_size)
        if codec:
            vinfo.save_volume_info(str(root / "5.vif"),
                                   vinfo.VolumeInfo(ec_codec=codec))
    port = ecvol.EcVolume(roots[0], "", 5)
    ref = ref_ecvol.EcVolume(roots[1], "", 5)
    with pytest.raises(RuntimeError):
        port.derived_dat_size()
    port.mount_shard(3)
    ref.mount_shard(3)
    derived = port.derived_dat_size()
    assert derived == ref.derived_dat_size()
    k = port.k
    assert geo.shard_file_size(derived, data_shards=k) == shard_size
    n_large, n_small = geo.row_layout(derived, data_shards=k)
    assert 1 <= n_small <= 1024
    if shard_size % GB == 0:
        assert (n_large, n_small) == (shard_size // GB - 1, 1024)
    port.close()
    ref.close()


def test_shard_bits():
    p, r = ecvol.ShardBits(), ref_ecvol.ShardBits()
    for ids in ((0, 5, 13), (31,), (2, 3)):
        p.add(*ids)
        r.add(*ids)
    p.remove(5, 2)
    r.remove(5, 2)
    assert p.bits == r.bits and p.ids() == r.ids() == [0, 3, 13, 31]
    assert p.count() == 4 and p.has(31) and not p.has(5)
    assert p == ecvol.ShardBits(p.bits) and repr(p) == repr(r)


@pytest.fixture()
def encoded(tmp_path):
    """One real volume (collection "col", vid 3): 200 needles of up to
    60 KB (~6 MB, so needles span shards 0-5 and cross shard edges) with
    some overwritten and deleted, encoded by each package into its own
    directory at the real block sizes (the EC volume derives its layout
    from them)."""
    src = tmp_path / "src"
    src.mkdir()
    v = Volume(str(src), "col", 3, create=True)
    rng = np.random.default_rng(99)
    for i in range(200):
        v.append_needle(ndl.Needle(
            id=i + 1, cookie=int(rng.integers(0, 2**32)),
            data=rng.bytes(int(rng.integers(1, 60000)))))
    for key in (4, 9, 17, 100):
        v.append_needle(ndl.Needle(id=key, cookie=1, data=rng.bytes(33)))
    for key in (5, 50, 150):
        v.delete_needle(key)
    v.close()
    dirs = {}
    for pkg, enc in (("p", encoder), ("r", ref_encoder)):
        d = tmp_path / pkg
        shutil.copytree(src, d)
        base = str(d / "col_3")
        enc.write_ec_files(base, backend="numpy")
        enc.write_sorted_ecx(base)
        dirs[pkg] = str(d)
    return dirs


def _ecv(mod, d):
    ecv = mod.EcVolume(d, "col", 3)
    for sid in range(14):
        ecv.mount_shard(sid)
    return ecv


def test_ec_volume_lookup_and_reads(encoded):
    port, ref = _ecv(ecvol, encoded["p"]), _ecv(ref_ecvol, encoded["r"])
    assert port.base_name() == os.path.join(encoded["p"], "col_3")
    assert (port.k, port.m, port.total, port.codec) == \
        (ref.k, ref.m, ref.total, ref.codec) == (10, 4, 14, "")
    assert port.shard_bits().bits == ref.shard_bits().bits == (1 << 14) - 1
    assert port.live_needle_ids() == ref.live_needle_ids()
    assert len(port.live_needle_ids()) == 197
    crossed = 0
    for key in range(0, 203):
        try:
            want = ref.locate_needle(key)
        except KeyError:
            with pytest.raises(KeyError):
                port.locate_needle(key)
            continue
        assert port.locate_needle(key) == want
        # at the real block sizes, as the Store reads them
        ivs, size = port.needle_intervals(key)
        rivs, rsize = ref.needle_intervals(key)
        assert (_ivs(ivs, GB, MB), size) == (_ivs(rivs, GB, MB), rsize)
        crossed += len(ivs) > 1
        blob = b"".join(port.read_interval_local(iv) for iv in ivs)
        assert blob == b"".join(ref.read_interval_local(iv) for iv in rivs)
        n = ndl.Needle.from_bytes(blob)
        assert n.id == key and n.size == size
    assert crossed >= 3     # needles across a shard edge
    on_0 = next(iv for key, _ in port.live_needle_ids()
                 for iv in port.needle_intervals(key)[0]
                 if iv.to_shard_and_offset()[0] == 0)
    port.unmount_shard(0)
    assert port.read_interval_local(on_0) is None
    assert 0 not in port.shards and port.shard_bits().count() == 13
    port.close()
    ref.close()


def test_ec_volume_deletion_journal(encoded):
    port, ref = _ecv(ecvol, encoded["p"]), _ecv(ref_ecvol, encoded["r"])
    for key in (7, 7, 2**40 + 1, 120):
        port.delete_needle(key)
        ref.delete_needle(key)
    with open(port.base_name() + ".ecj", "rb") as a, \
            open(ref.base_name() + ".ecj", "rb") as b:
        assert a.read() == b.read()
    assert port.deleted == ref.deleted == {7, 2**40 + 1, 120}
    for ecv in (port, ref):
        with pytest.raises(KeyError, match="deleted"):
            ecv.locate_needle(7)
    assert port.live_needle_ids() == ref.live_needle_ids()
    port.close()
    # a reopened volume reads its journal back
    again = ecvol.EcVolume(encoded["p"], "col", 3)
    assert again.deleted == {7, 2**40 + 1, 120}
    again.close()
    ref.close()


def test_remote_ec_shard_surface():
    calls = []
    shard = ecvol.RemoteEcShard("c", 1, 4, "key", 100,
                                lambda k, o, n: calls.append((k, o, n))
                                or b"x" * n)
    assert shard.remote and shard.read_at(5, 3) == b"xxx"
    assert calls == [("key", 5, 3)]
    shard.close()
    assert not ecvol.EcVolumeShard.remote


@pytest.mark.parametrize("name", [
    "1.dat", "col_12.dat", "a_b_7.dat", "3.vif", "x.dat", "5.ec00",
    "col_5.ec13", "col_5.ec31", "5.ec1", "5.ecx", "5.idx", "_4.dat",
    "my-col_44.ec07"])
def test_file_name_parsing(name):
    assert dl.parse_volume_filename(name) == \
        ref_dl.parse_volume_filename(name)
    assert dl.parse_ec_filename(name) == ref_dl.parse_ec_filename(name)


def test_disk_location_load_and_shard_removal(encoded, tmp_path):
    for pkg, mod in (("p", dl), ("r", ref_dl)):
        d = encoded[pkg]
        shutil.copy(os.path.join(d, "col_3.dat"),
                    os.path.join(d, "col_8.dat"))
        shutil.copy(os.path.join(d, "col_3.idx"),
                    os.path.join(d, "col_8.idx"))
        os.remove(os.path.join(d, "col_3.dat"))
        os.remove(os.path.join(d, "col_3.idx"))
    port, ref = dl.DiskLocation(encoded["p"]), ref_dl.DiskLocation(
        encoded["r"])
    port.load_existing()
    ref.load_existing()
    assert sorted(port.volumes) == sorted(ref.volumes) == [8]
    assert port.load_errors == ref.load_errors == []
    assert {v: (e.collection, sorted(e.shard_ids))
            for v, e in port.ec_shards.items()} == \
        {v: (e.collection, sorted(e.shard_ids))
         for v, e in ref.ec_shards.items()} == {3: ("col", list(range(14)))}
    assert port.volume_count == 1 and port.free_space_bytes() > 0
    assert port.volumes[8].read_needle(1).data == \
        ref.volumes[8].read_needle(1).data
    for loc in (port, ref):
        loc.remove_ec_shards(3, {0, 5})
    assert sorted(os.listdir(encoded["p"])) == sorted(os.listdir(encoded["r"]))
    for loc in (port, ref):
        loc.remove_ec_shards(3)
    # the last shard takes the .ecx (and .ecj, .vif) with it
    assert sorted(os.listdir(encoded["p"])) == \
        sorted(os.listdir(encoded["r"])) == ["col_8.dat", "col_8.idx"]
    assert port.try_load_volume(8) and not port.try_load_volume(9)
    with pytest.raises(FileExistsError):
        port.new_volume("col", 8)
    v = port.new_volume("", 11)
    assert v.file_name() == os.path.join(encoded["p"], "11")
    port.delete_volume(11)
    assert not os.path.exists(os.path.join(encoded["p"], "11.dat"))
    port.close()
    ref.close()
    assert port.volume_count == 0
