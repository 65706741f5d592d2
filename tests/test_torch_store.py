"""The Store of the torch port against the JAX package's, byte for byte
(tolerance 0). The EC lifecycle — write needles, seal, generate shards
and .ecx, mount, drop the volume, read every needle, journal deletes,
lose three shards, read again through the degraded-read ladder, rebuild,
remount, read a last time — for RS(10,4), RS(28,4) and lrc-10.2.2: the
port under CudaCodec(device="cpu") (the kernel's plain version) and
"native", the reference under "numpy", with both packages' clocks
pinned. Shards, .ecx, .ecj, every needle read and the heartbeat must be
equal. Then the ladder itself with fake fetchers (as
tests/test_ec_degraded_parallel.py), rank-not-count shard collection for
an LRC, the CPU-codec routing of interval reads, and the device
backends raising without a GPU instead of running elsewhere."""
import hashlib
import os
import types as pytypes

import numpy as np
import pytest
import torch

from seaweedfs_tpu.storage import needle as ref_ndl
from seaweedfs_tpu.storage import store as ref_store
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu_torch.ec import backend as ecb
from seaweedfs_tpu_torch.ec import encoder, probe
from seaweedfs_tpu_torch.ec import geometry as geo
from seaweedfs_tpu_torch.ops import codec_cuda
from seaweedfs_tpu_torch.storage import needle as ndl
from seaweedfs_tpu_torch.storage import store as store_mod
from seaweedfs_tpu_torch.storage import volume as volume_mod

T0 = 1_760_000_000_123_456_789
VID = 6
DAT_TARGET = 6_800_000     # > 6 MiB: needle data on shards 0-6


@pytest.fixture()
def pinned_clock(monkeypatch):
    clock = pytypes.SimpleNamespace(time_ns=lambda: T0,
                                    time=lambda: T0 / 1e9)
    for mod in (ref_volume, volume_mod, ref_store, store_mod):
        monkeypatch.setattr(mod, "time", clock)


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _needles(seed: int):
    """Seeded needles, log-uniform 1 KiB - 256 KiB, until DAT_TARGET
    bytes; some carry a name, mime, pairs and last_modified."""
    rng = np.random.default_rng(seed)
    total, out = 0, []
    while total < DAT_TARGET:
        size = int(np.exp(rng.uniform(np.log(1 << 10), np.log(256 << 10))))
        kw = dict(id=int(rng.integers(1, 1 << 40)),
                  cookie=int(rng.integers(0, 1 << 32)), data=rng.bytes(size))
        if len(out) % 7 == 0:
            kw.update(name=b"n%d" % len(out), mime=b"image/png",
                      pairs=b'{"a":1}', last_modified=1700000000)
        out.append(kw)
        total += size
    return out, rng


def _read_all(store, keys) -> list:
    out = []
    for key in keys:
        try:
            n = store.read_needle(VID, key)
        except KeyError:
            out.append(("gone", key))
            continue
        out.append((key, n.cookie, bytes(n.data), bytes(n.name),
                    bytes(n.mime), bytes(n.pairs), n.last_modified,
                    n.append_at_ns))
    return out


def _lifecycle(Store, Needle, root: str, backend, codec: str,
               lost: list[int]) -> dict:
    """One Store's whole EC lifecycle -> everything it wrote and read."""
    res = {}
    store = Store([root], ec_backend=backend)
    recon = []
    real = store._reconstruct_interval

    def counted(ecv, sid, off, size):
        recon.append(sid)
        return real(ecv, sid, off, size)

    store._reconstruct_interval = counted
    store.add_volume(VID, collection="c", replication="001")
    needles, rng = _needles(41)
    for kw in needles:
        store.write_needle(VID, Needle(**kw))
    keys = [kw["id"] for kw in needles]
    for key in rng.choice(keys, len(keys) // 20, replace=False):
        store.write_needle(VID, Needle(id=int(key), cookie=5,
                                       data=rng.bytes(3000)))
    dead = rng.choice(keys, max(1, len(keys) // 50), replace=False)
    for key in dead:
        store.delete_needle(VID, int(key))
    res["needles"] = len(keys)
    res["dead"] = sorted(int(d) for d in set(dead))
    base = os.path.join(root, f"c_{VID}")
    res["dat"] = _digest(base + ".dat")
    with pytest.raises(PermissionError):
        store.mark_readonly(VID)
        store.write_needle(VID, Needle(id=1, data=b"x"))
    store.generate_ec_shards(VID, codec=codec)
    total = geo.parse_code(codec).total
    store.mount_ec_shards(VID, "c", range(total))
    res["shards"] = [_digest(base + geo.shard_ext(i)) for i in range(total)]
    res["ecx"] = _digest(base + ".ecx")
    res["hb_mounted"] = store.collect_heartbeat()
    store.delete_volume(VID)
    res["read1"] = _read_all(store, keys)
    res["recon1"] = len(recon)
    more = [k for k in keys if k not in set(int(d) for d in dead)][::97]
    for key in more:
        assert store.delete_needle(VID, key) == 0
    res["ecj"] = _digest(base + ".ecj")
    res["gone"] = _read_all(store, more)
    store.delete_ec_shards(VID, lost)
    res["left"] = sorted(os.listdir(root))
    res["read2"] = _read_all(store, keys)
    res["recon2"] = len(recon) - res["recon1"]
    res["recon2_sids"] = sorted(set(recon))
    res["rebuilt"] = store.rebuild_ec_shards(VID)
    # rebuilt files are not mounted yet: reads still reconstruct
    before = len(recon)
    res["read3"] = _read_all(store, keys[:40])
    res["recon3"] = len(recon) - before
    store.mount_ec_shards(VID, "c", lost)
    res["rebuilt_shards"] = [_digest(base + geo.shard_ext(i))
                             for i in range(total)]
    before = len(recon)
    res["read4"] = _read_all(store, keys)
    res["recon4"] = len(recon) - before
    res["ids"] = store.needle_ids(VID)
    res["hb"] = store.collect_heartbeat()
    store.close()
    # a restarted Store finds the shard set and mounts it
    again = Store([root], ec_backend=backend)
    res["restart"] = (sorted(again.ec_volumes),
                      again.ec_volumes[VID].shard_bits().bits,
                      _read_all(again, keys[:10]))
    again.close()
    return res


CODES = [("", [0, 5, 11]), ("28.4", [0, 5, 30]), ("lrc-10.2.2", [0, 5, 11])]


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The JAX package's lifecycle per code (numpy codec), run once."""
    out = {}
    clock = pytypes.SimpleNamespace(time_ns=lambda: T0,
                                    time=lambda: T0 / 1e9)
    saved = ref_volume.time, ref_store.time
    ref_volume.time = ref_store.time = clock
    try:
        for codec, lost in CODES:
            root = str(tmp_path_factory.mktemp("ref"))
            out[codec] = _lifecycle(ref_store.Store, ref_ndl.Needle, root,
                                    "numpy", codec, lost)
    finally:
        ref_volume.time, ref_store.time = saved
    return out


@pytest.mark.parametrize("port_backend", ["cuda-plain", "native"])
@pytest.mark.parametrize("codec,lost", CODES)
def test_store_ec_lifecycle_matches_reference(tmp_path, pinned_clock,
                                              reference_runs, codec, lost,
                                              port_backend):
    backend = port_backend
    device_calls = []
    if port_backend == "cuda-plain":
        backend = codec_cuda.CudaCodec(slab=1 << 19, device="cpu")
        real = backend._kernel

        def counted(mats, x, out=None):
            device_calls.append(tuple(x.shape))
            return real(mats, x, out)

        backend._kernel = counted
    got = _lifecycle(store_mod.Store, ndl.Needle, str(tmp_path), backend,
                     codec, lost)
    want = reference_runs[codec]
    for key in want:
        assert got[key] == want[key], key
    k = geo.parse_code(codec).k
    # the volume spans shards 0-6: lost data shards 0 and 5 hold needle
    # bytes, so the ladder reconstructed intervals of exactly those
    assert got["recon1"] == 0 and got["recon2"] > 0 and got["recon3"] > 0
    assert got["recon2_sids"] == [0, 5] and got["recon4"] == 0
    assert got["rebuilt"] == lost
    assert got["rebuilt_shards"] == got["shards"]
    # ids deleted before sealing and through the .ecj raise KeyError
    assert [r[1] for r in got["read1"] if r[0] == "gone"] == \
        [k for k in [r[1] for r in got["read1"]] if k in got["dead"]] and \
        {r[1] for r in got["read1"] if r[0] == "gone"} == set(got["dead"])
    assert all(r[0] == "gone" for r in got["gone"]) and got["gone"]
    if port_backend == "cuda-plain":
        # generate and rebuild ran the device codec's kernel path (the
        # interval reconstructions did not: see the next test)
        assert device_calls and all(shape[0] <= k
                                    for shape in device_calls)
    assert [ec["codec"] for ec in got["hb"]["ec_shards"]] == [codec]


def test_interval_reads_use_the_cpu_codec(tmp_path, monkeypatch):
    """A degraded single-interval read builds its ReedSolomon on
    cpu_backend_name(), whatever ec_backend is, and never touches the
    device codec."""
    codec = codec_cuda.CudaCodec(device="cpu")
    calls = []
    real = codec._kernel
    codec._kernel = lambda mats, x, out=None: (calls.append(1),
                                               real(mats, x, out))[1]
    store = store_mod.Store([str(tmp_path)], ec_backend=codec)
    store.add_volume(1)
    rng = np.random.default_rng(3)
    for i in range(1, 40):
        store.write_needle(1, ndl.Needle(id=i, data=rng.bytes(2000)))
    store.generate_ec_shards(1)
    n_encode = len(calls)
    assert n_encode > 0
    store.mount_ec_shards(1, "", range(14))
    store.delete_volume(1)
    store.delete_ec_shards(1, [0])
    assert store.read_needle(1, 7).id == 7
    assert len(calls) == n_encode
    assert set(store._rs_cache) == {("10.4", ecb.cpu_backend_name())}
    rs = store._rs_for(store.ec_volumes[1], interval=True)
    assert rs.backend.name == "native"
    assert store._rs_for(store.ec_volumes[1]) is store._rs
    store.close()


# -- the ladder with fake fetchers -------------------------------------------

def _make_ec_store(tmp_path, Store, n_local=4, codec=""):
    """A Store holding shards [0, n_local) of a volume of one stripe row
    of seeded bytes (raw intervals are enough for the ladder), plus the
    golden bytes of every shard."""
    rng = np.random.default_rng(5)
    k = geo.parse_code(codec).k
    (tmp_path / "77.dat").write_bytes(rng.bytes(geo.SMALL_BLOCK * k))
    (tmp_path / "77.idx").write_bytes(b"")
    encoder.write_ec_files(str(tmp_path / "77"), backend="numpy",
                           codec=codec)
    encoder.write_sorted_ecx(str(tmp_path / "77"))
    total = geo.parse_code(codec).total
    shards = {i: (tmp_path / ("77" + geo.shard_ext(i))).read_bytes()
              for i in range(total)}
    for i in range(total):
        if i >= n_local:
            (tmp_path / ("77" + geo.shard_ext(i))).unlink()
    store = Store([str(tmp_path)])
    assert 77 in store.ec_volumes
    return store, shards


STORES = {"port": store_mod.Store, "ref": ref_store.Store}


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_reconstruct_uses_fanout_fetcher(tmp_path, pkg):
    store, shards = _make_ec_store(tmp_path, STORES[pkg], n_local=4)
    calls = []

    def fetcher(vid, sids, offset, size, need, deadline):
        calls.append((vid, tuple(sids), need, deadline))
        return {sid: shards[sid][offset:offset + size]
                for sid in sids[:need]}

    store.remote_shards_fetcher = fetcher
    ecv = store.ec_volumes[77]
    assert store._reconstruct_interval(ecv, 12, 100, 5000) == \
        shards[12][100:5100]
    vid, sids, need, deadline = calls[0]
    assert vid == 77 and need == geo.DATA_SHARDS - 4
    assert 12 not in sids and all(s >= 4 for s in sids)
    assert deadline == store.ec_read_deadline
    # the ladder's first hop: the owning shard alone, on a slice of the
    # deadline; it answers, so nothing is reconstructed
    calls.clear()
    iv = geo.Interval(7, 10, 300, False, 0)
    assert store._read_interval(ecv, iv) == shards[7][10:310]
    assert calls == [(77, (7,), 1, min(2.0, store.ec_read_deadline * 0.25))]
    store.close()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_reconstruct_fails_cleanly_when_short(tmp_path, pkg):
    store, _ = _make_ec_store(tmp_path, STORES[pkg], n_local=4)
    store.remote_shards_fetcher = \
        lambda vid, sids, off, size, need, dl: {}  # all peers dark
    with pytest.raises(IOError, match="only 4 shards reachable"):
        store._reconstruct_interval(store.ec_volumes[77], 12, 0, 100)
    store.close()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_serial_reader_ladder(tmp_path, pkg):
    """Without a fan-out fetcher the legacy serial reader is asked shard
    by shard, each once; a None from the owner means reconstruct."""
    store, shards = _make_ec_store(tmp_path, STORES[pkg], n_local=6)
    asked = []

    def reader(vid, sid, offset, size):
        asked.append(sid)
        if sid in (8, 9):
            return None                      # dark peers
        return shards[sid][offset:offset + size]

    store.remote_shard_reader = reader
    ecv = store.ec_volumes[77]
    iv = geo.Interval(9, 0, 4000, False, 0)
    assert store._read_interval(ecv, iv) == shards[9][:4000]
    assert asked == [9, 6, 7, 8, 10, 11]     # owner, then the serial walk
    store.close()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_lrc_collects_to_rank_not_count(tmp_path, pkg):
    """lrc-10.2.2 with the whole first locality group local (data 0-4 and
    its XOR parity 10) plus 5-7: nine local shards but rank 8, since
    parity 10 rides with its full group. Healing global parity 13 must
    ask the fetcher for two more shards, not one."""
    store, shards = _make_ec_store(tmp_path, STORES[pkg], n_local=14,
                                   codec="lrc-10.2.2")
    ecv = store.ec_volumes[77]
    for sid in (8, 9, 11, 12, 13):
        ecv.unmount_shard(sid)
    calls = []

    def fetcher(vid, sids, offset, size, need, deadline):
        calls.append((tuple(sids), need))
        return {sid: shards[sid][offset:offset + size]
                for sid in sids[:need]}

    store.remote_shards_fetcher = fetcher
    assert store._reconstruct_interval(ecv, 13, 64, 3000) == \
        shards[13][64:3064]
    assert calls == [((8, 9, 11, 12), 2)]
    # a data shard inside a complete local group heals from the group
    # alone (the repair plan): no fetch at all
    calls.clear()
    assert store._reconstruct_interval(ecv, 3, 0, 2000) == shards[3][:2000]
    assert calls == []
    # with the group's parity remote, the plan fetches exactly it
    ecv.unmount_shard(10)
    assert store._reconstruct_interval(ecv, 3, 0, 2000) == shards[3][:2000]
    assert calls == [((10,), 1)]
    store.close()


# -- volume management and needle IO -----------------------------------------

def test_store_volume_management(tmp_path, pinned_clock):
    out = {}
    for pkg in ("port", "ref"):
        root = tmp_path / pkg
        root.mkdir()
        Needle = ndl.Needle if pkg == "port" else ref_ndl.Needle
        st = STORES[pkg]([str(root)], ec_backend="numpy",
                         needle_map_kind="compact")
        st.add_volume(1)
        st.add_volume(2, collection="x", replication="010",
                      ttl=b"\x03\x01")
        with pytest.raises(FileExistsError):
            st.add_volume(1)
        rng = np.random.default_rng(8)
        res = [st.write_needle(1, Needle(id=i, cookie=i,
                                         data=rng.bytes(100 * i)))
               for i in range(1, 30)]
        res.append(st.delete_needle(1, 4))
        blob = st.read_raw_needle(1, 9)
        res.append(st.append_raw_needle(2, blob))
        res.append(st.append_raw_needle(2, blob))          # already live
        res.append(st.append_raw_needle(2, blob, force=True))
        res.append(st.needle_size(1, 9))
        res.append(st.needle_size(3, 9))
        res.append(st.needle_ids(1))
        with pytest.raises(PermissionError):
            st.read_needle(1, 9, cookie=8)
        with pytest.raises(KeyError):
            st.read_needle(1, 4)
        res.append(bytes(st.read_needle(1, 4, read_deleted=True).data))
        st.unmount_volume(2)
        res.append(st.has_volume(2))
        st.mount_volume(2)
        res.append(bytes(st.read_needle(2, 9).data))
        with pytest.raises(KeyError):
            st.mount_volume(5)
        res.append(st.volume_heat(1))
        res.append(st.collect_heartbeat())
        st.close()
        for name in sorted(os.listdir(root)):
            with open(root / name, "rb") as f:
                res.append((name, hashlib.sha256(f.read()).hexdigest()))
        out[pkg] = res
    assert out["port"] == out["ref"]


def test_auto_store_builds_lazily_and_raises_without_a_gpu(tmp_path,
                                                           monkeypatch):
    """Store(ec_backend="auto") constructs ReedSolomon(10, 4) eagerly, as
    the reference does, but that must not sweep: the router measures
    (or raises, with no GPU) on first use."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_PROBE_CACHE",
                       str(tmp_path / "probe.json"))
    monkeypatch.delenv("SEAWEEDFS_TPU_EC_BACKEND", raising=False)
    monkeypatch.setattr(probe, "_curves", {})
    monkeypatch.setattr(ecb, "_auto_choice", None)
    swept = []
    real_sweep = probe.run_sweep
    monkeypatch.setattr(probe, "run_sweep",
                        lambda *a, **kw: (swept.append(1),
                                          real_sweep(*a, **kw))[1])
    auto = ecb.AutoCodec()
    monkeypatch.setitem(ecb._instances, "auto", auto)
    store = store_mod.Store([str(tmp_path)])
    assert store.ec_backend == "auto" and store._rs.backend is auto
    assert swept == [] and auto.chosen is None
    store.add_volume(1)
    store.write_needle(1, ndl.Needle(id=1, data=b"payload"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        store.generate_ec_shards(1)
    assert swept == [1]
    assert not os.path.exists(os.path.join(str(tmp_path), "1.ec00"))
    store.close()


def test_cuda_store_raises_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delitem(ecb._instances, "cuda", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        store_mod.Store([str(tmp_path)], ec_backend="cuda")
    assert "cuda" not in ecb._instances
