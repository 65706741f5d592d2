"""The port's filer model, chunk algebra, metadata stores and Filer
against the JAX package's (tolerance 0 on every byte).

* `Entry` / `FileChunk` JSON (what the stores keep and the wire
  carries) byte-equal to the reference's for seeded entries, and
  round-trips.
* `filechunks` against the reference with hypothesis: visible
  intervals, chunk views, compaction, ETags and manifests over seeded
  overlapping chunk lists.
* The cases of tests/test_filerstore_contract.py, tests/test_filer.py,
  tests/test_filechunks.py and test_filer_conf.py's rule matching, run
  unchanged on the port's MemoryStore, SqliteStore, Filer and FilerConf
  (tests/torch_port_cases.py rebinds their names); the two cases that
  import reference modules in their bodies have port twins here.
* The same mutations through both packages' Filer give the same store
  contents (timestamps masked) and the same event kinds.
"""
import json
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import seaweedfs_tpu.filer as ref
from seaweedfs_tpu.filer import filer_conf as ref_conf
from seaweedfs_tpu.utils import compression as ref_compression
from seaweedfs_tpu.utils import extheaders as ref_extheaders
import seaweedfs_tpu_torch.filer as port
from seaweedfs_tpu_torch.filer import filer as port_filer_mod
from seaweedfs_tpu_torch.filer import filer_conf as port_conf
from seaweedfs_tpu_torch.filer import filerstore as port_stores
from seaweedfs_tpu_torch.filer.entry import entry_size as port_entry_size
from seaweedfs_tpu.filer.entry import entry_size as ref_entry_size
from seaweedfs_tpu_torch.utils import compression, extheaders

from tests import test_filechunks as ref_chunk_cases
from tests import test_filer as ref_filer_cases
from tests import test_filer_conf as ref_conf_cases
from tests import test_filerstore_contract as ref_store_cases
from tests.torch_port_cases import call_case, port_cases

SEED = 20261017


def _seeded_entry_dict(rng, i: int) -> dict:
    chunks = []
    off = 0
    for j in range(int(rng.integers(0, 4))):
        size = int(rng.integers(1, 1 << 20))
        c = {"fid": f"{int(rng.integers(1, 50))},{int(rng.integers(1 << 40)):x}"
                    f"{int(rng.integers(1 << 32)):08x}",
             "offset": off, "size": size,
             "mtime_ns": int(rng.integers(1 << 62)),
             "etag": rng.bytes(16).hex()}
        if rng.random() < 0.3:
            c["is_compressed"] = True
        if rng.random() < 0.1:
            c["is_chunk_manifest"] = True
        chunks.append(c)
        off += size
    d = {"full_path": f"/buckets/b{i % 3}/dir/obj-{i}.bin",
         "mtime": float(rng.integers(1 << 31)) + 0.25,
         "crtime": float(rng.integers(1 << 31)) + 0.5,
         "mode": int(rng.choice([0o644, 0o660, 0o40755]))}
    if rng.random() < 0.5:
        d["mime"] = "application/json"
        d["md5"] = rng.bytes(16).hex()
    if rng.random() < 0.5:
        d["collection"] = f"b{i % 3}"
        d["ttl_sec"] = int(rng.integers(1, 3600))
    if chunks:
        d["chunks"] = chunks
    if rng.random() < 0.5:
        d["extended"] = {"s3_meta_k": f"v{i}", "s3_etag": "ab-2"}
    if rng.random() < 0.3:
        d["content"] = "aGVsbG8gd29ybGQ="
    return d


@pytest.mark.parametrize("i", range(8))
def test_entry_json_byte_equal_to_the_reference(i):
    rng = np.random.default_rng([SEED, i])
    d = _seeded_entry_dict(rng, i)
    pe, re_ = port.Entry.from_dict(d), ref.Entry.from_dict(d)
    assert json.dumps(pe.to_dict()) == json.dumps(re_.to_dict())
    assert port.Entry.from_dict(pe.to_dict()) == pe
    assert pe.file_size == re_.file_size
    assert pe.dir_and_name == re_.dir_and_name
    assert pe.is_directory == re_.is_directory
    assert port_entry_size(d) == ref_entry_size(d)
    for c in d.get("chunks", []):
        assert port.FileChunk.from_dict(c).to_dict() == \
            ref.FileChunk.from_dict(c).to_dict()


_chunk = st.tuples(st.integers(0, 5000), st.integers(1, 3000),
                   st.integers(0, 50), st.binary(min_size=16, max_size=16))


def _both(chunks):
    out_p, out_r = [], []
    for i, (off, size, ts, md5) in enumerate(chunks):
        kw = dict(fid=f"{i + 1},{i:x}ab", offset=off, size=size,
                  mtime_ns=ts, etag=md5.hex())
        out_p.append(port.FileChunk(**kw))
        out_r.append(ref.FileChunk(**kw))
    return out_p, out_r


def _iv(xs):
    return [(v.start, v.stop, v.fid, v.mtime_ns, v.offset_in_chunk,
             v.chunk_size) for v in xs]


def _views(xs):
    return [(v.fid, v.offset_in_chunk, v.view_size, v.view_offset)
            for v in xs]


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.lists(_chunk, min_size=0, max_size=12),
       st.integers(0, 9000), st.integers(0, 9000))
def test_filechunks_against_the_reference(chunks, offset, size):
    p, r = _both(chunks)
    assert _iv(port.non_overlapping_visible_intervals(p)) == \
        _iv(ref.non_overlapping_visible_intervals(r))
    assert _views(port.view_from_chunks(p, offset, size)) == \
        _views(ref.view_from_chunks(r, offset, size))
    assert _views(port.view_from_chunks(p)) == _views(ref.view_from_chunks(r))
    pc, pg = port.compact_file_chunks(p)
    rc, rg = ref.compact_file_chunks(r)
    assert [c.to_dict() for c in pc] == [c.to_dict() for c in rc]
    assert [c.to_dict() for c in pg] == [c.to_dict() for c in rg]
    assert port.etag_chunks(p) == ref.etag_chunks(r)
    assert port.total_size(p) == ref.total_size(r)


@pytest.mark.parametrize("n,batch", [(5, 2), (7, 7), (3, 10)])
def test_manifests_against_the_reference(n, batch):
    rng = np.random.default_rng([SEED, n, batch])
    chunks = [(int(i * 100), 100, int(rng.integers(1 << 40)), rng.bytes(16))
              for i in range(n)]
    p, r = _both(chunks)
    saved: dict[str, bytes] = {}

    def save(payload: bytes) -> str:
        fid = f"99,{len(saved):x}00"
        saved[fid] = payload
        return fid

    pm = port.maybe_manifestize(save, p, batch=batch)
    ref_saved = dict(saved)
    saved.clear()
    rm = ref.maybe_manifestize(save, r, batch=batch)
    assert saved == ref_saved
    assert [c.to_dict() for c in pm] == [c.to_dict() for c in rm]
    assert [c.to_dict() for c in port.resolve_chunk_manifest(
        saved.__getitem__, pm)] == [c.to_dict() for c in p]


@pytest.mark.parametrize("name,mime", [
    ("a.json", ""), ("x.txt", ""), ("x.bin", ""), ("y", "text/plain"),
    ("z.PY", ""), ("w", "application/json; charset=utf-8"), ("", "")])
def test_compression_policy_as_the_reference(name, mime):
    assert compression.is_compressible(mime, name) == \
        ref_compression.is_compressible(mime, name)
    rng = np.random.default_rng(SEED)
    for data in (b"", b"x" * 100, b'{"a": 1}' * 500, rng.bytes(4096)):
        assert compression.maybe_gzip(data) == \
            ref_compression.maybe_gzip(data)
    v = "café / 100% \r\n"
    assert extheaders.armor(v) == ref_extheaders.armor(v)
    assert extheaders.unarmor(extheaders.armor(v)) == v


# -- the reference's cases, run on the port ----------------------------
STORE_CASES = port_cases(ref_store_cases, Entry=port.Entry,
                         make_store=port.make_store)


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
@pytest.mark.parametrize("case", list(STORE_CASES))
def test_filerstore_contract_on_the_port(case, kind, tmp_path):
    store = port.make_store(kind, **({"path": str(tmp_path / "s.db")}
                                     if kind == "sqlite" else {}))
    try:
        call_case(STORE_CASES[case], {"store": store, "tmp_path": tmp_path})
    finally:
        store.close()


FILER_CASES = port_cases(
    ref_filer_cases, DIR_MODE_FLAG=port.DIR_MODE_FLAG, Entry=port.Entry,
    FileChunk=port.FileChunk, Filer=port.Filer, event_kind=port.event_kind,
    skip=("TestGatedStores.test_external_stores_registered_but_gated",
          "TestRegressions.test_rename_dir_with_expired_entry_keeps_all_children",
          "TestRegressions.test_sqlite_like_wildcards_literal"))


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
@pytest.mark.parametrize("case", list(FILER_CASES))
def test_filer_cases_on_the_port(case, kind, tmp_path):
    f = port.Filer(kind, **({"path": str(tmp_path / "filer.db")}
                            if kind == "sqlite" else {}))
    try:
        call_case(FILER_CASES[case], {"filer": f, "tmp_path": tmp_path})
    finally:
        f.close()


def _touch(f, path, size=0, fid="1,ab"):
    chunks = [port.FileChunk(fid=fid, offset=0, size=size,
                             mtime_ns=time.time_ns())] if size else []
    return f.create_entry(port.Entry(full_path=path, chunks=chunks))


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_rename_dir_with_expired_entry_keeps_all_children(kind, tmp_path,
                                                          monkeypatch):
    """Port twin of the reference case: a full store page holding one
    expired entry must not truncate iter_tree on rename."""
    monkeypatch.setattr(port_filer_mod, "LIST_BATCH", 4)
    f = port.Filer(kind, **({"path": str(tmp_path / "f.db")}
                            if kind == "sqlite" else {}))
    for i in range(8):
        _touch(f, f"/pg/f{i}", size=1)
    expired = port.Entry(full_path="/pg/f1", ttl_sec=1)
    expired.crtime = time.time() - 10
    f.store.insert_entry(expired)
    f.rename("/pg", "/pg2")
    assert sorted(e.name for e in f.iter_tree("/pg2")) == \
        [f"f{i}" for i in range(8) if i != 1]
    f.close()


def test_sqlite_like_wildcards_literal(tmp_path):
    f = port.Filer(port.SqliteStore(str(tmp_path / "w.db")))
    _touch(f, "/a_b/keep1")
    _touch(f, "/axb/keep2")
    _touch(f, "/pre/50%off")
    _touch(f, "/pre/500")
    f.delete_entry("/a_b", recursive=True)
    assert f.find_entry("/axb/keep2") is not None
    assert [e.name for e in f.list_entries("/pre", prefix="50%")] == \
        ["50%off"]
    f.close()


def test_the_port_registers_its_two_stores():
    assert sorted(port_stores.STORES) == ["memory", "sqlite"]
    with pytest.raises(KeyError, match="unknown filer store"):
        port.make_store("leveldb")


CHUNK_CASES = port_cases(
    ref_chunk_cases, Entry=port.Entry, FileChunk=port.FileChunk,
    compact_file_chunks=port.compact_file_chunks,
    etag_chunks=port.etag_chunks, maybe_manifestize=port.maybe_manifestize,
    non_overlapping_visible_intervals=port.non_overlapping_visible_intervals,
    resolve_chunk_manifest=port.resolve_chunk_manifest,
    total_size=port.total_size, view_from_chunks=port.view_from_chunks)


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_filechunks_cases_on_the_port(case):
    call_case(CHUNK_CASES[case], {})


CONF_CASES = {k: v for k, v in port_cases(
    ref_conf_cases, CONF_KEY=port_conf.CONF_KEY, FilerConf=port_conf.FilerConf,
    PathConf=port_conf.PathConf).items() if k.startswith("TestMatching.")}


@pytest.mark.parametrize("case", list(CONF_CASES))
def test_filer_conf_matching_on_the_port(case):
    call_case(CONF_CASES[case], {})


def test_filer_conf_json_equal_to_the_reference():
    rules = [("/buckets/", "c1", "001", "3d"), ("/buckets/media/", "m", "",
                                                 ""), ("/tmp", "", "", "1h")]
    pc, rc = port_conf.FilerConf(), ref_conf.FilerConf()
    for loc, col, rp, ttl in rules:
        pc.set_rule(port_conf.PathConf(location_prefix=loc, collection=col,
                                       replication=rp, ttl=ttl))
        rc.set_rule(ref_conf.PathConf(location_prefix=loc, collection=col,
                                      replication=rp, ttl=ttl))
    assert pc.to_json() == rc.to_json()
    for path in ("/buckets/media/a.mp4", "/buckets/x", "/tmp/y", "/z"):
        assert pc.match(path).to_dict() == rc.match(path).to_dict()


def _masked(entries) -> list[dict]:
    out = []
    for e in entries:
        d = e.to_dict()
        d.pop("mtime")
        d.pop("crtime")
        d.pop("hard_link_id", None)     # a uuid4
        for c in d.get("chunks", []):
            c.pop("mtime_ns")
        out.append(d)
    return out


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_same_mutations_same_namespace(kind, tmp_path):
    """One seeded run of creates, overwrites, mkdirs, renames, links and
    deletes through both packages' Filer: the same tree (timestamps and
    hard-link ids masked), the same dead chunks handed back, the same
    event kinds."""
    rng = np.random.default_rng([SEED, 7])
    dead_p, dead_r = [], []
    kw = {"path": str(tmp_path / "p.db")} if kind == "sqlite" else {}
    fp = port.Filer(kind, on_delete_chunks=dead_p.extend, **kw)
    kw = {"path": str(tmp_path / "r.db")} if kind == "sqlite" else {}
    fr = ref.Filer(kind, on_delete_chunks=dead_r.extend, **kw)
    for step in range(120):
        op = int(rng.integers(0, 6))
        a = f"/d{int(rng.integers(0, 3))}/f{int(rng.integers(0, 8))}"
        b = f"/d{int(rng.integers(0, 3))}/g{int(rng.integers(0, 8))}"
        size = int(rng.integers(1, 100))
        recursive = bool(rng.random() < 0.5)
        fid = f"{step + 1},{step:x}cd"
        for f, mod, dead in ((fp, port, dead_p), (fr, ref, dead_r)):
            try:
                if op in (0, 1):
                    f.create_entry(mod.Entry(full_path=a, chunks=[
                        mod.FileChunk(fid=fid, offset=0, size=size,
                                      mtime_ns=step)]), gc_old_chunks=True)
                elif op == 2:
                    f.mkdir(b + "dir")
                elif op == 3:
                    f.rename(a, b)
                elif op == 4:
                    f.link(a, b + "ln")
                else:
                    f.delete_entry(a.rsplit("/", 1)[0],
                                   recursive=recursive)
            except OSError as e:
                dead.append(type(e).__name__)
            except ValueError:
                dead.append("ValueError")
    assert _masked(fp.iter_tree("/")) == _masked(fr.iter_tree("/"))
    assert [c if isinstance(c, str) else c.fid for c in dead_p] == \
        [c if isinstance(c, str) else c.fid for c in dead_r]
    assert [port.event_kind(ev) for ev in fp.meta_log.replay()] == \
        [ref.event_kind(ev) for ev in fr.meta_log.replay()]
    fp.close()
    fr.close()
