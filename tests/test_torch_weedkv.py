"""The port's weedkv engine (the `leveldb` store's LSM) against the JAX
package's (tolerance 0 on every byte).

* The cases of tests/test_weedkv.py, run on each package: the
  reference's as they are, the port's with their names rebound
  (tests/torch_port_cases.py), WAL replay, torn tails (JSON and binary
  v2), segments, compaction and the store adapter included.
* The same seeded operations write byte-identical directories (WAL,
  segments, compacted segment) in both packages.
* Each package opens the other's directory — after a clean close, after
  a crash with a torn WAL tail, after compaction — and reads every key
  and every listing page the writer would.
* A compaction is observed in each package's own
  `filer_store_compaction_seconds` histogram.
"""
import inspect
import os

import numpy as np
import pytest

from seaweedfs_tpu.filer import entry as ref_entry
from seaweedfs_tpu.filer import filerstore as ref_stores
from seaweedfs_tpu.filer import weedkv as ref_weedkv
from seaweedfs_tpu.utils import metrics as ref_metrics
import seaweedfs_tpu_torch.filer as port
from seaweedfs_tpu_torch.filer import entry as port_entry
from seaweedfs_tpu_torch.filer import filerstore as port_stores
from seaweedfs_tpu_torch.filer import weedkv as port_weedkv
from seaweedfs_tpu_torch.utils import metrics as port_metrics

from tests import test_weedkv as ref_cases
from tests.torch_port_cases import call_case, port_cases, swap_modules

SEED = 20261018

PKGS = {
    "reference": {"weedkv": ref_weedkv, "stores": ref_stores,
                  "entry": ref_entry, "metrics": ref_metrics},
    "port": {"weedkv": port_weedkv, "stores": port_stores,
             "entry": port_entry, "metrics": port_metrics},
}

PORT_CASES = port_cases(ref_cases, weedkv=port_weedkv,
                        WeedKV=port_weedkv.WeedKV,
                        make_store=port.make_store)
REF_CASES = port_cases(ref_cases)
# cases import these inside their bodies
_PORT_MODULES = {"seaweedfs_tpu.filer.entry": port_entry,
                 "seaweedfs_tpu.filer.weedkv": port_weedkv}


@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("case", list(PORT_CASES))
def test_weedkv_cases(case, pkg, tmp_path, monkeypatch):
    fn = (PORT_CASES if pkg == "port" else REF_CASES)[case]
    db = None
    if "db" in inspect.signature(fn).parameters:   # the module's fixture
        db = PKGS[pkg]["weedkv"].WeedKV(str(tmp_path / "db"))
    fixtures = {"db": db, "tmp_path": tmp_path, "monkeypatch": monkeypatch}
    try:
        if pkg == "port":
            with swap_modules(_PORT_MODULES, parents=True):
                call_case(fn, fixtures)
        else:
            call_case(fn, fixtures)
    finally:
        if db is not None:
            db.close()


def _ops(seed: int, n: int = 600) -> list[tuple[bytes, bytes | None]]:
    """Seeded puts, overwrites and deletes over a small key space."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = f"k{int(rng.integers(0, 200)):04d}".encode()
        if rng.random() < 0.25:
            out.append((k, None))
        else:
            out.append((k, rng.bytes(int(rng.integers(0, 64)))))
    return out


def _apply(kv, ops) -> dict:
    want = {}
    for k, v in ops:
        if v is None:
            kv.delete(k)
            want.pop(k, None)
        else:
            kv.put(k, v)
            want[k] = v
    return want


def _tree(d: str) -> dict:
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("flush_every", [10_000, 50, 7])
def test_same_ops_write_identical_directories(flush_every, tmp_path,
                                              monkeypatch):
    for mod in (ref_weedkv, port_weedkv):
        monkeypatch.setattr(mod, "MEMTABLE_FLUSH_ENTRIES", flush_every)
        monkeypatch.setattr(mod, "COMPACT_SEGMENT_COUNT", 4)
    ops = _ops(SEED + flush_every)
    trees = []
    for name, mod in (("ref", ref_weedkv), ("port", port_weedkv)):
        kv = mod.WeedKV(str(tmp_path / name))
        _apply(kv, ops)
        kv._wal.flush()
        mid = _tree(str(tmp_path / name))     # before the clean close
        kv.close()
        trees.append((mid, _tree(str(tmp_path / name))))
    assert trees[0] == trees[1]


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
@pytest.mark.parametrize("ending", ["close", "crash", "torn", "compact"])
def test_each_opens_the_others_directory(writer, reader, ending, tmp_path,
                                         monkeypatch):
    w, r = PKGS[writer]["weedkv"], PKGS[reader]["weedkv"]
    for mod in (w, r):
        monkeypatch.setattr(mod, "MEMTABLE_FLUSH_ENTRIES", 64)
        monkeypatch.setattr(mod, "COMPACT_SEGMENT_COUNT", 100)
    d = str(tmp_path / "db")
    kv = w.WeedKV(d)
    want = _apply(kv, _ops(SEED))
    if ending == "close":
        kv.close()
    elif ending == "compact":
        kv.flush()
        kv.compact()
        assert sum(n.endswith(".sst") for n in os.listdir(d)) == 1
        kv.close()
    else:                                  # no clean close
        kv._wal.flush()
        if ending == "torn":
            with open(kv._wal_path, "ab") as f:
                f.write(w._encode_wal2(b"torn-key", b"torn-value")[:-5])
    kv2 = r.WeedKV(d)
    try:
        assert kv2.scan(b"", b"\xff") == sorted(want.items())
        for k in {k for k, _ in _ops(SEED)}:
            assert kv2.get(k) == want.get(k)
        assert kv2.get(b"torn-key") is None
        kv2.put(b"after", b"reopened")      # the reader's writes land
    finally:
        kv2.close()
    kv3 = w.WeedKV(d)
    try:
        assert kv3.get(b"after") == b"reopened"
    finally:
        kv3.close()


def _fixed_entry(entry_mod, path: str, i: int):
    e = entry_mod.Entry(full_path=path, mode=0o644 if i % 5 else 0o40755,
                        mtime=1000.0 + i, crtime=999.0 + i,
                        content=f"c{i}".encode() if i % 3 == 0 else b"")
    return e


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_leveldb_store_directory_across_packages(writer, reader, tmp_path):
    """The `leveldb` filer store one package wrote, opened by the
    other: every entry, every listing page and every KV value equal."""
    w, r = PKGS[writer], PKGS[reader]
    path = str(tmp_path / "filerdb")
    rng = np.random.default_rng(SEED)
    names = sorted({f"n{int(rng.integers(0, 10_000)):05d}"
                    for _ in range(300)})
    st = w["stores"].make_store("leveldb", path=path)
    for i, n in enumerate(names):
        d = f"/buckets/b{i % 3}" if i % 2 else f"/dir{(i // 2) % 4}/sub"
        st.insert_entry(_fixed_entry(w["entry"], f"{d}/{n}", i))
    for i in range(20):
        st.kv_put(f"kv/{i}", rng.bytes(16))
    st.delete_entry(f"/buckets/b1/{names[1]}")
    st.delete_entry(f"/dir1/sub/{names[2]}")
    dirs = ["/", "/buckets", "/buckets/b0", "/buckets/b1", "/buckets/b2",
            "/dir0/sub", "/dir2/sub", "/dir3/sub", "/dir1/sub"]

    def snapshot(store):
        out = {}
        for dpath in dirs:
            pages, cursor = [], ""
            while True:
                page = store.list_directory_entries(dpath, start_from=cursor,
                                                    limit=17)
                pages.append([e.to_dict() for e in page])
                if len(page) < 17:
                    break
                cursor = page[-1].name
            out[dpath] = pages
        out["kv"] = [store.kv_get(f"kv/{i}") for i in range(20)]
        return out

    before = snapshot(st)
    st.close()
    other = r["stores"].make_store("leveldb", path=path)
    try:
        assert snapshot(other) == before
        assert sum(len(p) for p in before["/buckets/b1"]) > 0
    finally:
        other.close()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_compaction_is_metered(pkg, tmp_path, monkeypatch):
    mod, metrics = PKGS[pkg]["weedkv"], PKGS[pkg]["metrics"]
    monkeypatch.setattr(mod, "MEMTABLE_FLUSH_ENTRIES", 8)
    monkeypatch.setattr(mod, "COMPACT_SEGMENT_COUNT", 3)

    def count() -> float:
        for line in metrics.render().splitlines():
            if line.startswith("filer_store_compaction_seconds_count"):
                return float(line.split()[-1])
        return 0.0

    before = count()
    kv = mod.WeedKV(str(tmp_path / "db"))
    try:
        _apply(kv, _ops(SEED, n=200))
    finally:
        kv.close()
    assert count() > before
