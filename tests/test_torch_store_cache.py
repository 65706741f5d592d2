"""The port's read-through cache and sharded store against the JAX
package's (tolerance 0).

* The cases of tests/test_filer_cache.py (zero staleness through the
  Python filer and the native S3 front's applier channel),
  tests/test_sharded_pagination.py (a sharded store's listings, page
  seams and prefix windows byte-identical to one store's) and
  tests/test_large_directory.py (100k-entry weedkv and 20k-entry redis
  directories paged in O(page)), each run on both packages.
* The same mutations, renames included, through a cached filer and an
  uncached one: every read after every mutation agrees (no stale read),
  and the cache's counters and snapshot are equal in both packages.
* The meta log calls its sync listeners under the filer's mutation
  lock, for every kind of mutation, in both packages: the cache's
  exact invalidation rests on it.
"""
import numpy as np
import pytest

import seaweedfs_tpu.filer as ref
from seaweedfs_tpu.filer import entry as ref_entry
from seaweedfs_tpu.filer.store_cache import CachingStore as RefCaching
from seaweedfs_tpu.s3.native_front import NativeS3Front as RefFront
import seaweedfs_tpu_torch.filer as port
from seaweedfs_tpu_torch.filer import entry as port_entry
from seaweedfs_tpu_torch.filer import filerstore as port_stores
from seaweedfs_tpu_torch.filer.store_cache import CachingStore as PortCaching
from seaweedfs_tpu_torch.s3.native_front import NativeS3Front as PortFront

from tests import test_filer_cache as ref_cache_cases
from tests import test_large_directory as ref_large_cases
from tests import test_sharded_pagination as ref_pagination_cases
from tests.torch_port_cases import (call_case, expand_params, port_cases,
                                    swap_modules)

SEED = 20261018
PKGS = {"reference": (ref, RefCaching, RefFront),
        "port": (port, PortCaching, PortFront)}
_PORT_MODULES = {"seaweedfs_tpu.filer.entry": port_entry,
                 "seaweedfs_tpu.filer.filerstore": port_stores}


def _cases(module, **port_subs):
    return {"reference": port_cases(module),
            "port": port_cases(module, Entry=port.Entry,
                               make_store=port.make_store, **port_subs)}


CACHE_CASES = _cases(ref_cache_cases, Filer=port.Filer,
                     CachingStore=PortCaching, NativeS3Front=PortFront)
PAGINATION_CASES = _cases(ref_pagination_cases)
PAGINATION_PARAMS = expand_params(ref_pagination_cases,
                                  PAGINATION_CASES["port"])
LARGE_CASES = _cases(ref_large_cases)


def _cached_filer(pkg, tmp_path, shards=2, child="leveldb"):
    mod, caching, _ = PKGS[pkg]
    inner = mod.make_store("sharded", path=str(tmp_path / "db"),
                           shards=shards, child=child)
    cached = caching(inner, entries=4096, pages=256)
    f = mod.Filer(cached)
    cached.attach(f.meta_log)
    return f


@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("case", list(CACHE_CASES["port"]))
def test_filer_cache_cases(case, pkg, tmp_path):
    f = _cached_filer(pkg, tmp_path)
    front = PKGS[pkg][2].__new__(PKGS[pkg][2])
    front.filer = f
    try:
        call_case(CACHE_CASES[pkg][case], {"filer": f, "front": front})
    finally:
        f.close()


@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("case", list(PAGINATION_PARAMS))
def test_sharded_pagination_cases(case, pkg, tmp_path):
    name, kwargs = PAGINATION_PARAMS[case]
    call_case(PAGINATION_CASES[pkg][name], {"tmp_path": tmp_path, **kwargs})


@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("case", list(LARGE_CASES["port"]))
def test_large_directory_cases(case, pkg, tmp_path):
    fn = LARGE_CASES[pkg][case]
    if pkg == "port":
        with swap_modules(_PORT_MODULES, parents=True):
            call_case(fn, {"tmp_path": tmp_path})
    else:
        call_case(fn, {"tmp_path": tmp_path})


def _mutations(entry_mod, seed: int):
    """Seeded creates, overwrites, deletes and renames (files and
    directories) under buckets and plain trees."""
    rng = np.random.default_rng(seed)
    live: list[str] = []
    ops = []
    for i in range(160):
        r = rng.random()
        if r < 0.55 or not live:
            d = (f"/buckets/b{int(rng.integers(0, 3))}" if rng.random() < 0.6
                 else f"/t{int(rng.integers(0, 2))}/d{int(rng.integers(0, 3))}")
            path = f"{d}/f{int(rng.integers(0, 30)):02d}"
            ops.append(("create", entry_mod.Entry(
                full_path=path, mode=0o644, mtime=100.0 + i,
                crtime=50.0 + i, md5=f"{i:032x}")))
            live.append(path)
        elif r < 0.75:
            ops.append(("delete", live.pop(int(rng.integers(0, len(live))))))
        elif r < 0.9:
            src = live.pop(int(rng.integers(0, len(live))))
            dst = f"/renamed/r{i:03d}"
            ops.append(("rename", src, dst))
            live.append(dst)
        else:
            d = f"/t{int(rng.integers(0, 2))}/d{int(rng.integers(0, 3))}"
            ops.append(("rename_dir", d, f"/moved/m{i:03d}"))
            live = [p for p in live if not p.startswith(d + "/")]
    return ops


def _apply(f, op) -> None:
    kind = op[0]
    try:
        if kind == "create":
            f.create_entry(op[1])
        elif kind == "delete":
            f.delete_entry(op[1])
        else:
            f.rename(op[1], op[2])
    except (FileNotFoundError, FileExistsError):
        pass


_PROBES = ([f"/buckets/b{b}/f{k:02d}" for b in range(3) for k in range(30)]
           + [f"/t{t}/d{d}/f{k:02d}" for t in range(2) for d in range(3)
              for k in range(0, 30, 3)])
_DIRS = ["/", "/buckets", "/buckets/b0", "/buckets/b1", "/buckets/b2",
         "/renamed", "/moved", "/t0/d0", "/t1/d2"]


def _reads(f) -> tuple:
    finds = tuple((p, None if e is None else
                   (e.md5, e.mtime, tuple(sorted(e.extended.items()))))
                  for p in _PROBES for e in [f.find_entry(p)])
    lists = tuple(tuple(e.name for e in f.list_entries(d, limit=1000))
                  for d in _DIRS)
    return finds, lists


@pytest.mark.parametrize("pkg", list(PKGS))
def test_no_stale_read_after_any_mutation(pkg, tmp_path):
    """A cached, sharded filer and a plain one take the same mutations;
    after each one every probe and listing agrees."""
    mod, _, _ = PKGS[pkg]
    entry_mod = ref_entry if pkg == "reference" else port_entry
    cached = _cached_filer(pkg, tmp_path, shards=4)
    plain = mod.Filer(mod.make_store("memory"))
    try:
        for n, op in enumerate(_mutations(entry_mod, SEED)):
            _apply(cached, op)
            _apply(plain, op)
            if n % 4 == 0:
                assert _reads(cached) == _reads(plain), (n, op)
                assert _reads(cached) == _reads(plain), (n, op)  # warm
        st = cached.store.stats()
        hits = st.get("hits_entry", 0) + st.get("hits_page", 0)
        assert hits > 0
    finally:
        cached.close()
        plain.close()


def test_cache_counters_and_snapshot_equal(tmp_path):
    """The same mutations and reads move the cache's counters by the
    same amounts, and leave the same sizes and store snapshot, in both
    packages (the counters are process-wide: compared as deltas)."""
    out = []
    for pkg in PKGS:
        entry_mod = ref_entry if pkg == "reference" else port_entry
        f = _cached_filer(pkg, tmp_path / pkg, shards=4)
        try:
            before = f.store.stats()
            for op in _mutations(entry_mod, SEED + 1):
                _apply(f, op)
                _reads(f)
            after = f.store.stats()
            delta = {k: v - (0 if k in ("entries", "pages") or
                             k.endswith("capacity") else before.get(k, 0))
                     for k, v in after.items()}
            out.append((delta, f.store.debug_snapshot()))
        finally:
            f.close()
    (s_ref, snap_ref), (s_port, snap_port) = out

    def strip(snap):        # the shard paths name each package's tmp dir
        if isinstance(snap, dict):
            return {k: strip(v) for k, v in snap.items() if k != "path"}
        if isinstance(snap, list):
            return [strip(v) for v in snap]
        return snap

    assert s_ref == s_port
    assert s_port["hits_entry"] > 0 and s_port["hits_page"] > 0
    assert strip(snap_ref["inner"]) == strip(snap_port["inner"])
    assert snap_port["kind"] == "cache"
    assert snap_port["inner"]["kind"] == "sharded"


@pytest.mark.parametrize("pkg", list(PKGS))
def test_sync_listeners_run_under_the_mutation_lock(pkg, tmp_path):
    mod = PKGS[pkg][0]
    entry_mod = ref_entry if pkg == "reference" else port_entry
    f = mod.Filer(mod.make_store("memory"))
    seen = []
    f.meta_log.sync_listeners.append(
        lambda ev: seen.append(f._mutation_lock._is_owned()))
    try:
        f.create_entry(entry_mod.Entry(full_path="/a/b/c", mode=0o644))
        f.update_entry(entry_mod.Entry(full_path="/a/b/c", mode=0o600))
        f.mkdir("/a/d")
        f.link("/a/b/c", "/a/d/hard")
        f.rename("/a/b", "/a/e")
        f.delete_entry("/a/d/hard")
        f.delete_entry("/a", recursive=True)
        for op in _mutations(entry_mod, SEED + 2)[:40]:
            _apply(f, op)
    finally:
        f.close()
    assert len(seen) > 40
    assert all(seen)
