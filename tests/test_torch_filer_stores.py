"""The port's filer metadata stores against the JAX package's
(tolerance 0 on every byte).

* The store contract (tests/test_filerstore_contract.py's cases) as one
  test over [reference|port] x kind: the embedded engines, the sharded
  and cached wrappers, and every network engine over its in-repo fake
  server (tests/mini*.py), one fresh server per case.
* The same operations leave the same keys, rows and documents in each
  fake server, whichever package's store made them; a server one
  package's store filled reads back equal through the other's, and a
  4-shard sharded directory likewise.
* The request bytes a recording proxy sees in front of the RESP, CQL
  and etcd fakes are equal for the same operations (etcd: each
  request's method, path and JSON body; the HTTP headers are each
  client's own).
* The reference's mysql case file fails now and then with 1045 "access
  denied": its fake server draws a 20-byte scramble from os.urandom,
  and the client (both packages) strips trailing NULs from the
  scramble as a real server never sends one. Shown here with a
  scramble that ends in NUL; the port's mysql cases run the reference
  file's cases against the fake with a scramble of 1..127 bytes, as a
  real mysqld draws it, so they do not inherit that failure.
* rocksdb: without librocksdb both packages refuse the kind with the
  same ImportError; with it, the contract runs on it too.
"""
import contextlib
import ctypes.util
import dataclasses
import json
import os
import socket
import threading
import types

import numpy as np
import pytest

import seaweedfs_tpu.filer as ref
from seaweedfs_tpu.filer import abstract_sql as ref_sql
from seaweedfs_tpu.filer import mysql_lite as ref_mysql_lite
from seaweedfs_tpu.filer.store_cache import CachingStore as RefCaching
import seaweedfs_tpu_torch.filer as port
from seaweedfs_tpu_torch.filer import abstract_sql as port_sql
from seaweedfs_tpu_torch.filer import entry as port_entry
from seaweedfs_tpu_torch.filer import mysql_lite as port_mysql_lite
from seaweedfs_tpu_torch.filer.store_cache import CachingStore as PortCaching

from tests import minimysql
from tests import test_filer_store_mysql as ref_mysql_cases
from tests import test_filerstore_contract as ref_contract
from tests.minicassandra import MiniCassandra
from tests.minietcd import MiniEtcd
from tests.minimongo import MiniMongo
from tests.minipg import MiniPg
from tests.miniredis import MiniRedis
from tests.minirediscluster import MiniRedisCluster
from tests.torch_port_cases import (call_case, port_cases, swap_modules,
                                    within)

SEED = 20261018
PKGS = {"reference": (ref, RefCaching), "port": (port, PortCaching)}
HAS_ROCKSDB = bool(ctypes.util.find_library("rocksdb"))

NETWORK = ["redis", "redis_cluster", "etcd", "mongodb", "cassandra",
           "mysql", "mysql2", "postgres", "postgres2"]
KINDS = (["memory", "sqlite", "leveldb", "sharded-leveldb",
          "sharded-sqlite", "cached-leveldb"] + NETWORK
         + (["rocksdb"] if HAS_ROCKSDB else []))


def _real_scramble(n: int) -> bytes:
    """A scramble as mysqld draws it: bytes 1..127, never NUL."""
    return bytes(1 + b % 127 for b in os.urandom(n))


class _Server:
    """One fake server of a network kind, started and stopped through
    `within`, with the store options that reach it."""

    def __init__(self, kind: str):
        self.kind = kind
        base = kind.rstrip("2")
        if base == "redis":
            self.srv = MiniRedis()
            self.opts = {"port": self.srv.port}
        elif base == "redis_cluster":
            self.srv = MiniRedisCluster(3)
            self.opts = {"host": self.srv.seeds}
        elif base == "etcd":
            self.srv = within(30, MiniEtcd().start)
            self.opts = {"port": self.srv.port}
        elif base == "mongodb":
            self.srv = within(30, MiniMongo().start)
            self.opts = {"port": self.srv.port}
        elif base == "cassandra":
            self.srv = MiniCassandra()
            self.opts = {"port": self.srv.port}
        elif base == "mysql":
            self.srv = minimysql.MiniMysql(user="weed", password="s3cret")
            # accepted sockets inherit it: the fake writes a result set
            # packet by packet, each then waits out a delayed ACK
            self.srv._srv.setsockopt(socket.IPPROTO_TCP,
                                     socket.TCP_NODELAY, 1)
            self.opts = {"port": self.srv.port, "user": "weed",
                         "password": "s3cret", "database": ""}
        elif base == "postgres":
            self.srv = MiniPg(user="weed", password="s3cret")
            self.opts = {"port": self.srv.port, "user": "weed",
                         "password": "s3cret", "database": ""}
        else:
            raise ValueError(kind)

    def stop(self) -> None:
        stop = getattr(self.srv, "stop", None) or self.srv.close
        within(30, stop)

    def state(self):
        """Everything the server holds, in a comparable form."""
        s, base = self.srv, self.kind.rstrip("2")
        if base == "redis":
            return (dict(s.kv), {k: sorted(v) for k, v in s.zsets.items()})
        if base == "redis_cluster":
            return [(dict(n.kv), {k: sorted(v) for k, v in n.zsets.items()})
                    for n in s.nodes]
        if base == "etcd":
            return dict(s._kv)
        if base == "mongodb":
            return json.loads(json.dumps(s._data, default=repr,
                                         sort_keys=True))
        if base == "cassandra":
            # (value, expiry): an expiry is a wall-clock deadline
            return {t: {k: (v[0], v[1] is not None) for k, v in rows.items()}
                    for t, rows in s.data.items()}
        with s.lock:                       # mysql / postgres: sqlite rows
            tables = sorted(r[0] for r in s.db.execute(
                "SELECT name FROM sqlite_master WHERE type='table'"))
            return {t: sorted(s.db.execute(f'SELECT * FROM "{t}"').fetchall(),
                              key=repr) for t in tables}


@contextlib.contextmanager
def _mysql_scramble():
    """minimysql's os, with a scramble as mysqld draws it."""
    saved = minimysql.os
    minimysql.os = types.SimpleNamespace(urandom=_real_scramble)
    try:
        yield
    finally:
        minimysql.os = saved


def _open(pkg: str, kind: str, tmp_path, server: _Server | None,
          name: str = "db"):
    mod, caching = PKGS[pkg]
    path = str(tmp_path / name)
    if kind == "memory":
        return mod.make_store("memory")
    if kind == "sqlite":
        return mod.make_store("sqlite", path=path + ".sqlite")
    if kind in ("leveldb", "rocksdb"):
        return mod.make_store(kind, path=path)
    if kind.startswith("sharded-"):
        return mod.make_store("sharded", path=path, shards=4,
                              child=kind.split("-")[1])
    if kind == "cached-leveldb":
        return caching(mod.make_store("leveldb", path=path), entries=64,
                       pages=16)
    return mod.make_store(kind, **server.opts)


@contextlib.contextmanager
def _store(pkg, kind, tmp_path, server=None, name="db"):
    own = server is None and kind in NETWORK
    with _mysql_scramble():
        if own:
            server = _Server(kind)
        try:
            st = _open(pkg, kind, tmp_path, server, name)
            try:
                yield st
            finally:
                st.close()
        finally:
            if own:
                server.stop()


CONTRACT = {"reference": port_cases(ref_contract),
            "port": port_cases(ref_contract, Entry=port.Entry,
                               make_store=port.make_store,
                               CachingStore=PortCaching)}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("case", list(CONTRACT["port"]))
def test_store_contract(case, pkg, kind, tmp_path):
    with _store(pkg, kind, tmp_path) as st:
        call_case(CONTRACT[pkg][case], {"store": st, "tmp_path": tmp_path})


# -- the same state, whichever package wrote it ------------------------
def _ops(entry_mod, seed: int):
    """Seeded creates, overwrites, deletes, subtree deletes and KV
    writes with fixed timestamps (entry JSON carries them)."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(80):
        bucket = int(rng.integers(0, 3))
        d = (f"/buckets/bk{bucket}" if rng.random() < 0.6
             else f"/top{int(rng.integers(0, 3))}/d{int(rng.integers(0, 2))}")
        name = f"f{int(rng.integers(0, 40)):03d}"
        chunks = [entry_mod.FileChunk(fid=f"{i % 7 + 1},{i:x}0a0b0c0d",
                                      offset=0, size=int(rng.integers(1, 999)),
                                      mtime_ns=1_000_000 + i)]
        e = entry_mod.Entry(full_path=f"{d}/{name}", mode=0o644,
                            mtime=1000.0 + i, crtime=900.0 + i,
                            chunks=chunks, md5=f"{i:032x}")
        ops.append(("insert", e))
        if rng.random() < 0.15:
            ops.append(("delete", f"{d}/{name}"))
        if i % 40 == 39:
            ops.append(("delete_children", f"/top{i % 3}"))
        if rng.random() < 0.2:
            ops.append(("kv_put", f"kv/{i % 9}", rng.bytes(24)))
    for b in range(3):
        ops.append(("insert", entry_mod.Entry(
            full_path=f"/buckets/bk{b}", mode=0o40755, mtime=5.0,
            crtime=5.0)))
    return ops


def _apply(store, ops) -> None:
    for op in ops:
        if op[0] == "insert":
            store.insert_entry(op[1])
        elif op[0] == "delete":
            store.delete_entry(op[1])
        elif op[0] == "delete_children":
            store.delete_folder_children(op[1])
        else:
            store.kv_put(op[1], op[2])


_LISTED = ["/", "/buckets", "/buckets/bk0", "/buckets/bk1", "/buckets/bk2",
           "/top0/d0", "/top0/d1", "/top1/d0", "/top1/d1", "/top2/d0",
           "/top2/d1"]


def _view(store) -> dict:
    """Every listing page (limit 7), point lookups and KV values."""
    out = {}
    for d in _LISTED:
        pages, cursor = [], ""
        while True:
            page = store.list_directory_entries(d, start_from=cursor, limit=7)
            pages.append([e.to_dict() for e in page])
            if len(page) < 7:
                break
            cursor = page[-1].name
        out[d] = pages
    out["find"] = {p: (e.to_dict() if e else None) for p in
                   (f"/buckets/bk{b}/f{i:03d}" for b in range(3)
                    for i in range(0, 40, 3))
                   for e in [store.find_entry(p)]}
    out["kv"] = [store.kv_get(f"kv/{i}") for i in range(9)]
    return out


@pytest.mark.parametrize("kind", NETWORK)
def test_same_operations_leave_the_same_server_state(kind, tmp_path):
    states, views = [], []
    for pkg in PKGS:
        entry_mod = ref.entry if pkg == "reference" else port_entry
        with _mysql_scramble():
            server = _Server(kind)
        try:
            with _store(pkg, kind, tmp_path, server) as st:
                _apply(st, _ops(entry_mod, SEED))
                views.append(_view(st))
            states.append(server.state())
        finally:
            server.stop()
    assert states[0] == states[1]
    assert views[0] == views[1]
    assert sum(len(p) for p in views[0]["/buckets/bk1"]) > 0


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
@pytest.mark.parametrize("kind", NETWORK + ["sharded-leveldb",
                                            "sharded-sqlite"])
def test_a_store_one_package_filled_reads_back_in_the_other(
        kind, writer, reader, tmp_path):
    entry_mod = ref.entry if writer == "reference" else port_entry
    server = None
    if kind in NETWORK:
        with _mysql_scramble():
            server = _Server(kind)
    try:
        with _store(writer, kind, tmp_path, server) as st:
            _apply(st, _ops(entry_mod, SEED + 1))
            want = _view(st)
        with _store(reader, kind, tmp_path, server) as st:
            assert _view(st) == want
            if kind.startswith("sharded-"):
                # the shards' own directories hold the namespace
                shard_dirs = sorted(os.listdir(tmp_path / "db"))
                assert shard_dirs[:4] == [f"shard-{i:02d}" for i in range(4)]
    finally:
        if server is not None:
            server.stop()


# -- request bytes -------------------------------------------------------
class _Recorder:
    """A TCP proxy that records what clients send, per connection."""

    def __init__(self, upstream_port: int):
        self.up = upstream_port
        self.sent: list[bytearray] = []
        self._lsn = socket.create_server(("127.0.0.1", 0))
        self.port = self._lsn.getsockname()[1]
        self._socks: list[socket.socket] = []
        self._threads: list[threading.Thread] = []
        self._spawn(self._accept)

    def _spawn(self, fn, *args) -> None:
        t = threading.Thread(target=fn, args=args, daemon=True)
        self._threads.append(t)
        t.start()

    def _accept(self) -> None:
        while True:
            try:
                c, _ = self._lsn.accept()
            except OSError:
                return
            u = socket.create_connection(("127.0.0.1", self.up))
            for sk in (c, u):      # relay each write as it comes
                sk.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            log = bytearray()
            self.sent.append(log)
            self._socks += [c, u]
            self._spawn(self._pump, c, u, log)
            self._spawn(self._pump, u, c, None)

    @staticmethod
    def _pump(src, dst, log) -> None:
        try:
            while True:
                b = src.recv(65536)
                if not b:
                    break
                if log is not None:
                    log += b
                dst.sendall(b)
        except OSError:
            pass
        finally:
            with contextlib.suppress(OSError):
                dst.shutdown(socket.SHUT_WR)

    def close(self) -> None:
        # shutdown, not just close: it wakes the accept and the recvs
        for s in [self._lsn] + self._socks:
            with contextlib.suppress(OSError):
                s.shutdown(socket.SHUT_RDWR)
            s.close()
        for t in self._threads:
            t.join(5)


def _http_requests(raw: bytes) -> list[tuple[str, str, bytes]]:
    """(method, path, body) of each request in an HTTP/1.1 stream."""
    out = []
    while raw:
        head, _, rest = raw.partition(b"\r\n\r\n")
        lines = head.decode().split("\r\n")
        method, path, _ = lines[0].split(" ")
        hdrs = {k.lower(): v.strip() for k, _, v in
                (ln.partition(":") for ln in lines[1:])}
        n = int(hdrs.get("content-length", 0))
        out.append((method, path, rest[:n]))
        raw = rest[n:]
    return out


@pytest.mark.parametrize("kind", ["redis", "cassandra", "etcd"])
def test_request_bytes_equal(kind, tmp_path):
    seen = []
    for pkg in PKGS:
        entry_mod = ref.entry if pkg == "reference" else port_entry
        server = _Server(kind)
        rec = _Recorder(server.srv.port)
        try:
            proxied = types.SimpleNamespace(opts={**server.opts,
                                                  "port": rec.port})
            with _store(pkg, kind, tmp_path, proxied) as st:
                _apply(st, _ops(entry_mod, SEED + 2))
                _view(st)
        finally:
            rec.close()
            server.stop()
        streams = [bytes(b) for b in rec.sent]
        if kind == "etcd":
            streams = [_http_requests(b) for b in streams]
            streams = [r for s in streams for r in s]   # over any conns
        seen.append(streams)
    assert seen[0] == seen[1]
    assert seen[0]


# -- mysql ---------------------------------------------------------------
@pytest.mark.parametrize("lite", [ref_mysql_lite, port_mysql_lite],
                         ids=list(PKGS))
def test_a_scramble_ending_in_nul_is_refused_by_both_clients(lite,
                                                             monkeypatch):
    """The cause of the reference mysql file's rare 1045: the fake's
    os.urandom scramble ended in NUL, which the client strips."""
    nonce = bytes(range(1, 20)) + b"\x00"
    monkeypatch.setattr(minimysql, "os",
                        types.SimpleNamespace(urandom=lambda n: nonce[:n]))
    srv = minimysql.MiniMysql(user="weed", password="s3cret")
    try:
        with pytest.raises(lite.MysqlError) as ei:
            lite.MysqlConnection("127.0.0.1", srv.port, user="weed",
                                 password="s3cret")
        assert ei.value.errno == 1045
        nonce = bytes(range(1, 21))              # no NUL: accepted
        monkeypatch.setattr(minimysql, "os", types.SimpleNamespace(
            urandom=lambda n: nonce[:n]))
        lite.MysqlConnection("127.0.0.1", srv.port, user="weed",
                             password="s3cret").close()
    finally:
        srv.close()


MYSQL_CASES = port_cases(
    ref_mysql_cases, Entry=port.Entry, FileChunk=port.FileChunk,
    Filer=port.Filer, MysqlConnection=port_mysql_lite.MysqlConnection,
    MysqlError=port_mysql_lite.MysqlError,
    escape_literal=port_mysql_lite.escape_literal,
    native_password_token=port_mysql_lite.native_password_token)


@pytest.fixture(scope="module")
def mysqld():
    with _mysql_scramble():
        s = minimysql.MiniMysql(user="weed", password="s3cret")
    yield s
    within(10, s.close)


@pytest.mark.parametrize("case", list(MYSQL_CASES))
def test_mysql_cases_on_the_port(case, mysqld):
    fixtures = {"mysqld": mysqld}
    with _mysql_scramble(), swap_modules(
            {"seaweedfs_tpu.filer.abstract_sql": port_sql}, parents=True):
        with mysqld.lock:
            for (name,) in mysqld.db.execute(
                    "SELECT name FROM sqlite_master WHERE type='table'"
            ).fetchall():
                mysqld.db.execute(f'DROP TABLE IF EXISTS "{name}"')
        store_cls = port_sql.Mysql2Store if "mysql2" in case \
            else port_sql.MysqlStore
        st = store_cls(port=mysqld.port, user="weed", password="s3cret",
                       database="")
        fixtures["store"] = fixtures["store2"] = st
        try:
            call_case(MYSQL_CASES[case], fixtures)
        finally:
            st.close()


def test_sql_dialects_equal():
    for name in ("MYSQL_DIALECT", "POSTGRES_DIALECT"):
        assert dataclasses.asdict(getattr(port_sql, name)) == \
            dataclasses.asdict(getattr(ref_sql, name))
    for p in ("/", "/a", "/buckets/b/x", "/ünï/cöde"):
        assert port_sql.dir_hash(p) == ref_sql.dir_hash(p)


# -- rocksdb ---------------------------------------------------------------
def test_rocksdb_gate_as_the_reference(tmp_path):
    """Without librocksdb both packages refuse the kind with the same
    ImportError; with it both open a store (and the contract runs)."""
    errs = []
    for pkg in PKGS:
        try:
            PKGS[pkg][0].make_store("rocksdb",
                                    path=str(tmp_path / pkg)).close()
            errs.append(None)
        except ImportError as e:
            errs.append(str(e).replace(str(tmp_path / pkg), "P"))
    assert errs[0] == errs[1]
    assert (errs[0] is None) == HAS_ROCKSDB
    if not HAS_ROCKSDB:
        assert "rocksdb" in errs[0]


# -- the filer server's store options and /debug/filer -----------------------
def test_filer_and_server_take_the_store_flags(monkeypatch):
    from seaweedfs_tpu_torch import cli

    parser = cli.build_parser()
    a = parser.parse_args(["filer"])
    assert (a.store, a.store_path, a.store_host, a.store_port,
            a.filer_store_shards, a.filer_cache_entries,
            a.filer_cache_pages, a.encrypt_volume_data) == \
        ("memory", ":memory:", "", 0, 0, 0, 0, False)
    s = parser.parse_args(["server"])
    assert (s.filer_store, s.filer_store_shards, s.filer_cache_entries,
            s.filer_cache_pages) == ("sqlite", 0, 0, 0)
    seen = {}

    def start(args, master, port, store, store_path, **kw):
        seen.update(kw, store=store, store_path=store_path)
        raise SystemExit(0)

    monkeypatch.setattr(cli, "_start_filer", start)
    with pytest.raises(SystemExit):
        cli.main(["filer", "-store", "redis", "-store.host", "h",
                  "-store.port", "7000", "-store.password", "pw",
                  "-filer.store.shards", "4", "-filer.cache.entries", "99",
                  "-filer.cache.pages", "7", "-encryptVolumeData"])
    assert seen["store"] == "redis"
    assert seen["store_options"] == {"host": "h", "port": 7000,
                                     "password": "pw"}
    assert (seen["store_shards"], seen["cache_entries"], seen["cache_pages"],
            seen["cipher"]) == (4, 99, 7, True)


def _debug_filer_reference(fs) -> dict:
    import asyncio

    return json.loads(asyncio.run(fs.handle_debug_filer(None)).text)


def _debug_filer_port(fs) -> dict:
    return json.loads(fs.handle_debug_filer(None).body)


@pytest.mark.parametrize("layout", ["memory", "sqlite", "leveldb",
                                    "sharded", "sharded-cached"])
def test_debug_filer_answers_as_the_reference(layout, tmp_path):
    from seaweedfs_tpu.server.filer_server import FilerServer as RefFS
    from seaweedfs_tpu_torch.server.filer_server import FilerServer as PortFS

    kind = {"sharded": "leveldb", "sharded-cached": "leveldb"}.get(layout,
                                                                   layout)
    kw = {}
    if layout.startswith("sharded"):
        kw["store_shards"] = 4
    if layout == "sharded-cached":
        kw["cache_entries"] = 128
    out = []
    for pkg, cls, debug in (("reference", RefFS, _debug_filer_reference),
                            ("port", PortFS, _debug_filer_port)):
        entry_mod = ref.entry if pkg == "reference" else port_entry
        path = str(tmp_path / pkg / ("filer.db" if kind == "sqlite"
                                     else "filerdb"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fs = cls("http://127.0.0.1:9", store=kind,
                 store_path=path if kind != "memory" else ":memory:", **kw)
        try:
            for op in _ops(entry_mod, SEED + 3):
                if op[0] == "insert":
                    fs.filer.create_entry(op[1])
            for i in range(10):
                fs.filer.find_entry(f"/buckets/bk{i % 3}/f{i:03d}")
            body = debug(fs)
        finally:
            fs.filer.close()
        body = json.loads(json.dumps(body).replace(str(tmp_path / pkg), "T"))
        cache = body["snapshot"].get("cache")
        if cache:       # its counters are process-wide: sizes only
            body["snapshot"]["cache"] = {
                k: v for k, v in cache.items()
                if k in ("entries", "entry_capacity", "pages",
                         "page_capacity")}
        out.append(body)
    assert out[0] == out[1]
    assert out[1]["store"] == {"memory": "memory", "sqlite": "sqlite",
                               "leveldb": "leveldb", "sharded": "sharded",
                               "sharded-cached": "cached-sharded"}[layout]
