"""The port's last five filer engines (elastic, arangodb, hbase over
thrift_lite, tikv and ydb over utils/grpc_lite) against the JAX
package's, with tolerance 0 on every byte.

* The store contract (tests/test_filerstore_contract.py's cases) as one
  test over [reference|port] x kind, each engine over its in-repo fake
  server (tests/mini*.py; tikv and ydb are real grpc-core servers).
* The reference's own engine cases (tests/test_filer_store_*.py) and
  its grpc_lite cases (tests/test_grpc_lite.py) on the port's modules.
* The same operations leave the same documents, rows, cells and keys
  in each fake, whichever package's store made them; a fake one
  package's store filled is found, listed and deleted through the
  other's.
* The request bytes: the Thrift stream byte for byte, each HTTP
  request's method, path and JSON body, each HTTP/2 HEADERS and DATA
  frame (one fake and one recording proxy for both packages, so the
  :authority is the same).
* grpc_lite: the Huffman table, a message larger than the peer's
  window, and a GOAWAY in mid-call (the call re-dials once, then
  fails with the same error).
* Both CLIs parse `filer -store <kind>` with the store flags to the
  same store and options, and `server -filer.store <kind>`; an engine
  whose server is down refuses to start in both packages.
"""
import contextlib
import socket
import struct
import threading
import types
from concurrent import futures

import grpc
import pytest

import seaweedfs_tpu.filer as ref
from seaweedfs_tpu.filer import entry as ref_entry
from seaweedfs_tpu.utils import grpc_lite as ref_grpc_lite
import seaweedfs_tpu_torch.filer as port
from seaweedfs_tpu_torch.filer import abstract_sql as port_sql
from seaweedfs_tpu_torch.filer import (arangodb_store, elastic_store,
                                       hbase_store, thrift_lite, tikv_store,
                                       ydb_store)
from seaweedfs_tpu_torch.filer import entry as port_entry
from seaweedfs_tpu_torch.filer.filer import Filer as PortFiler
from seaweedfs_tpu_torch.rpc import httpclient
from seaweedfs_tpu_torch.utils import grpc_lite

from tests import test_filer_store_arangodb as ref_arango_cases
from tests import test_filer_store_elastic as ref_elastic_cases
from tests import test_filer_store_hbase as ref_hbase_cases
from tests import test_filer_store_tikv as ref_tikv_cases
from tests import test_filer_store_ydb as ref_ydb_cases
from tests import test_filerstore_contract as ref_contract
from tests import test_grpc_lite as ref_grpc_cases
from tests.miniarango import MiniArango
from tests.minielastic import MiniElastic
from tests.minihbase import MiniHbase
from tests.minitikv import MiniTikv
from tests.miniydb import MiniYdb
from tests.test_torch_filer_stores import (_apply, _http_requests, _ops,
                                           _Recorder, _view)
from tests.torch_port_cases import (call_case, port_cases, swap_modules,
                                    within)

SEED = 20261018
PKGS = {"reference": ref, "port": port}
ENTRY = {"reference": ref_entry, "port": port_entry}
KINDS = ["elastic", "arangodb", "hbase", "tikv", "ydb"]


class _Fake:
    """One fake server of a kind, with the store options that reach it,
    a way to empty it and its whole state in a comparable form."""

    def __init__(self, kind: str):
        self.kind = kind
        if kind == "elastic":
            self.srv = MiniElastic()
        elif kind == "arangodb":
            self.srv = MiniArango()
        elif kind == "hbase":
            self.srv = within(30, MiniHbase().start)
        elif kind == "tikv":
            self.srv = within(30, MiniTikv().start)
        else:
            self.srv = within(30, MiniYdb().start)
        self.port = self.srv.port
        lsn = getattr(getattr(self.srv, "_srv", None), "socket", None) or \
            getattr(self.srv, "sock", None)
        if lsn is not None:
            # accepted sockets inherit it: the fake writes a reply's head
            # and body apart, each then waits out a delayed ACK
            lsn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def stop(self) -> None:
        stop = getattr(self.srv, "stop", None) or self.srv.close
        within(30, stop)

    def clear(self) -> None:
        s = self.srv
        if self.kind == "elastic":
            with s.lock:
                s.indexes.clear()
        elif self.kind == "arangodb":
            with s.lock:
                s.collections.clear()
        elif self.kind == "hbase":
            s.tables.clear()
            s.scanners.clear()
            s._next_scanner = 1     # ids the server hands out restart too
        elif self.kind == "tikv":
            s.kv.clear()
        else:
            s.filemeta.clear()
            s.kv.clear()
            s.sessions = 0

    def state(self):
        s = self.srv
        if self.kind == "elastic":
            return s.indexes
        if self.kind == "arangodb":
            return s.collections
        if self.kind == "hbase":
            return s.tables
        if self.kind == "tikv":
            return s.kv
        return s.filemeta, s.kv


@pytest.fixture(scope="module")
def fakes():
    out = {}
    try:
        for kind in KINDS:
            out[kind] = _Fake(kind)
        yield out
    finally:
        for f in out.values():
            f.stop()


@contextlib.contextmanager
def _store(pkg: str, kind: str, port_no: int):
    st = PKGS[pkg].make_store(kind, port=port_no)
    try:
        yield st
    finally:
        st.close()


CONTRACT = {"reference": port_cases(ref_contract),
            "port": port_cases(ref_contract, Entry=port.Entry,
                               make_store=port.make_store)}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("case", list(CONTRACT["port"]))
def test_store_contract(case, pkg, kind, fakes, tmp_path):
    fakes[kind].clear()
    with _store(pkg, kind, fakes[kind].port) as st:
        call_case(CONTRACT[pkg][case], {"store": st, "tmp_path": tmp_path})


# -- the reference's engine cases on the port -----------------------------
_COMMON = dict(Entry=port.Entry, FileChunk=port.FileChunk, Filer=PortFiler)
ENGINE_CASES = {
    "elastic": port_cases(ref_elastic_cases,
                          ElasticStore=elastic_store.ElasticStore,
                          INDEX_PREFIX=elastic_store.INDEX_PREFIX,
                          **_COMMON),
    "arangodb": port_cases(ref_arango_cases,
                           ArangodbStore=arangodb_store.ArangodbStore,
                           DEFAULT_COLLECTION=(
                               arangodb_store.DEFAULT_COLLECTION),
                           **_COMMON),
    "hbase": port_cases(ref_hbase_cases, HbaseStore=hbase_store.HbaseStore,
                        tl=thrift_lite, **_COMMON),
    "tikv": port_cases(ref_tikv_cases, TikvStore=tikv_store.TikvStore,
                       _prefix_end=tikv_store._prefix_end, **_COMMON),
    "ydb": port_cases(ref_ydb_cases, YdbStore=ydb_store.YdbStore,
                      **_COMMON),
}
# the reference module's name for its fake server's fixture
_SERVER_FIXTURE = {"elastic": "es", "arangodb": "arango",
                   "hbase": "hbase_server", "tikv": "tikv_server",
                   "ydb": "ydb_server"}
_STORE_CLS = {"elastic": elastic_store.ElasticStore,
              "arangodb": arangodb_store.ArangodbStore,
              "hbase": hbase_store.HbaseStore,
              "tikv": tikv_store.TikvStore, "ydb": ydb_store.YdbStore}


_REQUESTS = types.SimpleNamespace(HTTPError=httpclient.HTTPError)


@pytest.mark.parametrize("kind,case", [(k, c) for k in KINDS
                                       for c in ENGINE_CASES[k]])
def test_reference_engine_cases_on_the_port(kind, case, fakes):
    fake = fakes[kind]
    fake.clear()
    st = _STORE_CLS[kind](port=fake.port)
    try:
        # the auth cases import `requests` for its HTTPError: the port's
        # stores raise rpc/httpclient's
        with swap_modules({"seaweedfs_tpu.filer.abstract_sql": port_sql,
                           "requests": _REQUESTS}, parents=True):
            call_case(ENGINE_CASES[kind][case],
                      {_SERVER_FIXTURE[kind]: fake.srv, "store": st})
    finally:
        st.close()


# -- the same state, whichever package wrote it ----------------------------
@pytest.mark.parametrize("kind", KINDS)
def test_same_operations_leave_the_same_server_state(kind, fakes):
    fake = fakes[kind]
    states, views = [], []
    for pkg in PKGS:
        fake.clear()
        with _store(pkg, kind, fake.port) as st:
            _apply(st, _ops(ENTRY[pkg], SEED))
            views.append(_view(st))
        states.append(repr(fake.state()))
    assert states[0] == states[1]
    assert views[0] == views[1]
    assert sum(len(p) for p in views[0]["/buckets/bk1"]) > 0


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
@pytest.mark.parametrize("kind", KINDS)
def test_a_store_one_package_filled_is_used_by_the_other(kind, writer,
                                                         reader, fakes):
    fake = fakes[kind]
    fake.clear()
    with _store(writer, kind, fake.port) as st:
        _apply(st, _ops(ENTRY[writer], SEED + 1))
        want = _view(st)
    with _store(reader, kind, fake.port) as st:
        assert _view(st) == want
        # found, listed and deleted through the other package
        victim = next(e for page in want["/buckets/bk1"] for e in page)
        path = victim["full_path"]
        assert st.find_entry(path).to_dict() == victim
        st.delete_entry(path)
        assert st.find_entry(path) is None
        st.delete_folder_children("/buckets/bk2")
        assert st.list_directory_entries("/buckets/bk2") == []
        after = _view(st)
    with _store(writer, kind, fake.port) as st:
        assert _view(st) == after
        assert st.find_entry(path) is None


# -- request bytes ----------------------------------------------------------
PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"


def _h2_frames(raw: bytes) -> list[tuple]:
    """(type, flags, stream, payload) of each HEADERS and DATA frame a
    client sent (SETTINGS, PING and WINDOW_UPDATE answer the server's
    timing)."""
    assert raw.startswith(PREFACE)
    i, out = len(PREFACE), []
    while i + 9 <= len(raw):
        n = int.from_bytes(raw[i:i + 3], "big")
        ftype, flags = raw[i + 3], raw[i + 4]
        stream = struct.unpack(">I", raw[i + 5:i + 9])[0] & 0x7FFFFFFF
        if ftype in (0, 1):
            out.append((ftype, flags, stream, raw[i + 9:i + 9 + n]))
        i += 9 + n
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_request_bytes_equal(kind, fakes):
    fake = fakes[kind]
    rec = _Recorder(fake.port)
    seen = []
    try:
        for pkg in PKGS:
            fake.clear()
            first = len(rec.sent)
            with _store(pkg, kind, rec.port) as st:
                _apply(st, _ops(ENTRY[pkg], SEED + 2))
                _view(st)
            streams = [bytes(b) for b in rec.sent[first:]]
            if kind in ("elastic", "arangodb"):
                streams = [r for s in streams for r in _http_requests(s)]
            elif kind in ("tikv", "ydb"):
                streams = [_h2_frames(s) for s in streams]
            seen.append(streams)
    finally:
        rec.close()
    assert seen[0] == seen[1]
    assert seen[0] and all(seen[0])


@pytest.mark.parametrize("kind", KINDS)
def test_an_unreachable_engine_refuses_to_start(kind):
    """No fall-back to another store: both packages raise an OSError
    (the same type and text where both speak through the socket)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
    s.close()
    errs = []
    for pkg in PKGS:
        with pytest.raises(OSError) as ei:
            PKGS[pkg].make_store(kind, port=dead).close()
        errs.append((type(ei.value).__name__, str(ei.value)))
    if kind in ("hbase", "tikv", "ydb"):
        assert errs[0] == errs[1]


# -- grpc_lite -------------------------------------------------------------
GRPC_CASES = port_cases(ref_grpc_cases, g=grpc_lite)


@pytest.fixture(scope="module")
def grpc_server():
    srv = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    srv.add_generic_rpc_handlers((ref_grpc_cases._Handlers(),))
    port_no = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    yield port_no
    srv.stop(0)


@pytest.mark.parametrize("case", list(GRPC_CASES))
def test_reference_grpc_lite_cases_on_the_port(case, grpc_server):
    ch = grpc_lite.GrpcChannel("127.0.0.1", grpc_server)
    try:
        call_case(GRPC_CASES[case], {"ch": ch, "server": grpc_server})
    finally:
        ch.close()


def test_huffman_table_and_hpack_equal():
    assert grpc_lite._HUFFMAN == ref_grpc_lite._HUFFMAN
    assert len(grpc_lite._HUFFMAN) == 257
    hdrs = [(":method", "POST"), ("x-tag", "ünï"), ("grpc-timeout", "5S")]
    assert grpc_lite.hpack_encode_raw(hdrs) == \
        ref_grpc_lite.hpack_encode_raw(hdrs)
    for i in range(256):
        code, bits = grpc_lite._HUFFMAN[i]
        pad = (8 - bits % 8) % 8
        n = (bits + pad) // 8
        raw = ((code << pad) | ((1 << pad) - 1)).to_bytes(n, "big")
        assert grpc_lite.huffman_decode(raw) == bytes([i])


@pytest.mark.parametrize("mod", [ref_grpc_lite, grpc_lite],
                         ids=list(PKGS))
def test_a_message_larger_than_the_window(mod, grpc_server):
    """300 KiB each way: past the 64 KiB initial windows, so the call
    waits for WINDOW_UPDATEs and sends its own."""
    body = bytes(range(256)) * 1200
    ch = mod.GrpcChannel("127.0.0.1", grpc_server)
    try:
        assert ch.unary("/test.Echo/Big", body) == body[::-1]
        assert ch.unary("/test.Echo/Unary", b"x") == b"echo:x"
    finally:
        ch.close()


class _GoawayProxy:
    """The first `goaways` connections read the client's call and
    answer SETTINGS then GOAWAY; later ones relay to the real server."""

    def __init__(self, upstream: int, goaways: int):
        self.up, self.left = upstream, goaways
        self._lsn = socket.create_server(("127.0.0.1", 0))
        self.port = self._lsn.getsockname()[1]
        self._socks: list[socket.socket] = []
        self._thread = threading.Thread(target=self._accept, daemon=True)
        self._thread.start()

    def _accept(self) -> None:
        while True:
            try:
                c, _ = self._lsn.accept()
            except OSError:
                return
            self._socks.append(c)
            if self.left > 0:
                self.left -= 1
                threading.Thread(target=self._goaway, args=(c,),
                                 daemon=True).start()
                continue
            u = socket.create_connection(("127.0.0.1", self.up))
            self._socks.append(u)
            for a, b in ((c, u), (u, c)):
                threading.Thread(target=self._pump, args=(a, b),
                                 daemon=True).start()

    @staticmethod
    def _goaway(c: socket.socket) -> None:
        got = b""
        with contextlib.suppress(OSError):
            # the preface, SETTINGS, the call's HEADERS and its DATA
            while got.count(b"/test.Echo/Unary") == 0 or \
                    not got.endswith(b"hello"):
                piece = c.recv(65536)
                if not piece:
                    return
                got += piece
            frame = lambda t, f, s, p: (len(p).to_bytes(3, "big") +  # noqa: E731
                                        bytes([t, f]) +
                                        struct.pack(">I", s) + p)
            c.sendall(frame(4, 0, 0, b"") +
                      frame(7, 0, 0, struct.pack(">II", 0, 0)))
            c.shutdown(socket.SHUT_WR)

    @staticmethod
    def _pump(a: socket.socket, b: socket.socket) -> None:
        with contextlib.suppress(OSError):
            while True:
                piece = a.recv(65536)
                if not piece:
                    break
                b.sendall(piece)
        with contextlib.suppress(OSError):
            b.shutdown(socket.SHUT_WR)

    def close(self) -> None:
        for s in [self._lsn] + self._socks:
            with contextlib.suppress(OSError):
                s.shutdown(socket.SHUT_RDWR)
            s.close()
        self._thread.join(5)


@pytest.mark.parametrize("goaways", [1, 2])
def test_a_goaway_in_mid_call(goaways, grpc_server):
    """One GOAWAY: the call re-dials and is answered. Two: it fails,
    with the reference's error."""
    out = []
    for mod in (ref_grpc_lite, grpc_lite):
        proxy = _GoawayProxy(grpc_server, goaways)
        ch = mod.GrpcChannel("127.0.0.1", proxy.port)
        try:
            try:
                out.append(ch.unary("/test.Echo/Unary", b"hello"))
            except OSError as e:
                out.append((type(e).__name__,
                            str(e).replace(str(proxy.port), "P")))
        finally:
            ch.close()
            proxy.close()
    assert out[0] == out[1]
    if goaways == 1:
        assert out[1] == b"echo:hello"
    else:
        assert out[1] == ("OSError",
                          "grpc /test.Echo/Unary: h2 GOAWAY from server")


# -- the CLIs ---------------------------------------------------------------
STORE_FLAGS = ["-store.host", "127.0.0.9", "-store.port", "9999",
               "-store.user", "weed", "-store.password", "pw",
               "-store.database", "seaweedfs"]


@pytest.mark.parametrize("kind", KINDS)
def test_both_clis_parse_the_store_flags_alike(kind, monkeypatch):
    from seaweedfs_tpu import cli as ref_cli
    from seaweedfs_tpu.server import filer_server as ref_fs
    from seaweedfs_tpu_torch import cli

    seen = {}

    class Caught(Exception):
        pass

    def ref_filer(master, store, **kw):
        seen["reference"] = (store, kw["store_options"])
        raise Caught

    def port_filer(args, master, port_no, store, store_path, **kw):
        seen["port"] = (store, kw["store_options"])
        raise Caught

    monkeypatch.setattr(ref_fs, "FilerServer", ref_filer)
    monkeypatch.setattr(cli, "_start_filer", port_filer)
    argv = ["filer", "-store", kind] + STORE_FLAGS
    for main in (ref_cli.main, cli.main):
        with pytest.raises(Caught):
            main(argv)
    assert seen["port"] == seen["reference"]
    assert seen["port"] == (kind, {"host": "127.0.0.9", "port": 9999,
                                   "user": "weed", "password": "pw",
                                   "database": "seaweedfs"})
    assert kind in port.STORES
    assert cli.build_parser().parse_args(
        ["server", "-filer.store", kind]).filer_store == kind


def test_the_registries_hold_the_same_kinds():
    assert sorted(port.STORES) == sorted(ref.STORES)
    kinds = {"memory", "sqlite", "leveldb", "redis", "redis_cluster",
             "etcd", "mongodb", "cassandra", "mysql", "mysql2",
             "postgres", "postgres2", "elastic", "arangodb", "hbase",
             "tikv", "ydb", "rocksdb"}
    assert len(kinds) == 18 and kinds <= set(port.STORES)
