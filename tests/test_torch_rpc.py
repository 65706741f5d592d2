"""The port's transport alone (rpc/http.py, rpc/httpclient.py,
utils/retry.py, utils/httprange.py, utils/ratelimit.py): the route
table and the fid pattern, HEAD, JSON errors and the 500 a raising
handler gives, deadlines, ranges, file responses, keep-alive and the
reuse of a connection the server closed, client timeouts, connect
retry and the retry policy; held against the reference where it has the
same function (retry policy, range parser, token bucket), and across
the wire in both directions (requests against the port's server, the
port's client against an aiohttp server)."""
import json
import random
import socket
import threading
import time
import types

import pytest
import requests

from seaweedfs_tpu.rpc import http as ref_http
from seaweedfs_tpu.utils import httprange as ref_httprange
from seaweedfs_tpu.utils import ratelimit as ref_ratelimit
from seaweedfs_tpu.utils import retry as ref_retry
from seaweedfs_tpu_torch.rpc import http as rhttp
from seaweedfs_tpu_torch.rpc import httpclient as hc
from seaweedfs_tpu_torch.utils import httprange, ratelimit, retry

FID_ROUTE = "/{fid:[0-9]+,[0-9a-fA-F]+(_[0-9]+)?}"


def _app() -> rhttp.App:
    app = rhttp.App(bad_request=(json.JSONDecodeError, KeyError, ValueError))
    calls = app.calls = []

    def echo(req):
        calls.append(req.method)
        return rhttp.json_ok({"method": req.method, "path": req.path,
                              "query": req.query,
                              "body": req.read().decode("latin-1"),
                              "thread": threading.current_thread().name,
                              "deadline": retry.current_deadline()})

    def fid(req):
        return rhttp.json_ok({"fid": req.match_info["fid"],
                              "method": req.method})

    def boom(req):
        raise RuntimeError("codec exploded")

    def bad(req):
        return rhttp.json_ok({"v": req.json()["volume"]})

    def slow(req):
        calls.append("slow")
        time.sleep(float(req.query.get("s", "1")))
        return rhttp.json_ok()

    def flaky(req):
        calls.append(req.method)
        if len(calls) < int(req.query.get("fail", "1")) + 1:
            headers = {retry.RETRYABLE_HEADER: "1"} \
                if req.query.get("attest") else {}
            return rhttp.Response(b"busy", 503, headers)
        return rhttp.json_ok({"calls": len(calls)})

    app.get("/echo", echo)
    app.post("/echo", echo)
    app.route("*", FID_ROUTE, fid)
    app.get("/boom", boom)
    app.post("/bad", bad)
    app.get("/slow", slow)
    app.route("*", "/flaky", flaky)
    app.get("/debug", rhttp.debug_index_factory(
        "test", {"/debug/ec": "router", "/debug/x": "other"}))
    return app


@pytest.fixture()
def server():
    app = _app()
    st = rhttp.ServerThread(app).start()
    try:
        yield st
    finally:
        st.stop()


@pytest.fixture(autouse=True)
def fresh_session():
    hc.session().close()
    yield
    hc.session().close()


@pytest.mark.parametrize("fid,ok", [
    ("3,01637037d6", True), ("3,01637037d6_2", True),
    ("12,ABCDEF0123456789", True), ("3,0163xx37d6", False),
    ("a,01637037d6", False), ("3,01637037d6_x", False)])
def test_fid_route_pattern(server, fid, ok):
    r = hc.session().get(f"{server.url}/{fid}")
    if ok:
        assert r.status_code == 200 and r.json()["fid"] == fid
    else:
        assert r.status_code == 404 and "error" in r.json()


def test_routes_methods_and_head(server):
    s = hc.session()
    r = s.get(f"{server.url}/echo", params={"a": "1", "b": "x y"})
    assert r.json()["query"] == {"a": "1", "b": "x y"}
    r = s.get(f"{server.url}/echo?a=1&a=2")
    assert r.json()["query"] == {"a": "1"}          # first value wins
    assert s.delete(f"{server.url}/echo").status_code == 405
    assert s.get(f"{server.url}/nowhere").status_code == 404
    h = s.head(f"{server.url}/echo")
    assert h.status_code == 200 and h.content == b""
    assert int(h.headers["Content-Length"]) > 0
    for m in ("GET", "POST", "PUT", "DELETE", "HEAD"):
        r = s.request(m, f"{server.url}/3,01637037d6")
        assert r.status_code == 200
        if m != "HEAD":
            assert r.json()["method"] == m
    d = s.get(f"{server.url}/debug").json()
    assert d == {"service": "test", "endpoints": {
        "/debug/ec": "router", "/debug/x": "other"}}
    assert "test debug endpoints" in s.get(
        f"{server.url}/debug", params={"format": "text"}).text


def test_json_bodies_and_errors(server):
    s = hc.session()
    r = s.post(f"{server.url}/echo", json={"k": [1, 2]})
    assert json.loads(r.json()["body"]) == {"k": [1, 2]}
    r = s.post(f"{server.url}/echo", data=b"\x00\xffraw")
    assert r.json()["body"] == "\x00\xffraw"
    # malformed input: 400 with the error in JSON
    r = s.post(f"{server.url}/bad", data=b"{not json")
    assert r.status_code == 400 and "bad request" in r.json()["error"]
    r = s.post(f"{server.url}/bad", json={"nope": 1})
    assert r.status_code == 400 and "volume" in r.json()["error"]
    # a raising handler never answers 200
    r = s.get(f"{server.url}/boom")
    assert r.status_code == 500
    assert r.json()["error"] == "RuntimeError: codec exploded"


def test_chunked_request_body(server):
    with socket.create_connection(("127.0.0.1", server.port), 5) as c:
        c.sendall(b"POST /echo HTTP/1.1\r\nHost: x\r\n"
                  b"Transfer-Encoding: chunked\r\n\r\n"
                  b"5\r\nhello\r\n6\r\n world\r\n0\r\n\r\n")
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += c.recv(65536)
        head, _, body = buf.partition(b"\r\n\r\n")
        n = int([ln for ln in head.split(b"\r\n")
                 if ln.lower().startswith(b"content-length")][0]
                .split(b":")[1])
        while len(body) < n:
            body += c.recv(65536)
    assert json.loads(body)["body"] == "hello world"


def test_deadline_header(server):
    s = hc.session()
    past = {retry.DEADLINE_HEADER: f"{time.time() - 1:.6f}"}
    r = s.get(f"{server.url}/echo", headers=past)
    assert r.status_code == 504
    dl = time.time() + 30
    r = s.get(f"{server.url}/echo",
              headers={retry.DEADLINE_HEADER: f"{dl:.6f}"})
    assert abs(r.json()["deadline"] - dl) < 1e-3
    # the client carries the ambient deadline on
    with retry.deadline_scope(budget=20) as mine:
        r = s.get(f"{server.url}/echo")
    assert abs(r.json()["deadline"] - mine) < 1e-3
    with retry.deadline_scope(budget=-1):
        with pytest.raises(retry.DeadlineExceeded):
            s.get(f"{server.url}/echo")


def test_keep_alive_and_server_closed_idle(server, monkeypatch):
    s = hc.session()
    a = s.get(f"{server.url}/echo").json()["thread"]
    b = s.get(f"{server.url}/echo").json()["thread"]
    assert a == b                      # one connection, one server thread
    # the server drops every connection; the pool notices and reconnects
    server._server.close_connections()
    time.sleep(0.05)
    c = s.get(f"{server.url}/echo").json()["thread"]
    assert c != a
    # a connection that dies under a request it reused goes again fresh
    conn = s._take("127.0.0.1", server.port)
    conn.sock.shutdown(socket.SHUT_RDWR)
    s._release("127.0.0.1", server.port)(conn, True)
    monkeypatch.setattr(hc, "_dropped", lambda conn: False)
    assert s.post(f"{server.url}/echo", data=b"x").json()["body"] == "x"


def test_read_timeout_is_not_replayed(server):
    app = server.app
    with pytest.raises(hc.Timeout):
        hc.session().get(f"{server.url}/slow", params={"s": "1"},
                         timeout=(2.0, 0.2))
    assert app.calls.count("slow") == 1


def test_connect_failure_retries_then_raises(monkeypatch):
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()                       # nothing listens there
    monkeypatch.setattr(retry, "DEFAULT", retry.RetryPolicy(
        max_attempts=3, base_delay=0.001))
    tries = []
    real = hc.Session._connect

    def counting(*a):
        tries.append(1)
        return real(*a)

    monkeypatch.setattr(hc.Session, "_connect", staticmethod(counting))
    with pytest.raises(hc.ConnectionError):
        hc.session().post(f"http://127.0.0.1:{port}/x", data=b"1",
                          timeout=(1.0, 1.0))
    assert len(tries) == 3


def test_connect_failure_replays_a_post(server, monkeypatch):
    monkeypatch.setattr(retry, "DEFAULT", retry.RetryPolicy(
        max_attempts=3, base_delay=0.001))
    real = hc.Session._connect
    tries = []

    def once_refused(*a):
        tries.append(1)
        if len(tries) == 1:
            raise ConnectionRefusedError("refused")
        return real(*a)

    monkeypatch.setattr(hc.Session, "_connect", staticmethod(once_refused))
    r = hc.session().post(f"{server.url}/echo", data=b"once")
    assert r.json()["body"] == "once" and len(tries) == 2
    assert server.app.calls == ["POST"]


@pytest.mark.parametrize("method,attest,want_calls,want_status", [
    ("GET", False, 2, 200),      # idempotent: 503 retried
    ("POST", False, 1, 503),     # not idempotent, not attested: no replay
    ("POST", True, 2, 200),      # X-Sw-Retryable attests no work was done
])
def test_status_retry_policy(server, monkeypatch, method, attest,
                             want_calls, want_status):
    monkeypatch.setattr(retry, "DEFAULT", retry.RetryPolicy(
        max_attempts=3, base_delay=0.001))
    params = {"fail": "1"}
    if attest:
        params["attest"] = "1"
    r = hc.session().request(method, f"{server.url}/flaky", params=params)
    assert r.status_code == want_status
    assert len(server.app.calls) == want_calls


def test_file_response_streams_ranges(tmp_path):
    blob = random.Random(5).randbytes(3 * rhttp.FILE_PIECE + 123)
    path = tmp_path / "f.bin"
    path.write_bytes(blob)
    paced = []
    app = rhttp.App()
    app.get("/whole", lambda r: rhttp.file_response(str(path)))
    app.get("/part", lambda r: rhttp.file_response(
        str(path), 1000, 2 * rhttp.FILE_PIECE + 7, pace=paced.append))
    st = rhttp.ServerThread(app).start()
    try:
        s = hc.session()
        assert s.get(f"{st.url}/whole").content == blob
        r = s.get(f"{st.url}/part", stream=True)
        got = b"".join(r.iter_content(1 << 16))
        assert got == blob[1000:1000 + 2 * rhttp.FILE_PIECE + 7]
        assert paced == [rhttp.FILE_PIECE, rhttp.FILE_PIECE, 7]
        # the streamed connection went back to the pool
        assert s.get(f"{st.url}/whole").content == blob
    finally:
        st.stop()


def test_stop_runs_cleanup_and_closes_connections():
    app = _app()
    done = []
    app.on_startup.append(lambda: done.append("up"))
    app.on_cleanup.append(lambda: done.append("down"))
    st = rhttp.ServerThread(app).start()
    hc.session().get(f"{st.url}/echo")
    st.stop()
    assert done == ["up", "down"]
    with pytest.raises(hc.ConnectionError):
        hc.session().get(f"{st.url}/echo", timeout=(0.5, 0.5))


def test_requests_client_against_the_port_server(server):
    r = requests.post(f"{server.url}/echo", json={"a": 1}, timeout=5)
    assert json.loads(r.json()["body"]) == {"a": 1}
    r = requests.get(f"{server.url}/3,01637037d6_1", timeout=5)
    assert r.json() == {"fid": "3,01637037d6_1", "method": "GET"}
    r = requests.get(f"{server.url}/boom", timeout=5)
    assert r.status_code == 500 and "codec exploded" in r.json()["error"]
    with requests.Session() as sess:  # keep-alive from requests' pool
        names = {sess.get(f"{server.url}/echo", timeout=5).json()["thread"]
                 for _ in range(3)}
    assert len(names) == 1


def test_port_client_against_an_aiohttp_server():
    from aiohttp import web

    async def big(req):
        resp = web.StreamResponse()          # chunked transfer encoding
        await resp.prepare(req)
        for i in range(5):
            await resp.write(bytes([i]) * 100_000)
        await resp.write_eof()
        return resp

    async def echo(req):
        return web.json_response({"q": dict(req.query),
                                  "body": await req.json()})

    app = web.Application()
    app.add_routes([web.get("/big", big), web.post("/echo", echo)])
    st = ref_http.ServerThread(app).start()
    try:
        s = hc.session()
        got = s.get(f"{st.url}/big").content
        assert got == b"".join(bytes([i]) * 100_000 for i in range(5))
        r = s.post(f"{st.url}/echo", params={"x": 1}, json={"y": [2]})
        assert r.json() == {"q": {"x": "1"}, "body": {"y": [2]}}
        assert s.get(f"{st.url}/missing").status_code == 404
    finally:
        st.stop()


# -- held against the reference --------------------------------------------

@pytest.mark.parametrize("spec", [
    "", "bytes=0-0", "bytes=0-99", "bytes=10-", "bytes=-5", "bytes=-0",
    "bytes=95-200", "bytes=100-", "bytes=5-2", "bytes=a-b", "bytes=0-9,20-29",
    "bytes=0-60,50-99", "items=0-5", "bytes=,", "bytes=3", "bytes=-200"])
def test_range_parser_matches_reference(spec):
    for size in (0, 1, 100):
        assert httprange.parse_range_header(spec, size) == \
            ref_httprange.parse_range_header(spec, size)
    assert httprange.content_range(5, 10, 100) == \
        ref_httprange.content_range(5, 10, 100)


@pytest.mark.parametrize("seed", range(4))
def test_retry_policy_matches_reference(seed):
    a = retry.RetryPolicy(max_attempts=4, base_delay=0.05, max_delay=0.3)
    b = ref_retry.RetryPolicy(max_attempts=4, base_delay=0.05,
                              max_delay=0.3)
    ra, rb = random.Random(seed), random.Random(seed)
    for attempt in range(1, 8):
        assert a.backoff(attempt, ra) == b.backoff(attempt, rb)
    for attempt in range(5):
        for method in ("GET", "HEAD", "POST", "PUT"):
            for kw in ({}, {"conn_failure": True},
                       {"status": 503}, {"status": 500},
                       {"status": 503, "retryable_response": True},
                       {"idempotent": True, "status": 502}):
                assert a.should_retry(attempt, method, **kw) == \
                    b.should_retry(attempt, method, **kw)


def test_deadline_scope_matches_reference():
    for mod in (retry, ref_retry):
        with mod.deadline_scope(budget=10) as outer:
            with mod.deadline_scope(budget=100) as inner:
                assert inner == outer          # only tightens
            with mod.deadline_scope(absolute=outer - 5) as tighter:
                assert tighter == outer - 5
                h = mod.inject({})
                assert float(h[mod.DEADLINE_HEADER]) == pytest.approx(
                    tighter, abs=1e-5)
        assert mod.current_deadline() is None
        assert mod.parse_deadline("garbage") is None
        assert mod.parse_deadline(str(time.time() + 10 ** 6)) is None


@pytest.mark.parametrize("rate,burst", [(1000.0, None), (5e5, 4096.0),
                                         (0.0, None)])
def test_token_bucket_matches_reference(monkeypatch, rate, burst):
    now = [100.0]
    clock = types.SimpleNamespace(monotonic=lambda: now[0],
                                  time=lambda: now[0])
    monkeypatch.setattr(ratelimit, "time", clock)
    monkeypatch.setattr(ref_ratelimit, "time", clock)
    a = ratelimit.TokenBucket(rate, burst)
    b = ref_ratelimit.TokenBucket(rate, burst)
    rng = random.Random(int(rate))
    for _ in range(40):
        now[0] += rng.random() * 0.5
        n = rng.randrange(0, 200_000)
        # a zero timeout takes the bytes only when they are there, and
        # un-debits them otherwise: the same grants, the same fill
        assert a.acquire(n, timeout=0.0) == b.acquire(n, timeout=0.0)
        assert a.state() == b.state()
        if rng.random() < 0.2:
            a.cancel(n)
            b.cancel(n)
    ratelimit.reset()
    assert ratelimit.bucket("repair", 10.0).rate == 10.0
    assert ratelimit.bucket("repair", 20.0).rate == 20.0
    assert set(ratelimit.snapshot()) == {"repair"}
    ratelimit.reset()
