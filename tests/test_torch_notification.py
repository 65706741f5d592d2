"""The port's notification/ (kafka_lite and the five queues) against the
JAX package's.

* Every case of tests/test_notification_kafka.py (over the mini broker
  of tests/minikafka.py, which checks each batch's CRC32C) and of
  tests/test_notification_cloud.py (over its SQS double, which
  re-derives SigV4, and its Pub/Sub double, which checks the bearer
  token) runs twice, `[reference]` and `[port]`
  (tests/torch_port_cases.py rebinds the case's names).
* Across packages, tolerance 0 (bytes):
  - the Kafka requests, Metadata and Produce, that both packages' queues
    put on the wire for the same seeded keys, values and timestamps;
  - the SQS SendMessage body and its SigV4 Authorization at one frozen
    second, and the Pub/Sub publish body and its bearer header;
  - the lines both packages' LogFileQueues write for the same events,
    and those each package's notifier writes for one filer's events.
"""
import base64
import json
import socket
import threading
import time
import types
from datetime import datetime, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import requests

import seaweedfs_tpu.notification.kafka_lite as ref_kafka_lite
import seaweedfs_tpu.notification.queues as ref_queues
import seaweedfs_tpu.s3.sigv4_client as ref_sigv4
import seaweedfs_tpu_torch.notification.queues as port_queues
import seaweedfs_tpu_torch.s3.sigv4_client as port_sigv4
from seaweedfs_tpu.filer.entry import Entry as RefEntry
from seaweedfs_tpu.filer.filer import Filer as RefFiler
from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.notification import kafka_lite
from seaweedfs_tpu_torch.rpc import httpclient

from tests import test_notification_cloud as ref_cloud
from tests import test_notification_kafka as ref_kafka
from tests.minikafka import MiniKafka
from tests.torch_port_cases import port_cases, run_case, swap_modules

SEED = 20261018
# the port's HTTP errors, under the name the cases catch them by
port_requests = types.SimpleNamespace(**{
    **vars(requests), "HTTPError": httpclient.HTTPError})
KAFKA = {
    "reference": port_cases(ref_kafka),
    "port": port_cases(ref_kafka, Entry=Entry, Filer=Filer,
                       KafkaClient=kafka_lite.KafkaClient,
                       KafkaError=kafka_lite.KafkaError,
                       attach_notifier=port_queues.attach_notifier,
                       make_queue=port_queues.make_queue),
}
CLOUD = {
    "reference": port_cases(ref_cloud),
    "port": port_cases(ref_cloud, make_queue=port_queues.make_queue,
                       requests=port_requests),
}
KAFKA_CASES = list(KAFKA["port"])
CLOUD_CASES = list(CLOUD["port"])


def test_every_reference_case_is_mirrored():
    assert KAFKA_CASES == list(KAFKA["reference"]) == [
        "test_metadata_and_produce", "test_produce_errors",
        "test_queue_routing_and_reconnect", "test_unknown_topic_fails_fast",
        "test_filer_events_reach_broker",
        "test_not_leader_triggers_refresh_and_follow"]
    assert CLOUD_CASES == list(CLOUD["reference"]) == [
        "test_sqs_signed_send", "test_sqs_bad_secret_rejected",
        "test_pubsub_publish_and_auth", "test_config_validation"]


@pytest.fixture(scope="module")
def brokers():
    """One mini broker per side: the cases count offsets from 0."""
    out = {side: MiniKafka() for side in KAFKA}
    yield out
    for b in out.values():
        b.close()


@pytest.mark.parametrize("side", list(KAFKA))
@pytest.mark.parametrize("case", KAFKA_CASES)
def test_kafka_case(case, side, brokers):
    swaps = {"seaweedfs_tpu.notification.queues": port_queues} \
        if side == "port" else {}
    with swap_modules(swaps, parents=True):
        run_case(KAFKA[side][case], {"broker": brokers[side]})


@pytest.mark.parametrize("side", list(CLOUD))
@pytest.mark.parametrize("case", CLOUD_CASES)
def test_cloud_case(case, side):
    run_case(CLOUD[side][case], {})


# ----------------------------------------------------------------------
# Kafka: the same request bytes
# ----------------------------------------------------------------------
class _Recording:
    """A broker connection that keeps every byte the client sends."""

    def __init__(self, sock, sent: list):
        self._sock, self._sent = sock, sent

    def sendall(self, data):
        self._sent.append(bytes(data))
        return self._sock.sendall(data)

    def recv(self, n):
        return self._sock.recv(n)

    def close(self):
        self._sock.close()


def _events(n: int) -> list[tuple[str, dict]]:
    rng = np.random.default_rng([SEED, 1])
    return [(f"/dir{int(rng.integers(0, 4))}/f{i}.bin",
             {"ts_ns": int(rng.integers(1, 1 << 62)),
              "size": int(rng.integers(0, 1 << 30)),
              "name": rng.bytes(8).hex()}) for i in range(n)]


def test_kafka_request_bytes_equal(monkeypatch):
    broker = MiniKafka({"seaweedfs_filer": 3})
    real = socket.create_connection
    sent: list = []
    monkeypatch.setattr(socket, "create_connection",
                        lambda *a, **kw: _Recording(real(*a, **kw), sent))
    wire = {}
    try:
        for side, mod in (("reference", ref_queues), ("port", port_queues)):
            sent.clear()
            clock = iter(range(1_790_000_000_000, 1_790_000_100_000, 7))
            monkeypatch.setattr(time, "time", lambda: next(clock) / 1000)
            q = mod.make_queue("kafka", hosts=f"127.0.0.1:{broker.port}")
            for key, msg in _events(24):
                q.send(key, msg)
            q.close()
            wire[side] = list(sent)
        # the client alone: Metadata v1 for two topics, then Produce v3
        # with empty and binary keys and values
        for side, mod in (("reference", ref_kafka_lite),
                          ("port", kafka_lite)):
            sent.clear()
            rng = np.random.default_rng([SEED, 2])
            c = mod.KafkaClient("127.0.0.1", broker.port)
            c.metadata(["seaweedfs_filer", "missing"])
            for i in range(4):
                c.produce("seaweedfs_filer", i % 3, rng.bytes(i * 5),
                          rng.bytes(300 * i), 1_790_000_000_000 + i)
            c.close()
            wire[side + "/client"] = list(sent)
    finally:
        broker.close()
    assert wire["port"] == wire["reference"]
    assert wire["port/client"] == wire["reference/client"]
    assert len(wire["port"]) == 25 and len(wire["port/client"]) == 5
    assert sum(len(v) for v in broker.records.values()) == 2 * (24 + 4)


# ----------------------------------------------------------------------
# SQS and Pub/Sub: the same request bodies and signatures
# ----------------------------------------------------------------------
class _Recorder(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.server.seen.append((self.path, {
            k.lower(): v for k, v in self.headers.items()
            if k.lower() in ("authorization", "x-amz-date",
                             "x-amz-content-sha256", "content-type")},
            body))
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")


@pytest.fixture()
def recorder():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Recorder)
    srv.seen = []
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv, f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()


def test_sqs_and_pubsub_requests_equal(recorder, monkeypatch):
    srv, url = recorder
    frozen = datetime(2026, 10, 18, 4, 5, 6, tzinfo=timezone.utc)
    for mod in (ref_sigv4, port_sigv4):
        monkeypatch.setattr(mod, "datetime", types.SimpleNamespace(
            now=lambda tz=None: frozen))
    got = {}
    for side, mod in (("reference", ref_queues), ("port", port_queues)):
        srv.seen.clear()
        q = mod.make_queue("aws_sqs", queue_url=f"{url}/12345/events-q",
                           region="eu-west-1", access_key="AK",
                           secret_key="SK")
        for key, msg in _events(5):
            q.send(key, msg)
        q.close()
        q = mod.make_queue("google_pub_sub", project="p1", topic="ev",
                           endpoint=url, token="pstoken")
        for key, msg in _events(3):
            q.send(key, msg)
        q.close()
        got[side] = list(srv.seen)
    assert got["port"] == got["reference"]
    assert len(got["port"]) == 8
    path, headers, body = got["port"][0]
    assert path == "/12345/events-q"
    assert headers["authorization"].startswith(
        "AWS4-HMAC-SHA256 Credential=AK/20261018/eu-west-1/sqs/")
    path, headers, body = got["port"][-1]
    assert path == "/v1/projects/p1/topics/ev:publish"
    assert headers["authorization"] == "Bearer pstoken"
    msg = json.loads(body)["messages"][0]
    assert json.loads(base64.b64decode(msg["data"])) == _events(3)[-1][1]


# ----------------------------------------------------------------------
# the log queue and the notifier
# ----------------------------------------------------------------------
def test_log_queue_lines_equal(tmp_path):
    out = {}
    for side, mod in (("reference", ref_queues), ("port", port_queues)):
        path = str(tmp_path / side / "events.jsonl")
        q = mod.make_queue("log", path=path)
        for key, msg in _events(16):
            q.send(key, msg)
        q.close()
        out[side] = open(path, "rb").read()
    assert out["port"] == out["reference"]
    assert out["port"].count(b"\n") == 16


def test_notifier_lines_equal(tmp_path):
    """Each package's notifier on its own filer, the same mutations: the
    same lines once the clocks and signatures are masked."""
    lines = {}
    for side, filer_cls, entry_cls, mod in (
            ("reference", RefFiler, RefEntry, ref_queues),
            ("port", Filer, Entry, port_queues)):
        f = filer_cls("memory")
        path = str(tmp_path / f"{side}.jsonl")
        q = mod.make_queue("log", path=path)
        pump = mod.attach_notifier(f, q, path_prefix="/nt")
        try:
            f.create_entry(entry_cls(full_path="/nt/a/one.txt"))
            f.create_entry(entry_cls(full_path="/other/x.txt"))
            f.rename("/nt/a/one.txt", "/nt/a/uno.txt")
            f.delete_entry("/nt/a/uno.txt")
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and \
                    open(path, "rb").read().count(b"\n") < 5:
                time.sleep(0.02)
        finally:
            pump.stop_event.set()
            pump.join(5)
            q.close()
            f.close()
        lines[side] = [_mask(json.loads(x)) for x in open(path)]
    assert lines["port"] == lines["reference"]
    # /nt's own create is an event of "/", outside the prefix; a rename
    # is a create of the new path and a delete of the old
    assert [x["key"] for x in lines["port"]] == [
        "/nt/a", "/nt/a/one.txt", "/nt/a/uno.txt", "/nt/a/one.txt",
        "/nt/a/uno.txt"]


_MASK = ("ts_ns", "mtime", "crtime", "mtime_ns", "signatures")


def _mask(obj):
    if isinstance(obj, dict):
        return {k: ("*" if k in _MASK else _mask(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj
