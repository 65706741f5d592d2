"""Message-queue broker server; the counterpart of
seaweedfs_tpu/mq/broker.py.

Equivalent of SeaweedFS weed/mq/broker/ (broker_server.go,
broker_grpc_pub.go, broker_grpc_sub.go, broker_grpc_configure.go):

- topics are `namespace/name` with a fixed partition count; their
  config is a JSON file in the filer at /topics/<ns>/<name>/topic.conf
  (SeaweedFS stores topic.conf through the filer too)
- publish hashes the record key onto a partition (md5; a sticky
  round-robin for empty keys) and appends to that partition's log
- partition logs live in the filer as segment files
  /topics/<ns>/<name>/p<k>/seg-<firstOffset, 20 digits> (flushed at
  256 records, 1 MiB or 1 s, the log buffer's flush), with the
  unflushed tail in the broker's memory — a restarted broker reads its
  offsets back from the filer
- subscribe streams records from `offset` on: flushed segments first,
  then the live in-memory tail, then it follows (long poll)

Records are JSON: {"o": offset, "ts": ns, "k": key, "v": value}; a
value that is not UTF-8 is {"v64": base64}.

The port runs on threads where the reference ran asyncio tasks: the
flush loop and the membership loop (`/cluster/announce` as type
`broker`, a `leave` on stop) are daemon threads started once the port
is bound (the App's on_startup), and the App's cleanup stops them and
flushes every dirty partition. Each partition's lock is a
`threading.Condition` whose notify wakes the subscribers the
reference woke with a fresh asyncio.Event. A subscription is a
chunked `application/x-ndjson` reply fed by a generator on the
request's thread, with the reference's replay, gap and follow steps,
`limit` and `idle_timeout`. Acknowledgement comes before the flush,
as in the reference: a broker killed (not stopped) loses its unflushed
tail.
"""
from __future__ import annotations

import base64
import bisect
import hashlib
import json
import threading
import time
from urllib.parse import quote

from ..rpc.http import App, Request, Response, json_response
from ..rpc.httpclient import session
from ..utils import glog

TOPICS_DIR = "/topics"
SEG_FLUSH_RECORDS = 256
SEG_FLUSH_BYTES = 1 << 20
SEG_FLUSH_AGE = 1.0  # seconds
# each filer hop, as the reference's ClientTimeout(total=30)
FILER_TIMEOUT = 30.0
# aiohttp's default client_max_size, which the reference's app keeps: a
# larger publish answers 413
MAX_BODY = 1 << 20


def _enc_value(v: bytes) -> dict:
    try:
        return {"v": v.decode("utf-8")}
    except UnicodeDecodeError:
        return {"v64": base64.b64encode(v).decode()}


def _line(rec: dict) -> str:
    return json.dumps(rec, separators=(",", ":"))


class _NoTopic(Exception):
    """The route names a topic this broker does not hold (404)."""


class Partition:
    """One partition's log: flushed segments in the filer + memory tail."""

    def __init__(self, dirpath: str, idx: int):
        self.dir = f"{dirpath}/p{idx}"
        self.idx = idx
        self.tail: list[dict] = []      # unflushed records
        self.tail_base = 0              # offset of tail[0]
        self.next_offset = 0
        self.tail_bytes = 0
        self.last_flush = time.monotonic()
        # guards the tail; notify_all wakes the subscribers following it
        self.lock = threading.Condition()


class Topic:
    def __init__(self, namespace: str, name: str, partitions: int = 4):
        self.namespace = namespace
        self.name = name
        self.partitions = partitions

    @property
    def dir(self) -> str:
        return f"{TOPICS_DIR}/{self.namespace}/{self.name}"

    def conf(self) -> dict:
        return {"namespace": self.namespace, "name": self.name,
                "partitions": self.partitions}


class BrokerServer:
    def __init__(self, filer_url: str, master_url: str = "",
                 announce_pulse: float = 3.0):
        self.filer_url = filer_url.rstrip("/")
        self.master_url = master_url.rstrip("/")
        self.announce_pulse = announce_pulse
        self.address = ""  # set by the runner after the socket binds
        self.topics: dict[tuple[str, str], Topic] = {}
        self.parts: dict[tuple[str, str, int], Partition] = {}
        self._rr = 0
        self._rr_lock = threading.Lock()
        self._stop = threading.Event()
        # set once the topics are loaded: the port listens before the
        # App's on_startup runs, where aiohttp listens only after it
        self._ready = threading.Event()
        self._threads: list[threading.Thread] = []
        self.app = self._build_app()
        self.app.on_startup.append(self._on_startup)
        self.app.on_cleanup.append(self._on_cleanup)

    # -- plumbing -------------------------------------------------------
    def _build_app(self) -> App:
        app = App(bad_request=(json.JSONDecodeError, KeyError, ValueError),
                  max_body=MAX_BODY)

        def route(method: str, path: str, handler) -> None:
            def serve(req: Request) -> Response:
                if not self._ready.wait(FILER_TIMEOUT):
                    return json_response({"error": "broker starting"},
                                         status=503)
                try:
                    return handler(req)
                except _NoTopic as e:
                    return json_response({"error": str(e)}, status=404)
            serve.__name__ = handler.__name__   # the server span's name
            app.route(method, path, serve)

        route("GET", "/status", self.handle_status)
        route("GET", "/topics", self.handle_list_topics)
        route("POST", "/topics/{ns}/{topic}", self.handle_configure)
        route("GET", "/topics/{ns}/{topic}", self.handle_describe)
        route("DELETE", "/topics/{ns}/{topic}", self.handle_delete)
        route("POST", "/topics/{ns}/{topic}/publish", self.handle_publish)
        route("GET", "/topics/{ns}/{topic}/subscribe",
              self.handle_subscribe)
        return app

    def _on_startup(self) -> None:
        self._stop.clear()
        self._load_topics()
        self._ready.set()
        loops = [self._flush_loop]
        if self.master_url:
            loops.append(self._membership_loop)
        self._threads = [threading.Thread(target=fn, daemon=True,
                                          name=f"mq-{fn.__name__}")
                         for fn in loops]
        for t in self._threads:
            t.start()

    def _on_cleanup(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)
        # flush every dirty partition so a clean shutdown loses nothing
        for key, part in list(self.parts.items()):
            topic = self.topics.get(key[:2])
            if topic and part.tail:
                try:
                    self._flush_partition(part)
                except Exception as e:  # noqa: BLE001 — flush the rest
                    glog.warning("mq: final flush of %s failed: %s",
                                 part.dir, e)

    def _announce(self, leave: bool = False) -> None:
        body = {"address": self.address, "type": "broker"}
        if leave:
            body["leave"] = True
        session().post(f"{self.master_url}/cluster/announce", json=body,
                       timeout=FILER_TIMEOUT)

    def _membership_loop(self) -> None:
        """Register as a broker in the cluster's membership
        (broker_server.go keepConnectedToMaster)."""
        while not self.address:
            if self._stop.wait(0.02):
                return
        while True:
            try:
                self._announce()
            except Exception as e:  # noqa: BLE001 — beat again later
                glog.v(1, "mq: announce to %s failed: %s",
                       self.master_url, e)
            if self._stop.wait(self.announce_pulse):
                break
        # deregister so shell commands don't route to a dead broker for
        # the membership's TTL
        try:
            self._announce(leave=True)
        except Exception as e:  # noqa: BLE001 — the TTL ends it anyway
            glog.v(1, "mq: leave announce failed: %s", e)

    # -- filer IO -------------------------------------------------------
    def _filer(self, method: str, path: str, **kw):
        return session().request(method, f"{self.filer_url}{quote(path)}",
                                 timeout=FILER_TIMEOUT, **kw)

    def _load_topics(self) -> None:
        """Rehydrate the topic registry and partition offsets from the
        filer (a stateless broker's restart)."""
        for ns in self._list_dir(TOPICS_DIR):
            if not ns["is_dir"]:
                continue
            ns_name = ns["name"]
            for tp in self._list_dir(f"{TOPICS_DIR}/{ns_name}"):
                if not tp["is_dir"]:
                    continue
                resp = self._filer(
                    "GET", f"{TOPICS_DIR}/{ns_name}/{tp['name']}"
                           f"/topic.conf")
                if resp.status_code != 200:
                    continue
                conf = json.loads(resp.content)
                topic = Topic(conf["namespace"], conf["name"],
                              conf.get("partitions", 4))
                self.topics[(topic.namespace, topic.name)] = topic
                for i in range(topic.partitions):
                    part = self._open_partition(topic, i)
                    self.parts[(topic.namespace, topic.name, i)] = part

    def _list_dir(self, path: str) -> list[dict]:
        resp = self._filer("GET", path,
                           headers={"Accept": "application/json"})
        if resp.status_code != 200:
            return []
        out = []
        for e in resp.json().get("entries", []):
            name = e["full_path"].rstrip("/").rsplit("/", 1)[-1]
            out.append({"name": name,
                        "is_dir": bool(e.get("mode", 0) & 0o40000)})
        return out

    def _open_partition(self, topic: Topic, idx: int) -> Partition:
        part = Partition(topic.dir, idx)
        segs = self._segments(part)
        if segs:
            # next offset = last segment's first offset + its records.
            # A failed read here must NOT fall through to offset 0 —
            # the broker would re-ack duplicate offsets and overwrite
            # the first flushed segment on the next flush.
            resp = self._filer("GET", f"{part.dir}/seg-{segs[-1]:020d}")
            if resp.status_code != 200:
                raise IOError(
                    f"cannot recover offsets for {part.dir}: segment "
                    f"seg-{segs[-1]:020d} read failed "
                    f"({resp.status_code})")
            n = sum(1 for line in resp.content.splitlines()
                    if line.strip())
            part.next_offset = segs[-1] + n
        part.tail_base = part.next_offset
        return part

    def _segments(self, part: Partition) -> list[int]:
        """Sorted first offsets of the flushed segment files."""
        segs = []
        for e in self._list_dir(part.dir):
            if e["name"].startswith("seg-"):
                try:
                    segs.append(int(e["name"][4:]))
                except ValueError:
                    continue
        return sorted(segs)

    def _flush_partition(self, part: Partition) -> None:
        # records stay in the tail until the segment write is durable:
        # removing them first would open a window where a subscriber
        # sees neither the tail copy nor the (in-flight) segment and
        # silently skips offsets. Duplicates across tail and segment
        # are harmless — subscribe filters by offset.
        with part.lock:
            if not part.tail:
                return
            records = list(part.tail)
            base = part.tail_base
        body = "\n".join(_line(r) for r in records) + "\n"
        resp = self._filer("POST", f"{part.dir}/seg-{base:020d}",
                           data=body.encode(),
                           headers={"Content-Type":
                                    "application/octet-stream"})
        if resp.status_code >= 300:
            raise IOError(f"segment flush failed: {resp.status_code}")
        with part.lock:
            del part.tail[:len(records)]
            part.tail_base = base + len(records)
            part.tail_bytes = sum(
                len(r.get("v", r.get("v64", ""))) + len(r["k"]) + 32
                for r in part.tail)
            part.last_flush = time.monotonic()

    def _flush_loop(self) -> None:
        while not self._stop.wait(SEG_FLUSH_AGE / 2):
            now = time.monotonic()
            for part in list(self.parts.values()):
                try:
                    if part.tail and (
                            now - part.last_flush >= SEG_FLUSH_AGE
                            or len(part.tail) >= SEG_FLUSH_RECORDS
                            or part.tail_bytes >= SEG_FLUSH_BYTES):
                        self._flush_partition(part)
                except Exception as e:  # noqa: BLE001 — retry next tick
                    glog.v(1, "mq: flush of %s failed: %s", part.dir, e)

    # -- handlers -------------------------------------------------------
    def _topic(self, req: Request) -> Topic:
        key = (req.match_info["ns"], req.match_info["topic"])
        topic = self.topics.get(key)
        if topic is None:
            raise _NoTopic(f"no topic {key[0]}/{key[1]}")
        return topic

    def handle_status(self, req: Request) -> Response:
        return json_response(
            {"filer": self.filer_url, "topics": len(self.topics)})

    def handle_list_topics(self, req: Request) -> Response:
        return json_response(
            {"topics": [t.conf() for t in self.topics.values()]})

    def handle_configure(self, req: Request) -> Response:
        """ConfigureTopic (broker_grpc_configure.go): create or grow."""
        ns, name = req.match_info["ns"], req.match_info["topic"]
        raw = req.read()
        body = json.loads(raw) if raw else {}
        partitions = int(body.get("partitions", 4))
        if partitions < 1:
            raise ValueError("partitions must be >= 1")
        existing = self.topics.get((ns, name))
        if existing is not None and existing.partitions > partitions:
            return json_response(
                {"error": "cannot shrink partitions"}, status=409)
        topic = Topic(ns, name, partitions)
        resp = self._filer(
            "POST", f"{topic.dir}/topic.conf",
            data=json.dumps(topic.conf()).encode(),
            headers={"Content-Type": "application/octet-stream"})
        if resp.status_code >= 300:
            return json_response(
                {"error": f"filer: {resp.status_code}"}, status=502)
        self.topics[(ns, name)] = topic
        for i in range(partitions):
            if (ns, name, i) not in self.parts:
                self.parts[(ns, name, i)] = self._open_partition(topic, i)
        return json_response(topic.conf(), status=201)

    def handle_describe(self, req: Request) -> Response:
        topic = self._topic(req)
        parts = []
        for i in range(topic.partitions):
            part = self.parts[(topic.namespace, topic.name, i)]
            parts.append({"partition": i,
                          "next_offset": part.next_offset})
        return json_response({**topic.conf(), "state": parts})

    def handle_delete(self, req: Request) -> Response:
        topic = self._topic(req)
        self._filer("DELETE", topic.dir, params={"recursive": "true"})
        del self.topics[(topic.namespace, topic.name)]
        for i in range(topic.partitions):
            self.parts.pop((topic.namespace, topic.name, i), None)
        return json_response({}, status=204)

    def _partition_of(self, topic: Topic, key: str) -> int:
        if key:
            return int(hashlib.md5(key.encode()).hexdigest(),
                       16) % topic.partitions
        with self._rr_lock:
            self._rr += 1
            return self._rr % topic.partitions

    def handle_publish(self, req: Request) -> Response:
        """Publish one record or a batch (broker_grpc_pub.go). Body:
        {"key": ..., "value": ...} or {"records": [...]}."""
        topic = self._topic(req)
        body = req.json()
        if "records" in body:
            # an explicitly empty batch is a no-op, NOT a single
            # publish of the envelope
            records = body["records"]
            if not isinstance(records, list):
                return json_response(
                    {"error": "records must be a list"}, status=400)
        else:
            records = [body]
        by_part: dict[int, list[tuple[int, str, bytes]]] = {}
        for i, rec in enumerate(records):
            key = rec.get("key", "")
            if "value64" in rec:
                value = base64.b64decode(rec["value64"])
            else:
                value = rec.get("value", "")
                if isinstance(value, str):
                    value = value.encode()
            by_part.setdefault(self._partition_of(topic, key), []).append(
                (i, key, value))
        # each partition's share of the batch is appended under one
        # hold of its lock, so the flush thread never cuts a batch into
        # two segments (the reference's event loop never yields inside
        # one); offsets follow the batch's order in every partition
        out: list[dict] = [{}] * len(records)
        for pidx, group in by_part.items():
            part = self.parts[(topic.namespace, topic.name, pidx)]
            with part.lock:
                for i, key, value in group:
                    record = {"o": part.next_offset, "ts": time.time_ns(),
                              "k": key, **_enc_value(value)}
                    part.tail.append(record)
                    part.tail_bytes += len(value) + len(key) + 32
                    part.next_offset += 1
                    out[i] = {"partition": pidx, "offset": record["o"]}
                part.lock.notify_all()
        return json_response({"acks": out})

    def handle_subscribe(self, req: Request) -> Response:
        """Stream records from `offset` on one partition; replays
        flushed segments then follows the live tail until idle for
        `idle_timeout` seconds (broker_grpc_sub.go)."""
        topic = self._topic(req)
        pidx = int(req.query.get("partition", "0"))
        if not 0 <= pidx < topic.partitions:
            raise ValueError(f"partition {pidx} out of range")
        offset = int(req.query.get("offset", "0"))
        idle_timeout = float(req.query.get("idle_timeout", "5"))
        limit = int(req.query.get("limit", "0"))
        part = self.parts[(topic.namespace, topic.name, pidx)]
        return Response(status=200, content_type="application/x-ndjson",
                        stream=self._follow(part, offset, idle_timeout,
                                            limit))

    def _segment_records(self, part: Partition, first: int):
        r = self._filer("GET", f"{part.dir}/seg-{first:020d}")
        if r.status_code != 200:
            return
        for line in r.content.splitlines():
            if line.strip():
                yield json.loads(line)

    def _follow(self, part: Partition, offset: int, idle_timeout: float,
                limit: int):
        """The subscription's ndjson lines, one piece each."""
        sent = 0
        # 1. replay flushed segments that may hold records >= offset
        for first in self._segments(part):
            with part.lock:
                tail_base = part.tail_base
            if first >= tail_base:
                break  # re-flushed after we read; the tail covers it
            for rec in self._segment_records(part, first):
                if rec["o"] < offset:
                    continue
                yield (_line(rec) + "\n").encode()
                offset, sent = rec["o"] + 1, sent + 1
                if limit and sent >= limit:
                    return
        # 2. the live tail, then follow it
        while True:
            with part.lock:
                pending = [r for r in part.tail if r["o"] >= offset]
                # records between the segment replay and the tail may
                # have been flushed while we replayed: read those
                gap = offset < part.tail_base and not pending
                if not pending and not gap:
                    # nothing new: wait for a publish or the idle timeout
                    if not part.lock.wait(idle_timeout):
                        return
                    continue
            if gap:
                segs = self._segments(part)
                # the segment holding `offset` is the last one starting
                # at or before it (segments have no fixed record count)
                idx = max(0, bisect.bisect_right(segs, offset) - 1)
                for first in segs[idx:]:
                    for rec in self._segment_records(part, first):
                        if rec["o"] < offset:
                            continue
                        yield (_line(rec) + "\n").encode()
                        offset, sent = rec["o"] + 1, sent + 1
                        if limit and sent >= limit:
                            return
                if offset < part.tail_base:
                    # nothing more on disk either: records were lost or
                    # compacted away; skip forward rather than spin
                    offset = part.tail_base
                continue
            for rec in pending:
                if rec["o"] < offset:
                    continue
                yield (_line(rec) + "\n").encode()
                offset, sent = rec["o"] + 1, sent + 1
                if limit and sent >= limit:
                    return
