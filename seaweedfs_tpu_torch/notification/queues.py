"""Metadata-event notification publishing; the counterpart of
seaweedfs_tpu/notification/queues.py, on rpc/httpclient's per-thread
session instead of a `requests.Session` per queue.

Equivalent of SeaweedFS weed/notification/ (configuration.go +
kafka/aws_sqs/google_pub_sub adapters, consumed by
weed/command/filer_notify read side): every filer metadata mutation
can be published to an external queue. All five backends are real
here, SDK-free: in-memory and JSONL log for local consumers, kafka
over the in-tree wire producer, SQS over the SigV4-signed Query API,
and Pub/Sub over the JSON REST API with in-tree OAuth. Kept as the
reference has it: `attach_notifier` never unsubscribes from the
filer's log; its pump only stops.
"""
from __future__ import annotations

import json
import os
import queue
import threading

from ..rpc.httpclient import session


class NotificationQueue:
    name = "base"

    def send(self, key: str, message: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryQueue(NotificationQueue):
    name = "memory"

    def __init__(self, maxsize: int = 10000, **_):
        self.q: queue.Queue = queue.Queue(maxsize=maxsize)

    def send(self, key: str, message: dict) -> None:
        try:
            self.q.put_nowait((key, message))
        except queue.Full:
            self.q.get_nowait()  # drop oldest
            self.q.put_nowait((key, message))

    def drain(self) -> list[tuple[str, dict]]:
        out = []
        while True:
            try:
                out.append(self.q.get_nowait())
            except queue.Empty:
                return out


class LogFileQueue(NotificationQueue):
    """Append-only JSONL file, one line per event — the `log` notifier
    plus a tail-able integration point for external consumers."""

    name = "log"

    def __init__(self, path: str, **_):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(path, "ab")

    def send(self, key: str, message: dict) -> None:
        line = json.dumps({"key": key, "message": message}) \
            .encode() + b"\n"
        with self._lock:
            self._f.write(line)
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._f.close()


class KafkaQueue(NotificationQueue):
    """Publish metadata events to a Kafka topic over the in-tree wire
    producer (kafka_lite.py: Metadata v1 + Produce v3) — the slot of
    SeaweedFS weed/notification/kafka/kafka_queue.go:15, JSON
    payloads instead of protobuf. Events for one path land on one
    partition (key-hash routing), keeping per-file event order; each
    produce goes to that partition's LEADER broker from metadata, with
    a refresh + one retry on NOT_LEADER / transport failure.

    Delivery is at-least-once, like the reference's sarama producer: a
    response lost after the request landed is retried and may
    duplicate the event; definitive broker rejections (message too
    large, ...) are never retried."""

    name = "kafka"

    NOT_LEADER = 6
    _RETRIABLE = (3, 5, 6)  # unknown-topic / leader-not-avail / not-leader

    def __init__(self, hosts: str = "127.0.0.1:9092",
                 topic: str = "seaweedfs_filer",
                 metadata_retries: int = 5, **_):
        self.topic = topic
        host, _, port = hosts.split(",")[0].partition(":")
        self._bootstrap = (host, int(port or 9092))
        self._clients: dict[tuple[str, int], object] = {}
        self._brokers: dict[int, tuple[str, int]] = {}
        self._leaders: dict[int, int] = {}  # partition -> broker node
        self._lock = threading.Lock()
        self._refresh_metadata(metadata_retries)

    def _client(self, addr: tuple[str, int]):
        from .kafka_lite import KafkaClient

        c = self._clients.get(addr)
        if c is None:
            c = self._clients[addr] = KafkaClient(*addr)
        return c

    def _drop_client(self, addr: tuple[str, int]) -> None:
        c = self._clients.pop(addr, None)
        if c is not None:
            c.close()

    def _refresh_metadata(self, retries: int = 5) -> None:
        """Leader discovery. The first Metadata for a missing topic
        TRIGGERS auto-create on a standard broker but answers
        UNKNOWN_TOPIC(3) or LEADER_NOT_AVAILABLE(5); real clients
        retry until the leaders settle (sarama does the same)."""
        import time as _time

        t: dict = {}
        md: dict = {}
        for attempt in range(max(1, retries)):
            try:
                md = self._client(self._bootstrap) \
                    .metadata([self.topic])
            except (IOError, OSError):
                # the cached bootstrap connection can be just as stale
                # as the leader's that sent us here — reconnect it once
                self._drop_client(self._bootstrap)
                md = self._client(self._bootstrap) \
                    .metadata([self.topic])
            t = md["topics"].get(self.topic, {})
            if t.get("error", 0) == 0 and t.get("partitions"):
                break
            if t.get("error") not in self._RETRIABLE:
                break
            _time.sleep(0.2 * (attempt + 1))
        if t.get("error", 0) != 0 or not t.get("partitions"):
            raise KeyError(
                f"kafka topic {self.topic!r} unavailable "
                f"(error {t.get('error')})")
        self._brokers = md["brokers"]
        self._leaders = dict(t["partitions"])

    def _leader_addr(self, pid: int) -> tuple[str, int]:
        addr = self._brokers.get(self._leaders.get(pid, -1))
        return tuple(addr) if addr else self._bootstrap

    def send(self, key: str, message: dict) -> None:
        import hashlib
        import time as _time

        from .kafka_lite import KafkaError

        value = json.dumps(message, separators=(",", ":")).encode()
        with self._lock:
            pids = sorted(self._leaders)
            pid = pids[int.from_bytes(
                hashlib.md5(key.encode()).digest()[:4], "big")
                % len(pids)]
            for attempt in (0, 1):
                addr = self._leader_addr(pid)
                try:
                    self._client(addr).produce(
                        self.topic, pid, key.encode(), value,
                        int(_time.time() * 1000))
                    return
                except KafkaError as e:
                    # leadership moved: refresh and follow it once;
                    # any other broker answer is definitive
                    if e.code != self.NOT_LEADER or attempt:
                        raise
                    self._refresh_metadata()
                except (IOError, OSError):
                    # transport failure: reconnect via fresh metadata
                    # and retry once (at-least-once — see class doc)
                    self._drop_client(addr)
                    if attempt:
                        raise
                    self._refresh_metadata()

    def close(self) -> None:
        for c in self._clients.values():
            c.close()
        self._clients.clear()


class AwsSqsQueue(NotificationQueue):
    """Publish events to an AWS SQS queue over the Query API
    (SendMessage), signed with the in-tree SigV4 signer — the slot of
    SeaweedFS weed/notification/aws_sqs/aws_sqs_pub.go:16,
    JSON bodies instead of protobuf. `queue_url` overrides endpoint
    resolution for emulators (localstack/elasticmq-style)."""

    name = "aws_sqs"

    def __init__(self, queue_url: str = "", region: str = "us-east-1",
                 access_key: str = "", secret_key: str = "", **_):
        if not queue_url:
            raise ValueError("aws_sqs notification needs queue_url")
        self.queue_url = queue_url.rstrip("/")
        self.region = region
        self.access_key = access_key
        self.secret_key = secret_key

    def send(self, key: str, message: dict) -> None:
        import urllib.parse

        from ..s3.sigv4_client import sign_headers

        body = urllib.parse.urlencode({
            "Action": "SendMessage",
            "Version": "2012-11-05",
            "MessageBody": json.dumps({"key": key, "message": message},
                                      separators=(",", ":")),
            "MessageAttribute.1.Name": "key",
            "MessageAttribute.1.Value.DataType": "String",
            "MessageAttribute.1.Value.StringValue": key,
        }).encode()
        headers = {"Content-Type":
                   "application/x-www-form-urlencoded"}
        if self.access_key:
            headers.update(sign_headers(
                "POST", self.queue_url, self.access_key,
                self.secret_key, body, region=self.region,
                service="sqs"))
        r = session().post(self.queue_url, data=body, headers=headers,
                           timeout=30)
        r.raise_for_status()


class GooglePubSubQueue(NotificationQueue):
    """Publish events to a GCP Pub/Sub topic over the JSON REST API
    (topics.publish) with the shared GcpTokenSource (static token /
    metadata / service-account JWT) — the slot of SeaweedFS
    weed/notification/google_pub_sub/google_pub_sub.go:17. `endpoint`
    overrides https://pubsub.googleapis.com for emulators."""

    name = "google_pub_sub"

    def __init__(self, project: str = "", topic: str = "",
                 endpoint: str = "", token: str = "",
                 token_url: str = "", credentials_file: str = "", **_):
        if not project or not topic:
            raise ValueError(
                "google_pub_sub notification needs project and topic")
        from ..utils.gcp_auth import GcpTokenSource

        self.url = ((endpoint or "https://pubsub.googleapis.com")
                    .rstrip("/") +
                    f"/v1/projects/{project}/topics/{topic}:publish")
        self._tokens = GcpTokenSource(
            token=token, token_url=token_url,
            credentials_file=credentials_file,
            scope="https://www.googleapis.com/auth/pubsub")

    def send(self, key: str, message: dict) -> None:
        import base64

        data = base64.b64encode(json.dumps(
            message, separators=(",", ":")).encode()).decode()
        r = session().post(
            self.url,
            json={"messages": [{"data": data,
                                "attributes": {"key": key}}]},
            headers=self._tokens.headers(), timeout=30)
        r.raise_for_status()


def make_queue(kind: str, **kwargs) -> NotificationQueue:
    queues = {"memory": MemoryQueue, "log": LogFileQueue,
              "kafka": KafkaQueue, "aws_sqs": AwsSqsQueue,
              "google_pub_sub": GooglePubSubQueue}
    if kind not in queues:
        raise KeyError(
            f"unknown notification queue {kind!r}; have "
            f"{sorted(queues)}")
    return queues[kind](**kwargs)


def queue_from_config(conf: dict) -> NotificationQueue:
    """Build a queue from a stored config dict
    ({"kind": "log", "path": ...} — the notification.toml analog kept
    in the filer KV space as `notification.conf`)."""
    conf = dict(conf)
    kind = conf.pop("kind", "")
    if not kind:
        raise KeyError("notification config missing 'kind'")
    return make_queue(kind, **conf)


def attach_notifier(filer, q: NotificationQueue,
                    path_prefix: str = "/") -> threading.Thread:
    """Subscribe to a Filer's in-process metadata log and publish every
    event under path_prefix to the queue (filer_notify.go
    EventNotify's publish side). Returns the daemon pump thread."""
    sid, sub_q = filer.meta_log.subscribe()
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            try:
                ev = sub_q.get(timeout=0.25)
            except queue.Empty:
                continue
            d = ev["directory"]
            if not (d + "/").startswith(path_prefix.rstrip("/") + "/"):
                continue
            key = ((ev.get("new_entry") or ev.get("old_entry") or
                    {}).get("full_path", d))
            try:
                q.send(key, ev)
            except Exception:
                pass

    t = threading.Thread(target=pump, daemon=True)
    t.stop_event = stop  # cooperative stop handle
    t.start()
    return t
