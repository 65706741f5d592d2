"""Shared filer metadata-subscription pump; the counterpart of
seaweedfs_tpu/rpc/meta_subscriber.py, on threads over rpc/websocket.py
instead of an asyncio loop over aiohttp.

One implementation of the reconnecting websocket consumer that the
remote-mount workers (remote_storage/sync.py, gateway.py) and
`filer.meta.tail` need (the reference's filer_pb.SubscribeMetadata
client loop): a pump thread reads the filer's /ws/meta_subscribe stream
(answering its pings) and queues each event; a worker thread runs the
handler on them in order, so blocking IO in a handler never stalls the
stream. Each (re)connect resumes from `since_fn()`, read once the
worker has handled every queued event, so no event is skipped or
handled twice across a reconnect.

`stop(timeout)` returns within its timeout even on an idle stream: it
shuts the socket down, which ends a blocked receive at once, and the
pump's socket also reads with a RECEIVE_TIMEOUT.
"""
from __future__ import annotations

import json
import queue
import socket
import threading
from typing import Callable
from urllib.parse import urlencode

from .websocket import WebSocket, connect

# read timeout of the stream's socket: how often an idle pump looks at
# its stop flag
RECEIVE_TIMEOUT = 1.0


class MetaSubscriber:
    def __init__(self, source_url: str, path_prefix: str,
                 handler: Callable[[dict], None],
                 since_fn: Callable[[], int] | None = None,
                 reconnect_delay: float = 0.5):
        """handler(event) is called for every event, in order, from a
        worker thread; since_fn() supplies the resume offset at each
        (re)connect."""
        self.source = source_url.rstrip("/") \
            if source_url.startswith("http") else f"http://{source_url}"
        self.prefix = path_prefix.rstrip("/") or "/"
        self.handler = handler
        self.since_fn = since_fn or (lambda: 0)
        self.reconnect_delay = reconnect_delay
        self._stop = threading.Event()
        self._events: queue.Queue = queue.Queue()
        self._ws: WebSocket | None = None
        self._ws_lock = threading.Lock()
        self._threads: list[threading.Thread] = []

    def start(self) -> None:
        self._stop.clear()
        self._events = queue.Queue()
        self._threads = [
            threading.Thread(target=self._pump, name="meta-sub-pump",
                             daemon=True),
            threading.Thread(target=self._work, name="meta-sub-worker",
                             daemon=True)]
        for t in self._threads:
            t.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        with self._ws_lock:
            ws = self._ws
        if ws is not None:
            ws.abort()
        self._events.put(None)          # wakes an idle worker
        for t in self._threads:
            t.join(timeout=timeout)

    def _work(self) -> None:
        while True:
            ev = self._events.get()
            try:
                if ev is None or self._stop.is_set():
                    return
                self.handler(ev)
            except Exception:  # noqa: BLE001 — a handler's failure
                pass           # must not end the stream
            finally:
                self._events.task_done()

    def _pump(self) -> None:
        ws_url = self.source.replace("http", "ws", 1) + \
            "/ws/meta_subscribe"
        while not self._stop.is_set():
            try:
                # every queued event handled first: the offset is then
                # the last one the handler saw
                while self._events.unfinished_tasks:
                    if self._stop.wait(0.01):
                        return
                since = self.since_fn()
                ws = connect(ws_url + "?" + urlencode(
                    {"path_prefix": self.prefix, "since_ns": str(since)}),
                    timeout=RECEIVE_TIMEOUT)
                with self._ws_lock:
                    self._ws = ws
                try:
                    self._read(ws)
                finally:
                    with self._ws_lock:
                        self._ws = None
                    ws.abort()
                    ws.sock.close()
            except Exception:  # noqa: BLE001 — the filer is down or
                pass           # restarting: reconnect below
            self._stop.wait(self.reconnect_delay)

    def _read(self, ws: WebSocket) -> None:
        while not self._stop.is_set():
            try:
                msg = ws.receive()
            except socket.timeout:
                continue        # idle stream: look at the stop flag
            if not isinstance(msg, str):
                return          # closed, or a binary frame: reconnect
            self._events.put(json.loads(msg))
