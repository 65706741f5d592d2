"""Filer-facing client for the mount: entry CRUD over the filer meta
HTTP API, chunk upload via master assign, chunk read via volume lookup,
plus the metadata subscription that keeps the local meta cache fresh;
the counterpart of seaweedfs_tpu/mount/filer_client.py, over
rpc/httpclient.

Equivalent of the mount's filer gRPC usage in SeaweedFS
weed/mount/weedfs.go + meta_cache/meta_cache_subscribe.go, carried over
this build's HTTP surface (filer `?meta=1` entry API, `mv.from` rename,
/ws/meta_subscribe).

The subscription runs on threads (rpc/meta_subscriber.MetaSubscriber
over rpc/websocket.py), where the reference runs aiohttp's websocket
on an asyncio loop and stops it by cancelling the task:
`stop_subscription` shuts the stream's socket down, so a blocked
receive returns at once instead of waiting for the next heartbeat. It
streams the events from the moment it starts (a reconnect resumes
after the last one handled), as SeaweedFS's mount does; the
reference's asks for none and gets the filer's whole buffered history,
which a fresh mount then replays over what it reads (weedfs.py).
"""
from __future__ import annotations

import json
import time

from ..filer.entry import Entry
from ..operation import verbs
from ..rpc.httpclient import session
from ..rpc.meta_subscriber import MetaSubscriber
from ..wdclient.client import MasterClient


class FilerClient:
    def __init__(self, filer_url: str, master_url: str | None = None,
                 collection: str = "", replication: str = ""):
        self.filer_url = filer_url.rstrip("/") \
            if filer_url.startswith("http") else f"http://{filer_url}"
        self.collection = collection
        self.replication = replication
        # master for chunk assign/lookup; discovered from the filer's
        # status if not given. The status also says whether the filer
        # encrypts its chunks (GetFilerConfiguration): a mount writing
        # plaintext into a ciphered namespace would leak data the
        # operator asked to encrypt — so this FAILS CLOSED: no /status
        # answer means no mount
        st = session().get(f"{self.filer_url}/status", timeout=10).json()
        if master_url is None:
            master_url = st.get("master", "")
        self.master_url = master_url
        self.cipher = bool(st.get("cipher", False))
        self.masters = MasterClient(master_url)
        self._subscriber: MetaSubscriber | None = None

    # -- entries --------------------------------------------------------
    def kv_get(self, key: str) -> bytes | None:
        r = session().get(f"{self.filer_url}/kv/{key}", timeout=30)
        return r.content if r.status_code == 200 else None

    def lookup_entry(self, path: str) -> Entry | None:
        r = session().get(f"{self.filer_url}{path}", params={"meta": "1"},
                          timeout=30)
        if r.status_code == 404:
            return None
        r.raise_for_status()
        return Entry.from_dict(r.json())

    def list_dir(self, path: str, limit: int = 1 << 20) -> list[Entry]:
        out: list[Entry] = []
        last = ""
        while True:
            r = session().get(f"{self.filer_url}{path or '/'}",
                              params={"limit": str(min(limit, 1024)),
                                      "lastFileName": last},
                              headers={"Accept": "application/json"},
                              timeout=30)
            if r.status_code == 404:
                return out
            r.raise_for_status()
            d = r.json()
            batch = [Entry.from_dict(e) for e in d.get("entries", [])]
            out.extend(batch)
            if not d.get("shouldDisplayLoadMore") or not batch or \
                    len(out) >= limit:
                return out[:limit]
            last = d.get("lastFileName", "")

    def save_entry(self, entry: Entry) -> None:
        r = session().put(f"{self.filer_url}{entry.full_path}",
                          params={"meta": "1"},
                          data=json.dumps(entry.to_dict()), timeout=60)
        r.raise_for_status()

    def mkdir(self, path: str) -> None:
        r = session().put(f"{self.filer_url}{path}", params={"mkdir": "1"},
                          timeout=30)
        r.raise_for_status()

    def delete(self, path: str, recursive: bool = False) -> None:
        r = session().delete(f"{self.filer_url}{path}",
                             params={"recursive": "true"} if recursive
                             else {}, timeout=60)
        if r.status_code not in (200, 204, 404):
            r.raise_for_status()

    def rename(self, old: str, new: str) -> None:
        r = session().put(f"{self.filer_url}{new}",
                          params={"mv.from": old}, timeout=60)
        r.raise_for_status()

    def link(self, src: str, dst: str) -> None:
        r = session().post(f"{self.filer_url}{dst}",
                           params={"link.from": src}, timeout=60)
        if r.status_code >= 300:
            raise OSError(r.status_code, r.text)

    # -- chunks ---------------------------------------------------------
    def upload_chunk(self, data: bytes,
                     name: str = "") -> tuple[str, str, bytes]:
        """-> (fid, etag, cipher_key): assign a fid at the master and
        upload the chunk bytes (ciphertext when the filer runs
        -encryptVolumeData) to its volume server."""
        ckey = b""
        if self.cipher:
            from ..utils import cipher as cip

            ckey = cip.gen_cipher_key()
            data = cip.encrypt(data, ckey)
        a = verbs.assign(self.master_url, collection=self.collection,
                         replication=self.replication)
        body = verbs.upload(a, data, name=name)
        return a.fid, body.get("eTag", ""), ckey

    def read_chunk(self, fid: str, cipher_key: bytes = b"") -> bytes:
        data = verbs.download(self.masters.lookup_file_id(fid))
        if cipher_key:
            from ..utils import cipher as cip

            data = cip.decrypt(data, cipher_key)
        return data

    def read_chunk_range(self, fid: str, offset: int,
                         size: int) -> bytes:
        """Exactly [offset, offset+size) of one plain chunk — the
        random-read path, no whole-chunk amplification (the volume
        front serves ranges natively)."""
        from ..filer.stream import read_fid

        return read_fid(self.masters.lookup_file_id, fid, offset, size)

    # -- metadata subscription (meta_cache_subscribe.go) ----------------
    def subscribe_meta(self, prefix: str, on_event) -> None:
        """Start background threads feeding filer metadata events
        (create/update/delete/rename) for paths under `prefix` from now
        on to on_event(event_dict), in order. Used to invalidate the
        meta cache when other clients change the namespace."""
        self.stop_subscription()
        since = [time.time_ns()]

        def handle(ev: dict) -> None:
            since[0] = max(since[0], int(ev.get("ts_ns", 0)))
            on_event(ev)

        self._subscriber = MetaSubscriber(self.filer_url, prefix, handle,
                                          since_fn=lambda: since[0])
        self._subscriber.start()

    def stop_subscription(self) -> None:
        sub, self._subscriber = self._subscriber, None
        if sub is not None:
            sub.stop(timeout=5)
