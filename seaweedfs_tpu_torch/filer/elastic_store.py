"""Elasticsearch 7 filer store over the raw REST API.

The slot of SeaweedFS weed/filer/elastic/v7/elastic_store.go:30
with plain HTTP instead of olivere/elastic — wire protocol #7 in this
tree. Same data model as the reference:

* one index per top-level directory: `.seaweedfs_<bucket>` (documents
  of deeper paths land in their bucket's index; the two-segment root
  level lives in `.seaweedfs_`),
* document id = md5(full path), with `ParentId` = md5(parent dir) for
  listing; this build adds a keyword `Name` field so listings are a
  proper term-filter + range + sort instead of client-side paging,
* KV entries in `.seaweedfs_kv_entries` with base64 values,
* deleting a bucket directory drops its whole index
  (elastic_store.go:163 deleteIndex).

Writes use `refresh=true` so the filer's read-your-writes contract
holds (the reference calls Refresh before every list instead).

The port's copy of seaweedfs_tpu/filer/elastic_store.py: the same
indices, document ids and bodies, over rpc/httpclient instead of
`requests`.
"""
from __future__ import annotations

import base64
import hashlib
import json
import urllib.parse

from ..rpc.httpclient import SharedSession
from .entry import Entry
from .filerstore import (FilerStore, _delete_subtree_by_walk, _norm,
                         _split, register_store)

INDEX_PREFIX = ".seaweedfs_"
KV_INDEX = ".seaweedfs_kv_entries"


def _md5(s: str) -> str:
    return hashlib.md5(s.encode()).hexdigest()


def _index_of(path: str, is_directory: bool) -> str:
    parts = path.split("/")
    if is_directory and len(parts) >= 2 and parts[1]:
        return INDEX_PREFIX + parts[1].lower()
    if len(parts) > 2:
        return INDEX_PREFIX + parts[1].lower()
    return INDEX_PREFIX


@register_store("elastic")
@register_store("elastic7")
class ElasticStore(FilerStore):
    """`-store=elastic -store.host=... -store.port=9200` (optional
    -store.user/-store.password for basic auth)."""

    name = "elastic7"

    def __init__(self, host: str = "127.0.0.1", port: int = 9200,
                 user: str = "", username: str = "",
                 password: str = "", max_page: int = 10000, **_):
        self.base = f"http://{host}:{int(port)}"
        self.max_page = max_page
        self._sess = SharedSession()
        username = user or username
        if username:
            self._sess.auth = (username, password)
        # fail fast + ensure the KV index exists (initialize())
        r = self._sess.head(f"{self.base}/{KV_INDEX}", timeout=10)
        if r.status_code == 404:
            self._sess.put(f"{self.base}/{KV_INDEX}", json={
                "mappings": {"properties": {
                    "Value": {"type": "binary"}}}},
                timeout=30).raise_for_status()
        elif r.status_code >= 500:
            r.raise_for_status()

    # -- plumbing -------------------------------------------------------
    def _doc_url(self, index: str, doc_id: str) -> str:
        return (f"{self.base}/{urllib.parse.quote(index)}/_doc/"
                f"{urllib.parse.quote(doc_id)}")

    # -- entries --------------------------------------------------------
    def insert_entry(self, entry: Entry) -> None:
        path = _norm(entry.full_path)
        d, n = entry.dir_and_name
        doc = {"ParentId": _md5(_norm(d)), "Name": n,
               "Entry": entry.to_dict()}
        r = self._sess.put(
            self._doc_url(_index_of(path, False), _md5(path)),
            params={"refresh": "true"}, json=doc, timeout=30)
        r.raise_for_status()

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry | None:
        path = _norm(path)
        r = self._sess.get(
            self._doc_url(_index_of(path, False), _md5(path)),
            timeout=30)
        if r.status_code == 404:
            return None
        r.raise_for_status()
        doc = r.json()
        if not doc.get("found"):
            return None
        return Entry.from_dict(doc["_source"]["Entry"])

    def delete_entry(self, path: str) -> None:
        path = _norm(path)
        if path.count("/") == 1 and path != "/":
            # a bucket-level directory owns a whole index: drop it
            # (elastic_store.go:163 deleteIndex)
            r = self._sess.delete(
                f"{self.base}/{urllib.parse.quote(_index_of(path, True))}",
                timeout=60)
            if r.status_code not in (200, 404):
                r.raise_for_status()
            return
        r = self._sess.delete(
            self._doc_url(_index_of(path, False), _md5(path)),
            params={"refresh": "true"}, timeout=30)
        if r.status_code not in (200, 404):
            r.raise_for_status()

    def delete_folder_children(self, path: str) -> None:
        # ParentId-walk the subtree via the shared helper (the
        # reference lists and deletes one level, leaving recursion to
        # its filer; this tree's store contract is whole-subtree)
        _delete_subtree_by_walk(self, path, page=self.max_page)

    def delete_directory_range(self, d: str) -> None:
        # writes use refresh=true (read-your-writes), so re-listing
        # after a deleted page always converges
        while True:
            batch = self.list_directory_entries(d, limit=self.max_page)
            if not batch:
                return
            for e in batch:
                self.delete_entry(d.rstrip("/") + "/" + e.name)

    def list_directory_entries(self, dirpath: str, start_from: str = "",
                               inclusive: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        dirpath = _norm(dirpath)
        index = _index_of(dirpath, True)
        filt: list[dict] = [{"term": {"ParentId": _md5(dirpath)}}]
        if start_from:
            op = "gte" if inclusive else "gt"
            filt.append({"range": {"Name": {op: start_from}}})
        if prefix:
            filt.append({"prefix": {"Name": prefix}})
        body = {"query": {"bool": {"filter": filt}},
                "sort": [{"Name": "asc"}],
                "size": min(limit, self.max_page)}
        r = self._sess.post(
            f"{self.base}/{urllib.parse.quote(index)}/_search",
            json=body, timeout=60)
        if r.status_code == 404:
            return []  # index not created yet: empty directory
        r.raise_for_status()
        hits = r.json().get("hits", {}).get("hits", [])
        return [Entry.from_dict(h["_source"]["Entry"]) for h in hits]

    # -- kv -------------------------------------------------------------
    def kv_put(self, key: str, value: bytes) -> None:
        r = self._sess.put(
            self._doc_url(KV_INDEX, _md5(key)),
            params={"refresh": "true"},
            json={"Value": base64.b64encode(value).decode()},
            timeout=30)
        r.raise_for_status()

    def kv_get(self, key: str) -> bytes | None:
        r = self._sess.get(self._doc_url(KV_INDEX, _md5(key)),
                           timeout=30)
        if r.status_code == 404:
            return None
        r.raise_for_status()
        doc = r.json()
        if not doc.get("found"):
            return None
        return base64.b64decode(doc["_source"]["Value"])

    def kv_delete(self, key: str) -> None:
        r = self._sess.delete(self._doc_url(KV_INDEX, _md5(key)),
                              params={"refresh": "true"}, timeout=30)
        if r.status_code not in (200, 404):
            r.raise_for_status()

    def close(self) -> None:
        self._sess.close()
