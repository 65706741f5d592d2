"""ArangoDB filer store over the raw HTTP API (documents + AQL).

The slot of SeaweedFS weed/filer/arangodb/arangodb_store.go:23
with plain HTTP instead of the go-driver — REST store family #8.
Reference model preserved:

* a collection per bucket for paths under /buckets/<name> (collection
  name mangled to arango's charset), everything else in
  `seaweed_no_bucket`; KV pairs in `seaweed_kvmeta`
  (arangodb_store_bucket.go / helpers.go extractBucket),
* document _key = md5(full path), fields directory / name / meta,
* listings and subtree deletes are AQL over the `directory` field.

One deliberate divergence: `meta` is base64 text, not the reference's
[]uint64 chunking (helpers.go bytesToArray works around a go-driver
binary-marshal limitation that plain JSON doesn't have).

The port's copy of seaweedfs_tpu/filer/arangodb_store.py: the same
collections, keys, AQL and documents, over rpc/httpclient instead of
`requests`.
"""
from __future__ import annotations

import base64
import hashlib
import json

from ..rpc.httpclient import SharedSession
from .entry import Entry
from .filerstore import FilerStore, _norm, register_store

DEFAULT_COLLECTION = "seaweed_no_bucket"
KV_COLLECTION = "seaweed_kvmeta"
BUCKET_PREFIX = "/buckets/"


def _key_of(path: str) -> str:
    return hashlib.md5(path.encode()).hexdigest()


def _collection_of(path: str) -> str:
    """Paths INSIDE a bucket get the bucket's collection; the bucket
    directory entry itself stays in the default collection (helpers.go
    extractBucket requires >= 3 slashes for exactly this reason: the
    /buckets listing must find the bucket entries)."""
    if not path.startswith(BUCKET_PREFIX):
        return DEFAULT_COLLECTION
    bucket, _, rest = path[len(BUCKET_PREFIX):].partition("/")
    if not bucket or not rest:
        return DEFAULT_COLLECTION
    safe = "".join(c if c.isalnum() or c in "_-" else
                   f"_{ord(c):02x}" for c in bucket)
    return f"seaweedfs_{safe}"


@register_store("arangodb")
class ArangodbStore(FilerStore):
    """`-store=arangodb -store.host=... -store.port=8529
    -store.database=seaweedfs` (optional -store.user/-store.password
    for basic auth)."""

    name = "arangodb"

    def __init__(self, host: str = "127.0.0.1", port: int = 8529,
                 database: str = "seaweedfs", user: str = "",
                 username: str = "", password: str = "", **_):
        self.base = f"http://{host}:{int(port)}/_db/{database}"
        self._sess = SharedSession()
        username = user or username
        if username:
            self._sess.auth = (username, password)
        self._collections: set[str] = set()
        self._ensure_collection(KV_COLLECTION)  # fail fast too
        self._ensure_collection(DEFAULT_COLLECTION)

    # -- plumbing -------------------------------------------------------
    def _ensure_collection(self, name: str) -> None:
        if name in self._collections:
            return
        r = self._sess.post(f"{self.base}/_api/collection",
                            json={"name": name}, timeout=30)
        if r.status_code not in (200, 409):  # 409 = already exists
            r.raise_for_status()
        self._collections.add(name)

    def _aql(self, query: str, bind: dict) -> list:
        r = self._sess.post(f"{self.base}/_api/cursor",
                            json={"query": query, "bindVars": bind,
                                  "batchSize": 1000}, timeout=60)
        r.raise_for_status()
        d = r.json()
        out = list(d.get("result", []))
        while d.get("hasMore"):
            r = self._sess.put(
                f"{self.base}/_api/cursor/{d['id']}", timeout=60)
            r.raise_for_status()
            d = r.json()
            out.extend(d.get("result", []))
        return out

    # -- entries --------------------------------------------------------
    def insert_entry(self, entry: Entry) -> None:
        path = _norm(entry.full_path)
        d, n = entry.dir_and_name
        coll = _collection_of(path)
        self._ensure_collection(coll)
        doc = {"_key": _key_of(path), "directory": _norm(d), "name": n,
               "meta": base64.b64encode(json.dumps(
                   entry.to_dict()).encode()).decode()}
        r = self._sess.post(
            f"{self.base}/_api/document/{coll}",
            params={"overwriteMode": "replace"}, json=doc, timeout=30)
        r.raise_for_status()

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry | None:
        path = _norm(path)
        r = self._sess.get(
            f"{self.base}/_api/document/{_collection_of(path)}/"
            f"{_key_of(path)}", timeout=30)
        if r.status_code == 404:
            return None
        r.raise_for_status()
        return Entry.from_dict(json.loads(
            base64.b64decode(r.json()["meta"])))

    def delete_entry(self, path: str) -> None:
        path = _norm(path)
        r = self._sess.delete(
            f"{self.base}/_api/document/{_collection_of(path)}/"
            f"{_key_of(path)}", timeout=30)
        if r.status_code not in (200, 202, 404):
            r.raise_for_status()
        # a bucket-level directory owns a whole collection: drop it
        # with the bucket (the reference's OnBucketDeletion; the
        # elastic sibling drops its index the same way) or dead
        # collections accumulate under churn
        inner = _collection_of(path + "/x")
        if inner != DEFAULT_COLLECTION and \
                _collection_of(path) == DEFAULT_COLLECTION:
            r = self._sess.delete(
                f"{self.base}/_api/collection/{inner}", timeout=30)
            if r.status_code not in (200, 404):
                r.raise_for_status()
            self._collections.discard(inner)

    def delete_folder_children(self, path: str) -> None:
        path = _norm(path)
        like = path.rstrip("/") + "/"
        # one AQL REMOVE per affected collection sweeps the subtree
        # (the reference's deleteFolderChildren query,
        # arangodb_store.go:268-282); names are backtick-quoted like
        # the reference's — bucket names with '-' are valid AQL
        # operators otherwise
        for coll in self._subtree_collections(path):
            self._aql(
                f"FOR d IN `{coll}` FILTER d.directory == @dir OR "
                f"STARTS_WITH(d.directory, @pfx) REMOVE d IN `{coll}`",
                {"dir": path, "pfx": like})

    def _subtree_collections(self, path: str) -> list[str]:
        if path == "/" or path == BUCKET_PREFIX.rstrip("/"):
            # the subtree may span every bucket collection
            r = self._sess.get(f"{self.base}/_api/collection",
                               timeout=30)
            r.raise_for_status()
            return sorted(
                c["name"] for c in r.json().get("result", [])
                if c["name"].startswith("seaweedfs_") or
                c["name"] == DEFAULT_COLLECTION)
        # children of a bucket DIRECTORY live in the bucket collection
        # even though the dir entry itself sits in the default one
        return [_collection_of(path.rstrip("/") + "/x")]

    def list_directory_entries(self, dirpath: str, start_from: str = "",
                               inclusive: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        dirpath = _norm(dirpath)
        # listing DIR contents = entries whose collection is keyed by
        # a child path (the bucket dir itself lists into its bucket)
        coll = _collection_of(dirpath.rstrip("/") + "/x")
        self._ensure_collection(coll)
        q = f"FOR d IN `{coll}` FILTER d.directory == @dir"
        bind: dict = {"dir": dirpath, "limit": limit}
        if start_from:
            q += f" FILTER d.name {'>=' if inclusive else '>'} @start"
            bind["start"] = start_from
        if prefix:
            q += " FILTER STARTS_WITH(d.name, @prefix)"
            bind["prefix"] = prefix
        q += " SORT d.name ASC LIMIT @limit RETURN d"
        rows = self._aql(q, bind)
        return [Entry.from_dict(json.loads(base64.b64decode(r["meta"])))
                for r in rows]

    # -- kv -------------------------------------------------------------
    def kv_put(self, key: str, value: bytes) -> None:
        doc = {"_key": _key_of(key),
               "value": base64.b64encode(value).decode()}
        r = self._sess.post(
            f"{self.base}/_api/document/{KV_COLLECTION}",
            params={"overwriteMode": "replace"}, json=doc, timeout=30)
        r.raise_for_status()

    def kv_get(self, key: str) -> bytes | None:
        r = self._sess.get(
            f"{self.base}/_api/document/{KV_COLLECTION}/{_key_of(key)}",
            timeout=30)
        if r.status_code == 404:
            return None
        r.raise_for_status()
        return base64.b64decode(r.json()["value"])

    def kv_delete(self, key: str) -> None:
        r = self._sess.delete(
            f"{self.base}/_api/document/{KV_COLLECTION}/{_key_of(key)}",
            timeout=30)
        if r.status_code not in (200, 202, 404):
            r.raise_for_status()

    def close(self) -> None:
        self._sess.close()
