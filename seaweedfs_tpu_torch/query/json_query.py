"""JSON document projection + filtering; the counterpart of
seaweedfs_tpu/query/json_query.py.

Equivalent of SeaweedFS weed/query/json/query_json.go: documents
are JSON objects (one per line for NDJSON payloads, or a single
object/array per object body); `selections` projects top-level or
dotted-path fields; `Filter` compares one field against a constant with
the reference's operand set (=, !=, >, <, >=, <=).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Iterator

OPS = ("=", "!=", ">=", "<=", ">", "<")


@dataclass
class Filter:
    field: str = ""
    op: str = "="
    value: str = ""

    def matches(self, doc: dict) -> bool:
        if not self.field:
            return True
        got = get_path(doc, self.field)
        if got is None:
            return False
        want: Any = self.value
        if isinstance(got, bool):
            want = self.value.lower() in ("true", "1")
        elif isinstance(got, (int, float)):
            # compare numerically without truncating the constant:
            # int(29.5) would make `age >= 29.5` match age=29
            try:
                want = float(self.value)
            except ValueError:
                return False
        if self.op == "=":
            return got == want
        if self.op == "!=":
            return got != want
        try:
            if self.op == ">":
                return got > want
            if self.op == "<":
                return got < want
            if self.op == ">=":
                return got >= want
            if self.op == "<=":
                return got <= want
        except TypeError:
            return False
        raise ValueError(f"bad operand {self.op!r} (want one of {OPS})")


def get_path(doc: Any, path: str) -> Any:
    """Dotted-path lookup: "a.b.c" -> doc["a"]["b"]["c"] (None when any
    hop is missing or not an object)."""
    cur = doc
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def project(doc: dict, selections: list[str]) -> dict:
    if not selections or selections == ["*"]:
        return doc
    out = {}
    for sel in selections:
        v = get_path(doc, sel)
        if v is not None:
            out[sel] = v
    return out


def query_json_doc(doc: Any, selections: list[str],
                   filt: Filter | None = None) -> Iterator[dict]:
    """Query one parsed JSON value; a top-level array queries each
    element (query_json.go iterates arrays)."""
    filt = filt or Filter()
    docs = doc if isinstance(doc, list) else [doc]
    for d in docs:
        if isinstance(d, dict) and filt.matches(d):
            yield project(d, selections)


def query_json_bytes(data: bytes, selections: list[str],
                     filt: Filter | None = None) -> Iterator[dict]:
    """Query a raw object body: NDJSON (one doc per line) or a single
    JSON document/array."""
    text = data.decode("utf-8", "replace").strip()
    if not text:
        return
    if text.startswith(("[", "{")):
        # try the whole body as one document first: a pretty-printed
        # (multi-line) object must not fall through to line mode where
        # every line would fail to parse and be silently skipped.
        # NDJSON can't parse as a single document, so this is exact.
        try:
            doc = json.loads(text)
        except json.JSONDecodeError:
            pass
        else:
            yield from query_json_doc(doc, selections, filt)
            return
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except json.JSONDecodeError:
            continue  # reference skips unparseable lines
        yield from query_json_doc(doc, selections, filt)
