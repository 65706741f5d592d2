"""Tiny SELECT parser for the S3 SelectObjectContent subset; the
counterpart of seaweedfs_tpu/query/sql.py.

The reference wires amazon's S3 Select shape through
s3api (POST ?select&select-type=2) down to the volume Query rpc; its
supported expressions are of the form

    SELECT * FROM S3Object
    SELECT s.field1, s.nested.f2 FROM S3Object s WHERE s.x = 'v'

This parses exactly that: a projection list, an optional alias, and an
optional single WHERE comparison (=, !=, >, <, >=, <=). Anything
fancier raises ValueError — matching the reference's "unsupported sql"
errors rather than guessing.
"""
from __future__ import annotations

import re

from .json_query import OPS, Filter

_SELECT_RE = re.compile(
    r"^\s*select\s+(?P<sel>.+?)\s+from\s+s3object(\s*\[\s*(?P<ba>\w+)"
    r"\s*\]|\s+as\s+(?P<asal>\w+)|\s+(?P<al>\w+))?"
    r"(\s+where\s+(?P<where>.+?))?\s*;?\s*$",
    re.IGNORECASE | re.DOTALL)

_WHERE_RE = re.compile(
    r"^\s*(?P<field>[\w.]+)\s*(?P<op>!=|>=|<=|=|>|<)\s*"
    r"(?P<val>'[^']*'|\"[^\"]*\"|[\w.+-]+)\s*$")


def parse_select(expression: str) -> tuple[list[str], Filter]:
    """SQL text -> (selections, filter). Raises ValueError on anything
    outside the supported subset."""
    m = _SELECT_RE.match(expression)
    if not m:
        raise ValueError(f"unsupported sql: {expression!r}")
    alias = m.group("ba") or m.group("asal") or m.group("al") or ""

    def strip_alias(field: str) -> str:
        if alias and field.lower().startswith(alias.lower() + "."):
            return field[len(alias) + 1:]
        if field.lower().startswith("s3object."):
            return field[len("s3object."):]
        return field

    sel_raw = m.group("sel").strip()
    if sel_raw == "*":
        selections: list[str] = []
    else:
        selections = []
        for part in sel_raw.split(","):
            part = part.strip()
            if not re.fullmatch(r"[\w.]+", part):
                raise ValueError(
                    f"unsupported projection: {part!r}")
            selections.append(strip_alias(part))

    filt = Filter()
    where = m.group("where")
    if where:
        wm = _WHERE_RE.match(where)
        if not wm:
            raise ValueError(f"unsupported where clause: {where!r}")
        val = wm.group("val")
        if val[:1] in "'\"":
            val = val[1:-1]
        op = wm.group("op")
        if op not in OPS:
            raise ValueError(f"unsupported operand {op!r}")
        filt = Filter(field=strip_alias(wm.group("field")), op=op,
                      value=val)
    return selections, filt
