"""Per-path storage rules (`filer.conf`); the counterpart of
seaweedfs_tpu/filer/filer_conf.py, copied as is.

Equivalent of SeaweedFS weed/filer/filer_conf.go: a set of
location-prefix rules, each carrying storage options (collection,
replication, ttl, fsync, read-only, max file-name length, disk type).
The filer consults the longest matching prefix on every write
(detectStorageOption, filer_server_handlers_write.go:219) so operators
can pin `/buckets/media/` to its own collection, force a TTL under
`/tmp/`, or mark a subtree read-only without touching clients.

The rules live in the filer store's KV space under `filer.conf`
(JSON), as in the reference package: replicated with the metadata
store, hot-editable, no server restart.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

CONF_KEY = "filer.conf"


@dataclass
class PathConf:
    """One rule. Empty string / zero fields mean "no opinion" and fall
    through to the filer's own defaults (filer_conf.go PathConf)."""

    location_prefix: str = "/"
    collection: str = ""
    replication: str = ""
    ttl: str = ""
    disk_type: str = ""
    fsync: bool = False
    read_only: bool = False
    max_file_name_length: int = 0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PathConf":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__
                      if k in d})


@dataclass
class FilerConf:
    rules: list[PathConf] = field(default_factory=list)

    # -- serialization --------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {"rules": [r.to_dict() for r in self.rules]}, indent=1)

    @classmethod
    def from_json(cls, raw: str | bytes) -> "FilerConf":
        d = json.loads(raw) if raw else {}
        return cls(rules=[PathConf.from_dict(r)
                          for r in d.get("rules", [])])

    # -- rule editing (fs.configure) ------------------------------------
    def set_rule(self, rule: PathConf) -> None:
        """Insert or replace the rule for rule.location_prefix."""
        self.rules = [r for r in self.rules
                      if r.location_prefix != rule.location_prefix]
        self.rules.append(rule)
        self.rules.sort(key=lambda r: r.location_prefix)

    def delete_rule(self, location_prefix: str) -> bool:
        before = len(self.rules)
        self.rules = [r for r in self.rules
                      if r.location_prefix != location_prefix]
        return len(self.rules) != before

    # -- matching -------------------------------------------------------
    def match(self, path: str) -> PathConf:
        """Merged storage options for `path`: rules are applied from the
        shortest matching prefix to the longest, so the most specific
        rule wins per field (filer_conf.go MatchStorageRule trie walk),
        while unset fields inherit from broader rules."""
        merged = PathConf(location_prefix=path)
        for rule in sorted(self.rules,
                           key=lambda r: len(r.location_prefix)):
            p = rule.location_prefix
            if path == p or path.startswith(p if p.endswith("/")
                                            else p + "/"):
                _overlay(merged, rule)
        return merged


def _overlay(base: PathConf, over: PathConf) -> None:
    if over.collection:
        base.collection = over.collection
    if over.replication:
        base.replication = over.replication
    if over.ttl:
        base.ttl = over.ttl
    if over.disk_type:
        base.disk_type = over.disk_type
    if over.fsync:
        base.fsync = True
    if over.read_only:
        base.read_only = True
    if over.max_file_name_length:
        base.max_file_name_length = over.max_file_name_length
