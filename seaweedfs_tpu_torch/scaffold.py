"""`scaffold` — print starter config templates; the counterpart of
seaweedfs_tpu/scaffold.py.

Equivalent of SeaweedFS weed/command/scaffold.go +
command/scaffold/*.toml: `weed scaffold -config=filer|master|security|
replication|notification|s3|shell` prints an annotated template the
operator copies into place. The reference's TOML templates carry
comments; these are JSON (what the servers and the filer KV actually
consume), so the annotations live in "//" keys — every template is
valid JSON that the consumers accept as-is (unknown keys are ignored).
"""
from __future__ import annotations

import json

TEMPLATES: dict[str, dict] = {
    "filer": {
        "//": "filer store selection: pass as `filer -store=... "
              "-store.path=...`. Stores: memory (ephemeral), sqlite "
              "(single file), leveldb (weedkv LSM directory). Per-path "
              "rules live IN the filer: `fs.configure` in the shell.",
        "store": "leveldb",
        "store.path": "/var/lib/seaweedfs/filerdb",
    },
    "master": {
        "//": "master flags, incl. periodic maintenance scripts the "
              "leader runs (master.toml [master.maintenance] "
              "equivalent)",
        "volumeSizeLimitMB": 30720,
        "defaultReplication": "000",
        "admin.scripts":
            "volume.vacuum; volume.fix.replication; ec.rebuild",
        "admin.scriptInterval": 1800,
    },
    "security": {
        "//": "shared JWT secret: volume servers verify write tokens "
              "minted by the master (security.toml jwt.signing "
              "equivalent). Empty disables auth. The https section "
              "(security.toml [https.*] equivalent) enables TLS on "
              "control/gateway listeners when passed via the global "
              "-security flag; ca + client_auth turns on mutual TLS.",
        "jwt.secret": "change-me",
        "https": {"cert": "", "key": "", "ca": "",
                  "client_auth": False},
    },
    "replication": {
        "//": "sink for `filer.replicate` (replication.toml "
              "equivalent)",
        "sink": "s3:https://s3.example.com,backup-bucket,prefix/",
        "alternatives": ["local:/mnt/backup",
                         "filer:http://other:8888,/"],
    },
    "notification": {
        "//": "metadata-event fanout targets (notification.toml "
              "equivalent)",
        "enabled": ["log"],
        "queues": {"log": {}, "memory": {}},
    },
    "s3": {
        "//": "identities: store at filer KV key s3/identities (or "
              "pass -config); circuit-breaker limits: filer KV key "
              "s3/circuit_breaker",
        "identities": [
            {"name": "admin",
             "credentials": [{"accessKey": "AK", "secretKey": "SK"}],
             "actions": ["Admin", "Read", "Write", "List", "Tagging"]},
        ],
        "circuit_breaker": {
            "global": {"readCount": 1024, "writeCount": 512,
                       "writeBytes": 1073741824},
            "buckets": {},
        },
    },
    "shell": {
        "//": "defaults for the admin shell (shell.toml equivalent)",
        "master": "http://127.0.0.1:9333",
        "filer": "http://127.0.0.1:8888",
    },
}


def scaffold(config: str) -> str:
    if config not in TEMPLATES:
        raise KeyError(
            f"unknown config {config!r}; have {sorted(TEMPLATES)}")
    return json.dumps(TEMPLATES[config], indent=2) + "\n"
