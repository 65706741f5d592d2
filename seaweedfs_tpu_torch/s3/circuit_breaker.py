"""S3 gateway circuit breaker; the counterpart of
seaweedfs_tpu/s3/circuit_breaker.py.

Equivalent of SeaweedFS weed/s3api/s3api_circuit_breaker.go: caps
concurrent requests and in-flight upload bytes, globally and per
bucket, split by read / write action. When a limit trips the request
is rejected with 503 TooManyRequests instead of letting a burst take
the gateway (and the filer behind it) down.

Config shape (kept in the filer KV under `s3/circuit_breaker` and
reloaded with the identities; the reference's SeaweedFS keeps it at
/etc/s3/circuit_breaker.json):

    {"global": {"readCount": 64, "writeCount": 32,
                "writeBytes": 268435456},
     "buckets": {"media": {"writeCount": 4}}}

Absent keys mean unlimited (off by default).
"""
from __future__ import annotations

import threading

LIMIT_KEYS = ("readCount", "writeCount", "readBytes", "writeBytes")


class CircuitOpen(Exception):
    def __init__(self, scope: str, what: str):
        super().__init__(f"{scope} {what} limit reached")
        self.scope = scope
        self.what = what


class _Counters:
    __slots__ = ("read_count", "write_count", "read_bytes",
                 "write_bytes")

    def __init__(self):
        self.read_count = 0
        self.write_count = 0
        self.read_bytes = 0
        self.write_bytes = 0


class CircuitBreaker:
    def __init__(self, config: dict | None = None):
        self._lock = threading.Lock()
        self._global = _Counters()
        self._buckets: dict[str, _Counters] = {}
        self.config: dict = {}
        self.load_config(config or {})

    def load_config(self, config: dict) -> None:
        with self._lock:
            self.config = config or {}

    @property
    def enabled(self) -> bool:
        return bool(self.config.get("global")
                    or self.config.get("buckets"))

    def _limits(self, bucket: str) -> list[tuple[str, dict, _Counters]]:
        out = [("global", self.config.get("global") or {}, self._global)]
        bconf = (self.config.get("buckets") or {}).get(bucket)
        if bconf:
            counters = self._buckets.setdefault(bucket, _Counters())
            out.append((f"bucket {bucket}", bconf, counters))
        return out

    def acquire(self, action: str, bucket: str, nbytes: int = 0):
        """-> context manager guarding one request. `action` is "read"
        or "write"; raises CircuitOpen when a limit would be exceeded."""
        return _Guard(self, action, bucket, nbytes)


class _Guard:
    def __init__(self, cb: CircuitBreaker, action: str, bucket: str,
                 nbytes: int):
        self.cb = cb
        self.action = "write" if action == "write" else "read"
        self.bucket = bucket
        self.nbytes = max(0, nbytes)
        self._held: list[_Counters] = []

    def __enter__(self):
        cb = self.cb
        with cb._lock:
            if not cb.enabled:
                return self
            count_key = f"{self.action}Count"
            bytes_key = f"{self.action}Bytes"
            scopes = cb._limits(self.bucket)
            for scope, conf, counters in scopes:
                limit = conf.get(count_key)
                inflight = getattr(counters, f"{self.action}_count")
                if limit is not None and inflight + 1 > limit:
                    raise CircuitOpen(scope, count_key)
                blimit = conf.get(bytes_key)
                bheld = getattr(counters, f"{self.action}_bytes")
                if blimit is not None and bheld + self.nbytes > blimit:
                    raise CircuitOpen(scope, bytes_key)
            for _scope, _conf, counters in scopes:
                setattr(counters, f"{self.action}_count",
                        getattr(counters, f"{self.action}_count") + 1)
                setattr(counters, f"{self.action}_bytes",
                        getattr(counters, f"{self.action}_bytes")
                        + self.nbytes)
                self._held.append(counters)
        return self

    def __exit__(self, *exc):
        with self.cb._lock:
            for counters in self._held:
                setattr(counters, f"{self.action}_count",
                        getattr(counters, f"{self.action}_count") - 1)
                setattr(counters, f"{self.action}_bytes",
                        getattr(counters, f"{self.action}_bytes")
                        - self.nbytes)
            self._held.clear()
        return False
