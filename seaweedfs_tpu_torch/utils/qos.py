"""Per-tenant edge QoS: token-bucket admission and deadline-aware
shedding; the counterpart of seaweedfs_tpu/utils/qos.py.

An overloaded S3 or filer gateway that accepts every request queues work
until deadlines expire en masse, and one greedy tenant takes the
well-behaved ones down with it. This is the admission layer both
gateways share:

* **Tenant buckets.** One reservation-style ``ratelimit.TokenBucket``
  per tenant (tenant = S3 access key at the S3 front, first path
  segment at the filer). Cardinality is BOUNDED: at most
  ``max_tenants`` distinct buckets; later arrivals share one
  ``__overflow__`` bucket, so a tenant-id spray can neither exhaust
  gateway memory nor explode the ``tenant`` metric label.
* **Pacing.** Admission quotes a pacing delay from ``bucket.reserve``;
  the middleware sleeps it on the request's own handler thread (the
  port's servers run one thread per connection, where the reference
  awaits ``asyncio.sleep`` on its event loop), so a paced request
  holds up no other request.
* **Deadline-aware shedding.** If the quoted queue delay exceeds the
  request's remaining ``X-Sw-Deadline`` budget the work is doomed to
  504 anyway — shed it NOW as 503 + ``Retry-After`` carrying the
  ``X-Sw-Retryable`` attestation (zero work done, safe to replay),
  and un-debit the reservation. Likewise when the delay exceeds
  ``max_delay``, the bound on acceptable queueing.
* **Weighted priority.** A tenant's ``priority`` divides the bytes
  charged per request: priority 2 pays half price for the same rate.

Config arrives via ``-qos.*`` flags and an optional JSON spec
(``-qos.spec``), reloaded when its mtime changes:

    {"default": {"rate": 2e6, "burst": 4e6, "priority": 1},
     "tenants": {"alice": {"rate": 8e6, "priority": 2}}}

Accounting lands in the metrics registry (``qos_shed_total{tenant,
reason}``, ``qos_admitted_total{tenant}``, ``qos_queue_delay_seconds``)
and is summarized at ``/debug/qos`` on both gateways and under ``Qos``
in the master's ``/cluster/status``. Per-tenant demand sketches become
the ``workload_tenant_*`` gauges of the gateways' /metrics, which the
master's federation scrape carries to master/workload.py's qos advisor.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time

from . import metrics
from . import sketch as _sketch
from .ratelimit import TokenBucket

OVERFLOW_TENANT = "__overflow__"
# floor charged per request (bytes): read/metadata ops carry no body
# but still cost a seek + a dispatch — shaping only writes would let
# a GET flood through unshaped
REQUEST_FLOOR = 4 << 10
# seconds between spec-file mtime checks (the hot-reload poll)
SPEC_CHECK_INTERVAL = 1.0


class Admission:
    """One admission verdict: either a pacing ``wait`` (admitted) or a
    ``shed_reason`` + ``retry_after`` hint (rejected, nothing owed)."""

    __slots__ = ("tenant", "wait", "shed_reason", "retry_after")

    def __init__(self, tenant: str, wait: float = 0.0,
                 shed_reason: str = "", retry_after: float = 0.0):
        self.tenant = tenant
        self.wait = wait
        self.shed_reason = shed_reason
        self.retry_after = retry_after

    @property
    def admitted(self) -> bool:
        return not self.shed_reason


class QosRegistry:
    """Bounded per-tenant bucket registry + admission policy."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.enabled = False
        self.default_rate = 0.0     # bytes/sec per tenant; 0 = off
        self.default_burst: float | None = None
        self.default_priority = 1.0
        self.max_tenants = 256
        self.max_delay = 2.0        # seconds of queueing before shed
        self.request_floor = REQUEST_FLOOR
        self.spec_path = ""
        self._spec_mtime: float | None = None
        self._spec_checked = 0.0
        # per-tenant overrides from the JSON spec
        self._overrides: dict[str, dict] = {}
        self._buckets: dict[str, TokenBucket] = {}
        self._priority: dict[str, float] = {}
        self._admitted: dict[str, int] = {}
        self._shed: dict[tuple[str, str], int] = {}
        # per-tenant demand sketches (inter-arrival gap, body bytes,
        # queue delay) — recorded whether or not shaping is enabled,
        # bounded by the same max_tenants/__overflow__ rule as buckets
        self._demand: dict[str, dict] = {}

    # -- config ---------------------------------------------------------

    def configure(self, enabled: bool | None = None,
                  rate: float | None = None,
                  burst: float | None = None,
                  max_tenants: int | None = None,
                  max_delay: float | None = None,
                  request_floor: int | None = None,
                  spec: str | None = None) -> None:
        """Apply -qos.* CLI flags (None = leave unchanged)."""
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if rate is not None:
                self.default_rate = float(rate)
            if burst is not None:
                self.default_burst = float(burst) if burst > 0 else None
            if max_tenants is not None:
                self.max_tenants = max(1, int(max_tenants))
            if max_delay is not None:
                self.max_delay = float(max_delay)
            if request_floor is not None:
                self.request_floor = max(1, int(request_floor))
            if spec is not None:
                self.spec_path = spec
                self._spec_mtime = None
                self._spec_checked = 0.0
            self._reconfigure_buckets_locked()
        if spec:
            self._maybe_reload_spec(force=True)

    def load_spec(self, spec: dict) -> None:
        """Hot-apply a JSON spec: {"default": {...}, "tenants":
        {name: {rate, burst, priority}}}. Existing buckets re-rate in
        place (waiters re-price, nothing is forgiven — see
        TokenBucket.configure)."""
        default = spec.get("default") or {}
        with self._lock:
            if "rate" in default:
                self.default_rate = float(default["rate"])
            if "burst" in default:
                self.default_burst = float(default["burst"]) or None
            if "priority" in default:
                self.default_priority = max(
                    1e-3, float(default["priority"]))
            self._overrides = {
                _clean_tenant(name): dict(cfg)
                for name, cfg in (spec.get("tenants") or {}).items()}
            self._reconfigure_buckets_locked()

    def _reconfigure_buckets_locked(self) -> None:
        for name, b in self._buckets.items():
            rate, burst, prio = self._tenant_cfg_locked(name)
            b.configure(rate, burst)
            self._priority[name] = prio

    def _tenant_cfg_locked(self, tenant: str) -> tuple[float,
                                                       float | None,
                                                       float]:
        o = self._overrides.get(tenant) or {}
        rate = float(o.get("rate", self.default_rate))
        burst = o.get("burst", self.default_burst)
        burst = float(burst) if burst else None
        prio = max(1e-3, float(o.get("priority",
                                     self.default_priority)))
        return rate, burst, prio

    def _maybe_reload_spec(self, force: bool = False) -> None:
        """mtime-gated spec reload: at most one stat() per
        SPEC_CHECK_INTERVAL, a parse only when the file changed. A
        malformed spec keeps the previous config (re-rating tenants
        mid-incident must not be all-or-nothing)."""
        path = self.spec_path
        if not path:
            return
        now = time.monotonic()
        with self._lock:
            if not force and now - self._spec_checked \
                    < SPEC_CHECK_INTERVAL:
                return
            self._spec_checked = now
            last = self._spec_mtime
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            return
        if not force and mtime == last:
            return
        try:
            with open(path, encoding="utf-8") as f:
                spec = json.load(f)
        except (OSError, ValueError):
            return
        with self._lock:
            self._spec_mtime = mtime
        self.load_spec(spec)

    # -- admission ------------------------------------------------------

    def _bucket_for(self, tenant: str) -> tuple[str, TokenBucket,
                                                float]:
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                if len(self._buckets) >= self.max_tenants and \
                        tenant != OVERFLOW_TENANT:
                    # bounded cardinality: late tenants share one
                    # bucket (and one metric label value)
                    return self._bucket_for_locked(OVERFLOW_TENANT)
                return self._bucket_for_locked(tenant)
            return tenant, b, self._priority.get(
                tenant, self.default_priority)

    def _bucket_for_locked(self, tenant: str) -> tuple[str,
                                                       TokenBucket,
                                                       float]:
        b = self._buckets.get(tenant)
        if b is None:
            rate, burst, prio = self._tenant_cfg_locked(tenant)
            b = self._buckets[tenant] = TokenBucket(rate, burst)
            self._priority[tenant] = prio
            metrics.gauge_set("qos_tenants", len(self._buckets))
        return tenant, b, self._priority[tenant]

    def admit(self, tenant: str, cost: int,
              remaining: float | None) -> Admission:
        """Price one request for ``tenant``: ``cost`` bytes (floored
        at ``request_floor``, divided by the tenant's priority) against
        its bucket. Returns the pacing wait, or a shed verdict when
        the wait exceeds ``max_delay`` or the request's remaining
        deadline budget — in which case the reservation is cancelled:
        a shed request owes nothing."""
        if not self.enabled:
            return Admission(tenant)
        self._maybe_reload_spec()
        tenant, bucket, prio = self._bucket_for(_clean_tenant(tenant))
        if bucket.rate <= 0:
            return Admission(tenant)
        charged = int(max(self.request_floor, cost) / prio)
        wait = bucket.reserve(charged)
        reason = ""
        if wait > self.max_delay:
            reason = "rate"
        elif remaining is not None and wait > remaining:
            # doomed to 504 downstream: reject-early instead of
            # accepting work nobody will wait for
            reason = "deadline"
        if reason:
            bucket.cancel(charged)
            lab = {"tenant": tenant, "reason": reason}
            metrics.counter_add("qos_shed_total", labels=lab)
            with self._lock:
                self._shed[(tenant, reason)] = \
                    self._shed.get((tenant, reason), 0) + 1
            return Admission(tenant, shed_reason=reason,
                             retry_after=wait)
        metrics.counter_add("qos_admitted_total",
                            labels={"tenant": tenant})
        metrics.histogram_observe("qos_queue_delay_seconds", wait,
                                  labels={"tenant": tenant})
        with self._lock:
            self._admitted[tenant] = self._admitted.get(tenant, 0) + 1
        return Admission(tenant, wait=wait)

    # -- tenant demand telemetry ---------------------------------------

    def record_demand(self, tenant: str, cost: int,
                      wait: float) -> None:
        """Sketch one request's demand signal for ``tenant`` (arrival
        gap, body bytes, queue delay). Runs whether or not shaping is
        enabled — the telemetry plane must see the workload before QoS
        is ever turned on — and is a no-op when telemetry is off."""
        if not _sketch.enabled():
            return
        now = time.time()
        tenant = _clean_tenant(tenant)
        with self._lock:
            d = self._demand.get(tenant)
            if d is None:
                if len(self._demand) >= self.max_tenants and \
                        tenant != OVERFLOW_TENANT:
                    # bounded label cardinality, same rule as buckets
                    tenant = OVERFLOW_TENANT
                    d = self._demand.get(tenant)
                if d is None:
                    d = self._demand[tenant] = {
                        "gap": _sketch.windowed(),
                        "bytes": _sketch.windowed(),
                        "delay": _sketch.windowed(),
                        "last_at": 0.0}
            if d["last_at"]:
                d["gap"].record(now - d["last_at"], now)
            d["last_at"] = now
            d["bytes"].record(max(0, int(cost)), now)
            d["delay"].record(max(0.0, wait), now)

    def _demand_rows_locked(self, now: float) -> list[tuple]:
        # (tenant, rate_rps, bytes_sketch, delay_sketch, gap_sketch,
        #  provisioned bytes/sec); caller holds _lock. Rate comes from
        # the mean inter-arrival gap inside the sliding window — exact
        # for steady arrivals, window-size independent.
        rows = []
        for name, d in self._demand.items():
            gap = d["gap"].merged(now)
            by = d["bytes"].merged(now)
            dl = d["delay"].merged(now)
            rate = 1.0 / gap.mean if gap.mean > 0 else 0.0
            b = self._buckets.get(name)
            prov = b.rate if b is not None else self.default_rate
            rows.append((name, rate, by, dl, gap, prov))
        return rows

    def demand_snapshot(self, now: float | None = None) -> dict:
        """Per-tenant demand digest + the provisioned rate each tenant
        is currently configured for (the QoS advisor's delta input)."""
        now = time.time() if now is None else now
        with self._lock:
            tenants = {
                name: {"rate_rps": round(rate, 3),
                       "bytes_per_sec": round(rate * by.mean, 1),
                       "bytes": by.summary(),
                       "delay": dl.summary(),
                       "gap": gap.summary(),
                       "provisioned_rate": prov}
                for name, rate, by, dl, gap, prov
                in self._demand_rows_locked(now)}
        return {"alpha": _sketch.alpha(), "window": _sketch.window(),
                "tenants": tenants}

    def export_demand_metrics(self, now: float | None = None) -> None:
        """Set ``workload_tenant_*`` gauges from the demand sketches.
        The gateways call this while rendering /metrics, so per-tenant
        demand rides the existing federation to the master's workload
        aggregator instead of needing a new wire."""
        if not _sketch.enabled():
            return
        now = time.time() if now is None else now
        with self._lock:
            rows = self._demand_rows_locked(now)
        for name, rate, by, dl, _gap, prov in rows:
            lab = {"tenant": name}
            metrics.gauge_set("workload_tenant_rate_rps", rate,
                              labels=lab)
            metrics.gauge_set("workload_tenant_bytes_per_sec",
                              rate * by.mean, labels=lab)
            metrics.gauge_set("workload_tenant_provisioned_rate",
                              prov, labels=lab)
            for q in ("0.5", "0.9", "0.99"):
                metrics.gauge_set("workload_tenant_bytes",
                                  by.quantile(float(q)),
                                  labels={"tenant": name, "q": q})
                metrics.gauge_set("workload_tenant_delay_seconds",
                                  dl.quantile(float(q)),
                                  labels={"tenant": name, "q": q})

    # -- introspection --------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            tenants = {}
            for name, b in self._buckets.items():
                st = b.state()
                st["priority"] = self._priority.get(
                    name, self.default_priority)
                st["admitted"] = self._admitted.get(name, 0)
                shed = {r: n for (t, r), n in self._shed.items()
                        if t == name}
                if shed:
                    st["shed"] = shed
                tenants[name] = st
            return {
                "enabled": self.enabled,
                "default_rate": self.default_rate,
                "default_burst": self.default_burst,
                "default_priority": self.default_priority,
                "max_tenants": self.max_tenants,
                "max_delay": self.max_delay,
                "request_floor": self.request_floor,
                "spec_path": self.spec_path,
                "tenants": tenants,
            }

    def reset(self) -> None:
        """Test hook: back to defaults, drop all buckets."""
        with self._lock:
            self.enabled = False
            self.default_rate = 0.0
            self.default_burst = None
            self.default_priority = 1.0
            self.max_tenants = 256
            self.max_delay = 2.0
            self.request_floor = REQUEST_FLOOR
            self.spec_path = ""
            self._spec_mtime = None
            self._spec_checked = 0.0
            self._overrides.clear()
            self._buckets.clear()
            self._priority.clear()
            self._admitted.clear()
            self._shed.clear()
            self._demand.clear()


def _clean_tenant(raw: str) -> str:
    """Bound the label value itself: printable, short, never empty."""
    t = "".join(c if c.isalnum() or c in "-_.+" else "_"
                for c in (raw or ""))[:64]
    return t or "anonymous"


_registry = QosRegistry()


def configure(**kw) -> None:
    _registry.configure(**kw)


def load_spec(spec: dict) -> None:
    _registry.load_spec(spec)


def admit(tenant: str, cost: int,
          remaining: float | None) -> Admission:
    return _registry.admit(tenant, cost, remaining)


def enabled() -> bool:
    return _registry.enabled


def snapshot() -> dict:
    return _registry.snapshot()


def record_demand(tenant: str, cost: int, wait: float) -> None:
    _registry.record_demand(tenant, cost, wait)


def demand_snapshot(now: float | None = None) -> dict:
    return _registry.demand_snapshot(now)


def export_demand_metrics(now: float | None = None) -> None:
    _registry.export_demand_metrics(now)


def reset() -> None:
    _registry.reset()


# -- tenant extraction ------------------------------------------------

def s3_tenant(request) -> str:
    """S3 tenant = the access key named by the request. Parsed
    cheaply, WITHOUT signature verification: attribution needs no
    authn (a spoofed key only buys its owner's — usually worse —
    rate), and admission must run before any per-request crypto."""
    auth = request.headers.get("Authorization", "")
    if auth.startswith("AWS4-HMAC-SHA256"):
        # Credential=AKID/20230101/us-east-1/s3/aws4_request
        i = auth.find("Credential=")
        if i >= 0:
            cred = auth[i + len("Credential="):].split(",", 1)[0]
            return cred.split("/", 1)[0]
    elif auth.startswith("AWS "):  # SigV2: "AWS AKID:signature"
        return auth[4:].split(":", 1)[0]
    cred = request.query.get("X-Amz-Credential", "")
    if cred:
        return cred.split("/", 1)[0]
    ak = request.query.get("AWSAccessKeyId", "")
    if ak:
        return ak
    return "anonymous"


def filer_tenant(request) -> str:
    """Filer tenant = first path segment (the top-level namespace a
    workload writes under)."""
    seg = request.path.lstrip("/").split("/", 1)[0]
    return seg or "_root"


# -- gateway middleware -----------------------------------------------

_SKIP_PATHS = {"/metrics", "/debug", "/status", "/healthz"}
# filer control-plane prefixes: lock manager, KV config store and the
# metadata subscription feed serve the cluster itself — shaping there
# would rate-limit identity reloads by tenant "kv". All /debug/* pages
# ride the same exemption (they ARE the instruments).
_SKIP_PREFIXES = ("/dlm/", "/kv/", "/ws/", "/debug/")


def middleware(service: str, tenant_of):
    """Admission middleware for the gateway edges (rpc/http.App). Sits
    between the deadline middleware (which binds the request's budget)
    and the handler: sheds with 503 + Retry-After + X-Sw-Retryable
    (zero work done — safe for clients to replay blindly), paces
    admitted requests with a sleep on the handler's own thread."""
    from ..rpc.http import json_response
    from . import retry

    def mw(req, nxt):
        if req.path in _SKIP_PATHS or req.path.startswith(_SKIP_PREFIXES):
            return nxt(req)
        tenant = tenant_of(req)
        cost = req.content_length or 0
        if not _registry.enabled:
            # shaping off: still sketch the tenant's demand — the
            # workload plane characterizes traffic before QoS is on
            _registry.record_demand(tenant, cost, 0.0)
            return nxt(req)
        adm = _registry.admit(tenant, cost, retry.remaining())
        if not adm.admitted:
            return json_response(
                {"error": "per-tenant rate exceeded",
                 "tenant": adm.tenant, "reason": adm.shed_reason},
                status=503,
                headers={retry.RETRYABLE_HEADER: "1",
                         "Retry-After": str(max(1, int(math.ceil(
                             adm.retry_after))))})
        _registry.record_demand(adm.tenant, cost, adm.wait)
        if adm.wait > 0:
            time.sleep(adm.wait)
        return nxt(req)
    return mw


def handle_debug_qos(req):
    """GET /debug/qos: the registry's snapshot."""
    from ..rpc.http import json_response

    return json_response(snapshot())
