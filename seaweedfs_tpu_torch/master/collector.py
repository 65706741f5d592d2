"""Cluster observability plane: trace collector + metrics federation;
the counterpart of seaweedfs_tpu/master/collector.py.

The master is the one process every node already talks to, so it hosts
the cluster's telemetry too:

- `SpanCollector` receives span batches pushed by every server
  process's `rpc.trace_push.SpanPusher` (and the master's own tracing
  sink, `local_sink`), stitches them into cross-process trace trees
  keyed by trace-id in a bounded store, and serves them at
  ``/cluster/traces``. Retention is tail-based: when the store is full,
  healthy traces evict first and error/slow traces are pinned until
  nothing else is left.
- `to_otlp` renders collected traces as OTLP/JSON (resourceSpans →
  scopeSpans → spans) from the stdlib alone, for
  ``/cluster/traces?format=otlp`` and the ``-trace.otlpUrl`` push loop.
- `MetricsFederator` scrapes every registered node's ``/metrics`` on a
  timer (a thread of the master) and serves the merged,
  ``instance``-labeled corpus at ``/cluster/metrics``: one scrape
  covers the whole cluster. The master's `/cluster/status` folds read
  the last scrape (the `Tiering` fold sums `tier_bytes_moved_total`
  from it).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from ..rpc.httpclient import session
from ..utils import glog, metrics, tracing

MAX_TRACES = 2048          # bounded trace store (traces, not spans)
MAX_SPANS_PER_TRACE = 512  # runaway-trace guard
OTLP_SCOPE = "seaweedfs_tpu.tracing"
_OTLP_KIND = {"internal": 1, "server": 2, "client": 3}


class SpanCollector:
    """Bounded cross-process trace store with tail-based retention."""

    def __init__(self, max_traces: int = MAX_TRACES,
                 slow_threshold: float = 1.0):
        self.max_traces = max(16, int(max_traces))
        self.slow_threshold = float(slow_threshold)
        self._lock = threading.Lock()
        # trace_id -> {"spans": [rec...], "updated": mono, "pinned": bool}
        self._traces: OrderedDict[str, dict] = OrderedDict()
        # per-pusher bookkeeping for the /cluster/status block
        # instance -> {"service", "last_push" (wall), "spans", "dropped"}
        self._pushers: dict[str, dict] = {}
        self._evicted = 0
        # traces touched since the last OTLP drain (push loop input)
        self._otlp_pending: deque = deque(maxlen=self.max_traces)
        self._otlp_pending_set: set[str] = set()

    # -- ingest ---------------------------------------------------------

    def add_spans(self, instance: str, service: str, spans: list[dict],
                  dropped: int = 0) -> int:
        """One push batch from `instance`. -> spans accepted."""
        now = time.monotonic()
        accepted = 0
        with self._lock:
            st = self._pushers.setdefault(
                instance, {"service": service, "last_push": 0.0,
                           "spans": 0, "dropped": 0})
            st["service"] = service or st["service"]
            st["last_push"] = time.time()
            st["dropped"] += max(0, int(dropped))
            for rec in spans:
                tid = rec.get("trace_id")
                if not isinstance(tid, str) or not tid:
                    continue
                entry = self._traces.get(tid)
                if entry is None:
                    entry = {"spans": [], "updated": now, "pinned": False}
                    self._traces[tid] = entry
                elif len(entry["spans"]) >= MAX_SPANS_PER_TRACE:
                    continue
                rec = dict(rec)
                rec["instance"] = instance
                rec.setdefault("service", service)
                entry["spans"].append(rec)
                entry["updated"] = now
                self._traces.move_to_end(tid)
                if (rec.get("status") == "error"
                        or float(rec.get("duration") or 0.0)
                        >= self.slow_threshold > 0):
                    entry["pinned"] = True
                if tid not in self._otlp_pending_set:
                    self._otlp_pending_set.add(tid)
                    self._otlp_pending.append(tid)
                accepted += 1
            st["spans"] += accepted
            self._evict_locked()
        if accepted:
            metrics.counter_add("cluster_trace_spans_received_total",
                                accepted)
        return accepted

    def _evict_locked(self) -> None:
        """Tail-based retention: oldest healthy traces go first, pinned
        (error/slow) traces only once no healthy trace is left."""
        while len(self._traces) > self.max_traces:
            victim = None
            for tid, entry in self._traces.items():  # oldest first
                if not entry["pinned"]:
                    victim = tid
                    break
            if victim is None:  # everything pinned: evict oldest anyway
                victim = next(iter(self._traces))
            del self._traces[victim]
            self._otlp_pending_set.discard(victim)
            self._evicted += 1

    def local_sink(self, instance: str, service: str = "master"):
        """A `tracing.add_sink` callback feeding this collector
        directly — the master's own spans skip the HTTP hop (and honor
        the same head-sampling verdict as every remote pusher)."""

        def sink(rec: dict) -> None:
            if not tracing.sample_decision(rec.get("trace_id", "")):
                return
            self.add_spans(instance,
                           rec.get("service") or service, [rec])

        return sink

    # -- queries --------------------------------------------------------

    def _snapshot(self, trace_id: str) -> list[dict] | None:
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None:
                return None
            return [dict(s) for s in entry["spans"]]

    def list_traces(self, limit: int = 50) -> list[dict]:
        """Newest-first trace summaries."""
        with self._lock:
            items = [(tid, [dict(s) for s in e["spans"]], e["pinned"])
                     for tid, e in reversed(self._traces.items())]
            items = items[:max(1, int(limit))]
        out = []
        for tid, spans, pinned in items:
            services = sorted({s.get("service") or "unknown"
                               for s in spans})
            instances = sorted({s.get("instance") or "" for s in spans}
                               - {""})
            roots = [s for s in spans if not s.get("parent_id")]
            dur = max((float(s.get("duration") or 0.0)
                       for s in (roots or spans)), default=0.0)
            out.append({
                "trace_id": tid,
                "spans": len(spans),
                "services": services,
                "instances": instances,
                "start": min((float(s.get("start") or 0.0)
                              for s in spans), default=0.0),
                "duration": dur,
                "error": any(s.get("status") == "error" for s in spans),
                "pinned": pinned,
            })
        return out

    def get_trace(self, trace_id: str) -> dict | None:
        """The stitched cross-process span tree of one trace."""
        flat = self._snapshot(trace_id)
        if flat is None:
            return None
        by_id = {s["span_id"]: s for s in flat if s.get("span_id")}
        roots: list[dict] = []
        for s in flat:
            s.setdefault("children", [])
            parent = by_id.get(s.get("parent_id"))
            if parent is not None and parent is not s:
                parent.setdefault("children", []).append(s)
            else:
                roots.append(s)
        for s in flat:
            s["children"].sort(key=lambda c: float(c.get("start") or 0))
        roots.sort(key=lambda s: float(s.get("start") or 0))
        return {"trace_id": trace_id, "spans": len(flat), "tree": roots}

    # -- OTLP export ----------------------------------------------------

    def to_otlp(self, trace_ids: list[str] | None = None,
                limit: int = 50) -> dict:
        """Render traces as an OTLP/JSON ExportTraceServiceRequest."""
        with self._lock:
            if trace_ids is None:
                ids = list(reversed(self._traces))[:max(1, int(limit))]
            else:
                ids = [t for t in trace_ids if t in self._traces]
            spans = [dict(s) for tid in ids
                     for s in self._traces[tid]["spans"]]
        # OTLP groups spans under the resource that produced them:
        # one resourceSpans entry per (service, instance) pair
        groups: dict[tuple[str, str], list[dict]] = {}
        for s in spans:
            key = (s.get("service") or "unknown",
                   s.get("instance") or "")
            groups.setdefault(key, []).append(s)
        resource_spans = []
        for (service, instance), recs in sorted(groups.items()):
            attrs = [{"key": "service.name",
                      "value": {"stringValue": service}}]
            if instance:
                attrs.append({"key": "service.instance.id",
                              "value": {"stringValue": instance}})
            resource_spans.append({
                "resource": {"attributes": attrs},
                "scopeSpans": [{
                    "scope": {"name": OTLP_SCOPE},
                    "spans": [_otlp_span(r) for r in recs],
                }],
            })
        return {"resourceSpans": resource_spans}

    def drain_otlp_pending(self, max_ids: int = 64,
                           min_idle: float = 3.0) -> list[str]:
        """Trace-ids ready for the OTLP push loop: touched since the
        last drain AND idle for `min_idle` seconds (late spans from
        slow hops still land before export). Ids not yet idle stay
        pending for the next drain."""
        now = time.monotonic()
        ready: list[str] = []
        with self._lock:
            defer: list[str] = []
            while self._otlp_pending and len(ready) < max_ids:
                tid = self._otlp_pending.popleft()
                if tid not in self._otlp_pending_set:
                    continue  # evicted since enqueue
                entry = self._traces.get(tid)
                if entry is None:
                    self._otlp_pending_set.discard(tid)
                    continue
                if now - entry["updated"] < min_idle:
                    defer.append(tid)
                    continue
                self._otlp_pending_set.discard(tid)
                ready.append(tid)
            self._otlp_pending.extendleft(reversed(defer))
        return ready

    # -- status ---------------------------------------------------------

    def observability(self) -> dict:
        """Compact block for /cluster/status."""
        now = time.time()
        with self._lock:
            n_traces = len(self._traces)
            n_spans = sum(len(e["spans"])
                          for e in self._traces.values())
            n_pinned = sum(1 for e in self._traces.values()
                           if e["pinned"])
            evicted = self._evicted
            pushers = {
                inst: {
                    "Service": st["service"],
                    "PushLagSeconds": round(now - st["last_push"], 3)
                    if st["last_push"] else None,
                    "SpansReceived": st["spans"],
                    "SpansDropped": st["dropped"],
                } for inst, st in sorted(self._pushers.items())}
        metrics.gauge_set("cluster_trace_store_traces", n_traces)
        metrics.gauge_set("cluster_trace_store_spans", n_spans)
        for inst, st in pushers.items():
            if st["PushLagSeconds"] is not None:
                metrics.gauge_set("cluster_span_push_lag_seconds",
                                  st["PushLagSeconds"],
                                  {"instance": inst})
        return {
            "TraceStoreTraces": n_traces,
            "TraceStoreSpans": n_spans,
            "TraceStorePinned": n_pinned,
            "TraceStoreEvicted": evicted,
            "Pushers": pushers,
        }


def _otlp_span(rec: dict) -> dict:
    """One ring-buffer span record -> OTLP/JSON Span."""
    start_ns = int(float(rec.get("start") or 0.0) * 1e9)
    end_ns = start_ns + int(float(rec.get("duration") or 0.0) * 1e9)
    status = str(rec.get("status") or "")
    out = {
        "traceId": str(rec.get("trace_id") or ""),
        "spanId": str(rec.get("span_id") or ""),
        "name": str(rec.get("name") or "unknown"),
        "kind": _OTLP_KIND.get(rec.get("kind") or "internal", 1),
        # uint64 nanos are JSON strings in OTLP (proto3 JSON mapping)
        "startTimeUnixNano": str(start_ns),
        "endTimeUnixNano": str(end_ns),
        "status": {"code": 2} if status == "error" else {"code": 0},
        "attributes": [],
    }
    if rec.get("parent_id"):
        out["parentSpanId"] = str(rec["parent_id"])
    if rec.get("peer"):
        out["attributes"].append(
            {"key": "net.peer.name",
             "value": {"stringValue": str(rec["peer"])}})
    if status and status != "error":
        out["attributes"].append(
            {"key": "http.response.status_code",
             "value": {"stringValue": status}})
    return out




class MetricsFederator:
    """Scrapes every registered node's /metrics and serves the merged,
    instance-labeled corpus (one Prometheus scrape covers the cluster).

    Targets come from the master's own view of the cluster: volume
    servers from the topology, filers/brokers from membership, plus
    every instance that has pushed spans (covers the S3 gateway, which
    registers with neither)."""

    def __init__(self, master, interval: float = 10.0,
                 stale_after: float | None = None):
        self.master = master
        self.interval = float(interval)
        # a crashed node's last scrape must not serve frozen gauges
        # forever: past this cutoff its series are dropped from the
        # merged corpus and its synthetic `up` gauge flips to 0.
        # Default: 3 missed scrape intervals, floored at 30s so tests
        # with sub-second intervals don't flap
        self.stale_after = (float(stale_after) if stale_after
                            else max(3.0 * self.interval, 30.0))
        self._lock = threading.Lock()
        # instance -> {"text": str, "ts": wall, "error": str}
        self._scraped: dict[str, dict] = {}

    # -- targets --------------------------------------------------------

    def targets(self) -> dict[str, str]:
        """instance -> metrics URL."""
        out: dict[str, str] = {}
        topo = self.master.topo
        with topo.lock:
            for node in topo.nodes.values():
                out[node.url] = f"http://{node.url}/metrics"
        for n in self.master.membership.list_nodes():
            addr = n.address
            out[addr] = f"http://{addr}/metrics"
        collector = getattr(self.master, "collector", None)
        if collector is not None:
            with collector._lock:
                pushers = list(collector._pushers)
            for inst in pushers:
                if ":" in inst and inst not in out:
                    out[inst] = f"http://{inst}/metrics"
        return out

    # -- scraping -------------------------------------------------------

    def scrape_once(self) -> None:
        """One sweep over all targets (sync; runs in a worker thread).
        Failures keep the previous sample and record the error — a
        scrape outage must look stale, not empty."""
        for inst, url in self.targets().items():
            try:
                r = session().get(url, timeout=(3.0, 5.0))
                r.raise_for_status()
                sample = {"text": r.text, "ts": time.time(), "error": ""}
                with self._lock:
                    self._scraped[inst] = sample
            except Exception as e:
                with self._lock:
                    prev = self._scraped.get(inst)
                    if prev is not None:
                        prev["error"] = str(e)
                    else:
                        self._scraped[inst] = {"text": "", "ts": 0.0,
                                               "error": str(e)}
                glog.v(2, "federation scrape %s failed: %s", inst, e)

    def run(self, stop: threading.Event) -> None:
        """Scrape loop (the master's federation thread) until `stop`
        is set."""
        while not stop.is_set():
            try:
                self.scrape_once()
            except Exception as e:  # noqa: BLE001 — the loop goes on
                glog.warning("federation sweep failed: %s", e)
            stop.wait(self.interval)

    def missing(self) -> bool:
        """True when a target has never been scraped (a new node): the
        /cluster/metrics handler then sweeps once before it answers."""
        targets = self.targets()
        with self._lock:
            return any(t not in self._scraped for t in targets)

    def scraped_texts(self) -> list[str]:
        """The last scraped exposition of every target that answered."""
        with self._lock:
            return [s["text"] for s in self._scraped.values()
                    if s.get("text")]

    # -- merged output --------------------------------------------------

    def merged(self, self_instance: str = "") -> str:
        """The federated exposition: every scraped node's series plus
        the master's own registry, all labeled with `instance`. Emits
        a synthetic `up{instance}` gauge per target (1 = scraped
        within the staleness cutoff) and DROPS the series of stale
        instances — a dead node answers up 0, not frozen gauges."""
        now = time.time()
        with self._lock:
            samples = {i: dict(s) for i, s in self._scraped.items()}
        staleness = {i: (now - s["ts"]) if s["ts"] else float("inf")
                     for i, s in samples.items()}
        for inst, st in staleness.items():
            metrics.gauge_set(
                "cluster_scrape_staleness_seconds",
                round(st, 3) if st != float("inf") else -1,
                {"instance": inst})
        stale = {i for i, st in staleness.items()
                 if st > self.stale_after}
        if self_instance:
            # render AFTER the staleness gauges so they ride along;
            # the master's own registry is by definition fresh
            samples[self_instance] = {"text": metrics.render(),
                                      "ts": now, "error": ""}
            stale.discard(self_instance)
        # family -> (type line, [series lines]) keeps one # TYPE per
        # family across instances (duplicate TYPE lines are invalid)
        types: dict[str, str] = {}
        series: dict[str, list[str]] = {}
        order: list[str] = []
        types["up"] = "# TYPE up gauge"
        series["up"] = []
        order.append("up")
        for inst in sorted(samples):
            labeled = _inject_instance(
                f"up {0 if inst in stale else 1}", inst)
            if labeled is not None:
                series["up"].append(labeled)
        for inst in sorted(samples):
            if inst in stale:
                continue
            for line in samples[inst]["text"].splitlines():
                line = line.strip()
                if not line:
                    continue
                if line.startswith("# TYPE "):
                    parts = line.split()
                    if len(parts) >= 4:
                        fam = parts[2]
                        types.setdefault(fam, line)
                        if fam not in series:
                            series[fam] = []
                            order.append(fam)
                    continue
                if line.startswith("#"):
                    continue
                labeled = _inject_instance(line, inst)
                if labeled is None:
                    continue
                fam = _family_of(line)
                if fam not in series:
                    series[fam] = []
                    order.append(fam)
                series[fam].append(labeled)
        lines: list[str] = []
        for fam in order:
            if fam in types:
                lines.append(types[fam])
            lines.extend(series[fam])
        return "\n".join(lines) + "\n"

    def observability(self) -> dict:
        now = time.time()
        with self._lock:
            return {
                inst: {
                    "StalenessSeconds": round(now - s["ts"], 3)
                    if s["ts"] else None,
                    "Up": bool(s["ts"]) and
                    (now - s["ts"]) <= self.stale_after,
                    "Error": s["error"] or None,
                } for inst, s in sorted(self._scraped.items())}


def _family_of(series_line: str) -> str:
    """Metric family of one exposition series line (histogram
    components fold into their base family so # TYPE stays adjacent)."""
    name = series_line.split("{", 1)[0].split(" ", 1)[0]
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            return name[:-len(suffix)]
    return name


def _inject_instance(series_line: str, instance: str) -> str | None:
    """Add instance="..." to one series line; None for junk lines."""
    esc = (instance.replace("\\", "\\\\").replace('"', '\\"'))
    if "{" in series_line:
        head, rest = series_line.split("{", 1)
        if "}" not in rest:
            return None
        labels, value = rest.rsplit("}", 1)
        if not value.strip():
            return None
        if 'instance="' in labels:
            return series_line  # already labeled (nested federation)
        return f'{head}{{instance="{esc}",{labels}}}{value}'
    parts = series_line.split()
    if len(parts) < 2:
        return None
    name, value = parts[0], " ".join(parts[1:])
    return f'{name}{{instance="{esc}"}} {value}'
