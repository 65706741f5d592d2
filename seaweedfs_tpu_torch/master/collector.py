"""Cluster metrics federation; the `MetricsFederator` of
seaweedfs_tpu/master/collector.py.

`MetricsFederator` scrapes every registered node's ``/metrics`` on a
timer (a thread of the master) and serves the merged,
``instance``-labeled corpus at ``/cluster/metrics``: one scrape covers
the whole cluster. The master's `/cluster/status` folds read the last
scrape (the `Tiering` fold sums `tier_bytes_moved_total` from it).

Not here yet: the span collector (`SpanCollector`, ``/cluster/traces``
and the OTLP export), which waits for the servers' span push
(rpc/trace_push.py).
"""
from __future__ import annotations

import threading
import time

from ..rpc.httpclient import session
from ..utils import glog, metrics


class MetricsFederator:
    """Scrapes every registered node's /metrics and serves the merged,
    instance-labeled corpus (one Prometheus scrape covers the cluster).

    Targets come from the master's own view of the cluster: volume
    servers from the topology, filers/brokers from membership. (The
    reference also scrapes every instance that pushed spans to its
    collector; that waits for the span collector.)"""

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
