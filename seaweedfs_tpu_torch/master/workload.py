"""Cluster workload aggregator + recommend-only threshold advisors; the
counterpart of seaweedfs_tpu/master/workload.py.

The master half of the workload-characterization telemetry plane
(arXiv 1709.05365): volume servers sketch per-volume
read/write inter-access gaps and request sizes into log-bucketed
quantile histograms (utils/sketch.py) and ship compact encodings on
the existing heartbeat; gateways sketch per-tenant demand and export
it as ``workload_tenant_*`` gauges that ride the existing metrics
federation. This module merges both into cluster-wide distributions
with per-node provenance and, on top, runs three **advisors** that
*recommend* — never actuate — threshold values for the static flags
the watchdog, the qos admission and the tiering controller are
tuned by:

* **seal** — the read-idle-gap quantile (× headroom) that would match
  ``-tier.sealAfterIdle``'s intent: seal volumes idle longer than all
  but the hottest (1 - sealQuantile) of observed re-access gaps.
* **qos** — per-tenant provisioned-rate suggestions from measured
  demand (bytes/sec × headroom) vs what ``-qos.spec`` provisions.
* **repair** — a ``-repair.maxBytesPerSec`` suggestion from measured
  idle bandwidth: the minimum over nodes of (peak foreground rate −
  current foreground rate), i.e. headroom repair can consume without
  competing with the foreground anywhere.

Every advisor carries current-flag vs recommendation and an operator
override (POST /debug/workload) that wins over the recommendation in
the ``effective`` field — the exact value a closed-loop controller
would be fed. All of it is visible at GET /debug/workload,
as ``workload_*`` gauges in the master's /metrics (hence federated
into /cluster/metrics), and folded into /cluster/status.

The port's gateways do not export ``workload_tenant_*`` yet (utils/qos
is not ported), so the qos advisor sees only what a federated scrape
carries.
"""
from __future__ import annotations

import re
import threading
import time

from ..utils import metrics
from ..utils import sketch as _sketch

# advisor kinds (the bounded `kind` label values)
ADVISORS = ("seal", "qos", "repair")
# heartbeat payloads older than this are provenance-only: still shown
# with their age, but excluded from cluster merges and advisor math —
# a crashed node must not pin yesterday's distribution forever
STALE_AFTER = 60.0
# per-volume sketch kinds on the heartbeat wire -> human names
_KINDS = {"rg": "read_gap", "rs": "read_size",
          "wg": "write_gap", "ws": "write_size"}
_QUANTILES = ("0.5", "0.9", "0.99")

# the per-tenant demand gauges exported by the gateways (utils/qos.py
# export_demand_metrics), parsed back out of the federator's scrape
# corpus — demand rides the existing federation wire, not a new one
_TENANT_SERIES = re.compile(
    r'^(workload_tenant_rate_rps|workload_tenant_bytes_per_sec|'
    r'workload_tenant_provisioned_rate|workload_tenant_bytes|'
    r'workload_tenant_delay_seconds)\{([^}]*)\}\s+([0-9.eE+-]+)\s*$')


def _parse_labels(raw: str) -> dict:
    return {k: v.strip('"')
            for k, v in (p.split("=", 1)
                         for p in raw.split(",") if "=" in p)}


class WorkloadAggregator:
    def __init__(self, master, seal_quantile: float = 0.95,
                 demand_quantile: float = 0.9,
                 headroom: float = 1.5,
                 stale_after: float = STALE_AFTER):
        self.master = master
        self.seal_quantile = min(0.999, max(0.5, float(seal_quantile)))
        self.demand_quantile = min(0.999, max(0.5,
                                              float(demand_quantile)))
        self.headroom = max(1.0, float(headroom))
        self.stale_after = max(1.0, float(stale_after))
        self._lock = threading.Lock()
        # node_id -> {"at": ts, "alpha", "fg_bps", "peak_bps",
        #             "volumes": {vid: {kind: QuantileSketch}}}
        self._nodes: dict[str, dict] = {}
        # "seal" | "repair" | "qos" | "qos:<tenant>" -> float
        self._overrides: dict[str, float] = {}

    # -- ingest (heartbeat side) ---------------------------------------

    def ingest(self, node_id: str, payload: dict) -> None:
        """One heartbeat's `workload` key from ``node_id``: decode the
        per-volume sketch encodings, stamp arrival time (provenance)."""
        if not isinstance(payload, dict):
            return
        vols: dict[str, dict] = {}
        for vid, kinds in (payload.get("volumes") or {}).items():
            if not isinstance(kinds, dict):
                continue
            decoded = {}
            for k, enc in kinds.items():
                if k in _KINDS and isinstance(enc, dict):
                    try:
                        decoded[k] = _sketch.QuantileSketch.from_dict(enc)
                    except (TypeError, ValueError):
                        continue
            if decoded:
                vols[str(vid)] = decoded
        with self._lock:
            self._nodes[node_id] = {
                "at": time.time(),
                "alpha": float(payload.get("alpha",
                                           _sketch.DEFAULT_ALPHA)),
                "fg_bps": float(payload.get("fg_bps", 0.0)),
                "peak_bps": float(payload.get("peak_bps", 0.0)),
                "volumes": vols,
            }

    def forget(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)

    # -- merged views ---------------------------------------------------

    def _fresh_nodes_locked(self, now: float) -> dict[str, dict]:
        return {nid: rec for nid, rec in self._nodes.items()
                if now - rec["at"] <= self.stale_after}

    def _cluster_sketches_locked(self, now: float
                                 ) -> dict[str, _sketch.QuantileSketch]:
        """Cluster-wide distribution per kind: bucket-exact merge of
        every fresh node's per-volume sketches."""
        out = {k: _sketch.QuantileSketch(_sketch.alpha())
               for k in _KINDS}
        for rec in self._fresh_nodes_locked(now).values():
            for kinds in rec["volumes"].values():
                for k, sk in kinds.items():
                    if abs(sk.alpha - out[k].alpha) > 1e-12:
                        # a node on a different -telemetry.alpha can't
                        # merge bucket-exactly; rebase the merged view
                        # on its alpha (mixed configs are transitional)
                        out[k] = _sketch.QuantileSketch(sk.alpha)
                    out[k].merge(sk)
        return out

    # -- tenant demand (federation side) --------------------------------

    def tenant_demand(self) -> dict[str, dict]:
        """Per-tenant demand folded from the federated gateway
        scrapes. Rates/bytes-per-sec SUM across gateways (a tenant can
        hit several fronts); quantiles and provisioned rate take the
        MAX (conservative for an advisor)."""
        with self.master.federator._lock:
            texts = [s["text"]
                     for s in self.master.federator._scraped.values()
                     if s.get("text")]
        tenants: dict[str, dict] = {}
        for text in texts:
            for line in text.splitlines():
                m = _TENANT_SERIES.match(line.strip())
                if not m:
                    continue
                fam, rawlab, val = m.groups()
                labels = _parse_labels(rawlab)
                tenant = labels.get("tenant", "")
                if not tenant:
                    continue
                t = tenants.setdefault(
                    tenant, {"rate_rps": 0.0, "bytes_per_sec": 0.0,
                             "provisioned_rate": 0.0,
                             "bytes": {}, "delay": {}})
                v = float(val)
                if fam == "workload_tenant_rate_rps":
                    t["rate_rps"] += v
                elif fam == "workload_tenant_bytes_per_sec":
                    t["bytes_per_sec"] += v
                elif fam == "workload_tenant_provisioned_rate":
                    t["provisioned_rate"] = max(
                        t["provisioned_rate"], v)
                else:
                    q = labels.get("q", "")
                    key = ("bytes" if fam == "workload_tenant_bytes"
                           else "delay")
                    t[key][q] = max(t[key].get(q, 0.0), v)
        return tenants

    # -- advisors -------------------------------------------------------

    def _advise_seal_locked(self, now: float) -> dict:
        gaps = self._cluster_sketches_locked(now)["rg"]
        current = float(self.master.tiering.seal_after_idle)
        rec = {"current": current, "samples": gaps.count}
        if gaps.count:
            # seal volumes idle longer than all but the hottest
            # (1 - sealQuantile) of observed re-access gaps, padded by
            # the headroom factor against phase noise
            rec["recommended"] = round(
                gaps.quantile(self.seal_quantile) * self.headroom, 3)
            # how much of the observed gap stream the current flag
            # already covers (coverage 0.99 = flag seals almost
            # nothing that would have been re-read)
            rec["coverage"] = round(gaps.fraction_below(current), 4)
        else:
            rec["recommended"] = None
        return self._finish(rec, "seal")

    def _advise_qos(self, tenants: dict[str, dict]) -> dict:
        per_tenant = {}
        total_rec = total_cur = 0.0
        for name, t in sorted(tenants.items()):
            # provisioned-rate suggestion: measured demand in bytes/sec
            # times headroom; the q-th size percentile shows what the
            # demand is made of
            demand = t["bytes_per_sec"]
            recommended = round(demand * self.headroom, 1)
            cur = t["provisioned_rate"]
            row = {"demand_bytes_per_sec": round(demand, 1),
                   "rate_rps": round(t["rate_rps"], 3),
                   "bytes_p": t["bytes"], "delay_p": t["delay"],
                   "current": cur, "recommended": recommended,
                   "delta": round(recommended - cur, 1)}
            ov = self._overrides.get(f"qos:{name}")
            if ov is not None:
                row["override"] = ov
            row["effective"] = ov if ov is not None else recommended
            per_tenant[name] = row
            total_rec += recommended
            total_cur += cur
        rec = {"current": round(total_cur, 1),
               "recommended": round(total_rec, 1) if per_tenant
               else None,
               "tenants": per_tenant}
        return self._finish(rec, "qos")

    def _advise_repair_locked(self, now: float) -> dict:
        current = float(self.master.watchdog.max_bytes_per_sec)
        rec = {"current": current}
        fresh = self._fresh_nodes_locked(now)
        slack = [max(0.0, r["peak_bps"] - r["fg_bps"])
                 for r in fresh.values() if r["peak_bps"] > 0]
        if slack:
            # repair can consume the smallest per-node idle bandwidth
            # without competing with the foreground anywhere
            rec["recommended"] = round(min(slack), 1)
            rec["node_slack"] = {
                nid: round(max(0.0, r["peak_bps"] - r["fg_bps"]), 1)
                for nid, r in fresh.items() if r["peak_bps"] > 0}
        else:
            rec["recommended"] = None
        return self._finish(rec, "repair")

    def _finish(self, rec: dict, kind: str) -> dict:
        """Attach override/effective/delta: the override wins over the
        recommendation; ``effective`` is what a closed-loop controller
        would consume."""
        ov = self._overrides.get(kind)
        if ov is not None:
            rec["override"] = ov
        eff = ov if ov is not None else rec.get("recommended")
        rec["effective"] = eff
        if rec.get("recommended") is not None and \
                rec.get("current") is not None:
            rec["delta"] = round(rec["recommended"] - rec["current"], 3)
        return rec

    def set_override(self, advisor: str, value,
                     tenant: str = "") -> dict:
        """POST /debug/workload: {"advisor", "override": number|null,
        optional "tenant" (qos only)}. null clears. Raises ValueError
        on malformed input (handler maps it to a 400)."""
        if advisor not in ADVISORS:
            raise ValueError(f"unknown advisor {advisor!r}; expected "
                             f"one of {', '.join(ADVISORS)}")
        if tenant and advisor != "qos":
            raise ValueError("tenant overrides apply to the qos "
                             "advisor only")
        key = f"qos:{tenant}" if tenant else advisor
        if value is None:
            with self._lock:
                self._overrides.pop(key, None)
            return {"advisor": advisor, "tenant": tenant,
                    "override": None}
        try:
            v = float(value)
        except (TypeError, ValueError):
            raise ValueError(
                f"override must be a number or null, got {value!r}")
        if v < 0 or v != v:  # NaN
            raise ValueError(f"override must be >= 0, got {value!r}")
        with self._lock:
            self._overrides[key] = v
        return {"advisor": advisor, "tenant": tenant, "override": v}

    # -- outputs --------------------------------------------------------

    def snapshot(self) -> dict:
        """GET /debug/workload: cluster distributions, per-node
        provenance, tenant demand, and all three advisors."""
        now = time.time()
        tenants = self.tenant_demand()
        with self._lock:
            cluster = {_KINDS[k]: sk.summary() for k, sk in
                       self._cluster_sketches_locked(now).items()}
            nodes = {
                nid: {"age_seconds": round(now - r["at"], 3),
                      "stale": now - r["at"] > self.stale_after,
                      "alpha": r["alpha"],
                      "volumes": len(r["volumes"]),
                      "fg_bps": r["fg_bps"],
                      "peak_bps": r["peak_bps"]}
                for nid, r in self._nodes.items()}
            volumes: dict[str, dict] = {}
            for rec in self._fresh_nodes_locked(now).values():
                for vid, kinds in rec["volumes"].items():
                    dst = volumes.setdefault(vid, {})
                    for k, sk in kinds.items():
                        name = _KINDS[k]
                        merged = dst.get(name)
                        if merged is None:
                            dst[name] = merged = \
                                _sketch.QuantileSketch(sk.alpha)
                        if abs(merged.alpha - sk.alpha) <= 1e-12:
                            merged.merge(sk)
            volumes = {vid: {name: sk.summary()
                             for name, sk in kinds.items()}
                       for vid, kinds in volumes.items()}
            advisors = {
                "seal": self._advise_seal_locked(now),
                "qos": self._advise_qos(tenants),
                "repair": self._advise_repair_locked(now),
            }
        return {
            "alpha": _sketch.alpha(),
            "window": _sketch.window(),
            "telemetry_enabled": _sketch.enabled(),
            "seal_quantile": self.seal_quantile,
            "demand_quantile": self.demand_quantile,
            "headroom": self.headroom,
            "nodes": nodes,
            "cluster": cluster,
            "volumes": volumes,
            "tenants": tenants,
            "advisors": advisors,
        }

    def export_gauges(self) -> None:
        """workload_* gauges into the master's registry: scraped at
        /metrics, hence federated into /cluster/metrics like every
        other instance's exposition."""
        now = time.time()
        tenants = self.tenant_demand()
        with self._lock:
            fresh = self._fresh_nodes_locked(now)
            metrics.gauge_set("workload_nodes_reporting", len(fresh))
            sketches = self._cluster_sketches_locked(now)
            advisors = {
                "seal": self._advise_seal_locked(now),
                "qos": self._advise_qos(tenants),
                "repair": self._advise_repair_locked(now),
            }
        for k, sk in sketches.items():
            if not sk.count:
                continue
            for q in _QUANTILES:
                val = sk.quantile(float(q))
                if k == "rg":
                    metrics.gauge_set("workload_read_gap_seconds",
                                      val, labels={"q": q})
                elif k == "rs":
                    metrics.gauge_set("workload_read_size_bytes",
                                      val, labels={"q": q})
                elif k == "wg":
                    metrics.gauge_set("workload_write_gap_seconds",
                                      val, labels={"q": q})
                else:
                    metrics.gauge_set("workload_write_size_bytes",
                                      val, labels={"q": q})
        for kind, adv in advisors.items():
            lab = {"kind": kind}
            if adv.get("current") is not None:
                metrics.gauge_set("workload_advisor_current",
                                  float(adv["current"]), labels=lab)
            if adv.get("recommended") is not None:
                metrics.gauge_set("workload_advisor_recommended",
                                  float(adv["recommended"]), labels=lab)
            if adv.get("delta") is not None:
                metrics.gauge_set("workload_advisor_delta",
                                  float(adv["delta"]), labels=lab)
            if adv.get("effective") is not None:
                metrics.gauge_set("workload_advisor_effective",
                                  float(adv["effective"]), labels=lab)

    def status_fold(self) -> dict:
        """The compact /cluster/status fold (full detail lives at
        /debug/workload)."""
        now = time.time()
        tenants = self.tenant_demand()
        with self._lock:
            fresh = self._fresh_nodes_locked(now)
            advisors = {
                "seal": self._advise_seal_locked(now),
                "qos": self._advise_qos(tenants),
                "repair": self._advise_repair_locked(now),
            }
        return {
            "TelemetryEnabled": _sketch.enabled(),
            "NodesReporting": len(fresh),
            "TenantsSeen": len(tenants),
            "Advisors": {
                kind: {"Current": adv.get("current"),
                       "Recommended": adv.get("recommended"),
                       "Override": adv.get("override"),
                       "Effective": adv.get("effective"),
                       "Delta": adv.get("delta")}
                for kind, adv in advisors.items()},
        }
