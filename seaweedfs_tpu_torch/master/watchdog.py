"""Redundancy watchdog + repair queue; the counterpart of
seaweedfs_tpu/master/watchdog.py.

Tracks per-volume replica counts and per-EC-volume live shard counts
from the topology the heartbeats keep, surfaces the deficit sets on
/cluster/status and /debug/repair, and — when ``-repair.enabled`` is
set — drives re-replication / EC shard rebuild through a
bounded-concurrency queue. Time-to-redundancy, not encode speed, sets a
cluster's availability, so repair starts when a loss is seen, not on
the next maintenance tick.

Threads take the place of the reference's asyncio tasks: one scan
thread waits on a poke Event (or `interval` seconds), and
`concurrency` worker threads take tasks from a queue.Queue. The
reference's dedupe maps (`_tracked`, `_queued`, `_inflight`) relied on
asyncio's single thread; here one lock guards all three, and neither it
nor the topology's lock is held across a repair. A repair runs the
shell's volume.fix.replication or ec.rebuild over HTTP against this
master, so an EC rebuild goes through the volume servers' codec (with
"cuda", the hand-written kernel).

With raft masters only the leader scans; a follower owns no topology
and shows empty deficit sets (as the reference, :225-230). A fresh
leader's topology fills one heartbeat at a time, so an EC volume whose
servers have only partly re-registered looks like it is missing shards
that are not lost. The reference drives repairs as soon as it leads;
here a leader tracks deficits at once but queues no repair until a
full reaper window (REAP_PULSES pulses) has passed since it took
leadership: by then every live server has heartbeated, and a silent one
is one the reaper would unregister anyway. That holds after a partition
too: an old leader cut off from the other masters steps down within an
election window (raft.py's check-quorum) and refuses heartbeats, so its
servers re-home here.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..ec import geometry as geo
from ..storage.super_block import ReplicaPlacement
from ..utils import glog, metrics
from ..utils import retry as _retry

# how long stop() waits for each thread
JOIN_TIMEOUT = 10.0
# silent pulses before the master unregisters a volume server
# (Topology.dead_nodes), and so a fresh leader's repair hold
REAP_PULSES = 5.0


@dataclass
class RepairTask:
    vid: int
    kind: str                 # "replica" | "ec"
    reason: str               # "watchdog" | "scrub" | "operator"
    have: int = 0
    want: int = 0
    collection: str = ""
    attempts: int = 0
    first_seen: float = field(default_factory=time.monotonic)
    not_before: float = 0.0   # monotonic; requeue backoff gate

    @property
    def key(self) -> tuple[int, str]:
        return (self.vid, self.kind)

    def to_dict(self) -> dict:
        return {"volume": self.vid, "kind": self.kind,
                "reason": self.reason, "have": self.have,
                "want": self.want, "collection": self.collection,
                "attempts": self.attempts,
                "age_seconds": round(time.monotonic() - self.first_seen,
                                     3)}


class RedundancyWatchdog:
    """Deficit tracking is ALWAYS on (a scan of the in-memory topology
    on every poke / interval); repair driving is opt-in via ``enabled``
    so operator shells and tests keep exclusive control of the cluster
    unless self-healing is requested."""

    def __init__(self, master, enabled: bool = False,
                 interval: float = 10.0, concurrency: int = 2,
                 max_attempts: int = 5, grace: float = 0.0,
                 max_bytes_per_sec: float = 0.0,
                 partial_ec: bool = True):
        self.master = master
        self.enabled = enabled
        self.interval = max(0.05, interval)
        self.concurrency = max(1, concurrency)
        self.max_attempts = max(1, max_attempts)
        self.grace = max(0.0, grace)
        # -repair.maxBytesPerSec: per-node repair byte-rate cap, sent
        # with every copy (0 = unshaped)
        self.max_bytes_per_sec = max(0.0, max_bytes_per_sec)
        # -repair.partialEc: few-shard rebuilds stream only the k shard
        # ranges reconstruction needs
        self.partial_ec = partial_ec
        self.placement_violations = 0
        self.under_replicated: list[dict] = []
        self.under_parity: list[dict] = []
        self.last_scan_at = 0.0
        self.scan_count = 0
        self._lock = threading.Lock()
        self._tracked: dict[tuple[int, str], RepairTask] = {}
        self._queued: set[tuple[int, str]] = set()
        self._inflight: dict[tuple[int, str], float] = {}
        self._results: deque[dict] = deque(maxlen=50)
        self._queue: queue.Queue[RepairTask | None] = queue.Queue()
        self._poke = threading.Event()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        self._stop.clear()
        self._threads = [threading.Thread(
            target=self._scan_loop, name="repair-scan", daemon=True)]
        if self.enabled:
            self._threads += [threading.Thread(
                target=self._worker, name=f"repair-worker-{i}",
                daemon=True) for i in range(self.concurrency)]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        """Set the stop flag, wake every thread, join each one. A
        repair in flight runs to its end (its HTTP calls time out when
        the servers are gone); its result is still recorded."""
        self._stop.set()
        self._poke.set()
        for _ in range(self.concurrency):
            self._queue.put(None)
        for t in self._threads:
            t.join(timeout=JOIN_TIMEOUT)
        self._threads = []

    def poke(self) -> None:
        """Event-driven rescan request — called on every heartbeat and
        every unregistration, so a lost node is noticed at delta time,
        not at the next interval tick."""
        self._poke.set()

    def queue_depth(self) -> int:
        with self._lock:
            return self._queue.qsize() + len(self._inflight)

    # -- deficit scan ---------------------------------------------------
    def scan(self) -> tuple[list[dict], list[dict]]:
        """One pass over the in-memory topology under its lock:
        under-replicated plain volumes and under-parity EC volumes."""
        topo = self.master.topo
        under_replicated: list[dict] = []
        under_parity: list[dict] = []
        with topo.lock:
            for key, layout in topo.layouts.items():
                want = ReplicaPlacement.parse(key.replication).copy_count
                if want <= 1:
                    continue
                for vid, nodes in layout.locations.items():
                    have = len(nodes)
                    if 0 < have < want:
                        under_replicated.append(
                            {"volume": vid, "collection": key.collection,
                             "have": have, "want": want,
                             "replication": key.replication})
            for vid, shards in topo.ec_locations.items():
                code = geo.parse_code(topo.ec_codecs.get(vid, ""))
                live_ids = [sid for sid, nodes in shards.items()
                            if nodes]
                live = len(live_ids)
                if 0 < live < code.total:
                    # recoverability is the code's call (GF(256) rank
                    # for structured codes), not a shard count
                    under_parity.append(
                        {"volume": vid,
                         "collection": topo.ec_collections.get(vid, ""),
                         "have": live, "want": code.total,
                         "code": code.spec,
                         "recoverable": code.recoverable(live_ids)})
        return under_replicated, under_parity

    def enqueue(self, vid: int, kind: str, reason: str,
                collection: str = "") -> bool:
        """External enqueue hook (scrub wiring, /debug/repair POST).
        Dedupes against tracked / in-flight work; repair only runs when
        the queue is enabled, otherwise the task stays visible as
        pending."""
        task = RepairTask(vid=vid, kind=kind, reason=reason,
                          collection=collection)
        with self._lock:
            if task.key in self._inflight:
                return False
            prev = self._tracked.get(task.key)
            if prev is not None:
                # keep attempt history, refresh the reason
                prev.reason = reason
                task = prev
            else:
                self._tracked[task.key] = task
            if self.enabled and task.key not in self._queued:
                self._queued.add(task.key)
                self._queue.put_nowait(task)
            self._report_depth()
        self.poke()
        return True

    # -- introspection --------------------------------------------------
    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            pending = [t.to_dict() for t in self._tracked.values()]
            in_flight = [{"volume": vid, "kind": kind,
                          "running_seconds": round(now - t0, 3)}
                         for (vid, kind), t0 in self._inflight.items()]
            depth = self._queue.qsize() + len(self._inflight)
            recent = list(self._results)
        return {
            "enabled": self.enabled,
            "interval": self.interval,
            "concurrency": self.concurrency,
            "max_attempts": self.max_attempts,
            "grace": self.grace,
            "max_bytes_per_sec": self.max_bytes_per_sec,
            "partial_ec": self.partial_ec,
            "placement_violations": self.placement_violations,
            "queue_depth": depth,
            "scan_count": self.scan_count,
            "last_scan_age_seconds": (
                round(now - self.last_scan_at, 3)
                if self.last_scan_at else None),
            "under_replicated": self.under_replicated,
            "under_parity": self.under_parity,
            "pending": pending,
            "in_flight": in_flight,
            "recent": recent,
        }

    def _report_depth(self) -> None:
        """Caller holds self._lock."""
        metrics.gauge_set("repair_queue_depth",
                          self._queue.qsize() + len(self._inflight))

    # -- scan loop ------------------------------------------------------
    def _scan_loop(self) -> None:
        while not self._stop.is_set():
            if self._poke.wait(self.interval):
                # coalesce a burst of heartbeat deltas into one scan
                self._stop.wait(min(0.05, self.interval / 4))
            self._poke.clear()
            if self._stop.is_set():
                return
            raft = self.master.raft
            if raft is not None and not raft.is_leader():
                # followers own no topology; drop stale deficit views
                with self._lock:
                    self.under_replicated = []
                    self.under_parity = []
                continue
            try:
                self._scan_once()
            except Exception as e:  # noqa: BLE001 — the loop goes on
                glog.warning("repair watchdog scan failed: %s", e)

    def repair_hold(self) -> float:
        """Seconds before a fresh raft leader may queue repairs (0 on a
        single master or a leader past its first reaper window)."""
        raft = self.master.raft
        if raft is None:
            return 0.0
        window = REAP_PULSES * self.master.topo.pulse_seconds
        return max(0.0, raft.leader_since + window - time.monotonic())

    def _scan_once(self) -> None:
        ur, up = self.scan()
        held = self.repair_hold() > 0
        now = time.monotonic()
        with self._lock:
            self.under_replicated = ur
            self.under_parity = up
            self.last_scan_at = now
            self.scan_count += 1
            seen: set[tuple[int, str]] = set()
            for entry, kind in [(e, "replica") for e in ur] + \
                               [(e, "ec") for e in up]:
                if kind == "ec" and not entry.get("recoverable", True):
                    continue  # < k shards: rebuild is impossible
                key = (entry["volume"], kind)
                seen.add(key)
                task = self._tracked.get(key)
                if task is None:
                    task = RepairTask(vid=entry["volume"], kind=kind,
                                      reason="watchdog",
                                      collection=entry.get("collection",
                                                           ""))
                    self._tracked[key] = task
                task.have = entry["have"]
                task.want = entry["want"]
            # deficits that healed on their own (node came back) drop out
            for key in list(self._tracked):
                if key not in seen and key not in self._inflight and \
                        self._tracked[key].reason == "watchdog" and \
                        key not in self._queued:
                    self._tracked.pop(key)
            if self.enabled and not held:
                for key, task in list(self._tracked.items()):
                    if key in self._queued or key in self._inflight:
                        continue
                    if now - task.first_seen < self.grace:
                        continue
                    if now < task.not_before:
                        continue
                    self._queued.add(key)
                    self._queue.put_nowait(task)
            self._report_depth()

    # -- repair workers -------------------------------------------------
    def _worker(self) -> None:
        while not self._stop.is_set():
            task = self._queue.get()
            if task is None or self._stop.is_set():
                return
            with self._lock:
                self._queued.discard(task.key)
                if task.key not in self._tracked:
                    continue  # healed while queued
                self._inflight[task.key] = time.monotonic()
                self._report_depth()
            t0 = time.monotonic()
            try:
                detail, repaired_bytes = self._repair_one(task)
                ok, err = True, ""
            except Exception as e:  # noqa: BLE001 — recorded, retried
                ok, err, detail, repaired_bytes = False, str(e), {}, 0
            dt = time.monotonic() - t0
            task.attempts += 1
            metrics.histogram_observe(
                "repair_seconds", dt,
                {"kind": task.kind, "outcome": "ok" if ok else "error"})
            if repaired_bytes:
                metrics.counter_add("repair_bytes_total", repaired_bytes,
                                    {"kind": task.kind})
            with self._lock:
                self._inflight.pop(task.key, None)
                self._results.appendleft({
                    "volume": task.vid, "kind": task.kind,
                    "reason": task.reason, "ok": ok,
                    "attempts": task.attempts,
                    "seconds": round(dt, 3), "bytes": repaired_bytes,
                    "error": err, "detail": detail,
                    "finished_at": time.time()})
                if ok or task.attempts >= self.max_attempts:
                    self._tracked.pop(task.key, None)
                else:
                    # full-jitter requeue backoff from the shared
                    # policy; the next scan re-enqueues once not_before
                    # passes
                    task.not_before = time.monotonic() + \
                        _retry.policy().backoff(task.attempts)
                self._report_depth()
            if ok:
                glog.info("repair[%s] volume %d done in %.2fs (%d bytes)",
                          task.kind, task.vid, dt, repaired_bytes)
            elif task.attempts >= self.max_attempts:
                glog.warning("repair[%s] volume %d gave up after %d "
                             "attempts: %s", task.kind, task.vid,
                             task.attempts, err)
            else:
                glog.warning("repair[%s] volume %d attempt %d failed: %s",
                             task.kind, task.vid, task.attempts, err)
                self.poke()

    def _repair_one(self, task: RepairTask) -> tuple[dict, int]:
        """One repair: targeted volume.fix.replication for lost
        replicas, ec.rebuild (through the volume servers' codec) for
        lost shards. Takes the cluster admin lock, as the admin-scripts
        timer does: through a live filer's DLM, so a repair never runs
        while an operator shell (ec.encode mounting shards server by
        server) holds it — the refusal fails this attempt and the task
        is requeued with backoff. Without a filer the lock is
        process-local, as in the reference."""
        from ..shell.commands_ec import ec_rebuild
        from ..shell.commands_volume import volume_fix_replication
        from ..shell.env import CommandEnv

        env = CommandEnv(self.master.admin_scripts_url,
                         filer_url=self.master.live_filer_url())
        try:
            env.acquire_lock()
            if task.kind == "replica":
                fixes = volume_fix_replication(
                    env, volume_id=task.vid,
                    max_bps=self.max_bytes_per_sec)
                moved = 0
                violations = 0
                for f in fixes:
                    moved += int(f.get("bytes", 0))
                    violations += int(f.get("placement_violations", 0))
                self._count_violations("replica", violations)
                return {"fixes": fixes}, moved
            out = ec_rebuild(env, task.vid, collection=task.collection,
                             max_bps=self.max_bytes_per_sec,
                             partial=self.partial_ec)
            self._count_violations(
                "ec", int(out.get("placement_violations", 0)))
            return out, int(out.get("rebuilt_bytes", 0))
        finally:
            env.close()

    def _count_violations(self, kind: str, n: int) -> None:
        """A violation = a repair forced to break rack/DC spread because
        no spread-preserving node had free slots."""
        if n > 0:
            with self._lock:
                self.placement_violations += n
            metrics.counter_add("repair_placement_violations_total", n,
                                {"kind": kind})
