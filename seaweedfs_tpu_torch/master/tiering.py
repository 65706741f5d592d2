"""Tiered-storage lifecycle controller: hot → warm EC → cold remote; the
counterpart of seaweedfs_tpu/master/tiering.py.

This controller watches per-volume heat from heartbeat-reported
read/write activity, seals volumes that cross the idleness threshold
and drives them through the EC encoder (the ec.encode shell verb, so
the volume servers' codec: with "cuda", the hand-written kernel),
offloads the coldest EC volumes' shard bytes to the remote tier
(volume.tier.offload), and recalls a volume back to hot on sustained
re-access (volume.tier.recall + ec.decode). Thresholds follow the
SSD-array EC characterization studies (arXiv 1709.05365, 1906.08602):
age/idleness gates when encoding cold data pays for itself.

Every transition is crash-safe: the per-volume state machine
(hot → sealing → ec → offloading → remote → recalling → hot) is
persisted to ``-tier.stateDir`` (``tiering.json``, atomic tmp + fsync +
rename) before and after each move, the offload/recall primitives are
idempotent with deterministic remote keys, and a restarted leader
reconciles persisted intent against the observed topology and resumes
mid-flight transitions.

Threads take the place of the reference's asyncio tasks, as in
master/watchdog.py: one scan thread waits on a poke Event (or
`interval` seconds), coalesces a burst of pokes into one scan and scans
only on the raft leader; `concurrency` worker threads take tasks from a
queue.Queue. One lock guards `_tracked` / `_queued` / `_inflight` /
`states` (and the read marks and results); neither it nor the
topology's lock is held across a transition. A transition runs the
shell verbs over HTTP against this master, under the cluster admin lock
(through a live filer's DLM when there is one).

A controller that just started, or whose master just took raft
leadership, tracks wants at once but queues no transition of its own
for 5 pulses (REAP_PULSES; the watchdog's repair hold,
master/watchdog.py): its topology fills one heartbeat at a time. A
resumed offload run then would skip the holders not yet registered and
still record the volume remote; a seal would leave a replica that has
not re-registered behind as a writable plain volume beside the EC
shards. The reference queues at once.

Each transition runs inside a root span `tier <transition>` (service
master), so its shell calls are client spans of one trace that the
volume servers' spans join (the reference records none here).
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..utils import glog, metrics, tracing
from ..utils import retry as _retry
from .watchdog import JOIN_TIMEOUT, REAP_PULSES

# the tier-state enum; every metrics label value below comes from it
TIERS = ("hot", "sealing", "ec", "offloading", "remote", "recalling")

# transition verb -> (from-state, transitional-state, end-state)
TRANSITIONS = {
    "seal": ("hot", "sealing", "ec"),
    "offload": ("ec", "offloading", "remote"),
    "recall": ("remote", "recalling", "hot"),
}
_RESUME = {"sealing": "seal", "offloading": "offload",
           "recalling": "recall"}


@dataclass
class TierTask:
    vid: int
    transition: str           # "seal" | "offload" | "recall"
    reason: str               # "controller" | "operator" | "resume"
    collection: str = ""
    attempts: int = 0
    first_seen: float = field(default_factory=time.monotonic)
    not_before: float = 0.0   # monotonic; requeue backoff gate

    @property
    def key(self) -> tuple[int, str]:
        return (self.vid, self.transition)

    def to_dict(self) -> dict:
        return {"volume": self.vid, "transition": self.transition,
                "reason": self.reason, "collection": self.collection,
                "attempts": self.attempts,
                "age_seconds": round(time.monotonic() - self.first_seen,
                                     3)}


class TieringController:
    """Heat tracking and tier bookkeeping are ALWAYS on (cheap scan of
    in-memory topology); actually moving data is opt-in via ``enabled``
    so tests and operator shells keep exclusive control unless the
    lifecycle is requested."""

    def __init__(self, master, enabled: bool = False,
                 interval: float = 30.0, concurrency: int = 1,
                 seal_after_idle: float = 3600.0,
                 offload_after_idle: float = 7200.0,
                 recall_reads: int = 3, recall_window: float = 300.0,
                 max_attempts: int = 5,
                 max_bytes_per_sec: float = 0.0,
                 remote: dict | None = None,
                 state_dir: str = ""):
        self.master = master
        self.enabled = enabled
        self.interval = max(0.05, interval)
        self.concurrency = max(1, concurrency)
        self.seal_after_idle = max(0.0, seal_after_idle)
        self.offload_after_idle = max(0.0, offload_after_idle)
        self.recall_reads = max(1, recall_reads)
        self.recall_window = max(0.1, recall_window)
        self.max_attempts = max(1, max_attempts)
        # -tier.maxBytesPerSec: per-node cap for bulk shard movement,
        # sent with every offload/recall so each volume server shapes
        # its own side against one shared "tier" token bucket; 0 = off
        self.max_bytes_per_sec = max(0.0, max_bytes_per_sec)
        # -tier.remote: the cold-tier client conf; offload is skipped
        # (and manual offloads rejected) until one is configured
        self.remote = remote
        self.state_path = os.path.join(state_dir, "tiering.json") \
            if state_dir else ""
        self._lock = threading.Lock()
        # vid -> {"state", "collection", "updated_at", "transitions"}
        self.states: dict[int, dict] = {}
        self._load_states()
        # recall signal: per-vid (wall time, cumulative read count)
        # samples, pruned to the recall window
        self._read_marks: dict[int, deque] = {}
        self.last_scan_at = 0.0
        self.scan_count = 0
        self._tracked: dict[tuple[int, str], TierTask] = {}
        self._queued: set[tuple[int, str]] = set()
        self._inflight: dict[tuple[int, str], float] = {}
        self._results: deque[dict] = deque(maxlen=50)
        self._queue: queue.Queue[TierTask | None] = queue.Queue()
        self._poke = threading.Event()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._started_at = 0.0

    # -- crash-safe state persistence -----------------------------------
    def _load_states(self) -> None:
        if not self.state_path:
            return
        try:
            with open(self.state_path, encoding="utf-8") as f:
                raw = json.load(f)
            self.states = {int(vid): st
                           for vid, st in raw.get("volumes", {}).items()}
        except FileNotFoundError:
            pass
        except (ValueError, OSError) as e:
            glog.warning("tiering state %s unreadable (%s); starting "
                         "from observed topology", self.state_path, e)

    def _save_states(self) -> None:
        """Atomic tmp+rename: a master crash leaves the old or the new
        state file, never a torn one — the restart-resume guarantee.
        Caller holds self._lock."""
        if not self.state_path:
            return
        os.makedirs(os.path.dirname(self.state_path), exist_ok=True)
        tmp = self.state_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"volumes": {str(v): st
                                   for v, st in self.states.items()}}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.state_path)

    def _set_state_locked(self, vid: int, state: str,
                          collection: str | None = None) -> None:
        st = self.states.setdefault(
            vid, {"state": "hot", "collection": "", "transitions": 0})
        if collection is not None:
            st["collection"] = collection
        if st.get("state") != state:
            st["transitions"] = st.get("transitions", 0) + 1
        st["state"] = state
        st["updated_at"] = time.time()
        self._save_states()

    def _set_state(self, vid: int, state: str,
                   collection: str | None = None) -> None:
        with self._lock:
            self._set_state_locked(vid, state, collection)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        self._stop.clear()
        self._started_at = time.monotonic()
        self._threads = [threading.Thread(
            target=self._scan_loop, name="tier-scan", daemon=True)]
        if self.enabled:
            self._threads += [threading.Thread(
                target=self._worker, name=f"tier-worker-{i}",
                daemon=True) for i in range(self.concurrency)]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        """Set the stop flag, wake every thread, join each one. A
        transition in flight runs to its end (its HTTP calls time out
        when the servers are gone); its result is still recorded."""
        self._stop.set()
        self._poke.set()
        for _ in range(self.concurrency):
            self._queue.put(None)
        for t in self._threads:
            t.join(timeout=JOIN_TIMEOUT)
        self._threads = []

    def poke(self) -> None:
        """Event-driven rescan request from the master's heartbeat
        paths — heat changes are noticed at delta time, not at the
        next interval tick."""
        self._poke.set()

    # -- observation ----------------------------------------------------
    def _observed_tier(self, vid: int) -> str | None:
        """What the live topology says about one volume: a plain
        volume is hot, an EC volume is ec — or remote once every
        shard-holding node reports its shards offloaded.  None =
        not (yet) registered anywhere."""
        topo = self.master.topo
        with topo.lock:
            if vid in topo.ec_locations:
                return "remote" if topo.ec_tier_view(vid)["remote"] \
                    else "ec"
            for node in topo.nodes.values():
                if vid in node.volumes:
                    return "hot"
        return None

    def _plain_heat(self, vid: int) -> float:
        """Wall-clock time of the volume's last write OR read across
        all replicas (0 when never active)."""
        last = 0.0
        with self.master.topo.lock:
            for node in self.master.topo.nodes.values():
                v = node.volumes.get(vid)
                if v is not None:
                    last = max(last, float(v.modified_at),
                               float(v.last_read_at))
        return last

    def _mark_reads_locked(self, vid: int, now: float,
                           count: int) -> int:
        """Record the current cumulative EC read count and return the
        number of reads inside the trailing recall window."""
        marks = self._read_marks.setdefault(vid, deque())
        marks.append((now, count))
        while marks and marks[0][0] < now - self.recall_window:
            marks.popleft()
        return count - marks[0][1] if marks else 0

    def transition_hold(self) -> float:
        """Seconds before this controller may queue transitions of its
        own: REAP_PULSES pulses after it started, and the watchdog's
        repair hold after its master took raft leadership."""
        window = REAP_PULSES * self.master.topo.pulse_seconds
        fresh = self._started_at + window - time.monotonic() \
            if self._started_at else 0.0
        return max(0.0, fresh, self.master.watchdog.repair_hold())

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
                continue  # followers own no topology
            try:
                self._scan_once()
            except Exception as e:  # noqa: BLE001 — the loop goes on
                glog.warning("tiering scan failed: %s", e)

    def _scan_once(self) -> None:
        topo = self.master.topo
        now = time.time()
        with topo.lock:
            plain: dict[int, dict] = {}
            for node in topo.nodes.values():
                for vid, v in node.volumes.items():
                    plain.setdefault(vid, {"collection": v.collection,
                                           "size": 0})
                    plain[vid]["size"] = max(plain[vid]["size"], v.size)
            ec_vids = {vid: topo.ec_collections.get(vid, "")
                       for vid in topo.ec_locations}
            ec_view = {vid: topo.ec_tier_view(vid) for vid in ec_vids}
        with self._lock:
            vids = sorted(set(plain) | set(ec_vids) | set(self.states))
        # observations before the bookkeeping: the topology's lock is
        # never taken under this controller's
        obs_of = {vid: self._observed_tier(vid) for vid in vids}
        heat_of = {vid: self._plain_heat(vid) for vid in vids
                   if vid in plain}
        held = self.transition_hold() > 0
        mono = time.monotonic()
        with self._lock:
            self.last_scan_at = mono
            self.scan_count += 1
            wanted = self._want_locked(vids, plain, ec_vids, ec_view,
                                       obs_of, heat_of, now)
            self._report_tier_counts()
            for task in wanted:
                prev = self._tracked.get(task.key)
                if prev is not None:
                    task = prev
                else:
                    self._tracked[task.key] = task
                if not self.enabled or held:
                    continue
                if task.key in self._queued or task.key in self._inflight:
                    continue
                if mono < task.not_before:
                    continue
                self._queued.add(task.key)
                self._queue.put_nowait(task)
            # drop wants that no longer hold (volume warmed up again)
            keys_wanted = {t.key for t in wanted}
            for key in list(self._tracked):
                if key not in keys_wanted and key not in self._queued and \
                        key not in self._inflight and \
                        self._tracked[key].reason != "operator":
                    self._tracked.pop(key)

    def _want_locked(self, vids, plain, ec_vids, ec_view, obs_of,
                     heat_of, now) -> list[TierTask]:
        """The reference's per-volume reconcile and decide pass
        (tiering.py:265-352) on one topology snapshot. Caller holds
        self._lock."""
        wanted: list[TierTask] = []
        for vid in vids:
            obs = obs_of[vid]
            st = self.states.get(vid)
            state = st["state"] if st else None
            collection = (st or {}).get("collection") or \
                plain.get(vid, {}).get("collection", "") or \
                ec_vids.get(vid, "")
            # reconcile persisted intent with observed topology: a
            # transition that completed before a crash is recognized
            # by its end state having materialized
            if state == "sealing" and obs == "ec":
                self._finish_observed(vid, "sealing", "ec")
                state = "ec"
            elif state == "offloading" and obs == "remote":
                self._finish_observed(vid, "offloading", "remote")
                state = "remote"
            elif state == "recalling" and obs == "hot":
                self._finish_observed(vid, "recalling", "hot")
                state = "hot"
            elif state is None and obs is not None:
                state = obs
                self.states.setdefault(
                    vid, {"state": obs, "collection": collection,
                          "updated_at": now, "transitions": 0})
            elif state in ("hot", "ec", "remote") and obs is not None \
                    and obs != state:
                # external change (operator ran ec.encode/decode by
                # hand, or a rebuild wrote local shards): adopt the
                # observed tier
                self._set_state_locked(vid, obs, collection)
                state = obs
            if state is None:
                continue
            # mid-flight transitional states resume their verb
            if state in _RESUME:
                verb = _RESUME[state]
                if verb != "offload" or self.remote is not None:
                    wanted.append(TierTask(vid=vid, transition=verb,
                                           reason="resume",
                                           collection=collection))
                continue
            updated_at = float((st or {}).get("updated_at", 0.0))
            if state == "hot" and vid in plain and \
                    plain[vid]["size"] > 0:
                idle = now - max(heat_of[vid], updated_at)
                if idle >= self.seal_after_idle:
                    wanted.append(TierTask(vid=vid, transition="seal",
                                           reason="controller",
                                           collection=collection))
            elif state == "ec" and vid in ec_vids and \
                    self.remote is not None:
                idle = now - max(ec_view[vid]["last_read_at"], updated_at)
                if idle >= self.offload_after_idle:
                    wanted.append(TierTask(vid=vid,
                                           transition="offload",
                                           reason="controller",
                                           collection=collection))
            elif state == "remote" and vid in ec_vids:
                if self._mark_reads_locked(
                        vid, now, ec_view[vid]["read_count"]) >= \
                        self.recall_reads:
                    wanted.append(TierTask(vid=vid, transition="recall",
                                           reason="controller",
                                           collection=collection))
        # forget volumes that vanished from both topology and intent
        for vid in list(self.states):
            if vid not in plain and vid not in ec_vids and \
                    self.states[vid].get("state") not in _RESUME:
                self.states.pop(vid)
                self._read_marks.pop(vid, None)
        return wanted

    def _finish_observed(self, vid: int, frm: str, to: str) -> None:
        """A transition whose end state materialized without this
        process running the verb (crash-resume discovery). Caller
        holds self._lock."""
        self._set_state_locked(vid, to)
        metrics.counter_add("tier_transitions_total", 1,
                            {"from": frm, "to": to,
                             "outcome": "resumed"})

    def _tier_counts_locked(self) -> dict[str, int]:
        counts = {t: 0 for t in TIERS}
        for st in self.states.values():
            counts[st.get("state", "hot")] = \
                counts.get(st.get("state", "hot"), 0) + 1
        return counts

    def _report_tier_counts(self) -> None:
        """Caller holds self._lock."""
        for tier, n in self._tier_counts_locked().items():
            metrics.gauge_set("tier_volume_count", n, {"tier": tier})

    # -- manual + queue entry -------------------------------------------
    def enqueue(self, vid: int, transition: str,
                reason: str = "operator",
                collection: str = "") -> bool:
        """External enqueue hook (POST /debug/tiering). Validates the
        verb, dedupes against in-flight work; the move only actually
        runs when the queue is enabled."""
        if transition not in TRANSITIONS:
            raise ValueError(
                f"unknown transition {transition!r}; "
                f"known: {sorted(TRANSITIONS)}")
        if transition == "offload" and self.remote is None:
            raise ValueError(
                "no cold tier configured (-tier.remote)")
        task = TierTask(vid=vid, transition=transition, reason=reason,
                        collection=collection)
        with self._lock:
            if task.key in self._inflight:
                return False
            prev = self._tracked.get(task.key)
            if prev is not None:
                prev.reason = reason
                task = prev
            else:
                self._tracked[task.key] = task
            if self.enabled and task.key not in self._queued:
                self._queued.add(task.key)
                self._queue.put_nowait(task)
        self.poke()
        return True

    # -- transition workers ---------------------------------------------
    def _worker(self) -> None:
        while not self._stop.is_set():
            task = self._queue.get()
            if task is None or self._stop.is_set():
                return
            with self._lock:
                self._queued.discard(task.key)
                if task.key not in self._tracked:
                    continue  # want disappeared while queued
                self._inflight[task.key] = time.monotonic()
            frm, _, to = TRANSITIONS[task.transition]
            t0 = time.monotonic()
            try:
                with tracing.span(f"tier {task.transition}",
                                  service="master", peer=str(task.vid)):
                    detail, moved = self._transition_one(task)
                ok, err = True, ""
            except Exception as e:  # noqa: BLE001 — recorded, retried
                ok, err, detail, moved = False, str(e), {}, 0
            dt = time.monotonic() - t0
            task.attempts += 1
            metrics.counter_add("tier_transitions_total", 1,
                                {"from": frm, "to": to,
                                 "outcome": "ok" if ok else "error"})
            with self._lock:
                self._inflight.pop(task.key, None)
                self._results.appendleft({
                    "volume": task.vid, "transition": task.transition,
                    "reason": task.reason, "ok": ok,
                    "attempts": task.attempts, "seconds": round(dt, 3),
                    "bytes": moved, "error": err, "detail": detail,
                    "finished_at": time.time()})
                if ok:
                    self._tracked.pop(task.key, None)
                    if task.transition == "recall":
                        self._read_marks.pop(task.vid, None)
                elif task.attempts >= self.max_attempts:
                    self._tracked.pop(task.key, None)
                else:
                    # full-jitter requeue backoff from the shared
                    # policy; the next scan re-enqueues once not_before
                    # passes (the persisted transitional state keeps
                    # the intent)
                    task.not_before = time.monotonic() + \
                        _retry.policy().backoff(task.attempts)
            if ok:
                glog.info("tier[%s] volume %d done in %.2fs (%d bytes)",
                          task.transition, task.vid, dt, moved)
            elif task.attempts >= self.max_attempts:
                glog.warning("tier[%s] volume %d gave up after %d "
                             "attempts: %s", task.transition, task.vid,
                             task.attempts, err)
            else:
                glog.warning("tier[%s] volume %d attempt %d failed: %s",
                             task.transition, task.vid, task.attempts,
                             err)
                self.poke()

    def _transition_one(self, task: TierTask) -> tuple[dict, int]:
        """One transition, holding the cluster admin lock like the
        admin-scripts timer — tier moves serialize against operator
        shells and the repair queue.

        The transitional state is persisted BEFORE any data moves:
        a crash mid-move leaves "sealing"/"offloading"/"recalling" on
        disk and the restarted controller resumes the (idempotent)
        verb instead of forgetting the volume in limbo."""
        from ..shell.commands_ec import ec_encode
        from ..shell.commands_volume import (volume_tier_offload,
                                             volume_tier_recall)
        from ..shell.env import CommandEnv

        _, transitional, to = TRANSITIONS[task.transition]
        self._set_state(task.vid, transitional, task.collection)
        env = CommandEnv(self.master.admin_scripts_url,
                         filer_url=self.master.live_filer_url())
        try:
            env.acquire_lock()
            if task.transition == "seal":
                if self._observed_tier(task.vid) == "ec":
                    # resume: the encode finished before the crash
                    placement, moved = {"resumed": True}, 0
                else:
                    placement = ec_encode(env, task.vid,
                                          collection=task.collection)
                    moved = 0
                self._set_state(task.vid, to, task.collection)
                return {"placement": {str(k): v for k, v
                                      in placement.items()}}, moved
            if task.transition == "offload":
                if self.remote is None:
                    raise ValueError(
                        "no cold tier configured (-tier.remote)")
                out = volume_tier_offload(
                    env, task.vid, self.remote,
                    max_bps=self.max_bytes_per_sec)
                moved = sum(int(r.get("moved_bytes", 0)) for r in out)
                self._set_state(task.vid, to, task.collection)
                return {"servers": out}, moved
            out = volume_tier_recall(env, task.vid,
                                     max_bps=self.max_bytes_per_sec,
                                     decode=True)
            moved = sum(int(r.get("moved_bytes", 0))
                        for r in out.get("recalled", []))
            self._set_state(task.vid, to, task.collection)
            return out, moved
        finally:
            env.close()

    # -- introspection --------------------------------------------------
    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            return {
                "enabled": self.enabled,
                "interval": self.interval,
                "concurrency": self.concurrency,
                "seal_after_idle": self.seal_after_idle,
                "offload_after_idle": self.offload_after_idle,
                "recall_reads": self.recall_reads,
                "recall_window": self.recall_window,
                "max_attempts": self.max_attempts,
                "max_bytes_per_sec": self.max_bytes_per_sec,
                "remote_configured": self.remote is not None,
                "state_path": self.state_path,
                "tier_counts": self._tier_counts_locked(),
                "queue_depth": self._queue.qsize() + len(self._inflight),
                "scan_count": self.scan_count,
                "last_scan_age_seconds": (
                    round(now - self.last_scan_at, 3)
                    if self.last_scan_at else None),
                "volumes": {str(vid): dict(st)
                            for vid, st in sorted(self.states.items())},
                "pending": [t.to_dict() for t in self._tracked.values()],
                "in_flight": [{"volume": vid, "transition": tr,
                               "running_seconds": round(now - t0, 3)}
                              for (vid, tr), t0 in self._inflight.items()],
                "recent": list(self._results),
            }
