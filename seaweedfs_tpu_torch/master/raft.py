"""Raft consensus for HA masters; the counterpart of
seaweedfs_tpu/master/raft.py.

Equivalent of SeaweedFS's hashicorp-raft integration
(weed/server/raft_hashicorp.go:99 NewHashicorpRaftServer,
raft_server.go:72 StateMachine.Apply): leader election and a replicated
log whose state machine is the cluster's MaxVolumeId, the one fact the
masters must agree on before handing out volume ids. Membership changes
(`add_peer` / `remove_peer`) ride the same log, and once the applied log
passes `compact_threshold` entries the prefix is folded into a snapshot
that a follower left behind receives by InstallSnapshot.

Threads take the place of the reference's asyncio tasks: an election
thread per node; on the leader, a supervisor thread that keeps one
replication thread per peer (a dead peer's RPC timeout never delays the
live ones); one thread per vote request. One lock guards term, vote,
log and commit state, and it is never held across an RPC. Term and vote
are persisted before a vote reply. `on_apply` runs under that lock, in
log order, so it must not call back into the node.

Unlike the reference, a leader that no majority of its peers has
answered for an election window steps down (check-quorum): a leader
cut off from the other masters but not from the volume servers then
stops taking their heartbeats, and they find the leader the others
elected, instead of two masters each holding part of the topology.

The RPCs and the JSON sidecar (`raft_<host>_<port>.json` in
`state_dir`) have the reference's layout, so port and reference masters
form one quorum and a state directory written by either loads in the
other. `MemoryTransport` runs a cluster in one process (with
partitions); `HTTPTransport` carries /raft/request_vote,
/raft/append_entries and /raft/install_snapshot between masters, and
`http_routes` serves them with /raft/status.
"""
from __future__ import annotations

import json
import os
import queue
import random
import threading
import time
from dataclasses import dataclass

from ..utils import glog

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"

# how long stop() waits for each thread
JOIN_TIMEOUT = 5.0


@dataclass
class LogEntry:
    term: int
    command: dict  # {"op": "max_volume_id", "value": N}

    def to_json(self) -> dict:
        return {"term": self.term, "command": self.command}

    @staticmethod
    def from_json(d: dict) -> "LogEntry":
        return LogEntry(d["term"], d["command"])


class MaxVolumeIdFSM:
    """The replicated state machine: a monotonic volume-id high-water
    mark (raft_server.go:53-99)."""

    def __init__(self) -> None:
        self.max_volume_id = 0

    def apply(self, command: dict) -> None:
        if command.get("op") == "max_volume_id":
            self.max_volume_id = max(self.max_volume_id,
                                     int(command["value"]))

    def to_dict(self) -> dict:
        return {"max_volume_id": self.max_volume_id}

    def from_dict(self, d: dict) -> None:
        self.max_volume_id = int(d.get("max_volume_id", 0))


class Transport:
    """RPC carrier between raft peers: each call returns the peer's
    reply, or None when the peer could not be reached."""

    def request_vote(self, peer: str, args: dict) -> dict | None:
        raise NotImplementedError

    def append_entries(self, peer: str, args: dict) -> dict | None:
        raise NotImplementedError

    def install_snapshot(self, peer: str, args: dict) -> dict | None:
        raise NotImplementedError


class MemoryTransport(Transport):
    """In-process transport for cluster tests; nodes in `partitioned`
    neither send nor receive."""

    def __init__(self) -> None:
        self.nodes: dict[str, "RaftNode"] = {}
        self.partitioned: set[str] = set()

    def register(self, node: "RaftNode") -> None:
        self.nodes[node.me] = node

    def _reachable(self, a: str, b: str) -> bool:
        return a not in self.partitioned and b not in self.partitioned

    def request_vote(self, peer: str, args: dict) -> dict | None:
        node = self.nodes.get(peer)
        if node is None or not self._reachable(args["candidate"], peer):
            return None
        return node.on_request_vote(args)

    def append_entries(self, peer: str, args: dict) -> dict | None:
        node = self.nodes.get(peer)
        if node is None or not self._reachable(args["leader"], peer):
            return None
        return node.on_append_entries(args)

    def install_snapshot(self, peer: str, args: dict) -> dict | None:
        node = self.nodes.get(peer)
        if node is None or not self._reachable(args["leader"], peer):
            return None
        return node.on_install_snapshot(args)


class HTTPTransport(Transport):
    """The three RPCs as JSON POSTs between master processes."""

    def __init__(self, timeout: float = 2.0) -> None:
        self._timeout = timeout

    def _post(self, peer: str, path: str, args: dict) -> dict | None:
        from ..rpc.httpclient import session

        try:
            resp = session().post(f"http://{peer}{path}", json=args,
                                  timeout=self._timeout)
            if resp.status_code != 200:
                return None
            return resp.json()
        except (OSError, ValueError):
            return None

    def request_vote(self, peer: str, args: dict) -> dict | None:
        return self._post(peer, "/raft/request_vote", args)

    def append_entries(self, peer: str, args: dict) -> dict | None:
        return self._post(peer, "/raft/append_entries", args)

    def install_snapshot(self, peer: str, args: dict) -> dict | None:
        return self._post(peer, "/raft/install_snapshot", args)


class _Waiter:
    """A commit waiter: resolves True only if the entry committed at
    `index` is the one appended under `term` (a deposed leader's
    overwritten entry resolves False)."""

    def __init__(self, index: int, term: int):
        self.index = index
        self.term = term
        self.result = False
        self.done = threading.Event()

    def resolve(self, ok: bool) -> None:
        if not self.done.is_set():
            self.result = ok
            self.done.set()


class RaftNode:
    """One raft participant: election, log replication and commit.
    Timing scales with `tick`: the election window is
    uniform(0.15, 0.3) * tick, the leader's heartbeat 0.05 * tick."""

    def __init__(self, me: str, peers: list[str], transport: Transport,
                 state_dir: str | None = None, tick: float = 1.0,
                 on_apply=None, compact_threshold: int = 1024):
        self.me = me
        self.peers = [p for p in peers if p != me]
        self.transport = transport
        self.state_dir = state_dir
        self.tick = tick
        self.fsm = MaxVolumeIdFSM()
        self.on_apply = on_apply
        self._lock = threading.Lock()

        # persistent state; `log` holds the entries AFTER snap_index, so
        # every absolute 1-based index goes through _entry / _term_at
        self.current_term = 0
        self.voted_for: str | None = None
        self.log: list[LogEntry] = []
        self.snap_index = 0
        self.snap_term = 0
        # FSM state frozen AT snap_index (the live fsm may be ahead)
        self.snap_fsm: dict = {}
        self.compact_threshold = compact_threshold

        # volatile
        self.state = FOLLOWER
        self.commit_index = 0
        self.last_applied = 0
        self.leader_id: str | None = None
        self.next_index: dict[str, int] = {}
        self.match_index: dict[str, int] = {}
        # monotonic time this node last became leader (0: never)
        self.leader_since = 0.0
        # monotonic time of each peer's last reply in this term
        self._acked: dict[str, float] = {}
        self._last_heartbeat = time.monotonic()
        self._term_start_index = 0
        self._waiters: list[_Waiter] = []
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        if self.me not in peers and peers:
            glog.warning("raft: own address %r not found in peers %s — "
                         "check -ip/-port vs -peers spelling; a "
                         "self-alias under another name breaks elections",
                         self.me, peers)
        self._load()

    # ------------------------------------------------------------------
    # persistence (the boltdb-store analog)
    # ------------------------------------------------------------------
    def _state_path(self) -> str | None:
        if not self.state_dir:
            return None
        return os.path.join(self.state_dir,
                            f"raft_{self.me.replace(':', '_')}.json")

    def _persist(self) -> None:
        """Caller holds the lock."""
        path = self._state_path()
        if not path:
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"term": self.current_term,
                       "voted_for": self.voted_for,
                       "peers": self.peers,
                       "snapshot": {"index": self.snap_index,
                                    "term": self.snap_term,
                                    "fsm": self.snap_fsm},
                       "log": [e.to_json() for e in self.log]}, f)
        os.replace(tmp, path)

    def _load(self) -> None:
        path = self._state_path()
        if not path or not os.path.exists(path):
            return
        with open(path) as f:
            d = json.load(f)
        self.current_term = d["term"]
        self.voted_for = d.get("voted_for")
        # membership changes committed through the log survive restarts
        self.peers = [p for p in d.get("peers", self.peers)
                      if p != self.me]
        self.log = [LogEntry.from_json(e) for e in d.get("log", [])]
        snap = d.get("snapshot") or {}
        self.snap_index = int(snap.get("index", 0))
        self.snap_term = int(snap.get("term", 0))
        self.snap_fsm = snap.get("fsm", {}) or {}
        if self.snap_index:
            # the compacted prefix is applied state, not replayable
            self.fsm.from_dict(self.snap_fsm)
            self.commit_index = self.snap_index
            self.last_applied = self.snap_index

    # -- absolute-index helpers over the compacted log (lock held) -----
    def _last_index(self) -> int:
        return self.snap_index + len(self.log)

    def _entry(self, idx: int) -> LogEntry:
        return self.log[idx - self.snap_index - 1]

    def _term_at(self, idx: int) -> int:
        if idx == self.snap_index:
            return self.snap_term
        if idx <= 0 or idx > self._last_index() or idx < self.snap_index:
            return 0
        return self._entry(idx).term

    def _maybe_compact(self) -> None:
        """Fold the applied prefix into the snapshot once the log is
        past the threshold; never past a pending commit waiter."""
        if len(self.log) <= self.compact_threshold:
            return
        if any(w.index <= self.last_applied for w in self._waiters):
            return
        limit = self.last_applied
        if limit <= self.snap_index:
            return
        self.snap_term = self._term_at(limit)
        del self.log[:limit - self.snap_index]
        self.snap_index = limit
        self.snap_fsm = self.fsm.to_dict()
        self._persist()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        self._stop.clear()
        self._spawn(self._election_loop, "raft-election")

    def _spawn(self, fn, name: str, *args) -> threading.Thread:
        t = threading.Thread(target=fn, args=args, name=name, daemon=True)
        self._threads = [x for x in self._threads if x.is_alive()]
        self._threads.append(t)
        t.start()
        return t

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            for w in self._waiters:
                w.resolve(False)
            self._waiters = []
        for t in list(self._threads):
            if t is not threading.current_thread():
                t.join(timeout=JOIN_TIMEOUT)
        self._threads = []

    def _election_timeout(self) -> float:
        return random.uniform(0.15, 0.3) * self.tick

    def _election_loop(self) -> None:
        while True:
            timeout = self._election_timeout()
            if self._stop.wait(timeout / 3):
                return
            if self.state == LEADER:
                continue
            if time.monotonic() - self._last_heartbeat > timeout:
                self._run_election(timeout)

    def _run_election(self, window: float) -> None:
        with self._lock:
            glog.info("raft %s: no leader heard for %.3f s; candidate "
                      "for term %d", self.me,
                      time.monotonic() - self._last_heartbeat,
                      self.current_term + 1)
            self.state = CANDIDATE
            self.current_term += 1
            self.voted_for = self.me
            self.leader_id = None
            # a new full window before the next candidacy
            self._last_heartbeat = time.monotonic()
            self._persist()
            term = self.current_term
            last_idx = self._last_index()
            args = {"term": term, "candidate": self.me,
                    "last_log_index": last_idx,
                    "last_log_term": self._term_at(last_idx)}
            peers = list(self.peers)
            needed = (len(peers) + 1) // 2 + 1
            if needed <= 1:
                self._become_leader()
                return
        # count votes as they arrive: a dead peer's RPC timeout must
        # not stall the election once a majority has answered
        replies: queue.Queue = queue.Queue()
        for p in peers:
            threading.Thread(
                target=lambda p=p: replies.put(
                    self.transport.request_vote(p, args)),
                name="raft-vote", daemon=True).start()
        votes, answered = 1, 0
        end = time.monotonic() + window
        while answered < len(peers) and not self._stop.is_set():
            try:
                r = replies.get(timeout=max(0.0, end - time.monotonic()))
            except queue.Empty:
                return
            answered += 1
            if r is None:
                continue
            with self._lock:
                if self.state != CANDIDATE or self.current_term != term:
                    return
                if r["term"] > self.current_term:
                    self._step_down(r["term"])
                    return
                if r.get("granted"):
                    votes += 1
                if votes >= needed:
                    self._become_leader()
                    return

    def _become_leader(self) -> None:
        """Caller holds the lock."""
        glog.info("raft %s: leader of term %d", self.me, self.current_term)
        self.state = LEADER
        self.leader_id = self.me
        self.leader_since = time.monotonic()
        self.next_index = {p: self._last_index() + 1 for p in self.peers}
        self.match_index = {p: 0 for p in self.peers}
        self._acked = {}
        # a no-op of the new term commits (and so applies) any surviving
        # prior-term entries without waiting for a client proposal
        self.log.append(LogEntry(self.current_term, {"op": "noop"}))
        self._persist()
        self._term_start_index = self._last_index()
        self._spawn(self._lead, "raft-lead", self.current_term)

    def _step_down(self, term: int) -> None:
        """Caller holds the lock. Forgets the old term's leader; the
        election timer is NOT reset (only a granted vote or the
        leader's AppendEntries reset it), so a rejoining node with an
        inflated term cannot livelock the cluster."""
        if term > self.current_term:
            if self.state == LEADER:
                glog.info("raft %s: deposed by term %d", self.me, term)
            self.current_term = term
            self.voted_for = None
            self._persist()
        self.state = FOLLOWER
        self.leader_id = None

    def _leading(self, term: int) -> bool:
        return not self._stop.is_set() and self.state == LEADER and \
            self.current_term == term

    def _lead(self, term: int) -> None:
        """Keep one replication thread per peer for this term, over a
        peer set that membership changes may grow mid-term."""
        loops: dict[str, threading.Thread] = {}
        while self._leading(term):
            for p in list(self.peers):
                t = loops.get(p)
                if t is None or not t.is_alive():
                    loops[p] = self._spawn(self._replicate_loop,
                                           f"raft-repl-{p}", p, term)
            with self._lock:
                self._check_quorum()
                self._advance_commit()
            self._stop.wait(0.05 * self.tick)

    def _check_quorum(self) -> None:
        """Caller holds the lock. Step down once no majority has
        answered within the longest election window: by then the peers
        that no longer hear this leader may have elected another."""
        if self.state != LEADER:
            return
        now = time.monotonic()
        window = 0.3 * self.tick
        if now - self.leader_since < window:
            return
        heard = 1 + sum(
            1 for p in self.peers
            if now - self._acked.get(p, self.leader_since) < window)
        if heard * 2 <= len(self.peers) + 1:
            glog.warning("raft %s: only %d of %d masters answered in "
                         "%.3f s; stepping down from term %d", self.me,
                         heard, len(self.peers) + 1, window,
                         self.current_term)
            self.state = FOLLOWER
            self.leader_id = None
            self._last_heartbeat = now

    def _replicate_loop(self, peer: str, term: int) -> None:
        while self._leading(term) and peer in self.peers:
            self._replicate_one(peer)
            with self._lock:
                self._advance_commit()
            self._stop.wait(0.05 * self.tick)

    def _replicate_one(self, peer: str) -> None:
        with self._lock:
            if self.state != LEADER:
                return
            term = self.current_term
            ni = self.next_index.get(peer, self._last_index() + 1)
            if ni <= self.snap_index:
                # the entries this peer needs are compacted away
                snap = True
                args = {"term": term, "leader": self.me,
                        "snap_index": self.snap_index,
                        "snap_term": self.snap_term,
                        "fsm": dict(self.snap_fsm),
                        "voters": self.peers + [self.me]}
            else:
                snap = False
                prev_idx = ni - 1
                entries = [e.to_json()
                           for e in self.log[ni - self.snap_index - 1:]]
                args = {"term": term, "leader": self.me,
                        "prev_log_index": prev_idx,
                        "prev_log_term": self._term_at(prev_idx),
                        "entries": entries,
                        "leader_commit": self.commit_index}
        r = (self.transport.install_snapshot(peer, args) if snap
             else self.transport.append_entries(peer, args))
        with self._lock:
            if r is None or self.state != LEADER or \
                    self.current_term != term:
                return
            if r["term"] > self.current_term:
                self._step_down(r["term"])
                return
            self._acked[peer] = time.monotonic()
            if snap:
                if r.get("success"):
                    self.match_index[peer] = args["snap_index"]
                    self.next_index[peer] = args["snap_index"] + 1
            elif r.get("success"):
                self.match_index[peer] = max(
                    self.match_index.get(peer, 0),
                    args["prev_log_index"] + len(args["entries"]))
                self.next_index[peer] = self.match_index[peer] + 1
            else:
                self.next_index[peer] = max(1, ni - 1)

    def _advance_commit(self) -> None:
        """Caller holds the lock."""
        if self.state == LEADER:
            n = self._last_index()
            while n > self.commit_index:
                if self._term_at(n) == self.current_term:
                    votes = 1 + sum(1 for p in self.peers
                                    if self.match_index.get(p, 0) >= n)
                    if votes * 2 > len(self.peers) + 1:
                        self.commit_index = n
                        break
                n -= 1
        self._apply_committed()

    def _apply_committed(self) -> None:
        """Caller holds the lock."""
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            cmd = self._entry(self.last_applied).command
            if str(cmd.get("type", "")).startswith("raft."):
                self._apply_conf_change(cmd)
                continue
            self.fsm.apply(cmd)
            if self.on_apply is not None:
                self.on_apply(cmd)
        still = []
        for w in self._waiters:
            if w.index <= self.commit_index:
                # an index inside an installed snapshot reads term 0 and
                # resolves False: the outcome is unknown there, and
                # propose only promises no false positives
                committed = self._term_at(w.index) \
                    if w.index <= self._last_index() else -1
                w.resolve(committed == w.term)
            elif w.index <= self._last_index() and \
                    self._term_at(w.index) != w.term:
                w.resolve(False)  # overwritten before it committed
            else:
                still.append(w)
        self._waiters = still
        self._maybe_compact()

    # ------------------------------------------------------------------
    # membership (single-server changes through the log: the
    # hashicorp-raft AddVoter / RemoveServer behind cluster.raft.add /
    # cluster.raft.remove)
    # ------------------------------------------------------------------
    def _apply_conf_change(self, cmd: dict) -> None:
        peer = cmd.get("peer", "")
        if cmd["type"] == "raft.add_peer":
            if peer and peer != self.me and peer not in self.peers:
                self.peers.append(peer)
                if self.state == LEADER:
                    self.next_index[peer] = self._last_index() + 1
                    self.match_index[peer] = 0
        elif cmd["type"] == "raft.remove_peer":
            if peer in self.peers:
                self.peers.remove(peer)
                self.next_index.pop(peer, None)
                self.match_index.pop(peer, None)
        self._persist()

    def add_peer(self, peer: str, timeout: float = 5.0) -> bool:
        """Leader only: commit a config entry adding `peer` as a voter.
        The new server must be started with the full peer list."""
        return self.propose({"type": "raft.add_peer", "peer": peer},
                            timeout)

    def remove_peer(self, peer: str, timeout: float = 5.0) -> bool:
        """Leader only: commit a config entry removing `peer`."""
        return self.propose({"type": "raft.remove_peer", "peer": peer},
                            timeout)

    # ------------------------------------------------------------------
    # RPC handlers (called by the transport)
    # ------------------------------------------------------------------
    def on_request_vote(self, args: dict) -> dict:
        with self._lock:
            term = args["term"]
            if term > self.current_term:
                self._step_down(term)
            granted = False
            if term == self.current_term and \
                    self.voted_for in (None, args["candidate"]):
                my_last = self._last_index()
                if (args["last_log_term"], args["last_log_index"]) >= \
                        (self._term_at(my_last), my_last):
                    granted = True
                    self.voted_for = args["candidate"]
                    self._last_heartbeat = time.monotonic()
                    self._persist()   # before the reply leaves
            return {"term": self.current_term, "granted": granted}

    def on_append_entries(self, args: dict) -> dict:
        with self._lock:
            term = args["term"]
            if args.get("leader") == self.me:
                # a misconfigured peer list routed our own heartbeat back
                return {"term": self.current_term, "success": False}
            if term < self.current_term:
                return {"term": self.current_term, "success": False}
            if term > self.current_term or self.state != FOLLOWER:
                self._step_down(term)
            self._last_heartbeat = time.monotonic()
            self.leader_id = args["leader"]
            prev_idx = args["prev_log_index"]
            entries = [LogEntry.from_json(e) for e in args["entries"]]
            if prev_idx > self._last_index():
                return {"term": self.current_term, "success": False}
            if prev_idx < self.snap_index:
                # our snapshot covers part of this batch
                skip = self.snap_index - prev_idx
                if skip >= len(entries):
                    return {"term": self.current_term, "success": True}
                entries = entries[skip:]
                prev_idx = self.snap_index
            elif prev_idx > self.snap_index and \
                    self._term_at(prev_idx) != args["prev_log_term"]:
                del self.log[prev_idx - self.snap_index - 1:]
                self._persist()
                return {"term": self.current_term, "success": False}
            idx = prev_idx
            changed = False
            for e in entries:
                idx += 1
                if idx <= self._last_index():
                    if self._term_at(idx) != e.term:
                        del self.log[idx - self.snap_index - 1:]
                        self.log.append(e)
                        changed = True
                else:
                    self.log.append(e)
                    changed = True
            if changed:
                self._persist()
            if args["leader_commit"] > self.commit_index:
                self.commit_index = min(args["leader_commit"],
                                        self._last_index())
                self._apply_committed()
            return {"term": self.current_term, "success": True}

    def on_install_snapshot(self, args: dict) -> dict:
        """Adopt the leader's snapshot when our log is too far behind
        for AppendEntries to bridge."""
        with self._lock:
            term = args["term"]
            if term < self.current_term:
                return {"term": self.current_term, "success": False}
            if term > self.current_term or self.state != FOLLOWER:
                self._step_down(term)
            self._last_heartbeat = time.monotonic()
            self.leader_id = args["leader"]
            snap_index = int(args["snap_index"])
            if snap_index <= self.commit_index:
                return {"term": self.current_term, "success": True}
            self.log = []
            self.snap_index = snap_index
            self.snap_term = int(args["snap_term"])
            self.snap_fsm = args.get("fsm", {}) or {}
            self.fsm.from_dict(self.snap_fsm)
            if args.get("voters"):
                self.peers = [p for p in args["voters"] if p != self.me]
            self.commit_index = snap_index
            self.last_applied = snap_index
            self._persist()
            return {"term": self.current_term, "success": True}

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------
    def is_leader(self) -> bool:
        return self.state == LEADER

    def leader(self) -> str | None:
        return self.leader_id

    def _wait(self, w: _Waiter, timeout: float) -> bool:
        if not w.done.wait(timeout * self.tick):
            with self._lock:
                if w in self._waiters:
                    self._waiters.remove(w)
            return False
        return w.result

    def propose(self, command: dict, timeout: float = 5.0) -> bool:
        """Append a command; True once committed on a majority, False
        if this node is not the leader or the wait timed out."""
        with self._lock:
            if self.state != LEADER:
                return False
            self.log.append(LogEntry(self.current_term, command))
            self._persist()
            w = _Waiter(self._last_index(), self.current_term)
            self._waiters.append(w)
            if not self.peers:
                self._advance_commit()
        return self._wait(w, timeout)

    def barrier(self, timeout: float = 5.0) -> bool:
        """Wait until this leader has applied everything committed in
        prior terms (its own term-start no-op included): what a caller
        needs before reading FSM-derived state such as the volume-id
        high-water mark."""
        with self._lock:
            if self.state != LEADER:
                return False
            if self.last_applied >= self._term_start_index:
                return True
            w = _Waiter(self._term_start_index, self.current_term)
            self._waiters.append(w)
        return self._wait(w, timeout) and self.state == LEADER

    def status(self) -> dict:
        with self._lock:
            return {"me": self.me, "state": self.state,
                    "term": self.current_term, "leader": self.leader_id,
                    "commit_index": self.commit_index,
                    "max_volume_id": self.fsm.max_volume_id,
                    "peers": list(self.peers)}

    def http_routes(self, app) -> None:
        """Serve the RPCs and /raft/status on an rpc/http.App."""
        from ..rpc.http import json_response

        app.post("/raft/request_vote",
                 lambda req: json_response(self.on_request_vote(req.json())))
        app.post("/raft/append_entries",
                 lambda req: json_response(
                     self.on_append_entries(req.json())))
        app.post("/raft/install_snapshot",
                 lambda req: json_response(
                     self.on_install_snapshot(req.json())))
        app.get("/raft/status", lambda req: json_response(self.status()))
