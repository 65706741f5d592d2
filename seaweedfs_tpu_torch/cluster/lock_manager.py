"""Distributed lock manager, consistent-hashed over the live filers;
the counterpart of seaweedfs_tpu/cluster/lock_manager.py.

Equivalent of SeaweedFS weed/cluster/lock_manager/
distributed_lock_manager.go:13-93 + lock_ring.go: every named lock has
one home filer chosen by hashing the name onto the sorted ring of live
filers; a request landing on the wrong filer is answered with a
"moved" hint naming the right one, which clients follow (the
reference's filer_grpc_server_dlm.go does the same over gRPC). Locks
are exclusive, owned by a renewal token, and expire by TTL so a dead
holder cannot wedge the cluster. `DlmClient.lock` does not wait on
contention: a held lock raises at once, as in the reference.

One departure: `DlmClient.close()` joins its renewer thread before it
releases the locks, where the reference only signals it.
"""
from __future__ import annotations

import bisect
import secrets
import threading
import time
import zlib

from ..rpc.httpclient import session

# how long close() waits for the renewer thread
JOIN_TIMEOUT = 10.0


class LockMoved(Exception):
    """Raised (server-side) / signalled (wire) when a lock's home is a
    different filer; carries the correct address."""

    def __init__(self, host: str):
        super().__init__(f"lock moved to {host}")
        self.host = host


class LockNotOwned(Exception):
    pass


class RingEmpty(Exception):
    """The lock ring has no servers yet (membership not pulsed):
    grants must be refused or two filers could each think they own
    every lock."""


class LockRing:
    """Consistent-hash ring of live filer addresses; a lock name maps
    to the first virtual node at or after its hash (lock_ring.go).
    Consistent hashing (vs mod-N) keeps most lock homes stable when a
    filer joins or leaves — membership changes move only ~1/N of the
    names, shrinking the pulse-skew window in which two filers can
    disagree about a lock's home (that window is bounded by the
    announce pulse; disagreement resolves via moved hints + renewal
    rejection at the new home)."""

    VNODES = 32

    def __init__(self) -> None:
        self._servers: list[str] = []
        self._points: list[tuple[int, str]] = []
        self._lock = threading.Lock()

    def set_servers(self, servers: list[str]) -> None:
        pts = []
        for s in set(servers):
            for i in range(self.VNODES):
                pts.append((zlib.crc32(f"{s}#{i}".encode()), s))
        pts.sort()
        with self._lock:
            self._servers = sorted(set(servers))
            self._points = pts

    def servers(self) -> list[str]:
        with self._lock:
            return list(self._servers)

    def owner_of(self, name: str) -> str | None:
        h = zlib.crc32(name.encode())
        with self._lock:
            if not self._points:
                return None
            idx = bisect.bisect_left(self._points, (h, ""))
            if idx == len(self._points):
                idx = 0
            return self._points[idx][1]


class _Lock:
    __slots__ = ("token", "owner", "expires_at")

    def __init__(self, token: str, owner: str, expires_at: float):
        self.token = token
        self.owner = owner
        self.expires_at = expires_at


class DistributedLockManager:
    """One filer's share of the lock space."""

    def __init__(self, me: str, ring: LockRing | None = None):
        self.me = me
        self.ring = ring or LockRing()
        self._locks: dict[str, _Lock] = {}
        self._mu = threading.Lock()

    def _home(self, name: str) -> str | None:
        return self.ring.owner_of(name)

    def lock(self, name: str, owner: str, ttl: float = 10.0,
             token: str = "") -> str:
        """Acquire or renew. Returns the renewal token.
        Raises LockMoved if this filer is not the lock's home, or
        PermissionError if held by someone else."""
        home = self._home(name)
        if home is None:
            raise RingEmpty("lock ring empty: membership not yet known")
        if home != self.me:
            raise LockMoved(home)
        now = time.monotonic()
        with self._mu:
            cur = self._locks.get(name)
            if cur is not None and cur.expires_at > now:
                if token and cur.token == token:
                    cur.expires_at = now + ttl  # renewal
                    return cur.token
                if token:
                    raise LockNotOwned(
                        f"stale renewal token for lock {name}")
                raise PermissionError(
                    f"lock {name} held by {cur.owner}")
            if token:
                # a renewal must never resurrect a lock that was
                # released or expired out from under its holder —
                # the holder has to learn it lost the lock
                raise LockNotOwned(
                    f"lock {name} no longer held (expired/released)")
            new = _Lock(secrets.token_hex(8), owner, now + ttl)
            self._locks[name] = new
            return new.token

    def unlock(self, name: str, token: str) -> None:
        with self._mu:
            cur = self._locks.get(name)
            if cur is None:
                return
            if cur.token != token:
                raise LockNotOwned(f"wrong token for lock {name}")
            del self._locks[name]

    def find_owner(self, name: str) -> str | None:
        home = self._home(name)
        if home is None:
            raise RingEmpty("lock ring empty: membership not yet known")
        if home != self.me:
            raise LockMoved(home)
        now = time.monotonic()
        with self._mu:
            cur = self._locks.get(name)
            if cur is None or cur.expires_at <= now:
                return None
            return cur.owner


class DlmClient:
    """Client side: tries a seed filer, follows moved hints, renews in
    the background while held (shell/commands.go:78 confirmIsLocked
    rides on this)."""

    def __init__(self, filers: list[str] | str, owner: str = "",
                 ttl: float = 10.0):
        if isinstance(filers, str):
            filers = [filers]
        self.filers = [f.rstrip("/") if f.startswith("http")
                       else f"http://{f}" for f in filers]
        self.owner = owner or f"client-{secrets.token_hex(4)}"
        self.ttl = ttl
        self._held: dict[str, tuple[str, str]] = {}  # name -> (filer, token)
        self._mu = threading.Lock()  # guards _held vs the renewer
        self._renewer: threading.Thread | None = None
        self._stop = threading.Event()

    # one lock request against one filer; returns (ok, moved_to, err)
    def _try(self, filer: str, path: str, body: dict):
        resp = session().post(f"{filer}{path}", json=body, timeout=10)
        d = resp.json()
        if resp.status_code == 200:
            return d, None, None
        if resp.status_code == 409 and d.get("moved"):
            host = d["moved"]
            return None, host if host.startswith("http") \
                else f"http://{host}", None
        return None, None, d.get("error", f"http {resp.status_code}")

    def _request(self, path: str, body: dict, start: str | None = None):
        tried = set()
        candidates = ([start] if start else []) + self.filers
        last_err = None
        for _ in range(8):
            target = next((c for c in candidates if c not in tried), None)
            if target is None:
                break
            tried.add(target)
            try:
                d, moved, err = self._try(target, path, body)
            except Exception as e:
                last_err = str(e)
                continue
            if d is not None:
                return target, d
            if moved is not None:
                candidates.insert(0, moved)
                tried.discard(moved)
                continue
            last_err = err
            if err and "held by" in err:
                break  # contention is definitive, not routable
        raise RuntimeError(last_err or "no filer reachable for lock rpc")

    # how long lock() waits out "ring empty" (a filer that hasn't seen
    # its own membership announce pulse yet — a startup transient, not
    # a lock conflict; shows up under CI load right after cluster boot)
    RING_WAIT = 10.0

    def lock(self, name: str) -> None:
        deadline = time.monotonic() + self.RING_WAIT
        while True:
            with self._mu:
                held = self._held.get(name)
            body = {"name": name, "owner": self.owner, "ttl": self.ttl}
            if held is not None:
                # already ours: renew instead of contending with ourselves
                body["token"] = held[1]
            try:
                filer, d = self._request("/dlm/lock", body,
                                         start=held[0] if held else None)
            except RuntimeError as e:
                if "ring empty" in str(e) and time.monotonic() < deadline:
                    time.sleep(0.2)
                    continue
                raise
            break
        with self._mu:
            self._held[name] = (filer, d["token"])
        self._ensure_renewer()

    def unlock(self, name: str) -> None:
        with self._mu:
            held = self._held.pop(name, None)
        if held is None:
            return
        filer, token = held
        self._request("/dlm/unlock", {"name": name, "token": token},
                      start=filer)

    def find_owner(self, name: str) -> str | None:
        _, d = self._request("/dlm/find", {"name": name})
        return d.get("owner")

    def close(self) -> None:
        """Stop the renewer (and wait for it), then release every lock
        still held: a renewer left running would keep a lock alive
        after its holder is gone."""
        self._stop.set()
        renewer, self._renewer = self._renewer, None
        if renewer is not None and renewer is not threading.current_thread():
            renewer.join(timeout=JOIN_TIMEOUT)
        for name in list(self._held):
            try:
                self.unlock(name)
            except Exception:  # noqa: BLE001 — the TTL frees it anyway
                pass

    # -- background renewal --------------------------------------------
    def _ensure_renewer(self) -> None:
        if self._renewer is not None and self._renewer.is_alive():
            return
        self._stop.clear()
        self._renewer = threading.Thread(target=self._renew_loop,
                                         name="dlm-renew", daemon=True)
        self._renewer.start()

    def _renew_loop(self) -> None:
        while not self._stop.wait(self.ttl / 3):
            with self._mu:
                snapshot = list(self._held.items())
            for name, (filer, token) in snapshot:
                try:
                    new_filer, d = self._request(
                        "/dlm/lock",
                        {"name": name, "owner": self.owner,
                         "ttl": self.ttl, "token": token}, start=filer)
                    with self._mu:
                        # unlock() may have raced this renewal: only
                        # record it if the lock is still held
                        if name in self._held:
                            self._held[name] = (new_filer, d["token"])
                except Exception:
                    # lost the lock (ring moved + expiry); drop it so
                    # confirm() can tell the caller
                    with self._mu:
                        self._held.pop(name, None)

    def is_held(self, name: str) -> bool:
        with self._mu:
            return name in self._held
