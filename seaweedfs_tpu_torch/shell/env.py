"""Shell command environment: master access + the admin lock; the
counterpart of seaweedfs_tpu/shell/env.py.

Equivalent of SeaweedFS weed/shell/commands.go:41-78 (command interface
+ CommandEnv.confirmIsLocked). With a filer (`filer_url`), the admin
lock is the filer DLM's `admin` lock (cluster/lock_manager.DlmClient):
cluster-wide, renewed in the background while held, refused at once to
a second holder; the master's watchdog and admin scripts take the same
lock, so their repairs serialize against an operator shell. Without a
filer it is held in this process (single-operator mode), as in the
reference.

`master_url` may list several masters (comma-separated). The shell then
talks to the raft leader: it asks the masters /cluster/leader before
its first request, and finds the leader again when a master stops
answering or has none elected (503), for up to MASTER_FAILOVER_SECONDS.
A follower reads an empty topology, so the shell never reads one.
"""
from __future__ import annotations

import posixpath
import time

from ..ec import geometry as geo
from ..rpc.httpclient import RequestException, session
from ..wdclient.client import find_leader

# how long a request keeps looking for a raft leader
MASTER_FAILOVER_SECONDS = 15.0


class ShellError(Exception):
    pass


class CommandEnv:
    def __init__(self, master_url: str, filer_url: str = ""):
        self.masters = [m if m.startswith("http") else f"http://{m}"
                        for m in (u.strip().rstrip("/")
                                  for u in master_url.split(",")) if m]
        self._leader = self.masters[0] if len(self.masters) == 1 else ""
        self.filer_url = filer_url.rstrip("/")
        self.locked = False
        self._dlm = None
        # fs.cd / fs.pwd working directory (commands.go option.directory)
        self.cwd = "/"

    ADMIN_LOCK = "admin"  # cluster-wide exclusive shell lock name

    def resolve(self, path: str) -> str:
        """Resolve a possibly-relative shell path against fs.cd's cwd."""
        if not path.startswith("/"):
            path = posixpath.join(self.cwd, path)
        norm = posixpath.normpath(path)
        return norm if norm != "." else "/"

    # -- master helpers -------------------------------------------------
    @property
    def master_url(self) -> str:
        """The raft leader's url (the one master, without HA)."""
        if not self._leader:
            self._leader = find_leader(self.masters) or self.masters[0]
        return self._leader

    def master_request(self, method: str, path: str, **kw):
        """One request to the leader. With several masters, a
        connection failure or a 503 (no leader elected) finds the
        leader again and retries, up to MASTER_FAILOVER_SECONDS."""
        if len(self.masters) == 1:
            return session().request(method, f"{self.master_url}{path}",
                                     **kw)
        end = time.monotonic() + MASTER_FAILOVER_SECONDS
        while True:
            try:
                resp = session().request(
                    method, f"{self.master_url}{path}", **kw)
                if resp.status_code != 503 or time.monotonic() > end:
                    return resp
            except RequestException:
                if time.monotonic() > end:
                    raise
            self._leader = ""
            time.sleep(0.2)

    def master_get(self, path: str, **params) -> dict:
        resp = self.master_request("GET", path, params=params, timeout=60)
        # status first: a 502/500 from a proxy carries an HTML body
        # that would raise JSONDecodeError past ShellError-only callers
        if resp.status_code >= 300:
            try:
                detail = resp.json().get("error", resp.status_code)
            except ValueError:
                detail = resp.status_code
            raise ShellError(f"{path}: {detail}")
        try:
            return resp.json()
        except ValueError as e:
            raise ShellError(f"{path}: non-json response: {e}") from e

    def topology(self) -> dict:
        return self.master_get("/cluster/status")["Topology"]

    def data_nodes(self) -> list[dict]:
        out = []
        for dc in self.topology()["datacenters"]:
            for rack in dc["racks"]:
                for n in rack["nodes"]:
                    n = dict(n)
                    n["dc"] = dc["id"]
                    n["rack"] = rack["id"]
                    out.append(n)
        return out

    def ec_shard_locations(self, vid: int) -> dict[int, list[str]]:
        body = self.master_get("/cluster/ec_shards", volumeId=vid)
        return {int(sid): urls for sid, urls in body["shards"].items()}

    def ec_collection(self, vid: int) -> str:
        return self.master_get("/cluster/ec_shards",
                               volumeId=vid).get("collection", "")

    def ec_info(self, vid: int) -> tuple[str, tuple[int, int],
                                         "dict[int, list[str]]"]:
        """(collection, (k, m), {shard_id: [urls]}) in ONE master
        round trip — /cluster/ec_shards carries all three."""
        col, code, locs = self.ec_full_info(vid)
        return col, (code.k, code.m), locs

    def ec_full_info(self, vid: int):
        """(collection, CodeConfig, {shard_id: [urls]}) in ONE master
        round trip — the code config (not just its (k, m) geometry)
        drives rebuild planning for structured codes."""
        body = self.master_get("/cluster/ec_shards", volumeId=vid)
        return (body.get("collection", ""),
                geo.parse_code(body.get("codec", "")),
                {int(sid): urls
                 for sid, urls in body.get("shards", {}).items()})

    def volume_collection(self, vid: int) -> str:
        for n in self.data_nodes():
            col = n.get("collections", {}).get(str(vid))
            if col is not None:
                return col
        return ""

    def volume_locations(self, vid: int) -> list[str]:
        try:
            body = self.master_get("/dir/lookup", volumeId=str(vid))
        except ShellError:
            return []
        return [l["url"] for l in body["locations"]]

    # -- volume server admin -------------------------------------------
    def vs_post(self, server: str, path: str, body: dict,
                timeout: float = 600) -> dict:
        resp = session().post(f"http://{server}{path}", json=body,
                              timeout=timeout)
        try:
            out = resp.json()
        except ValueError:
            out = {"error": resp.text}
        if resp.status_code >= 300:
            raise ShellError(
                f"{server}{path}: {out.get('error', resp.status_code)}")
        return out

    # -- admin lock (commands.go:78 confirmIsLocked) --------------------
    # Cluster-wide exclusive via the filer DLM when a filer is known;
    # process-local otherwise (single-operator mode).
    def confirm_locked(self) -> None:
        if not self.locked:
            raise ShellError(
                "lock is required: run `lock` before cluster-mutating "
                "commands")
        if self._dlm is not None and not self._dlm.is_held(self.ADMIN_LOCK):
            self.locked = False
            raise ShellError(
                "admin lock lost (renewal failed); run `lock` again")

    def acquire_lock(self) -> None:
        if self.filer_url:
            from ..cluster.lock_manager import DlmClient

            if self._dlm is None:
                self._dlm = DlmClient(self.filer_url, owner="shell")
            try:
                self._dlm.lock(self.ADMIN_LOCK)
            except RuntimeError as e:
                raise ShellError(f"cannot acquire admin lock: {e}")
        self.locked = True

    def release_lock(self) -> None:
        if self._dlm is not None:
            try:
                self._dlm.unlock(self.ADMIN_LOCK)
            except RuntimeError:
                pass
        self.locked = False

    def close(self) -> None:
        """Release the admin lock and stop the renewer on shell exit —
        otherwise the cluster-wide lock stays wedged until TTL."""
        if self.locked:
            self.release_lock()
        if self._dlm is not None:
            self._dlm.close()
            self._dlm = None

    def wait_for_ec_registration(self, vid: int, min_shards: int,
                                 timeout: float = 20.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            locs = self.ec_shard_locations(vid)
            if sum(len(v) for v in locs.values()) >= min_shards:
                return
            time.sleep(0.1)
        raise ShellError(f"ec shards of volume {vid} not registered in time")
