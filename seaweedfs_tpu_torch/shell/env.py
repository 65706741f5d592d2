"""Shell command environment: master access + the admin lock; the
counterpart of seaweedfs_tpu/shell/env.py.

Equivalent of SeaweedFS weed/shell/commands.go:41-78 (command interface
+ CommandEnv.confirmIsLocked). The admin lock is held in this process
(single-operator mode), as the reference does when it knows no filer.
`filer_url` only names the filer whose namespace volume.fsck walks.
Not here: the filer DLM path (cluster/lock_manager).
"""
from __future__ import annotations

import time

from ..ec import geometry as geo
from ..rpc.httpclient import session


class ShellError(Exception):
    pass


class CommandEnv:
    def __init__(self, master_url: str, filer_url: str = ""):
        self.master_url = master_url.rstrip("/")
        self.filer_url = filer_url.rstrip("/")
        self.locked = False

    # -- master helpers -------------------------------------------------
    def master_get(self, path: str, **params) -> dict:
        resp = session().get(f"{self.master_url}{path}", params=params,
                             timeout=60)
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
    def confirm_locked(self) -> None:
        if not self.locked:
            raise ShellError(
                "lock is required: run `lock` before cluster-mutating "
                "commands")

    def acquire_lock(self) -> None:
        self.locked = True

    def release_lock(self) -> None:
        self.locked = False

    def close(self) -> None:
        """Release the admin lock on shell exit."""
        if self.locked:
            self.release_lock()

    def wait_for_ec_registration(self, vid: int, min_shards: int,
                                 timeout: float = 20.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            locs = self.ec_shard_locations(vid)
            if sum(len(v) for v in locs.values()) >= min_shards:
                return
            time.sleep(0.1)
        raise ShellError(f"ec shards of volume {vid} not registered in time")
