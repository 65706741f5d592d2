"""Read-only master follower; the counterpart of
seaweedfs_tpu/server/master_follower.py.

Equivalent of SeaweedFS weed/command/master_follower.go: a stateless
service that takes no part in raft and holds no topology. It follows
the masters through a subscribed MasterClient (the KeepConnected
stream, wdclient/client.py) and answers /dir/lookup by volume id
(`?volumeId=4`) or by file id (`?fileId=4,49c...`) from that cache, so
lookup traffic never reaches the leader once the stream has warmed it;
/status reports the masters it follows and the volumes it caches.
"""
from __future__ import annotations

from ..rpc.http import App, Request, Response, json_error, json_ok
from ..utils import retry
from ..wdclient.client import MasterClient


class MasterFollower:
    def __init__(self, master_urls: list[str] | str):
        self.client = MasterClient(master_urls, subscribe=True)
        self.app = self.build_app()

    def build_app(self) -> App:
        # the reference's app: the deadline middleware alone, and
        # aiohttp's default 1 MiB body cap
        app = App(middlewares=[retry.middleware("master-follower")],
                  max_body=1 << 20)
        app.get("/dir/lookup", self.handle_lookup)
        app.get("/status", self.handle_status)
        app.on_cleanup.append(self.client.stop)
        return app

    def handle_lookup(self, req: Request) -> Response:
        vid_s = req.query.get("volumeId", "") or req.query.get("fileId", "")
        try:
            vid = int(vid_s.split(",")[0])
        except ValueError:
            return json_error(f"unparsable volume id {vid_s!r}", status=400)
        locs = self.client.lookup(vid)
        if not locs:
            return json_error(f"volume {vid} not found", status=404)
        return json_ok({"volumeId": str(vid), "locations": locs})

    def handle_status(self, req: Request) -> Response:
        return json_ok({
            "isFollower": True,
            "masters": self.client.masters,
            "leader": self.client.master_url,
            "cachedVolumes": self.client.cached_volumes(),
        })
