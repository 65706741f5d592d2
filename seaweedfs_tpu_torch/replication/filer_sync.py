"""Active-active filer <-> filer synchronization; the counterpart of
seaweedfs_tpu/replication/filer_sync.py.

Equivalent of SeaweedFS weed/command/filer_sync.go: each side runs a
replicator whose sink writes into the peer tagged with the SOURCE
filer's signature; events whose signature list already contains the
peer's signature are skipped, so an entry written on A and synced to B
does not bounce back to A (signature loop prevention, filer_sync.go's
clientId/signature dance). Each direction keeps its offset in its
source filer's KV under sync/<peer signature>/offset.
"""
from __future__ import annotations

from ..rpc.httpclient import session
from .replicator import Replicator
from .sink import FilerSink


def _signature_of(filer_url: str) -> int:
    url = filer_url.rstrip("/") if filer_url.startswith("http") \
        else f"http://{filer_url}"
    return int(session().get(f"{url}/status",
                             timeout=10).json()["signature"])


class FilerSync:
    """Bidirectional (or one-way) sync between two filers."""

    def __init__(self, filer_a: str, filer_b: str,
                 path_prefix: str = "/", both_ways: bool = True):
        sig_a = _signature_of(filer_a)
        sig_b = _signature_of(filer_b)
        # A -> B: skip events B has already seen; tag writes into B
        # with A's signature so B's own events name A as origin
        self.a_to_b = Replicator(
            filer_a,
            FilerSink(filer_b, dest_path=path_prefix, signature=sig_a),
            path_prefix=path_prefix,
            offset_key=f"sync/{sig_b}/offset",
            exclude_signature=sig_b)
        self.b_to_a = Replicator(
            filer_b,
            FilerSink(filer_a, dest_path=path_prefix, signature=sig_b),
            path_prefix=path_prefix,
            offset_key=f"sync/{sig_a}/offset",
            exclude_signature=sig_a) if both_ways else None

    def start(self) -> None:
        self.a_to_b.start()
        if self.b_to_a is not None:
            self.b_to_a.start()

    def stop(self) -> None:
        self.a_to_b.stop()
        if self.b_to_a is not None:
            self.b_to_a.stop()
