"""Filer replication: sinks, the replicator, active-active filer.sync
and the metadata backup; the counterpart of seaweedfs_tpu/replication/
(SeaweedFS weed/replication/ and the command/filer_replicate.go,
filer_sync.go, filer_backup.go, filer_meta_backup.go workers)."""
from .replicator import Replicator
from .sink import FilerSink, LocalSink, S3Sink, make_sink

__all__ = ["Replicator", "FilerSink", "LocalSink", "S3Sink",
           "make_sink"]
