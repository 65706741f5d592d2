"""Remote-storage clients; the counterpart of
seaweedfs_tpu/remote_storage/ — its client registry only
(remote_storage/client.py: the "local" and "s3" types). The filer's
remote mounts (mount.py, sync.py, gateway.py) and the gcs / azure
clients are not in seaweedfs_tpu_torch yet.
"""
from .client import (LocalRemoteClient, RemoteEntry, RemoteStorageClient,
                     S3RemoteClient, make_client, parse_remote_spec,
                     register_remote)

__all__ = [
    "RemoteEntry", "RemoteStorageClient", "LocalRemoteClient",
    "S3RemoteClient", "make_client", "parse_remote_spec",
    "register_remote",
]
