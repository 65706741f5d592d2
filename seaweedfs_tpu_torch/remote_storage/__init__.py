"""Remote-storage tiering: map filer directories onto cloud buckets;
the counterpart of seaweedfs_tpu/remote_storage/.

Equivalent of SeaweedFS weed/remote_storage/ (the RemoteStorageClient
interface, remote_storage.go:71-87, and its s3 / gcs / azure / local
implementations) plus the mount bookkeeping the shell remote.* commands
and the `filer.remote.sync` / `filer.remote.gateway` workers use
(weed/shell/command_remote_*.go, weed/command/filer_remote_sync*.go,
filer_remote_gateway*.go).
"""
from .client import (LocalRemoteClient, RemoteEntry, RemoteStorageClient,
                     S3RemoteClient, make_client, parse_remote_spec,
                     register_remote)
from . import azure_client as _azure_client  # registers "azure" (REST)
from . import gcs_client as _gcs_client      # registers "gcs" (JSON API)
from .azure_client import AzureRemoteClient
from .gcs_client import GcsRemoteClient
from .mount import (RemoteConf, RemoteMount, find_mount, load_conf,
                    remote_key_for, save_conf)

__all__ = [
    "RemoteEntry", "RemoteStorageClient", "LocalRemoteClient",
    "S3RemoteClient", "GcsRemoteClient", "AzureRemoteClient",
    "make_client", "parse_remote_spec", "register_remote",
    "RemoteConf", "RemoteMount", "load_conf", "save_conf",
    "find_mount", "remote_key_for",
]
