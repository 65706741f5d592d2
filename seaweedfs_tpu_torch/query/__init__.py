"""Server-side structured queries over stored objects; the counterpart
of seaweedfs_tpu/query/.

Equivalent of SeaweedFS weed/query/ (query_json.go) and the
VolumeServer.Query streaming rpc (volume_server.proto:107,
volume_grpc_query.go): push a projection + filter down to where the
bytes live instead of hauling whole objects to the client.
"""
from .json_query import Filter, query_json_bytes, query_json_doc
from .sql import parse_select

__all__ = ["Filter", "query_json_bytes", "query_json_doc",
           "parse_select"]
