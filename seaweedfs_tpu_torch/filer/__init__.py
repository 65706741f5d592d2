"""Filer: directory namespace + chunked files over volume storage; the
counterpart of seaweedfs_tpu/filer/.

entry.py (Entry/FileChunk), filechunks.py (visible-interval algebra),
filerstore.py (the memory, sqlite and leveldb stores), weedkv.py (the
leveldb engine), sharded_store.py and store_cache.py (the sharding and
caching wrappers), the network engines with their wire clients
(abstract_sql.py over mysql_lite.py / pg_lite.py, redis_store.py,
redis_cluster_store.py, etcd_store.py, mongodb_store.py over
bson_lite.py, cassandra_store.py over cql_lite.py, elastic_store.py,
arangodb_store.py, hbase_store.py over thrift_lite.py, tikv_store.py
and ydb_store.py over utils/grpc_lite.py) and rocksdb_store.py,
event_log.py (metadata event log), filer_conf.py (per-path storage
rules), filer.py (the Filer), stream.py (chunked reads over the volume
servers).
"""
from .entry import DIR_MODE_FLAG, Entry, FileChunk, total_size
from .event_log import MetaEventLog, event_kind
from .filechunks import (ChunkView, VisibleInterval, compact_file_chunks,
                         etag_chunks, maybe_manifestize,
                         non_overlapping_visible_intervals,
                         resolve_chunk_manifest, view_from_chunks)
from .filer import Filer, norm_path
from . import abstract_sql as _abstract_sql  # registers mysql/postgres
from . import arangodb_store as _arangodb_store  # registers arangodb
from . import cassandra_store as _cassandra_store  # registers cassandra
from . import elastic_store as _elastic_store  # registers elastic (REST)
from . import etcd_store as _etcd_store      # registers etcd (v3 http)
from . import hbase_store as _hbase_store    # registers hbase (thrift)
from . import tikv_store as _tikv_store      # registers tikv (grpc)
from . import ydb_store as _ydb_store        # registers ydb (grpc+yql)
from . import rocksdb_store as _rocksdb_store  # registers rocksdb (C API)
from . import mongodb_store as _mongodb_store  # registers mongodb (OP_MSG)
from . import redis_store as _redis_store    # registers redis
from . import redis_cluster_store as _redis_cluster  # registers redis_cluster
from . import sharded_store as _sharded_store  # registers "sharded"
from .filerstore import (STORES, FilerStore, MemoryStore, SqliteStore,
                         make_store, register_store)
from .sharded_store import ShardedStore
from .store_cache import CachingStore
from .stream import (ChunkStreamReader, iter_content, read_fid,
                     stream_content)

__all__ = [
    "DIR_MODE_FLAG", "Entry", "FileChunk", "total_size",
    "MetaEventLog", "event_kind",
    "ChunkView", "VisibleInterval", "compact_file_chunks", "etag_chunks",
    "maybe_manifestize", "non_overlapping_visible_intervals",
    "resolve_chunk_manifest", "view_from_chunks",
    "Filer", "norm_path",
    "STORES", "FilerStore", "MemoryStore", "SqliteStore", "make_store",
    "register_store", "ShardedStore", "CachingStore",
    "ChunkStreamReader", "iter_content", "read_fid", "stream_content",
]
