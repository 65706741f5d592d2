"""Filer: directory namespace + chunked files over volume storage; the
counterpart of seaweedfs_tpu/filer/.

entry.py (Entry/FileChunk), filechunks.py (visible-interval algebra),
filerstore.py (the memory and sqlite metadata stores), event_log.py
(metadata event log), filer_conf.py (per-path storage rules), filer.py
(the Filer), stream.py (chunked reads over the volume servers).
Not here: the other store engines (weedkv, sharded, the caching
wrapper, the network engines) and the native front.
"""
from .entry import DIR_MODE_FLAG, Entry, FileChunk, total_size
from .event_log import MetaEventLog, event_kind
from .filechunks import (ChunkView, VisibleInterval, compact_file_chunks,
                         etag_chunks, maybe_manifestize,
                         non_overlapping_visible_intervals,
                         resolve_chunk_manifest, view_from_chunks)
from .filer import Filer, norm_path
from .filerstore import (STORES, FilerStore, MemoryStore, SqliteStore,
                         make_store, register_store)
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
    "register_store",
    "ChunkStreamReader", "iter_content", "read_fid", "stream_content",
]
