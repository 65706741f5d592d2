"""`backup` tool: keep a local replica of a volume up to date; the
counterpart of seaweedfs_tpu/operation/backup.py, over
rpc/httpclient.py.

Equivalent of SeaweedFS weed/command/backup.go +
weed/storage/volume_backup.go: locate the volume via the master, compare
sync status with the local copy, then either full-copy (.dat/.idx) or
incrementally append only the records written since the last run
(streamed from the source's append_at_ns watermark). Repeated runs are
cheap — the normal mode is a cron job pulling deltas.
"""
from __future__ import annotations

import os

from ..storage.volume import Volume
from ..rpc.httpclient import session


class BackupError(Exception):
    pass


def _locate(master_url: str, vid: int) -> str:
    r = session().get(f"{master_url}/dir/lookup",
                     params={"volumeId": vid}, timeout=30)
    try:
        body = r.json()
    except ValueError:  # proxy/html error bodies
        raise BackupError(
            f"volume {vid}: lookup returned {r.status_code}: "
            f"{r.text[:200]}")
    locs = body.get("locations", [])
    if r.status_code >= 300 or not locs:
        raise BackupError(
            f"volume {vid}: {body.get('error', 'no locations')}")
    return locs[0]["url"]


def backup_volume(master_url: str, vid: int, dest_dir: str,
                  collection: str = "") -> dict:
    """Pull volume `vid` into dest_dir; returns a summary dict."""
    master_url = master_url.rstrip("/")
    if not master_url.startswith("http"):
        master_url = f"http://{master_url}"
    source = _locate(master_url, vid)
    st = session().get(f"http://{source}/admin/volume_sync_status",
                      params={"volume": vid}, timeout=60)
    if st.status_code >= 300:
        raise BackupError(f"sync status from {source}: {st.text}")
    status = st.json()
    os.makedirs(dest_dir, exist_ok=True)

    name = f"{collection}_{vid}" if collection else str(vid)
    dat_path = os.path.join(dest_dir, name + ".dat")
    have_local = os.path.exists(dat_path)
    mode = "incremental"
    if have_local:
        local = Volume(dest_dir, collection, vid)
        # a vacuum on the source rewrote history; or the local copy is
        # somehow ahead (e.g. it was a live replica once) — start over
        if (local.super_block.compaction_revision
                != status["compact_revision"]
                or local.dat.size() > status["tail_offset"]):
            local.close()
            have_local = False
            mode = "full (revision/tail mismatch)"
        elif local.last_append_at_ns == 0 and len(local.nm) > 0:
            # a replica without stamps (v2 records) can't say where it
            # stopped — an "incremental" pull from 0 would re-append
            # the whole source on every run
            local.close()
            have_local = False
            mode = "full (no append stamps)"
    if not have_local:
        if os.path.exists(dat_path):
            os.remove(dat_path)
            idx = os.path.join(dest_dir, name + ".idx")
            if os.path.exists(idx):
                os.remove(idx)
        _full_copy(source, vid, collection, dest_dir, name)
        local = Volume(dest_dir, collection, vid)
        mode = mode if mode.startswith("full") else "full (new)"
        applied = local.nm.file_count
    else:
        applied = _incremental_copy(source, vid, local)
    out = {"volume": vid, "mode": mode, "records_applied": applied,
           "tail_offset": local.dat.size(),
           "last_append_at_ns": local.last_append_at_ns}
    local.close()
    return out


def _full_copy(source: str, vid: int, collection: str, dest_dir: str,
               name: str) -> None:
    for ext in (".dat", ".idx"):
        with session().get(f"http://{source}/admin/copy_file",
                          params={"volume": vid, "collection": collection,
                                  "ext": ext},
                          stream=True, timeout=600) as r:
            if r.status_code >= 300:
                raise BackupError(f"copy {ext} from {source}: "
                                  f"{r.status_code}")
            with open(os.path.join(dest_dir, name + ext), "wb") as f:
                for chunk in r.iter_content(1 << 20):
                    f.write(chunk)


def _incremental_copy(source: str, vid: int, local: Volume) -> int:
    """Stream the delta and append whole-record prefixes as they
    arrive — the delta after a long gap can be many GB and must not be
    buffered wholesale."""
    from ..storage import needle as ndl

    applied = 0
    buf = bytearray()
    with session().get(f"http://{source}/admin/volume_incremental_copy",
                      params={"volume": vid,
                              "since_ns": local.last_append_at_ns},
                      stream=True, timeout=600) as r:
        if r.status_code >= 300:
            raise BackupError(f"incremental copy from {source}: "
                              f"{r.status_code}")
        for chunk in r.iter_content(1 << 20):
            buf.extend(chunk)
            whole = ndl.whole_records_prefix(buf, local.version)
            if whole:
                applied += local.append_raw_segment(
                    bytes(memoryview(buf)[:whole]))
                del buf[:whole]
    if buf:
        raise BackupError(
            f"incremental stream from {source} ended mid-record "
            f"({len(buf)} trailing bytes); re-run to retry")
    return applied
