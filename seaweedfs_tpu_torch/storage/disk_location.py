"""DiskLocation: one data directory holding volume files and EC shards.

A copy of seaweedfs_tpu/storage/disk_location.py. Equivalent of
weed/storage/disk_location.go and disk_location_ec.go: scan a
directory, load `<collection_>?<vid>.dat/.idx` volumes and
`.ecXX`/`.ecx` shard sets, expose free-space checks.
"""
from __future__ import annotations

import os
import re
import shutil
from dataclasses import dataclass, field

from ..ec import geometry as geo
from .volume import Volume

_VOL_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.(?:dat|vif)$")
_EC_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.ec(?P<shard>\d{2})$")
# remote-shard manifest: shards of this EC volume whose bytes were
# offloaded to a cold remote tier (storage/store.py tier_offload_ec)
_RSM_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.rsm$")


def parse_volume_filename(name: str) -> tuple[str, int] | None:
    """Recognise a volume by its .dat — or by a .vif sidecar alone,
    which marks a tiered volume whose .dat lives on a backend storage
    (disk_location.go loadVolumeInfo)."""
    m = _VOL_RE.match(name)
    if not m:
        return None
    return (m.group("col") or "", int(m.group("vid")))


def parse_ec_filename(name: str) -> tuple[str, int, int] | None:
    m = _EC_RE.match(name)
    if not m:
        return None
    return (m.group("col") or "", int(m.group("vid")), int(m.group("shard")))


@dataclass
class EcShardSet:
    """Shards of one EC volume present at this location."""

    collection: str
    vid: int
    shard_ids: set[int] = field(default_factory=set)

    def base_name(self, dirname: str) -> str:
        name = f"{self.collection}_{self.vid}" if self.collection else \
            str(self.vid)
        return os.path.join(dirname, name)


class DiskLocation:
    def __init__(self, dirname: str, max_volumes: int = 8,
                 disk_type: str = "hdd",
                 needle_map_kind: str = "memory"):
        self.dir = dirname
        self.needle_map_kind = needle_map_kind
        self.max_volumes = max_volumes
        self.disk_type = disk_type
        self.volumes: dict[int, Volume] = {}
        self.ec_shards: dict[int, EcShardSet] = {}
        self.load_errors: list[tuple[int, str]] = []
        os.makedirs(dirname, exist_ok=True)

    def load_existing(self) -> None:
        """Scan the dir; one unloadable volume (e.g. a tiered .vif whose
        backend storage isn't configured on this process yet) must not
        abort the whole location — it is recorded in `load_errors` and
        skipped, like the reference logging and continuing per volume
        (disk_location.go concurrentLoadingVolumes)."""
        self.load_errors: list[tuple[int, str]] = []
        for name in sorted(os.listdir(self.dir)):
            v = parse_volume_filename(name)
            if v is not None:
                col, vid = v
                if vid not in self.volumes:
                    try:
                        self.volumes[vid] = Volume(
                            self.dir, col, vid,
                            needle_map_kind=self.needle_map_kind)
                    except Exception as e:
                        self.load_errors.append((vid, f"{type(e).__name__}: {e}"))
                continue
            e = parse_ec_filename(name)
            if e is not None:
                col, vid, shard = e
                entry = self.ec_shards.setdefault(vid, EcShardSet(col, vid))
                entry.shard_ids.add(shard)
                continue
            r = _RSM_RE.match(name)
            if r is not None:
                # offloaded shards: registered so the store re-mounts
                # them remote-backed after a restart (tier recall needs
                # the EC volume to stay served while its bytes are cold)
                col, vid = r.group("col") or "", int(r.group("vid"))
                entry = self.ec_shards.setdefault(vid, EcShardSet(col, vid))
                try:
                    import json as _json

                    with open(os.path.join(self.dir, name),
                              encoding="utf-8") as f:
                        man = _json.load(f)
                    entry.shard_ids.update(
                        int(s) for s in man.get("shards", {}))
                except Exception as ex:
                    self.load_errors.append(
                        (vid, f"rsm manifest: {type(ex).__name__}: {ex}"))

    def try_load_volume(self, vid: int) -> bool:
        """Load one volume's on-disk files if present (VolumeMount)."""
        if vid in self.volumes:
            return True
        for name in os.listdir(self.dir):
            v = parse_volume_filename(name)
            if v is not None and v[1] == vid:
                self.volumes[vid] = Volume(
                    self.dir, v[0], vid,
                    needle_map_kind=self.needle_map_kind)
                return True
        return False

    def new_volume(self, collection: str, vid: int, **kw) -> Volume:
        if vid in self.volumes:
            raise FileExistsError(f"volume {vid} already exists")
        kw.setdefault('needle_map_kind', self.needle_map_kind)
        v = Volume(self.dir, collection, vid, create=True, **kw)
        self.volumes[vid] = v
        return v

    def delete_volume(self, vid: int) -> None:
        v = self.volumes.pop(vid, None)
        if v is not None:
            v.destroy()

    def base_name(self, collection: str, vid: int) -> str:
        name = f"{collection}_{vid}" if collection else str(vid)
        return os.path.join(self.dir, name)

    def add_ec_shard(self, collection: str, vid: int, shard_id: int) -> None:
        entry = self.ec_shards.setdefault(vid, EcShardSet(collection, vid))
        entry.shard_ids.add(shard_id)

    def remove_ec_shards(self, vid: int,
                         shard_ids: set[int] | None = None) -> None:
        entry = self.ec_shards.get(vid)
        if entry is None:
            return
        ids = shard_ids if shard_ids is not None else set(entry.shard_ids)
        base = entry.base_name(self.dir)
        for sid in ids:
            entry.shard_ids.discard(sid)
            try:
                os.remove(base + geo.shard_ext(sid))
            except FileNotFoundError:
                pass
        if not entry.shard_ids:
            self.ec_shards.pop(vid, None)
            # drop the codec sidecar with the last shard — unless a
            # normal volume still owns the base (its tiering record
            # lives in the same .vif)
            if not os.path.exists(base + ".dat"):
                try:
                    os.remove(base + ".vif")
                except FileNotFoundError:
                    pass
            for ext in (".ecx", ".ecj", ".rsm"):
                try:
                    os.remove(base + ext)
                except FileNotFoundError:
                    pass

    def free_space_bytes(self) -> int:
        return shutil.disk_usage(self.dir).free

    @property
    def volume_count(self) -> int:
        return len(self.volumes)

    def close(self) -> None:
        for v in self.volumes.values():
            v.close()
        self.volumes.clear()
