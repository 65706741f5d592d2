"""FUSE kernel binding for WeedFS; the counterpart of
seaweedfs_tpu/mount/fuse_adapter.py.

Equivalent of the go-fuse binding in SeaweedFS weed/mount/weedfs.go —
host-side glue only: all filesystem logic lives in weedfs.py. The
reference prefers the `fusepy` package when it is importable
(`WeedFuseOps`) and falls back to its own ctypes binding to
libfuse.so.2; the port imports no third-party FUSE package, so it
always takes the ctypes route (fuse_ctypes.py), the one the reference
takes where fusepy is missing, as it is on every machine this runs on.
"""
from __future__ import annotations


def mount(filer_url: str, mountpoint: str, root: str = "/",
          options: str | None = None, **weedfs_kwargs) -> None:
    """Block serving `filer_url`'s `root` directory at `mountpoint`
    through the kernel, via libfuse.so.2."""
    from . import fuse_ctypes

    if not fuse_ctypes.libfuse_available():
        raise RuntimeError(
            "neither fusepy nor libfuse.so.2 is available; the mount "
            "core is still usable as a library via mount.WeedFS")
    fuse_ctypes.mount(filer_url, mountpoint, root=root, options=options,
                      **weedfs_kwargs)
