"""Leveled logging with -v / -vmodule gating.

Equivalent of the reference's vendored glog fork (weed/glog/glog.go:
Info/Warning/Error/Fatal plus V-style verbosity, `-v` global level and
`-vmodule=file=level` per-file overrides). Same line format so log
tooling written for the reference parses these too:

    I0730 12:00:00.000000 12345 volume_server.py:123] message

Threads share one process-wide configuration. Copy of
seaweedfs_tpu/utils/glog.py; the port's tracing uses it for the
slow-request log.
"""
from __future__ import annotations

import inspect
import os
import sys
import threading
import time

_lock = threading.Lock()
_verbosity = 0
_vmodule: dict[str, int] = {}
_out = sys.stderr


def set_verbosity(level: int) -> None:
    global _verbosity
    _verbosity = int(level)


def set_vmodule(spec: str) -> None:
    """'store=2,volume_server=3' — per-module (file stem) levels."""
    _vmodule.clear()
    for part in spec.split(","):
        if not part.strip():
            continue
        mod, _, lvl = part.partition("=")
        _vmodule[mod.strip().removesuffix(".py")] = int(lvl or 0)


def set_output(stream) -> None:
    global _out
    _out = stream


def _caller(depth: int = 3) -> tuple[str, int]:
    frame = inspect.currentframe()
    for _ in range(depth):
        if frame is None or frame.f_back is None:
            break
        frame = frame.f_back
    if frame is None:
        return "?", 0
    return os.path.basename(frame.f_code.co_filename), frame.f_lineno


def V(level: int, depth: int = 2) -> bool:
    """True when messages at `level` should be emitted here (glog.V)."""
    if level <= _verbosity:
        return True
    if _vmodule:
        fname, _ = _caller(depth + 1)
        mod = fname.removesuffix(".py")
        if level <= _vmodule.get(mod, -1):
            return True
    return False


def _emit(sev: str, msg: str, depth: int = 3) -> None:
    fname, line = _caller(depth)
    now = time.time()
    stamp = time.strftime("%m%d %H:%M:%S", time.localtime(now))
    usec = int((now % 1) * 1e6)
    rec = (f"{sev}{stamp}.{usec:06d} {threading.get_native_id()} "
           f"{fname}:{line}] {msg}\n")
    with _lock:
        _out.write(rec)
        _out.flush()


def info(msg: str, *args) -> None:
    _emit("I", msg % args if args else msg)


def warning(msg: str, *args) -> None:
    _emit("W", msg % args if args else msg)


def error(msg: str, *args) -> None:
    _emit("E", msg % args if args else msg)


def fatal(msg: str, *args) -> None:
    _emit("F", msg % args if args else msg)
    sys.exit(1)


def v(level: int, msg: str, *args) -> None:
    """glog.V(level).Infof equivalent."""
    if V(level, depth=2):
        _emit("I", msg % args if args else msg)
