"""Self-contained ctypes binding to libfuse.so.2 (FUSE 2, API v26); the
counterpart of seaweedfs_tpu/mount/fuse_ctypes.py.

Equivalent of the go-fuse kernel binding used by the reference mount
(SeaweedFS weed/mount/weedfs.go:11 hanwen/go-fuse): this module
is only transport glue between the kernel's FUSE protocol and the
WeedFS core in weedfs.py — no filesystem logic lives here. It exists
so `seaweedfs_tpu_torch mount` produces a real kernel mount without any
third-party Python FUSE package: struct layouts below mirror the C
headers (<fuse/fuse.h> 2.9, <sys/stat.h>, <sys/statvfs.h>) for
x86-64 Linux, and fuse_main_real() drives the session.

All callbacks run on libfuse's own pthreads; ctypes acquires the GIL
per call, and the WeedFS core is already internally locked.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import errno
import os
import stat as statmod

from .weedfs import FuseError, WeedFS

c_char_p = ctypes.c_char_p
c_int = ctypes.c_int
c_uint = ctypes.c_uint
c_long = ctypes.c_long
c_ulong = ctypes.c_ulong
c_size_t = ctypes.c_size_t
c_uint64 = ctypes.c_uint64
c_void_p = ctypes.c_void_p

# glibc x86-64 ABI scalar typedefs
mode_t = c_uint
dev_t = c_ulong
uid_t = c_uint
gid_t = c_uint
off_t = c_long

# <bits/stat.h> special tv_nsec values accepted by utimensat(2)
UTIME_NOW = (1 << 30) - 1
UTIME_OMIT = (1 << 30) - 2


class Timespec(ctypes.Structure):
    _fields_ = [("tv_sec", c_long), ("tv_nsec", c_long)]


class Stat(ctypes.Structure):
    # struct stat, x86-64 glibc layout
    _fields_ = [
        ("st_dev", dev_t),
        ("st_ino", c_ulong),
        ("st_nlink", c_ulong),
        ("st_mode", mode_t),
        ("st_uid", uid_t),
        ("st_gid", gid_t),
        ("_pad0", c_int),
        ("st_rdev", dev_t),
        ("st_size", off_t),
        ("st_blksize", c_long),
        ("st_blocks", c_long),
        ("st_atim", Timespec),
        ("st_mtim", Timespec),
        ("st_ctim", Timespec),
        ("_reserved", c_long * 3),
    ]


class StatVFS(ctypes.Structure):
    # struct statvfs, x86-64 glibc layout
    _fields_ = [
        ("f_bsize", c_ulong),
        ("f_frsize", c_ulong),
        ("f_blocks", c_ulong),
        ("f_bfree", c_ulong),
        ("f_bavail", c_ulong),
        ("f_files", c_ulong),
        ("f_ffree", c_ulong),
        ("f_favail", c_ulong),
        ("f_fsid", c_ulong),
        ("f_flag", c_ulong),
        ("f_namemax", c_ulong),
        ("_spare", c_int * 6),
    ]


class FuseFileInfo(ctypes.Structure):
    # struct fuse_file_info, fuse 2.9
    _fields_ = [
        ("flags", c_int),
        ("fh_old", c_ulong),
        ("writepage", c_int),
        ("direct_io", c_uint, 1),
        ("keep_cache", c_uint, 1),
        ("flush", c_uint, 1),
        ("nonseekable", c_uint, 1),
        ("flock_release", c_uint, 1),
        ("_padding", c_uint, 27),
        ("fh", c_uint64),
        ("lock_owner", c_uint64),
    ]


CB = ctypes.CFUNCTYPE
StatP = ctypes.POINTER(Stat)
StatVFSP = ctypes.POINTER(StatVFS)
FFIP = ctypes.POINTER(FuseFileInfo)
TimespecP = ctypes.POINTER(Timespec)

# int (*fuse_fill_dir_t)(void *buf, const char *name,
#                        const struct stat *stbuf, off_t off)
fill_dir_t = CB(c_int, c_void_p, c_char_p, StatP, off_t)

# NB: buffer parameters are c_void_p, not c_char_p — ctypes converts
# c_char_p callback args to immutable NUL-truncated Python bytes, which
# both corrupts binary payloads and makes memmove write into a copy.
GETATTR_T = CB(c_int, c_char_p, StatP)
READLINK_T = CB(c_int, c_char_p, c_void_p, c_size_t)
MKNOD_T = CB(c_int, c_char_p, mode_t, dev_t)
MKDIR_T = CB(c_int, c_char_p, mode_t)
PATH_T = CB(c_int, c_char_p)
PATH2_T = CB(c_int, c_char_p, c_char_p)
CHMOD_T = CB(c_int, c_char_p, mode_t)
CHOWN_T = CB(c_int, c_char_p, uid_t, gid_t)
TRUNCATE_T = CB(c_int, c_char_p, off_t)
OPEN_T = CB(c_int, c_char_p, FFIP)
READ_T = CB(c_int, c_char_p, c_void_p, c_size_t, off_t, FFIP)
WRITE_T = CB(c_int, c_char_p, c_void_p, c_size_t, off_t, FFIP)
STATFS_T = CB(c_int, c_char_p, StatVFSP)
FSYNC_T = CB(c_int, c_char_p, c_int, FFIP)
READDIR_T = CB(c_int, c_char_p, c_void_p, fill_dir_t, off_t, FFIP)
INIT_T = CB(c_void_p, c_void_p)
DESTROY_T = CB(None, c_void_p)
ACCESS_T = CB(c_int, c_char_p, c_int)
CREATE_T = CB(c_int, c_char_p, mode_t, FFIP)
FTRUNCATE_T = CB(c_int, c_char_p, off_t, FFIP)
FGETATTR_T = CB(c_int, c_char_p, StatP, FFIP)
UTIMENS_T = CB(c_int, c_char_p, TimespecP)
SETXATTR_T = CB(c_int, c_char_p, c_char_p, c_void_p, c_size_t, c_int)
GETXATTR_T = CB(c_int, c_char_p, c_char_p, c_void_p, c_size_t)
LISTXATTR_T = CB(c_int, c_char_p, c_void_p, c_size_t)
REMOVEXATTR_T = CB(c_int, c_char_p, c_char_p)


class FuseOperations(ctypes.Structure):
    # struct fuse_operations for FUSE_USE_VERSION 26 (fuse 2.9); the
    # trailing members past utimens are declared as bare pointers —
    # they stay NULL but must occupy their slots so op_size matches.
    _fields_ = [
        ("getattr", GETATTR_T),
        ("readlink", READLINK_T),
        ("getdir", c_void_p),          # deprecated
        ("mknod", MKNOD_T),
        ("mkdir", MKDIR_T),
        ("unlink", PATH_T),
        ("rmdir", PATH_T),
        ("symlink", PATH2_T),
        ("rename", PATH2_T),
        ("link", PATH2_T),
        ("chmod", CHMOD_T),
        ("chown", CHOWN_T),
        ("truncate", TRUNCATE_T),
        ("utime", c_void_p),           # superseded by utimens
        ("open", OPEN_T),
        ("read", READ_T),
        ("write", WRITE_T),
        ("statfs", STATFS_T),
        ("flush", OPEN_T),
        ("release", OPEN_T),
        ("fsync", FSYNC_T),
        ("setxattr", SETXATTR_T),
        ("getxattr", GETXATTR_T),
        ("listxattr", LISTXATTR_T),
        ("removexattr", REMOVEXATTR_T),
        ("opendir", c_void_p),
        ("readdir", READDIR_T),
        ("releasedir", c_void_p),
        ("fsyncdir", c_void_p),
        ("init", INIT_T),
        ("destroy", DESTROY_T),
        ("access", ACCESS_T),
        ("create", CREATE_T),
        ("ftruncate", FTRUNCATE_T),
        ("fgetattr", FGETATTR_T),
        ("lock", c_void_p),
        ("utimens", UTIMENS_T),
        ("bmap", c_void_p),
        ("flags", c_uint),             # flag_nullpath_ok etc. bitfield
        ("ioctl", c_void_p),
        ("poll", c_void_p),
        ("write_buf", c_void_p),
        ("read_buf", c_void_p),
        ("flock", c_void_p),
        ("fallocate", c_void_p),
    ]


def _load_libfuse():
    name = ctypes.util.find_library("fuse") or "libfuse.so.2"
    lib = ctypes.CDLL(name, use_errno=True)
    lib.fuse_main_real.argtypes = [
        c_int, ctypes.POINTER(c_char_p),
        ctypes.POINTER(FuseOperations), c_size_t, c_void_p]
    lib.fuse_main_real.restype = c_int
    return lib


def libfuse_available() -> bool:
    import platform

    # the struct layouts below are the x86-64 glibc ABI; on another
    # arch this binding would write stat fields at wrong offsets and
    # serve garbage — fail over to the clear "not available" error
    if platform.machine() != "x86_64":
        return False
    try:
        _load_libfuse()
        return True
    except OSError:
        return False


def _fill_stat(st: Stat, attr: dict) -> None:
    ctypes.memset(ctypes.addressof(st), 0, ctypes.sizeof(st))
    st.st_mode = attr.get("st_mode", 0)
    st.st_ino = attr.get("st_ino", 0)
    st.st_nlink = attr.get("st_nlink", 1)
    st.st_uid = attr.get("st_uid", 0)
    st.st_gid = attr.get("st_gid", 0)
    size = int(attr.get("st_size", 0))
    st.st_size = size
    st.st_blksize = 4096
    st.st_blocks = (size + 511) // 512
    for cf, key in (("st_atim", "st_mtime"), ("st_mtim", "st_mtime"),
                    ("st_ctim", "st_ctime")):
        t = float(attr.get(key, 0) or 0)
        ts = getattr(st, cf)
        ts.tv_sec = int(t)
        ts.tv_nsec = int((t - int(t)) * 1e9)


class FuseSession:
    """Binds one WeedFS instance to fuse_main_real.

    Keeps every CFUNCTYPE thunk referenced on self for the lifetime of
    the mount (libfuse holds raw pointers into them).
    """

    def __init__(self, fs: WeedFS):
        self.fs = fs
        ops = FuseOperations()
        ops.getattr = GETATTR_T(self._getattr)
        ops.fgetattr = FGETATTR_T(self._fgetattr)
        ops.readlink = READLINK_T(self._readlink)
        ops.mknod = MKNOD_T(self._mknod)
        ops.mkdir = MKDIR_T(self._mkdir)
        ops.unlink = PATH_T(self._unlink)
        ops.rmdir = PATH_T(self._rmdir)
        ops.symlink = PATH2_T(self._symlink)
        ops.rename = PATH2_T(self._rename)
        ops.link = PATH2_T(self._link)
        ops.chmod = CHMOD_T(self._chmod)
        ops.chown = CHOWN_T(self._chown)
        ops.truncate = TRUNCATE_T(self._truncate)
        ops.ftruncate = FTRUNCATE_T(self._ftruncate)
        ops.open = OPEN_T(self._open)
        ops.create = CREATE_T(self._create)
        ops.read = READ_T(self._read)
        ops.write = WRITE_T(self._write)
        ops.statfs = STATFS_T(self._statfs)
        ops.flush = OPEN_T(self._flush)
        ops.release = OPEN_T(self._release)
        ops.fsync = FSYNC_T(self._fsync)
        ops.readdir = READDIR_T(self._readdir)
        ops.destroy = DESTROY_T(self._destroy)
        ops.utimens = UTIMENS_T(self._utimens)
        ops.setxattr = SETXATTR_T(self._setxattr)
        ops.getxattr = GETXATTR_T(self._getxattr)
        ops.listxattr = LISTXATTR_T(self._listxattr)
        ops.removexattr = REMOVEXATTR_T(self._removexattr)
        self.ops = ops

    # every handler: exceptions become -errno, success >= 0
    def _guard(self, fn, *args) -> int:
        try:
            r = fn(*args)
            return r if isinstance(r, int) else 0
        except FuseError as e:
            return -(e.errno or errno.EIO)
        except OSError as e:
            return -(e.errno or errno.EIO)
        except Exception:
            return -errno.EIO

    @staticmethod
    def _path(p: bytes) -> str:
        return p.decode("utf-8", "surrogateescape")

    def _getattr(self, path, stp):
        def go():
            _fill_stat(stp.contents, self.fs.getattr(self._path(path)))
        return self._guard(go)

    def _fgetattr(self, path, stp, fi):
        return self._getattr(path, stp)

    def _readlink(self, path, buf, bufsize):
        def go():
            target = self.fs.readlink(self._path(path)).encode()[:bufsize - 1]
            ctypes.memmove(buf, target + b"\0", len(target) + 1)
        return self._guard(go)

    def _mknod(self, path, mode, rdev):
        def go():
            if not statmod.S_ISREG(mode):
                raise FuseError(errno.EPERM)
            fh = self.fs.create(self._path(path), mode & 0o7777)
            self.fs.release(fh)
        return self._guard(go)

    def _mkdir(self, path, mode):
        return self._guard(self.fs.mkdir, self._path(path), mode)

    def _unlink(self, path):
        return self._guard(self.fs.unlink, self._path(path))

    def _rmdir(self, path):
        return self._guard(self.fs.rmdir, self._path(path))

    def _symlink(self, target, linkpath):
        return self._guard(self.fs.symlink, self._path(target),
                           self._path(linkpath))

    def _rename(self, old, new):
        return self._guard(self.fs.rename, self._path(old), self._path(new))

    def _link(self, src, dst):
        return self._guard(self.fs.link, self._path(src), self._path(dst))

    def _chmod(self, path, mode):
        return self._guard(self.fs.chmod, self._path(path), mode)

    def _chown(self, path, uid, gid):
        return self._guard(self.fs.chown, self._path(path), uid, gid)

    def _truncate(self, path, length):
        return self._guard(self.fs.truncate, self._path(path), length)

    def _ftruncate(self, path, length, fi):
        return self._guard(self.fs.truncate, self._path(path), length,
                           fi.contents.fh)

    def _open(self, path, fi):
        def go():
            truncate = bool(fi.contents.flags & os.O_TRUNC)
            fi.contents.fh = self.fs.open(self._path(path), truncate)
        return self._guard(go)

    def _create(self, path, mode, fi):
        def go():
            fi.contents.fh = self.fs.create(self._path(path), mode & 0o7777)
        return self._guard(go)

    def _read(self, path, buf, size, offset, fi):
        def go():
            data = self.fs.read(fi.contents.fh, offset, size)
            n = min(len(data), size)
            ctypes.memmove(buf, data, n)
            return n
        return self._guard(go)

    def _write(self, path, buf, size, offset, fi):
        def go():
            data = ctypes.string_at(buf, size)
            return self.fs.write(fi.contents.fh, offset, data)
        return self._guard(go)

    def _statfs(self, path, svp):
        def go():
            sv = svp.contents
            ctypes.memset(ctypes.addressof(sv), 0, ctypes.sizeof(sv))
            d = self.fs.statfs()
            sv.f_bsize = sv.f_frsize = d.get("f_bsize", 4096)
            sv.f_blocks = d.get("f_blocks", 0)
            sv.f_bfree = d.get("f_bfree", 0)
            sv.f_bavail = d.get("f_bavail", 0)
            sv.f_files = d.get("f_files", 1 << 20)
            sv.f_ffree = sv.f_favail = d.get("f_ffree", 1 << 20)
            sv.f_namemax = 255
        return self._guard(go)

    def _flush(self, path, fi):
        return self._guard(self.fs.flush, fi.contents.fh)

    def _release(self, path, fi):
        return self._guard(self.fs.release, fi.contents.fh)

    def _fsync(self, path, datasync, fi):
        return self._guard(self.fs.flush, fi.contents.fh)

    def _readdir(self, path, buf, filler, offset, fi):
        def go():
            names = list(self.fs.readdir(self._path(path)))
            for dot in ("..", "."):
                if dot not in names:
                    names.insert(0, dot)
            for name in names:
                if filler(buf, name.encode("utf-8", "surrogateescape"),
                          None, 0):
                    break
        return self._guard(go)

    def _destroy(self, _private):
        try:
            self.fs.destroy()
        except Exception:
            pass

    # xattr protocol (xattr(7)): a zero-size probe returns the needed
    # byte count; a too-small buffer is -ERANGE with nothing written
    def _setxattr(self, path, name, value, size, flags):
        def go():
            data = ctypes.string_at(value, size) if size else b""
            self.fs.setxattr(self._path(path), self._path(name),
                             data, flags)
        return self._guard(go)

    def _getxattr(self, path, name, buf, size):
        def go():
            data = self.fs.getxattr(self._path(path), self._path(name))
            if size == 0:
                return len(data)
            if size < len(data):
                raise FuseError(errno.ERANGE)
            ctypes.memmove(buf, data, len(data))
            return len(data)
        return self._guard(go)

    def _listxattr(self, path, buf, size):
        def go():
            names = self.fs.listxattr(self._path(path))
            blob = b"".join(
                n.encode("utf-8", "surrogateescape") + b"\0"
                for n in names)
            if size == 0:
                return len(blob)
            if size < len(blob):
                raise FuseError(errno.ERANGE)
            if blob:
                ctypes.memmove(buf, blob, len(blob))
            return len(blob)
        return self._guard(go)

    def _removexattr(self, path, name):
        return self._guard(self.fs.removexattr, self._path(path),
                           self._path(name))

    def _utimens(self, path, tvp):
        def go():
            import time as _t
            if not tvp:
                mtime = _t.time()
            else:
                mt = tvp[1]
                if mt.tv_nsec == UTIME_NOW:
                    mtime = _t.time()
                elif mt.tv_nsec == UTIME_OMIT:
                    return
                else:
                    mtime = mt.tv_sec + mt.tv_nsec / 1e9
            self.fs.utimens(self._path(path), mtime)
        return self._guard(go)

    def main(self, mountpoint: str, foreground: bool = True,
             options: str | None = None, single_threaded: bool = False,
             debug: bool = False) -> int:
        lib = _load_libfuse()
        opts = "fsname=seaweedfs,subtype=seaweedfs,big_writes"
        if options:
            opts += "," + options
        argv = [b"seaweedfs-mount", os.fsencode(mountpoint),
                b"-o", opts.encode()]
        if foreground:
            argv.append(b"-f")
        if single_threaded:
            argv.append(b"-s")
        if debug:
            argv.append(b"-d")
        c_argv = (c_char_p * len(argv))(*argv)
        return lib.fuse_main_real(
            len(argv), c_argv, ctypes.byref(self.ops),
            ctypes.sizeof(self.ops), None)


def mount(filer_url: str, mountpoint: str, root: str = "/",
          options: str | None = None, **weedfs_kwargs) -> int:
    """Block serving `filer_url`'s `root` at `mountpoint` via the kernel."""
    fs = WeedFS(filer_url, root=root, **weedfs_kwargs)
    return FuseSession(fs).main(mountpoint, options=options)
