"""FTP gateway over the filer; the counterpart of seaweedfs_tpu/ftpd.

SeaweedFS ships only an experimental 81-line skeleton
(weed/ftpd/ftp_server.go wires ftpserverlib but is not
production-ready); this is a working stdlib implementation of the same
slot: a threaded RFC 959 server speaking passive-mode FTP, with every
file operation carried by the filer HTTP API (list/GET/POST/DELETE /
mkdir / mv.from — the same surface the WebDAV gateway rides).

Supported verbs: USER/PASS, SYST, FEAT, TYPE, PWD/CWD/CDUP, PASV/EPSV,
LIST/NLST, RETR, STOR, APPE, DELE, MKD, RMD, RNFR/RNTO, SIZE, MDTM,
REST (stream resume for RETR), NOOP, QUIT.

The port keeps the sessions, replies and listings of the JAX package
byte for byte. Its filer hops go through `rpc/httpclient.session()`
(one pool per session thread) in place of `requests`: a failed hop is
that module's `RequestException` (451), a RETR streams the filer's
body through `Response.iter_content`, and an APPE copies the old
content into the spool the same way. A STOR's spool goes to the filer
with its Content-Length, as `requests` measures a file body.
"""
from __future__ import annotations

import posixpath
import socket
import threading
import time
from urllib.parse import quote

from ..filer.entry import entry_size as _entry_size
from ..rpc.httpclient import RequestException, Response, session


class FtpSession(threading.Thread):
    def __init__(self, server: "FtpServer", conn: socket.socket):
        super().__init__(daemon=True)
        self.srv = server
        self.conn = conn
        self.cwd = "/"
        self.user = ""
        self.authed = False
        self.binary = True
        self.rename_from = ""
        self.rest_offset = 0
        self._pasv: socket.socket | None = None

    # -- plumbing -------------------------------------------------------
    def reply(self, code: int, text: str) -> None:
        self.conn.sendall(f"{code} {text}\r\n".encode())

    def _abs(self, arg: str) -> str:
        path = arg if arg.startswith("/") else \
            posixpath.join(self.cwd, arg)
        norm = posixpath.normpath(path)
        root = self.srv.root.rstrip("/")
        return (root + norm) if norm != "/" else (root or "/")

    def _filer(self, method: str, path: str, **kw) -> Response:
        return session().request(method,
                                 f"{self.srv.filer_url}{quote(path)}",
                                 timeout=600, **kw)

    def _open_data(self) -> socket.socket:
        if self._pasv is None:
            raise ConnectionError("no PASV listener")
        self._pasv.settimeout(30)
        data, _ = self._pasv.accept()
        self._pasv.close()
        self._pasv = None
        return data

    # -- main loop ------------------------------------------------------
    def run(self) -> None:
        try:
            self.reply(220, "seaweedfs-tpu FTP gateway ready")
            buf = b""
            while True:
                while b"\r\n" not in buf:
                    chunk = self.conn.recv(4096)
                    if not chunk:
                        return
                    buf += chunk
                line, buf = buf.split(b"\r\n", 1)
                cmd, _, arg = line.decode("utf-8",
                                          "surrogateescape").partition(" ")
                cmd = cmd.upper()
                try:
                    if not self._dispatch(cmd, arg):
                        return
                except RequestException:
                    self.reply(451, "filer request failed")
                except (ConnectionError, socket.timeout):
                    self.reply(425, "cannot open data connection")
        except OSError:
            pass
        finally:
            if self._pasv is not None:
                self._pasv.close()
            self.conn.close()

    # -- commands -------------------------------------------------------
    def _dispatch(self, cmd: str, arg: str) -> bool:
        if cmd == "QUIT":
            self.reply(221, "bye")
            return False
        if cmd == "USER":
            self.user = arg
            if self.srv.anonymous and arg in ("anonymous", "ftp"):
                self.authed = True
                self.reply(230, "anonymous login ok")
            else:
                self.reply(331, "password required")
            return True
        if cmd == "PASS":
            if self.srv.anonymous and self.user in ("anonymous", "ftp"):
                self.authed = True
                self.reply(230, "logged in")
            elif self.srv.users.get(self.user) == arg:
                self.authed = True
                self.reply(230, "logged in")
            else:
                self.reply(530, "login incorrect")
            return True
        if cmd in ("SYST",):
            self.reply(215, "UNIX Type: L8")
            return True
        if cmd == "FEAT":
            self.conn.sendall(
                b"211-Features:\r\n SIZE\r\n MDTM\r\n REST STREAM\r\n"
                b" EPSV\r\n UTF8\r\n211 End\r\n")
            return True
        if cmd == "NOOP":
            self.reply(200, "ok")
            return True
        if cmd == "TYPE":
            self.binary = arg.upper().startswith("I")
            self.reply(200, f"type set to {'I' if self.binary else 'A'}")
            return True
        if not self.authed:
            self.reply(530, "please login")
            return True
        handler = getattr(self, f"_cmd_{cmd.lower()}", None)
        if handler is None:
            self.reply(502, f"{cmd} not implemented")
            return True
        handler(arg)
        return True

    def _cmd_pwd(self, arg: str) -> None:
        self.reply(257, f'"{self.cwd}" is the current directory')

    def _cmd_cwd(self, arg: str) -> None:
        path = self._abs(arg or "/")
        if arg in ("/", "") or self._stat_dir(path):
            self.cwd = posixpath.normpath(
                arg if arg.startswith("/")
                else posixpath.join(self.cwd, arg))
            self.reply(250, "directory changed")
        else:
            self.reply(550, "no such directory")

    def _cmd_cdup(self, arg: str) -> None:
        self.cwd = posixpath.dirname(self.cwd.rstrip("/")) or "/"
        self.reply(250, "directory changed")

    def _stat_dir(self, path: str) -> bool:
        r = self._filer("GET", path, params={"meta": "1"})
        return r.status_code == 200 and \
            bool(r.json().get("mode", 0) & 0o40000)

    def _entry(self, path: str) -> dict | None:
        r = self._filer("GET", path, params={"meta": "1"})
        return r.json() if r.status_code == 200 else None

    def _cmd_pasv(self, arg: str) -> None:
        self._listen_pasv()
        # advertise the address the client already reached us on — a
        # wildcard bind (0.0.0.0) must never leak into the 227 reply
        ip = self.conn.getsockname()[0].replace(".", ",")
        port = self._pasv.getsockname()[1]
        self.reply(227, f"entering passive mode "
                        f"({ip},{port >> 8},{port & 0xFF})")

    def _cmd_epsv(self, arg: str) -> None:
        self._listen_pasv()
        port = self._pasv.getsockname()[1]
        self.reply(229, f"entering extended passive mode (|||{port}|)")

    def _listen_pasv(self) -> None:
        if self._pasv is not None:
            self._pasv.close()
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.srv.host, 0))
        s.listen(1)
        self._pasv = s

    def _list_entries(self, path: str) -> list[dict]:
        r = self._filer("GET", path or "/",
                        params={"limit": "10000"},
                        headers={"Accept": "application/json"})
        if r.status_code != 200:
            return []
        return r.json().get("entries", [])

    def _cmd_list(self, arg: str) -> None:
        path = self._abs(arg or ".") if not arg.startswith("-") \
            else self._abs(".")
        self.reply(150, "opening data connection")
        data = self._open_data()
        try:
            lines = []
            for e in self._list_entries(path):
                name = e["full_path"].rstrip("/").rpartition("/")[2]
                is_dir = bool(e.get("mode", 0) & 0o40000)
                size = _entry_size(e)
                mtime = time.strftime(
                    "%b %d %H:%M", time.localtime(e.get("mtime", 0)))
                kind = "d" if is_dir else "-"
                lines.append(f"{kind}rw-r--r-- 1 ftp ftp "
                             f"{size:>12} {mtime} {name}")
            data.sendall(("\r\n".join(lines) + "\r\n").encode()
                         if lines else b"")
        finally:
            data.close()
        self.reply(226, "transfer complete")

    def _cmd_nlst(self, arg: str) -> None:
        path = self._abs(arg or ".")
        self.reply(150, "opening data connection")
        data = self._open_data()
        try:
            names = [e["full_path"].rstrip("/").rpartition("/")[2]
                     for e in self._list_entries(path)]
            data.sendall(("\r\n".join(names) + "\r\n").encode()
                         if names else b"")
        finally:
            data.close()
        self.reply(226, "transfer complete")

    def _cmd_rest(self, arg: str) -> None:
        try:
            self.rest_offset = int(arg)
            self.reply(350, f"restarting at {self.rest_offset}")
        except ValueError:
            self.reply(501, "bad offset")

    def _cmd_retr(self, arg: str) -> None:
        path = self._abs(arg)
        headers = {}
        offset = self.rest_offset
        self.rest_offset = 0
        if offset:
            headers["Range"] = f"bytes={offset}-"
        r = self._filer("GET", path, headers=headers, stream=True)
        try:
            if r.status_code not in (200, 206):
                self.reply(550, "no such file")
                return
            self.reply(150, "opening data connection")
            data = self._open_data()
            try:
                for chunk in r.iter_content(256 << 10):
                    data.sendall(chunk)
            finally:
                data.close()
        finally:
            r.close()
        self.reply(226, "transfer complete")

    # spill uploads to disk past this; an FTP gateway's whole job is
    # large transfers, so the body must never have to fit in RAM
    SPOOL_MAX = 16 << 20

    def _store(self, arg: str, append: bool) -> None:
        import tempfile

        path = self._abs(arg)
        self.reply(150, "opening data connection")
        data = self._open_data()
        spool = tempfile.SpooledTemporaryFile(max_size=self.SPOOL_MAX)
        try:
            if append:
                # prefix with the existing content, streamed
                r = self._filer("GET", path, stream=True)
                try:
                    if r.status_code == 200:
                        for piece in r.iter_content(256 << 10):
                            spool.write(piece)
                finally:
                    r.close()
            while True:
                chunk = data.recv(256 << 10)
                if not chunk:
                    break
                spool.write(chunk)
            data.close()
            data = None
            size = spool.tell()
            spool.seek(0)
            # the file-object body streams in pieces with its length;
            # the filer's autochunk splits it into volume chunks
            self._filer("POST", path, data=spool, headers={
                "Content-Length": str(size)}).raise_for_status()
        finally:
            if data is not None:
                data.close()
            spool.close()
        self.reply(226, "transfer complete")

    def _cmd_stor(self, arg: str) -> None:
        self._store(arg, append=False)

    def _cmd_appe(self, arg: str) -> None:
        self._store(arg, append=True)

    def _cmd_dele(self, arg: str) -> None:
        r = self._filer("DELETE", self._abs(arg))
        if r.status_code in (200, 204):
            self.reply(250, "deleted")
        else:
            self.reply(550, "delete failed")

    def _cmd_rmd(self, arg: str) -> None:
        path = self._abs(arg)
        if not self._stat_dir(path):
            self.reply(550, "no such directory")
            return
        r = self._filer("DELETE", path + "/",
                        params={"recursive": "true"})
        if r.status_code in (200, 204):
            self.reply(250, "directory removed")
        else:
            self.reply(550, "rmd failed")

    def _cmd_mkd(self, arg: str) -> None:
        path = self._abs(arg)
        r = self._filer("PUT", path, params={"mkdir": "1"})
        if r.status_code < 300:
            self.reply(257, f'"{arg}" created')
        else:
            self.reply(550, "mkdir failed")

    def _cmd_rnfr(self, arg: str) -> None:
        if self._entry(self._abs(arg)) is None:
            self.reply(550, "no such file")
            return
        self.rename_from = self._abs(arg)
        self.reply(350, "ready for RNTO")

    def _cmd_rnto(self, arg: str) -> None:
        if not self.rename_from:
            self.reply(503, "RNFR first")
            return
        r = self._filer("PUT", self._abs(arg),
                        params={"mv.from": self.rename_from})
        self.rename_from = ""
        if r.status_code < 300:
            self.reply(250, "renamed")
        else:
            self.reply(550, "rename failed")

    def _cmd_size(self, arg: str) -> None:
        e = self._entry(self._abs(arg))
        if e is None or e.get("mode", 0) & 0o40000:
            self.reply(550, "no such file")
            return
        self.reply(213, str(_entry_size(e)))

    def _cmd_mdtm(self, arg: str) -> None:
        e = self._entry(self._abs(arg))
        if e is None:
            self.reply(550, "no such file")
            return
        self.reply(213, time.strftime("%Y%m%d%H%M%S",
                                      time.gmtime(e.get("mtime", 0))))


class FtpServer:
    """`seaweedfs_tpu ftp` — serve a filer directory over FTP."""

    def __init__(self, filer_url: str, port: int = 8021,
                 host: str = "127.0.0.1", root: str = "/",
                 users: dict[str, str] | None = None,
                 anonymous: bool = True):
        self.filer_url = filer_url.rstrip("/") \
            if filer_url.startswith("http") else f"http://{filer_url}"
        self.host = host
        self.port = port
        self.root = "/" + root.strip("/") if root.strip("/") else ""
        self.users = users or {}
        self.anonymous = anonymous and not self.users
        self._srv: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._stopping = False

    def start(self) -> "FtpServer":
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(16)
        self.port = s.getsockname()[1]
        self._srv = s
        self._thread = threading.Thread(target=self._accept, daemon=True)
        self._thread.start()
        return self

    def _accept(self) -> None:
        while not self._stopping:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            FtpSession(self, conn).start()

    def stop(self) -> None:
        self._stopping = True
        if self._srv is not None:
            self._srv.close()
