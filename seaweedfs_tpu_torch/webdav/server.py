"""WebDAV gateway over the filer; the counterpart of
seaweedfs_tpu/webdav/server.py.

Equivalent of SeaweedFS weed/server/webdav_server.go (golang.org/
x/net/webdav over the filer): the RFC 4918 subset — OPTIONS, PROPFIND
(Depth 0/1), PROPPATCH (accepted, changes nothing), MKCOL, GET/HEAD,
PUT, DELETE, MOVE, COPY, and class-2 LOCK/UNLOCK with in-memory
advisory tokens (Windows and macOS clients refuse to write without
them). Data and namespace both ride the filer's HTTP API.

The port serves it from an `rpc/http.App` on threads: one route for
any method (`App.route("*", ...)`, aiohttp's `web.route("*", ...)`),
the tracing middleware ("webdav") and the deadline one minted at this
edge, and a body cap of 1 TiB (the reference's `client_max_size`). The
replies — statuses, headers, the multistatus and lock XML — are the
reference's byte for byte. Filer hops go through the calling thread's
`rpc/httpclient.session()`, which carries the request's trace context
and deadline on. A GET streams the filer's body out in 256 KiB pieces;
a PUT reads the whole body first, as the reference does. The lock
table is shared by the handler threads, under a mutex.
"""
from __future__ import annotations

import threading
import time
import uuid
from urllib.parse import quote, unquote
from xml.sax.saxutils import escape

from ..filer.entry import entry_size as _entry_size
from ..rpc.http import App, Request, Response
from ..rpc.httpclient import session
from ..utils import retry, tracing

# bytes per piece of a streamed GET
PIECE = 256 << 10
# the reference's client_max_size
MAX_BODY = 1 << 40
# each filer hop: (connect, read) seconds
FILER_TIMEOUT = (5.0, 300.0)
_XML = "application/xml; charset=utf-8"


def _prop_xml(href: str, is_dir: bool, size: int, mtime: float,
              name: str) -> str:
    rtype = "<D:resourcetype><D:collection/></D:resourcetype>" if is_dir \
        else "<D:resourcetype/>"
    modified = time.strftime("%a, %d %b %Y %H:%M:%S GMT",
                             time.gmtime(mtime))
    return (
        f"<D:response><D:href>{escape(href)}</D:href>"
        "<D:propstat><D:prop>"
        f"{rtype}"
        f"<D:displayname>{escape(name)}</D:displayname>"
        f"<D:getcontentlength>{size}</D:getcontentlength>"
        f"<D:getlastmodified>{modified}</D:getlastmodified>"
        "<D:supportedlock><D:lockentry><D:lockscope><D:exclusive/>"
        "</D:lockscope><D:locktype><D:write/></D:locktype>"
        "</D:lockentry></D:supportedlock>"
        "</D:prop><D:status>HTTP/1.1 200 OK</D:status></D:propstat>"
        "</D:response>")


def _is_dir(entry: dict | None) -> bool:
    return bool(entry and entry.get("mode", 0) & 0o40000)


class _Relay:
    """A filer reply's body as a streamed reply's pieces; closing it
    closes the filer reply (a client that hangs up mid-body)."""

    def __init__(self, resp):
        self._resp = resp

    def __iter__(self):
        return self._resp.iter_content(PIECE)

    def close(self) -> None:
        self._resp.close()


class WebDavServer:
    LOCK_TTL = 3600.0

    def __init__(self, filer_url: str, root: str = "/",
                 collection: str = "", replication: str = ""):
        self.filer_url = filer_url.rstrip("/") \
            if filer_url.startswith("http") else f"http://{filer_url}"
        self.root = root.rstrip("/")
        self.collection = collection
        self.replication = replication
        self._locks: dict[str, tuple[str, float]] = {}  # path -> (token, expiry)
        self._locks_mu = threading.Lock()
        self.app = self._build_app()

    def _lock_conflict(self, req: Request, path: str) -> bool:
        """True when `path` is exclusively locked by a token the
        request does not present (in If or Lock-Token headers)."""
        with self._locks_mu:
            rec = self._locks.get(path)
            if rec is None:
                return False
            token, expiry = rec
            if time.monotonic() > expiry:
                del self._locks[path]
                return False
        presented = ((req.headers.get("If") or "") +
                     (req.headers.get("Lock-Token") or ""))
        return token not in presented

    def _build_app(self) -> App:
        app = App(middlewares=[tracing.middleware("webdav"),
                               retry.middleware("webdav", edge=True)],
                  max_body=MAX_BODY)
        app.get("/debug/traces", tracing.handle_debug_traces)
        app.route("*", "/{path:.*}", self.dispatch)
        return app

    def _abs(self, path: str) -> str:
        return (self.root + "/" + path.strip("/")).rstrip("/") or "/"

    def dispatch(self, req: Request) -> Response:
        handler = {
            "OPTIONS": self.do_options, "PROPFIND": self.do_propfind,
            "PROPPATCH": self.do_proppatch, "MKCOL": self.do_mkcol,
            "GET": self.do_get, "HEAD": self.do_get,
            "PUT": self.do_put, "DELETE": self.do_delete,
            "MOVE": self.do_move, "COPY": self.do_copy,
            "LOCK": self.do_lock, "UNLOCK": self.do_unlock,
        }.get(req.method.upper())
        if handler is None:
            return Response(status=405)
        return handler(req)

    # -- plumbing to the filer -----------------------------------------
    def _filer(self, method: str, full: str, **kw):
        return session().request(method, f"{self.filer_url}{quote(full)}",
                                 timeout=FILER_TIMEOUT, **kw)

    def _entry(self, full: str) -> dict | None:
        r = self._filer("GET", full, params={"meta": "1"})
        if r.status_code == 404:
            return None
        return r.json()

    def _listing(self, full: str) -> list[dict]:
        out, last = [], ""
        while True:
            r = self._filer("GET", full or "/",
                            params={"limit": "1024", "lastFileName": last})
            if r.status_code != 200:
                return out
            d = r.json()
            batch = d.get("entries", [])
            out.extend(batch)
            if not d.get("shouldDisplayLoadMore") or not batch:
                return out
            last = d.get("lastFileName", "")

    # -- methods --------------------------------------------------------
    def do_options(self, req: Request) -> Response:
        return Response(status=200, headers={
            "DAV": "1, 2",
            "Allow": "OPTIONS, PROPFIND, PROPPATCH, MKCOL, GET, HEAD, "
                     "PUT, DELETE, MOVE, COPY, LOCK, UNLOCK",
            "MS-Author-Via": "DAV",
        })

    def do_propfind(self, req: Request) -> Response:
        path = "/" + req.match_info["path"]
        full = self._abs(path)
        depth = req.headers.get("Depth") or "1"
        entry = self._entry(full)
        if entry is None and full != "/":
            return Response(status=404)
        parts = []
        is_dir = full == "/" or _is_dir(entry)
        size = _entry_size(entry) if entry else 0
        href = path if path.startswith("/") else "/" + path
        parts.append(_prop_xml(
            href + ("/" if is_dir and not href.endswith("/") else ""),
            is_dir, 0 if is_dir else size, (entry or {}).get("mtime", 0),
            href.rstrip("/").rsplit("/", 1)[-1] or "/"))
        if is_dir and depth != "0":
            for e in self._listing(full):
                child_dir = _is_dir(e)
                name = e["full_path"].rsplit("/", 1)[-1]
                child_href = (href.rstrip("/") + "/" + name +
                              ("/" if child_dir else ""))
                parts.append(_prop_xml(child_href, child_dir,
                                       _entry_size(e), e.get("mtime", 0),
                                       name))
        body = ('<?xml version="1.0" encoding="utf-8"?>'
                '<D:multistatus xmlns:D="DAV:">' + "".join(parts) +
                "</D:multistatus>")
        return Response(body.encode(), status=207, content_type=_XML)

    def do_proppatch(self, req: Request) -> Response:
        path = "/" + req.match_info["path"]
        body = ('<?xml version="1.0" encoding="utf-8"?>'
                '<D:multistatus xmlns:D="DAV:">'
                f"<D:response><D:href>{escape(path)}</D:href>"
                "<D:propstat><D:status>HTTP/1.1 200 OK</D:status>"
                "</D:propstat></D:response></D:multistatus>")
        return Response(body.encode(), status=207, content_type=_XML)

    def do_mkcol(self, req: Request) -> Response:
        full = self._abs("/" + req.match_info["path"])
        if self._entry(full) is not None:
            return Response(status=405)  # exists
        r = self._filer("PUT", full, params={"mkdir": "1"})
        return Response(status=201 if r.status_code < 300
                        else r.status_code)

    def do_get(self, req: Request) -> Response:
        full = self._abs("/" + req.match_info["path"])
        headers = {}
        if req.headers.get("Range") is not None:
            headers["Range"] = req.headers["Range"]
        entry = self._entry(full)
        if entry is None:
            return Response(status=404)
        if _is_dir(entry):
            return Response(status=405)  # collection GET
        r = self._filer("GET", full, headers=headers, stream=True)
        relay = None  # owns the filer reply once the body streams
        try:
            # the reference passes ETag, Content-Range, Last-Modified
            # and Accept-Ranges on, compared case for case with
            # aiohttp's spelling of the names, which is "Etag": no ETag
            # ever passes
            resp_headers = {k: r.headers[k] for k in
                            ("Content-Range", "Last-Modified",
                             "Accept-Ranges")
                            if r.headers.get(k) is not None}
            if req.method == "HEAD":
                resp_headers["Content-Length"] = \
                    r.headers.get("Content-Length") or "0"
                return Response(status=r.status_code,
                                headers=resp_headers)
            # stream: a 20 GB download must not sit in the gateway's
            # memory before its first byte goes out
            length = r.headers.get("Content-Length")
            if length is not None:
                resp_headers["Content-Length"] = length
            # aiohttp's StreamResponse names this type when given none
            resp_headers["Content-Type"] = "application/octet-stream"
            size = int(length) if length is not None else None
            relay = _Relay(r)
            return Response(status=r.status_code, headers=resp_headers,
                            stream=relay, length=size)
        finally:
            if relay is None:
                r.close()

    def do_put(self, req: Request) -> Response:
        path = "/" + req.match_info["path"]
        if self._lock_conflict(req, path):
            return Response(status=423)
        full = self._abs(path)
        data = req.read()
        params = {}
        if self.collection:
            params["collection"] = self.collection
        if self.replication:
            params["replication"] = self.replication
        r = self._filer("PUT", full, data=data, params=params,
                        headers={"Content-Type": req.content_type or
                                 "application/octet-stream"})
        return Response(status=201 if r.status_code < 300
                        else r.status_code)

    def do_delete(self, req: Request) -> Response:
        path = "/" + req.match_info["path"]
        if self._lock_conflict(req, path):
            return Response(status=423)
        full = self._abs(path)
        if self._entry(full) is None:
            return Response(status=404)
        r = self._filer("DELETE", full, params={"recursive": "true"})
        return Response(status=204 if r.status_code < 300
                        else r.status_code)

    def _dest_path(self, req: Request) -> str | None:
        dest = req.headers.get("Destination") or ""
        if not dest:
            return None
        # strip scheme://host
        if "://" in dest:
            dest = dest.split("://", 1)[1]
            dest = dest[dest.find("/"):]
        return unquote(dest)

    def do_move(self, req: Request) -> Response:
        src_rel = "/" + req.match_info["path"]
        src = self._abs(src_rel)
        dest_rel = self._dest_path(req)
        if dest_rel is None:
            return Response(status=400)
        if self._lock_conflict(req, src_rel) or \
                self._lock_conflict(req, dest_rel):
            return Response(status=423)
        dest = self._abs(dest_rel)
        overwrite = (req.headers.get("Overwrite") or "T") != "F"
        if self._entry(src) is None:
            return Response(status=404)
        existed = self._entry(dest) is not None
        if existed and not overwrite:
            return Response(status=412)
        if existed:
            self._filer("DELETE", dest, params={"recursive": "true"})
        r = self._filer("PUT", dest, params={"mv.from": src})
        if r.status_code >= 300:
            return Response(status=r.status_code)
        return Response(status=204 if existed else 201)

    def do_copy(self, req: Request) -> Response:
        src = self._abs("/" + req.match_info["path"])
        dest_rel = self._dest_path(req)
        if dest_rel is None:
            return Response(status=400)
        if self._lock_conflict(req, dest_rel):
            return Response(status=423)
        dest = self._abs(dest_rel)
        overwrite = (req.headers.get("Overwrite") or "T") != "F"
        entry = self._entry(src)
        if entry is None:
            return Response(status=404)
        existed = self._entry(dest) is not None
        if existed and not overwrite:
            return Response(status=412)
        self._copy_tree(src, dest, _is_dir(entry))
        return Response(status=204 if existed else 201)

    def _copy_tree(self, src: str, dest: str, is_dir: bool) -> None:
        if is_dir:
            self._filer("PUT", dest, params={"mkdir": "1"})
            for e in self._listing(src):
                name = e["full_path"].rsplit("/", 1)[-1]
                self._copy_tree(f"{src}/{name}", f"{dest}/{name}",
                                _is_dir(e))
            return
        data = self._filer("GET", src).content
        self._filer("PUT", dest, data=data,
                    headers={"Content-Type": "application/octet-stream"})

    # -- class-2 advisory locks ----------------------------------------
    def do_lock(self, req: Request) -> Response:
        path = "/" + req.match_info["path"]
        if self._lock_conflict(req, path):
            return Response(status=423)  # someone else holds it
        with self._locks_mu:
            held = self._locks.get(path)
            if held is not None and held[0] in (req.headers.get("If")
                                                or ""):
                # RFC 4918 refresh: the client presented the live token
                # — extend the TTL and KEEP the token (a new one would
                # 423 every later request still using the original)
                token = held[0]
            else:
                token = f"opaquelocktoken:{uuid.uuid4()}"
            self._locks[path] = (token, time.monotonic() + self.LOCK_TTL)
        body = ('<?xml version="1.0" encoding="utf-8"?>'
                '<D:prop xmlns:D="DAV:"><D:lockdiscovery><D:activelock>'
                "<D:locktype><D:write/></D:locktype>"
                "<D:lockscope><D:exclusive/></D:lockscope>"
                "<D:depth>infinity</D:depth>"
                f"<D:locktoken><D:href>{token}</D:href></D:locktoken>"
                "<D:timeout>Second-3600</D:timeout>"
                "</D:activelock></D:lockdiscovery></D:prop>")
        return Response(body.encode(), status=200, content_type=_XML,
                        headers={"Lock-Token": f"<{token}>"})

    def do_unlock(self, req: Request) -> Response:
        path = "/" + req.match_info["path"]
        with self._locks_mu:
            held = self._locks.get(path)
            if held is not None:
                if held[0] not in (req.headers.get("Lock-Token") or ""):
                    # only the token holder may unlock (RFC 4918): a
                    # blind UNLOCK would let any client break an
                    # exclusive lock and clobber the holder's edit
                    return Response(status=409)
                self._locks.pop(path, None)
        return Response(status=204)
