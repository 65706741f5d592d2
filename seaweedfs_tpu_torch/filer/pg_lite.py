"""Minimal PostgreSQL frontend/backend protocol v3 client (stdlib only).

Implemented from the public protocol docs for the postgres filer store
— wire protocol #6 in this tree; the reference reaches postgres
through lib/pq (SeaweedFS weed/filer/postgres/postgres_store.go:14).

Scope: StartupMessage, cleartext (AuthenticationCleartextPassword) and
md5 (AuthenticationMD5Password) auth, simple Query protocol
('Q' -> 'T'/'D'/'C'/'E'/'Z'), client-side literal interpolation with
standard_conforming_strings quoting, bytea as hex literals with an
explicit ::bytea cast, and bytea (oid 17) result decoding.

Exposes the same DB-API-ish surface as mysql_lite (cursor / execute /
fetchall / description / commit) for AbstractSqlStore.

The port's copy of seaweedfs_tpu/filer/pg_lite.py: the same files, keys,
rows and request bytes, over the standard library only.
"""
from __future__ import annotations

import hashlib
import socket
import struct

BYTEA_OID = 17


class PgError(IOError):
    def __init__(self, fields: dict[str, str]):
        self.fields = fields
        super().__init__(
            f"postgres error {fields.get('C', '?')}: "
            f"{fields.get('M', '')}")


def escape_literal(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, (bytes, bytearray, memoryview)):
        return "'\\x" + bytes(v).hex() + "'::bytea"
    if isinstance(v, str):
        # standard_conforming_strings: only '' needs doubling, but a
        # backslash-free guarantee is worth keeping explicit — E''
        # syntax is deliberately NOT used
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"unsupported SQL value type {type(v)}")


class Cursor:
    def __init__(self, conn: "PgConnection"):
        self._conn = conn
        self.description = None
        self._rows: list = []

    def execute(self, sql: str, args: tuple = ()) -> None:
        if args:
            sql = sql % tuple(escape_literal(a) for a in args)
        cols, rows = self._conn.query(sql)
        self.description = [(c, None, None, None, None, None, None)
                            for c, _oid in cols] if cols else None
        self._rows = rows

    def fetchall(self) -> list:
        return self._rows

    def close(self) -> None:
        pass


class PgConnection:
    def __init__(self, host: str, port: int = 5432,
                 user: str = "postgres", password: str = "",
                 database: str = "", timeout: float = 30.0):
        self._sock = socket.create_connection((host, int(port)), timeout)
        self._startup(user, password, database or user)

    # -- framing --------------------------------------------------------
    def _send_msg(self, kind: bytes, payload: bytes) -> None:
        self._sock.sendall(kind + struct.pack(">I", len(payload) + 4) +
                           payload)

    def _recv_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            piece = self._sock.recv(n - len(out))
            if not piece:
                raise IOError("postgres connection closed")
            out += piece
        return out

    def _recv_msg(self) -> tuple[bytes, bytes]:
        kind = self._recv_exact(1)
        (length,) = struct.unpack(">I", self._recv_exact(4))
        return kind, self._recv_exact(length - 4)

    @staticmethod
    def _error(payload: bytes) -> PgError:
        fields: dict[str, str] = {}
        at = 0
        while at < len(payload) and payload[at] != 0:
            code = chr(payload[at])
            end = payload.index(b"\x00", at + 1)
            fields[code] = payload[at + 1:end].decode()
            at = end + 1
        return PgError(fields)

    # -- handshake ------------------------------------------------------
    def _startup(self, user: str, password: str, database: str) -> None:
        params = (b"user\x00" + user.encode() + b"\x00" +
                  b"database\x00" + database.encode() + b"\x00\x00")
        payload = struct.pack(">I", 196608) + params
        self._sock.sendall(struct.pack(">I", len(payload) + 4) + payload)
        while True:
            kind, body = self._recv_msg()
            if kind == b"E":
                raise self._error(body)
            if kind == b"R":
                (auth,) = struct.unpack_from(">I", body)
                if auth == 0:
                    continue  # AuthenticationOk
                if auth == 3:  # cleartext
                    self._send_msg(b"p", password.encode() + b"\x00")
                elif auth == 5:  # md5
                    salt = body[4:8]
                    inner = hashlib.md5(
                        password.encode() + user.encode()).hexdigest()
                    outer = hashlib.md5(
                        inner.encode() + salt).hexdigest()
                    self._send_msg(b"p", b"md5" + outer.encode() +
                                   b"\x00")
                else:
                    raise IOError(
                        f"unsupported postgres auth method {auth}")
            elif kind == b"Z":  # ReadyForQuery
                return
            # 'S' ParameterStatus / 'K' BackendKeyData: ignored

    # -- simple query protocol ------------------------------------------
    def query(self, sql: str) -> tuple[list, list]:
        """-> ([(name, type oid)...], rows). Text results arrive as
        bytes; bytea columns are hex-decoded to real bytes."""
        self._send_msg(b"Q", sql.encode() + b"\x00")
        cols: list[tuple[str, int]] = []
        rows: list[list] = []
        err: PgError | None = None
        while True:
            kind, body = self._recv_msg()
            if kind == b"T":
                (n,) = struct.unpack_from(">H", body)
                at = 2
                for _ in range(n):
                    end = body.index(b"\x00", at)
                    name = body[at:end].decode()
                    at = end + 1
                    _table, _attr, oid, _len, _mod, _fmt = \
                        struct.unpack_from(">IHIhiH", body, at)
                    at += 18
                    cols.append((name, oid))
            elif kind == b"D":
                (n,) = struct.unpack_from(">H", body)
                at = 2
                row: list = []
                for i in range(n):
                    (ln,) = struct.unpack_from(">i", body, at)
                    at += 4
                    if ln < 0:
                        row.append(None)
                        continue
                    val = body[at:at + ln]
                    at += ln
                    if i < len(cols) and cols[i][1] == BYTEA_OID and \
                            val[:2] == b"\\x":
                        val = bytes.fromhex(val[2:].decode())
                    row.append(val)
                rows.append(row)
            elif kind == b"E":
                err = self._error(body)
            elif kind == b"Z":
                if err is not None:
                    raise err
                return cols, rows
            # 'C' CommandComplete / 'N' notices: ignored

    # -- DB-API surface -------------------------------------------------
    def cursor(self) -> Cursor:
        return Cursor(self)

    def commit(self) -> None:
        pass  # simple-query protocol autocommits single statements

    def close(self) -> None:
        try:
            self._send_msg(b"X", b"")  # Terminate
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
