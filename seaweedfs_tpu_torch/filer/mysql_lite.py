"""Minimal MySQL client protocol implementation (stdlib only).

Implemented from the public MySQL client/server protocol docs for the
mysql filer store — wire protocol #5 in this tree (after redis RESP,
etcd v3, MongoDB OP_MSG, cassandra CQL v4); the reference reaches
MySQL through go-sql-driver/mysql
(SeaweedFS weed/filer/mysql/mysql_store.go:14).

Scope: HandshakeV10 + HandshakeResponse41 with mysql_native_password,
COM_QUERY text protocol with client-side parameter interpolation
(go-sql-driver's interpolateParams=true approach — every value is
escaped into the statement text, so the text protocol carries the
whole conversation), OK/ERR/resultset parsing with EOF framing
(CLIENT_DEPRECATE_EOF intentionally not negotiated).

Exposes a DB-API-ish surface (connect / cursor / execute / fetchall /
description / commit) — exactly what AbstractSqlStore consumes.

The port's copy of seaweedfs_tpu/filer/mysql_lite.py: the same files, keys,
rows and request bytes, over the standard library only.
"""
from __future__ import annotations

import hashlib
import socket
import struct

CLIENT_LONG_PASSWORD = 0x1
CLIENT_CONNECT_WITH_DB = 0x8
CLIENT_PROTOCOL_41 = 0x200
CLIENT_TRANSACTIONS = 0x2000
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_PLUGIN_AUTH = 0x80000


class MysqlError(IOError):
    def __init__(self, errno: int, message: str):
        super().__init__(f"mysql error {errno}: {message}")
        self.errno = errno


def native_password_token(password: str, nonce: bytes) -> bytes:
    """SHA1(pass) XOR SHA1(nonce + SHA1(SHA1(pass))) —
    the mysql_native_password scramble."""
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(nonce + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def escape_literal(v) -> str:
    """Value -> MySQL SQL literal (the client-side interpolation).
    Bytes go as hex literals (X'..') — charset-independent, unlike
    quoted binary whose high bytes would be mangled by the connection
    charset."""
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, (bytes, bytearray, memoryview)):
        return "X'" + bytes(v).hex() + "'"
    if isinstance(v, str):
        return "'" + _escape_str(v) + "'"
    raise TypeError(f"unsupported SQL value type {type(v)}")


_ESCAPES = {"\x00": "\\0", "\n": "\\n", "\r": "\\r", "\x1a": "\\Z",
            "'": "\\'", "\\": "\\\\", '"': '\\"'}


def _escape_str(s: str) -> str:
    return "".join(_ESCAPES.get(ch, ch) for ch in s)


def _lenenc(buf: bytes, at: int) -> tuple[int | None, int]:
    """Length-encoded integer -> (value, next offset); 0xFB = NULL."""
    first = buf[at]
    if first < 0xFB:
        return first, at + 1
    if first == 0xFB:
        return None, at + 1
    if first == 0xFC:
        return struct.unpack_from("<H", buf, at + 1)[0], at + 3
    if first == 0xFD:
        return int.from_bytes(buf[at + 1:at + 4], "little"), at + 4
    return struct.unpack_from("<Q", buf, at + 1)[0], at + 9


class Cursor:
    def __init__(self, conn: "MysqlConnection"):
        self._conn = conn
        self.description = None
        self._rows: list = []

    def execute(self, sql: str, args: tuple = ()) -> None:
        if args:
            sql = sql % tuple(escape_literal(a) for a in args)
        cols, rows = self._conn.query(sql)
        self.description = [(c, None, None, None, None, None, None)
                            for c in cols] if cols else None
        self._rows = rows

    def fetchall(self) -> list:
        return self._rows

    def close(self) -> None:
        pass


class MysqlConnection:
    """One authenticated connection, autocommit on."""

    def __init__(self, host: str, port: int = 3306, user: str = "root",
                 password: str = "", database: str = "",
                 timeout: float = 30.0):
        self._sock = socket.create_connection((host, int(port)), timeout)
        self._seq = 0
        self._handshake(user, password, database)

    # -- packet framing -------------------------------------------------
    def _send(self, payload: bytes) -> None:
        # payloads >= 16MB-1 are split into 0xFFFFFF chunks, terminated
        # by a shorter (possibly empty) packet — protocol framing rule
        at = 0
        while True:
            chunk = payload[at:at + 0xFFFFFF]
            hdr = len(chunk).to_bytes(3, "little") + bytes([self._seq])
            self._seq = (self._seq + 1) & 0xFF
            self._sock.sendall(hdr + chunk)
            at += len(chunk)
            if len(chunk) < 0xFFFFFF:
                return

    def _recv_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            piece = self._sock.recv(n - len(out))
            if not piece:
                raise IOError("mysql connection closed")
            out += piece
        return out

    def _recv(self) -> bytes:
        out = b""
        while True:
            hdr = self._recv_exact(4)
            length = int.from_bytes(hdr[:3], "little")
            self._seq = (hdr[3] + 1) & 0xFF
            out += self._recv_exact(length)
            if length < 0xFFFFFF:  # 0xFFFFFF = continuation follows
                return out

    # -- handshake ------------------------------------------------------
    def _handshake(self, user: str, password: str, database: str) -> None:
        greet = self._recv()
        if greet and greet[0] == 0xFF:
            raise self._err(greet)
        if greet[0] != 10:
            raise IOError(f"unsupported handshake protocol {greet[0]}")
        at = greet.index(b"\x00", 1) + 1  # server version
        at += 4  # thread id
        nonce = greet[at:at + 8]
        at += 8 + 1  # auth-data-1 + filler
        at += 2 + 1 + 2 + 2  # caps-low, charset, status, caps-high
        auth_len = greet[at] if at < len(greet) else 0
        at += 1 + 10  # auth data len + reserved
        if auth_len:
            # part 2 is max(13, auth_len - 8) incl. trailing NUL
            part2 = greet[at:at + max(13, auth_len - 8)]
            nonce += part2.rstrip(b"\x00")[:12]
        caps = (CLIENT_LONG_PASSWORD | CLIENT_PROTOCOL_41 |
                CLIENT_TRANSACTIONS | CLIENT_SECURE_CONNECTION |
                CLIENT_PLUGIN_AUTH |
                (CLIENT_CONNECT_WITH_DB if database else 0))
        token = native_password_token(password, nonce[:20])
        # charset 45 = utf8mb4_general_ci: 4-byte UTF-8 (emoji and
        # non-BMP CJK in file names) must survive the connection
        resp = struct.pack("<IIB23x", caps, 1 << 24, 45)
        resp += user.encode() + b"\x00"
        resp += bytes([len(token)]) + token
        if database:
            resp += database.encode() + b"\x00"
        resp += b"mysql_native_password\x00"
        self._send(resp)
        ok = self._recv()
        if ok and ok[0] == 0xFF:
            raise self._err(ok)
        if ok and ok[0] == 0xFE:
            raise IOError("server requested an auth method switch; "
                          "only mysql_native_password is supported")

    @staticmethod
    def _err(payload: bytes) -> MysqlError:
        errno = struct.unpack_from("<H", payload, 1)[0]
        msg = payload[3:]
        if msg[:1] == b"#":
            msg = msg[6:]  # sql state marker + 5 chars
        return MysqlError(errno, msg.decode("utf-8", "replace"))

    # -- text protocol --------------------------------------------------
    def query(self, sql: str) -> tuple[list[str], list[list]]:
        """COM_QUERY -> (column names, rows of bytes|None)."""
        self._seq = 0
        self._send(b"\x03" + sql.encode())
        first = self._recv()
        if first[0] == 0xFF:
            raise self._err(first)
        if first[0] == 0x00:  # OK packet: no result set
            return [], []
        n_cols, _ = _lenenc(first, 0)
        cols = []
        for _ in range(n_cols):
            col = self._recv()
            # column definition: catalog, schema, table, org_table,
            # name, org_name (all lenenc strings)
            at = 0
            name = b""
            for field_i in range(5):
                ln, at = _lenenc(col, at)
                if field_i == 4:
                    name = col[at:at + (ln or 0)]
                at += ln or 0
            cols.append(name.decode())
        eof = self._recv()
        if eof[0] == 0xFF:  # server may still error at this point
            raise self._err(eof)
        if eof[0] != 0xFE:
            raise IOError("expected EOF after column definitions")
        rows: list[list] = []
        while True:
            pkt = self._recv()
            if pkt[0] == 0xFE and len(pkt) < 9:
                return cols, rows
            if pkt[0] == 0xFF:
                raise self._err(pkt)
            at = 0
            row: list = []
            for _ in range(n_cols):
                ln, at = _lenenc(pkt, at)
                if ln is None:
                    row.append(None)
                else:
                    row.append(pkt[at:at + ln])
                    at += ln
            rows.append(row)

    # -- DB-API surface -------------------------------------------------
    def cursor(self) -> Cursor:
        return Cursor(self)

    def commit(self) -> None:
        pass  # autocommit; AbstractSqlStore calls this after each op

    def close(self) -> None:
        try:
            self._sock.sendall(b"\x01\x00\x00\x00\x01")  # COM_QUIT
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
