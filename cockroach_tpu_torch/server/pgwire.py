"""pgwire — the Postgres v3 wire protocol server over the SQL session.

Reference: pkg/sql/pgwire/server.go:854 accepts conns, conn.go:343 reads
the startup message and serves the message loop; CockroachDB speaks v3 so
every Postgres driver works unchanged. This is the same surface, reduced
to the simple-query flow every driver's autocommit path uses:

  StartupMessage -> AuthenticationOk + ParameterStatus* + BackendKeyData
                    + ReadyForQuery
  'Q' (simple query) -> RowDescription / DataRow* / CommandComplete
                        (or ErrorResponse) -> ReadyForQuery
  SSLRequest -> 'N' (no TLS here); CancelRequest -> ignored; 'X' ends.

ReadyForQuery carries the session's REAL transaction status ('I' idle,
'T' in block, 'E' aborted block) — BEGIN/COMMIT/ROLLBACK flow through the
session FSM, so drivers' transaction handling works. Results travel in
text format (the universally-supported encoding); the extended protocol
(Parse/Bind/Execute) is the next increment.

Each connection gets its OWN Session over the shared catalog/DB — the
reference's conn-executor-per-session model.

The port of ``cockroach_tpu.server.pgwire``: replies are byte for byte
the reference's. Two differences in how they travel: accepted sockets
set TCP_NODELAY, so a reply's last message is not held back for a
delayed ACK, and a reply's messages are buffered and written together
at ReadyForQuery or a Flush (the reference writes each message as it
is made). ``PgServer(device=...)`` (``"cuda"`` by default, which
raises without a card) says where the catalog and the engine live.
Connections parse, bind and write concurrently; their queries run on the
device one at a time (flow/dispatch.exec_lock).
"""

from __future__ import annotations

import re
import socket
import struct
import threading

import numpy as np

from ..sql import Session

_SSL_REQUEST = 80877103
_CANCEL_REQUEST = 80877102
_STARTUP_V3 = 196608

# type OIDs (pg_catalog.pg_type)
_OID_BOOL = 16
_OID_INT8 = 20
_OID_FLOAT8 = 701
_OID_TEXT = 25
_OID_DATE = 1082
_OID_NUMERIC = 1700


def _oid_for_dtype(dtype) -> int:
    """Column OID from the RESULT ARRAY's dtype — never from row values
    (a NULL in row 0 must not retype the whole column as TEXT)."""
    if dtype == np.bool_:
        return _OID_BOOL
    if np.issubdtype(dtype, np.integer):
        return _OID_INT8
    if np.issubdtype(dtype, np.floating):
        return _OID_FLOAT8
    return _OID_TEXT  # object arrays: strings or mixed/NULL-bearing


def _render(v) -> bytes | None:
    if v is None:
        return None
    if isinstance(v, (bool, np.bool_)):
        return b"t" if v else b"f"
    if isinstance(v, (float, np.floating)):
        return repr(float(v)).encode()
    return str(v).encode()


class _Conn:
    def __init__(self, sock: socket.socket, session: Session):
        self.sock = sock
        self.session = session
        self._ext_failed = False  # error sent; discarding until Sync
        self._stmts: dict[bytes, str] = {}  # prepared statements
        self._portals: dict[bytes, str] = {}  # bound portals (params inlined)
        self._out = bytearray()  # buffered reply messages

    # -- framing -------------------------------------------------------------

    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("client closed")
            buf.extend(chunk)
        return bytes(buf)

    # replies are buffered and written at ReadyForQuery, at a Flush, or
    # past _FLUSH_BYTES: one send per reply instead of one per message
    # (a result of 18k rows was 18k sends)
    _FLUSH_BYTES = 1 << 16

    def _send(self, tag: bytes, payload: bytes = b"") -> None:
        self._out += tag + struct.pack("!I", len(payload) + 4) + payload
        if len(self._out) >= self._FLUSH_BYTES:
            self._flush()

    def _flush(self) -> None:
        if self._out:
            self.sock.sendall(self._out)
            self._out = bytearray()

    # -- startup -------------------------------------------------------------

    def startup(self) -> bool:
        while True:
            n = struct.unpack("!I", self._recv_exact(4))[0]
            body = self._recv_exact(n - 4)
            code = struct.unpack("!I", body[:4])[0]
            if code == _SSL_REQUEST:
                self.sock.sendall(b"N")  # no TLS; client retries plaintext
                continue
            if code == _CANCEL_REQUEST:
                return False
            if code != _STARTUP_V3:
                raise ConnectionError(f"unsupported protocol {code}")
            break
        self._send(b"R", struct.pack("!I", 0))  # AuthenticationOk (trust)
        for k, v in (
            (b"server_version", b"13.0 cockroach_tpu"),
            (b"client_encoding", b"UTF8"),
            (b"DateStyle", b"ISO"),
        ):
            self._send(b"S", k + b"\x00" + v + b"\x00")
        self._send(b"K", struct.pack("!II", 0, 0))  # BackendKeyData
        self._ready()
        return True

    def _txn_status(self) -> bytes:
        if getattr(self.session, "_txn_aborted", False):
            return b"E"
        return b"T" if getattr(self.session, "_txn", None) is not None \
            else b"I"

    def _ready(self) -> None:
        self._send(b"Z", self._txn_status())
        self._flush()

    # -- query flow ----------------------------------------------------------

    def _error(self, msg: str, code: str = "XX000") -> None:
        fields = (b"SERROR\x00" + b"C" + code.encode() + b"\x00"
                  + b"M" + msg.encode("utf-8", "replace") + b"\x00\x00")
        self._send(b"E", fields)

    def _row_description(self, names, dtypes) -> None:
        out = [struct.pack("!H", len(names))]
        for name, dt in zip(names, dtypes):
            out.append(
                name.encode() + b"\x00"
                + struct.pack("!IHIhih", 0, 0, _oid_for_dtype(dt), -1, -1, 0)
            )
        self._send(b"T", b"".join(out))

    def _data_row(self, row) -> None:
        out = [struct.pack("!H", len(row))]
        for v in row:
            r = _render(v)
            if r is None:
                out.append(struct.pack("!i", -1))
            else:
                out.append(struct.pack("!i", len(r)) + r)
        self._send(b"D", b"".join(out))

    def _run_query(self, sql_text: str, send_row_desc: bool = True) -> None:
        res = self.session.execute(sql_text)
        if isinstance(res, dict) and res and all(
            isinstance(v, np.ndarray) for v in res.values()
        ):
            names = list(res.keys())
            nrows = len(res[names[0]]) if names else 0
            if send_row_desc:  # extended Execute relies on Describe's
                self._row_description(names, [res[n].dtype for n in names])
            for i in range(nrows):
                self._data_row([res[n][i] for n in names])
            self._send(b"C", b"SELECT %d\x00" % nrows)
            return
        # DML / DDL / txn control results
        if isinstance(res, dict):
            if "rows_affected" in res:
                n = res["rows_affected"]
                low = sql_text.strip().lower()
                if low.startswith("insert"):
                    tag = b"INSERT 0 %d" % n
                elif low.startswith("update"):
                    tag = b"UPDATE %d" % n
                elif low.startswith("delete"):
                    tag = b"DELETE %d" % n
                else:
                    tag = b"OK"
            elif "begin" in res:
                tag = b"BEGIN"
            elif "commit" in res:
                tag = b"COMMIT"
            elif "rollback" in res:
                tag = b"ROLLBACK"
            elif "created" in res:
                tag = b"CREATE TABLE"
            elif "analyzed" in res:
                tag = b"ANALYZE"
            else:
                tag = b"OK"
        else:
            tag = b"OK"
        self._send(b"C", tag + b"\x00")

    def serve(self) -> None:
        if not self.startup():
            return
        while True:
            tag = self._recv_exact(1)
            n = struct.unpack("!I", self._recv_exact(4))[0]
            body = self._recv_exact(n - 4)
            if tag == b"X":  # Terminate
                return
            if self._ext_failed and tag != b"S":
                # error-recovery rule: after the batch's ErrorResponse,
                # discard EVERYTHING (including stray Query/unknown tags)
                # until Sync — any extra response would desync the client
                continue
            if tag == b"Q":
                sql_text = body.rstrip(b"\x00").decode("utf-8", "replace")
                try:
                    if sql_text.strip():
                        self._run_query(sql_text)
                    else:
                        self._send(b"I", b"")  # EmptyQueryResponse
                # crlint: allow-broad-except(query error becomes an ErrorResponse to the client)
                except Exception as e:  # an ErrorResponse to the client
                    self._error(f"{type(e).__name__}: {e}",
                                code=_sqlstate_for(e))
                self._ready()
            elif tag in (b"P", b"B", b"D", b"E", b"C"):
                # extended protocol (Parse/Bind/Describe/Execute/Close):
                # on ANY failure send ONE ErrorResponse then discard until
                # Sync (the error-recovery rule — a second error before
                # Sync would desync pipeline-mode clients' result queues)
                try:
                    self._extended(tag, body)
                # crlint: allow-broad-except(extended-protocol error becomes ONE ErrorResponse then discard-until-Sync)
                except Exception as e:  # one ErrorResponse, then to Sync
                    self._ext_failed = True
                    self._error(f"{type(e).__name__}: {e}",
                                code=_sqlstate_for(e))
            elif tag == b"F":
                if not self._ext_failed:
                    self._ext_failed = True
                    self._error("FunctionCall is not supported",
                                code="0A000")
            elif tag == b"H":  # Flush: write what is buffered
                self._flush()
            elif tag == b"S":  # Sync ends the extended batch
                self._ext_failed = False
                self._ready()
            else:
                self._error(f"unknown message {tag!r}")
                self._ready()

    # -- extended protocol ---------------------------------------------------

    @staticmethod
    def _cstr(body: bytes, off: int) -> tuple[str, int]:
        end = body.index(b"\x00", off)
        return body[off:end].decode("utf-8", "replace"), end + 1

    def _extended(self, tag: bytes, body: bytes) -> None:
        if tag == b"P":  # Parse: name, query, param-type oids
            name, off = self._cstr(body, 0)
            query, off = self._cstr(body, off)
            self._stmts[name.encode()] = query
            self._send(b"1", b"")  # ParseComplete
        elif tag == b"B":  # Bind: portal, stmt, formats, params
            portal, off = self._cstr(body, 0)
            stmt, off = self._cstr(body, off)
            nfmt = struct.unpack_from("!H", body, off)[0]
            fmts = struct.unpack_from("!%dH" % nfmt, body, off + 2)
            off += 2 + 2 * nfmt
            nparams = struct.unpack_from("!H", body, off)[0]
            off += 2
            params: list[str | None] = []
            for i in range(nparams):
                plen = struct.unpack_from("!i", body, off)[0]
                off += 4
                if plen < 0:
                    params.append(None)
                    continue
                fmt = fmts[i] if i < len(fmts) else (
                    fmts[0] if len(fmts) == 1 else 0)
                if fmt != 0:
                    raise ValueError(
                        "binary parameter format is not supported "
                        "(send text format)"
                    )
                params.append(body[off:off + plen].decode("utf-8"))
                off += plen
            # trailing result-format codes: binary results are not
            # implemented — reject loudly rather than sending text bytes
            # a binary-mode client would decode as garbage
            if off + 2 <= len(body):
                nrf = struct.unpack_from("!H", body, off)[0]
                rfmts = struct.unpack_from("!%dH" % nrf, body, off + 2)
                if any(f != 0 for f in rfmts):
                    raise ValueError(
                        "binary result format is not supported "
                        "(request text format)"
                    )
            sql = self._stmts.get(stmt.encode())
            if sql is None:
                raise ValueError(f"unknown prepared statement {stmt!r}")
            self._portals[portal.encode()] = _inline_params(sql, params)
            self._send(b"2", b"")  # BindComplete
        elif tag == b"D":  # Describe 'S'|'P' + name
            kind, name = body[:1], body[1:].rstrip(b"\x00")
            sql = (self._stmts.get(name) if kind == b"S"
                   else self._portals.get(name))
            if sql is None:
                raise ValueError(f"unknown {kind!r} to describe: {name!r}")
            nparams = _count_placeholders(sql)
            if kind == b"S":
                # ParameterDescription is mandatory for statement
                # describes; oid 0 = unspecified (clients send text)
                self._send(b"t", struct.pack("!H", nparams)
                           + struct.pack("!I", 0) * nparams)
                # plan the schema with placeholders as NULLs
                sql = _inline_params(sql, [None] * nparams)
            schema = self._plan_schema(sql)
            if schema is None:
                self._send(b"n", b"")  # NoData (DML/DDL)
            else:
                names, dtypes = schema
                self._row_description(names, dtypes)
        elif tag == b"E":  # Execute: portal, row limit (ignored: full)
            portal, off = self._cstr(body, 0)
            sql = self._portals.get(portal.encode())
            if sql is None:
                raise ValueError(f"unknown portal {portal!r}")
            # extended-protocol Execute sends DataRows WITHOUT a
            # RowDescription (clients got it from Describe). The inlined
            # text reaches Session.execute, where sql/plancache.py
            # re-parameterizes it — so Parse-once/Bind-many clients hit
            # the prepared-plan cache on every rebind: no re-plan, no new
            # capture (the inlined literals rebind as graph inputs).
            self._run_query(sql, send_row_desc=False)
        elif tag == b"C":  # Close 'S'|'P' + name
            kind, name = body[:1], body[1:].rstrip(b"\x00")
            (self._stmts if kind == b"S" else self._portals).pop(name, None)
            self._send(b"3", b"")  # CloseComplete

    def _plan_schema(self, sql: str):
        """(names, dtypes) for a SELECT by BINDING (not running) it —
        Describe must answer before Execute. Non-SELECTs: None (NoData)."""
        from ..coldata.types import Family as F
        from ..sql import parser as P
        from ..sql.binder import Binder

        try:
            stmt = P.parse_statement(sql)
        # crlint: allow-broad-except(describe-time parse failure means no row description, not an error)
        except Exception:  # unparsable: no row description, not an error
            return None
        if not isinstance(stmt, P.Select):
            return None
        rel = Binder(self.session.catalog).bind(stmt)
        dtypes = []
        for t in rel.schema.types:
            if t.family is F.BOOL:
                dtypes.append(np.dtype(np.bool_))
            elif t.family in (F.INT, F.DATE):
                dtypes.append(np.dtype(np.int64))
            elif t.family in (F.FLOAT, F.DECIMAL):
                dtypes.append(np.dtype(np.float64))
            else:
                dtypes.append(np.dtype(object))
        return list(rel.schema.names), dtypes


_NUMERIC_PARAM = re.compile(r"^-?\d+(\.\d+)?$")
_PLACEHOLDER = re.compile(r"\$(\d+)")
_SQL_LITERAL = re.compile(r"'(?:[^']|'')*'")


def _outside_literals(sql: str):
    """Yield (is_literal, segment) pairs — $n inside a quoted SQL string
    is literal text, never a placeholder."""
    last = 0
    for m in _SQL_LITERAL.finditer(sql):
        yield False, sql[last:m.start()]
        yield True, m.group(0)
        last = m.end()
    yield False, sql[last:]


def _count_placeholders(sql: str) -> int:
    return max(
        (int(m.group(1))
         for lit, seg in _outside_literals(sql) if not lit
         for m in _PLACEHOLDER.finditer(seg)),
        default=0,
    )


def _inline_params(sql: str, params: list) -> str:
    """Substitute $1..$n with SQL literals (text-format params): numeric-
    looking values inline bare (placeholder type inference by value
    shape — the reference infers from context; divergence documented),
    strings quote with '' escaping, None becomes NULL. ONE regex pass
    over the NON-LITERAL segments only — sequential replacement would
    re-substitute placeholders appearing inside parameter values, and a
    '$n' inside a quoted literal is just text."""
    def lit(m: re.Match) -> str:
        i = int(m.group(1))
        if not 1 <= i <= len(params):
            raise ValueError(f"no parameter bound for ${i}")
        v = params[i - 1]
        if v is None:
            return "null"
        if _NUMERIC_PARAM.match(v):
            return v
        if v.lower() in ("true", "false"):
            return v.lower()
        return "'" + v.replace("'", "''") + "'"

    return "".join(
        seg if is_lit else _PLACEHOLDER.sub(lit, seg)
        for is_lit, seg in _outside_literals(sql)
    )


def _sqlstate_for(e: Exception) -> str:
    from ..kv.txn import TransactionRetryError
    from ..storage.lsm import WriteIntentError
    from ..utils.errors import AdmissionRejectedError, QueryError

    if isinstance(e, QueryError) and e.__cause__ is not None:
        return _sqlstate_for(e.__cause__)
    if isinstance(e, (TransactionRetryError, WriteIntentError)):
        return "40001"  # serialization_failure: clients retry
    if isinstance(e, AdmissionRejectedError):
        # insufficient_resources class: the node is shedding load (queue
        # full / rate limit / overload). The message carries the
        # retry-after hint; clients back off instead of hammering
        return "53300"
    return "XX000"


class PgServer:
    """Accept loop: one thread + one Session per connection. The warm
    menu is not the server's: ``server/node.Node.start`` builds it
    (sql/warmmenu.warm_node) before the node reports readiness."""

    def __init__(self, catalog=None, db=None, host: str = "127.0.0.1",
                 port: int = 0, session_factory=None, device="cuda"):
        if session_factory is None:
            # bootstrap the shared catalog and store ONCE (a new store on
            # `device` when none is given); per-connection sessions reuse
            # them without re-scanning descriptors
            boot = Session(catalog=catalog, db=db, device=device)
            catalog, db = boot.catalog, boot.db
            boot.close()
            self._factory = lambda: Session(catalog=catalog, db=db,
                                            bootstrap=False, device=device)
        else:
            self._factory = session_factory
        self._srv = socket.create_server((host, port))
        self.addr = self._srv.getsockname()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def serve_background(self) -> "PgServer":
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        return self

    def _serve(self) -> None:
        from ..utils import log, metric

        self._srv.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return

            # a reply is several small messages, each its own send:
            # without TCP_NODELAY, Nagle's algorithm holds the last one
            # for the client's delayed ACK (about 40 ms on Linux)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

            def run(c=conn):
                try:
                    _Conn(c, self._factory()).serve()
                except (ConnectionError, OSError):
                    pass  # client went away: its problem, not the server's
                # crlint: allow-broad-except(connection thread: failure logged, socket closed in finally)
                except Exception as e:  # logged; the socket closes below
                    log.warning(log.OPS, "pgwire connection failed",
                                error=f"{type(e).__name__}: {e}")
                finally:
                    c.close()

            metric.PG_CONNS.inc()
            threading.Thread(target=run, daemon=True).start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._srv.close()
