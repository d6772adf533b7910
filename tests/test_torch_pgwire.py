"""The port's pgwire server (cockroach_tpu_torch/server/pgwire.py) against
the reference's: the same statements go to both servers through a
hand-rolled Postgres v3 client, and every reply message (RowDescription,
DataRow, CommandComplete, ErrorResponse with its SQLSTATE, ReadyForQuery
with its transaction status, the extended protocol's Parse/Bind/Close
completions, ParameterDescription and NoData) is byte-equal."""

import contextlib
import socket
import struct
import threading

import pytest
import torch

from cockroach_tpu.kv import DB as jDB
from cockroach_tpu.kv import ManualClock as jClock
from cockroach_tpu.server.pgwire import PgServer as jPgServer
from cockroach_tpu.storage.lsm import Engine as jEngine
from cockroach_tpu_torch.kv import DB as tDB
from cockroach_tpu_torch.kv import ManualClock as tClock
from cockroach_tpu_torch.server.pgwire import PgServer as tPgServer
from cockroach_tpu_torch.sql.session import Session as tSession
from cockroach_tpu_torch.storage.lsm import Engine as tEngine


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These small tables gain nothing from intra-op threads, and several
    test workers' thread pools on shared cores slow each other down."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


class RawPg:
    """A v3 client that returns every reply message as (tag, body)."""

    def __init__(self, addr):
        self.sock = socket.create_connection(addr, timeout=30)
        body = struct.pack("!I", 196608) + b"user\x00t\x00\x00"
        self.sock.sendall(struct.pack("!I", len(body) + 4) + body)
        self.startup = self._until_ready()

    def _recv(self, n):
        buf = bytearray()
        while len(buf) < n:
            c = self.sock.recv(n - len(buf))
            assert c, "server closed"
            buf.extend(c)
        return bytes(buf)

    def _until_ready(self):
        msgs = []
        while True:
            tag = self._recv(1)
            n = struct.unpack("!I", self._recv(4))[0]
            msgs.append((tag, self._recv(n - 4)))
            if tag == b"Z":
                return msgs

    def send(self, tag: bytes, body: bytes = b""):
        self.sock.sendall(tag + struct.pack("!I", len(body) + 4) + body)

    def query(self, sql: str):
        self.send(b"Q", sql.encode() + b"\x00")
        return self._until_ready()

    def prepare(self, name, sql):
        self.send(b"P", name.encode() + b"\x00" + sql.encode() + b"\x00"
                  + struct.pack("!H", 0))

    def bind(self, portal, stmt, params):
        body = portal.encode() + b"\x00" + stmt.encode() + b"\x00"
        body += struct.pack("!H", 1) + struct.pack("!H", 0)
        body += struct.pack("!H", len(params))
        for p in params:
            if p is None:
                body += struct.pack("!i", -1)
            else:
                pb = str(p).encode()
                body += struct.pack("!i", len(pb)) + pb
        body += struct.pack("!H", 0)
        self.send(b"B", body)

    def sync(self):
        self.send(b"S")
        return self._until_ready()

    def close(self):
        self.send(b"X")
        self.sock.close()


@pytest.fixture
def servers():
    """The reference's server and the port's (on the CPU), each over a
    fresh store with a manual clock."""
    j = jPgServer(db=jDB(jEngine(key_width=24, val_width=128,
                                 memtable_size=4096), jClock()))
    t = tPgServer(db=tDB(tEngine(key_width=24, val_width=128,
                                 memtable_size=4096, device="cpu"),
                         tClock()), device="cpu")
    j.serve_background()
    t.serve_background()
    yield j, t
    j.close()
    t.close()


SIMPLE = (
    "create table acct (id int primary key, bal decimal(12, 2), "
    "tag string, d date, f float)",
    "insert into acct values (1, 10.50, 'a', '1995-03-15', 1.5), "
    "(2, 20.00, 'b', '1996-01-01', null), (3, 0.25, 'a', null, -2.25)",
    "select id, bal, tag, d, f from acct order by id",
    "select tag, sum(bal) as s, count(*) as n from acct group by tag "
    "order by tag",
    "select id from acct where f > 0 or f is null order by id",
    "update acct set bal = bal + 1.00 where tag = 'a'",
    "select sum(bal) as s from acct",
    "delete from acct where id = 2",
    "select count(*) as n, avg(bal) as a from acct",
    "select 1 + 2 as three, 'x' as s, true as b",
    "",
    "select nope from acct",
    "selec 1",
    "create index acct_tag on acct (tag)",
    "select id from acct where tag = 'a' order by id",
    "analyze acct",
    "show tables",
    "show columns from acct",
    "show statistics for table acct",
    "set application_name = 'parity'",
    "show application_name",
    "set cluster setting sql.plan_cache.enabled = true",
    "show cluster setting sql.plan_cache.size",
)

TXN = (
    "create table u (a int primary key, b int)",
    "insert into u values (1, 10), (2, 20)",
    "begin",
    "update u set b = b - 5 where a = 1",
    "select a, b from u order by a",
    "select nope from u",
    "select a from u",
    "rollback",
    "select a, b from u order by a",
    "begin",
    "insert into u values (3, 30)",
    "commit",
    "select a, b from u order by a",
    "commit",
    "begin",
    "begin",
    "rollback",
)


def _replies(srv, statements):
    c = RawPg(srv.addr)
    try:
        return [c.startup] + [c.query(s) for s in statements]
    finally:
        c.close()


@pytest.mark.parametrize("script", [SIMPLE, TXN], ids=["simple", "txn"])
def test_simple_query_replies_byte_equal(servers, script):
    j, t = servers
    want = _replies(j, script)
    got = _replies(t, script)
    for stmt, w, g in zip(("<startup>",) + script, want, got):
        assert g == w, stmt
    # the aborted block's status and an ErrorResponse's SQLSTATE
    assert b"E" in [m[0] for r in got for m in r]


def _extended(srv):
    c = RawPg(srv.addr)
    out = []
    try:
        out.append(c.query(
            "create table ep (id int primary key, v int, s string)"))
        out.append(c.query("insert into ep values (1, 10, 'a'), "
                           "(2, 20, 'b'), (3, 30, 'it''s')"))
        c.prepare("sel", "select id, v, s from ep where v > $1 and s <> $2"
                         " order by id")
        c.send(b"D", b"Ssel\x00")
        c.bind("", "sel", ["15", "zzz"])
        c.send(b"D", b"P\x00")
        c.send(b"E", b"\x00" + struct.pack("!i", 0))
        out.append(c.sync())
        for params in (["0", "it's"], [None, "zzz"], ["25", "b"]):
            c.bind("", "sel", params)
            c.send(b"E", b"\x00" + struct.pack("!i", 0))
            out.append(c.sync())
        c.prepare("ins", "insert into ep values ($1, $2, $3)")
        c.bind("", "ins", ["4", "40", "d"])
        c.send(b"D", b"P\x00")
        c.send(b"E", b"\x00" + struct.pack("!i", 0))
        c.send(b"C", b"Sins\x00")
        out.append(c.sync())
        c.send(b"E", b"nope\x00" + struct.pack("!i", 0))
        c.send(b"E", b"nope\x00" + struct.pack("!i", 0))
        out.append(c.sync())
        out.append(c.query("select count(*) as n from ep"))
    finally:
        c.close()
    return out


def test_extended_protocol_replies_byte_equal(servers):
    j, t = servers
    want, got = _extended(j), _extended(t)
    assert len(got) == len(want)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, i


def test_unported_statement_is_an_error_response(servers, tmp_path):
    """The statements ported since (ALTER TABLE, BACKUP and tenant DDL)
    reply byte for byte as the reference's server does, and the
    connection goes on serving."""
    from cockroach_tpu.utils import external_storage as jext
    from cockroach_tpu_torch.utils import external_storage as text

    saved = [(ext, ext._NODELOCAL_BASE) for ext in (jext, text)]
    for ext, _ in saved:
        ext.set_nodelocal_base(str(tmp_path))
    replies = []
    try:
        for srv in servers:
            c = RawPg(srv.addr)
            try:
                got = [c.query("create table w (a int primary key)")]
                for stmt in ("alter table w add column z int",
                             "backup to 'nodelocal://1/w'",
                             "create tenant t1"):
                    reply = c.query(stmt)
                    assert reply[0][0] != b"E", (stmt, reply)
                    assert reply[-1] == (b"Z", b"I")
                    got.append(reply)
                got.append(c.query("select count(*) as n from w"))
                assert got[-1][-2][0] == b"C"
            finally:
                c.close()
            replies.append(got)
    finally:
        for ext, base in saved:
            ext.set_nodelocal_base(base)
    want, have = replies
    assert have == want


def _keys(reply) -> list[int]:
    """The first column of a reply's DataRows, as integers."""
    out = []
    for tag, body in reply:
        if tag == b"D":
            n = struct.unpack("!i", body[2:6])[0]
            out.append(int(body[6:6 + n]))
    return out


def test_txn_snapshot_stays_on_its_connection(monkeypatch):
    """While connection A's in-transaction SELECT scans at A's snapshot, a
    plain SELECT on connection B reads at its own: A's uncommitted row is
    never B's (B meets it as a foreign intent, 40001), and B sees every
    committed row, one committed after A's snapshot included; A's read
    sees its own row, and A commits."""
    srv = tPgServer(db=tDB(tEngine(key_width=24, val_width=128,
                                   memtable_size=4096, device="cpu"),
                           tClock()), device="cpu").serve_background()
    a, b = RawPg(srv.addr), RawPg(srv.addr)
    inside, release = threading.Event(), threading.Event()
    read_as = tSession._read_as

    @contextlib.contextmanager
    def held(self, txn):
        # A's statement waits inside its snapshot until B has read
        with read_as(self, txn):
            if not inside.is_set():
                inside.set()
                release.wait(30)
            yield

    try:
        for t in ("iso", "late"):
            a.query(f"create table {t} (k int primary key, v int)")
            a.query(f"insert into {t} values (1, 10), (2, 20)")
        a.query("begin")
        a.query("insert into iso values (3, 30)")  # A's intent
        b.query("insert into late values (4, 40)")  # after A's snapshot
        monkeypatch.setattr(tSession, "_read_as", held)
        a.send(b"Q", b"select k from iso order by k\x00")
        assert inside.wait(30)
        try:
            b_iso = b.query("select k from iso order by k")
            b_late = b.query("select k from late order by k")
        finally:
            release.set()
        assert _keys(a._until_ready()) == [1, 2, 3]
        assert b_iso[0][0] == b"E" and b"C40001" in b_iso[0][1]
        assert _keys(b_late) == [1, 2, 4]
        assert a.query("commit")[0] == (b"C", b"COMMIT\x00")
        assert _keys(b.query("select k from iso order by k")) == [1, 2, 3]
    finally:
        release.set()
        a.close()
        b.close()
        srv.close()
