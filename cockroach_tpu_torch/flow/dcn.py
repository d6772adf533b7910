"""Cross-host flow streams — the colrpc Outbox/Inbox; the port of
``cockroach_tpu.flow.dcn``.

Reference: a remote DistSQL flow streams batches over gRPC FlowStream
(pkg/sql/colflow/colrpc/outbox.go:44 serializes via colserde at :280;
inbox.go:48 is an Operator whose Next() reads the stream; the service is
execinfrapb/api.proto:143-166 SetupFlow/FlowStream). This module is that
lane between processes:

- ``FlowOutbox``: drives a local operator and streams its batches over a
  socket, then an end-of-stream marker;
- ``FlowInbox``: a SourceOperator whose next_batch() reads one batch from
  the socket and lands it on its device as a Batch — downstream
  operators cannot tell it from a local scan;
- ``FlowServer``: answers SetupFlow-style requests naming a registered
  flow (a callable returning an Operator) with the stream (one request
  per connection);
- ``setup_remote_flow``: the dialing half.

Frames: a 4-byte little-endian length, then the payload; length 0 ends a
stream (the changefeed, gossip and Batch RPC planes share these three
frame functions). Every socket read is bounded by the socket's own
timeout: dials pass ``flow.dcn.io_timeout_s`` to ``create_connection``,
servers set it before the handshake read, and a socket that reaches a
read without one gets that deadline there (``_recv_exact``).

The batch format. The reference frames each batch as an Arrow IPC
stream; the card machine has no ``pyarrow``, so the port writes its own
with numpy and ``struct`` (``_encode_batch``/``_decode_batch``): a u32
header length and a JSON header (the schema, the row count and each
STRING column's dictionary values), padded to 8 bytes, then per column
its data buffer (the live rows' canonical values, little-endian; BOOL as
one byte, BYTES as W bytes a row) and its validity buffer (one byte a
row), each padded to 8 bytes. The live rows are gathered and packed on
the batch's device and cross to the host in one copy; the receiver
uploads the body in one copy and views each column out of it. A NULL's
data slot is zero (BYTES excepted), as the reference's Arrow round trip
leaves it, so both give the same Batch (capacity ``max(4096, n)``),
schema and dictionaries. It is not Arrow byte for byte.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time

import numpy as np
import torch

from ..coldata.batch import DEFAULT_CAPACITY, Batch, Column, Dictionary
from ..coldata.types import Family, Schema, SQLType
from ..device import resolve_device
from ..utils import settings, tracing
from .operator import Operator, SourceOperator

_LEN = struct.Struct("<I")
_ALIGN = 8


def _send_msg(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Exactly n bytes, within the socket's own timeout. Dials pass one to
    create_connection and most servers set one before their first read;
    a socket that has none (an accepted connection inherits no timeout)
    gets ``flow.dcn.io_timeout_s`` here, so a peer that stops mid-frame
    raises ``socket.timeout`` instead of parking the thread for good."""
    if sock.gettimeout() is None:
        sock.settimeout(settings.get("flow.dcn.io_timeout_s"))
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("flow stream closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> bytes | None:
    n = _LEN.unpack(_recv_exact(sock, _LEN.size))[0]
    if n == 0:
        return None
    return _recv_exact(sock, n)


def _recv_batch_msg(sock: socket.socket) -> bytearray | None:
    """One frame read straight into a writable buffer (a batch payload is
    viewed in place, not copied again); None at end of stream."""
    n = _LEN.unpack(_recv_exact(sock, _LEN.size))[0]
    if n == 0:
        return None
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("flow stream closed mid-message")
        got += k
    return buf


# -- the batch format ---------------------------------------------------------


def _pad(n: int) -> int:
    return -n % _ALIGN


def _row_bytes(t) -> int:
    """Data bytes per row of a column of type t."""
    if t.family is Family.BYTES:
        return t.width
    return t.dtype.itemsize


def _layout(schema: Schema, n: int) -> list[tuple[int, int, int]]:
    """(data offset, data bytes, valid offset) per column, from the
    start of the body."""
    out, off = [], 0
    for t in schema.types:
        nb = n * _row_bytes(t)
        voff = off + nb + _pad(nb)
        out.append((off, nb, voff))
        off = voff + n + _pad(n)
    return out


def _encode_parts(b: Batch, schema: Schema, dictionaries):
    """(header bytes, body, rows) of one batch's live rows; the body is a
    host numpy uint8 array made by one device-to-host copy."""
    from .wire import enc_schema

    dictionaries = dictionaries or {}
    idx = torch.nonzero(b.mask).squeeze(1)
    n = int(idx.shape[0])
    parts = []
    dicts = {}
    for i, t in enumerate(schema.types):
        col = b.cols[i]
        data = col.data[idx]
        valid = col.valid[idx]
        if t.family is Family.STRING:
            d = dictionaries.get(i)
            if d is None:
                raise ValueError(f"STRING column {schema.names[i]} needs "
                                 "its Dictionary")
            dicts[str(i)] = [str(v) for v in d.values]
        if t.family is not Family.BYTES:
            data = torch.where(valid, data, torch.zeros_like(data))
        if t.family is Family.BOOL:
            data = data.to(torch.uint8)
        raw = data.contiguous().view(torch.uint8).reshape(-1)
        vb = valid.to(torch.uint8)
        for x in (raw, vb):
            parts.append(x)
            k = _pad(int(x.shape[0]))
            if k:
                parts.append(torch.zeros(k, dtype=torch.uint8,
                                         device=x.device))
    body = (torch.cat(parts).cpu().numpy() if parts
            else np.zeros(0, np.uint8))
    header = json.dumps({"schema": enc_schema(schema), "n": n,
                         "dicts": dicts}).encode("utf-8")
    head = _LEN.pack(len(header)) + header
    return head + b"\0" * _pad(len(head)), body, n


def _encode_batch(b: Batch, schema: Schema, dictionaries) -> bytes:
    head, body, _n = _encode_parts(b, schema, dictionaries)
    return head + body.tobytes()


def _decode_batch(payload, device="cuda"
                  ) -> tuple[Batch, Schema, dict[int, Dictionary]]:
    """Payload -> (Batch on `device`, schema, {column: Dictionary}); the
    body crosses to the device in one copy."""
    from .wire import dec_schema

    dev = resolve_device(device)
    if not isinstance(payload, bytearray):
        payload = bytearray(payload)
    hlen = _LEN.unpack_from(payload, 0)[0]
    header = json.loads(bytes(payload[_LEN.size:_LEN.size + hlen]))
    schema = dec_schema(header["schema"])
    # a DECIMAL comes back at precision 38, as from the reference's Arrow
    # decimal128 (precision is informational; the scale is the value's)
    schema = Schema(schema.names, tuple(
        SQLType(Family.DECIMAL, t.width, 38, t.scale)
        if t.family is Family.DECIMAL else t for t in schema.types))
    n = int(header["n"])
    start = _LEN.size + hlen
    start += _pad(start)
    size = len(payload) - start
    body = (torch.frombuffer(payload, dtype=torch.uint8, offset=start,
                             count=size) if size
            else torch.zeros(0, dtype=torch.uint8))
    body = body.to(dev)
    cap = max(DEFAULT_CAPACITY, n)
    cols = []
    for t, (off, nb, voff) in zip(schema.types, _layout(schema, n)):
        raw = body[off:off + nb]
        if t.family is Family.BOOL:
            data = raw.to(torch.bool)
        elif t.family is Family.BYTES:
            data = raw.reshape(n, t.width)
        else:
            data = raw.view(t.torch_dtype)
        full = torch.zeros((cap,) + tuple(data.shape[1:]),
                           dtype=data.dtype, device=dev)
        full[:n] = data
        valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        valid[:n] = body[voff:voff + n].to(torch.bool)
        cols.append(Column(data=full, valid=valid))
    mask = torch.arange(cap, device=dev) < n
    dicts = {int(i): Dictionary(np.asarray(v, dtype=object))
             for i, v in header["dicts"].items()}
    return Batch(cols=tuple(cols), mask=mask), schema, dicts


# -- streams -------------------------------------------------------------------


class FlowOutbox:
    """Stream every batch of `op` over the socket (outbox.go:44 role).
    ``frames``, ``rows`` and ``bytes`` count what it sent, and
    ``encode_s`` the seconds spent framing (the device gather and the
    copy to the host included)."""

    def __init__(self, op: Operator, sock: socket.socket):
        self.op = op
        self.sock = sock
        self.frames = self.rows = self.bytes = 0
        self.encode_s = 0.0

    def run(self) -> int:
        from .dispatch import exec_lock
        from .runtime import _post_run_updates

        # device work runs under the device lock, one batch at a time (a
        # host serves several streams at once); the sends do not hold it
        with exec_lock():
            self.op.init()
        while True:
            with exec_lock():
                b = self.op.next_batch()
                if b is None:
                    break
                t0 = time.perf_counter()
                head, body, rows = _encode_parts(b, self.op.output_schema,
                                                 self.op.dictionaries)
                self.encode_s += time.perf_counter() - t0
            n = len(head) + body.nbytes
            self.sock.sendall(_LEN.pack(n) + head)
            if body.nbytes:
                self.sock.sendall(memoryview(body))
            self.frames += 1
            self.rows += rows
            self.bytes += n
        with exec_lock():
            # a speculative capacity that overflowed (a duplicate-key
            # join's emission) made this run's output short; local runs
            # re-run, a stream cannot: it ends without its end marker, so
            # the gateway sees a broken stream and degrades
            rerun = _post_run_updates(self.op)
            self.op.close()
        if rerun:
            raise RuntimeError("a speculative capacity overflowed while "
                               "streaming: the stream is incomplete")
        self.sock.sendall(_LEN.pack(0))  # end of stream
        return self.frames


def runtime_dictionaries(schema: Schema) -> dict[int, Dictionary]:
    """An empty Dictionary per STRING column, marked as filled at runtime
    (as a string_agg output's): a stream's dictionaries arrive with its
    batches, after the operators above it were built around these
    objects; plan-time readers of dictionary contents refuse them."""
    out = {}
    for i, t in enumerate(schema.types):
        if t.family is Family.STRING:
            d = Dictionary(np.array([], dtype=object))
            d._runtime = True
            out[i] = d
    return out


class FlowInbox(SourceOperator):
    """An Operator fed by a remote flow stream (inbox.go:48 role), landing
    each batch on ``device``. The schema arrives with every batch; callers
    that need it before pulling pass the expected schema up front.

    Dictionary codes are relative to the sender's dictionary. A STRING
    column's dictionary given up front (the gateway's own build of the
    fragment) must equal every batch's; one left out is made empty at
    runtime (``runtime_dictionaries``) and filled in place from the first
    batch, which later batches must equal. A batch whose dictionary
    differs raises: its codes cannot be read against the plan's.
    ``frames`` and ``bytes`` count what it received, ``decode_s`` the
    seconds spent unframing (the copy to the device included)."""

    def __init__(self, sock: socket.socket, schema: Schema,
                 dictionaries: dict[int, Dictionary] | None = None,
                 expect_trace: bool = False, device="cuda"):
        super().__init__()
        self.sock = sock
        self.device = resolve_device(device)
        self.output_schema = schema
        self.dictionaries = {**runtime_dictionaries(schema),
                             **(dictionaries or {})}
        self._filled: set[int] = set()
        self.decode_s = 0.0
        self.frames = 0
        self.bytes = 0
        self._done = False
        # when the handshake carried a trace context the server appends
        # its span recording as one JSON message after the end-of-stream
        # marker; it is grafted under the span that set the flow up
        # (captured here: a puller thread's context is empty)
        self._expect_trace = expect_trace
        self._trace_parent = tracing.current() if expect_trace else None

    def _next(self):
        from .dispatch import exec_released

        if self._done:
            return None
        # waiting on the peer, the device lock goes to other work (on a
        # host, possibly the very stream this one waits for)
        with exec_released():
            payload = _recv_batch_msg(self.sock)
        if payload is None:
            self._done = True
            if self._expect_trace:
                try:
                    trailer = _recv_msg(self.sock)
                    if trailer:
                        tracing.graft(
                            json.loads(trailer.decode("utf-8")),
                            into=self._trace_parent)
                except (OSError, ConnectionError, ValueError):
                    # the data stream is complete: a lost recording must
                    # not fail the query
                    pass
            # a drained stream's socket is dead weight: close it here
            try:
                self.sock.close()
            except OSError:
                pass
            return None
        self.frames += 1
        self.bytes += len(payload)
        t0 = time.perf_counter()
        b, _schema, dicts = _decode_batch(payload, self.device)
        self.decode_s += time.perf_counter() - t0
        for i, d in dicts.items():
            mine = self.dictionaries.get(i)
            if mine is None:
                self.dictionaries[i] = d
            elif getattr(mine, "_runtime", False) and i not in self._filled:
                mine.reset(d.values)
                self._filled.add(i)
            elif not np.array_equal(mine.values.astype(str),
                                    d.values.astype(str)):
                raise ValueError(
                    f"stream dictionary of column {i} differs from the "
                    "plan's: its codes cannot be read")
        return b

    def close(self) -> None:
        # shutdown first: it unblocks a puller thread parked in recv
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class FlowServer:
    """Answers SetupFlow requests: the client sends a flow name (or a JSON
    hello carrying it and a trace context), the server streams that
    flow's batches back. One request per connection."""

    def __init__(self, flows: dict[str, object], host: str = "127.0.0.1",
                 port: int = 0):
        self.flows = flows
        self._srv = socket.create_server((host, port))
        self.addr = self._srv.getsockname()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def serve_background(self) -> "FlowServer":
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        return self

    def _serve(self) -> None:
        self._srv.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # close() raced the accept
            # one thread serves connections in turn: a client that dials
            # and goes silent must not wedge every flow behind it
            conn.settimeout(settings.get("flow.dcn.io_timeout_s"))
            try:
                msg = _recv_msg(conn)
                if msg is None:
                    continue
                name = msg.decode("utf-8", errors="replace")
                tctx = None
                if name.startswith("{"):
                    try:
                        hello = json.loads(name)
                        name = str(hello.get("flow", ""))
                        tctx = hello.get("trace")
                    except ValueError:
                        tctx = None
                make_op = self.flows.get(name)
                if make_op is None:
                    continue
                with tracing.remote_span("flow/outbox", tctx,
                                         flow=name) as osp:
                    sent = FlowOutbox(make_op(), conn).run()
                    if osp is not None:
                        osp.tags["batches"] = sent
                if osp is not None:
                    # the recording travels as one more message after the
                    # end-of-stream marker; the inbox grafts it
                    _send_msg(conn,
                              json.dumps(osp.to_dict()).encode("utf-8"))
            # crlint: allow-broad-except(accept loop survives any one connection/operator failure; logged below)
            except Exception as e:  # noqa: BLE001 - one connection's failure never ends the accept loop; logged
                from ..utils import log

                log.warning(log.OPS, "flow connection failed",
                            error=f"{type(e).__name__}: {e}")
            finally:
                conn.close()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._srv.close()


def setup_remote_flow(addr, name: str, schema: Schema,
                      device="cuda") -> FlowInbox:
    """Dial a FlowServer and return the Inbox (on ``device``) for the
    named flow — the DistSQLPlanner.setupFlows remote half
    (distsql_running.go:391). The dial's timeout persists as the socket
    timeout, so every later stream read carries the same deadline."""
    dev = resolve_device(device)
    sock = socket.create_connection(
        tuple(addr), timeout=settings.get("flow.dcn.io_timeout_s"))
    tctx = tracing.context()
    if tctx is None:
        _send_msg(sock, name.encode("utf-8"))
        return FlowInbox(sock, schema, device=dev)
    _send_msg(sock, json.dumps(
        {"flow": name, "trace": tctx}).encode("utf-8"))
    return FlowInbox(sock, schema, expect_trace=True, device=dev)
