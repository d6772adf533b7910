"""KV Batch RPC — the Internal.Batch service reduction.

The port of ``cockroach_tpu.kv.rpc``.

Reference: every KV request travels as a BatchRequest of typed sub-
requests (Get/Put/Delete/Scan/...) over the gRPC `Internal` service
(kvpb/api.proto:3691 Batch, :3697 streaming BatchStream); DistSender
splits client batches by range and fans them out to these endpoints.

Reduction: one listening socket per server speaking the DCN length-
prefixed framing with JSON envelopes (base64 for byte payloads — the
same byte-exact discipline as raw rangefeeds). A batch is a list of sub-
requests evaluated IN ORDER against the server's DB (non-transactional
requests, like the reference's non-txn batches; the txn layer stays
client-side in this build). Errors return per-batch with a typed code so
clients can distinguish WriteIntentError (retryable wait) from hard
failures. The connection is persistent: one client can stream many
batches (the BatchStream shape).
"""

from __future__ import annotations

import base64
import itertools
import json
import socket
import threading
import uuid

from ..storage.lsm import WriteIntentError
from ..utils import locks, tracing
from ..utils.errors import register_passthrough
from ..utils.faults import InjectedFault
from .liveness import EpochFencedError, NotLeaseHolderError
from .txn import DB

# leaseholder-guard errors travel as typed codes named after the class
_LEASE_ERRORS = (EpochFencedError, NotLeaseHolderError)


class AmbiguousResultError(RuntimeError):
    """A mutation batch's apply state is unknowable (kvpb's
    AmbiguousResultError): every transport retry failed, and the last
    attempt may or may not have been applied server-side. Deliberately
    NOT a ConnectionError — no layer may silently retry past this; the
    caller must read to disambiguate or surface it to the application."""

    def __init__(self, msg: str, cid: str | None = None,
                 seq: int | None = None):
        super().__init__(msg)
        self.cid = cid
        self.seq = seq


register_passthrough(AmbiguousResultError)

_client_ids = itertools.count(1)


def _b64(b: bytes | None) -> str | None:
    return None if b is None else base64.b64encode(b).decode("ascii")


def _unb64(s: str | None) -> bytes | None:
    return None if s is None else base64.b64decode(s)

_MUTATION_OPS = frozenset(("put", "delete"))


class BatchServer:
    """Serve Batch RPCs against one DB (Node.Batch -> Store.Send role)."""

    def __init__(self, db: DB, host: str = "127.0.0.1", port: int = 0,
                 lease_check=None):
        self.db = db
        # optional leaseholder guard: called with the decoded request
        # before mutation batches evaluate; raises EpochFencedError /
        # NotLeaseHolderError (kv/liveness.py) which travel to the client
        # as typed codes. Node wires this to its LeaseManager.
        self.lease_check = lease_check
        # SO_REUSEADDR so a restart rebinds the port while the previous
        # incarnation's conns sit in TIME_WAIT (create_server sets it on
        # POSIX; made explicit because restart-on-same-port is contract)
        self._srv = socket.create_server((host, port))
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.settimeout(0.2)
        self.addr = self._srv.getsockname()
        self._stop = threading.Event()
        self._conns: set = set()
        self._conns_lock = locks.lock("rpc.server.conns")
        self._threads: list[threading.Thread] = []
        self._accept_thread = threading.Thread(
            target=self._serve, daemon=True, name="kv-batch-server")
        self._accept_thread.start()

    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._conns_lock:
                if self._stop.is_set():
                    conn.close()
                    return
                self._conns.add(conn)
                t = threading.Thread(target=self._conn_loop, args=(conn,),
                                     daemon=True)
                self._threads.append(t)
            t.start()

    def _conn_loop(self, conn):
        """Persistent per-connection loop (BatchStream shape): one bad
        request answers with an error frame, never kills the server."""
        from ..flow.dcn import _recv_msg, _send_msg

        try:
            while not self._stop.is_set():
                msg = _recv_msg(conn)
                if msg is None:
                    return
                ssp = None
                try:
                    req = json.loads(msg.decode("utf-8"))
                    # snowball half: the caller's (trace_id, span_id)
                    # rides the envelope; the server-side span's finished
                    # recording ships back on the response for grafting
                    with tracing.remote_span(
                            "kv/server.batch", req.get("trace"),
                            ops=len(req.get("requests", ()))) as ssp:
                        resp = self._eval_batch(req)
                        # post-apply response loss (the ambiguous-result
                        # window): the batch IS applied, the client never
                        # hears back. A `drop` here severs the stream; the
                        # retry must hit the replay cache, not re-apply.
                        from ..utils import faults

                        faults.fire("kv.rpc.server.respond")
                except InjectedFault as e:
                    if e.kind == "drop":
                        raise  # sever the stream, like a crashed replica
                    resp = {"error": str(e), "code": "Internal"}
                except _LEASE_ERRORS as e:
                    resp = {"error": str(e),
                            "code": type(e).__name__,
                            "holder": getattr(e, "holder", None)}
                except AmbiguousResultError as e:
                    # a stamped batch found applied in part (a DistSender's
                    # sub-batches): typed, never answered as applied
                    resp = {"error": str(e), "code": "AmbiguousResultError"}
                except WriteIntentError as e:
                    # carry the REAL conflicting keys/txns: clients format
                    # them into user errors and conflict handling keys on
                    # the txn ids
                    resp = {"error": str(e), "code": "WriteIntentError",
                            "keys": [_b64(k) for k in e.keys],
                            "txns": list(e.txns)}
                except Exception as e:  # noqa: BLE001 - a wire error reply
                    resp = {"error": f"{type(e).__name__}: {e}",
                            "code": "Internal"}
                if ssp is not None:
                    # errored evals ship their recording too — the client
                    # grafts BEFORE raising, so failed batches still show
                    # in the trace
                    resp["trace"] = ssp.to_dict()
                _send_msg(conn, json.dumps(resp).encode("utf-8"))
        except (OSError, ConnectionError):
            pass  # client went away
        finally:
            conn.close()
            with self._conns_lock:
                self._conns.discard(conn)

    def _eval_batch(self, req: dict) -> dict:
        """Evaluate sub-requests in order (batcheval's cmd_* dispatch)."""
        from ..utils import faults

        # replica-side evaluation fault (TestingEvalFilter analog): fires
        # BEFORE any sub-request touches the store, so a dropped batch is
        # all-or-nothing and a retry replays it exactly
        faults.fire("kv.rpc.server.eval")
        reqs = req.get("requests", ())
        if self.lease_check is not None and any(
                r["op"] in _MUTATION_OPS for r in reqs):
            with tracing.leaf_span("kv/lease_check",
                                   range=req.get("range")):
                self.lease_check(req)
        if req.get("cid") is not None and reqs and all(
                r["op"] in _MUTATION_OPS for r in reqs):
            return self._eval_stamped_mutations(req)
        out = []
        for r in req.get("requests", ()):
            op = r["op"]
            if op == "put":
                ts = self.db.put(_unb64(r["key"]), _unb64(r["value"]))
                out.append({"ts": ts})
            elif op == "delete":
                ts = self.db.delete(_unb64(r["key"]))
                out.append({"ts": ts})
            elif op == "get":
                v = self.db.get(_unb64(r["key"]), ts=r.get("ts"))
                out.append({"value": _b64(v)})
            elif op == "scan":
                rows = self.db.scan(
                    _unb64(r.get("start")), _unb64(r.get("end")),
                    ts=r.get("ts"), max_keys=r.get("max_keys"),
                )
                out.append({"rows": [[_b64(k), _b64(v)] for k, v in rows]})
            else:
                raise ValueError(f"unknown batch op {op!r}")
        return {"responses": out}

    def _eval_stamped_mutations(self, req: dict) -> dict:
        """Exactly-once path for (cid, seq)-stamped mutation-only batches.

        Under the engine mutex: a replay-cache hit returns the FIRST
        attempt's response verbatim (the retry crossed a severed-response
        or restart window — applying again would double-write); a miss
        evaluates every mutation, then lands ops + dedup entry + response
        in one atomic WAL record via Engine.apply_rpc_batch. Reads and
        mixed batches take the legacy path above: reads are idempotent,
        so only mutations need replay protection (kvserver's replay
        protection covers writes for the same reason)."""
        from ..utils import metric

        db = self.db
        cid, seq = req["cid"], int(req["seq"])
        with db.engine.mu:
            cached = db.engine.replay_cache_get(
                cid, seq, n_ops=len(req["requests"]))
            if cached is not None:
                metric.REPLAY_CACHE_HITS.inc()
                return cached
            muts, out = [], []
            for r in req["requests"]:
                k = _unb64(r["key"])
                db._check_lock(k)  # WriteIntentError surfaces typed
                ts = db.clock.now()
                if r["op"] == "put":
                    muts.append((k, _unb64(r["value"]), ts, 0, False))
                else:
                    muts.append((k, b"", ts, 0, True))
                out.append({"ts": ts})
            resp = {"responses": out}
            db.engine.apply_rpc_batch(cid, seq, muts, resp)
        return resp

    def close(self):
        """Idempotent full teardown: stop accepting, sever every accepted
        conn, and JOIN the accept + per-conn threads (the stopper's
        "start/stop bound every thread" contract) — a closed server holds
        no port, no fd, and no thread, so back-to-back restarts on the
        same port never collide."""
        self._stop.set()
        self._srv.close()
        # closing established conns unblocks per-connection loops parked
        # in recv
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
            threads = list(self._threads)
            self._threads.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        if self._accept_thread is not threading.current_thread():
            self._accept_thread.join(timeout=5)
        for t in threads:
            if t is not threading.current_thread():
                t.join(timeout=5)


class BatchClient:
    """Dial a BatchServer; issue batches over one persistent connection.
    Raises WriteIntentError/RuntimeError mirroring the server's typed
    error codes (the DistSender would catch the former and retry).

    Transport discipline (the DistSender's send-retry reduction): every
    RPC runs under a per-call deadline (rpc.batch.deadline_s) and
    TRANSPORT failures — drops, resets, timeouts — re-dial and re-send
    with exponential backoff + jitter (rpc.batch.max_retries attempts).
    Typed SERVER answers (WriteIntentError, Internal) are never retried
    here: the txn layer owns intent waits, and hard errors must surface.

    Exactly-once writes: every mutation-only batch is stamped with this
    client's id and a per-batch sequence number. A retry re-sends the
    SAME stamp, so a failure after server-side evaluation (severed
    response, server restart) dedups against the server's WAL-persisted
    replay cache instead of double-applying. When retries exhaust with
    the apply state still unknown, the client raises a typed
    AmbiguousResultError — never a silent retry, never a silent drop."""

    def __init__(self, addr, deadline_s: float | None = None,
                 max_retries: int | None = None):
        from ..utils import settings

        self.addr = tuple(addr)
        self.deadline_s = (deadline_s if deadline_s is not None
                          else settings.get("rpc.batch.deadline_s"))
        self.max_retries = (max_retries if max_retries is not None
                            else settings.get("rpc.batch.max_retries"))
        # globally unique client id: the replay cache keys dedup entries
        # on it, so two clients must never collide (uuid covers
        # multi-process; the counter disambiguates within-process)
        self.cid = f"{uuid.uuid4().hex[:12]}-{next(_client_ids)}"
        self._seq = itertools.count(1)
        self._sock = self._dial()
        self._lock = locks.lock("rpc.client.pool")

    def _dial(self) -> socket.socket:
        s = socket.create_connection(self.addr, timeout=self.deadline_s)
        s.settimeout(self.deadline_s)
        return s

    def _redial(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = self._dial()

    @staticmethod
    def _transport_error(e: BaseException) -> bool:
        """Retry ONLY wire-level failures; typed server errors surface."""
        return isinstance(e, (ConnectionError, socket.timeout,
                              TimeoutError, OSError))

    def batch(self, requests: list[dict],
              range_id: int | None = None) -> list[dict]:
        from ..utils import faults, metric, retry
        from ..flow.dcn import _recv_msg, _send_msg

        envelope: dict = {"requests": requests}
        if range_id is not None:
            # range-addressed batch: the server's lease guard verifies it
            # still holds this range's epoch lease before mutating
            envelope["range"] = int(range_id)
        # stamp mutation-only batches: the (cid, seq) token is allocated
        # ONCE here, so every transport retry below re-sends the same
        # token and the server can dedup (reads stay unstamped — they
        # are idempotent and must not occupy the one-entry window)
        stamped = bool(requests) and all(
            r["op"] in _MUTATION_OPS for r in requests)
        seq = None
        if stamped:
            seq = next(self._seq)
            envelope["cid"] = self.cid
            envelope["seq"] = seq
        # trace propagation: the current span's (trace_id, span_id) rides
        # the envelope — built ONCE here so every transport retry carries
        # the same parent and the server's recording grafts under it
        tctx = tracing.context()
        if tctx is not None:
            envelope["trace"] = tctx
        payload = json.dumps(envelope).encode("utf-8")

        with tracing.leaf_span(
                "kv/batch", addr=f"{self.addr[0]}:{self.addr[1]}",
                ops=len(requests)) as ksp:
            attempts = 0

            def send_once():
                nonlocal attempts
                attempts += 1
                with self._lock:  # one in-flight batch per connection
                    faults.fire("kv.rpc.client.batch")
                    try:
                        _send_msg(self._sock, payload)
                        msg = _recv_msg(self._sock)
                    except (socket.timeout, TimeoutError) as e:
                        metric.RPC_TIMEOUTS.inc()
                        # a timed-out stream has unknown framing state:
                        # the next attempt MUST start on a fresh
                        # connection
                        self._redial()
                        raise retry.RPCDeadlineError(
                            f"batch rpc deadline ({self.deadline_s}s) "
                            f"exceeded against {self.addr}") from e
                    except (ConnectionError, OSError):
                        self._redial()
                        raise
                if msg is None:
                    self._redial()
                    raise ConnectionError("batch server closed the stream")
                return msg

            try:
                msg = retry.call(
                    send_once,
                    retry.Backoff(
                        max_attempts=self.max_retries,
                        deadline_s=self.deadline_s * self.max_retries),
                    retryable=self._transport_error,
                )
            except Exception as e:
                if ksp is not None:
                    ksp.add_tag("attempts", attempts)
                if stamped and self._transport_error(e):
                    # retries exhausted mid-mutation: the batch may or may
                    # not have applied, and nothing below can find out.
                    # Surface a typed ambiguity instead of letting a
                    # ConnectionError tempt an outer layer into re-sending
                    # under a FRESH seq (which WOULD double-apply).
                    metric.AMBIGUOUS_RESULTS.inc()
                    raise AmbiguousResultError(
                        f"mutation batch (cid={self.cid}, seq={seq}) "
                        f"against {self.addr}: transport failed after "
                        f"{self.max_retries} attempts; apply state "
                        f"unknown", cid=self.cid, seq=seq) from e
                raise
            if ksp is not None:
                ksp.add_tag("attempts", attempts)
            resp = json.loads(msg.decode("utf-8"))
            # graft the server-side recording BEFORE the typed raises so
            # failed evals still land in the caller's trace
            tracing.graft(resp.pop("trace", None))
            if "error" in resp:
                code = resp.get("code")
                if code == "WriteIntentError":
                    raise WriteIntentError(
                        [_unb64(k) for k in resp.get("keys", [])],
                        resp.get("txns", []),
                    )
                if code == "EpochFencedError":
                    raise EpochFencedError(resp["error"])
                if code == "AmbiguousResultError":
                    metric.AMBIGUOUS_RESULTS.inc()
                    raise AmbiguousResultError(resp["error"], cid=self.cid,
                                               seq=seq)
                if code == "NotLeaseHolderError":
                    raise NotLeaseHolderError(
                        resp["error"], holder=resp.get("holder"))
                raise RuntimeError(f"batch rpc failed: {resp['error']}")
            return resp["responses"]

    # convenience single-op wrappers (the kv.DB surface over RPC)
    def put(self, key: bytes, value: bytes) -> int:
        return self.batch([{"op": "put", "key": _b64(key),
                            "value": _b64(value)}])[0]["ts"]

    def get(self, key: bytes, ts: int | None = None) -> bytes | None:
        r = {"op": "get", "key": _b64(key)}
        if ts is not None:
            r["ts"] = ts
        return _unb64(self.batch([r])[0]["value"])

    def delete(self, key: bytes) -> int:
        return self.batch([{"op": "delete",
                            "key": _b64(key)}])[0]["ts"]

    def scan(self, start: bytes | None, end: bytes | None,
             max_keys: int | None = None) -> list[tuple[bytes, bytes]]:
        r = {"op": "scan", "start": _b64(start), "end": _b64(end)}
        if max_keys is not None:
            r["max_keys"] = max_keys
        return [(base64.b64decode(k), base64.b64decode(v))
                for k, v in self.batch([r])[0]["rows"]]

    def close(self):
        self._sock.close()
