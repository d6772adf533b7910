"""Cross-host DistSQL — one query spanning processes; the port of
``cockroach_tpu.flow.disthost``.

Reference shape (pkg/sql/distsql/server.go:616 SetupFlow +
pkg/sql/flowinfra/flow_registry.go:164): the gateway ships FlowSpecs to
remote nodes, each remote registers its flow under a FlowID, and stream
connections attach to registered flows by (flow_id, stream_id). Here:

- ``HostFlowServer`` extends the one-shot FlowServer with that registry:
  a SETUP_FLOW request carries serialized plan fragments (flow/wire.py),
  which build operators against the server's catalog and wait in the
  registry; a FLOW_STREAM request attaches to one (flow_id, stream_id)
  and streams its batches back (the batch framing of flow/dcn.py).
  Either arrival order works — streams wait for their setup briefly, the
  registry's ConnectInboundStream timeout discipline. A CANCEL_FLOW
  request tears down every registered entry of a flow (the gateway's
  CancelDeadFlows reduction) and poisons the flow id so late setups and
  stream-waits for it fail instead of lingering to TTL expiry.
- ``run_distributed_hosts`` is the gateway half (DistSQLPlanner.PlanAndRun
  reduction): split an aggregation plan into per-host partial fragments
  over table shards, SetupFlow each, attach the streams, and run the
  final aggregation locally over the inboxes' union. Both gateway
  runners execute under an end-to-end flow deadline
  (sql.distsql.flow_deadline_s): the first fragment failure cancels the
  flow on every reachable host and the query DEGRADES — re-planned onto
  the surviving hosts, or run single-host locally when none survive
  (distsql_degraded_queries counts these; EXPLAIN surfaces the policy).

The in-process SPMD mesh (parallel/planner.py) remains the one-process
plane; this module is the across-processes plane stacked above it. A
host's fragments scan and compute on the host's device (its catalog's:
``HostFlowServer(device="cuda")`` by default, and without a card it
raises unless the caller passes ``device="cpu"``); the gateway's final
stage runs on the gateway catalog's device. ``stream_stats`` totals what
the gateway's inboxes received.
"""

from __future__ import annotations

import json
import socket
import threading
import time
import uuid

from ..coldata.types import Schema
from ..device import resolve_device
from ..plan import spec as S
from ..utils import faults, locks, metric, retry
from ..utils.faults import InjectedFault
from . import wire
from .dcn import FlowInbox, FlowOutbox, _recv_msg, _send_msg
from .operator import Operator

_stats_mu = threading.Lock()
_stats = {"streams": 0, "frames": 0, "bytes": 0, "decode_s": 0.0}


def stream_stats() -> dict:
    """Process totals of the gateway's inbound streams: streams drained,
    frames and bytes received, seconds spent unframing them."""
    with _stats_mu:
        return dict(_stats)


def _note_inbox(inbox: FlowInbox) -> None:
    with _stats_mu:
        _stats["streams"] += 1
        _stats["frames"] += inbox.frames
        _stats["bytes"] += inbox.bytes
        _stats["decode_s"] += inbox.decode_s


class HostFlowServer:
    """SetupFlow + FlowStream + CancelFlow service over one socket."""

    def __init__(self, catalog, host: str = "127.0.0.1", port: int = 0,
                 stream_wait_s: float = 10.0, flow_ttl_s: float = 60.0,
                 device="cuda"):
        dev = resolve_device(device)
        if catalog.device != dev:
            raise ValueError(f"catalog on {catalog.device}, server on "
                             f"{dev}: pass the catalog's device")
        self.catalog = catalog
        self.device = dev
        # what this host's outboxes sent: streams, frames, rows, bytes
        # and the seconds spent framing
        self.sent = {"streams": 0, "frames": 0, "rows": 0, "bytes": 0,
                     "encode_s": 0.0}
        # SO_REUSEADDR so back-to-back restarts rebind the port while the
        # previous incarnation's conns sit in TIME_WAIT
        self._srv = socket.create_server((host, port))
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.addr = self._srv.getsockname()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._conns: set = set()
        self._conns_lock = locks.lock("flow.host.conns")
        self._handlers: list[threading.Thread] = []
        # the flow registry: (flow_id, stream_id) -> (operator, expiry)
        # waiting for its stream connection (flow_registry.go:164); flows
        # no stream attaches to within flow_ttl_s are purged
        self._registry: dict[tuple[str, int], tuple[Operator, float]] = {}
        # flow_id -> poison expiry: cancelled flows reject late setups and
        # wake stream-waiters immediately instead of timing out
        self._cancelled: dict[str, float] = {}
        # a plain condition: stream waiters park on it until their setup
        # lands or the flow is cancelled
        self._reg_lock = threading.Condition(threading.Lock())
        self.stream_wait_s = stream_wait_s
        self.flow_ttl_s = flow_ttl_s

    def registry_size(self) -> int:
        """Live registered streams (leak checks in chaos tests)."""
        with self._reg_lock:
            self._purge_expired_locked()
            return len(self._registry)

    def serve_background(self) -> "HostFlowServer":
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="host-flow-server")
        self._thread.start()
        return self

    def _serve(self) -> None:
        try:
            self._srv.settimeout(0.2)
        except OSError:
            return  # close() raced serve_background

        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # close() raced the accept
            with self._conns_lock:
                if self._stop.is_set():
                    conn.close()
                    return
                self._conns.add(conn)
                t = threading.Thread(target=self._handle, args=(conn,),
                                     daemon=True)
                self._handlers.append(t)
            t.start()

    def _handle(self, conn: socket.socket) -> None:
        from ..utils import log

        try:
            msg = _recv_msg(conn)
            if msg is None:
                return
            req = json.loads(msg.decode("utf-8"))
            op = req.get("op")
            if op == "setup_flow":
                try:
                    self._setup_flow(req)
                except InjectedFault as e:
                    if e.kind == "drop":
                        raise  # sever: the gateway sees a dead host
                    _send_msg(conn, json.dumps({
                        "error": str(e)}).encode("utf-8"))
                    return
                # crlint: allow-broad-except(rejection reason is reported to the gateway over the wire)
                except Exception as e:  # noqa: BLE001
                    # the gateway must learn WHY its fragment was rejected
                    # (unknown table, undecodable spec), not just see a
                    # closed socket
                    _send_msg(conn, json.dumps({
                        "error": f"{type(e).__name__}: {e}"
                    }).encode("utf-8"))
                    return
                _send_msg(conn, b'{"ok": true}')
            elif op == "flow_stream":
                self._flow_stream(conn, req)
            elif op == "cancel_flow":
                self._cancel_flow(conn, req)
            else:
                _send_msg(conn, b'{"error": "unknown op"}')
        # crlint: allow-broad-except(connection handler: error logged, socket severed below)
        except Exception as e:  # noqa: BLE001
            log.warning(log.OPS, "host flow connection failed",
                        error=f"{type(e).__name__}: {e}")
        finally:
            conn.close()
            with self._conns_lock:
                self._conns.discard(conn)

    def _setup_flow(self, req: dict) -> None:
        from ..plan import builder as plan_builder

        faults.fire("flow.host.setup")
        flow_id = str(req["flow_id"])
        # build EVERY stream before registering ANY: a failure mid-request
        # must not leave half a flow in the registry
        built = {}
        for sid, spec in req["streams"].items():
            plan = wire.dec_plan(spec)
            built[(flow_id, int(sid))] = plan_builder.build(
                plan, self.catalog)
        deadline = time.time() + self.flow_ttl_s
        with self._reg_lock:
            self._purge_expired_locked()
            if flow_id in self._cancelled:
                # the gateway already gave up on this flow: registering now
                # would pin operators nothing will ever drain
                raise RuntimeError(f"flow {flow_id} was cancelled")
            for key, op in built.items():
                self._registry[key] = (op, deadline)
            self._reg_lock.notify_all()

    def _purge_expired_locked(self) -> None:
        """Drop flows no stream ever attached to (a crashed gateway must
        not pin operators forever — flow_registry.go's timeout on the
        setup side), and expire cancellation poison entries so a reused
        flow id eventually works again."""
        now = time.time()
        for key in [k for k, (_, dl) in self._registry.items() if dl < now]:
            del self._registry[key]
        for fid in [f for f, dl in self._cancelled.items() if dl < now]:
            del self._cancelled[fid]

    def _flow_stream(self, conn: socket.socket, req: dict) -> None:
        faults.fire("flow.host.stream")
        key = (str(req["flow_id"]), int(req["stream_id"]))
        deadline = time.time() + self.stream_wait_s
        with self._reg_lock:
            self._purge_expired_locked()
            while key not in self._registry:
                if key[0] in self._cancelled:
                    _send_msg(conn, b'{"error": "flow cancelled"}')
                    return
                left = deadline - time.time()
                if left <= 0:
                    _send_msg(conn, b'{"error": "no such flow"}')
                    return
                self._reg_lock.wait(timeout=left)
            op, _ = self._registry.pop(key)
        _send_msg(conn, b'{"ok": true}')
        box = FlowOutbox(op, conn)
        box.run()
        with self._conns_lock:
            self.sent["streams"] += 1
            for k in ("frames", "rows", "bytes", "encode_s"):
                self.sent[k] += getattr(box, k)

    def _cancel_flow(self, conn: socket.socket, req: dict) -> None:
        flow_id = str(req["flow_id"])
        with self._reg_lock:
            self._purge_expired_locked()
            doomed = [k for k in self._registry if k[0] == flow_id]
            for k in doomed:
                del self._registry[k]
            self._cancelled[flow_id] = time.time() + self.flow_ttl_s
            # wake stream-waiters parked on this flow so they fail NOW
            self._reg_lock.notify_all()
        _send_msg(conn, json.dumps(
            {"ok": True, "removed": len(doomed)}).encode("utf-8"))

    def close(self) -> None:
        """Idempotent full teardown: stop accepting, sever accepted conns
        (unblocking handlers parked in recv or mid-stream), join the
        accept + handler threads, drop the registry. A closed server
        holds no port, no fd, and no thread."""
        self._stop.set()
        self._srv.close()
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
            handlers = list(self._handlers)
            self._handlers.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if (self._thread is not None
                and self._thread is not threading.current_thread()):
            self._thread.join(timeout=5)
        for t in handlers:
            if t is not threading.current_thread():
                t.join(timeout=5)
        with self._reg_lock:
            self._registry.clear()
            self._cancelled.clear()
            self._reg_lock.notify_all()


def _rpc_timeout_s() -> float:
    from ..utils import settings

    return settings.get("rpc.batch.deadline_s")


def setup_flow(addr, flow_id: str, streams: dict[int, S.PlanNode]) -> None:
    """Ship plan fragments to a host's registry (SetupFlowRequest).

    Transport failures retry with backoff under the RPC deadline —
    re-registering the same (flow_id, stream_id) keys is idempotent
    (the registry overwrites). Typed rejections surface immediately."""
    payload = json.dumps({
        "op": "setup_flow", "flow_id": flow_id,
        "streams": {sid: wire.enc_plan(p) for sid, p in streams.items()},
    }).encode("utf-8")

    def once():
        sock = socket.create_connection(tuple(addr),
                                        timeout=_rpc_timeout_s())
        try:
            _send_msg(sock, payload)
            msg = _recv_msg(sock)
            if msg is None:
                raise ConnectionError(f"setup_flow: {addr} severed stream")
            resp = json.loads(msg.decode("utf-8"))
            if not resp.get("ok"):
                raise RuntimeError(f"setup_flow rejected: {resp}")
        finally:
            sock.close()

    retry.call(once, retry.Backoff(max_attempts=3),
               retryable=_transport_error)


def attach_stream(addr, flow_id: str, stream_id: int, schema: Schema,
                  dictionaries=None, device="cuda") -> FlowInbox:
    """Attach to a registered flow's stream (FlowStream RPC); its batches
    land on ``device``, their STRING codes read against ``dictionaries``
    (see FlowInbox). The handshake retries past transport failures; the
    returned inbox socket keeps its read timeout so a wedged host
    surfaces as socket.timeout in the puller instead of hanging the
    query forever."""
    dev = resolve_device(device)

    def once():
        sock = socket.create_connection(tuple(addr),
                                        timeout=_rpc_timeout_s())
        try:
            _send_msg(sock, json.dumps({
                "op": "flow_stream", "flow_id": flow_id,
                "stream_id": stream_id,
            }).encode("utf-8"))
            msg = _recv_msg(sock)
            if msg is None:
                raise ConnectionError(f"flow_stream: {addr} severed stream")
            resp = json.loads(msg.decode("utf-8"))
            if not resp.get("ok"):
                raise RuntimeError(f"flow_stream rejected: {resp}")
        except BaseException:
            sock.close()
            raise
        return FlowInbox(sock, schema, dictionaries, device=dev)

    return retry.call(once, retry.Backoff(max_attempts=3),
                      retryable=_transport_error)


def cancel_flow(addr, flow_id: str) -> int:
    """Tear down every registered entry of flow_id on one host (the
    CancelDeadFlows RPC reduction). Best-effort single attempt — the
    host may be the one that died. Returns entries removed (0 when the
    host is unreachable)."""
    try:
        sock = socket.create_connection(tuple(addr), timeout=1.0)
    except OSError:
        return 0
    try:
        _send_msg(sock, json.dumps(
            {"op": "cancel_flow", "flow_id": flow_id}).encode("utf-8"))
        msg = _recv_msg(sock)
        if msg is None:
            return 0
        resp = json.loads(msg.decode("utf-8"))
        removed = int(resp.get("removed", 0))
        if removed:
            metric.DIST_FLOWS_CANCELLED.inc(removed)
        return removed
    except (OSError, ConnectionError, ValueError):
        return 0
    finally:
        sock.close()


def _transport_error(e: BaseException) -> bool:
    """Wire-level failures only; typed rejections (RuntimeError) surface."""
    return isinstance(e, (ConnectionError, socket.timeout, TimeoutError,
                          OSError))


def probe_host(addr, timeout_s: float = 0.5) -> bool:
    """Is anything listening at addr? (the gateway's liveness check when
    deciding which hosts survive a mid-flow failure)."""
    try:
        sock = socket.create_connection(tuple(addr), timeout=timeout_s)
    except OSError:
        return False
    sock.close()
    return True


def _retryable_failure(e: BaseException | None) -> bool:
    """Walk the cause chain: did this query die of a TRANSIENT distributed
    failure (drop/timeout/injected fault) rather than a planning or data
    error? QueryError wraps the operator failure with __cause__ intact."""
    seen: set[int] = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if retry.is_retryable(e):
            return True
        e = e.__cause__ if e.__cause__ is not None else e.__context__
    return False


def _cancel_everywhere(host_addrs: list, flow_id: str) -> None:
    for addr in host_addrs:
        cancel_flow(addr, flow_id)


def plan_host_fragments(plan: S.PlanNode, n_hosts: int):
    """Split an Aggregate(complete) over a scan chain into per-host partial
    fragments + the gateway's final-stage recipe.

    Returns (fragments, (group_cols, aggs)) where fragments[i] is the plan
    to ship to host i; the caller derives the final stage's base schema
    from plan.input. Raises TypeError for plans the host distributor does
    not cover (the caller falls back to local execution, exactly like the
    reference's distSQL support checks)."""
    if not isinstance(plan, S.Aggregate) or plan.mode != "complete":
        raise TypeError("host distribution covers Aggregate(complete) roots")
    frags = [
        S.Aggregate(
            _shard_scans(plan.input, i, n_hosts), plan.group_cols,
            plan.aggs, mode="partial",
        )
        for i in range(n_hosts)
    ]
    return frags, (plan.group_cols, plan.aggs)


def _shard_scans(p: S.PlanNode, i: int, n: int) -> S.PlanNode:
    if isinstance(p, S.TableScan):
        if p.shard is not None:
            raise TypeError("scan already sharded")
        return S.TableScan(p.table, p.columns, shard=(i, n))
    if isinstance(p, S.Filter):
        return S.Filter(_shard_scans(p.input, i, n), p.predicate)
    if isinstance(p, S.Project):
        return S.Project(_shard_scans(p.input, i, n), p.exprs, p.names,
                         p.dict_overrides)
    raise TypeError(
        f"host distribution cannot shard through {type(p).__name__}"
    )


def run_distributed_hosts(plan: S.PlanNode, catalog, host_addrs: list,
                          deadline_s: float | None = None):
    """Gateway execution: one partial fragment per host, final agg here.

    The fragment count equals the host count; stream ids are 0..n-1 under
    one fresh flow id (the FlowID/StreamID pairing of api.proto). Runs
    under the flow deadline with cancel-on-failure + degradation: a
    transient fragment failure cancels the flow everywhere, probes which
    hosts still answer, and re-plans onto the survivors — or runs the
    whole plan locally when none do."""
    from ..utils import log, settings

    if deadline_s is None:
        deadline_s = settings.get("sql.distsql.flow_deadline_s")
    try:
        return _run_hosts_once(plan, catalog, host_addrs, deadline_s)
    except Exception as e:
        if not _retryable_failure(e):
            raise
        survivors = [a for a in host_addrs if probe_host(a)]
        metric.DIST_DEGRADED.inc()
        if survivors and len(survivors) < len(host_addrs):
            log.warning(log.OPS, "distributed agg degraded to survivors",
                        hosts=len(host_addrs), survivors=len(survivors),
                        error=f"{type(e).__name__}: {e}")
            return _run_hosts_once(plan, catalog, survivors, deadline_s)
        # every host still answers (a transient blip we already retried
        # through) or none do: the local plan is the only safe harbor
        log.warning(log.OPS, "distributed agg degraded to local execution",
                    hosts=len(host_addrs),
                    error=f"{type(e).__name__}: {e}")
        return _run_local(plan, catalog)


def _run_local(plan: S.PlanNode, catalog):
    from ..plan import builder as plan_builder
    from .runtime import run_operator

    return run_operator(plan_builder.build(plan, catalog))


def _run_hosts_once(plan: S.PlanNode, catalog, host_addrs: list,
                    deadline_s: float):
    from ..flow import operators as ops
    from ..plan import builder as plan_builder
    from .runtime import run_operator

    frags, (group_cols, aggs) = plan_host_fragments(plan, len(host_addrs))
    flow_id = uuid.uuid4().hex[:12]
    # the partial fragments' OUTPUT schema (the state layout) — build one
    # locally to learn it; also the base schema the final stage needs
    probe_op = plan_builder.build(frags[0], catalog)
    state_schema = probe_op.output_schema
    base_schema = plan_builder.build(plan.input, catalog).output_schema

    inboxes: list[FlowInbox] = []
    try:
        for i, (addr, frag) in enumerate(zip(host_addrs, frags)):
            setup_flow(addr, flow_id, {i: frag})
        for i, addr in enumerate(host_addrs):
            # the state columns' codes read against the gateway's own
            # build of the fragment (every host's must be equal)
            inbox = attach_stream(addr, flow_id, i, state_schema,
                                  dictionaries=probe_op.dictionaries,
                                  device=catalog.device)
            inbox.sock.settimeout(deadline_s)
            inboxes.append(inbox)
        # unordered fan-in with one puller thread per host: remote hosts
        # stream concurrently instead of draining one at a time
        sync = ops.ParallelUnorderedSyncOp(tuple(inboxes))
        final = ops.AggregateOp(sync, group_cols, aggs, mode="final",
                                input_schema=base_schema)
        out = run_operator(final)
        for inbox in inboxes:
            _note_inbox(inbox)
        return out
    except Exception:
        # first fragment failure: tear down the whole flow — no remote
        # registry entry may outlive the query it belonged to
        _cancel_everywhere(host_addrs, flow_id)
        raise
    finally:
        for inbox in inboxes:
            inbox.close()


# -- cross-host hash-repartitioned joins ------------------------------------
#
# The HashRouter-over-DCN step (colflow/routers.go:420 + colrpc): every
# host scans its shard of BOTH join sides and hash-partitions rows to P
# consumer streams; peer p joins partition p and streams the joined rows
# to the gateway. Co-partitioning makes each partition's join exact.
#
# stream-id layout under one flow_id (execinfrapb StreamEndpointSpec):
#   scatter probe h->p : 1000 + h*P + p
#   scatter build h->p : 2000 + h*P + p
#   joined partition p : 3000 + p


def _sid_scatter(side: str, h: int, p: int, n: int) -> int:
    return (1000 if side == "probe" else 2000) + h * n + p


def _sid_join(p: int) -> int:
    return 3000 + p


def plan_host_join(plan: S.HashJoin, addrs: list, flow_id: str, catalog):
    """Fragments for a hash-repartitioned cross-host join.

    Returns (scatter_frags, join_frags): scatter_frags[h] is the
    {stream_id: plan} dict to register on host h (2*P bucket streams over
    its shards); join_frags[p] is host p's join fragment — a HashJoin
    whose inputs are StreamUnions of RemoteStreams from every host."""
    from ..plan.distribute import schema_of

    n = len(addrs)
    if not isinstance(plan, S.HashJoin):
        raise TypeError("plan_host_join covers HashJoin roots")
    probe_schema = schema_of(plan.probe, catalog)
    build_schema = schema_of(plan.build, catalog)
    scatter_frags: list[dict[int, S.PlanNode]] = []
    for h in range(n):
        streams: dict[int, S.PlanNode] = {}
        probe_shard = _shard_scans(plan.probe, h, n)
        build_shard = _shard_scans(plan.build, h, n)
        for p in range(n):
            streams[_sid_scatter("probe", h, p, n)] = S.HashBucket(
                probe_shard, plan.probe_keys, n, p)
            streams[_sid_scatter("build", h, p, n)] = S.HashBucket(
                build_shard, plan.build_keys, n, p)
        scatter_frags.append(streams)
    join_frags: list[S.PlanNode] = []
    for p in range(n):
        probe_in = S.StreamUnion(tuple(
            S.RemoteStream(tuple(addrs[h]), flow_id,
                           _sid_scatter("probe", h, p, n), probe_schema)
            for h in range(n)))
        build_in = S.StreamUnion(tuple(
            S.RemoteStream(tuple(addrs[h]), flow_id,
                           _sid_scatter("build", h, p, n), build_schema)
            for h in range(n)))
        join_frags.append(S.HashJoin(probe_in, build_in, plan.probe_keys,
                                     plan.build_keys, plan.spec))
    return scatter_frags, join_frags


def run_distributed_join(plan: S.HashJoin, catalog, host_addrs: list,
                         deadline_s: float | None = None):
    """Gateway execution of a hash-repartitioned cross-host join, under
    the same deadline + cancel + degradation discipline as
    run_distributed_hosts: a transient failure cancels the flow on every
    reachable host, then the join re-plans onto the surviving hosts (the
    shard/bucket layout re-derives from the new host count) or falls
    back to local single-host execution."""
    from ..utils import log, settings

    if deadline_s is None:
        deadline_s = settings.get("sql.distsql.flow_deadline_s")
    try:
        return _run_join_once(plan, catalog, host_addrs, deadline_s)
    except Exception as e:
        if not _retryable_failure(e):
            raise
        survivors = [a for a in host_addrs if probe_host(a)]
        metric.DIST_DEGRADED.inc()
        if survivors and len(survivors) < len(host_addrs):
            log.warning(log.OPS, "distributed join degraded to survivors",
                        hosts=len(host_addrs), survivors=len(survivors),
                        error=f"{type(e).__name__}: {e}")
            return _run_join_once(plan, catalog, survivors, deadline_s)
        log.warning(log.OPS, "distributed join degraded to local execution",
                    hosts=len(host_addrs),
                    error=f"{type(e).__name__}: {e}")
        return _run_local(plan, catalog)


def _run_join_once(plan: S.HashJoin, catalog, host_addrs: list,
                   deadline_s: float):
    """Setup order matters: every scatter fragment registers before any
    join fragment's streams attach (the registry's stream-wait covers
    races). The gateway unions the P joined-partition streams."""
    from ..flow import operators as ops
    from ..plan import builder as plan_builder
    from .runtime import run_operator

    flow_id = uuid.uuid4().hex[:12]
    scatter_frags, join_frags = plan_host_join(
        plan, host_addrs, flow_id, catalog)
    inboxes: list[FlowInbox] = []
    try:
        for addr, streams in zip(host_addrs, scatter_frags):
            setup_flow(addr, flow_id, streams)
        # learn the joined schema without initializing (RemoteStream
        # attaches only at init)
        out_schema = plan_builder.build(join_frags[0],
                                        catalog).output_schema
        for p, addr in enumerate(host_addrs):
            setup_flow(addr, flow_id, {_sid_join(p): join_frags[p]})
        for p, addr in enumerate(host_addrs):
            inbox = attach_stream(addr, flow_id, _sid_join(p), out_schema,
                                  device=catalog.device)
            inbox.sock.settimeout(deadline_s)
            inboxes.append(inbox)
        sync = ops.ParallelUnorderedSyncOp(tuple(inboxes))
        out = run_operator(sync)
        for inbox in inboxes:
            _note_inbox(inbox)
        return out
    except Exception:
        _cancel_everywhere(host_addrs, flow_id)
        raise
    finally:
        for inbox in inboxes:
            inbox.close()


def _explain_degradation(n_hosts: int) -> str:
    from ..utils import settings

    return (
        f"fault policy: flow deadline "
        f"{settings.get('sql.distsql.flow_deadline_s'):g}s; on fragment "
        f"failure cancel flow on all {n_hosts} hosts, re-plan onto "
        f"survivors or run locally (distsql_degraded_queries)"
    )


def explain_host_join(plan: S.HashJoin, n_hosts: int) -> list[str]:
    """EXPLAIN (DISTSQL) lines for the repartitioned join stages."""
    out = []
    for h in range(n_hosts):
        out.append(
            f"host {h}: scan shard {h}/{n_hosts} of both sides, "
            f"hash-repartition into {n_hosts} bucket streams per side "
            f"(HashRouter over DCN)"
        )
    for p in range(n_hosts):
        out.append(
            f"host {p}: join partition {p} over {n_hosts} probe + "
            f"{n_hosts} build inbound streams"
        )
    out.append(f"gateway: union {n_hosts} joined-partition streams")
    out.append(_explain_degradation(n_hosts))
    return out


def explain_hosts(plan: S.PlanNode, n_hosts: int) -> list[str]:
    """EXPLAIN (DISTSQL) lines for the cross-host stages."""
    frags, (group_cols, aggs) = plan_host_fragments(plan, n_hosts)
    out = []
    for i, f in enumerate(frags):
        out.append(
            f"remote host {i}: partial aggregation over shard {i}/{n_hosts}"
            f" (streams via FlowStream id {i})"
        )
    out.append(
        f"gateway: final aggregation over {n_hosts} inbound streams"
    )
    out.append(_explain_degradation(n_hosts))
    return out
