"""The port's KV Batch RPC, gossip, node dialer and lease router
(cockroach_tpu_torch/kv/rpc.py, flow/gossip.py, kv/dialer.py,
kv/dist.LeaseRouter) against the reference's on the CPU: the cases of
tests/test_kv_rpc.py run through both packages over DBs on ManualClocks
from the same start (every response, timestamp and typed error equal,
the engines' versions equal afterwards); the wire is one format, so a
port client talks to a reference server and the other way round; the
replay cache dedups a re-sent stamped batch in a server of each package;
gossip converges across packages; the breaker trips and recovers; the
router reroutes to the new leaseholder after a failover without applying
any mutation twice, and an unknowable apply surfaces as
AmbiguousResultError."""

import base64
import re
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cockroach_tpu.flow import gossip as jgossip
from cockroach_tpu.kv import DB as jDB
from cockroach_tpu.kv import dialer as jdialer
from cockroach_tpu.kv import dist as jdist
from cockroach_tpu.kv import liveness as jlive
from cockroach_tpu.kv import rpc as jrpc
from cockroach_tpu.kv.hlc import ManualClock as jClock
from cockroach_tpu.storage.lsm import Engine as jEngine
from cockroach_tpu.utils import faults as jfaults
from cockroach_tpu_torch.flow import gossip as tgossip
from cockroach_tpu_torch.kv import DB as tDB
from cockroach_tpu_torch.kv import dialer as tdialer
from cockroach_tpu_torch.kv import dist as tdist
from cockroach_tpu_torch.kv import liveness as tlive
from cockroach_tpu_torch.kv import rpc as trpc
from cockroach_tpu_torch.kv.hlc import ManualClock as tClock
from cockroach_tpu_torch.storage.lsm import Engine as tEngine
from cockroach_tpu_torch.utils import faults as tfaults
from cockroach_tpu_torch.utils import metric as tmetric
from cockroach_tpu_torch.utils import retry as tretry


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


J = SimpleNamespace(
    name="reference", rpc=jrpc, gossip=jgossip, dialer=jdialer, live=jlive,
    faults=jfaults,
    db=lambda: jDB(jEngine(key_width=16, val_width=32, memtable_size=64),
                   jClock(start=1_000)))
T = SimpleNamespace(
    name="port", rpc=trpc, gossip=tgossip, dialer=tdialer, live=tlive,
    faults=tfaults,
    db=lambda: tDB(tEngine(key_width=16, val_width=32, memtable_size=64,
                           device="cpu"), tClock(start=1_000)))
FIELDS = ("key", "ts", "seq", "txn", "tomb", "value", "vlen")


def _e(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _d(s: str) -> bytes:
    return base64.b64decode(s)


class Log(list):
    def call(self, fn, *a, **kw):
        try:
            out = fn(*a, **kw)
        except Exception as e:  # noqa: BLE001 - the error is the outcome
            # txn ids come from each package's process-wide counter
            self.append(("err", type(e).__name__,
                         re.sub(r"txns \[\d+\]", "txns [id]", str(e))))
            return e
        self.append(("ok", out))
        return out


def engine_rows(db) -> dict:
    got = db.engine.export_span(None, None)
    return {f: np.asarray(got[f]).tobytes() for f in FIELDS}


# -- server and client, both packages -----------------------------------------


def roundtrip_and_typed_errors(ns, log, client_ns=None):
    """test_batch_roundtrip_and_ordering + the typed-error cases: a
    server of package `ns`, a client of `client_ns` (default the same)."""
    cns = client_ns or ns
    db = ns.db()
    srv = ns.rpc.BatchServer(db)
    try:
        c = cns.rpc.BatchClient(srv.addr)
        resp = log.call(c.batch, [
            {"op": "put", "key": _e(b"a"), "value": _e(b"1")},
            {"op": "put", "key": _e(b"b"), "value": _e(b"\x00\xff")},
            {"op": "get", "key": _e(b"a")},
        ])
        assert _d(resp[2]["value"]) == b"1"
        assert log.call(c.get, b"b") == b"\x00\xff"
        log.call(c.put, b"c", b"3")
        assert log.call(c.scan, b"a", b"z", max_keys=2) == [
            (b"a", b"1"), (b"b", b"\x00\xff")]
        ts1 = log.call(c.put, b"h", b"old")
        log.call(c.put, b"h", b"new")
        assert log.call(c.get, b"h", ts=ts1) == b"old"
        log.call(c.delete, b"a")
        assert log.call(c.get, b"a") is None
        t = db.new_txn()
        t.put(b"locked", b"x")
        err = log.call(c.get, b"locked")
        assert type(err).__name__ == "WriteIntentError"
        log.append((err.keys, [int(x) != 0 for x in err.txns]))
        t.commit()
        assert log.call(c.get, b"locked") == b"x"
        err = log.call(c.batch, [{"op": "nope"}])
        assert "unknown batch op" in str(err)
        assert log.call(c.get, b"locked") == b"x"
        c.close()
    finally:
        srv.close()
    return db


@pytest.mark.parametrize("client", ["same", "other"])
def test_batch_rpc_equals_reference(client):
    """Each package's server answers each package's client the same."""
    jlog, tlog = Log(), Log()
    jdb = roundtrip_and_typed_errors(J, jlog, T if client == "other" else J)
    tdb = roundtrip_and_typed_errors(T, tlog, J if client == "other" else T)
    assert tlog == jlog
    assert engine_rows(tdb) == engine_rows(jdb)


def test_concurrent_clients_and_close_severs_connections():
    db = T.db()
    srv = trpc.BatchServer(db)
    errs = []

    def worker(i):
        try:
            cc = trpc.BatchClient(srv.addr)
            for j in range(20):
                cc.put(b"w%d-%02d" % (i, j), b"v%d" % j)
            assert len(cc.scan(b"w%d-" % i, b"w%d~" % i)) == 20
            cc.close()
        except Exception as e:  # noqa: BLE001 - surfaced below
            errs.append(e)

    ths = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    assert not errs, errs[:2]
    c = trpc.BatchClient(srv.addr, max_retries=1)
    c.put(b"x", b"1")
    srv.close()
    with pytest.raises((ConnectionError, OSError, RuntimeError,
                        trpc.AmbiguousResultError)):
        c.put(b"y", b"2")
    assert db.get(b"y") is None


def replay_dedup(ns):
    """A response lost after apply (fault kv.rpc.server.respond, drop):
    the client re-sends the SAME (cid, seq) stamp and the server's replay
    cache answers it: the put applies once."""
    db = ns.db()
    srv = ns.rpc.BatchServer(db)
    ns.faults.arm(0, {"kv.rpc.server.respond":
                      ns.faults.FaultSpec(kind="drop", max_fires=1)})
    try:
        c = ns.rpc.BatchClient(srv.addr, deadline_s=2.0, max_retries=3)
        ts = c.put(b"once", b"v")
        ns.faults.disarm()
        got = [ts, c.get(b"once"), c.put(b"twice", b"w")]
        c.close()
    finally:
        ns.faults.disarm()
        srv.close()
    return db, got


def test_replay_cache_dedups_in_a_server_of_each_package():
    jdb, jgot = replay_dedup(J)
    tdb, tgot = replay_dedup(T)
    assert tgot == jgot
    assert engine_rows(tdb) == engine_rows(jdb)
    rows = tdb.engine.export_span(b"once", b"oncf")
    assert len(rows["ts"]) == 1  # applied exactly once


@pytest.mark.chaos
def test_ambiguous_mutation_is_typed_and_reads_stay_retryable():
    """Every retry of a stamped put fails on the wire (the server dropped
    each response after applying): the client raises AmbiguousResultError
    carrying its stamp, never a bare ConnectionError; the put is applied
    once. A read that fails the same way surfaces as a transport error."""
    db = T.db()
    srv = trpc.BatchServer(db)
    tfaults.arm(0, {"kv.rpc.server.respond": tfaults.FaultSpec(kind="drop")})
    try:
        c = trpc.BatchClient(srv.addr, deadline_s=1.0, max_retries=2)
        a0 = tmetric.AMBIGUOUS_RESULTS.value
        with pytest.raises(trpc.AmbiguousResultError) as e:
            c.put(b"amb", b"1")
        assert e.value.cid == c.cid and e.value.seq == 1
        assert tmetric.AMBIGUOUS_RESULTS.value == a0 + 1
        assert not isinstance(e.value, ConnectionError)
        with pytest.raises(ConnectionError):
            c.get(b"amb")
    finally:
        tfaults.disarm()
        srv.close()
    assert len(db.engine.export_span(b"amb", b"amc")["ts"]) == 1


def two_store_cluster(dist, db_cls, clock, tmp, **dev):
    """r1 [b"", b"m") on store 1 (no WAL), r2 [b"m", ...) on store 2 (a
    WAL, so a storage.wal.append fault lands between the two)."""
    meta = dist.Meta(first_store=1)
    kw = dict(key_width=16, val_width=32, memtable_size=64, **dev)
    ds = dist.DistSender([dist.Store(1, meta, **kw),
                          dist.Store(2, meta, wal_path=f"{tmp}/s2.wal",
                                     **kw)], meta)
    ds.split_at(b"m")
    ds.move_range(2, 2)
    return db_cls(ds, clock(start=1_000))


def versions(db, key: bytes) -> int:
    return sum(len(s.engine.export_span(key, key + b"\x01")["ts"])
               for s in db.engine.stores.values())


@pytest.mark.chaos
def test_stamped_batch_over_a_cluster_is_whole_or_ambiguous(tmp_path):
    """A stamped batch over a DistSender lands as one sub-batch per
    range. Its response dropped after both applied, the re-sent stamp is
    answered from both stores' entries, ops in request order, each
    applied once. A WAL fault after store 1's sub-batch and before store
    2's severs the stream: the re-sent stamp finds one op of two and is
    typed AmbiguousResultError, never acknowledged; store 2 holds no
    version of its key. The reference's DistSender has no dedup read, so
    its server fails every stamped batch over a cluster and applies
    nothing (ROADMAP Queue 3 item 31)."""
    db = two_store_cluster(tdist, tDB, tClock, tmp_path, device="cpu")
    srv = trpc.BatchServer(db)
    c = trpc.BatchClient(srv.addr, deadline_s=2.0, max_retries=3)
    try:
        tfaults.arm(0, {"kv.rpc.server.respond":
                        tfaults.FaultSpec(kind="drop", max_fires=1)})
        whole = c.batch([{"op": "put", "key": _e(b"a"), "value": _e(b"1")},
                         {"op": "put", "key": _e(b"z"), "value": _e(b"2")}])
        tfaults.disarm()
        assert whole[0]["ts"] < whole[1]["ts"]
        assert versions(db, b"a") == versions(db, b"z") == 1
        a0 = tmetric.AMBIGUOUS_RESULTS.value
        tfaults.arm(0, {"storage.wal.append":
                        tfaults.FaultSpec(kind="drop", max_fires=1)})
        with pytest.raises(trpc.AmbiguousResultError,
                           match="1 of its 2 ops") as e:
            c.batch([{"op": "put", "key": _e(b"b"), "value": _e(b"3")},
                     {"op": "put", "key": _e(b"y"), "value": _e(b"4")}])
        tfaults.disarm()
        assert (e.value.cid, e.value.seq) == (c.cid, 2)
        assert tmetric.AMBIGUOUS_RESULTS.value == a0 + 1
        assert versions(db, b"b") == 1 and versions(db, b"y") == 0
        assert c.get(b"y") is None and c.get(b"b") == b"3"
    finally:
        tfaults.disarm()
        c.close()
        srv.close()
    (tmp_path / "ref").mkdir()
    jdb = two_store_cluster(jdist, jDB, jClock, tmp_path / "ref")
    jsrv = jrpc.BatchServer(jdb)
    jc = jrpc.BatchClient(jsrv.addr, deadline_s=2.0, max_retries=3)
    try:
        with pytest.raises(RuntimeError, match="replay_cache_get"):
            jc.put(b"a", b"1")
    finally:
        jc.close()
        jsrv.close()
    assert versions(jdb, b"a") == 0


# -- gossip ---------------------------------------------------------------


def test_gossip_converges_across_packages():
    """Three infoStores (two port, one reference) exchange push-pull
    rounds over the one wire format until each holds the union at the
    freshest versions."""
    a, b = tgossip.Gossip(1), tgossip.Gossip(2)
    r = jgossip.Gossip(3)
    a.add_info("node/1/kv", ["127.0.0.1", 1])
    b.add_info("node/2/kv", ["127.0.0.1", 2])
    r.add_info("node/3/kv", ["127.0.0.1", 3])
    a.add_info("k", "a1")
    a.add_info("k", "a2")
    b_addr, r_addr = b.serve(), r.serve()
    try:
        for _ in range(3):
            a.exchange(b_addr)
            a.exchange(r_addr)
        for g in (a, b, r):
            assert g.keys() == ["k", "node/1/kv", "node/2/kv", "node/3/kv"]
            assert g.get_info("k") == "a2"
            assert g.get_info("node/3/kv") == ["127.0.0.1", 3]
        # a fenced origin's infos expire
        a.note_epoch(2, 5)
        assert a.get_info("node/2/kv") is None
    finally:
        b.close()
        r.close()


def test_gossip_bound_evicts_foreign_infos_first():
    g = tgossip.Gossip(1, max_infos=3)
    g._merge([tgossip.Info("f1", 1, 1, 9), tgossip.Info("f2", 2, 2, 9)])
    g.add_info("mine1", 1)
    g.add_info("mine2", 2)
    assert g.keys() == ["f2", "mine1", "mine2"]


# -- dialer and breaker -------------------------------------------------------


def test_node_dialer_resolves_through_gossip_and_redials_after_restart():
    g = tgossip.Gossip(1)
    db = T.db()
    srv = trpc.BatchServer(db)
    tdialer.advertise(g, 2, srv.addr)
    d = tdialer.NodeDialer(g)
    try:
        c = d.dial(2)
        c.put(b"from1", b"hello2")
        assert db.get(b"from1") == b"hello2"
        assert d.dial(2) is c
        srv2 = trpc.BatchServer(db)
        srv.close()
        tdialer.advertise(g, 2, srv2.addr)
        c2 = d.dial(2)
        assert c2 is not c
        c2.put(b"after", b"restart")
        assert db.get(b"after") == b"restart"
        srv2.close()
        with pytest.raises(KeyError, match="no gossiped address"):
            d.dial(5)
    finally:
        d.close()


def test_circuit_breaker_trips_fastfails_and_recovers():
    g = tgossip.Gossip(99)
    db = T.db()
    srv = trpc.BatchServer(db)
    tdialer.advertise(g, 7, srv.addr)
    d = tdialer.NodeDialer(g, trip_threshold=2, cooldown_s=0.4)
    c = d.dial(7)
    c.put(b"cb", b"1")
    d.report_ok(7)
    srv.close()
    d.forget(7)
    for _ in range(2):
        with pytest.raises((ConnectionError, OSError, RuntimeError,
                            trpc.AmbiguousResultError)):
            d.dial(7).put(b"x", b"y")
        d.report_failure(7)
    assert d.breaker_open(7)
    with pytest.raises(tdialer.BreakerOpenError):
        d.dial(7)
    assert tretry.is_retryable(tdialer.BreakerOpenError("x"))
    srv2 = trpc.BatchServer(db)
    tdialer.advertise(g, 7, srv2.addr)
    time.sleep(0.45)
    d.dial(7).put(b"cb2", b"2")
    d.report_ok(7)
    assert not d.breaker_open(7)
    assert db.get(b"cb2") == b"2"
    srv2.close()
    d.close()


# -- the lease router: reroute after a failover -------------------------------


def lease_guard(lm):
    """The node's BatchServer guard: range-addressed batches must be
    served by the range's current leaseholder under its current epoch."""
    def check(req):
        rid = req.get("range")
        if rid is not None:
            lm.check(int(rid))
    return check


def test_lease_router_reroutes_after_failover_without_double_apply():
    """Two nodes serve one DB, node 1 holding r1's lease. The router
    sends range-addressed puts to node 1 (resolved through gossip's
    lease/1). Node 1's server closes: the put in flight surfaces as
    AmbiguousResultError with its stamp (never re-sent silently). A read
    through the router then retries past the dead node while node 1's
    liveness expires, node 2 fences it and takes the lease and gossip
    names node 2: the read reroutes there within the router's budget and
    shows the ambiguous put did not apply; it is re-sent once. Every
    acknowledged put was applied exactly once, and node 2 refused
    batches while it did not hold the lease (NotLeaseHolderError)."""
    db = T.db()
    nl1 = tlive.NodeLiveness(db, 1, ttl_ms=500)
    nl2 = tlive.NodeLiveness(db, 2, ttl_ms=500)
    nl1.heartbeat()
    nl2.heartbeat()
    lm1, lm2 = tlive.LeaseManager(nl1), tlive.LeaseManager(nl2)
    rec = lm1.acquire(1)
    s1 = trpc.BatchServer(db, lease_check=lease_guard(lm1))
    s2 = trpc.BatchServer(db, lease_check=lease_guard(lm2))
    g1, g2 = tgossip.Gossip(1), tgossip.Gossip(2)
    g2_addr = g2.serve()
    tdialer.advertise(g1, 1, s1.addr)
    tdialer.advertise(g2, 2, s2.addr)
    g1.add_info("lease/1", f"{rec.node_id}:{rec.epoch}")
    g1.exchange(g2_addr)
    dialer = tdialer.NodeDialer(g1, trip_threshold=2, cooldown_s=5.0)
    router = tdist.LeaseRouter(g1, dialer, resolve_timeout_s=5.0)

    def put(k, v):
        return router.batch(1, [{"op": "put", "key": _e(k),
                                 "value": _e(v)}])

    try:
        for i in range(20):
            put(b"r%03d" % i, b"v%d" % i)
        assert router.leaseholder(1) == 1
        with pytest.raises(tlive.NotLeaseHolderError):
            dialer.dial(2).batch([{"op": "put", "key": _e(b"no"),
                                   "value": _e(b"x")}], range_id=1)
        s1.close()
        t0 = time.perf_counter()
        with pytest.raises(trpc.AmbiguousResultError) as amb:
            put(b"r998", b"maybe")
        assert amb.value.seq is not None
        done = {}

        def read():
            done["out"] = router.batch(1, [{"op": "get",
                                            "key": _e(b"r998")}])
            done["ms"] = (time.perf_counter() - t0) * 1e3

        th = threading.Thread(target=read)
        th.start()
        db.clock.advance(1_000)  # node 1 stopped heartbeating: expired
        nl2.heartbeat()
        rec2 = lm2.acquire(1)  # fences node 1 (epoch bump), takes r1
        assert rec2.node_id == 2
        g2.add_info("lease/1", f"{rec2.node_id}:{rec2.epoch}")
        g1.exchange(g2_addr)  # gossip carries the new holder
        th.join(timeout=10)
        assert "out" in done and router.leaseholder(1) == 2
        assert done["out"] == [{"value": None}]  # the put never applied
        assert done["ms"] < 5_000
        put(b"r998", b"resent")
        put(b"r999", b"after")
        with pytest.raises(tlive.NotLeaseHolderError) as nlh:
            lm1.check(1)  # node 1 may no longer serve r1
        assert nlh.value.holder == 2
        with pytest.raises(tlive.EpochFencedError):
            nl1.heartbeat()  # fenced: its epoch was bumped while dark
        for i in list(range(20)) + [998, 999]:
            k = b"r%03d" % i
            assert len(db.engine.export_span(k, k + b"\x01")["ts"]) == 1
        assert db.get(b"r998") == b"resent"
    finally:
        dialer.close()
        s1.close()
        s2.close()
        g1.close()
        g2.close()


def test_lease_router_budget_exhaustion_is_typed():
    g = tgossip.Gossip(1)
    dialer = tdialer.NodeDialer(g)
    router = tdist.LeaseRouter(
        g, dialer, budget=tretry.RangeRetryBudget(budget=2,
                                                  refill_per_s=0.0),
        resolve_timeout_s=5.0)
    with pytest.raises(tretry.RetryBudgetExhausted) as e:
        router.batch(4, [{"op": "get", "key": _e(b"k")}])
    assert e.value.range_id == 4
    assert tmetric.RPC_RETRIES_BY_RANGE.value(4) >= 2


def test_retry_backoff_and_classification():
    import random

    from cockroach_tpu.utils import retry as jretry

    for mod in (jretry, tretry):
        b = mod.Backoff(max_attempts=3, initial_s=0.0, rng=random.Random(1))
        assert list(b.attempts()) == [0, 1, 2]
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("drop")
        return "ok"

    assert tretry.call(flaky, tretry.Backoff(max_attempts=4,
                                             initial_s=0.0)) == "ok"
    for e in (TimeoutError(), ConnectionError(), OSError(),
              tretry.RPCDeadlineError("x"), ValueError("hard")):
        assert tretry.is_retryable(e) == jretry.is_retryable(e)
    with pytest.raises(ValueError):
        tretry.call(lambda: (_ for _ in ()).throw(ValueError("hard")))
