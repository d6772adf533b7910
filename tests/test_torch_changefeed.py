"""The port's changefeed and fan-out plane (cockroach_tpu_torch/kv/
changefeed.py, kv/fanout.py, flow/dcn.py) against the reference's on the
CPU: the catch-up scan and ``changes_between`` over the same seeded
writes (span bounds, tombstones, an open intent holding the frontier),
the changefeed job's exactly-once resume, ``RangefeedServer`` frames;
then the port's ladder rungs, reconnect from the frontier, the
subscriber limit, the dead-socket reap, the four changefeed fault sites
and the ``crdb_internal`` table. Torch runs on one thread."""

import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

from scripts.check_no_leaks import assert_no_leaks, snapshot

from cockroach_tpu.kv import DB as jDB
from cockroach_tpu.kv import ManualClock as jClock
from cockroach_tpu.kv import changefeed as jcf
from cockroach_tpu.kv.jobs import Registry as jRegistry
from cockroach_tpu.storage.lsm import Engine as jEngine
from cockroach_tpu_torch.flow import memory as flowmem
from cockroach_tpu_torch.kv import DB as tDB
from cockroach_tpu_torch.kv import ManualClock as tClock
from cockroach_tpu_torch.kv import changefeed as tcf
from cockroach_tpu_torch.kv import fanout
from cockroach_tpu_torch.kv.jobs import Registry as tRegistry
from cockroach_tpu_torch.sql import Session
from cockroach_tpu_torch.storage.lsm import Engine as tEngine
from cockroach_tpu_torch.utils import faults, settings
from cockroach_tpu_torch.utils.errors import SlowConsumerError
from cockroach_tpu_torch.utils.faults import FaultSpec, InjectedFault


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
    faults.disarm()


def _tdb():
    return tDB(tEngine(key_width=16, val_width=64, memtable_size=64,
                       device="cpu"), tClock())


def _jdb():
    return jDB(jEngine(key_width=16, val_width=64, memtable_size=64),
               jClock())


def _seeded_writes(db, seed: int = 7, steps: int = 160) -> None:
    """The same seeded puts and deletes in either package: 40 keys, some
    written several times, a tombstone every fourth step."""
    rng = np.random.default_rng(seed)
    for step in range(steps):
        k = b"k%03d" % int(rng.integers(0, 40))
        v = b"v%04d" % step
        if int(rng.integers(0, 4)) == 0:
            db.txn(lambda t, k=k: t.delete(k))
        else:
            db.txn(lambda t, k=k, v=v: t.put(k, v))


@pytest.fixture(scope="module")
def twin_dbs():
    """Both packages' databases after the same writes, each with one open
    intent on k010 (a transaction that has not committed)."""
    j, t = _jdb(), _tdb()
    for db in (j, t):
        _seeded_writes(db)
        db.new_txn().put(b"k010", b"open")
    return j, t


@pytest.mark.parametrize("lo,span", [
    (0, (None, None)), (60, (b"k01", b"k03")), (0, (b"k02", None)),
    (120, (None, b"k009"))])
def test_scan_and_changes_between_match_reference(twin_dbs, lo, span):
    j, t = twin_dbs
    hi = 1 << 40  # past every write of either clock
    want = jcf._scan(j, lo, hi, *span)
    got = tcf._scan(t, lo, hi, *span)
    assert got == want
    want_ev = jcf.changes_between(j, lo, hi, *span)
    got_ev = tcf.changes_between(t, lo, hi, *span)
    assert got_ev == want_ev
    # the open intent on k010 holds the frontier below its timestamp
    # wherever the span holds k010
    holds = (span[0] is None or span[0] <= b"k010") and (
        span[1] is None or b"k010" < span[1])
    assert (got_ev[1] < hi) == holds


def test_scan_copies_once_per_poll(twin_dbs):
    """The selection crosses to the host in one copy; a selection past
    the learned capacity copies once more and grows the capacity."""
    _j, t = twin_dbs
    tcf._caps.pop(t.engine, None)
    s0 = tcf.scan_stats()
    tcf._scan(t, 1, t.clock.now())
    s1 = tcf.scan_stats()
    assert (s1["scans"] - s0["scans"], s1["copies"] - s0["copies"]) == (1, 1)
    tcf._caps[t.engine][(None, None)] = 4
    tcf._scan(t, 1, t.clock.now())
    s2 = tcf.scan_stats()
    assert s2["copies"] - s1["copies"] == 2
    assert tcf._caps[t.engine][(None, None)] >= s2["rows"] - s1["rows"]
    # a narrow span keeps a capacity of its own
    tcf._scan(t, 1, t.clock.now(), b"k00", b"k01")
    assert tcf._caps[t.engine][(b"k00", b"k01")] == tcf._MIN_CAP
    # a replay from 0 leaves the learned capacity as it was
    tcf._caps[t.engine][(None, None)] = 4
    tcf._scan(t, 0, t.clock.now())
    assert tcf._caps[t.engine][(None, None)] == 4


def test_changefeed_job_resumes_exactly_once(tmp_path):
    """The reference's job test through both packages: each version once
    across a resume, deletes as null, the same sink lines."""
    lines = {}
    for name, db, reg_cls, cf in (
            ("jax", _jdb(), jRegistry, jcf), ("torch", _tdb(), tRegistry,
                                             tcf)):
        reg = reg_cls(db)
        cf.register_changefeed_job(reg)
        sink = str(tmp_path / f"{name}.ndjson")
        db.txn(lambda t: [t.put(b"u001", b"alice"), t.put(b"u002", b"bob")])
        job = reg.create("changefeed", {"sink": sink, "start": "u",
                                        "end": "v", "polls": 1})
        reg.adopt_and_resume(job.job_id)
        db.txn(lambda t: (t.put(b"u001", b"alice2"), t.delete(b"u002")))
        jb = reg.load(job.job_id)
        jb.state = "pending"
        reg.checkpoint(jb)
        reg.adopt_and_resume(job.job_id)
        lines[name] = [json.loads(x) for x in open(sink).read().splitlines()]
    assert lines["torch"] == lines["jax"]
    assert [(e["key"], e["value"]) for e in lines["torch"]] == [
        ("u001", "alice"), ("u002", "bob"), ("u001", "alice2"),
        ("u002", None)]


def test_frontier_checkpoint_fault_fails_job_then_resumes(tmp_path):
    """A failed checkpoint write (changefeed.frontier.checkpoint) fails
    the job with its events emitted and the error recorded, as in the
    reference; re-adopted, it goes on from the recorded frontier: the
    sink holds every version exactly once, line for line the
    reference's."""
    from cockroach_tpu.utils import faults as jfaults
    from cockroach_tpu.utils.faults import FaultSpec as jFaultSpec

    out = {}
    for name, db, reg_cls, cf, fl, spec in (
            ("jax", _jdb(), jRegistry, jcf, jfaults, jFaultSpec),
            ("torch", _tdb(), tRegistry, tcf, faults, FaultSpec)):
        reg = reg_cls(db)
        cf.register_changefeed_job(reg)
        sink = str(tmp_path / f"{name}.ndjson")
        db.txn(lambda t: [t.put(b"u001", b"a"), t.put(b"u002", b"b")])
        job = reg.create("changefeed", {"sink": sink, "start": "u",
                                        "end": "v", "polls": 1})
        fl.arm(1, {"changefeed.frontier.checkpoint":
                   spec(kind="error", max_fires=1)})
        try:
            failed = reg.adopt_and_resume(job.job_id)
        except ConnectionError as e:  # InjectedFault of either package
            failed = e
        finally:
            fl.disarm()
        jb = reg.load(job.job_id)
        state = (jb.state, "changefeed.frontier.checkpoint" in jb.error)
        db.txn(lambda t: (t.put(b"u003", b"c"), t.delete(b"u001")))
        jb.state = "pending"
        reg.checkpoint(jb)
        reg.adopt_and_resume(job.job_id)
        seen = [json.loads(x) for x in open(sink).read().splitlines()]
        want, _ = cf.changes_between(db, 0, db.clock.now(), b"u", b"v")
        out[name] = (type(failed).__name__, state, seen, want)
    assert out["torch"][:3] == out["jax"][:3]
    assert out["torch"][1] == ("failed", True)
    seen, want = out["torch"][2], out["torch"][3]
    assert seen == want  # each version once, none skipped


def _drain(sock, frames, until_resolved, deadline_s=15):
    """Event frames deduplicated by (ts, key) until the resolved frontier
    reaches `until_resolved`, an error frame arrives, or the stream ends:
    (events, resolved, error frame, events counted with repeats)."""
    sock.settimeout(deadline_s)
    events, resolved, n = {}, 0, 0
    deadline = time.time() + deadline_s
    for f in frames:
        if "error" in f:
            return events, resolved, f, n
        if "resolved" in f:
            resolved = max(resolved, f["resolved"])
            if resolved >= until_resolved:
                break
        else:
            events[(f["ts"], f["key"])] = f["value"]
            n += 1
        if time.time() > deadline:
            break
    return events, resolved, None, n


def _oracle(db, cf, start=None, end=None):
    events, _ = cf.changes_between(db, 0, db.clock.now(), start, end)
    return {(e["ts"], e["key"]): e["value"] for e in events}


def test_rangefeed_frames_equal_reference_events():
    """Three subscribers (two spans and the whole keyspace) on each
    package's server over the same writes: every stream, deduplicated,
    equals the reference's event list for its span."""
    dbs = {"jax": _jdb(), "torch": _tdb()}
    got = {}
    for name, db in dbs.items():
        db.txn(lambda t: (t.put(b"a1", b"v1"), t.put(b"b1", b"v2")))
        srv = (jcf.RangefeedServer(db, poll_interval_s=0.02)
               if name == "jax" else
               tcf.RangefeedServer(db, poll_interval_s=0.02, device="cpu"))
        cf = jcf if name == "jax" else tcf
        try:
            subs = [cf.subscribe_rangefeed(srv.addr, start=b"a", end=b"b"),
                    cf.subscribe_rangefeed(srv.addr, start=b"b", end=b"c"),
                    cf.subscribe_rangefeed(srv.addr)]
            db.txn(lambda t: (t.put(b"a2", b"v3"), t.delete(b"b1")))
            hi = db.clock.now()
            got[name] = [_drain(s, fr, hi)[:3] for s, fr in subs]
            for s, _fr in subs:
                s.close()
        finally:
            srv.close()
    spans = [(b"a", b"b"), (b"b", b"c"), (None, None)]
    for (events, resolved, err), (lo, hi_k) in zip(got["torch"], spans):
        assert err is None
        assert events == _oracle(dbs["jax"], jcf, lo, hi_k)
    assert [g[0] for g in got["torch"]] == [g[0] for g in got["jax"]]


def test_entry_points_default_to_the_card():
    """``device`` defaults to "cuda": without a card the server and the
    hub raise; with one, a CPU engine does not match it."""
    db = _tdb()
    tcf.check_device(db, "cpu")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="engine on cpu"):
            tcf.RangefeedServer(db)
    else:
        for make in (tcf.RangefeedServer, fanout.FanoutHub):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make(db)


def test_reconnect_from_frontier_exactly_once():
    """Kill the client mid-stream, reconnect with since=<last
    checkpoint>: the union of both connections equals the full history,
    and nothing at or below the checkpoint streams again."""
    db = _tdb()
    for i in range(5):
        db.txn(lambda t, i=i: t.put(b"k%d" % i, b"v%d" % i))
    srv = tcf.RangefeedServer(db, poll_interval_s=0.02, device="cpu")
    try:
        mid = db.clock.now()
        sock, frames = tcf.subscribe_rangefeed(srv.addr)
        first, ckpt, err, _ = _drain(sock, frames, mid)
        assert err is None and ckpt >= mid
        sock.close()  # torn: no goodbye
        for i in range(5, 10):
            db.txn(lambda t, i=i: t.put(b"k%d" % i, b"v%d" % i))
        hi = db.clock.now()
        sock2, frames2 = tcf.subscribe_rangefeed(srv.addr, since=ckpt)
        second, ckpt2, err2, _ = _drain(sock2, frames2, hi)
        sock2.close()
        assert err2 is None and ckpt2 >= hi
        merged = dict(first)
        merged.update(second)
        assert merged == _oracle(db, tcf)
        assert all(ts > ckpt for ts, _k in second)
    finally:
        srv.close()


def test_subscriber_send_fault_evicts_typed_then_resumes():
    """A send that dies mid-stream (changefeed.subscriber.send) evicts
    the subscriber with a typed frame naming its frontier; reconnecting
    from that frontier delivers every later version exactly once."""
    db = _tdb()
    for i in range(4):
        db.txn(lambda t, i=i: t.put(b"s%d" % i, b"v%d" % i))
    srv = tcf.RangefeedServer(db, poll_interval_s=0.02, device="cpu")
    try:
        sock, frames = tcf.subscribe_rangefeed(srv.addr)
        first, ckpt, err, _ = _drain(sock, frames, db.clock.now())
        assert err is None
        faults.arm(3, {"changefeed.subscriber.send":
                       FaultSpec(kind="drop", max_fires=1)})
        db.txn(lambda t: t.put(b"s9", b"late"))
        _ev, _r, err, _ = _drain(sock, frames, db.clock.now() + 10**12,
                                 deadline_s=10)
        faults.disarm()
        sock.close()
        assert err is not None and err["error"] == "slow_consumer"
        assert "send failed" in err["reason"]
        assert err["frontier"] == ckpt
        hi = db.clock.now()
        sock2, frames2 = tcf.subscribe_rangefeed(srv.addr,
                                                 since=err["frontier"])
        second, _r2, err2, n2 = _drain(sock2, frames2, hi)
        sock2.close()
        assert err2 is None
        assert n2 == len(second), "a version streamed twice"
        merged = dict(first)
        merged.update(second)
        assert merged == _oracle(db, tcf)
    finally:
        srv.close()
    assert flowmem.staging_monitor("changefeed").used == 0


def test_subscribe_fault_is_retried():
    db = _tdb()
    srv = tcf.RangefeedServer(db, poll_interval_s=0.02, device="cpu")
    try:
        faults.arm(5, {"kv.rangefeed.subscribe":
                       FaultSpec(kind="error", max_fires=1)})
        with pytest.raises(InjectedFault):
            tcf.subscribe_rangefeed(srv.addr)
        sock, frames = tcf.subscribe_rangefeed(srv.addr)
        sock.settimeout(10)
        assert "resolved" in next(frames)
        sock.close()
    finally:
        srv.close()


# -- the backpressure ladder -------------------------------------------------


def _ladder_hub(db):
    """A hub with an undrained registration (no sender thread) forced
    LIVE, its poller parked: the test drives every rung."""
    hub = fanout.FanoutHub(db, poll_interval_s=3600, device="cpu")
    a, b = socket.socketpair()
    sub = hub.add_subscriber(a, start_sender=False)
    with hub._mu:
        sub.state = fanout.LIVE
    return hub, sub, a, b


def _batch(n_keys, nbytes, versions=1):
    out = []
    ts = 1
    for _v in range(versions):
        for i in range(n_keys):
            out.append((ts, b"lad%04d" % i, b"x" * nbytes, nbytes,
                        time.monotonic()))
            ts += 1
    return out


@pytest.fixture
def ladder_knobs():
    names = ("changefeed.fanout.buffer_bytes",
             "changefeed.fanout.highwater_frac",
             "changefeed.fanout.max_consecutive_sheds")
    settings.set("changefeed.fanout.buffer_bytes", 4096)
    settings.set("changefeed.fanout.highwater_frac", 0.1)
    yield
    for n in names:
        settings.reset(n)


def test_ladder_rung_one_coalesces(ladder_knobs):
    hub, sub, a, b = _ladder_hub(_tdb())
    try:
        with hub._mu:
            hub._enqueue_locked(sub, _batch(2, 100, versions=3))
        assert sub.state == fanout.LIVE
        assert sub.coalesced == 4 and len(sub.buf) == 2
        assert sub.queued_bytes == 200 and sub.mon.used == 200
        assert sorted(e[0] for e in sub.buf) == [5, 6]
    finally:
        hub.close()
        a.close()
        b.close()


def test_ladder_rung_two_sheds(ladder_knobs):
    hub, sub, a, b = _ladder_hub(_tdb())
    try:
        with hub._mu:
            hub._enqueue_locked(sub, _batch(60, 100))
        assert sub.state == fanout.CATCHUP
        assert sub.sheds == 1 and sub.sheds_run == 1
        assert sub.buf == [] and sub.queued_bytes == 0 and sub.mon.used == 0
    finally:
        hub.close()
        a.close()
        b.close()


def test_ladder_terminal_rung_typed_eviction(ladder_knobs):
    settings.set("changefeed.fanout.max_consecutive_sheds", 2)
    hub, sub, a, b = _ladder_hub(_tdb())
    try:
        for _ in range(2):
            with hub._mu:
                hub._enqueue_locked(sub, _batch(60, 100))
                sub.state = fanout.LIVE  # as if the rescan completed
        with hub._mu:
            hub._enqueue_locked(sub, _batch(60, 100))
        assert sub.state == fanout.EVICTED
        err = sub.evict_error
        assert isinstance(err, SlowConsumerError)
        assert err.subscriber_id == sub.id and err.frontier == sub.frontier
        assert "shed" in err.reason and sub.mon.used == 0
    finally:
        hub.close()
        a.close()
        b.close()
    assert flowmem.staging_monitor("changefeed").used == 0


def test_enqueue_fault_sheds_without_gap():
    """changefeed.fanout.enqueue: the batch never reaches the buffer, the
    subscriber sheds to a catch-up scan, and the stream still equals the
    full history."""
    db = _tdb()
    db.txn(lambda t: t.put(b"e1", b"v1"))
    srv = tcf.RangefeedServer(db, poll_interval_s=0.02, device="cpu")
    try:
        sock, frames = tcf.subscribe_rangefeed(srv.addr)
        _drain(sock, frames, db.clock.now())
        sheds0 = sum(s.sheds for s in srv.hub._subs.values())
        faults.arm(4, {"changefeed.fanout.enqueue":
                       FaultSpec(kind="error", max_fires=1)})
        db.txn(lambda t: (t.put(b"e2", b"v2"), t.put(b"e3", b"v3")))
        hi = db.clock.now()
        events, resolved, err, _ = _drain(sock, frames, hi)
        faults.disarm()
        sock.close()
        assert err is None and resolved >= hi
        assert sum(s.sheds for s in srv.hub._subs.values()) == sheds0 + 1
        assert (max(events), events[max(events)]) == (
            max(_oracle(db, tcf)), "v3")
    finally:
        srv.close()


def test_eviction_never_blocks_peers():
    db = _tdb()
    db.txn(lambda t: t.put(b"p1", b"v1"))
    srv = tcf.RangefeedServer(db, poll_interval_s=0.02, device="cpu")
    try:
        sock, frames = tcf.subscribe_rangefeed(srv.addr)
        x, y = socket.socketpair()
        doomed = srv.hub.add_subscriber(x, start_sender=False)
        with srv.hub._mu:
            srv.hub._evict_locked(doomed, "test: forced eviction")
        assert doomed.state == fanout.EVICTED
        db.txn(lambda t: t.put(b"p2", b"v2"))
        hi = db.clock.now()
        events, resolved, err, _ = _drain(sock, frames, hi)
        sock.close()
        assert err is None and resolved >= hi
        assert events == _oracle(db, tcf)
        x.close()
        y.close()
    finally:
        srv.close()


def test_dead_socket_reaped_and_census_clean():
    """A client that vanishes without a goodbye is reaped within
    heartbeat + deadline; after close the threads, sockets and the
    staging account are back where they started."""
    settings.set("changefeed.fanout.heartbeat_s", 0.05)
    settings.set("changefeed.fanout.send_deadline_s", 1.0)
    before = snapshot()
    db = _tdb()
    db.txn(lambda t: t.put(b"d1", b"v1"))
    srv = tcf.RangefeedServer(db, poll_interval_s=0.02, device="cpu")
    try:
        sock, frames = tcf.subscribe_rangefeed(srv.addr)
        sock.settimeout(10)
        assert next(frames) is not None
        sock.close()
        deadline = time.time() + 10
        while time.time() < deadline:
            with srv.hub._mu:
                if not srv.hub._subs:
                    break
            time.sleep(0.02)
        with srv.hub._mu:
            assert not srv.hub._subs, "dead subscriber not reaped"
    finally:
        srv.close()
        settings.reset("changefeed.fanout.heartbeat_s")
        settings.reset("changefeed.fanout.send_deadline_s")
    assert flowmem.staging_monitor("changefeed").used == 0
    assert_no_leaks(before)


def test_subscriber_limit_typed_refusal():
    db = _tdb()
    db.txn(lambda t: t.put(b"l1", b"v1"))
    settings.set("changefeed.fanout.max_subscribers", 1)
    srv = tcf.RangefeedServer(db, poll_interval_s=0.02, device="cpu")
    try:
        sock1, frames1 = tcf.subscribe_rangefeed(srv.addr)
        sock1.settimeout(10)
        assert next(frames1) is not None
        sock2, frames2 = tcf.subscribe_rangefeed(srv.addr)
        sock2.settimeout(10)
        assert next(frames2) == {"error": "subscriber_limit"}
        assert next(frames2, None) is None
        sock2.close()
        hi = db.clock.now()
        _events, resolved, err, _ = _drain(sock1, frames1, hi)
        assert err is None and resolved >= hi
        sock1.close()
    finally:
        srv.close()
        settings.reset("changefeed.fanout.max_subscribers")


def test_subscribers_table_and_silent_server():
    """crdb_internal.node_changefeed_subscribers through a Session; and
    a server that never answers ends the feed within the io deadline."""
    db = _tdb()
    db.txn(lambda t: t.put(b"s1", b"v1"))
    srv = tcf.RangefeedServer(db, poll_interval_s=0.02, device="cpu")
    try:
        sock, frames = tcf.subscribe_rangefeed(srv.addr, start=b"s",
                                               end=b"t")
        assert sock.gettimeout() == settings.get("flow.dcn.io_timeout_s")
        hi = db.clock.now()
        _e, resolved, err, _ = _drain(sock, frames, hi)
        assert err is None and resolved >= hi
        sess = Session(device="cpu")
        got = sess.execute(
            "select hub, state, span_start, span_end, frontier, "
            "sent_events from crdb_internal.node_changefeed_subscribers")
        mine = [i for i, h in enumerate(got["hub"]) if h == srv.hub.name]
        assert len(mine) == 1
        i = mine[0]
        assert (got["state"][i], got["span_start"][i],
                got["span_end"][i]) == ("live", "s", "t")
        assert got["frontier"][i] >= hi and got["sent_events"][i] >= 1
        sock.close()
        sess.close()
    finally:
        srv.close()
    assert srv.hub not in fanout.hubs()
    settings.set("flow.dcn.io_timeout_s", 0.3)
    lsn = socket.create_server(("127.0.0.1", 0))
    try:
        sock, frames = tcf.subscribe_rangefeed(lsn.getsockname())
        t0 = time.time()
        assert list(frames) == []
        assert time.time() - t0 < 5.0
        sock.close()
    finally:
        settings.reset("flow.dcn.io_timeout_s")
        lsn.close()


def test_local_subscriber_peek_ack_and_poller_thread():
    """An in-process registration fed by the hub's own poll thread: the
    buffered delta equals the scan, survives a peek, and an ack consumes
    exactly what it names."""
    db = _tdb()
    db.txn(lambda t: t.put(b"m1", b"v1"))
    hub = fanout.FanoutHub(db, poll_interval_s=0.01, device="cpu")
    try:
        sub = hub.add_local(start=b"m", end=b"n")
        sub.ack(0)
        db.txn(lambda t: (t.put(b"m2", b"v2"), t.delete(b"m1")))
        hi = db.clock.now()
        deadline = time.time() + 10
        while time.time() < deadline:
            events, resolved, _ = sub.peek()
            if events is not None and resolved >= hi:
                break
            time.sleep(0.01)
        assert resolved >= hi
        want, _ = tcf._scan(db, 0, hi, b"m", b"n")
        assert events == want
        assert sub.peek()[0] == events  # peek consumes nothing
        sub.ack(events[0][0])
        assert sub.peek()[0] == events[1:]
        assert [t.name for t in threading.enumerate()].count(
            "fanout-poller") >= 1
        sub.close()
    finally:
        hub.close()
    assert flowmem.staging_monitor("changefeed").used == 0


def test_long_values_resolve_from_the_heap():
    """A value longer than the engine's inline slot lives in its value
    heap. The port's feed reads it from there; the reference's emits the
    slot itself (its heap offset, zero padded): a reference fault kept
    out of the port."""
    v = b"x" * 40
    got = {}
    for name, db, cf in (
            ("jax", jDB(jEngine(key_width=16, val_width=16), jClock()), jcf),
            ("torch", tDB(tEngine(key_width=16, val_width=16, device="cpu"),
                          tClock()), tcf)):
        db.txn(lambda t: t.put(b"big", v))
        assert db.get(b"big") == v
        got[name] = cf.changes_between(db, 0, 1 << 40)[0]
    assert [e["value"] for e in got["torch"]] == [v.decode()]
    assert got["jax"][0]["value"] != v.decode()
    assert [(e["key"], e["ts"]) for e in got["torch"]] == [
        (e["key"], e["ts"]) for e in got["jax"]]
