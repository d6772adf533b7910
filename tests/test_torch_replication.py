"""The port's physical replication, timeseries store and upgrade
migrations (cockroach_tpu_torch/kv/replication.py, kv/tsdb.py,
kv/upgrade.py) against the reference's on the CPU. A port
ReplicationStream follows a port RangefeedServer and, over the same raw
frames, a reference one: after cutover each standby holds its source's
committed versions, historical reads on them equal the source's at the
same timestamps, and the two standbys agree but for timestamps. A stream from a DistSender cluster (the port's) lands in a
single-engine standby equal at the frontier. The timeseries store and
the migrations leave the reference's engine versions and answers."""

import time

import numpy as np
import pytest
import torch

from cockroach_tpu.kv import DB as jDB
from cockroach_tpu.kv.changefeed import RangefeedServer as jRangefeedServer
from cockroach_tpu.kv.hlc import ManualClock as jClock
from cockroach_tpu.kv import tsdb as jtsdb
from cockroach_tpu.kv import upgrade as jupgrade
from cockroach_tpu.storage.lsm import Engine as jEngine
from cockroach_tpu.utils import metric as jmetric
from cockroach_tpu_torch.kv.dist import make_cluster, spread
from cockroach_tpu_torch.kv import DB
from cockroach_tpu_torch.kv import tsdb as ttsdb
from cockroach_tpu_torch.kv import upgrade as tupgrade
from cockroach_tpu_torch.kv.changefeed import RangefeedServer
from cockroach_tpu_torch.kv.hlc import ManualClock
from cockroach_tpu_torch.kv.replication import ReplicationStream
from cockroach_tpu_torch.storage.lsm import Engine
from cockroach_tpu_torch.utils import faults, metric

FIELDS = ("key", "ts", "tomb", "value", "vlen")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def tdb(start=1_000, key_width=16):
    return DB(Engine(key_width=key_width, val_width=32, memtable_size=64,
                     device="cpu"), ManualClock(start=start))


def jdb(start=1_000, key_width=16):
    return jDB(jEngine(key_width=key_width, val_width=32, memtable_size=64),
               jClock(start=start))


def versions(db) -> list:
    """Every version in the engine as (key, ts, tomb, value, vlen), in
    key order: what replication carries (sequence numbers are the
    standby's own)."""
    got = db.engine.export_span(None, None)
    if not got:
        return []
    cols = [np.asarray(got[f]) for f in FIELDS]
    return sorted(tuple(c[i].tobytes() for c in cols)
                  for i in range(len(cols[0])))


def source_writes(db) -> dict:
    """The reference test's writes: history, a non-UTF-8 value, a
    tombstone; returns the timestamps to read at."""
    return {"ts1": db.put(b"ra", b"v1"), "ts2": db.put(b"ra", b"v2"),
            "ts3": db.put(b"rb", b"\x00\xff bytes ok"),
            "ts4": db.delete(b"rc_pre")}


def follow(server, src, dst) -> tuple[ReplicationStream, dict]:
    marks = source_writes(src)
    repl = ReplicationStream(server.addr, dst, start=b"r",
                             end=b"s").run_background()
    marks["late"] = src.put(b"rd", b"late")
    assert repl.wait_for_frontier(marks["late"]), repl.frontier
    t = src.new_txn()
    t.put(b"re", b"pending")
    src.put(b"rf", b"after-intent")
    time.sleep(0.1)
    assert dst.get(b"re") is None  # an intent never replicates
    t.commit()
    marks["post"] = src.put(b"rg", b"post-commit")
    assert repl.wait_for_frontier(marks["post"])
    return repl, marks


def test_port_stream_from_port_and_reference_servers_equal():
    """The same writes on a port source and a reference source; a port
    stream from each server. After cutover each standby holds exactly its
    source's committed versions in the span (keys, timestamps,
    tombstones, values), every historical read equals the source's at
    that timestamp, and the two standbys hold the same versions but for
    the timestamps (the servers' pollers read the clocks in between)."""
    out = []
    for make_src, make_srv in (
            (tdb, lambda db: RangefeedServer(db, poll_interval_s=0.02,
                                             device="cpu")),
            (jdb, lambda db: jRangefeedServer(db, poll_interval_s=0.02))):
        src, dst = make_src(), tdb(start=1)
        srv = make_srv(src)
        try:
            repl, marks = follow(srv, src, dst)
            frontier = repl.cutover()
            src.put(b"rz", b"too-late")
            time.sleep(0.1)
            assert dst.get(b"rz") is None
            assert frontier >= marks["post"]
            for name, ts in marks.items():
                got = dst.scan(b"r", b"s", ts=ts)
                assert got == src.scan(b"r", b"s", ts=ts), name
            assert dst.get(b"ra", ts=marks["ts1"]) == b"v1"
            assert dst.get(b"re") == b"pending"
            committed = [v for v in versions(src)
                         if b"r" <= v[0] < b"s" and v[0] != b"rz".ljust(16, b"\x00")]
            assert versions(dst) == committed
            out.append([(k, tomb, val, vl) for k, _, tomb, val, vl
                        in versions(dst)])
        finally:
            srv.close()
    assert out[0] == out[1]


def test_stream_from_a_distsender_cluster_into_one_engine():
    """The chip phase's shape at a small size: a 3-store cluster source,
    the stream over its first keys plus inserts made while it runs, a
    single-engine standby; scans of the standby at the frontier equal the
    cluster's at the same timestamp."""
    ds = make_cluster(3, device="cpu", key_width=16, val_width=16,
                      memtable_size=64)
    spread(ds, [b"user000000000100", b"user000000000200"])
    src = DB(ds, ManualClock(start=1_000))
    for i in range(300):
        src.put(b"user%012d" % i, b"v%06d" % i)
    dst = DB(Engine(key_width=16, val_width=16, device="cpu"),
             ManualClock(start=1))
    srv = RangefeedServer(src, poll_interval_s=0.02, device="cpu")
    try:
        repl = ReplicationStream(srv.addr, dst, start=b"user",
                                 end=b"user000000000250").run_background()
        for i in range(300, 310):
            src.put(b"user%012d" % (i - 300 + 120), b"w%06d" % i)
        mark = src.put(b"user000000000249", b"last")
        assert repl.wait_for_frontier(mark)
        frontier = repl.cutover()
        assert repl.applied >= 250
        lo, hi = b"user", b"user000000000250"
        assert dst.scan(lo, hi, ts=frontier) == src.scan(lo, hi, ts=frontier)
        assert dst.scan(lo, hi, ts=frontier - 5) == src.scan(
            lo, hi, ts=frontier - 5)
    finally:
        srv.close()


@pytest.mark.chaos
def test_stream_reconnects_from_frontier_after_source_restart():
    src, dst = tdb(), tdb(start=1)
    srv = RangefeedServer(src, poll_interval_s=0.02, device="cpu")
    addr = srv.addr
    srv2 = None
    r0 = metric.REPLICATION_RECONNECTS.value
    repl = ReplicationStream(srv.addr, dst, start=b"r",
                             end=b"s").run_background()
    try:
        mark = src.put(b"ra", b"pre-crash")
        assert repl.wait_for_frontier(mark)
        faults.arm(61, {"kv.rangefeed.subscribe": faults.FaultSpec(
            kind="error", p=1.0, max_fires=1)})
        srv.close()
        srv2 = RangefeedServer(src, poll_interval_s=0.02, port=addr[1],
                               device="cpu")
        mark2 = src.put(b"rb", b"post-restart")
        assert repl.wait_for_frontier(mark2), (repl.frontier, mark2)
        faults.disarm()
        assert repl.reconnects >= 1
        assert metric.REPLICATION_RECONNECTS.value > r0
        assert dst.get(b"ra") == b"pre-crash"
        assert dst.get(b"rb") == b"post-restart"
        assert repl.cutover() >= mark2
    finally:
        faults.disarm()
        try:
            repl.cutover()
        except RuntimeError:
            pass
        if srv2 is not None:
            srv2.close()
        srv.close()


# -- tsdb and upgrade -----------------------------------------------------


def registry(mod):
    reg = mod.Registry()
    reg.counter("ops").inc(3)
    reg.gauge("depth").set(7.5)
    h = reg.add(mod.Histogram("lat", buckets=(0.1, 1.0))) \
        if hasattr(reg, "add") else reg.histogram("lat", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    lc = reg.add(mod.LabeledCounter("shed", "tenant")) \
        if hasattr(reg, "add") else reg.labeled_counter("shed", "tenant")
    lc.inc("a", 2)
    return reg


def tsdb_scenario(tsmod, db, reg):
    ts = tsmod.TimeSeriesDB(db)
    out = [ts.record(reg)]
    for step in range(3):
        db.clock.advance(1_000)
        reg._metrics["ops"].inc(1)
        out.append(ts.record(reg, names=["ops", "depth"]))
    out += [ts.query("ops"), ts.query("lat_count"), ts.query("shed.a"),
            ts.downsample("ops", 2_000, "avg"),
            ts.downsample("ops", 2_000, "max"),
            ts.prune("ops", 2_500), ts.query("ops"), ts.prune_all(3_500),
            ts.query("depth")]
    return out


def test_tsdb_records_and_queries_like_the_reference():
    # the timeseries keys (\x01ts<name>|<13 digits>) need a wide store
    j, t = jdb(start=1_000, key_width=96), tdb(start=1_000, key_width=96)
    jout = tsdb_scenario(jtsdb, j, registry(jmetric))
    tout = tsdb_scenario(ttsdb, t, registry(metric))
    assert tout == jout
    assert versions(t) == versions(j)


def test_tsdb_records_the_default_registry():
    db = tdb(key_width=96)
    ts = ttsdb.TimeSeriesDB(db)
    metric.QUERIES.inc()
    n = ts.record(metric.DEFAULT)
    assert n >= len(metric.DEFAULT._metrics)
    got = ts.query("sql_queries")
    assert len(got) == 1 and got[0][1] == metric.QUERIES.value


def upgrade_scenario(mod, db):
    ran: list[str] = []
    migs = [mod.Migration((4, 0), "add-a", lambda d: (ran.append("a"),
                                                      d.put(b"\x01mig-a", b"1"))),
            mod.Migration((4, 1), "add-b", lambda d: (ran.append("b"),
                                                      d.put(b"\x01mig-b", b"1")))]
    out = [mod.active_version(db), mod.run_upgrades(db, migrations=migs),
           mod.active_version(db)]
    legacy = db.__class__(db.engine.__class__(
        key_width=16, val_width=32,
        **({"device": "cpu"} if mod is tupgrade else {})),
        db.clock.__class__(start=5_000))
    legacy.put(b"user-row", b"x")
    out += [mod.run_upgrades(legacy, to_version=(4, 1), migrations=migs),
            mod.run_upgrades(legacy, to_version=(4, 1), migrations=migs),
            mod.active_version(legacy), mod.is_active(legacy, (4, 1)),
            mod.is_active(legacy, (4, 2)), ran]
    return out, legacy


def test_run_upgrades_is_idempotent_like_the_reference():
    jout, jleg = upgrade_scenario(jupgrade, jdb())
    tout, tleg = upgrade_scenario(tupgrade, tdb())
    assert tout == jout
    assert tout[3] == ["add-a", "add-b"] and tout[4] == []
    assert versions(tleg) == versions(jleg)
    assert tupgrade.BINARY_VERSION == jupgrade.BINARY_VERSION
