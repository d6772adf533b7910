"""The port's KV distribution (cockroach_tpu_torch/kv/dist.py: Meta,
RangeCache, Store, DistSender, open_cluster_checkpoint) against the
reference's on the CPU: the cases of tests/test_dist_kv.py, each run
through both packages on ManualClocks from the same start. Every result
and every error (type and text) is equal, and so is every version each
store's engine holds afterwards (``export_span``, field by field)."""

import dataclasses
import re
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cockroach_tpu.kv import DB as jDB
from cockroach_tpu.kv import dist as jdist
from cockroach_tpu.kv import liveness as jlive
from cockroach_tpu.kv.hlc import ManualClock as jClock
from cockroach_tpu.sql.session import Session as jSession
from cockroach_tpu.storage import rowcodec as jrowcodec
from cockroach_tpu.storage.lsm import Engine as jEngine
from cockroach_tpu_torch.kv import DB as tDB
from cockroach_tpu_torch.kv import dist as tdist
from cockroach_tpu_torch.kv import liveness as tlive
from cockroach_tpu_torch.kv.hlc import ManualClock as tClock
from cockroach_tpu_torch.sql.session import Session as tSession
from cockroach_tpu_torch.storage import rowcodec as trowcodec
from cockroach_tpu_torch.storage.lsm import Engine as tEngine
from cockroach_tpu_torch.utils import racesan


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


J = SimpleNamespace(name="reference", dist=jdist, DB=jDB, Clock=jClock,
                    Engine=jEngine, live=jlive, rowcodec=jrowcodec,
                    session=lambda db: jSession(db=db), dev={})
T = SimpleNamespace(name="port", dist=tdist, DB=tDB, Clock=tClock,
                    Engine=tEngine, live=tlive, rowcodec=trowcodec,
                    session=lambda db: tSession(db=db, device="cpu"),
                    dev={"device": "cpu"})

FIELDS = ("key", "ts", "seq", "txn", "tomb", "value", "vlen")


class Log(list):
    """The scenario's transcript: each call's result or error."""

    def call(self, fn, *a, **kw):
        try:
            out = fn(*a, **kw)
        except Exception as e:  # noqa: BLE001 - the error is the outcome
            # txn ids come from each package's process-wide counter
            self.append(("err", type(e).__name__,
                         re.sub(r"txns \[\d+\]", "txns [id]", str(e))))
            return e
        self.append(("ok", _plain(out)))
        return out


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, np.ndarray):
        return v.tolist()
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        # the two packages' records never compare equal as objects
        return (type(v).__name__, _plain(dataclasses.asdict(v)))
    return v


def mk(ns, n_stores=2, **kw):
    meta = ns.dist.Meta(first_store=1)
    kw.setdefault("key_width", 16)
    kw.setdefault("val_width", 16)
    kw.setdefault("memtable_size", 64)
    stores = [ns.dist.Store(i + 1, meta, **kw, **ns.dev)
              for i in range(n_stores)]
    return meta, stores, ns.dist.DistSender(stores, meta)


def db_of(ns, ds):
    return ns.DB(ds, ns.Clock(start=1_000))


def store_rows(eng) -> dict:
    got = eng.export_span(None, None)
    return {f: np.asarray(got[f]).tobytes() for f in FIELDS} if got else {}


def stores_equal(jstores, tstores):
    assert len(jstores) == len(tstores)
    for js, ts in zip(jstores, tstores):
        assert js.store_id == ts.store_id
        assert store_rows(ts.engine) == store_rows(js.engine), ts.store_id


def descs(meta):
    return [_plain(d) for d in meta.snapshot()]


# -- the cases of tests/test_dist_kv.py -----------------------------------


def split_routes_and_cross_range_scan(ns, log):
    meta, stores, ds = mk(ns)
    db = db_of(ns, ds)
    for i in range(40):
        db.put(b"k%04d" % i, b"v%04d" % i)
    ds.split_at(b"k0020")
    right = meta.lookup(b"k0020")
    log.call(ds.move_range, right.range_id, to_store=2)
    log.call(db.get, b"k0005")
    log.call(db.get, b"k0030")
    now = db.clock.now()
    assert stores[1].engine.scan(b"k", b"l", ts=now)
    assert not stores[0].engine.scan(b"k0020", b"l", ts=now)
    rows = log.call(db.scan, b"k0010", b"k0030")
    assert [k for k, _ in rows] == [b"k%04d" % i for i in range(10, 30)]
    rows = log.call(db.scan, b"k0015", None, max_keys=10)
    assert [k for k, _ in rows] == [b"k%04d" % i for i in range(15, 25)]
    log.append(descs(meta))
    return stores


def stale_cache_detected_and_refreshed(ns, log):
    meta, stores, ds = mk(ns)
    db = db_of(ns, ds)
    for i in range(20):
        db.put(b"k%04d" % i, b"old%d" % i)
    db.get(b"k0010")
    cached = ds.cache.lookup(b"k0010")
    other = ns.dist.DistSender(list(ds.stores.values()), meta)
    other.split_at(b"k0010")
    right = meta.lookup(b"k0010")
    other.move_range(right.range_id, to_store=2)
    err = log.call(ds.stores[cached.store_id].check, cached, b"k0015", None)
    assert isinstance(err, ns.dist.RangeKeyMismatchError)
    ev0 = ds.cache.evictions
    assert log.call(db.get, b"k0015") == b"old15"
    log.append(ds.cache.evictions - ev0)
    assert ds.cache.evictions > ev0
    return stores


def txn_atomic_across_ranges(ns, log):
    meta, stores, ds = mk(ns)
    db = db_of(ns, ds)
    ds.split_at(b"m")
    ds.move_range(meta.lookup(b"m").range_id, to_store=2)

    def op(t):
        t.put(b"a1", b"left")
        t.put(b"z1", b"right")

    log.call(db.txn, op)
    log.call(db.get, b"a1")
    log.call(db.get, b"z1")

    def bad(t):
        t.put(b"a2", b"x")
        t.put(b"z2", b"y")
        raise KeyError("boom")

    assert isinstance(log.call(db.txn, bad), KeyError)
    assert log.call(db.get, b"a2") is None
    assert log.call(db.get, b"z2") is None
    for s in stores:
        assert not s.engine._locks
    return stores


def move_range_preserves_history_and_intents(ns, log):
    meta, stores, ds = mk(ns)
    db = db_of(ns, ds)
    ts1 = db.put(b"h1", b"v1")
    db.put(b"h1", b"v2")
    db.delete(b"h2")
    db.put(b"h2", b"v3")
    t = db.new_txn()
    t.put(b"h3", b"pending")
    ds.split_at(b"h")
    ds.split_at(b"i")
    mid = meta.lookup(b"h")
    assert log.call(ds.move_range, mid.range_id, to_store=2) >= 4
    assert log.call(db.get, b"h1", ts=ts1) == b"v1"
    log.call(db.get, b"h1")
    log.call(db.get, b"h2")
    assert type(log.call(db.get, b"h3")).__name__ == "WriteIntentError"
    log.call(t.commit)
    assert log.call(db.get, b"h3") == b"pending"
    return stores


def scan_batch_groups_by_store(ns, log):
    meta, stores, ds = mk(ns)
    db = db_of(ns, ds)
    for i in range(64):
        db.put(b"k%04d" % i, b"v%04d" % i)
    ds.split_at(b"k0032")
    ds.move_range(meta.lookup(b"k0032").range_id, to_store=2)
    starts = [b"k0000", b"k0030", b"k0040", b"k0010"]
    got = log.call(ds.scan_batch, starts, ts=db.clock.now(), max_keys=8)
    for s, rows in zip(starts, got):
        lo = int(s[1:5])
        want = [b"k%04d" % i for i in range(lo, min(lo + 8, 64))]
        assert [k for k, _ in rows] == want, (s, rows[:3])
    assert got[1][0][0] == b"k0030" and got[1][-1][0] == b"k0037"
    return stores


def move_range_durable_across_crash(ns, log, tmp_path):
    meta = ns.dist.Meta(first_store=1)
    kw = dict(key_width=16, val_width=16, memtable_size=64, **ns.dev)
    d = tmp_path / ns.name
    d.mkdir()
    stores = [ns.dist.Store(1, meta, wal_path=str(d / "s1.wal"), **kw),
              ns.dist.Store(2, meta, wal_path=str(d / "s2.wal"), **kw)]
    ds = ns.dist.DistSender(stores, meta)
    db = db_of(ns, ds)
    for i in range(30):
        db.put(b"d%04d" % i, b"v%04d" % i)
    ds.split_at(b"d0015")
    log.call(ds.move_range, meta.lookup(b"d0015").range_id, to_store=2)
    now = db.clock.now()
    stores[0].engine.close()
    stores[1].engine.close()
    e1 = ns.Engine(wal_path=str(d / "s1.wal"), **kw)
    e2 = ns.Engine(wal_path=str(d / "s2.wal"), **kw)
    got2 = log.call(e2.scan, b"d0015", b"e", ts=now)
    assert [k for k, _ in got2] == [b"d%04d" % i for i in range(15, 30)]
    assert not log.call(e1.scan, b"d0015", b"e", ts=now)
    got1 = log.call(e1.scan, b"d0000", b"d0015", ts=now)
    assert [k for k, _ in got1] == [b"d%04d" % i for i in range(15)]
    return [SimpleNamespace(store_id=1, engine=e1),
            SimpleNamespace(store_id=2, engine=e2)]


def _sql_cluster(ns):
    meta = ns.dist.Meta(first_store=1)
    kw = dict(key_width=16, val_width=128, memtable_size=256, **ns.dev)
    stores = [ns.dist.Store(1, meta, **kw), ns.dist.Store(2, meta, **kw)]
    ds = ns.dist.DistSender(stores, meta)
    return meta, stores, ds, ns.session(db_of(ns, ds))


def _result(res) -> dict:
    return {k: np.asarray(v).tolist() for k, v in res.items()}


def sql_over_multi_range_keyspace(ns, log):
    meta, stores, ds, sess = _sql_cluster(ns)
    sess.execute("create table kvt (id int primary key, g int, x int)")
    sess.execute("insert into kvt values " + ", ".join(
        f"({i}, {i % 5}, {i * 3})" for i in range(200)))
    t = sess.catalog.get("kvt")
    start, end = ns.rowcodec.table_span(t.table_id)
    all_keys = [k for k, _ in ds.scan(start, end, ts=sess.db.clock.now())]
    assert len(all_keys) >= 200
    ds.split_at(all_keys[100])
    ds.move_range(meta.snapshot()[-1].range_id, to_store=2)
    now = sess.db.clock.now()
    assert stores[0].engine.scan(start, None, ts=now, max_keys=1)
    assert stores[1].engine.scan(start, None, ts=now, max_keys=1)
    res = sess.execute("select count(*) as n, sum(x) as sx from kvt")
    assert int(res["n"][0]) == 200
    assert int(res["sx"][0]) == sum(i * 3 for i in range(200))
    log.append(_result(res))
    sess.execute("update kvt set x = -1 where id = 10")
    sess.execute("update kvt set x = -2 where id = 150")
    res = sess.execute("select x from kvt where id in (10, 150) order by x")
    assert list(res["x"]) == [-2, -1]
    log.append(_result(res))
    res = sess.execute(
        "select g, count(*) as c from kvt group by g order by g")
    assert list(res["c"]) == [40] * 5
    log.append(_result(res))
    log.append(descs(meta))
    return stores


def kvnemesis_with_splits_and_moves(ns, log):
    meta, stores, ds = mk(ns, n_stores=3, memtable_size=32)
    db = db_of(ns, ds)
    rng = np.random.default_rng(23)
    model: dict[bytes, bytes] = {}

    def key(i: int) -> bytes:
        return b"q%05d" % i

    for step in range(120):
        kind = rng.random()
        if kind < 0.08:
            ds.split_at(key(int(rng.integers(1, 300))))
            continue
        if kind < 0.16 and len(meta.snapshot()) > 1:
            ds_ = meta.snapshot()
            d = ds_[int(rng.integers(len(ds_)))]
            log.call(ds.move_range, d.range_id, int(rng.integers(1, 4)))
            continue
        if kind < 0.55:
            k1 = key(int(rng.integers(0, 150)))
            k2 = key(int(rng.integers(0, 150)))

            def op(t, k1=k1, k2=k2):
                a = int(t.get(k1) or b"0")
                b = int(t.get(k2) or b"0")
                t.put(k1, str(a + 1).encode())
                if k2 != k1:
                    t.put(k2, str(b + 2).encode())

            db.txn(op)
            a = int(model.get(k1, b"0"))
            b = int(model.get(k2, b"0"))
            model[k1] = str(a + 1).encode()
            if k2 != k1:
                model[k2] = str(b + 2).encode()
        elif kind < 0.7:
            k = key(int(rng.integers(150, 300)))
            v = b"s%04d" % step
            db.put(k, v)
            model[k] = v
        elif kind < 0.8:
            k = key(int(rng.integers(150, 300)))
            db.delete(k)
            model.pop(k, None)
        elif kind < 0.9:
            for _ in range(4):
                k = key(int(rng.integers(0, 300)))
                assert log.call(db.get, k) == model.get(k), (step, k)
        else:
            lo = int(rng.integers(0, 280))
            hi = lo + int(rng.integers(1, 40))
            got = log.call(db.scan, key(lo), key(hi), max_keys=16)
            want = sorted((k, v) for k, v in model.items()
                          if key(lo) <= k < key(hi))[:16]
            assert got == want, (step, lo, hi)
    assert dict(log.call(db.scan, key(0), key(99999))) == model
    assert len(meta.snapshot()) > 3
    assert len({d.store_id for d in meta.snapshot()}) > 1
    log.append(descs(meta))
    return stores


def show_ranges_through_sql(ns, log):
    meta, stores, ds, sess = _sql_cluster(ns)
    sess.execute("create table rr (id int primary key)")
    sess.execute("insert into rr values (1), (2)")
    ds.split_at(b"\x05")
    ds.move_range(meta.lookup(b"\x05").range_id, 2)
    res = sess.execute("show ranges")
    assert list(res["range_id"]) == [1, 2]
    assert list(res["store_id"]) == [1, 2]
    log.append(_result(res))
    hot = sess.execute("select range_id, start_key, end_key, store_id "
                       "from crdb_internal.hot_ranges")
    assert list(hot["range_id"]) == [1, 2]
    log.append(_result(hot))
    return stores


def lease_guard_stamps_every_piece_across_autosplit(ns, log):
    meta, stores, ds = mk(ns)
    db = db_of(ns, ds)
    nl = ns.live.NodeLiveness(db, 1, ttl_ms=600_000)
    nl.heartbeat()
    lm = ns.live.LeaseManager(nl)
    lm.acquire(1)
    checked = []
    local = threading.local()

    def guard(rid):
        if getattr(local, "busy", False):
            return
        local.busy = True
        try:
            checked.append(rid)
            rec = lm.holder(rid)
            if rec is not None and rec.node_id == 1:
                lm.check(rid)
        finally:
            local.busy = False

    ds.lease_check = guard
    for i in range(20):
        db.put(b"u%04d" % i, b"v%d" % i)
    left, right = meta.split_at(b"u0010")
    assert log.call(lm.carry, left.range_id, right.range_id) is not None
    assert (lm.holder(right.range_id).epoch
            == lm.holder(left.range_id).epoch)
    ds.move_range(right.range_id, to_store=2)
    checked.clear()
    rows = log.call(db.scan, b"u0005", b"u0015")
    assert [k for k, _ in rows] == [b"u%04d" % i for i in range(5, 15)]
    assert {left.range_id, right.range_id} <= set(checked)
    raw = db.get(ns.live.NodeLiveness._key(1))
    epoch, exp, nid = ns.live._REC.unpack(raw)
    db.put(ns.live.NodeLiveness._key(1), ns.live._REC.pack(epoch + 1, exp,
                                                           nid))
    for fn, a in ((db.put, (b"u0002", b"stale")),
                  (db.put, (b"u0012", b"stale")),
                  (db.scan, (b"u0005", b"u0015"))):
        err = log.call(fn, *a)
        assert type(err).__name__ == "EpochFencedError"
    return stores


SCENARIOS = (
    split_routes_and_cross_range_scan,
    stale_cache_detected_and_refreshed,
    txn_atomic_across_ranges,
    move_range_preserves_history_and_intents,
    scan_batch_groups_by_store,
    sql_over_multi_range_keyspace,
    kvnemesis_with_splits_and_moves,
    show_ranges_through_sql,
    lease_guard_stamps_every_piece_across_autosplit,
)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_dist_scenario_equals_reference(scenario):
    jlog, tlog = Log(), Log()
    jstores = scenario(J, jlog)
    tstores = scenario(T, tlog)
    assert tlog == jlog
    stores_equal(jstores, tstores)


def test_move_range_durable_across_crash_equals_reference(tmp_path):
    jlog, tlog = Log(), Log()
    jstores = move_range_durable_across_crash(J, jlog, tmp_path)
    tstores = move_range_durable_across_crash(T, tlog, tmp_path)
    assert tlog == jlog
    stores_equal(jstores, tstores)


@pytest.mark.parametrize("ns", [J, T], ids=lambda ns: ns.name)
def test_range_cache_single_flight_coalesces_meta_lookups(ns):
    """Concurrent misses for one key make ONE meta lookup in both
    packages; followers park on the leader's event."""
    meta = ns.dist.Meta(first_store=1)

    class SlowMeta:
        def __init__(self, inner):
            self.inner = inner
            self.lookups = 0

        def lookup(self, key):
            self.lookups += 1
            time.sleep(0.05)
            return self.inner.lookup(key)

    slow = SlowMeta(meta)
    cache = ns.dist.RangeCache(slow)
    got, errs = [], []
    start = threading.Barrier(8)

    def worker():
        try:
            start.wait()
            got.append(cache.lookup(b"sf-key"))
        except Exception as e:  # pragma: no cover - surfaced below
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert len(got) == 8 and len({d.range_id for d in got}) == 1
    assert slow.lookups == 1
    assert cache.coalesced >= 7
    cache.lookup(b"sf-key")
    assert slow.lookups == 1


def test_routed_ingest_matches_reference_per_store():
    """DistSender.ingest routes one bulk batch by range with one
    searchsorted: each store holds exactly the reference's versions."""
    out = []
    for ns in (J, T):
        meta, stores, ds = mk(ns, n_stores=3, memtable_size=4096)
        ds.split_at(b"user000000000100")
        ds.split_at(b"user000000000200")
        for i, d in enumerate(meta.snapshot()):
            ds.move_range(d.range_id, i + 1)
        idx = np.arange(300)
        keys = np.zeros((300, 16), np.uint8)
        for r, i in enumerate(idx):
            keys[r] = np.frombuffer(b"user%012d" % i, np.uint8)
        vals = np.zeros((300, 16), np.uint8)
        vals[:, 0] = ord("v")
        vals[:, 1:9] = keys[:, 7:15]
        ds.ingest(keys, vals, ts=5)
        got = ds.scan_batch([b"user000000000090", b"user000000000195",
                             b"user000000000290"], ts=6, max_keys=16)
        assert [len(r) for r in got] == [16, 16, 10]
        assert got[0][10][0] == b"user000000000100"
        out.append((stores, got))
    assert out[1][1] == out[0][1]
    stores_equal(out[0][0], out[1][0])
    assert all(store_rows(s.engine) for s in out[1][0])


def test_open_cluster_checkpoint_of_a_reference_cluster(tmp_path):
    """A reference cluster's ``checkpoint`` opens into a port cluster
    (open_cluster_checkpoint with the reference's Meta snapshot as plain
    tuples): every scan and every store's versions equal."""
    meta, stores, ds = mk(J, n_stores=3)
    db = db_of(J, ds)
    for i in range(90):
        db.put(b"c%04d" % i, b"w%04d" % i)
    db.delete(b"c0007")
    ds.split_at(b"c0030")
    ds.split_at(b"c0060")
    for i, d in enumerate(meta.snapshot()):
        ds.move_range(d.range_id, i + 1)
    now = db.clock.now()
    ds.checkpoint(str(tmp_path / "ckpt"))
    tup = [(d.range_id, d.start_key, d.end_key, d.store_id, d.generation)
           for d in meta.snapshot()]
    port = tdist.open_cluster_checkpoint(str(tmp_path / "ckpt"), tup,
                                         device="cpu")
    assert [(d.range_id, d.start_key, d.end_key, d.store_id, d.generation)
            for d in port.meta.snapshot()] == tup
    assert str(port.device) == "cpu"
    assert port.scan(None, None, ts=now) == ds.scan(None, None, ts=now)
    starts = [b"c0000", b"c0025", b"c0058", b"c0089"]
    assert port.scan_batch(starts, ts=now, max_keys=8) == \
        ds.scan_batch(starts, ts=now, max_keys=8)
    stores_equal(sorted(ds.stores.values(), key=lambda s: s.store_id),
                 sorted(port.stores.values(), key=lambda s: s.store_id))
    with pytest.raises(ValueError, match="tile the keyspace"):
        tdist.open_cluster_checkpoint(str(tmp_path / "ckpt"), tup[1:],
                                      device="cpu")


def test_stores_on_two_devices_have_no_device():
    meta = tdist.Meta()
    ds = tdist.DistSender([tdist.Store(1, meta, device="cpu")], meta)
    assert str(ds.device) == "cpu"
    ds.stores[2] = SimpleNamespace(engine=SimpleNamespace(device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        ds.device


def test_sql_and_move_range_concurrently_keep_the_lock_order():
    """SQL statements and move_range run at the same time over one port
    cluster under the race sanitizer: no thread takes the DistSender's
    lock (kv.distsender) while it holds an engine mutex (storage.engine),
    so the order dispatch.exec_lock -> kv.distsender -> storage.engine
    holds; nothing deadlocks or reports a race, and every read sees all
    120 rows."""
    from cockroach_tpu_torch.utils import locks as tlocks
    from cockroach_tpu_torch.utils import settings as tsettings

    inverted = []

    class OrderChecked(tlocks.NamedRLock):
        def __enter__(self):
            held = tlocks._held_stack()
            if "storage.engine" in held:
                inverted.append(held)
            return super().__enter__()

    tsettings.set("debug.race_detector.enabled", True)
    racesan.reset()
    try:
        meta, stores, ds, sess = _sql_cluster(T)
        ds.mu = OrderChecked("kv.distsender")
        sess.execute("create table lk (id int primary key, x int)")
        sess.execute("insert into lk values " + ", ".join(
            f"({i}, {i})" for i in range(120)))
        t = sess.catalog.get("lk")
        start, _ = T.rowcodec.table_span(t.table_id)
        keys = [k for k, _ in ds.scan(start, None, ts=sess.db.clock.now())]
        for k in keys[30::30]:
            ds.split_at(k)
        errs = []

        def mover():
            try:
                for r in range(6):
                    for d in meta.snapshot():
                        ds.move_range(d.range_id, 1 + (d.range_id + r) % 2)
            except Exception as e:  # noqa: BLE001 - surfaced below
                errs.append(e)

        th = threading.Thread(target=mover)
        th.start()
        counts = []
        while th.is_alive() or len(counts) < 3:
            res = sess.execute("select count(*) as n, sum(x) as s from lk")
            counts.append((int(res["n"][0]), int(res["s"][0])))
        th.join(timeout=60)
        assert not errs, errs
        assert set(counts) == {(120, sum(range(120)))}
        assert racesan.armed() and not inverted, inverted[:1]
    finally:
        tsettings.reset("debug.race_detector.enabled")
        racesan.reset()


def test_ycsb_e_over_three_stores_equals_one_engine():
    """bench/ycsb.run_ycsb_e with stores=3 (the keyspace in thirds, one a
    store, the load through DistSender.ingest, the scans through
    DistSender.scan_batch) scans the same rows as the single engine under
    the same seed (itself held to the reference in test_torch_engine.py);
    every scan, and one across each range boundary, equals the host
    model (a mismatch raises inside the run)."""
    from cockroach_tpu_torch.bench.ycsb import run_ycsb_e

    kw = dict(n_keys=3000, ops=96, seed=0, ingest_chunk=1024,
              concurrency=32, device="cpu")
    one = run_ycsb_e(**kw)
    three = run_ycsb_e(stores=3, **kw)
    for k in ("rows_scanned", "point_ops", "ops"):
        assert three[k] == one[k], k
    assert three["scans_checked"] == one["scans_checked"] + 2
    assert three["scans_crossing_a_range"] >= 2
    assert [r[1] for r in three["ranges"]] == [1, 2, 3]
    # the loaded keys, the warm-up insert and the run's inserts
    inserts = 96 - one["scans_checked"]
    assert inserts > 0
    assert sum(r[2] for r in three["ranges"]) == 3000 + 1 + inserts
