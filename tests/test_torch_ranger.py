"""The port's range lifecycle (cockroach_tpu_torch/kv/loadstats.py,
queues.py, allocator.py) against the reference's on the CPU: the cases of
tests/test_ranger.py, each run through both packages with the same
manual clocks and reservoir seeds. Both packages compute the same rates,
split at the same keys, queue and park the same items, and end with the
same descriptors, leaseholders, hot-ranges payload (the reference's
RangeLifecycle.hot_ranges and ``crdb_internal.hot_ranges`` through each
package's Session) and per-store engine versions."""

import dataclasses
import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cockroach_tpu.kv import DB as jDB
from cockroach_tpu.kv import allocator as jalloc
from cockroach_tpu.kv import dist as jdist
from cockroach_tpu.kv import liveness as jlive
from cockroach_tpu.kv import loadstats as jload
from cockroach_tpu.kv import queues as jqueues
from cockroach_tpu.kv.hlc import ManualClock as jClock
from cockroach_tpu.sql.session import Session as jSession
from cockroach_tpu.utils import metric as jmetric
from cockroach_tpu.utils import settings as jsettings
from cockroach_tpu_torch.kv import DB as tDB
from cockroach_tpu_torch.kv import allocator as talloc
from cockroach_tpu_torch.kv import dist as tdist
from cockroach_tpu_torch.kv import liveness as tlive
from cockroach_tpu_torch.kv import loadstats as tload
from cockroach_tpu_torch.kv import queues as tqueues
from cockroach_tpu_torch.kv.hlc import ManualClock as tClock
from cockroach_tpu_torch.sql.session import Session as tSession
from cockroach_tpu_torch.utils import metric as tmetric
from cockroach_tpu_torch.utils import settings as tsettings


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


J = SimpleNamespace(name="reference", dist=jdist, DB=jDB, Clock=jClock,
                    live=jlive, load=jload, queues=jqueues, alloc=jalloc,
                    metric=jmetric, settings=jsettings,
                    session=lambda db: jSession(db=db),
                    single=lambda: jSession(), dev={})
T = SimpleNamespace(name="port", dist=tdist, DB=tDB, Clock=tClock,
                    live=tlive, load=tload, queues=tqueues, alloc=talloc,
                    metric=tmetric, settings=tsettings,
                    session=lambda db: tSession(db=db, device="cpu"),
                    single=lambda: tSession(device="cpu"),
                    dev={"device": "cpu"})
BOTH = (J, T)
LIFECYCLE_SETTINGS = ("kv.range.split_qps_threshold", "kv.range.max_bytes",
                      "kv.range.merge_enabled", "kv.allocator.enabled")
FIELDS = ("key", "ts", "seq", "txn", "tomb", "value", "vlen")


@pytest.fixture(autouse=True)
def reset_settings():
    yield
    for ns in BOTH:
        for name in LIFECYCLE_SETTINGS:
            ns.settings.reset(name)


class ManualTime:
    """Injectable monotonic clock stepped by the test."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def mk(ns, n_stores=2):
    meta = ns.dist.Meta(first_store=1)
    stores = [ns.dist.Store(i + 1, meta, key_width=16, val_width=16,
                            memtable_size=64, **ns.dev)
              for i in range(n_stores)]
    return meta, stores, ns.dist.DistSender(stores, meta)


def plain(v):
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__, plain(dataclasses.asdict(v)))
    return v


def store_rows(eng) -> dict:
    got = eng.export_span(None, None)
    return {f: np.asarray(got[f]).tobytes() for f in FIELDS} if got else {}


# -- load stats -------------------------------------------------------------


def decaying_counter_half_life(ns):
    clk = ManualTime()
    c = ns.load.DecayingCounter(half_life_s=10.0, clock=clk)
    for _ in range(100):
        c.record()
    r0 = c.rate()
    clk.advance(10.0)
    r1 = c.rate()
    assert r1 == pytest.approx(r0 / 2.0, rel=1e-6)
    clk.advance(200.0)
    r2 = c.rate()
    assert r2 < r0 / 1000.0
    return [r0, r1, r2]


def reservoir_split_key_is_interior_median(ns):
    clk = ManualTime()
    ls = ns.load.RangeLoadStats(half_life_s=30.0, sample_size=16, seed=1,
                                clock=clk)
    for i in range(100):
        ls.record_write(1, b"k%03d" % i, 16)
    key = ls.split_key(1, b"", None)
    assert b"k020" < key < b"k080"
    ls2 = ns.load.RangeLoadStats(sample_size=8, seed=1, clock=clk)
    for _ in range(50):
        ls2.record_read(7, b"hot")
    out = [key, ls.split_key(1, b"k099", None), ls2.split_key(7, b"hot", None),
           ls2.split_key(9, b"", None), list(ls._ranges[1].samples)]
    assert out[1:4] == [None, None, None]
    return out


def note_split_partitions_samples_and_halves_rates(ns):
    clk = ManualTime()
    ls = ns.load.RangeLoadStats(half_life_s=30.0, sample_size=32, seed=2,
                                clock=clk)
    for i in range(32):
        ls.record_write(1, b"k%03d" % i, 8)
    q_before, w_before = ls.qps(1), ls.write_bytes_rate(1)
    ls.note_split(1, 2, b"k016")
    assert ls.qps(1) == pytest.approx(q_before / 2, rel=1e-6)
    assert ls.qps(2) == pytest.approx(q_before / 2, rel=1e-6)
    assert ls.write_bytes_rate(2) == pytest.approx(w_before / 2, rel=1e-6)
    assert all(k < b"k016" for k in ls._ranges[1].samples)
    assert all(k >= b"k016" for k in ls._ranges[2].samples)
    out = [q_before, w_before, ls.report(), list(ls._ranges[2].samples)]
    ls.note_merge(1, 2)
    assert ls.qps(1) == pytest.approx(q_before, rel=1e-6)
    assert ls.qps(2) == 0.0 and 2 not in ls._ranges
    return out + [ls.qps(1), ls._ranges[1].seen]


# -- replica queues ---------------------------------------------------------


def queue_priority_order_and_dedup(ns):
    done = []
    q = ns.queues.ReplicaQueue("t-prio", done.append,
                               registry=ns.metric.Registry())
    out = [q.maybe_add("a", 1.0), q.maybe_add("b", 5.0),
           q.maybe_add("a", 0.5), q.maybe_add("a", 3.0), len(q)]
    q.drain()
    assert done == ["b", "a"] and q.processed.value == 2
    return out + [done, q.processed.value]


def queue_purgatory_backoff_and_recovery(ns):
    clk = ManualTime()
    boom = {"on": True}

    def process(item):
        if boom["on"]:
            raise ConnectionError("transient")

    q = ns.queues.ReplicaQueue(
        "t-purg", process, purgatory_errors=(ConnectionError,),
        purgatory_interval_s=5.0, max_backoff_s=60.0,
        registry=ns.metric.Registry(), clock=clk)
    q.maybe_add("r1", 1.0)
    out = [q.drain(), q.purgatory_len(), len(q), q.failures.value,
           q.maybe_add("r1", 99.0), q.drain()]
    clk.advance(5.0)
    out += [q.drain(), q.purgatory_len()]
    clk.advance(5.0)
    out.append(q.drain())
    boom["on"] = False
    out += [q.drain(force_purgatory=True), q.purgatory_len(),
            q.processed.value]
    assert out == [1, 1, 0, 0, False, 0, 1, 1, 0, 1, 0, 1]
    return out


def queue_unexpected_error_drops_item_not_queue(ns):
    calls = []

    def process(item):
        calls.append(item)
        if item == "bad":
            raise ValueError("poison range")

    q = ns.queues.ReplicaQueue("t-drop", process,
                               purgatory_errors=(ConnectionError,),
                               registry=ns.metric.Registry())
    q.maybe_add("bad", 9.0)
    q.maybe_add("good", 1.0)
    q.drain()
    assert calls == ["bad", "good"]
    assert q.failures.value == 1 and q.processed.value == 1
    return [calls, q.purgatory_len(), len(q)]


def store_pool_thresholds_and_gossip_roundtrip(ns):
    pool = ns.alloc.StorePool()
    pool.note(ns.alloc.StoreCapacity(1, 1, ranges=4, qps=90.0,
                                     logical_bytes=100))
    pool.note(ns.alloc.StoreCapacity(2, 2, ranges=0, qps=10.0,
                                     logical_bytes=0))
    cap = ns.alloc.StoreCapacity(3, 9, ranges=7, qps=1.5, logical_bytes=4096)
    assert ns.alloc.StoreCapacity.from_info(cap.to_info()) == cap
    return [pool.mean_qps(), [c.store_id for c in pool.overfull()],
            pool.least_loaded(exclude_store=1).store_id,
            pool.least_loaded(exclude_store=2).store_id, cap.to_info()]


UNIT_CASES = (
    decaying_counter_half_life,
    reservoir_split_key_is_interior_median,
    note_split_partitions_samples_and_halves_rates,
    queue_priority_order_and_dedup,
    queue_purgatory_backoff_and_recovery,
    queue_unexpected_error_drops_item_not_queue,
    store_pool_thresholds_and_gossip_roundtrip,
)


@pytest.mark.parametrize("case", UNIT_CASES, ids=lambda f: f.__name__)
def test_unit_case_equals_reference(case):
    assert plain(case(T)) == plain(case(J))


def test_queue_start_stop_joins_thread():
    done = threading.Event()
    q = tqueues.ReplicaQueue("t-loop", lambda item: done.set(),
                             interval_s=0.01, registry=tmetric.Registry())
    q.start()
    try:
        q.maybe_add("x", 1.0)
        assert done.wait(timeout=5.0), "background loop never processed"
    finally:
        q.stop()
    assert q._thread is None


# -- the hot-key workload: split, transfer, re-merge ------------------------


def hot_key_lifecycle(ns):
    """tests/test_ranger.py's end-to-end story on a 2-store cluster, with
    a ManualClock under the DB so both packages stamp the same versions.
    Returns the transcript and the stores."""
    clk = ManualTime()
    meta, stores, ds = mk(ns)
    db = ns.DB(ds, ns.Clock(start=1_000))
    load = ns.load.RangeLoadStats(half_life_s=5.0, sample_size=32, seed=3,
                                  clock=clk)
    ds.load = load
    nl1 = ns.live.NodeLiveness(db, 1, ttl_ms=120_000)
    nl2 = ns.live.NodeLiveness(db, 2, ttl_ms=120_000)
    nl1.heartbeat()
    nl2.heartbeat()
    lm = ns.live.LeaseManager(nl1)
    lm.acquire(1)
    life = ns.alloc.RangeLifecycle(ds, load=load, leases=lm, node_id=1,
                                   store_nodes={1: 1, 2: 2}, clock=clk)
    ns.settings.set("kv.range.split_qps_threshold", 5.0)
    m = ns.metric
    c0 = (m.KV_RANGE_SPLITS.value, m.KV_LEASE_TRANSFERS.value,
          m.KV_RANGE_MERGES.value)
    rng = random.Random(7)
    model = {}
    for _ in range(400):
        i = rng.randrange(40) if rng.random() < 0.8 \
            else 40 + rng.randrange(160)
        k = b"y%05d" % i
        v = b"v%05d" % rng.randrange(10_000)
        db.put(k, v)
        model[k] = v
    out = []
    for _ in range(4):
        out.append(life.tick())
    descs = meta.snapshot()
    assert m.KV_RANGE_SPLITS.value > c0[0], "hot range never load-split"
    assert m.KV_LEASE_TRANSFERS.value > c0[1], "no lease transfer"
    assert {d.store_id for d in descs} == {1, 2}
    assert all(lm.holder(d.range_id) is not None for d in descs)
    assert any(lm.holder(d.range_id).node_id == 2 for d in descs
               if d.store_id == 2)
    for k, v in model.items():
        assert db.get(k) == v
    assert dict(db.scan(b"y", b"z")) == model
    report = life.hot_ranges()["hotRanges"]
    assert len(report) == len(descs)
    assert all(r["leaseholder"] in (1, 2) and r["sizeBytes"] > 0
               for r in report)
    # crdb_internal.hot_ranges reads the node's lifecycle
    sess = ns.session(db)
    sess.catalog._crdb_node = SimpleNamespace(ranger=life)
    hot = sess.execute("select range_id, start_key, end_key, store_id, qps, "
                       "size_bytes, leaseholder from crdb_internal.hot_ranges")
    hot = {k: np.asarray(v).tolist() for k, v in hot.items()}
    assert hot["range_id"] == [r["rangeId"] for r in report]
    out += [[plain(d) for d in descs],
            [plain(lm.holder(d.range_id)) for d in descs], report, hot,
            m.KV_RANGE_SPLITS.value - c0[0],
            m.KV_LEASE_TRANSFERS.value - c0[1]]
    clk.advance(3600.0)
    for _ in range(10):
        out.append(life.tick())
        if len(meta.snapshot()) == 1:
            break
    assert m.KV_RANGE_MERGES.value > c0[2]
    assert len(meta.snapshot()) == 1, "cold ranges never re-merged"
    live_ids = {d.range_id for d in meta.snapshot()}
    assert all(lm.holder(d.range_id) is None for d in descs
               if d.range_id not in live_ids)
    assert dict(db.scan(b"y", b"z")) == model
    out += [[plain(d) for d in meta.snapshot()],
            m.KV_RANGE_MERGES.value - c0[2]]
    return out, stores


def test_hot_key_workload_splits_transfers_then_remerges():
    jout, jstores = hot_key_lifecycle(J)
    tout, tstores = hot_key_lifecycle(T)
    assert plain(tout) == plain(jout)
    for js, ts in zip(jstores, tstores):
        assert store_rows(ts.engine) == store_rows(js.engine)


def split_disabled_below_threshold_and_merge_respects_setting(ns):
    clk = ManualTime()
    meta, stores, ds = mk(ns, n_stores=1)
    db = ns.DB(ds, ns.Clock(start=1_000))
    load = ns.load.RangeLoadStats(half_life_s=5.0, sample_size=16, seed=4,
                                  clock=clk)
    ds.load = load
    life = ns.alloc.RangeLifecycle(ds, load=load, clock=clk)
    for i in range(50):
        db.put(b"q%04d" % i, b"v")
    life.tick()
    out = [len(meta.snapshot())]
    ns.settings.set("kv.range.merge_enabled", False)
    ds.split_at(b"q0025")
    life.tick()
    out.append(len(meta.snapshot()))
    ns.settings.set("kv.range.merge_enabled", True)
    for _ in range(3):
        life.tick()
    out.append([plain(d) for d in meta.snapshot()])
    assert out[:2] == [1, 2] and len(out[2]) == 1
    return out


def test_split_disabled_below_threshold_and_merge_respects_setting():
    assert plain(split_disabled_below_threshold_and_merge_respects_setting(
        T)) == plain(
        split_disabled_below_threshold_and_merge_respects_setting(J))


def test_post_split_throughput_not_degraded():
    """The port's tripwire of tests/test_ranger.py: after the lifecycle
    splits the hot range, the same workload runs at least half as fast
    as on a twin cluster the lifecycle did not split (a broken split
    path, routing retries on every op, lands far below). The twin holds
    the LSM's own slowdown as its runs pile up out of the comparison:
    both clusters take the same writes in the same order, in turns."""
    rng_seed = 11
    twins = []
    for _ in range(2):
        meta, stores, ds = mk(T)
        db = tDB(ds, tClock(start=1_000))
        load = tload.RangeLoadStats(half_life_s=5.0, sample_size=32, seed=5)
        ds.load = load
        twins.append((db, talloc.RangeLifecycle(ds, load=load),
                      random.Random(rng_seed)))
    tsettings.set("kv.range.split_qps_threshold", 5.0)

    def burst(db, rng, n=150):
        t0 = time.perf_counter()
        for _ in range(n):
            i = rng.randrange(200)
            db.put(b"t%05d" % i, b"v%05d" % i)
            db.get(b"t%05d" % rng.randrange(200))
        return time.perf_counter() - t0

    for db, _, rng in twins:
        burst(db, rng)
    splits0 = tmetric.KV_RANGE_SPLITS.value
    twins[0][1].tick()
    assert tmetric.KV_RANGE_SPLITS.value > splits0
    assert len(twins[0][0].engine.meta.snapshot()) > 1
    assert len(twins[1][0].engine.meta.snapshot()) == 1
    secs = [0.0, 0.0]
    for _ in range(2):
        for j, (db, _, rng) in enumerate(twins):
            secs[j] += burst(db, rng)
    split_s, twin_s = secs
    assert split_s <= 2 * twin_s, f"{twin_s:.2f} s -> {split_s:.2f} s"


def hot_ranges_fallbacks(ns):
    """crdb_internal.hot_ranges without a lifecycle: the bare descriptor
    table over a DistSender, nothing over a single engine."""
    meta, stores, ds = mk(ns)
    db = ns.DB(ds, ns.Clock(start=1_000))
    db.put(b"hr-a", b"1")
    ds.split_at(b"hr-b")
    ds.move_range(meta.lookup(b"hr-b").range_id, 2)
    q = ("select range_id, start_key, end_key, store_id, qps, "
         "write_bytes_rate, size_bytes, leaseholder "
         "from crdb_internal.hot_ranges")
    got = [{k: np.asarray(v).tolist()
            for k, v in ns.session(db).execute(q).items()}]
    single = ns.single()
    got.append({k: np.asarray(v).tolist()
                for k, v in single.execute(q).items()})
    assert got[0]["range_id"] == [1, 2] and got[1]["range_id"] == []
    return got


def test_hot_ranges_fallbacks_equal_reference():
    assert hot_ranges_fallbacks(T) == hot_ranges_fallbacks(J)
