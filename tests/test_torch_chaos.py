"""Seeded fault injection at the port's fault sites (utils/faults.py),
one scenario per site that no other port test drives: the storage
engine, the spill plane, admission, the warm menu, liveness fencing,
the KV RPC, the node dialer, gossip, the range lifecycle, the commit
train and the cross-host flows. Each arms its site, checks the
documented degrade (a typed error, a retry that lands, a result equal to
the no-fault run) and disarms. Everything runs on the CPU with seeded
firing, in seconds."""

import random
import threading
import time

import numpy as np
import pytest
import torch

from cockroach_tpu_torch.catalog import Catalog, Table
from cockroach_tpu_torch.coldata.types import FLOAT64, INT64, Schema
from cockroach_tpu_torch.flow.disthost import (HostFlowServer,
                                               run_distributed_join)
from cockroach_tpu_torch.flow.runtime import run_operator
from cockroach_tpu_torch.kv import DB, Clock
from cockroach_tpu_torch.kv.rpc import BatchClient, BatchServer
from cockroach_tpu_torch.plan import builder as plan_builder
from cockroach_tpu_torch.plan import spec as S
from cockroach_tpu_torch.storage.lsm import Engine as _Engine
from cockroach_tpu_torch.utils import faults, metric, settings
from cockroach_tpu_torch.utils.faults import FaultSpec, InjectedFault

pytestmark = pytest.mark.chaos


def Engine(**kw):
    return _Engine(device="cpu", **kw)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    faults.disarm()


# -- storage engine ----------------------------------------------------------


def test_wal_fsync_and_delay_faults(tmp_path):
    """fsync error injection surfaces; delay injection slows appends
    without corrupting them."""
    eng = Engine(key_width=16, val_width=8, wal_path=str(tmp_path / "f.wal"),
                 wal_fsync=True)
    spec = FaultSpec(kind="error", p=1.0, max_fires=1)
    faults.arm(37, {"storage.wal.fsync": spec})
    with pytest.raises(InjectedFault):
        eng.put(b"x", b"1", ts=3)
    assert spec.fires == 1
    faults.arm(41, {"storage.wal.append": FaultSpec(
        kind="delay", p=1.0, delay_s=0.01, max_fires=2)})
    t0 = time.monotonic()
    eng.put(b"y", b"2", ts=4)
    assert time.monotonic() - t0 >= 0.01
    faults.disarm()
    assert eng.get(b"y", ts=10) == b"2"
    eng.close()


def test_bulk_ingest_link_crash_atomic_abort_then_retry(tmp_path):
    """A crash in the ingest link window (side file durable, WAL link
    record not written): the ingest aborts atomically, a retry lands it,
    and replay keeps exactly one copy of every row."""
    wal = str(tmp_path / "w.wal")
    eng = Engine(key_width=16, val_width=8, wal_path=wal)
    eng.put(b"keep", b"x", ts=1)
    keys = np.zeros((4, 16), np.uint8)
    for i in range(4):
        keys[i, :6] = np.frombuffer(b"ing%03d" % i, np.uint8)
    vals = np.full((4, 8), ord("v"), np.uint8)
    faults.arm(73, {"storage.ingest.link":
                    FaultSpec(kind="error", p=1.0, max_fires=1)})
    with pytest.raises(InjectedFault):
        eng.ingest(keys, vals, ts=5)
    assert eng.get(b"ing000", ts=10) is None
    assert len(eng.scan(None, None, ts=10)) == 1
    eng.ingest(keys, vals, ts=6)  # the retry (fault budget spent)
    faults.disarm()
    assert eng.get(b"ing002", ts=10) == b"v" * 8
    eng.close()
    eng2 = Engine(key_width=16, val_width=8, wal_path=wal)
    assert eng2.get(b"keep", ts=10) == b"x"
    assert len(eng2.scan(None, None, ts=10)) == 5
    eng2.close()


def test_compaction_swap_crash_still_invalidates_cache():
    """A crash between a compaction's run-set swap and its bookkeeping:
    the replaced runs' block-cache windows are invalidated anyway."""
    from cockroach_tpu_torch.storage import blockcache

    eng = Engine(key_width=16, val_width=16, memtable_size=4,
                 l0_trigger=64)
    for i in range(48):
        eng.put(b"s%05d" % i, b"v%05d" % i, ts=i + 1)
    eng.flush()
    assert len(eng.runs) >= 2
    for i in (3, 17, 40):  # warm the cache from the soon-dead runs
        assert eng.get(b"s%05d" % i, ts=100) == b"v%05d" % i
        assert eng.get(b"s%05d" % i, ts=100) == b"v%05d" % i
    old_tokens = {eng._meta_for(r).token for r in eng.runs}
    faults.arm(79, {"storage.compaction.swap":
                    FaultSpec(kind="error", p=1.0, max_fires=1)})
    with pytest.raises(InjectedFault):
        eng.compact(bottom=True)
    faults.disarm()
    cache = blockcache.node_cache()
    assert not any(k[0] in old_tokens for k in cache._entries)
    for i in (3, 17, 40, 47):
        assert eng.get(b"s%05d" % i, ts=100) == b"v%05d" % i


def test_bloom_corruption_detected_zero_false_negatives():
    """Silent bloom bit corruption after the build checksum: the lazy
    check on a first negative disables the filter; no present key is
    lost and absent keys still answer None."""
    faults.arm(83, {"storage.bloom.build": FaultSpec(kind="partial", p=1.0)})
    eng = Engine(key_width=16, val_width=16, memtable_size=4, l0_trigger=64)
    for i in range(40):
        eng.put(b"g%05d" % i, b"v%05d" % i, ts=i + 1)
    eng.flush()
    assert len(eng.runs) >= 4
    faults.disarm()
    before = metric.BLOOM_CORRUPTIONS.value
    for i in range(40):
        assert eng.get(b"g%05d" % i, ts=100) == b"v%05d" % i
    for i in range(500, 540):
        assert eng.get(b"g%05d" % i, ts=100) is None
    assert metric.BLOOM_CORRUPTIONS.value > before
    assert eng.get(b"g%05d" % 7, ts=100) == b"v%05d" % 7


# -- the spill plane -----------------------------------------------------------


def _spill_join_catalog(seed=5) -> Catalog:
    """Build side large enough that a 64 KiB workmem partitions it and
    at least one partition's build side alone exceeds it (the
    merge-probe path)."""
    rng = np.random.default_rng(seed)
    cat = Catalog("cpu")
    cat.add(Table(
        name="probe", schema=Schema(("k", "w"), (INT64, INT64)),
        columns={"k": rng.integers(0, 1200, 4000, dtype=np.int64),
                 "w": rng.integers(0, 100, 4000, dtype=np.int64)}))
    cat.add(Table(
        name="build", schema=Schema(("bk", "v"), (INT64, INT64)),
        columns={"bk": rng.integers(0, 1500, 36000, dtype=np.int64),
                 "v": rng.integers(0, 100, 36000, dtype=np.int64)}))
    return cat


def _run_spill_join(cat: Catalog, workmem: int) -> dict:
    from cockroach_tpu_torch.sql.rel import Rel

    prev = settings.get("sql.distsql.workmem_bytes")
    settings.set("sql.distsql.workmem_bytes", workmem)
    try:
        return (Rel.scan(cat, "probe")
                .join(Rel.scan(cat, "build"), on=[("k", "bk")],
                      how="inner", build_unique=False)
                .groupby(["k"], [("n", "count_rows", None),
                                 ("sv", "sum", "v")])
                .run())
    finally:
        settings.set("sql.distsql.workmem_bytes", prev)


def _canon(res: dict) -> np.ndarray:
    rows = np.stack([np.asarray(res[k], dtype=np.float64)
                     for k in sorted(res.keys())], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def _assert_equal(got: dict, want: dict) -> None:
    assert sorted(got.keys()) == sorted(want.keys())
    np.testing.assert_allclose(_canon(got), _canon(want), rtol=1e-9)


@pytest.mark.parametrize("site,seed", [("flow.spill.partition_write", 31),
                                       ("flow.spill.merge_probe", 37)])
def test_spill_fault_surfaces_then_clean_rerun(site, seed):
    """A host spill-partition write failure, or an oversized partition's
    merge-probe failure, surfaces to the caller as the injected fault
    (never silent row loss; the port's runner raises it unwrapped), and a
    clean re-run equals the no-spill result."""
    cat = _spill_join_catalog()
    want = _run_spill_join(cat, workmem=2 << 30)
    spec = FaultSpec(kind="error", p=1.0, max_fires=1)
    faults.arm(seed, {site: spec})
    with pytest.raises(InjectedFault) as ei:
        _run_spill_join(cat, workmem=1 << 16)
    assert ei.value.site == site
    assert spec.fires == 1
    faults.disarm()
    merge0 = metric.GRACE_JOIN_MERGE_PARTS.value
    _assert_equal(_run_spill_join(cat, workmem=1 << 16), want)
    assert metric.GRACE_JOIN_MERGE_PARTS.value > merge0


# -- admission -----------------------------------------------------------------


def test_admission_grant_lost_withdraws_waiter_and_leaks_no_slot():
    """Error-kind admission.grant.stall: a queued waiter's grant is lost;
    it withdraws with a typed busy whose cause is the fault, the queue
    drains, no slot leaks, and a clean rerun admits."""
    from cockroach_tpu_torch.utils import admission
    from cockroach_tpu_torch.utils.errors import AdmissionRejectedError

    q = admission.WorkQueue(slots=1, max_queue_depth=8)
    assert q.admit(tenant_id=2)  # park the slot so the next admit queues
    spec = FaultSpec(kind="error", p=1.0, max_fires=1)
    faults.arm(79, {"admission.grant.stall": spec})
    with pytest.raises(AdmissionRejectedError) as ei:
        q.admit(tenant_id=3, timeout=5.0)
    assert isinstance(ei.value.__cause__, InjectedFault)
    assert ei.value.retry_after_s > 0.0
    faults.disarm()
    assert q.queue_depth == 0
    q.release()
    assert q.admit(tenant_id=3, timeout=5.0)
    q.release()
    assert q.in_use == 0


def test_admission_grant_stall_delay_still_lands_grant():
    """Delay-kind admission.grant.stall holds only the stalled waiter's
    thread: the grant still lands and the slot count stays exact."""
    from cockroach_tpu_torch.utils import admission

    q = admission.WorkQueue(slots=1)
    assert q.admit(tenant_id=2)
    spec = FaultSpec(kind="delay", p=1.0, delay_s=0.2, max_fires=1)
    faults.arm(83, {"admission.grant.stall": spec})
    got = []

    def waiter():
        got.append(q.admit(tenant_id=3, timeout=10.0))
        q.release()

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    deadline = time.time() + 5.0
    while not spec.fires and time.time() < deadline:
        time.sleep(0.005)
    assert spec.fires == 1, "the waiter never queued into the stall site"
    q.release()  # the grant races the stalled waiter: it lands anyway
    t.join(timeout=10.0)
    assert got == [True]
    assert q.in_use == 0 and q.queue_depth == 0


def test_admission_bucket_refill_failure_is_typed_busy():
    """admission.bucket.refill: the tenant's token refill fails; the
    admit surfaces the typed busy (cause the fault), and the next admit
    succeeds."""
    from cockroach_tpu_torch.utils import admission
    from cockroach_tpu_torch.utils.errors import AdmissionRejectedError

    q = admission.WorkQueue(slots=2)
    q.configure_tenant(5, rate=1000.0, burst=4)
    faults.arm(89, {"admission.bucket.refill":
                    FaultSpec(kind="error", p=1.0, max_fires=1)})
    with pytest.raises(AdmissionRejectedError) as ei:
        q.admit(tenant_id=5)
    assert isinstance(ei.value.__cause__, InjectedFault)
    assert "refill" in str(ei.value)
    faults.disarm()
    assert q.admit(tenant_id=5)
    q.release()
    assert q.in_use == 0


# -- the warm menu ---------------------------------------------------------------


def _mini_catalog(n=600, c=16, seed=7) -> Catalog:
    rng = np.random.default_rng(seed)
    cat = Catalog("cpu")
    cat.add(Table(
        name="orders",
        schema=Schema(("o_key", "o_cust", "o_val"), (INT64, INT64, FLOAT64)),
        columns={"o_key": np.arange(n, dtype=np.int64),
                 "o_cust": rng.integers(0, c, n, dtype=np.int64),
                 "o_val": rng.uniform(1.0, 100.0, n)}))
    cat.add(Table(
        name="cust", schema=Schema(("c_key", "c_grp"), (INT64, INT64)),
        columns={"c_key": np.arange(c, dtype=np.int64),
                 "c_grp": np.arange(c, dtype=np.int64) % 4}))
    return cat


def test_warmup_compile_fault_records_failed_serves_cold():
    """A fault at "sql.warmup.compile" marks that menu item failed; the
    build still completes, and the statement serves correctly on first
    use (warming is best-effort)."""
    from cockroach_tpu_torch.sql import warmmenu
    from cockroach_tpu_torch.sql.session import Session

    warmmenu.reset()
    cat = _mini_catalog(n=300, seed=23)
    boot = Session(catalog=cat, device="cpu")
    settings.set("sql.warmup.menu.enabled", True)
    faults.arm(47, {"sql.warmup.compile":
                    FaultSpec(kind="error", p=1.0, max_fires=2)})
    try:
        run = warmmenu.build_menu(cat, boot.db, block=True)
        assert run is not None
        run.join(10)
        statuses = [r["status"] for r in warmmenu.menu_rows()]
        assert statuses.count("failed") == 2
        assert "compiled" in statuses
        faults.disarm()
        serve = Session(catalog=cat, db=boot.db, bootstrap=False,
                        device="cpu")
        oracle = Session(catalog=_mini_catalog(n=300, seed=23),
                         device="cpu")
        try:
            for s in warmmenu._ladder_statements(cat):
                got, exp = serve.execute(s), oracle.execute(s)
                assert set(got) == set(exp)
                for name in exp:
                    np.testing.assert_array_equal(
                        np.asarray(got[name]), np.asarray(exp[name]),
                        err_msg=f"{s}: {name}")
        finally:
            oracle.close()
            serve.close()
    finally:
        faults.disarm()
        settings.reset("sql.warmup.menu.enabled")
        boot.close()
        warmmenu.reset()


# -- liveness, the RPC, the dialer, gossip ---------------------------------------


def test_epoch_bump_injected_cput_failure_then_retry_fences():
    """The fencer's IncrementEpoch write fails in flight (node-scoped to
    the node doing the bump); the retry completes the fence."""
    from cockroach_tpu_torch.kv import ManualClock
    from cockroach_tpu_torch.kv.liveness import (EpochFencedError,
                                                 NodeLiveness)

    db = DB(Engine(key_width=16, val_width=32, memtable_size=64),
            ManualClock(start=1_000))
    n1 = NodeLiveness(db, 1, heartbeat_interval_ms=50, ttl_ms=100)
    n2 = NodeLiveness(db, 2, heartbeat_interval_ms=50, ttl_ms=100)
    n1.heartbeat()
    db.clock.advance(200)  # node 1's record expires
    faults.arm(67, {"liveness.epoch_bump.n2":
                    FaultSpec(kind="error", p=1.0, max_fires=1)})
    with pytest.raises(InjectedFault):
        n2.increment_epoch(1)
    rec = n2.increment_epoch(1)
    assert rec.epoch == 2 and rec.node_id == 1
    with pytest.raises(EpochFencedError):
        n1.heartbeat()


def test_kv_rpc_drops_retry_to_oracle():
    """Client-wire drops and server-eval drops: the retry layer re-dials
    and re-sends until the bounded faults are spent; every read equals
    the no-fault oracle."""
    db = DB(Engine(key_width=16, val_width=32, memtable_size=64), Clock())
    srv = BatchServer(db)
    client = BatchClient(srv.addr, deadline_s=2.0, max_retries=8)
    retries0 = metric.RPC_RETRIES.value
    specs = {"kv.rpc.client.batch": FaultSpec(kind="drop", p=0.25,
                                              max_fires=4),
             "kv.rpc.server.eval": FaultSpec(kind="drop", p=0.25,
                                             max_fires=4)}
    faults.arm(11, specs)
    try:
        oracle = {}
        for i in range(30):
            k, v = b"k%03d" % i, b"v%03d" % (i * 7)
            client.put(k, v)
            oracle[k] = v
        for k, v in oracle.items():
            assert client.get(k) == v
        assert all(s.fires for s in specs.values())
        assert metric.RPC_RETRIES.value > retries0
    finally:
        faults.disarm()
        client.close()
        srv.close()


def test_dialer_injected_connect_failure_then_retry_succeeds():
    """A transient connect failure at the node dialer: the dial raises,
    the half-open slot is released, and the retry connects without the
    breaker tripping on one failure."""
    from cockroach_tpu_torch.flow.gossip import Gossip
    from cockroach_tpu_torch.kv.dialer import NodeDialer, advertise

    db = DB(Engine(key_width=16, val_width=32, memtable_size=64), Clock())
    srv = BatchServer(db)
    g = Gossip(99)
    advertise(g, 7, srv.addr)
    dialer = NodeDialer(g, trip_threshold=2, cooldown_s=0.4)
    faults.arm(61, {"kv.dialer.dial":
                    FaultSpec(kind="error", p=1.0, max_fires=1)})
    try:
        with pytest.raises(InjectedFault):
            dialer.dial(7)
        c = dialer.dial(7)
        c.put(b"dk", b"dv")
        assert c.get(b"dk") == b"dv"
        dialer.report_ok(7)
    finally:
        faults.disarm()
        dialer.close()
        srv.close()


def test_gossip_injected_broadcast_failure_then_retry_converges():
    """A partitioned gossip link (node-scoped to the pushing node): the
    exchange raises, nothing leaks through, and the next round
    propagates the peer's infos."""
    from cockroach_tpu_torch.flow.gossip import Gossip

    g2 = Gossip(node_id=2)
    g2.add_info("node:2:addr", "hostB:26257")
    addr = g2.serve()
    g1 = Gossip(node_id=1)
    g1.add_info("node:1:addr", "hostA:26257")
    faults.arm(71, {"gossip.broadcast.n1":
                    FaultSpec(kind="error", p=1.0, max_fires=1)})
    try:
        with pytest.raises(InjectedFault):
            g1.exchange(addr)
        assert g1.get_info("node:2:addr") is None
        assert g1.exchange(addr) >= 1
        assert g1.get_info("node:2:addr") == "hostB:26257"
    finally:
        faults.disarm()
        g1.close()
        g2.close()


# -- the range lifecycle -------------------------------------------------------------


def _ranger_cluster(load_seed=3):
    """Two-store cluster with routing-path load stats (no background
    threads: the test drives the queues)."""
    from cockroach_tpu_torch.kv.dist import DistSender, Meta, Store
    from cockroach_tpu_torch.kv.loadstats import RangeLoadStats

    meta = Meta(first_store=1)
    stores = [Store(i + 1, meta, key_width=16, val_width=16,
                    memtable_size=64, device="cpu") for i in range(2)]
    ds = DistSender(stores, meta)
    db = DB(ds, Clock())
    load = RangeLoadStats(half_life_s=5.0, sample_size=32, seed=load_seed)
    ds.load = load
    return meta, ds, db, load


def test_ranger_split_crash_between_meta_write_and_bookkeeping():
    """ranger.split.apply fires after the meta split, before the lease
    carry and load handoff: the item parks in purgatory, and the retry
    finds the boundary present and finishes the bookkeeping."""
    from cockroach_tpu_torch.kv.allocator import RangeLifecycle

    meta, ds, db, load = _ranger_cluster()
    life = RangeLifecycle(ds, load=load)
    settings.set("kv.range.split_qps_threshold", 5.0)
    try:
        model = {}
        for i in range(200):
            k, v = b"s%04d" % i, b"v%04d" % (i * 3)
            db.put(k, v)
            model[k] = v
        splits0 = metric.KV_RANGE_SPLITS.value
        spec = FaultSpec(kind="error", p=1.0, max_fires=1)
        faults.arm(61, {"ranger.split.apply": spec})
        life.scan_once()
        life.split_queue.drain()
        assert spec.fires == 1
        assert len(meta.snapshot()) == 2
        assert metric.KV_RANGE_SPLITS.value == splits0
        assert life.split_queue.purgatory_len() == 1
        faults.disarm()
        life.split_queue.drain(force_purgatory=True)
        assert life.split_queue.purgatory_len() == 0
        assert metric.KV_RANGE_SPLITS.value > splits0
        assert all(load.qps(d.range_id) > 0 for d in meta.snapshot())
        for k, v in model.items():
            assert db.get(k) == v
        assert dict(db.scan(b"s", b"t")) == model
    finally:
        faults.disarm()
        settings.reset("kv.range.split_qps_threshold")


def test_ranger_merge_crash_after_meta_write_converges():
    """ranger.merge.apply fires after the boundary left the meta, before
    the load fold and cache eviction: the retry converges, data
    intact."""
    from cockroach_tpu_torch.kv.allocator import RangeLifecycle

    meta, ds, db, load = _ranger_cluster()
    life = RangeLifecycle(ds, load=load)
    model = {}
    for i in range(120):
        k, v = b"c%04d" % i, b"w%04d" % i
        db.put(k, v)
        model[k] = v
    ds.split_at(b"c0060")
    right = meta.lookup(b"c0060")
    ds.move_range(right.range_id, to_store=2)
    merges0 = metric.KV_RANGE_MERGES.value
    spec = FaultSpec(kind="error", p=1.0, max_fires=1)
    faults.arm(67, {"ranger.merge.apply": spec})
    life.scan_once()
    life.merge_queue.drain()
    assert spec.fires == 1
    assert len(meta.snapshot()) == 1
    assert metric.KV_RANGE_MERGES.value == merges0
    assert life.merge_queue.purgatory_len() == 1
    faults.disarm()
    life.merge_queue.drain(force_purgatory=True)
    assert life.merge_queue.purgatory_len() == 0
    for k, v in model.items():
        assert db.get(k) == v
    assert dict(db.scan(b"c", b"d")) == model


def test_ranger_lease_transfer_dropped_completes_on_retry():
    """ranger.lease.transfer fires after the data move, before the lease
    write: the range lives on the target while the lease names the old
    node; the purgatory retry completes the handoff exactly once."""
    from cockroach_tpu_torch.kv.allocator import RangeLifecycle
    from cockroach_tpu_torch.kv.liveness import LeaseManager, NodeLiveness

    meta, ds, db, load = _ranger_cluster()
    nl1 = NodeLiveness(db, 1, ttl_ms=600_000)
    nl2 = NodeLiveness(db, 2, ttl_ms=600_000)
    nl1.heartbeat()
    nl2.heartbeat()
    lm = LeaseManager(nl1)
    lm.acquire(1)
    life = RangeLifecycle(ds, load=load, leases=lm, node_id=1,
                          store_nodes={1: 1, 2: 2})
    settings.set("kv.range.split_qps_threshold", 5.0)
    try:
        rng = random.Random(17)
        model = {}
        for _ in range(300):
            i = (rng.randrange(40) if rng.random() < 0.8
                 else 40 + rng.randrange(160))
            k, v = b"x%05d" % i, b"v%05d" % rng.randrange(10_000)
            db.put(k, v)
            model[k] = v
        life.scan_once()
        life.split_queue.drain()
        assert len(meta.snapshot()) >= 2
        transfers0 = metric.KV_LEASE_TRANSFERS.value
        spec = FaultSpec(kind="error", p=1.0, max_fires=1)
        faults.arm(71, {"ranger.lease.transfer": spec})
        life.scan_once()
        life.rebalance_queue.drain()
        assert spec.fires == 1
        moved = [d for d in meta.snapshot() if d.store_id == 2]
        assert moved, "the rebalance never moved the hot range"
        assert all(lm.holder(d.range_id).node_id == 1 for d in moved)
        assert metric.KV_LEASE_TRANSFERS.value == transfers0
        assert life.rebalance_queue.purgatory_len() == 1
        faults.disarm()
        life.rebalance_queue.drain(force_purgatory=True)
        assert life.rebalance_queue.purgatory_len() == 0
        assert metric.KV_LEASE_TRANSFERS.value == transfers0 + 1
        moved = [d for d in meta.snapshot() if d.store_id == 2]
        assert any(lm.holder(d.range_id).node_id == 2 for d in moved)
        for k, v in model.items():
            assert db.get(k) == v
    finally:
        faults.disarm()
        settings.reset("kv.range.split_qps_threshold")


# -- the commit train ------------------------------------------------------------------


def test_coalesce_fault_every_train_still_serves():
    """kv.batch.coalesce at p=1.0: every train degrades, and the
    coalescer becomes the solo path: writes, reads and deletes all
    serve."""
    from cockroach_tpu_torch.kv import coalesce

    db = DB(Engine(), Clock())
    settings.set("kv.batch.coalesce.enabled", True)
    spec = FaultSpec(kind="error", p=1.0)
    faults.arm(7, {"kv.batch.coalesce": spec})
    try:
        ts1 = db.put("deg-a", "1")
        ts2 = db.put("deg-b", "2")
        assert isinstance(ts1, int) and isinstance(ts2, int)
        assert db.get("deg-a") == b"1"
        assert db.delete("deg-a") > ts1
        assert db.get("deg-a") is None
        assert spec.fires > 0
    finally:
        faults.disarm()
        settings.reset("kv.batch.coalesce.enabled")
        coalesce.reset_db(db)


# -- the cross-host flows ------------------------------------------------------------


def test_distributed_join_under_rpc_drops_equals_oracle():
    """Setup and stream faults (bounded) against both hosts: retries,
    and degradation if they run out, still give the single-host result,
    and no flow-registry entry outlives the query."""
    cat = _mini_catalog()
    plan = S.HashJoin(
        probe=S.TableScan("orders", ("o_key", "o_cust")),
        build=S.TableScan("cust", ("c_key", "c_grp")),
        probe_keys=(1,), build_keys=(0,))
    want = run_operator(plan_builder.build(plan, cat))
    srvs = [HostFlowServer(cat, device="cpu").serve_background()
            for _ in range(2)]
    specs = {"flow.host.setup": FaultSpec(kind="drop", p=0.4, max_fires=2),
             "flow.host.stream": FaultSpec(kind="error", p=0.4,
                                           max_fires=2)}
    faults.arm(29, specs)
    try:
        got = run_distributed_join(plan, cat, [s.addr for s in srvs])
        _assert_equal(got, want)
        assert any(s.fires for s in specs.values())
        faults.disarm()
        for s in srvs:
            assert s.registry_size() == 0, "leaked flow-registry entries"
    finally:
        faults.disarm()
        for s in srvs:
            s.close()
