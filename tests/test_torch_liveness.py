"""The port's node liveness and epoch leases
(cockroach_tpu_torch/kv/liveness.py) against the reference's on the CPU:
the 16 scenarios of tests/test_liveness.py, each run through both
packages on a ManualClock from the same start. Every record returned and
every error raised (type and text) is equal, and so is every version in
the two engines afterwards."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cockroach_tpu.kv import DB as jDB
from cockroach_tpu.kv.hlc import ManualClock as jClock
from cockroach_tpu.kv import liveness as jlive
from cockroach_tpu.storage.lsm import Engine as jEngine
from cockroach_tpu_torch.kv import DB as tDB
from cockroach_tpu_torch.kv.hlc import ManualClock as tClock
from cockroach_tpu_torch.kv import liveness as tlive
from cockroach_tpu_torch.storage.lsm import Engine as tEngine
from cockroach_tpu_torch.utils import faults as tfaults


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


J = SimpleNamespace(
    name="reference", live=jlive,
    db=lambda: jDB(jEngine(key_width=16, val_width=32, memtable_size=64),
                   jClock(start=1_000)))
T = SimpleNamespace(
    name="port", live=tlive,
    db=lambda: tDB(tEngine(key_width=16, val_width=32, memtable_size=64,
                           device="cpu"), tClock(start=1_000)))

FIELDS = ("key", "ts", "seq", "txn", "tomb", "value", "vlen")


class Log(list):
    """The scenario's transcript: each call's result or error."""

    def call(self, fn, *a):
        try:
            out = fn(*a)
        except Exception as e:  # noqa: BLE001 - the error is the outcome
            self.append(("err", type(e).__name__, str(e)))
            return e
        self.append(("ok", repr(out)))
        return out


def node(ns, db, node_id, ttl_ms=100):
    return ns.live.NodeLiveness(db, node_id,
                                heartbeat_interval_ms=ttl_ms // 2,
                                ttl_ms=ttl_ms)


# -- heartbeat -------------------------------------------------------------


def first_heartbeat_creates_epoch_one(ns, log):
    db = ns.db()
    n1 = node(ns, db, 1)
    rec = log.call(n1.heartbeat)
    assert rec.epoch == 1 and rec.node_id == 1
    assert rec.live_at(db.clock.now())
    assert log.call(n1.is_live, 1) is True
    return db


def heartbeat_renews_expiration_same_epoch(ns, log):
    db = ns.db()
    n1 = node(ns, db, 1, ttl_ms=100)
    first = log.call(n1.heartbeat)
    db.clock.advance(60)
    second = log.call(n1.heartbeat)
    assert second.epoch == first.epoch == 1
    assert second.expiration > first.expiration
    return db


def record_expires_without_heartbeat(ns, log):
    db = ns.db()
    n1 = node(ns, db, 1, ttl_ms=100)
    log.call(n1.heartbeat)
    db.clock.advance(200)
    assert log.call(n1.is_live, 1) is False
    assert log.call(node(ns, db, 2).is_live, 1) is False
    return db


def is_live_unknown_node_false(ns, log):
    db = ns.db()
    assert log.call(node(ns, db, 1).is_live, 99) is False
    return db


# -- epoch increment (fencing) ---------------------------------------------


def increment_epoch_refused_while_live(ns, log):
    db = ns.db()
    n1, n2 = node(ns, db, 1), node(ns, db, 2)
    log.call(n1.heartbeat)
    assert isinstance(log.call(n2.increment_epoch, 1),
                      ns.live.StillLiveError)
    return db


def increment_epoch_after_expiry_bumps(ns, log):
    db = ns.db()
    n1, n2 = node(ns, db, 1, ttl_ms=100), node(ns, db, 2)
    log.call(n1.heartbeat)
    db.clock.advance(200)
    rec = log.call(n2.increment_epoch, 1)
    assert rec.epoch == 2 and rec.node_id == 1
    return db


def increment_epoch_unknown_node_errors(ns, log):
    db = ns.db()
    assert isinstance(log.call(node(ns, db, 1).increment_epoch, 42),
                      ValueError)
    return db


def fenced_node_heartbeat_raises_epoch_fenced(ns, log):
    db = ns.db()
    n1, n2 = node(ns, db, 1, ttl_ms=100), node(ns, db, 2)
    log.call(n1.heartbeat)
    db.clock.advance(200)
    log.call(n2.increment_epoch, 1)
    assert isinstance(log.call(n1.heartbeat), ns.live.EpochFencedError)
    return db


def resurrect_after_fence_adopts_new_epoch(ns, log):
    db = ns.db()
    n1, n2 = node(ns, db, 1, ttl_ms=100), node(ns, db, 2)
    log.call(n1.heartbeat)
    db.clock.advance(200)
    log.call(n2.increment_epoch, 1)
    rec = log.call(node(ns, db, 1).heartbeat)  # a restarted process
    assert rec.epoch == 2
    assert log.call(n2.is_live, 1) is True
    assert isinstance(log.call(n1.heartbeat), ns.live.EpochFencedError)
    return db


def livenesses_lists_all_records(ns, log):
    db = ns.db()
    log.call(node(ns, db, 3).heartbeat)
    log.call(node(ns, db, 1).heartbeat)
    n = node(ns, db, 2)
    log.call(n.heartbeat)
    recs = {r.node_id: r for r in log.call(n.livenesses)}
    assert sorted(recs) == [1, 2, 3]
    assert all(r.epoch == 1 for r in recs.values())
    return db


# -- epoch leases ----------------------------------------------------------


def acquire_vacant_and_renew(ns, log):
    db = ns.db()
    lm = ns.live.LeaseManager(node(ns, db, 1))
    rec = log.call(lm.acquire, 7)
    assert (rec.range_id, rec.node_id, rec.epoch) == (7, 1, 1)
    again = log.call(lm.acquire, 7)
    assert (again.node_id, again.epoch) == (1, 1)
    assert log.call(lm.holder, 7).node_id == 1
    assert log.call(lm.check, 7) is None
    return db


def acquire_against_live_holder_reroutes(ns, log):
    db = ns.db()
    lm1 = ns.live.LeaseManager(node(ns, db, 1))
    lm2 = ns.live.LeaseManager(node(ns, db, 2))
    log.call(lm1.acquire, 7)
    log.call(lm2.liveness.heartbeat)
    err = log.call(lm2.acquire, 7)
    assert isinstance(err, ns.live.NotLeaseHolderError) and err.holder == 1
    return db


def failover_fences_dead_holder_and_takes_lease(ns, log):
    db = ns.db()
    n1 = node(ns, db, 1, ttl_ms=100)
    lm1 = ns.live.LeaseManager(n1)
    lm2 = ns.live.LeaseManager(node(ns, db, 2))
    log.call(lm1.acquire, 7)
    log.call(lm2.liveness.heartbeat)
    db.clock.advance(200)
    log.call(lm2.liveness.heartbeat)
    assert log.call(lm2.acquire, 7).node_id == 2
    assert log.call(lm2.liveness._read, 1).epoch == 2
    assert isinstance(log.call(lm1.check, 7),
                      (ns.live.EpochFencedError,
                       ns.live.NotLeaseHolderError))
    assert isinstance(log.call(n1.heartbeat), ns.live.EpochFencedError)
    return db


def check_not_holder_carries_hint(ns, log):
    db = ns.db()
    lm1 = ns.live.LeaseManager(node(ns, db, 1))
    lm2 = ns.live.LeaseManager(node(ns, db, 2))
    log.call(lm1.acquire, 7)
    err = log.call(lm2.check, 7)
    assert isinstance(err, ns.live.NotLeaseHolderError) and err.holder == 1
    return db


def check_vacant_range_not_holder(ns, log):
    db = ns.db()
    err = log.call(ns.live.LeaseManager(node(ns, db, 1)).check, 99)
    assert isinstance(err, ns.live.NotLeaseHolderError)
    return db


def check_epoch_fenced_after_bump(ns, log):
    db = ns.db()
    lm1 = ns.live.LeaseManager(node(ns, db, 1, ttl_ms=100))
    log.call(lm1.acquire, 7)
    db.clock.advance(200)
    log.call(node(ns, db, 2).increment_epoch, 1)
    assert isinstance(log.call(lm1.check, 7), ns.live.EpochFencedError)
    return db


SCENARIOS = (
    first_heartbeat_creates_epoch_one,
    heartbeat_renews_expiration_same_epoch,
    record_expires_without_heartbeat,
    is_live_unknown_node_false,
    increment_epoch_refused_while_live,
    increment_epoch_after_expiry_bumps,
    increment_epoch_unknown_node_errors,
    fenced_node_heartbeat_raises_epoch_fenced,
    resurrect_after_fence_adopts_new_epoch,
    livenesses_lists_all_records,
    acquire_vacant_and_renew,
    acquire_against_live_holder_reroutes,
    failover_fences_dead_holder_and_takes_lease,
    check_not_holder_carries_hint,
    check_vacant_range_not_holder,
    check_epoch_fenced_after_bump,
)


def engines_equal(jdb, tdb):
    got = tdb.engine.export_span(None, None)
    want = jdb.engine.export_span(None, None)
    for k in FIELDS:
        assert np.asarray(got[k]).tobytes() == np.asarray(
            want[k]).tobytes(), k


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_liveness_scenario_equals_reference(scenario):
    jlog, tlog = Log(), Log()
    jdb = scenario(J, jlog)
    tdb = scenario(T, tlog)
    assert tlog == jlog
    engines_equal(jdb, tdb)


@pytest.mark.chaos
def test_scoped_heartbeat_fault_blackholes_one_node():
    """liveness.heartbeat.n<id> fails one node's heartbeats while its peer
    renews; an unknown scoped site is refused at arm time."""
    db = T.db()
    n1, n2 = node(T, db, 1), node(T, db, 2)
    tfaults.arm(0, {"liveness.heartbeat.n1": tfaults.FaultSpec("error")})
    try:
        with pytest.raises(tfaults.InjectedFault):
            n1.heartbeat()
        assert n2.heartbeat().epoch == 1
    finally:
        tfaults.disarm()
    assert n1.heartbeat().epoch == 1
    with pytest.raises(KeyError):
        tfaults.arm(0, {"liveness.gossip.n1": tfaults.FaultSpec("error")})
