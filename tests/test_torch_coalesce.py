"""The port's commit train (cockroach_tpu_torch/kv/coalesce.py, the
``kv.batch.coalesce.enabled`` gate in kv/txn.DB and
bench/load.run_coalesce_ab) on the CPU, against the solo path and the
reference: the cases of tests/test_coalesce.py (coalesced against solo
bit-identity, a merged train as ONE WAL batch record, typed errors
demuxed to the one session, chunking, group-commit replay, the gate
off), a sequential caller with the gate on leaving the reference's solo
engine byte for byte, a train over a DistSender split into one stamped
sub-batch per range, and run_coalesce_ab at a small size with its
oracle."""

import threading
import time

import numpy as np
import pytest
import torch

from cockroach_tpu.kv import DB as jDB
from cockroach_tpu.kv.hlc import ManualClock as jClock
from cockroach_tpu.storage.lsm import Engine as jEngine
from cockroach_tpu_torch.bench.load import run_coalesce_ab
from cockroach_tpu_torch.kv import DB, coalesce
from cockroach_tpu_torch.kv import dist as tdist
from cockroach_tpu_torch.kv.hlc import ManualClock
from cockroach_tpu_torch.storage import lsm
from cockroach_tpu_torch.storage.lsm import Engine, WriteIntentError
from cockroach_tpu_torch.utils import metric, settings

FIELDS = ("key", "ts", "seq", "txn", "tomb", "value", "vlen")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def gate():
    settings.set("kv.batch.coalesce.enabled", True)
    yield
    settings.reset("kv.batch.coalesce.enabled")
    settings.reset("kv.batch.coalesce.max_ops")


def fresh_db(path=None, clock=None) -> DB:
    eng = (Engine(device="cpu") if path is None else
           Engine(wal_path=str(path), wal_fsync=True, device="cpu"))
    return DB(eng, clock)


def thread_script(tid: int, n: int):
    ops = []
    for i in range(n):
        k = f"t{tid}-k{i % 8}"
        if i % 5 == 4:
            ops.append(("delete", k, None))
        elif i % 3 == 2:
            ops.append(("get", k, None))
        else:
            ops.append(("put", k, f"v{tid}.{i}"))
    return ops


def run_script(db, ops, outcomes: list) -> None:
    for kind, k, v in ops:
        if kind == "put":
            outcomes.append(("put", k, db.put(k, v)))
        elif kind == "delete":
            outcomes.append(("delete", k, db.delete(k)))
        else:
            outcomes.append(("get", k, db.get(k)))


def state(db) -> dict:
    return dict(db.scan(None, None))


def rows(eng) -> dict:
    got = eng.export_span(None, None)
    return {f: np.asarray(got[f]).tobytes() for f in FIELDS}


class WalKinds:
    """Counts the WAL records an engine appends, by kind."""

    def __init__(self, eng):
        self.kinds: list[int] = []
        orig = eng._wal_record

        def counted(kind, *a, **kw):
            self.kinds.append(kind)
            return orig(kind, *a, **kw)

        eng._wal_record = counted


def test_concurrent_mixed_dml_bit_identical(gate):
    """8 sessions through the commit train leave the same visible state
    and the same per-session reads as the tapes run solo in the port and
    in the reference."""
    threads = 8
    scripts = [thread_script(t, 60) for t in range(threads)]
    db = fresh_db()
    outs = [[] for _ in range(threads)]
    errs = []

    def worker(t):
        try:
            run_script(db, scripts[t], outs[t])
        except Exception as e:  # noqa: BLE001 - surfaced below
            errs.append(e)

    ths = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(60)
    assert not errs, errs
    settings.reset("kv.batch.coalesce.enabled")
    solo, ref = fresh_db(), jDB(jEngine())
    solo_outs = [[] for _ in range(threads)]
    ref_outs = [[] for _ in range(threads)]
    for t in range(threads):
        run_script(solo, scripts[t], solo_outs[t])
        run_script(ref, scripts[t], ref_outs[t])
    assert state(db) == state(solo) == state(ref)
    for t in range(threads):
        for a, b, c in zip(outs[t], solo_outs[t], ref_outs[t]):
            assert a[:2] == b[:2] == c[:2]
            if a[0] == "get":
                assert a[2] == b[2] == c[2]
            else:
                assert isinstance(a[2], int) and isinstance(b[2], int)


def test_sequential_caller_takes_the_solo_path_byte_for_byte(gate):
    """A train of one is the solo op: with the gate on, a sequential
    caller leaves exactly the versions the reference's solo DB leaves
    (same ManualClock start), and no coalesced op is counted."""
    before = metric.KV_BATCH_COALESCED.value
    tdb = fresh_db(clock=ManualClock(start=1_000))
    jdb = jDB(jEngine(), jClock(start=1_000))
    for db in (tdb, jdb):
        for i in range(40):
            db.put(f"s{i % 13}", f"v{i}")
            if i % 7 == 3:
                db.delete(f"s{(i * 5) % 13}")
            db.get(f"s{i % 5}")
    assert rows(tdb.engine) == rows(jdb.engine)
    assert metric.KV_BATCH_COALESCED.value == before
    assert isinstance(tdb._coalescer, coalesce.BatchCoalescer)


def merged_train(db, n_riders=3, prefix="m"):
    """Hold the engine mutex so the first submitter leads a train that
    parks mid-flush; the riders arriving meanwhile board the next train,
    which merges them."""
    def worker(i):
        db.put(f"{prefix}{i}", "x")

    with db.engine.mu:
        leader = threading.Thread(target=worker, args=(0,))
        leader.start()
        time.sleep(0.1)
        riders = [threading.Thread(target=worker, args=(i,))
                  for i in range(1, n_riders + 1)]
        for t in riders:
            t.start()
        time.sleep(0.1)
    leader.join(30)
    for t in riders:
        t.join(30)


def test_merged_train_is_one_wal_batch_record(tmp_path, gate):
    db = fresh_db(tmp_path / "wal.log")
    wal = WalKinds(db.engine)
    before = metric.KV_BATCH_COALESCED.value
    merged_train(db)
    assert metric.KV_BATCH_COALESCED.value >= before + 3
    # the leader's train of one: a plain write record; the riders' train:
    # ONE batch record carrying ops, dedup token and response
    assert sorted(wal.kinds) == [lsm._REC_WRITE, lsm._REC_BATCH]
    assert db._coalescer.cid in db.engine._replay_cache
    for i in range(4):
        assert db.get(f"m{i}") == b"x"
    db.engine.close()
    again = DB(Engine(wal_path=str(tmp_path / "wal.log"), device="cpu"))
    assert {k: v for k, v in state(again).items()} == {
        b"m%d" % i: b"x" for i in range(4)}
    again.engine.close()


def test_train_over_a_distsender_is_one_stamped_batch_per_range(gate):
    meta = tdist.Meta(first_store=1)
    stores = [tdist.Store(i + 1, meta, key_width=16, val_width=16,
                          device="cpu") for i in range(2)]
    ds = tdist.DistSender(stores, meta)
    ds.split_at(b"m2")
    ds.move_range(meta.lookup(b"m2").range_id, 2)
    db = DB(ds)
    merged_train(db, n_riders=3)
    cid = db._coalescer.cid
    assert f"{cid}.r1" in stores[0].engine._replay_cache
    assert f"{cid}.r2" in stores[1].engine._replay_cache
    assert [db.get(f"m{i}") for i in range(4)] == [b"x"] * 4
    assert stores[1].engine.get(b"m3", ts=db.clock.now()) == b"x"


def test_write_intent_demuxes_to_conflicting_session_only(gate):
    db = fresh_db()
    with db.engine.mu:
        db.engine.put(b"locked", b"i", ts=db.clock.now(), txn=42)
    results = {}
    barrier = threading.Barrier(2)

    def conflicting():
        barrier.wait()
        try:
            db.put("locked", "v")
            results["conflict"] = "committed"
        except WriteIntentError as e:
            results["conflict"] = (e.keys, e.txns)

    def innocent():
        barrier.wait()
        results["innocent"] = db.put("innocent", "v")

    ths = [threading.Thread(target=conflicting),
           threading.Thread(target=innocent)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(30)
    assert results["conflict"] == ([b"locked"], [42])
    assert isinstance(results["innocent"], int)
    assert db.get("innocent") == b"v"


def test_max_ops_chunking_still_applies_everything(gate):
    settings.set("kv.batch.coalesce.max_ops", 2)
    db = fresh_db()
    barrier = threading.Barrier(6)
    errs = []

    def worker(i):
        barrier.wait()
        try:
            for j in range(10):
                db.put(f"c{i}-{j}", f"{i}.{j}")
        except Exception as e:  # noqa: BLE001 - surfaced below
            errs.append(e)

    ths = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(60)
    assert not errs and len(state(db)) == 60


def test_group_commit_wal_replay_has_every_acked_write(tmp_path, gate):
    db = fresh_db(tmp_path / "wal.log")
    barrier = threading.Barrier(6)
    acked, mu = [], threading.Lock()

    def worker(i):
        barrier.wait()
        got = []
        for j in range(15):
            db.put(f"w{i}-{j}", f"{i}.{j}")
            got.append((i, j))
        with mu:
            acked.extend(got)

    ths = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(60)
    assert len(acked) == 90
    db.engine.close()
    again = DB(Engine(wal_path=str(tmp_path / "wal.log"), wal_fsync=True,
                      device="cpu"))
    st = state(again)
    for i, j in acked:
        assert st[f"w{i}-{j}".encode()] == f"{i}.{j}".encode()
    again.engine.close()


def test_gate_off_never_attaches():
    db = fresh_db()
    db.put("a", "1")
    assert db.get("a") == b"1"
    assert getattr(db, "_coalescer", None) is None
    coalesce.reset_db(db)


def test_run_coalesce_ab_small_with_its_oracle():
    out = run_coalesce_ab(sessions=4, duration_s=0.3, rounds=1,
                          device="cpu")
    assert out["coalesce_oracle_ok"] is True
    assert out["coalesce_errors"] == 0, out["coalesce_last_error"]
    assert out["coalesce_off_ops_per_sec"] > 0
    assert out["coalesce_on_ops_per_sec"] > 0
    assert not settings.get("kv.batch.coalesce.enabled")


def test_run_coalesce_ab_defaults_to_the_card():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="cuda"):
        run_coalesce_ab(sessions=1, duration_s=0.01, rounds=1)
