"""The port's KV transaction layer (kv/hlc.py, kv/txn.py) against the JAX
reference on the CPU: each scenario of tests/test_kv.py runs through both
packages, and what it observes (reads, scans, timestamps, raised errors,
retries) must be the same; the randomized ones (kvnemesis with bulk
ingests and limited scans, the bank invariant) also hold to a dict
model."""

from types import SimpleNamespace

import numpy as np
import pytest

from cockroach_tpu import kv as jkv
from cockroach_tpu.kv import hlc as jhlc
from cockroach_tpu.storage.lsm import Engine as jEngine
from cockroach_tpu.utils import settings as jsettings
from cockroach_tpu_torch import kv as tkv
from cockroach_tpu_torch.kv import hlc as thlc
from cockroach_tpu_torch.storage.lsm import Engine as tEngine
from cockroach_tpu_torch.utils import settings as tsettings

J = SimpleNamespace(kv=jkv, hlc=jhlc, Engine=jEngine, settings=jsettings)
T = SimpleNamespace(kv=tkv, hlc=thlc,
                    Engine=lambda **kw: tEngine(device="cpu", **kw),
                    settings=tsettings)


def mkdb(P, **kw):
    return P.kv.DB(P.Engine(val_width=16, **kw), P.kv.ManualClock())


def both(scenario):
    """Run scenario(P, log) through both packages; the logs must agree."""
    logs = []
    for P in (J, T):
        log: list = []
        scenario(P, log)
        logs.append(log)
    assert logs[1] == logs[0]
    return logs[1]


def raises(P, log, exc_name, fn):
    """Call fn, log the name of the kv error it raises (it must raise)."""
    exc = getattr(P.kv, exc_name)
    with pytest.raises(exc):
        fn()
    log.append(exc_name)


def test_hlc_monotone():
    def sc(P, log):
        c = P.kv.ManualClock()
        a, b = c.now(), c.now()
        c.advance(10)
        d = c.now()
        e = c.update(P.hlc.pack(99, 5))
        log.extend([a, b, d, P.hlc.unpack(d), e, P.hlc.pack(3, 4)])
        wall = [1000]
        clk = P.hlc.Clock(lambda: wall[0])
        log.append([clk.now() for _ in range(3)])
        with pytest.raises(OverflowError):
            P.hlc.pack(1, 1 << 20)
    log = both(sc)
    assert log[1] > log[0] and log[3] == (11, 0)
    assert log[4] > thlc.pack(99, 5)


def test_db_basic():
    def sc(P, log):
        db = mkdb(P)
        ts1 = db.put(b"a", b"1")
        db.put(b"a", b"2")
        log += [db.get(b"a"), db.get(b"a", ts=ts1)]
        db.delete(b"a")
        log.append(db.get(b"a"))
        db.put(b"b", b"x")
        db.put(b"c", b"y")
        log.append(db.scan(b"a", b"z"))
    assert both(sc) == [b"2", b"1", None, [(b"b", b"x"), (b"c", b"y")]]


def test_txn_visibility_rollback_and_conflicts():
    def sc(P, log):
        db = mkdb(P)
        db.put(b"k", b"base")
        t = db.new_txn()
        t.put(b"k", b"txn")
        log += [db.get(b"k", ts=t.read_ts - 1), t.get(b"k")]
        t.commit()
        log.append(db.get(b"k"))
        t = db.new_txn()
        t.put(b"k", b"gone")
        t.rollback()
        log.append(db.get(b"k"))
        raises(P, log, "TransactionAbortedError",
               lambda: t.put(b"k", b"zombie"))
        t1, t2 = db.new_txn(), db.new_txn()
        t1.put(b"w", b"one")
        raises(P, log, "TransactionRetryError", lambda: t2.put(b"w", b"two"))
        t1.commit()
        t3 = db.new_txn()
        db.put(b"w", b"newer")  # commits above t3.read_ts
        raises(P, log, "TransactionRetryError", lambda: t3.put(b"w", b"x"))
        t3.rollback()
        db.put(b"r", b"v0")
        t4 = db.new_txn()
        log.append(t4.get(b"r"))
        db.put(b"r", b"v1")  # invalidates t4's read before commit
        t4.put(b"other", b"x")
        raises(P, log, "TransactionRetryError", t4.commit)
        log.append(db.get(b"other"))
        log.append(db.engine.intent_keys(t4.txn_id))
    assert both(sc)[:4] == [b"base", b"txn", b"txn", b"txn"]


def test_txn_closure_retries_and_rewrites():
    def sc(P, log):
        db = mkdb(P)
        db.put(b"counter", b"0")
        calls = {"n": 0}

        def incr(t):
            calls["n"] += 1
            v = int(t.get(b"counter") or b"0")
            if calls["n"] == 1:
                db.put(b"counter", str(v + 10).encode())
            t.put(b"counter", str(v + 1).encode())

        db.txn(incr)
        log += [calls["n"], db.get(b"counter")]

        def rw(t):
            t.put(b"rw", b"first")
            log.append(t.get(b"rw"))
            t.put(b"rw", b"second")
            log.append(t.get(b"rw"))
            t.delete(b"rw")
            log.append(t.get(b"rw"))
            t.put(b"rw", b"final")

        db.txn(rw)
        log.append(db.get(b"rw"))
        # a closure that always conflicts gives up after max_retries
        raises(P, log, "TransactionRetryError", lambda: db.txn(
            lambda t: (_ for _ in ()).throw(
                P.kv.TransactionRetryError("again")), max_retries=3))
    log = both(sc)
    assert log[0] >= 2 and log[1] == b"11" and log[5] == b"final"


def test_interleaved_serializability():
    """Write skew is refused by the commit-time refresh."""
    def sc(P, log):
        db = mkdb(P)
        db.put(b"x", b"0")
        db.put(b"y", b"0")
        t1, t2 = db.new_txn(), db.new_txn()
        log += [t1.get(b"x"), t2.get(b"y")]
        t1.put(b"y", b"1")
        t2.put(b"x", b"1")
        t1.commit()
        raises(P, log, "TransactionRetryError", t2.commit)
        log += [db.get(b"y"), db.get(b"x")]
    assert both(sc)[-2:] == [b"1", b"0"]


def test_non_txn_write_respects_intents():
    def sc(P, log):
        db = P.kv.DB(P.Engine(), P.kv.ManualClock())
        t = db.new_txn()
        t.put("k", "txnval")
        raises(P, log, "WriteIntentError", lambda: db.put("k", "sneaky"))
        raises(P, log, "WriteIntentError", lambda: db.delete("k"))
        t.commit()
        log.append(db.get("k"))
        db.put("k", "after")
        log.append(db.get("k"))
    assert both(sc)[-2:] == [b"txnval", b"after"]


def test_kvnemesis_bank_and_model():
    """Random transfers conserve the total, and random read-modify-writes,
    puts and deletes match a dict model (kvnemesis-lite), identically in
    both packages."""
    def sc(P, log):
        db = mkdb(P)
        rng = np.random.default_rng(3)
        n = 6
        for i in range(n):
            db.put(f"acct{i}".encode(), b"100")
        model = {f"acct{i}".encode(): b"100" for i in range(n)}
        for step in range(16):
            a, b = (int(x) for x in rng.integers(0, n, 2))
            ka, kb = f"acct{a}".encode(), f"acct{b}".encode()
            kind = rng.random()
            if kind < 0.5 and a != b:
                amt = int(rng.integers(1, 20))

                def xfer(t, ka=ka, kb=kb, amt=amt):
                    va, vb = int(t.get(ka)), int(t.get(kb))
                    t.put(ka, str(va - amt).encode())
                    t.put(kb, str(vb + amt).encode())

                db.txn(xfer)
                model[ka] = str(int(model[ka]) - amt).encode()
                model[kb] = str(int(model[kb]) + amt).encode()
            elif kind < 0.8:
                k = f"s{a}".encode()
                db.txn(lambda t, k=k, step=step: t.put(k, b"v%d" % step))
                model[k] = b"v%d" % step
            else:
                k = f"s{a}".encode()
                db.txn(lambda t, k=k: t.delete(k))
                model.pop(k, None)
        got = db.scan(None, None)
        log.append(got)
        assert dict(got) == model
        assert sum(int(v) for k, v in got if k.startswith(b"acct")) == 600
    both(sc)


def test_kvnemesis_with_ingest_and_limited_scans():
    """Bulk ingests interleave with transactional read-modify-writes and
    limited scans; every read matches a dict model and the reference."""
    def sc(P, log):
        db = P.kv.DB(P.Engine(key_width=16, val_width=16, memtable_size=32),
                     P.kv.ManualClock())
        rng = np.random.default_rng(11)
        model: dict[bytes, bytes] = {}

        def key(i):
            return b"n%05d" % i

        for step in range(20):
            kind = rng.random()
            if kind < 0.25:
                lo = int(rng.integers(0, 200))
                width = int(rng.integers(1, 30))
                keys = np.zeros((width, 16), np.uint8)
                vals = np.zeros((width, 16), np.uint8)
                for j in range(width):
                    k = key(lo + j)
                    v = b"i%d" % step
                    keys[j, :len(k)] = np.frombuffer(k, np.uint8)
                    vals[j, :len(v)] = np.frombuffer(v, np.uint8)
                    model[k] = v
                db.engine.ingest(keys, vals, ts=db.clock.now(),
                                 vlens=np.full(width, len(v), np.int32))
            elif kind < 0.6:
                i = int(rng.integers(0, 230))

                def rmw(t, i=i):
                    cur = t.get(key(i))
                    t.put(key(i), b"r" + (cur or b"")[:8])

                db.txn(rmw)
                model[key(i)] = b"r" + model.get(key(i), b"")[:8]
            elif kind < 0.7:
                i = int(rng.integers(0, 230))
                db.txn(lambda t, i=i: t.delete(key(i)))
                model.pop(key(i), None)
            else:
                lo = int(rng.integers(0, 230))
                mk = int(rng.integers(1, 12))
                got = db.scan(key(lo), key(lo + 60), max_keys=mk)
                want = sorted((k, v) for k, v in model.items()
                              if key(lo) <= k < key(lo + 60))[:mk]
                assert got == want
                log.append(got)
        log.append(db.scan(None, None))
        assert dict(log[-1]) == model
    both(sc)


def test_commit_heavy_intent_resolution_bounds_runs():
    """Each commit flushes a run; the resolution's compaction hook keeps
    the run count bounded, as in the reference."""
    def sc(P, log):
        db = mkdb(P)
        prev = P.settings.get("storage.compaction.pacing.enabled")
        P.settings.set("storage.compaction.pacing.enabled", False)
        try:
            for i in range(24):
                t = db.new_txn()
                t.put(b"k%d" % (i % 8), b"v%d" % i)
                t.commit()
                log.append(len(db.engine.runs))
            log.append([db.get(b"k%d" % j) for j in range(8)])
            assert len(db.engine.runs) <= db.engine.l0_trigger + 1
        finally:
            P.settings.set("storage.compaction.pacing.enabled", prev)
    both(sc)
