"""Secondary indexes through the port against the JAX reference on the
CPU: the entry codec's bytes, the CREATE INDEX job's backfill, index
maintenance on upserts and deletes, the Streamer's request-sized fetch,
DROP INDEX, and index selection (plan/indexopt.py): an indexed table's
optimized plan and EXPLAIN text equal the reference's, and its results
equal the reference's and the full scan's. The reference's own tests
build these tables through a SQL session; both packages build them here
through create_kv_table and insert."""

from types import SimpleNamespace

import numpy as np
import pytest

import cockroach_tpu.catalog as jcatalog
from cockroach_tpu import coldata as jcd
from cockroach_tpu.flow.runtime import run_operator as jrun
from cockroach_tpu.kv import DB as jDB
from cockroach_tpu.kv import ManualClock as jClock
from cockroach_tpu.kv import index as jix
from cockroach_tpu.kv import table as jtable
from cockroach_tpu.kv.jobs import Registry as jRegistry
from cockroach_tpu.ops import expr as jex
from cockroach_tpu.plan import builder as jbuilder
from cockroach_tpu.plan.explain import explain_plan as jexplain
from cockroach_tpu.sql.binder import BindError as jBindError
from cockroach_tpu.sql.rel import Rel as jRel
from cockroach_tpu.storage.lsm import Engine as jEngine
from cockroach_tpu.utils import settings as jsettings
from cockroach_tpu_torch import catalog as tcatalog
from cockroach_tpu_torch.coldata import types as tT
from cockroach_tpu_torch.flow.runtime import run_operator as trun
from cockroach_tpu_torch.kv import DB as tDB
from cockroach_tpu_torch.kv import ManualClock as tClock
from cockroach_tpu_torch.kv import index as tix
from cockroach_tpu_torch.kv import table as ttable
from cockroach_tpu_torch.kv.jobs import Registry as tRegistry
from cockroach_tpu_torch.ops import expr as tex
from cockroach_tpu_torch.plan import builder as tbuilder
from cockroach_tpu_torch.plan import spec as S
from cockroach_tpu_torch.plan.explain import explain_plan as texplain
from cockroach_tpu_torch.sql.rel import Rel as tRel
from cockroach_tpu_torch.storage.lsm import Engine as tEngine
from cockroach_tpu_torch.utils import settings as tsettings

J = SimpleNamespace(
    name="jax", cd=jcd, DB=jDB, Clock=jClock, Engine=jEngine, ix=jix,
    table=jtable, Registry=jRegistry, ex=jex, Rel=jRel, explain=jexplain,
    BindError=jBindError, settings=jsettings, Catalog=jcatalog.Catalog,
    stmt=lambda name, table, col: SimpleNamespace(name=name, table=table,
                                                  col=col),
    run=lambda plan, cat: jrun(jbuilder.build(plan, cat)))
T = SimpleNamespace(
    name="torch", cd=tT, DB=tDB, Clock=tClock,
    Engine=lambda **kw: tEngine(device="cpu", **kw), ix=tix, table=ttable,
    Registry=tRegistry, ex=tex, Rel=tRel, explain=texplain,
    BindError=tix.BindError, settings=tsettings,
    Catalog=lambda: tcatalog.Catalog("cpu"), stmt=tix.CreateIndex,
    run=lambda plan, cat: trun(tbuilder.build(plan, cat)))
PKGS = (J, T)
N = 60


def make(P, n=N, index=True, key_width=24):
    """Table t (id pk, k = id % 9, v = id * 3, s = 'g{id % 4}') of n rows,
    with the index ik on k made through the CREATE INDEX job."""
    cd = P.cd
    schema = cd.Schema.of(id=cd.INT64, k=cd.INT64, v=cd.INT64, s=cd.STRING,
                          f=cd.FLOAT64)
    db = P.DB(P.Engine(key_width=key_width, val_width=64, memtable_size=64),
              P.Clock())
    cat = P.Catalog()
    t = P.table.create_kv_table(cat, db, "t", schema, pk="id")

    def ins(txn):
        for i in range(n):
            t.insert(txn, {"id": i, "k": i % 9, "v": i * 3, "s": f"g{i % 4}",
                           "f": i / 2})

    db.txn(ins)
    if index:
        create_index(P, cat, db, "ik", "k")
    return db, cat, t


def create_index(P, cat, db, name, col):
    reg = P.Registry(db)
    P.ix.register_create_index_job(reg, cat)
    payload = P.ix.plan_create_index(cat, db, P.stmt(name, "t", col))
    job = reg.adopt_and_resume(reg.create("create_index", payload).job_id)
    assert job.state == "succeeded" and job.progress["swapped"]
    return payload


def lookup(P, cat, lo, hi=None):
    """SELECT id, v, s FROM t WHERE k >= lo [AND k <= hi], as stacked
    filters (the binder's shape for BETWEEN)."""
    r = P.Rel.scan(cat, "t", ("id", "k", "v", "s"))
    r = r.filter(P.ex.Cmp("ge", r.c("k"), P.ex.lit(lo)))
    if hi is not None:
        r = r.filter(P.ex.Cmp("le", r.c("k"), P.ex.lit(hi)))
    return r.select("id", "v", "s")


def rows(res):
    return sorted(zip(*(np.asarray(v).tolist() for v in res.values())))


# ---------------------------------------------------------------- codec


def test_entry_codec_matches_reference():
    pairs = [(-(1 << 62), 5), (-3, 1), (0, 0), (0, 7), (9, 2), (1 << 62, 9)]
    ks = []
    for val, pk in pairs:
        k = tix.encode_entry(7, val, pk)
        assert k == jix.encode_entry(7, val, pk)
        assert tix.decode_entry(k) == jix.decode_entry(k) == (val, pk)
        ks.append(k)
    assert ks == sorted(ks)
    for lo, hi in ((10, 20), (None, 3), (-4, None), (None, None)):
        assert tix.value_span(7, lo, hi) == jix.value_span(7, lo, hi)
    rng = np.random.default_rng(2)
    vals = rng.integers(-(1 << 40), 1 << 40, 300, dtype=np.int64)
    pks = rng.integers(0, 1 << 50, 300, dtype=np.int64)
    assert (tix.encode_entries(9, vals, pks).tobytes()
            == jix.encode_entries(9, vals, pks).tobytes())
    assert tix.ENTRY_BYTES == jix.ENTRY_BYTES == 21


# ------------------------------------------------------- the index itself


@pytest.fixture(scope="module")
def indexed():
    return {P.name: make(P) for P in PKGS}


def test_backfill_entries_and_scans_match_reference(indexed):
    """The job's backfill lands the same entry keys; range scans of the
    index return the same primary keys; the descriptor names the index
    and a fresh catalog reloads it."""
    got = {}
    for P in PKGS:
        db, cat, t = indexed[P.name]
        ix = t.indexes[0]
        start, end = P.ix.value_span(ix.index_id, None, None)
        got[P.name] = (
            db.engine.export_span(start, end)["key"].tobytes(),
            [P.ix.scan_pks(t, ix, lo, hi).tolist()
             for lo, hi in ((3, 3), (2, 5), (None, 1), (7, None))],
            ix)
        fresh = P.Catalog()
        P.table.load_catalog_from_engine(fresh, db)
        assert fresh.tables["t"].indexes == [ix]
    assert got["torch"][:2] == got["jax"][:2]
    assert got["torch"][1][0] == [i for i in range(N) if i % 9 == 3]
    j, t = got["jax"][2], got["torch"][2]
    assert (t.name, t.col, t.index_id) == (j.name, j.col, j.index_id)


@pytest.mark.parametrize("bounds", [(3, 3), (2, 5), (7, None)])
def test_indexed_table_optimized_plan_matches_reference(indexed, bounds):
    """Index selection over an indexed KV table: the optimized plan and
    its EXPLAIN text equal the reference's (a one-sided bound without
    statistics stays a full scan there too), and the results equal the
    reference's and the full scan's."""
    lo, hi = bounds
    out = {}
    for P in PKGS:
        db, cat, t = indexed[P.name]
        rel = lookup(P, cat, lo, hi)
        plan = rel.optimized_plan()
        P.settings.set("sql.opt.index_scan.enabled", False)
        try:
            full = P.run(rel.optimized_plan(), cat)
        finally:
            P.settings.set("sql.opt.index_scan.enabled", True)
        res = P.run(plan, cat)
        assert rows(res) == rows(full)
        out[P.name] = (repr(plan), P.explain(plan), rows(res))
    assert out["torch"] == out["jax"]
    assert ("IndexScan" in out["torch"][0]) == (hi is not None)
    assert out["torch"][2] == sorted(
        (i, i * 3, f"g{i % 4}") for i in range(N)
        if i % 9 >= lo and (hi is None or i % 9 <= hi))


def test_index_scan_operator_and_streamer(indexed):
    """IndexScanOp's batch is sized by the request; the Streamer masks
    off primary keys that do not exist."""
    db, cat, t = indexed["torch"]
    plan = S.IndexScan("t", "ik", 3, 3, ("id", "v"))
    op = tbuilder.build(plan, cat)
    assert type(op).__name__ == "IndexScanOp"
    res = trun(op)
    assert sorted(res["id"].tolist()) == [i for i in range(N) if i % 9 == 3]
    st = tix.Streamer(t)
    b = st.fetch(np.array([3, 5, 57], dtype=np.int64), ("id", "v"))
    assert b.capacity == 128
    m = b.mask.numpy()
    assert sorted(b.cols[0].data.numpy()[m].tolist()) == [3, 5, 57]
    assert sorted(b.cols[1].data.numpy()[m].tolist()) == [9, 15, 171]
    b = st.fetch(np.array([1, 999, 2], dtype=np.int64), ("id",))
    assert sorted(b.cols[0].data.numpy()[b.mask.numpy()].tolist()) == [1, 2]
    assert st.fetch(np.zeros(0, np.int64), ("id",)).capacity == 128


# ------------------------------------------------------- writes and DDL


def test_upserts_deletes_and_drop_index():
    """A vectorized upsert over an existing pk tombstones the stale entry
    (the old row is read before the put lands); a delete drops its entry;
    DROP INDEX removes the descriptor entry and the span; both packages
    end with the same entries."""
    out = {}
    for P in PKGS:
        db, cat, t = make(P, n=20)
        ix = t.indexes[0]

        def up(txn):
            t.insert_rows(txn, {"id": np.array([3, 300]),
                                "k": np.array([8, 8]),
                                "v": np.array([1, 2]),
                                "s": np.array(["x", "y"], dtype=object),
                                "f": np.array([0.5, 1.5])})
            t.delete_pk(txn, 8)

        db.txn(up)
        got = [P.ix.scan_pks(t, ix, 3, 3).tolist(),
               P.ix.scan_pks(t, ix, 8, 8).tolist()]
        start, end = P.ix.value_span(ix.index_id, None, None)
        got.append(db.engine.export_span(start, end)["key"].tobytes())
        P.ix.drop_index(cat, db, "t", "ik")
        got.append(db.scan(start, end))
        got.append("IndexScan" in repr(lookup(P, cat, 2, 2).optimized_plan()))
        out[P.name] = got
    assert out["torch"] == out["jax"]
    assert 3 not in out["torch"][0] and {3, 300} <= set(out["torch"][1])
    assert 8 not in out["torch"][1] and out["torch"][3] == []
    assert out["torch"][4] is False


def test_plan_create_index_refusals():
    """The reference's refusals, with the port's own BindError."""
    for P in PKGS:
        db, cat, t = make(P, n=3, index=False, key_width=16)
        with pytest.raises(P.BindError, match="key_width"):
            P.ix.plan_create_index(cat, db, P.stmt("i", "t", "k"))
        db, cat, t = make(P, n=3)
        for stmt, msg in ((P.stmt("i2", "t", "f"), "FLOAT"),
                          (P.stmt("ik", "t", "k"), "already exists"),
                          (P.stmt("i3", "t", "nope"), "unknown column"),
                          (P.stmt("i4", "u", "k"), "unknown table")):
            with pytest.raises(P.BindError, match=msg):
                P.ix.plan_create_index(cat, db, stmt)
        with pytest.raises(P.BindError, match="unknown index"):
            P.ix.drop_index(cat, db, "t", "nope")
