"""SQL over the MVCC store through the port against the JAX reference on
the CPU: storage/rowcodec's bytes and decodes, KVTable's write and read
surfaces (transactions, snapshots, NULLs, intents, bulk load and the
IMPORT job, descriptors), the scan's streaming guard, and TPC-H q1, q3,
q9 and q18 over KV tables at sf=0.002 (seed 7) before and after the
refresh functions RF1 and RF2. Integer, DECIMAL, DATE and STRING columns
compare exactly; FLOAT within rtol=1e-9, as tests/test_kvsql.py holds
the reference."""

import csv
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import cockroach_tpu.catalog as jcatalog
from cockroach_tpu import coldata as jcd
from cockroach_tpu.bench import queries as jQ
from cockroach_tpu.bench import tpch as jtpch
from cockroach_tpu.flow.runtime import run_operator as jrun
from cockroach_tpu.kv import DB as jDB
from cockroach_tpu.kv import ManualClock as jClock
from cockroach_tpu.kv import WriteIntentError as jWIE
from cockroach_tpu.kv import table as jtable
from cockroach_tpu.kv.jobs import Registry as jRegistry
from cockroach_tpu.kv.jobs import register_import_job as j_import_job
from cockroach_tpu.ops import expr as jex
from cockroach_tpu.plan import builder as jbuilder
from cockroach_tpu.sql.rel import Rel as jRel
from cockroach_tpu.storage import rowcodec as jrc
from cockroach_tpu.storage.lsm import Engine as jEngine
from cockroach_tpu.utils import settings as jsettings
from cockroach_tpu_torch import catalog as tcatalog
from cockroach_tpu_torch.bench import queries as tQ
from cockroach_tpu_torch.bench import tpch as ttpch
from cockroach_tpu_torch.bench import tpch_kv, tpch_oracle
from cockroach_tpu_torch.coldata import types as tT
from cockroach_tpu_torch.flow.runtime import run_operator as trun
from cockroach_tpu_torch.kv import DB as tDB
from cockroach_tpu_torch.kv import ManualClock as tClock
from cockroach_tpu_torch.kv import WriteIntentError as tWIE
from cockroach_tpu_torch.kv import table as ttable
from cockroach_tpu_torch.kv.jobs import Registry as tRegistry
from cockroach_tpu_torch.kv.jobs import register_import_job as t_import_job
from cockroach_tpu_torch.ops import expr as tex
from cockroach_tpu_torch.plan import builder as tbuilder
from cockroach_tpu_torch.sql.rel import Rel as tRel
from cockroach_tpu_torch.storage import rowcodec as trc
from cockroach_tpu_torch.storage.lsm import Engine as tEngine
from cockroach_tpu_torch.utils import settings as tsettings


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: beside the other test workers, a full thread
    pool per process oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


FLOAT_RTOL = 1e-9  # tests/test_kvsql.py's bound for FLOAT aggregates
SF, SEED = 0.002, 7
LADDER = ("q1", "q3", "q9", "q18")
# the MVCC fields every version carries besides its timestamp and
# sequence, which come from each package's own clock
FIELDS = ("key", "txn", "tomb", "value", "vlen")

J = SimpleNamespace(
    name="jax", cd=jcd, DB=jDB, Clock=jClock, Engine=jEngine, WIE=jWIE,
    table=jtable, Rel=jRel, ex=jex, rc=jrc, Catalog=jcatalog.Catalog,
    Registry=jRegistry, import_job=j_import_job, settings=jsettings,
    run=lambda rel: jrun(jbuilder.build(rel.optimized_plan(), rel.catalog)))
T = SimpleNamespace(
    name="torch", cd=tT, DB=tDB, Clock=tClock,
    Engine=lambda **kw: tEngine(device="cpu", **kw), WIE=tWIE,
    table=ttable, Rel=tRel, ex=tex, rc=trc,
    Catalog=lambda: tcatalog.Catalog("cpu"),
    Registry=tRegistry, import_job=t_import_job, settings=tsettings,
    run=lambda rel: trun(tbuilder.build(rel.optimized_plan(), rel.catalog)))
PKGS = (J, T)


def schema(P):
    cd = P.cd
    return cd.Schema.of(id=cd.INT64, qty=cd.INT64, price=cd.DECIMAL(12, 2),
                        day=cd.DATE, ratio=cd.FLOAT64, ok=cd.BOOL)


def rows_of(n: int, seed: int = 3) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"id": i, "qty": int(rng.integers(1, 100)),
             "price": int(rng.integers(100, 10000)),
             "day": int(rng.integers(8000, 9000)),
             "ratio": float(rng.random()), "ok": bool(rng.integers(0, 2))}
            for i in range(n)]


def setup(P, n=50, val_width=None):
    s = schema(P)
    db = P.DB(P.Engine(key_width=16,
                       val_width=val_width or P.rc.value_width(s),
                       memtable_size=64), P.Clock())
    cat = P.Catalog()
    t = P.table.create_kv_table(cat, db, "items", s, pk="id")
    rows = rows_of(n)

    def ins(txn):
        for r in rows:
            t.insert(txn, r)

    db.txn(ins)
    return db, cat, t, rows


def same(got: dict, want: dict, floats=()) -> None:
    assert list(got) == list(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape, k
        if k in floats:
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64), rtol=FLOAT_RTOL)
        else:
            assert a.tolist() == b.tolist(), k


# ------------------------------------------------------------- rowcodec


def test_rowcodec_bytes_match_reference():
    rng = np.random.default_rng(11)
    pks = np.concatenate([
        np.array([-(1 << 63), -1, 0, 1, (1 << 63) - 1], np.int64),
        rng.integers(-(1 << 62), 1 << 62, 200, dtype=np.int64)])
    for tid in (0, 7, trc.MAX_TABLE_ID):
        assert trc.table_span(tid) == jrc.table_span(tid)
        assert (trc.encode_pk_batch(tid, pks).tobytes()
                == jrc.encode_pk_batch(tid, pks).tobytes())
        for pk in pks[:20]:
            k = trc.encode_pk(tid, int(pk))
            assert k == jrc.encode_pk(tid, int(pk))
            assert trc.decode_pk(k) == jrc.decode_pk(k) == int(pk)
    ts, js = schema(T), schema(J)
    assert trc.value_width(ts) == jrc.value_width(js)
    rows = rows_of(40) + [{"id": 1}, {"id": -5, "ratio": -2.75, "ok": True}]
    for r in rows:
        b = trc.encode_row(ts, r)
        assert b == jrc.encode_row(js, r)
        assert trc.decode_row(ts, b) == jrc.decode_row(js, b)
    cols = {k: np.array([r[k] for r in rows[:40]]) for k in rows[0]}
    valids = {"qty": rng.random(40) < 0.7}
    assert (trc.encode_rows(ts, cols, valids).tobytes()
            == jrc.encode_rows(js, cols, valids).tobytes())


def test_decode_columns_exact():
    """The device decode (a strided copy per 8-byte field, viewed as int64
    or float64) equals the reference's u32-pair route bit for bit."""
    ts, js = schema(T), schema(J)
    rows = rows_of(64)
    cols = {k: np.array([r[k] for r in rows]) for k in rows[0]}
    cols["ratio"][3] = np.nan
    cols["ratio"][4] = -np.inf
    valids = {"price": np.arange(64) % 5 != 0}
    vals = jrc.encode_rows(js, cols, valids)
    sel = np.arange(64) % 7 != 3
    got = trc.decode_columns(torch.from_numpy(vals), torch.from_numpy(sel),
                             ts)
    want = jrc.decode_columns(vals, sel, js)
    for g, w in zip(got.cols, want.cols):
        assert g.data.numpy().tobytes() == np.asarray(w.data).tobytes()
        assert g.valid.numpy().tolist() == np.asarray(w.valid).tolist()
    keys = jrc.encode_pk_batch(5, cols["id"] * 977 - 31000)
    wide = np.zeros((64, 16), np.uint8)
    wide[:, :keys.shape[1]] = keys
    assert (trc.decode_pk_column(torch.from_numpy(wide)).numpy().tolist()
            == np.asarray(jrc.decode_pk_column(wide)).tolist())


# ------------------------------------------------------------- KVTable


def _count_rel(P, cat):
    r = P.Rel.scan(cat, "items")
    r = r.filter(P.ex.Cmp("gt", r.c("qty"), P.ex.lit(50)))
    return r.scalar_agg([("n", "count_rows", None), ("s", "sum", "qty"),
                         ("lo", "min", "day"), ("hi", "max", "day")])


def test_sql_over_kv_table_matches_reference():
    out = {}
    for P in PKGS:
        db, cat, t, rows = setup(P)
        res = P.run(_count_rel(P, cat))
        r2 = P.Rel.scan(cat, "items").scalar_agg(
            [("p", "sum", "price"), ("r", "avg", "ratio")])
        out[P.name] = (res, P.run(r2), t.num_rows)
    want = [r for r in rows_of(50) if r["qty"] > 50]
    res, res2, n = out["torch"]
    assert n == 50
    assert int(res["n"][0]) == len(want)
    assert int(res["s"][0]) == sum(r["qty"] for r in want)
    assert int(res["lo"][0]) == min(r["day"] for r in want)
    same(res, out["jax"][0])
    same(res2, out["jax"][1], floats=("r",))


def test_device_batch_matches_reference():
    """Every decoded column, its NULLs and the mask, slot for slot."""
    got = {}
    for P in PKGS:
        db, cat, t, rows = setup(P, n=40)

        def upd(txn, t=t, rows=rows):
            t.insert(txn, {"id": 3, "qty": 7})  # NULLs in the rest
            t.delete_pk(txn, 5)

        db.txn(upd)
        b = t.device_batch()
        got[P.name] = [np.asarray(b.mask)] + [
            x for c in b.cols for x in (np.asarray(c.data),
                                        np.asarray(c.valid))]
    for g, w in zip(got["torch"], got["jax"]):
        assert g.tobytes() == w.tobytes()


def _batch_bytes(b) -> list[bytes]:
    return [np.asarray(b.mask).tobytes()] + [
        np.asarray(x).tobytes() for c in b.cols for x in (c.data, c.valid)]


def test_persistent_device_batch_reuses_buffers():
    """ScanOp's decode into the table's own buffers: one buffer per
    column index, shared by every column list and kept at its address
    across decodes and writes, equal slot for slot to the reference's
    decode before and after a write."""
    cols = ("qty", "id", "ratio")
    batches = {}
    for P in PKGS:
        db, cat, t, rows = setup(P, n=40)
        first = (t.device_batch(persistent=True) if P is T
                 else t.device_batch())
        batches[P.name] = [_batch_bytes(first)]

        def upd(txn, t=t):
            t.insert(txn, {"id": 3, "qty": 7})
            t.delete_pk(txn, 5)

        db.txn(upd)
        if P is T:
            ptrs = {n: first.cols[t.schema.index(n)].data.data_ptr()
                    for n in cols}
            mask = first.mask.data_ptr()
            again = t.device_batch(cols, persistent=True)
            assert [c.data.data_ptr() for c in again.cols] == [
                ptrs[n] for n in cols]
            assert again.mask.data_ptr() == mask
            assert _batch_bytes(again) == _batch_bytes(t.device_batch(cols))
        batches[P.name].append(_batch_bytes(
            t.device_batch(cols, persistent=True) if P is T
            else t.device_batch(cols)))
    assert batches["torch"] == batches["jax"]


def test_kv_scan_counts_its_intent_check():
    """A KV scan's decode reads the host once (the intent check): the
    table counts it and the scan's stats carry it into host_syncs."""
    from cockroach_tpu_torch.flow.runtime import host_syncs

    db, cat, t, rows = setup(T, n=20)
    before = t.host_syncs
    root = tbuilder.build(T.Rel.scan(cat, "items").scalar_agg(
        [("n", "count_rows", None)]).optimized_plan(), cat)
    assert int(trun(root)["n"][0]) == len(rows)
    scans = {k: v for k, v in host_syncs(root).items() if "ScanOp" in k}
    assert list(scans.values()) == [1]
    assert t.host_syncs - before >= 1


def test_kv_table_snapshot_abort_delete():
    for P in PKGS:
        db, cat, t, rows = setup(P, 10)
        ts0 = db.clock.now()
        db.txn(lambda txn: t.insert(txn, {**rows[0], "qty": 10_000}))
        q = P.Rel.scan(cat, "items").scalar_agg([("m", "max", "qty")])
        assert int(P.run(q)["m"][0]) == 10_000
        t.read_ts = ts0
        try:
            assert int(P.run(q)["m"][0]) == max(r["qty"] for r in rows)
        finally:
            t.read_ts = None

        def bad(txn):
            t.insert(txn, {"id": 999, "qty": 1})
            raise KeyError("boom")

        with pytest.raises(KeyError):
            db.txn(bad)
        db.txn(lambda txn: t.delete_pk(txn, rows[1]["id"]))
        n = P.Rel.scan(cat, "items").scalar_agg([("n", "count_rows", None)])
        assert int(P.run(n)["n"][0]) == len(rows) - 1
        assert t.num_rows == t.snapshot_live_rows() == len(rows) - 1
        assert t.get_row(rows[2]["id"])["qty"] == rows[2]["qty"]


def test_kv_table_null_columns():
    for P in PKGS:
        db = P.DB(P.Engine(key_width=16, val_width=P.rc.value_width(
            schema(P)), memtable_size=64), P.Clock())
        cat = P.Catalog()
        t = P.table.create_kv_table(cat, db, "items", schema(P), pk="id")

        def ins(txn):
            t.insert(txn, {"id": 1, "qty": 5})
            t.insert(txn, {"id": 2, "price": 300})

        db.txn(ins)
        res = P.run(P.Rel.scan(cat, "items").scalar_agg(
            [("cq", "count", "qty"), ("cp", "count", "price"),
             ("n", "count_rows", None)]))
        assert [int(res[k][0]) for k in ("cq", "cp", "n")] == [1, 1, 2]


def test_kv_scan_hits_intent_conflict():
    for P in PKGS:
        db, cat, t, rows = setup(P, 5)
        open_txn = db.new_txn()
        t.insert(open_txn, {**rows[2], "qty": 1})
        q = P.Rel.scan(cat, "items").scalar_agg([("n", "count_rows", None)])
        with pytest.raises(P.WIE):
            P.run(q)
        open_txn.rollback()
        assert int(P.run(q)["n"][0]) == 5


def _string_schema(P):
    cd = P.cd
    return cd.Schema.of(id=cd.INT64, qty=cd.INT64, price=cd.DECIMAL(12, 2),
                        tag=cd.STRING)


def test_bulk_load_and_import_job(tmp_path):
    """IMPORT: CSV rows land as sorted runs with vectorized dictionary
    encoding; the two packages' engines hold the same versions after the
    import and after a re-import at a higher timestamp with a NULL row;
    the port's query over the table agrees with the CSV."""
    path = str(tmp_path / "items.csv")
    n = 1000
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["id", "qty", "price", "tag"])
        w.writeheader()
        for i in range(n):
            w.writerow({"id": i, "qty": i % 97,
                        "price": f"{(i % 1000) + 0.25:.2f}",
                        "tag": f"t{i % 7}"})
    with open(path) as f:
        first = f.read()
    out = {}
    for P in PKGS:
        with open(path, "w") as f:
            f.write(first)
        db = P.DB(P.Engine(key_width=16, val_width=256, memtable_size=256),
                  P.Clock())
        cat = P.Catalog()
        t = P.table.create_kv_table(cat, db, "items", _string_schema(P),
                                    pk="id")
        reg = P.Registry(db)
        P.import_job(reg, cat)
        done = reg.adopt_and_resume(reg.create(
            "import", {"table": "items", "path": path}).job_id)
        assert done.state == "succeeded" and done.progress["rows"] == n
        assert t.num_rows == n
        rows = db.engine.export_span(None, None)
        with open(path, "a", newline="") as f:
            f.write(f"{n},,,t0\n")
        done2 = reg.adopt_and_resume(reg.create(
            "import", {"table": "items", "path": path}).job_id)
        assert done2.progress["rows"] == n + 1
        assert t.get_row(n) == {"id": n, "qty": None, "price": None,
                                "tag": "t0"}
        out[P.name] = (rows, db.engine.export_span(None, None),
                       t.get_row(1234), cat)
    for i in (0, 1):
        for k in FIELDS + ("ts", "seq"):
            assert (out["torch"][i][k].tobytes()
                    == np.asarray(out["jax"][i][k]).tobytes()), k
    assert out["torch"][2] == out["jax"][2]
    g = T.Rel.scan(out["torch"][3], "items").groupby(
        ["tag"], [("c", "count_rows", None), ("q", "sum", "qty")])
    res = T.run(g.sort([("tag", False)]))
    assert list(res["tag"]) == [f"t{i}" for i in range(7)]
    assert res["c"].tolist() == [(n - i - 1) // 7 + 1 + (i == 0)
                                 for i in range(7)]
    assert int(res["q"].sum()) == sum(i % 97 for i in range(n))


def test_descriptors_reload_catalog():
    """A fresh catalog over the same engine rediscovers the table, its
    dictionary and rows (the bootstrap path), from either package's
    descriptors."""
    db = tDB(tEngine(key_width=16, val_width=64, device="cpu"), tClock())
    cat = tcatalog.Catalog("cpu")
    t = ttable.create_kv_table(cat, db, "ls", _string_schema(T), pk="id")
    long_s = "the quick brown fox jumps over the lazy dog " * 4
    db.txn(lambda txn: t.insert_rows(txn, {
        "id": np.array([1, 2]), "qty": np.array([3, 4]),
        "price": np.array([5, 6]),
        "tag": np.array([long_s, "short"], dtype=object)}))
    fresh = tcatalog.Catalog("cpu")
    assert ttable.load_catalog_from_engine(fresh, db) == ["ls"]
    assert fresh.tables["ls"].get_row(1)["tag"] == long_s
    assert fresh.tables["ls"].get_row(2) == t.get_row(2)
    assert fresh.tables["ls"].schema == t.schema
    with pytest.raises(ValueError, match="already in use"):
        ttable.create_kv_table(cat, db, "x", _string_schema(T), pk="id",
                               table_id=t.table_id)


def test_scan_stream_guard_keeps_kv_tables_whole():
    """Under a streaming threshold below the table's rows, a KV table still
    decodes whole (it has no host columns to stream), as in the
    reference."""
    n = 1500
    rows = rows_of(n)
    cols = {k: np.array([r[k] for r in rows]) for k in rows[0]}
    out = {}
    for P in PKGS:
        db = P.DB(P.Engine(key_width=16, val_width=P.rc.value_width(
            schema(P))), P.Clock())
        cat = P.Catalog()
        t = P.table.create_kv_table(cat, db, "items", schema(P), pk="id")
        t.bulk_load(cols)
        P.settings.set("sql.distsql.scan_stream_rows", 1024)
        try:
            out[P.name] = P.run(_count_rel(P, cat))
        finally:
            P.settings.set("sql.distsql.scan_stream_rows", 1 << 23)
    same(out["torch"], out["jax"])


# ------------------------------------------------------------- TPC-H


def load_reference(jhost, clock):
    """tpch_kv.load_tpch_kv through the reference's KV layer. One
    compaction at the end, with write pacing off, leaves the same versions
    as the port's compaction after each table."""
    width = max(jrc.value_width(_ref_schema(jhost.get(n)))
                for n in tpch_kv.TABLES)
    db = jDB(jEngine(key_width=16, val_width=width, memtable_size=1 << 20),
             clock)
    cat = jcatalog.Catalog()
    jsettings.set("admission.io_pacing.enabled", False)
    try:
        for name in tpch_kv.TABLES:
            ht = jhost.get(name)
            t = jtable.create_kv_table(cat, db, name, _ref_schema(ht),
                                       tpch_kv.PRIMARY[name])
            cols = {c: (ht.dictionaries[c].values[np.asarray(a)]
                        if c in ht.dictionaries else np.asarray(a))
                    for c, a in ht.columns.items()}
            key = tpch_kv._key_column(name, ht.columns)
            if key is not None:
                cols[tpch_kv.PRIMARY[name]] = key
            t.bulk_load(cols)
    finally:
        jsettings.set("admission.io_pacing.enabled", True)
    db.engine.compact(bottom=True)
    return cat, db


def _ref_schema(t):
    if tpch_kv.PRIMARY[t.name] in t.schema.names:
        return t.schema
    return jcd.Schema(t.schema.names + (tpch_kv.PRIMARY[t.name],),
                      t.schema.types + (jcd.INT64,))


def ref_refresh(cat, db, rf):
    """apply_rf1 then apply_rf2 (two transactions each) through the
    reference's KV layer."""
    o, li = cat.tables["orders"], cat.tables["lineitem"]
    ro, rl = rf["rf1_orders"], rf["rf1_lineitem"]
    for idx in tpch_kv._chunks(len(ro["o_orderkey"]), 2):
        lsel = np.isin(rl["l_orderkey"], ro["o_orderkey"][idx])

        def rf1(t, idx=idx, lsel=lsel):
            o.insert_rows(t, {c: a[idx] for c, a in ro.items()})
            li.insert_rows(t, {c: a[lsel] for c, a in rl.items()})

        db.txn(rf1)
    gone, lkeys = rf["rf2_orders"], rf["rf2_lineitem"]
    for idx in tpch_kv._chunks(len(gone), 2):
        def rf2(t, idx=idx):
            for k in lkeys[np.isin(lkeys >> 3, gone[idx])]:
                li.delete_pk(t, int(k))
            for k in gone[idx]:
                o.delete_pk(t, int(k))

        db.txn(rf2)


@pytest.fixture(scope="module")
def tpch_kv_runs():
    """q1, q3, q9, q18 over KV through both packages before RF1 and RF2,
    through the port after them (the two engines then hold the same
    versions), with the port's host-table runs and the oracles."""
    thost = ttpch.gen_tpch(sf=SF, seed=SEED, device="cpu")
    jhost = jtpch.gen_tpch(sf=SF, seed=SEED)
    tcat, tdb, load = tpch_kv.load_tpch_kv(thost, device="cpu",
                                           clock=tClock())
    jcat, jdb = load_reference(jhost, jClock())
    out = {"load": load,
           "host_rows": sum(thost.get(n).num_rows for n in tpch_kv.TABLES),
           "loaded": (tdb.engine.export_span(None, None),
                      jdb.engine.export_span(None, None))}

    def port(cat):
        return {q: trun(tbuilder.build(tQ.QUERIES[q](cat).optimized_plan(),
                                       cat)) for q in LADDER}

    out["before"] = (port(tcat), {
        q: jrun(jbuilder.build(jQ.QUERIES[q](jcat).optimized_plan(), jcat))
        for q in LADDER}, port(thost), thost)
    rf = tpch_kv.gen_refresh(thost, SF)
    out["rf1"] = tpch_kv.apply_rf1(tcat, tdb, rf, txns=2)
    out["rf2"] = tpch_kv.apply_rf2(tcat, tdb, rf, txns=2)
    ref_refresh(jcat, jdb, rf)
    out["refreshed"] = (tdb.engine.export_span(None, None),
                        jdb.engine.export_span(None, None))
    host_after = tpch_kv.refreshed_catalog(thost, rf)
    out["after"] = (port(tcat), None, port(host_after), host_after)
    return out


@pytest.mark.parametrize("when", ["loaded", "refreshed"])
def test_tpch_engine_versions_match_reference(tpch_kv_runs, when):
    """Every version in the engine after the load, and after RF1 and RF2,
    equals the reference's: keys, values, tombstones (the load's
    timestamps and sequences too)."""
    got, want = tpch_kv_runs[when]
    fields = FIELDS + (("ts", "seq") if when == "loaded" else ())
    for k in fields:
        assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k
    load = tpch_kv_runs["load"]
    assert load["rows"] == tpch_kv_runs["host_rows"]
    assert load["runs"] == 1 and set(load["parts_s"]) == {
        "dicts", "encode", "runs", "compaction"}


@pytest.mark.parametrize("tag", ["before", "after"])
@pytest.mark.parametrize("q", LADDER)
def test_tpch_over_kv_matches_reference(tpch_kv_runs, q, tag):
    """Over KV equal to the oracle of the data as it stands and to the
    host-table run; before the refresh, equal to the reference's run over
    its own KV tables."""
    got, ref, host, oracle_cat = tpch_kv_runs[tag]
    floats = tpch_oracle.FLOAT_COLUMNS[q]
    assert tpch_oracle.mismatch(q, got[q], tpch_oracle.ORACLES[q](
        oracle_cat)) is None
    same(got[q], host[q], floats)
    if ref is not None:
        same(got[q], {k: (np.asarray(v, dtype=object)
                          if np.asarray(v).dtype.kind in "US" else v)
                      for k, v in ref[q].items()}, floats)


def test_refresh_functions_counts(tpch_kv_runs):
    n = round(1500 * SF)
    for rf in ("rf1", "rf2"):
        r = tpch_kv_runs[rf]
        assert r["txns"] == 2 and r["retries"] == 0 and r["rows"] > n
