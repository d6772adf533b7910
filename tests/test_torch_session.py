"""The port's Session (cockroach_tpu_torch/sql/session.py, plancache.py,
stats.py) against the reference's on the CPU: DML in explicit
transactions with the aborted-block discipline, CREATE INDEX and its use,
ANALYZE with statistics persisted and reloaded — each statement's result
equal to the reference's and the engine's versions afterwards byte-equal
(both engines on a manual clock); the plan cache rebinding q6's literals
into one entry; the statements ported since (ALTER TABLE, tenant DDL,
BACKUP, RESTORE) equal to the reference and the typed error of the one
whose module is not; sessions on four threads giving the results of one; and the
mixed serving load reading back every acknowledged insert."""

import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from cockroach_tpu.flow import memory as jmemory
from cockroach_tpu.utils import admission as jadmission
from cockroach_tpu.utils import settings as jsettings
from cockroach_tpu.utils.errors import AdmissionRejectedError as jRejected
from cockroach_tpu.kv import DB as jDB
from cockroach_tpu.kv import ManualClock as jClock
from cockroach_tpu.sql import Session as jSession
from cockroach_tpu.sql import explain as jexplain
from cockroach_tpu.storage.lsm import Engine as jEngine
from cockroach_tpu.utils import external_storage as jext
from cockroach_tpu_torch.bench import tpch as ttpch
from cockroach_tpu_torch.bench.load import run_mixed_load
from cockroach_tpu_torch.bench.tpch_sql import TPCH_SQL
from cockroach_tpu_torch.flow import dispatch
from cockroach_tpu_torch.flow import memory as tmemory
from cockroach_tpu_torch.kv import DB as tDB
from cockroach_tpu_torch.kv import ManualClock as tClock
from cockroach_tpu_torch.sql import BindError, Session, UnportedError
from cockroach_tpu_torch.sql import explain, plancache
from cockroach_tpu_torch.storage.lsm import Engine as tEngine
from cockroach_tpu_torch.utils import admission as tadmission
from cockroach_tpu_torch.utils import external_storage as text
from cockroach_tpu_torch.utils import settings as tsettings
from cockroach_tpu_torch.utils.errors import (
    AdmissionRejectedError as tRejected)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These small tables gain nothing from intra-op threads, and several
    test workers' thread pools on shared cores slow each other down."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


FIELDS = ("key", "ts", "seq", "txn", "tomb", "value", "vlen")


def pair():
    """A reference session and a port session (on the CPU), each over a
    fresh 24-byte-key store with a manual clock."""
    j = jSession(db=jDB(jEngine(key_width=24, val_width=128,
                                memtable_size=4096), jClock()))
    t = Session(db=tDB(tEngine(key_width=24, val_width=128,
                               memtable_size=4096, device="cpu"), tClock()),
                device="cpu")
    return j, t


def run_both(j, t, stmt):
    """Execute in both; the outcomes (result columns, or the error's
    type name and message) must be equal."""
    outs = []
    for s in (j, t):
        try:
            outs.append(("ok", s.execute(stmt)))
        except Exception as e:  # noqa: BLE001 - the error is the outcome
            outs.append(("err", (type(e).__name__, str(e))))
    (jk, jv), (tk, tv) = outs
    assert tk == jk, (stmt, jv, tv)
    if jk == "err":
        assert tv == jv, stmt
        return tv
    assert list(tv) == list(jv), stmt
    for c in jv:
        w, g = np.asarray(jv[c]), np.asarray(tv[c])
        assert g.shape == w.shape, (stmt, c)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=stmt)
        else:
            assert g.tolist() == w.tolist(), (stmt, c)
    return tv


def engines_equal(j, t):
    """Every version in the two engines equal: keys, timestamps,
    sequences, txn words, tombstones, values and lengths."""
    got = t.db.engine.export_span(None, None)
    want = j.db.engine.export_span(None, None)
    for k in FIELDS:
        assert np.asarray(got[k]).tobytes() == np.asarray(
            want[k]).tobytes(), k


TXN_SCRIPT = (
    "create table acct (id int primary key, bal decimal(12, 2), tag string)",
    "insert into acct values (1, 10.50, 'a'), (2, 20.00, 'b'), "
    "(3, 0.25, 'a')",
    "begin",
    "update acct set bal = bal - 1.50 where id = 1",
    "update acct set bal = bal + 1.50 where id = 2",
    "select id, bal from acct order by id",
    "commit",
    "begin",
    "insert into acct values (4, 4.00, 'c')",
    "delete from acct where tag = 'a'",
    "select count(*) as n from acct",
    "rollback",
    "select id, bal, tag from acct order by id",
    "begin",
    "insert into acct values (5, 5.00, 'd')",
    "select nope from acct",
    "select id from acct",
    "insert into acct values (6, 6.00, 'e')",
    "commit",
    "select id, tag from acct order by id",
    "begin",
    "create table nope (a int primary key)",
    "rollback",
    "commit",
    "delete from acct where bal > 10",
    "update acct set tag = 'z' where id = 3",
    "select id, bal, tag from acct order by id",
)


def test_dml_in_transactions_matches_reference():
    j, t = pair()
    outs = [run_both(j, t, s) for s in TXN_SCRIPT]
    # the aborted block: the statement after the error is refused
    assert "current transaction is aborted" in outs[16][1]
    assert outs[18] == {"rollback": True}
    engines_equal(j, t)


def test_create_index_and_use_match_reference():
    j, t = pair()
    run_both(j, t, "create table ix (id int primary key, g int, s string)")
    rows = ", ".join(f"({i}, {i % 17}, 's{i % 5}')" for i in range(300))
    run_both(j, t, f"insert into ix values {rows}")
    run_both(j, t, "create index ix_g on ix (g)")
    q = "select id, s from ix where g = 3 order by id"
    got = run_both(j, t, q)
    assert got["id"].tolist() == [i for i in range(300) if i % 17 == 3]
    assert "IndexScan" in repr(_plan(t, q)), "the index is not used"
    assert explain(t.catalog, q) == jexplain(j.catalog, q)
    run_both(j, t, "insert into ix values (1000, 3, 'new')")
    run_both(j, t, "update ix set g = 3 where id = 1")
    run_both(j, t, "delete from ix where id = 20")
    run_both(j, t, q)
    run_both(j, t, "drop index ix_g")
    run_both(j, t, q)
    run_both(j, t, "create index ix_g on nope (g)")
    engines_equal(j, t)


def _plan(sess, q):
    from cockroach_tpu_torch.sql import sql

    return sql(sess.catalog, q).optimized_plan()


def test_analyze_persists_and_reloads(monkeypatch):
    import time as _time

    # the statistics' creation time is wall time: fix it in both packages
    monkeypatch.setattr(_time, "time", lambda: 1.7e9)
    j, t = pair()
    run_both(j, t, "create table st (id int primary key, g int, "
                   "d decimal(10, 2), s string)")
    rows = ", ".join(f"({i}, {i % 7}, {i * 0.25:.2f}, 'v{i % 3}')"
                     for i in range(200))
    run_both(j, t, f"insert into st values {rows}")
    run_both(j, t, "insert into st values (500, null, null, null)")
    run_both(j, t, "analyze st")
    run_both(j, t, "show statistics for table st")
    run_both(j, t, "create statistics s1 from st")
    engines_equal(j, t)
    st = t.catalog.tables["st"].table_stats
    assert st.row_count == 201 and st.cols["g"].null_count == 1
    assert t.catalog.tables["st"].estimated_rows() == 201
    # a new session over the same store reloads the persisted statistics
    t2 = Session(db=t.db, device="cpu")
    st2 = t2.catalog.tables["st"].table_stats
    assert st2 is not None and st2.to_json() == st.to_json()
    j2 = jSession(db=j.db)
    assert st2.to_json() == j2.catalog.tables["st"].table_stats.to_json()


@pytest.fixture(scope="module")
def tcat():
    return ttpch.gen_tpch(sf=0.005, seed=7, device="cpu")


Q6 = TPCH_SQL["q6"]
Q6_LITERALS = (("0.06", "24"), ("0.05", "25"), ("0.07", "23"))


def q6_text(discount, quantity):
    return chip_smoke.q6_text(Q6, float(discount), int(quantity))


def test_plan_cache_rebinds_q6_literals(tcat):
    assert "between 0.05 and 0.07" in Q6 and "< 24" in Q6
    sess = Session(catalog=tcat, device="cpu")
    cache = plancache.cache_for(tcat)
    cache.clear()
    results = []
    c0 = None
    for disc, qty in Q6_LITERALS:
        results.append(sess.execute(q6_text(disc, qty)))
        if c0 is None:
            c0 = dispatch.compiles()
    # one entry, two hits, and no new signature after the first run
    assert len(cache) == 1
    assert cache.hits == 2 and cache.misses == 1
    assert dispatch.compiles() == c0
    tsettings.set("sql.plan_cache.enabled", False)
    try:
        for (disc, qty), got in zip(Q6_LITERALS, results):
            want = sess.execute(q6_text(disc, qty))
            assert got["revenue"].tolist() == want["revenue"].tolist()
    finally:
        tsettings.reset("sql.plan_cache.enabled")
    assert len({r["revenue"][0] for r in results}) == 3
    # a verbatim repeat takes the memo path and still equals
    again = sess.execute(q6_text(*Q6_LITERALS[0]))
    assert again["revenue"].tolist() == results[0]["revenue"].tolist()
    # three serving-path hits: two rebinds and the memo
    assert cache.hits == 3
    sess.close()


@pytest.mark.parametrize("stmt,module", [
    ("alter table t add column z int", "sql/schemachange.py"),
    ("create tenant acme", "kv/tenant.py"),
    ("show tenants", "kv/tenant.py"),
    ("backup to 'nodelocal://1/b'", "kv/jobs.py"),
    ("restore from 'nodelocal://1/b'", "kv/jobs.py"),
    ("select range_id from crdb_internal.hot_ranges", "kv/loadstats.py"),
])
def test_unported_statement_raises_typed_error(stmt, module, tmp_path):
    """Every statement's module is now ported: each gives the reference's
    result (or error) and leaves byte-equal engines. The hot_ranges case
    holds crdb_internal.hot_ranges to the reference over a single-store
    session and over a DistSender session (kv/dist.py), and keeps the
    UnportedError mechanism, now with nothing listed: a table named in
    ``UNPORTED`` raises it, an unknown one fails as in the reference."""
    saved = [(ext, ext._NODELOCAL_BASE) for ext in (jext, text)]
    for ext, _ in saved:
        ext.set_nodelocal_base(str(tmp_path))
    try:
        j, t = pair()
        run_both(j, t, "create table t (a int primary key)")
        if module == "kv/loadstats.py":
            hot_ranges_parity(j, t, stmt)
        else:
            if stmt.startswith("restore"):
                run_both(j, t, "backup to 'nodelocal://1/b'")
                run_both(j, t, "insert into t values (7)")
            run_both(j, t, stmt)
            engines_equal(j, t)
    finally:
        for ext, base in saved:
            ext.set_nodelocal_base(base)
    assert isinstance(UnportedError("x", module), BindError)
    # the session goes on serving
    assert t.execute("select count(*) as n from t")["n"].tolist() == [0]


def hot_ranges_parity(j, t, stmt):
    from cockroach_tpu.kv import dist as jdist
    from cockroach_tpu_torch.kv import dist as tdist
    from cockroach_tpu_torch.sql import crdb_internal

    assert crdb_internal.UNPORTED == {}
    run_both(j, t, stmt)
    engines_equal(j, t)
    sessions = []
    for dist, sess, kw in ((jdist, jSession, {}),
                           (tdist, Session, {"device": "cpu"})):
        meta = dist.Meta(first_store=1)
        stores = [dist.Store(i + 1, meta, key_width=24, val_width=128,
                             memtable_size=4096, **kw) for i in range(2)]
        ds = dist.DistSender(stores, meta)
        clock = (jClock if dist is jdist else tClock)()
        db = (jDB if dist is jdist else tDB)(ds, clock)
        sessions.append((sess(db=db, **kw), ds, stores))
    (jd, jds, jst), (td, tds, tst) = sessions
    run_both(jd, td, "create table h (a int primary key)")
    run_both(jd, td, "insert into h values (1), (2), (3)")
    for ds in (jds, tds):
        ds.split_at(b"\x05")
        ds.move_range(ds.meta.lookup(b"\x05").range_id, 2)
    got = run_both(jd, td, "select range_id, start_key, end_key, store_id, "
                           "qps, size_bytes, leaseholder "
                           "from crdb_internal.hot_ranges")
    assert got["range_id"].tolist() == [1, 2]
    assert got["store_id"].tolist() == [1, 2]
    for js, ts_ in zip(jst, tst):
        want = js.engine.export_span(None, None)
        have = ts_.engine.export_span(None, None)
        for k in FIELDS:
            assert np.asarray(have[k]).tobytes() == np.asarray(
                want[k]).tobytes(), k
    # the mechanism stays: a listed table raises the typed error naming
    # its module; an unknown name fails as the reference's does
    crdb_internal.UNPORTED["crdb_internal.not_yet"] = "kv/x.py"
    try:
        with pytest.raises(UnportedError, match=r"kv/x\.py"):
            t.execute("select a from crdb_internal.not_yet")
    finally:
        crdb_internal.UNPORTED.clear()
    run_both(j, t, "select a from crdb_internal.no_such_table")


@pytest.mark.parametrize("stmt,want", [
    ("create materialized view v as select a from t", "grouped aggregate"),
    ("refresh materialized view v", "unknown materialized view"),
    ("select name from crdb_internal.node_materialized_views",
     "unknown column"),
])
def test_matview_statements_are_ported(stmt, want):
    """The statements sql/matview.py answers no longer raise
    UnportedError: each meets the reference's own typed error here."""
    sess = Session(device="cpu")
    sess.execute("create table t (a int primary key)")
    with pytest.raises(BindError, match=want) as e:
        sess.execute(stmt)
    assert not isinstance(e.value, UnportedError)
    assert sess.execute("select count(*) as n from t")["n"].tolist() == [0]


def test_unported_entry_points_raise():
    """Session(tenant=...) is ported: an unknown tenant meets the
    reference's TenantError, a created one opens a scoped session."""
    j, t = pair()
    outs = []
    for s, make in ((j, lambda: jSession(db=j.db, tenant="acme")),
                    (t, lambda: Session(db=t.db, tenant="acme",
                                        device="cpu"))):
        try:
            make()
        except Exception as e:  # noqa: BLE001 - the error is the outcome
            outs.append((type(e).__name__, str(e)))
        s.execute("create tenant acme")
        outs.append(make().tenant)
    # [reference error, reference tenant, port error, port tenant]
    assert outs[2] == outs[0] and outs[0][0] == "TenantError"
    assert repr(outs[3]) == repr(outs[1])
    engines_equal(j, t)
    sess = Session(device="cpu")
    sess.execute("create table t (a int primary key)")
    # EXPLAIN ANALYZE (DEBUG) is ported: it names its bundle
    out = explain(sess.catalog, "explain analyze (debug) select a from t")
    assert out.splitlines()[-1].startswith("diagnostics bundle: ")


def test_crdb_internal_tables():
    sess = Session(device="cpu")
    sess.execute("create table t (a int primary key)")
    sess.execute("insert into t values (1), (2)")
    sess.execute("select a from t")
    got = sess.execute("select fingerprint, count from "
                       "crdb_internal.node_statement_statistics")
    assert "select a from t" in got["fingerprint"].tolist()
    got = sess.execute("select session_id from "
                       "crdb_internal.cluster_sessions")
    assert sess._session_id in got["session_id"].tolist()
    got = sess.execute("select name, level from "
                       "crdb_internal.node_memory_monitors")
    assert "root" in got["name"].tolist()
    # this statement is in flight while the table materializes
    got = sess.execute("select query, phase from "
                       "crdb_internal.cluster_queries")
    assert any("cluster_queries" in q for q in got["query"].tolist())
    got = sess.execute("select tenant_id, admitted from "
                       "crdb_internal.node_tenant_admission")
    assert 1 in got["tenant_id"].tolist()
    sess.close()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_entry_points_default_to_the_card():
    from cockroach_tpu_torch.server.pgwire import PgServer

    with pytest.raises(RuntimeError, match="cuda"):
        Session()
    with pytest.raises(RuntimeError, match="cuda"):
        PgServer()
    with pytest.raises(RuntimeError, match="cuda"):
        run_mixed_load(sessions=1, duration_s=0.1)


THREAD_QUERIES = (
    [TPCH_SQL["q1"], TPCH_SQL["q3"], TPCH_SQL["q18"]]
    + [q6_text(d, q) for d, q in Q6_LITERALS])


def _run_all(sess):
    return [sess.execute(q) for q in THREAD_QUERIES]


def _same(a, b):
    for x, y in zip(a, b):
        assert list(x) == list(y)
        for c in x:
            assert np.asarray(x[c]).tolist() == np.asarray(y[c]).tolist(), c


def test_four_threads_equal_one(tcat):
    plancache.cache_for(tcat).clear()
    one = _run_all(Session(catalog=tcat, device="cpu"))
    outs, errs = {}, []

    def worker(i):
        sess = Session(catalog=tcat, device="cpu")
        try:
            for rep in range(2):
                outs[(i, rep)] = _run_all(sess)
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(e)
        finally:
            sess.close()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not errs, errs
    assert len(outs) == 8
    for got in outs.values():
        _same(got, one)


def test_mixed_load_reads_back_every_insert():
    out = run_mixed_load(sessions=4, duration_s=1.5, sf=0.002, n_keys=256,
                         device="cpu")
    assert out["errors"] == 0, out["last_error"]
    assert out["threads_alive"] == 0
    assert out["inserts"] > 0 and out["point_ops"] > 0
    assert out["analytic_ops"] > 0
    assert out["readback_ok"] and out["missing_inserts"] == 0
    # every statement's query waited for the device lock, and is timed
    assert out["exec_lock_waits"] >= out["point_ops"] + out["analytic_ops"]
    assert out["p99_stmt_ms"] > 0 and out["p99_point_ms"] > 0
    assert out["p99_exec_wait_ms"] >= 0


def test_exec_lock_times_the_outermost_wait():
    """A query that waits for the device lock records its wait once;
    a re-entrant acquire (a subquery run inside a query) records none."""
    from cockroach_tpu_torch.utils import metric

    h = metric.EXEC_LOCK_WAIT_SECONDS
    held, go = threading.Event(), threading.Event()

    def holder():
        with dispatch.exec_lock():
            held.set()
            go.wait(10)
            time.sleep(0.05)

    th = threading.Thread(target=holder)
    th.start()
    assert held.wait(10)
    n0, s0 = h.n, h.sum
    go.set()
    with dispatch.exec_lock():
        with dispatch.exec_lock():
            pass
    th.join(10)
    assert h.n == n0 + 1 and h.sum - s0 >= 0.05


def test_plan_cache_evicts_past_its_size(tcat):
    sess = Session(catalog=tcat, device="cpu")
    cache = plancache.cache_for(tcat)
    cache.clear()
    tsettings.set("sql.plan_cache.size", 1)
    try:
        sess.execute(TPCH_SQL["q6"])
        ev = cache.evictions
        sess.execute(TPCH_SQL["q14"])
        assert len(cache) == 1 and cache.evictions == ev + 1
    finally:
        tsettings.reset("sql.plan_cache.size")
    sess.close()


def test_plan_cache_evicts_past_its_byte_budget(tcat, monkeypatch):
    """Each plan holds device bytes between runs (here a count standing
    in for the card: 100 bytes a plan, at an address of its own); past
    ``MAX_DEVICE_FRACTION`` of the card's memory the least recently used
    plans go and their graphs are released, and a plan over the budget
    alone runs but is not kept."""
    capacity = [500]
    released = []
    monkeypatch.setattr(plancache, "_held_storages",
                        lambda entry, catalog: {id(entry.root): 100})
    monkeypatch.setattr(plancache, "_device_capacity",
                        lambda dev: capacity[0])
    monkeypatch.setattr(dispatch, "release_graphs",
                        lambda sink: released.append(sink) or 0)
    sess = Session(catalog=tcat, device="cpu")
    cache = plancache.cache_for(tcat)
    cache.clear()
    ev = cache.evictions
    del released[:]  # what the clear released
    try:
        assert cache.budget() == 500 * plancache.MAX_DEVICE_FRACTION == 250
        want = {q: sess.execute(TPCH_SQL[q]) for q in ("q6", "q14", "q1")}
        # each miss holds 100 bytes after its first run
        assert len(cache) == 2 and cache.bytes == 200
        assert cache.evictions == ev + 1 and len(released) == 1
        hits = cache.hits
        sess.execute(TPCH_SQL["q14"] + " ")  # still cached, still 100
        assert cache.hits == hits + 1 and cache.bytes == 200
        capacity[0] = 100
        got = sess.execute(TPCH_SQL["q6"])
        assert len(cache) == 0 and cache.bytes == 0
        _same([got], [want["q6"]])
    finally:
        cache.clear()
    sess.close()


def test_release_graphs_drops_only_the_recorded_variants():
    """``release_graphs`` removes from a shared wrapper the graph variants
    a plan's runs recorded, and leaves the others (and dead ones) be."""
    import weakref

    class G:  # a stand-in for a captured variant
        pass

    k = dispatch.jit(lambda x: x)
    mine, other, gone = G(), G(), G()
    k._graphs["sig"] = [mine, other]
    sink = [(weakref.ref(k), "sig", weakref.ref(mine)),
            (weakref.ref(k), "sig", weakref.ref(gone))]
    del gone
    assert dispatch.release_graphs(sink) == 1
    assert k._graphs["sig"] == [other] and sink == []


def test_warmup_replays_hot_statements_after_ddl():
    """``sql.plan_cache.warmup.enabled``: DDL re-keys every cached plan,
    and a background session re-executes the recorded hot statements,
    so the next foreground run hits."""
    sess = Session(device="cpu")
    sess.execute("create table w (a int primary key, b int)")
    sess.execute("insert into w values (1, 10), (2, 20), (3, 30)")
    text = "select a, b from w where b > 15 order by a"
    want = sess.execute(text)
    tsettings.set("sql.plan_cache.warmup.enabled", True)
    try:
        sess.execute("create index w_b on w (b)")
        th = sess._warmup_thread
        assert th is not None
        th.join(timeout=60)
        assert not th.is_alive()
        cache = plancache.cache_for(sess.catalog)
        hits = cache.hits
        got = sess.execute(text)
        assert cache.hits == hits + 1
    finally:
        tsettings.reset("sql.plan_cache.warmup.enabled")
        sess.close()
    assert got["a"].tolist() == want["a"].tolist() == [2, 3]


def test_explain_analyze_reports_cache_and_admission(tcat):
    out = explain(tcat, "explain analyze " + TPCH_SQL["q6"])
    lines = out.splitlines()
    assert any(ln.startswith("plan cache: ") for ln in lines)
    assert any(ln.startswith("block cache: ") for ln in lines)
    assert any(ln.startswith("admission: lane=analytical") for ln in lines)


def _admission_script(adm, settings, memory, rejected):
    """One sequence of admissions through a package's admission plane;
    the outcomes, with refusal reasons (their retry-after hints are
    timing-dependent)."""
    out = [adm.classify_statement(t) for t in (
        "select sum(a) from t", "select a from t where k = 1",
        "insert into t values (1)", "COMMIT", "explain select count(*) "
        "from t join u on t.a = u.a")]
    q = adm.WorkQueue(slots=2)
    out += [q.admit(), q.admit(), q.admit(timeout=0.01), q.timeouts,
            q.in_use]
    q.release()
    out.append(q.in_use)
    q.configure_tenant(7, rate=1.0, burst=1)
    out.append(q.admit(tenant_id=7))
    q.release()
    try:
        q.admit(tenant_id=7)
        out.append("admitted")
    except rejected as e:
        out.append(e.reason)
    # queue depth: one waiter queued, the next tenant-aware admit refused
    q2 = adm.WorkQueue(slots=1, max_queue_depth=1)
    out.append(q2.admit())
    got = []
    th = threading.Thread(target=lambda: got.append(q2.admit(timeout=30)))
    th.start()
    while q2.queue_depth < 1:
        time.sleep(0.001)
    try:
        q2.admit(tenant_id=1)
    except rejected as e:
        out.append(e.reason.split(" (")[0])
    q2.release()
    th.join()
    out += got + [q2.in_use]
    q2.release()
    # shedding under memory pressure: LOW first, then NORMAL. The root
    # may already hold bytes of earlier tests' live objects: the budget
    # and the reservations are set against what it holds
    base = memory.ROOT.used
    budget = max(1 << 20, 4 * base)
    settings.set("sql.mem.root_budget_bytes", budget)
    mon = memory.BytesMonitor("test", parent=memory.ROOT)
    try:
        for frac in (0.5, 0.95, 0.99):
            mon.release()
            mon.reserve(int(frac * budget) - base, force=True)
            out.append(adm.shed_floor())
            for pri in (adm.LOW, adm.NORMAL, adm.HIGH):
                try:
                    q.admit(pri, tenant_id=9)
                    q.release()
                    out.append("ok")
                except rejected as e:
                    out.append(e.reason.split(":")[0])
    finally:
        mon.close()
        settings.reset("sql.mem.root_budget_bytes")
    return out


def test_admission_matches_reference():
    want = _admission_script(jadmission, jsettings, jmemory, jRejected)
    got = _admission_script(tadmission, tsettings, tmemory, tRejected)
    assert got == want
    assert "tenant rate limit: token bucket empty" in got
    assert "overloaded" in got


def test_dml_and_txn_selects_rebind_cached_plans():
    """An UPDATE's affected-row scan (its WHERE and SET literals) and a
    SELECT inside a transaction run through the plan cache: repeats with
    other literals make no new signature, and the rows equal the
    reference's."""
    j, t = pair()
    for s in (j, t):
        s.execute("create table t (a int primary key, b int)")
        s.execute("insert into t values (1, 10), (2, 20), (3, 30)")
    c0 = None
    for i, pk in enumerate((1, 2, 3)):
        for s in (j, t):
            s.execute(f"update t set b = b + {i + 5} where a = {pk}")
            s.execute("begin")
            got = s.execute(f"select b from t where a = {pk}")
            s.execute("commit")
            assert got["b"].tolist() == [10 * pk + i + 5]
        if c0 is None:
            c0 = dispatch.compiles()
    assert dispatch.compiles() == c0
    q = "select a, b from t order by a"
    assert t.execute(q)["b"].tolist() == j.execute(q)["b"].tolist() == [
        15, 26, 37]
