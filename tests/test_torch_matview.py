"""The port's materialized views (cockroach_tpu_torch/sql/matview.py,
flow/viewmaint.py) against the reference's on the CPU.

The same seeded statements run through both packages' Sessions: a view
equals the reference's view (FLOAT columns within rtol 1e-12, every other
column exactly) and the port's own fresh rescan (exactly), at CREATE and
after each of six rounds of inserts, updates and deletes; a retraction of
each aggregate kind, the min/max rescans counted as the reference counts
them; the rewrite and the EXPLAIN note as the reference's; both
``crdb_internal`` tables; out-of-bounds dictionary growth; a flush's
dispatches (at most one per shape class, with vmap's per-view fallback an
error and the capture guard on); reads during flushes; a restart; the
three ``matview.*`` fault sites; TPC-H q1 views over KV through RF1 and
RF2 at sf=0.005 in both packages; and the two bench drivers. Torch runs
on one thread."""

import re
import threading
import warnings

import numpy as np
import pytest
import torch

from cockroach_tpu.kv import ManualClock as jClock
from cockroach_tpu.sql import Session as jSession
from cockroach_tpu.sql import explain as jexplain
from cockroach_tpu.sql import matview as jmatview
from cockroach_tpu.utils import metric as jmetric
from cockroach_tpu.utils import settings as jsettings
from cockroach_tpu_torch.bench import tpch as ttpch
from cockroach_tpu_torch.bench import tpch_kv
from cockroach_tpu_torch.bench import views as tviews
from cockroach_tpu_torch.bench.fanout import run_fanout
from cockroach_tpu_torch.flow import dispatch, viewmaint
from cockroach_tpu_torch.flow import memory as flowmem
from cockroach_tpu_torch.kv import ManualClock as tClock
from cockroach_tpu_torch.sql import Session, explain, matview
from cockroach_tpu_torch.utils import faults, metric, racesan, settings
from cockroach_tpu_torch.utils.faults import FaultSpec, InjectedFault

Q = ("SELECT flag, sum(qty) AS sq, avg(price) AS ap, count(*) AS n "
     "FROM t WHERE d <= DATE '1998-06-15' GROUP BY flag ORDER BY flag")
Q2 = ("SELECT flag, count(*) AS n, count(qty) AS nq, sum(qty) AS sq, "
      "avg(price) AS ap, min(qty) AS mn, max(qty) AS mx "
      "FROM t WHERE d <= DATE '1999-01-01' GROUP BY flag ORDER BY flag")
FLOAT_COLS = ("ap",)


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


PORT = dict(name="torch", session=lambda: Session(val_width=160,
                                                  device="cpu"),
            settings=settings, matview=matview, explain=explain,
            metric=metric)
REF = dict(name="jax", session=lambda: jSession(val_width=160),
           settings=jsettings, matview=jmatview, explain=jexplain,
           metric=jmetric)


def _mk(P):
    s = P["session"]()
    s.execute("CREATE TABLE t (k INT PRIMARY KEY, flag STRING, "
              "qty DECIMAL(12,2), price DECIMAL(12,2), d DATE)")
    return s


def _seed_rows(s, n=40, flags="ABC"):
    for i in range(n):
        s.execute(
            f"INSERT INTO t VALUES ({i}, '{flags[i % len(flags)]}', "
            f"{i}.25, {i * 2}.50, DATE '1998-0{1 + i % 8}-0{1 + i % 9}')")


def _fresh(P, s, q=Q):
    """A fresh full rescan with the planner rewrite off (the port's only:
    the reference's own tests hold its views to its rescans)."""
    if P is REF:
        return None
    st = P["settings"]
    st.set("sql.matview.rewrite.enabled", False)
    try:
        return s.execute(q)
    finally:
        st.set("sql.matview.rewrite.enabled", True)


def _view(s, name="mv"):
    return s.execute(f"SELECT * FROM {name} ORDER BY flag")


def _rows(res):
    return {k: np.asarray(v) for k, v in res.items()}


def _exact(a, b, ctx=""):
    a, b = _rows(a), _rows(b)
    assert list(a) == list(b), (ctx, list(a), list(b))
    for k in a:
        assert np.array_equal(a[k], b[k]), (ctx, k, a[k], b[k])


def _like_ref(got, want, ctx=""):
    """Port result against the reference's: FLOAT columns within rtol
    1e-12 (Queue 3 item 2: the reference's XLA division lands an ULP
    off), everything else exactly."""
    got, want = _rows(got), _rows(want)
    assert list(got) == list(want), (ctx, list(got), list(want))
    for k in got:
        if k in FLOAT_COLS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0,
                                       err_msg=f"{ctx} {k}")
        else:
            assert np.array_equal(got[k], want[k]), (ctx, k, got[k],
                                                     want[k])


def _mixed_dml(P) -> dict:
    """The reference's mixed-DML scenario, recorded: the view and a fresh
    rescan at CREATE and after each round, then the EXPLAIN texts, the
    rewrite and the view table's rows."""
    s = _mk(P)
    _seed_rows(s)
    out = {"create": s.execute(f"CREATE MATERIALIZED VIEW mv AS {Q}"),
           "rounds": [(_view(s), _fresh(P, s))]}
    rng = np.random.default_rng(7)
    live = set(range(40))
    next_k = 100
    for rnd in range(6):
        for _ in range(int(rng.integers(1, 5))):  # inserts, some filtered
            f = "ABC"[int(rng.integers(0, 3))]
            mo = 1 + int(rng.integers(0, 12) % 9) % 8
            s.execute(
                f"INSERT INTO t VALUES ({next_k}, '{f}', "
                f"{int(rng.integers(0, 50))}.75, "
                f"{int(rng.integers(0, 99))}.25, DATE '1998-0{mo}-11')")
            live.add(next_k)
            next_k += 1
        for _ in range(int(rng.integers(1, 4))):  # updates
            k = int(rng.choice(sorted(live)))
            s.execute(f"UPDATE t SET qty = {int(rng.integers(0, 80))}.50,"
                      f" price = {int(rng.integers(0, 80))}.00 WHERE k = {k}")
        if rnd % 2 == 1:
            k = int(rng.choice(sorted(live)))
            s.execute(f"DELETE FROM t WHERE k = {k}")
            live.discard(k)
        out["rounds"].append((_view(s), _fresh(P, s)))

    def ex(text):
        return re.sub(r"frontier=\d+", "frontier=N",
                      P["explain"](s.catalog, text))

    out["explain"] = (ex("EXPLAIN SELECT * FROM mv"), ex("EXPLAIN " + Q),
                      ex("EXPLAIN " + Q.replace("1998-06-15", "1998-04-15")))
    hits = P["metric"].MATVIEW_REWRITE_HITS
    h0 = hits.value
    out["rewrite"] = s.execute(Q.replace("SELECT", "select"))
    other = Q.replace("1998-06-15", "1998-04-15")
    out["other"] = (s.execute(other), _fresh(P, s, other))
    out["rewrite_hits"] = hits.value - h0
    out["vtable"] = s.execute(
        "SELECT view, base_table, groups, minmax_rescans, full_rescans "
        "FROM crdb_internal.node_materialized_views")
    P["matview"].close_all(s.catalog)
    return out


@pytest.fixture(scope="module")
def mixed():
    return {"jax": _mixed_dml(REF), "torch": _mixed_dml(PORT)}


def test_create_equals_rescan_and_reference(mixed):
    assert mixed["torch"]["create"]["created_view"] == "mv"
    view, fresh = mixed["torch"]["rounds"][0]
    _exact(view, fresh, "create")
    _like_ref(view, mixed["jax"]["rounds"][0][0], "create")


@pytest.mark.parametrize("rnd", range(1, 7))
def test_mixed_dml_round(mixed, rnd):
    """After each round: port view == port rescan == reference view."""
    view, fresh = mixed["torch"]["rounds"][rnd]
    _exact(view, fresh, f"round {rnd}")
    _like_ref(view, mixed["jax"]["rounds"][rnd][0], f"round {rnd}")


def test_explain_note_equals_reference(mixed):
    got, want = mixed["torch"]["explain"], mixed["jax"]["explain"]
    assert got == want
    assert got[0].splitlines()[0].startswith(
        "served from materialized view mv (frontier=")
    assert got[1].splitlines()[0].endswith(", rewrite)")
    assert "materialized view" not in got[2]


def test_rewrite_serves_from_view_as_reference(mixed):
    t, j = mixed["torch"], mixed["jax"]
    assert t["rewrite_hits"] == j["rewrite_hits"] == 1
    _exact(t["rewrite"], t["rounds"][-1][0], "rewrite")
    _like_ref(t["rewrite"], j["rewrite"], "rewrite")
    _exact(*t["other"], "other literal")
    _like_ref(t["other"][0], j["other"][0], "other literal")


def test_views_table_equals_reference(mixed):
    _exact(mixed["torch"]["vtable"], mixed["jax"]["vtable"], "vtable")
    assert _rows(mixed["torch"]["vtable"])["groups"].tolist() == [3]


def _retractions(P) -> list:
    s = _mk(P)
    _seed_rows(s)
    s.execute(f"CREATE MATERIALIZED VIEW mv AS {Q2}")
    reg = P["matview"].registry_for(s.catalog)
    out = []
    for stmt in ("DELETE FROM t WHERE k = 3",          # interior: native
                 "UPDATE t SET qty = 99.99 WHERE k = 12",  # raises a max
                 "DELETE FROM t WHERE k = 12",         # the max itself
                 "DELETE FROM t WHERE k = 0"):         # a group's min
        s.execute(stmt)
        view = _view(s)
        (row,) = reg.rows()
        out.append((view, _fresh(P, s, Q2), row["minmax_rescans"],
                    row["full_rescans"]))
    P["matview"].close_all(s.catalog)
    return out


@pytest.fixture(scope="module")
def retractions():
    return {"jax": _retractions(REF), "torch": _retractions(PORT)}


@pytest.mark.parametrize("step", range(4))
def test_retraction_per_aggregate_kind(retractions, step):
    """count/sum/avg retract natively; deleting a group's extremum ends
    in a min/max rescan, counted as the reference counts it."""
    view, fresh, mm, full = retractions["torch"][step]
    jview, _jfresh, jmm, jfull = retractions["jax"][step]
    _exact(view, fresh, f"step {step}")
    _like_ref(view, jview, f"step {step}")
    assert (mm, full) == (jmm, jfull)
    assert mm == (0, 0, 1, 2)[step]


@pytest.fixture
def sess():
    s = _mk(PORT)
    yield s
    matview.close_all(s.catalog)
    s.close()


def _oracle(s, q=Q):
    return _fresh(PORT, s, q)


def test_oob_group_key_rebuilds(sess):
    _seed_rows(sess)
    sess.execute(f"CREATE MATERIALIZED VIEW mv AS {Q}")
    reg = matview.registry_for(sess.catalog)
    (row,) = reg.rows()
    full0 = row["full_rescans"]
    sess.execute("INSERT INTO t VALUES (500, 'ZED', 1.00, 2.00, "
                 "DATE '1998-01-05')")
    _exact(_oracle(sess), _view(sess), "new dictionary value")
    (row,) = reg.rows()
    assert row["full_rescans"] == full0 + 1 and row["groups"] == 4


def test_flush_is_one_dispatch_per_shape_class(sess, monkeypatch):
    """Two shape classes, five views: one dispatch per class per flush, no
    base rescan, every frontier advanced — with vmap's per-view fallback
    turned into an error, its warnings into errors, and each new signature
    run under the CUDA-graph capture guard. A small one-hot budget makes
    the delta kernel walk the views in chunks, with the same result."""
    _seed_rows(sess)
    dates = ("1998-03-15", "1998-06-15", "1998-08-15")
    for i, d in enumerate(dates):
        sess.execute(f"CREATE MATERIALIZED VIEW mv{i} AS "
                     + Q.replace("1998-06-15", d))
    for i, d in enumerate(dates[:2]):
        sess.execute(f"CREATE MATERIALIZED VIEW mm{i} AS "
                     + Q2.replace("1999-01-01", d))
    m = matview.registry_for(sess.catalog).maintainers["t"]
    assert len(m.classes) == 2
    fallback = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        for rnd, budget in enumerate((viewmaint.ONEHOT_BYTES, 1 << 12)):
            monkeypatch.setattr(viewmaint, "ONEHOT_BYTES", budget)
            for i in range(6):
                k = 300 + 10 * rnd + i
                sess.execute(f"INSERT INTO t VALUES ({k}, 'A', 1.25, "
                             f"2.50, DATE '1998-0{2 + i}-03')")
            sess.execute(f"DELETE FROM t WHERE k = {7 + rnd}")
            m.pump()
            assert m.pending()
            d0 = dispatch.total()
            full0 = metric.MATVIEW_FULL_RESCANS.value
            mm0 = metric.MATVIEW_MINMAX_RESCANS.value
            fr0 = [v.frontier for v in m.views()]
            with dispatch.capture_checks(), warnings.catch_warnings():
                warnings.simplefilter("error")
                assert m.flush()
            assert dispatch.total() - d0 == len(m.classes)
            assert metric.MATVIEW_FULL_RESCANS.value == full0
            assert metric.MATVIEW_MINMAX_RESCANS.value == mm0
            assert all(v.frontier > f for v, f in zip(m.views(), fr0))
            if budget < 1 << 20:
                cls = next(iter(m.classes.values()))
                assert cls.view_chunk(64) < cls.cap
            for i, d in enumerate(dates):
                _exact(_oracle(sess, Q.replace("1998-06-15", d)),
                       _view(sess, f"mv{i}"), f"mv{i} {budget}")
            for i, d in enumerate(dates[:2]):
                q2 = Q2.replace("1999-01-01", d)
                _exact(_oracle(sess, q2), _view(sess, f"mm{i}"),
                       f"mm{i} {budget}")
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(fallback)


def test_concurrent_reads_during_flush(sess):
    """Readers racing the flushes always see one frontier: every qty is
    2.00, so sum(qty) == 2 * count(*) holds at every frontier."""
    qc = ("SELECT flag, count(*) AS n, sum(qty) AS sq FROM t "
          "WHERE d <= DATE '1999-01-01' GROUP BY flag ORDER BY flag")
    for i in range(20):
        sess.execute(f"INSERT INTO t VALUES ({i}, '{'AB'[i % 2]}', 2.00, "
                     f"4.00, DATE '1998-01-0{1 + i % 9}')")
    sess.execute(f"CREATE MATERIALIZED VIEW mv AS {qc}")
    reader = Session(catalog=sess.catalog, db=sess.db, bootstrap=False,
                     device="cpu")
    stop = threading.Event()
    errors = []

    def read_loop():
        while not stop.is_set():
            try:
                res = reader.execute("SELECT * FROM mv ORDER BY flag")
                n = np.asarray(res["n"], dtype=np.float64)
                sq = np.asarray(res["sq"], dtype=np.float64)
                if not np.array_equal(sq, 2.0 * n):
                    errors.append(("torn", sq.tolist(), n.tolist()))
            except Exception as e:  # noqa: BLE001 - surfaced below
                errors.append(("raise", repr(e)))

    th = threading.Thread(target=read_loop, daemon=True)
    th.start()
    try:
        for i in range(20):
            sess.execute(f"INSERT INTO t VALUES ({100 + i}, "
                         f"'{'AB'[i % 2]}', 2.00, 4.00, DATE '1998-02-01')")
            if i % 5 == 0:
                sess.execute("REFRESH MATERIALIZED VIEW mv")
    finally:
        stop.set()
        th.join(timeout=30)
    assert not th.is_alive()
    assert not errors, errors[:3]
    _exact(_oracle(sess, qc), _view(sess))
    reader.close()


def test_restart_resumes_from_frontier(sess):
    """The plane torn down and the view registered again: the rebuild at
    the resolved frontier equals the incremental state it replaces, and
    the shared table's snapshot pin was never written."""
    _seed_rows(sess)
    sess.execute(f"CREATE MATERIALIZED VIEW mv AS {Q}")
    sess.execute("INSERT INTO t VALUES (200, 'B', 9.00, 1.50, "
                 "DATE '1998-01-02')")
    sess.execute("DELETE FROM t WHERE k = 4")
    r_inc = _view(sess)
    matview.close_all(sess.catalog)
    sess.catalog.tables.pop("mv", None)
    sess._invalidate_plans()
    sess.execute(f"CREATE MATERIALIZED VIEW mv AS {Q}")
    r_back = _view(sess)
    _exact(r_inc, r_back, "restart")
    _exact(_oracle(sess), r_back, "restart vs rescan")
    assert sess.catalog.tables["t"].read_ts is None


@pytest.mark.parametrize("site", [
    "matview.flush", "matview.delta.apply", "matview.frontier.checkpoint"])
def test_faulted_flush_resumes_from_frontier(sess, site):
    """A flush killed at each site commits nothing (frontier, state and
    the un-acked buffer unchanged), and the retry applies the same delta
    exactly once; the race sanitizer is armed throughout."""
    settings.set("debug.race_detector.enabled", True)
    racesan.reset()
    try:
        _seed_rows(sess, n=30, flags="AB")
        sess.execute(f"CREATE MATERIALIZED VIEW mv AS {Q}")
        reg = matview.registry_for(sess.catalog)
        view, m = reg.views["mv"], reg.maintainers["t"]
        f0 = view.frontier
        state0 = [d.clone() for d in view.cls.datas]
        sess.execute("INSERT INTO t VALUES (100, 'A', 7.00, 3.00, "
                     "DATE '1998-02-02')")
        sess.execute("UPDATE t SET qty = 99.75 WHERE k = 2")
        sess.execute("DELETE FROM t WHERE k = 3")
        m.pump()
        assert m.pending()
        faults.arm(1234, {site: FaultSpec(kind="error", max_fires=1)})
        with pytest.raises(InjectedFault):
            m.flush()
        assert view.frontier == f0 and m.frontier == f0
        assert all(torch.equal(a, b) for a, b in
                   zip(state0, view.cls.datas))
        assert m.pending()
        assert m.flush()
        assert view.frontier > f0
        _exact(_oracle(sess), _view(sess), site)
    finally:
        faults.disarm()
        settings.reset("debug.race_detector.enabled")
        racesan.reset()


def test_ddl_lifecycle_gates_and_pgwire(sess):
    """The DDL's typed refusals, REFRESH, DROP; and the statements over
    pgwire: CREATE, SELECT through the view and the rewrite, both
    crdb_internal tables."""
    from cockroach_tpu_torch.server.pgwire import PgServer
    from test_torch_pgwire import RawPg

    _seed_rows(sess, n=6)
    settings.set("sql.matview.enabled", False)
    try:
        with pytest.raises(matview.MatviewError, match="disabled"):
            sess.execute(f"CREATE MATERIALIZED VIEW mv AS {Q}")
    finally:
        settings.reset("sql.matview.enabled")
    with pytest.raises(matview.MatviewError, match="grouped aggregate"):
        sess.execute("CREATE MATERIALIZED VIEW mv AS SELECT k FROM t")
    sess.execute(f"CREATE MATERIALIZED VIEW mv AS {Q}")
    with pytest.raises(matview.MatviewError, match="already exists"):
        sess.execute(f"CREATE MATERIALIZED VIEW mv AS {Q}")
    assert sess.execute("REFRESH MATERIALIZED VIEW mv")["refreshed"] == "mv"
    assert metric.MATVIEW_VIEWS.value == 1
    sess.execute("DROP MATERIALIZED VIEW mv")
    assert metric.MATVIEW_VIEWS.value == 0 and "mv" not in \
        sess.catalog.tables
    with pytest.raises(matview.MatviewError, match="unknown materialized"):
        sess.execute("DROP MATERIALIZED VIEW mv")

    srv = PgServer(catalog=sess.catalog, db=sess.db, device="cpu")
    srv.serve_background()
    c = RawPg(srv.addr)
    try:
        for stmt in (f"CREATE MATERIALIZED VIEW mw AS {Q}",
                     "SELECT * FROM mw ORDER BY flag", Q,
                     "REFRESH MATERIALIZED VIEW mw",
                     "SELECT view FROM crdb_internal.node_materialized_views",
                     "SELECT hub FROM "
                     "crdb_internal.node_changefeed_subscribers"):
            reply = c.query(stmt)
            assert reply[0][0] != b"E", (stmt, reply[0])
            assert reply[-1] == (b"Z", b"I")
        rows = [b for tag, b in c.query("SELECT n FROM mw ORDER BY flag")
                if tag == b"D"]
        assert len(rows) == 3
    finally:
        c.close()
        srv.close()


@pytest.fixture(scope="module")
def q1_kv():
    """TPC-H sf=0.005 in KV through both packages on manual clocks; two q1
    views (60 and 150 days: one shape class, as the chip's four are)
    created before RF1 and flushed after RF1 and after RF2 in each; in the
    port also two views on orders (the chip step's fallback), held to
    their rescans."""
    from cockroach_tpu.bench import tpch as jtpch
    from test_torch_kvsql import load_reference, ref_refresh

    sf, seed = 0.005, 7
    thost = ttpch.gen_tpch(sf=sf, seed=seed, device="cpu")
    jhost = jtpch.gen_tpch(sf=sf, seed=seed)
    tcat, tdb, _ = tpch_kv.load_tpch_kv(thost, device="cpu", clock=tClock())
    jcat, jdb = load_reference(jhost, jClock())
    rf = tpch_kv.gen_refresh(thost, sf)
    days = (60, 150)
    port = tviews.KVViews(tcat, tdb, days)
    orders = tviews.KVViews(tcat, tdb, (30, 300), base="orders")
    js = jSession(catalog=jcat, db=jdb, key_width=16, bootstrap=False)
    for i, d in enumerate(days):
        js.execute(f"CREATE MATERIALIZED VIEW q1v{i} AS "
                   f"{tviews.q1_view_text(d)}")
    jm = jmatview.registry_for(jcat).maintainers["lineitem"]
    order = "ORDER BY l_returnflag, l_linestatus"
    out = {"create": port.check() + orders.check(),
           "prime_s": port.prime_s, "shadow_rows": port.shadow_rows}

    def step(name, apply_t, apply_j):
        apply_t()
        apply_j()
        fl = port.flush()
        jm.pump()
        jm.flush()
        out[name] = (fl, port.check() + orders.check(), [
            (port.read(i), js.execute(f"SELECT * FROM q1v{i} {order}"),
             port.reg.views[port.names[i]].out_schema)
            for i in range(len(days))])

    step("rf1", lambda: tpch_kv.apply_rf1(tcat, tdb, rf, txns=2),
         lambda: ref_refresh_rf1(jcat, jdb, rf, ref_refresh))
    step("rf2", lambda: tpch_kv.apply_rf2(tcat, tdb, rf, txns=2),
         lambda: ref_refresh_rf2(jcat, jdb, rf, ref_refresh))
    port.close()
    orders.close()
    assert matview.registry_for(tcat) is None
    jmatview.close_all(jcat)
    return out


def ref_refresh_rf1(cat, db, rf, ref_refresh):
    """RF1 alone through the reference (``ref_refresh`` with RF2's
    deletions emptied)."""
    ref_refresh(cat, db, {**rf, "rf2_orders": rf["rf2_orders"][:0],
                          "rf2_lineitem": rf["rf2_lineitem"][:0]})


def ref_refresh_rf2(cat, db, rf, ref_refresh):
    """RF2 alone through the reference (RF1's inserts emptied)."""
    empty = {c: a[:0] for c, a in rf["rf1_orders"].items()}
    lempty = {c: a[:0] for c, a in rf["rf1_lineitem"].items()}
    ref_refresh(cat, db, {**rf, "rf1_orders": empty,
                          "rf1_lineitem": lempty})


def test_q1_views_at_create_equal_rescan(q1_kv):
    assert q1_kv["create"] == []
    assert q1_kv["prime_s"] > 0 and q1_kv["shadow_rows"] > 0


@pytest.mark.parametrize("when", ["rf1", "rf2"])
def test_q1_views_over_kv_through_refresh(q1_kv, when):
    """After each refresh function: one flush of one dispatch (the
    lineitem maintainer's; orders' flush is the hub's next pump) applied
    its events, each view equals the port's fresh query over KV and the
    q1 views the reference's."""
    fl, bad, pairs = q1_kv[when]
    assert bad == []
    assert fl["events"] > 0 and fl["dispatches"] == 1
    assert fl["copies_per_poll"] == 1
    for i, (got, want, schema) in enumerate(pairs):
        assert tviews.same_result(got, want, schema) is None, (when, i)


def test_run_views_oracles():
    r = tviews.run_views(views=32, rounds=3, device="cpu")
    assert r["views_dispatch_ok"] and r["views_oracle_ok"]
    assert r["shape_classes"] == 1 and r["dispatches_per_flush_max"] == 1
    assert r["full_rescans_steady"] == 0 and r["events_applied"] > 0


def test_run_fanout_oracles():
    r = run_fanout(subscribers=40, duration_s=2.0, slow=2, flappers=2,
                   device="cpu")
    assert r["fanout_oracle_ok"]
    assert r["staging_bytes_after_close"] == 0
    assert r["subscribers"] == 40 and r["evictions"] >= 2
    assert r["subscribers_sustained"] == 36
    assert flowmem.staging_monitor("changefeed").used == 0
