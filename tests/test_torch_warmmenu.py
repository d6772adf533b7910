"""The port's warm menu (cockroach_tpu_torch/sql/warmmenu.py) against the
reference's (cockroach_tpu/sql/warmmenu.py) on the CPU, over
tests/test_warmmenu.py's one-rung catalog built in both packages: the
same menu rows (fingerprint, source, status); a post-menu first
execution of every ladder statement makes 0 new signatures in both
packages and counts as a menu hit, the exact-text memo path included;
results equal to a cold catalog's and to the reference's; the vtable's
rows; no warm-menu thread left after the build; a disabled menu is a
no-op; an item past the plan cache's byte budget is recorded
``skipped`` and evicts nothing; a server warms its menu before it
accepts a connection."""

import threading

import numpy as np
import pytest
import torch

from cockroach_tpu.catalog import Catalog as jCatalog
from cockroach_tpu.catalog import Table as jTable
from cockroach_tpu.coldata.types import FLOAT64 as jFLOAT64
from cockroach_tpu.coldata.types import INT64 as jINT64
from cockroach_tpu.coldata.types import Schema as jSchema
from cockroach_tpu.flow import dispatch as jdispatch
from cockroach_tpu.sql import warmmenu as jwarmmenu
from cockroach_tpu.sql.session import Session as jSession
from cockroach_tpu.utils import metric as jmetric
from cockroach_tpu.utils import settings as jsettings
from cockroach_tpu_torch.catalog import Catalog, Table
from cockroach_tpu_torch.coldata.types import FLOAT64, INT64, Schema
from cockroach_tpu_torch.flow import dispatch
from cockroach_tpu_torch.sql import plancache, warmmenu
from cockroach_tpu_torch.sql.session import Session
from cockroach_tpu_torch.utils import metric, settings


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These small tables gain nothing from intra-op threads, and several
    test workers' thread pools on shared cores slow each other down."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _columns(n=96, seed=11) -> dict:
    rng = np.random.default_rng(seed)
    return {"m_key": np.arange(n, dtype=np.int64),
            "m_val": rng.uniform(0.0, 5.0, n)}


def _tcat(seed=11) -> Catalog:
    cat = Catalog("cpu")
    cat.add(Table(name="menu_t", schema=Schema(("m_key", "m_val"),
                                               (INT64, FLOAT64)),
                  columns=_columns(seed=seed)))
    return cat


def _jcat(seed=11) -> jCatalog:
    cat = jCatalog()
    cat.add(jTable(name="menu_t", schema=jSchema(("m_key", "m_val"),
                                                 (jINT64, jFLOAT64)),
                   columns=_columns(seed=seed)))
    return cat


@pytest.fixture(scope="module")
def warmed():
    """One menu build per package, shared by the module."""
    warmmenu.reset()
    jwarmmenu.reset()
    tcat, jcat = _tcat(), _jcat()
    tboot = Session(catalog=tcat, device="cpu")
    jboot = jSession(catalog=jcat)
    settings.set("sql.warmup.menu.enabled", True)
    jsettings.set("sql.warmup.menu.enabled", True)
    try:
        trun = warmmenu.build_menu(tcat, tboot.db, block=True)
        jrun = jwarmmenu.build_menu(jcat, jboot.db, block=True)
        yield tcat, tboot, trun, jcat, jboot
    finally:
        settings.reset("sql.warmup.menu.enabled")
        jsettings.reset("sql.warmup.menu.enabled")
        tboot.close()
        jboot.close()
        warmmenu.reset()
        jwarmmenu.reset()


def _menu_threads() -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.name.startswith(("warm-menu", "plan-warmup"))]


def _rows(rows) -> list[tuple]:
    """The rows' (fingerprint, source, status), sorted: two workers
    finish their items in either order."""
    return sorted((r["fingerprint"], r["source"], r["status"])
                  for r in rows)


def test_menu_rows_match_reference_and_threads_join(warmed):
    tcat, _, trun, jcat, _ = warmed
    stmts = warmmenu._ladder_statements(tcat)
    assert stmts == jwarmmenu._ladder_statements(jcat)
    assert len(stmts) == 4  # one rung x four operator templates
    rows = warmmenu.menu_rows()
    assert _rows(rows) == _rows(jwarmmenu.menu_rows())
    assert all(r["status"] == "compiled" for r in rows)
    assert sum(r["kernels"] for r in rows) > 0
    # each item ran at least twice, and its last run made no signature
    assert all(2 <= r["runs"] <= warmmenu._MAX_RUNS for r in rows)
    trun.join(10)
    assert _menu_threads() == []


def test_post_menu_first_execution_compiles_nothing(warmed):
    """In both packages, a post-menu first execution of every ladder
    statement makes 0 new signatures and counts as a serving-path menu
    hit; the port's results equal the reference's."""
    tcat, tboot, _, jcat, jboot = warmed
    serve = Session(catalog=tcat, db=tboot.db, bootstrap=False,
                    device="cpu")
    jserve = jSession(catalog=jcat, db=jboot.db, bootstrap=False)
    try:
        stmts = warmmenu._ladder_statements(tcat)
        hits0, jhits0 = (metric.SQL_WARMUP_MENU_HITS.value,
                         jmetric.SQL_WARMUP_MENU_HITS.value)
        c0, jc0 = dispatch.compiles(), jdispatch.compiles()
        got = [serve.execute(s) for s in stmts]
        want = [jserve.execute(s) for s in stmts]
        assert dispatch.compiles() - c0 == 0
        assert jdispatch.compiles() - jc0 == 0
        assert metric.SQL_WARMUP_MENU_HITS.value - hits0 == len(stmts)
        assert jmetric.SQL_WARMUP_MENU_HITS.value - jhits0 == len(stmts)
        assert sum(r["hits"] for r in warmmenu.menu_rows()) >= len(stmts)
        for s, g, w in zip(stmts, got, want):
            assert list(g) == list(w), s
            for name in g:
                np.testing.assert_allclose(
                    np.asarray(g[name], dtype=np.float64),
                    np.asarray(w[name], dtype=np.float64),
                    rtol=1e-12, err_msg=f"{s}: {name}")
    finally:
        serve.close()
        jserve.close()


def test_memo_fast_path_counts_menu_hits(warmed):
    tcat, tboot, _, _, _ = warmed
    serve = Session(catalog=tcat, db=tboot.db, bootstrap=False,
                    device="cpu")
    try:
        stmt = warmmenu._ladder_statements(tcat)[0]
        hits0 = metric.SQL_WARMUP_MENU_HITS.value
        serve.execute(stmt)
        serve.execute(stmt)
        assert metric.SQL_WARMUP_MENU_HITS.value - hits0 == 2
    finally:
        serve.close()


def test_menu_results_equal_cold(warmed):
    """A warmed plan returns the bytes a cold catalog's plan does."""
    tcat, tboot, _, _, _ = warmed
    serve = Session(catalog=tcat, db=tboot.db, bootstrap=False,
                    device="cpu")
    cold = Session(catalog=_tcat(), device="cpu")
    try:
        for s in warmmenu._ladder_statements(tcat):
            warm_out = serve.execute(s)
            cold_out = cold.execute(s)
            assert list(warm_out) == list(cold_out)
            for name in warm_out:
                np.testing.assert_array_equal(
                    np.asarray(warm_out[name]), np.asarray(cold_out[name]),
                    err_msg=f"{s}: {name}")
    finally:
        cold.close()
        serve.close()


def test_vtable_surfaces_menu_rows(warmed):
    tcat, tboot, _, jcat, jboot = warmed
    serve = Session(catalog=tcat, db=tboot.db, bootstrap=False,
                    device="cpu")
    jserve = jSession(catalog=jcat, db=jboot.db, bootstrap=False)
    try:
        q = ("select fingerprint, source, status, kernels, hits "
             "from crdb_internal.node_warmup_menu")
        out, jout = serve.execute(q), jserve.execute(q)
        assert list(out) == list(jout)
        statuses = [str(s) for s in np.asarray(out["status"])]
        assert len(statuses) == 4
        assert all(s == "compiled" for s in statuses)
        assert (sorted(str(f) for f in out["fingerprint"])
                == sorted(str(f) for f in jout["fingerprint"]))
    finally:
        serve.close()
        jserve.close()


def test_disabled_menu_is_a_noop():
    cat = _tcat(seed=12)
    boot = Session(catalog=cat, device="cpu")
    prev = settings.get("sql.warmup.menu.enabled")
    settings.set("sql.warmup.menu.enabled", False)
    try:
        rows0 = warmmenu.menu_rows()
        assert warmmenu.build_menu(cat, boot.db, block=True) is None
        assert warmmenu.menu_rows() == rows0
        assert _menu_threads() == []
    finally:
        settings.set("sql.warmup.menu.enabled", prev)
        boot.close()


def test_item_past_the_byte_budget_is_skipped(monkeypatch):
    """With the cache's byte budget below what one warmed entry holds,
    the first item is not kept and every later one is skipped before it
    runs: all rows ``skipped``, no entry evicted, the cache within its
    budget."""
    warmmenu.reset()
    cat = _tcat(seed=13)
    boot = Session(catalog=cat, device="cpu")
    monkeypatch.setattr(plancache.PlanCache, "budget", lambda self: 1)
    cache = plancache.cache_for(cat)
    ev = cache.evictions
    settings.set("sql.warmup.menu.enabled", True)
    try:
        warmmenu.build_menu(cat, boot.db, block=True)
        rows = warmmenu.menu_rows()
        assert len(rows) == 4
        assert all(r["status"] == "skipped" for r in rows)
        assert cache.evictions == ev and len(cache) == 0
        assert cache.bytes <= 1
        assert _menu_threads() == []
    finally:
        settings.reset("sql.warmup.menu.enabled")
        boot.close()
        warmmenu.reset()


def test_server_warms_before_its_first_connection():
    """Node.start builds the menu (explicit course first, through
    warmmenu.warm_node) before it reports readiness, and stop() leaves no
    warm-menu thread."""
    from cockroach_tpu_torch.server.node import Node

    warmmenu.reset()
    cat = _tcat(seed=14)
    text = "select count(*) as n from menu_t where m_key >= 10"
    settings.set("sql.warmup.menu.enabled", True)
    try:
        node = Node(node_id=14, ttl_ms=30000, metrics_interval_s=None,
                    device="cpu", catalog=cat, menu=[text])
        node.start(gossip_port=None, pg_port=0)
        try:
            rows = warmmenu.menu_rows()
            # rows land in the order the two workers finish their items
            assert sorted(r["source"] for r in rows) == [
                "explicit"] + ["ladder"] * 4
            assert all(r["status"] == "compiled" for r in rows)
            assert node._warmmenu_run is not None
            assert node.pg is not None
        finally:
            node.stop()
        assert _menu_threads() == []
    finally:
        settings.reset("sql.warmup.menu.enabled")
        warmmenu.reset()


def test_serving_miss_evicts_no_warmed_entry(monkeypatch):
    """Warmed entries go last: with room for the four ladder plans and no
    fifth, a serving miss runs, is not kept, and every warmed entry stays
    (a later run of each is a hit with no new signature)."""
    warmmenu.reset()
    cat = _tcat(seed=15)
    boot = Session(catalog=cat, device="cpu")
    monkeypatch.setattr(plancache, "_held_storages",
                        lambda entry, catalog: {id(entry.root): 100})
    monkeypatch.setattr(plancache.PlanCache, "budget", lambda self: 450)
    cache = plancache.cache_for(cat)
    settings.set("sql.warmup.menu.enabled", True)
    serve = Session(catalog=cat, db=boot.db, bootstrap=False, device="cpu")
    try:
        warmmenu.build_menu(cat, boot.db, block=True)
        assert [r["status"] for r in warmmenu.menu_rows()] == [
            "compiled"] * 4
        warmed = set(map(id, cache.entries()))
        assert len(warmed) == 4 and cache.bytes == 400
        serve.execute("select m_val from menu_t where m_key < 7")
        assert set(map(id, cache.entries())) == warmed
        c0 = dispatch.compiles()
        for s in warmmenu._ladder_statements(cat):
            serve.execute(s)
        assert dispatch.compiles() == c0
    finally:
        settings.reset("sql.warmup.menu.enabled")
        serve.close()
        boot.close()
        warmmenu.reset()


def test_explicit_item_runs_under_its_own_settings(monkeypatch):
    """A (text, settings) item runs under its settings on its worker's
    thread alone: the ladder runs under the process's settings, which the
    build leaves as they were; the same text given twice is one item;
    served under the item's settings, it makes no new signature."""
    warmmenu.reset()
    cat = _tcat(seed=16)
    boot = Session(catalog=cat, device="cpu")
    text = "select m_key, m_val from menu_t where m_val > 2.5"
    seen: list = []
    execute = Session.execute

    def spy(self, sql, *a, **k):
        seen.append((sql, settings.get("sql.opt.join_order")))
        return execute(self, sql, *a, **k)

    monkeypatch.setattr(Session, "execute", spy)
    settings.set("sql.warmup.menu.enabled", True)
    serve = Session(catalog=cat, db=boot.db, bootstrap=False, device="cpu")
    try:
        warmmenu.build_menu(cat, boot.db, [
            (text, {"sql.opt.join_order": "cost"}), text], block=True)
        assert settings.get("sql.opt.join_order") == "heuristic"
        rows = warmmenu.menu_rows()
        assert sorted(r["source"] for r in rows) == [
            "explicit"] + ["ladder"] * 4
        assert all(r["status"] == "compiled" for r in rows)
        orders = {}
        for sql, order in seen:
            orders.setdefault(sql, set()).add(order)
        assert orders.pop(text) == {"cost"}
        assert set(orders) == set(warmmenu._ladder_statements(cat))
        assert all(o == {"heuristic"} for o in orders.values())
        settings.set("sql.opt.join_order", "cost")
        c0 = dispatch.compiles()
        serve.execute(text)
        assert dispatch.compiles() == c0
    finally:
        settings.reset("sql.opt.join_order")
        settings.reset("sql.warmup.menu.enabled")
        serve.close()
        boot.close()
        warmmenu.reset()


def test_scoped_settings_are_checked_and_stay_on_their_thread():
    seen: list = []

    def other():
        seen.append(settings.get("sql.opt.join_order"))

    with settings.scoped({"sql.opt.join_order": "cost"}):
        assert settings.get("sql.opt.join_order") == "cost"
        th = threading.Thread(target=other)
        th.start()
        th.join()
        with settings.scoped({"sql.plan_cache.size": "7"}):
            assert settings.get("sql.plan_cache.size") == 7
            assert settings.get("sql.opt.join_order") == "cost"
        assert settings.get("sql.plan_cache.size") == 128
    assert settings.get("sql.opt.join_order") == "heuristic"
    assert seen == ["heuristic"]
    with pytest.raises(ValueError):
        with settings.scoped({"sql.opt.join_order": "greedy"}):
            pass
