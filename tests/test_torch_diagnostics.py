"""The port's statement diagnostics (cockroach_tpu_torch/sql/diagnostics.py)
and its new crdb_internal tables against the reference's on the CPU: a
bundle's section names equal the reference's for the same statement;
the slow-query log (off at a threshold of 0.0 s, as in the reference;
a bundle per statement at any positive threshold a statement passes);
the ring evicting its oldest bundle at ``sql.diagnostics.ring_size``;
EXPLAIN ANALYZE (DEBUG) naming its bundle, through ``sql.explain`` and
through ``Session.execute``; and node_metrics, node_inflight_trace_spans,
cluster_load and node_warmup_menu with the reference's column names and
types."""

import os

import pytest
import torch

from cockroach_tpu.sql import Session as jSession
from cockroach_tpu.sql import crdb_internal as jcrdb
from cockroach_tpu.sql import diagnostics as jdiag
from cockroach_tpu.sql import explain as jexplain
from cockroach_tpu.utils import settings as jsettings
from cockroach_tpu_torch.sql import Session, explain
from cockroach_tpu_torch.sql import crdb_internal as tcrdb
from cockroach_tpu_torch.sql import diagnostics as tdiag
from cockroach_tpu_torch.utils import settings as tsettings

NEW_TABLES = ("crdb_internal.node_metrics",
              "crdb_internal.node_inflight_trace_spans",
              "crdb_internal.cluster_load",
              "crdb_internal.node_warmup_menu")

STMT = "select a, sum(b) as s from t where a >= 1 group by a"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These small tables gain nothing from intra-op threads, and several
    test workers' thread pools on shared cores slow each other down."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def dirs(tmp_path):
    """Both packages' bundles in directories of the test's own."""
    for pkg, sub in ((tsettings, "torch"), (jsettings, "jax")):
        pkg.set("sql.diagnostics.dir", str(tmp_path / sub))
    tdiag.reset()
    jdiag.reset()
    yield tmp_path
    for pkg in (tsettings, jsettings):
        for name in ("sql.diagnostics.dir", "sql.diagnostics.ring_size",
                     "sql.log.slow_query.latency_threshold"):
            pkg.reset(name)
    tdiag.reset()
    jdiag.reset()


def _pair():
    t = Session(device="cpu")
    j = jSession()
    for s in (t, j):
        s.execute("create table t (a int primary key, b int)")
        s.execute("insert into t values (1, 10), (2, 20), (3, 30)")
    return t, j


def test_bundle_sections_match_reference(dirs):
    t, j = _pair()
    got = tdiag.get(tdiag.capture(t, STMT, elapsed_s=0.01)["id"])
    want = jdiag.get(jdiag.capture(j, STMT, elapsed_s=0.01)["id"])
    assert sorted(got) == sorted(want)
    assert got["stmt"] == want["stmt"] == STMT
    assert got["planCacheStatus"] == want["planCacheStatus"]
    assert sorted(got["memory"]) == sorted(want["memory"])
    assert got["memory"]["device"] == {}  # no card in use
    assert got["plan"] == want["plan"]
    t.close()
    j.close()


def test_slow_query_log_captures_bundles(dirs):
    t, j = _pair()
    for s, pkg, diag in ((t, tsettings, tdiag), (j, jsettings, jdiag)):
        # 0.0 s is off, in both packages
        pkg.set("sql.log.slow_query.latency_threshold", 0.0)
        s.execute(STMT)
        assert diag.bundles() == []
        pkg.set("sql.log.slow_query.latency_threshold", 1e-9)
        s.execute(STMT)
        s.execute("select count(*) as n from t")
        listed = diag.bundles()
        assert [b["trigger"] for b in listed] == ["slow_query"] * 2
        assert listed[1]["stmt"] == STMT
        full = diag.get(listed[1]["id"])
        assert full["trace"]["name"] == "sql.execute"
        pkg.set("sql.log.slow_query.latency_threshold", 0.0)
    t.close()
    j.close()


def test_ring_evicts_oldest_at_ring_size(dirs):
    t, _ = _pair()
    tsettings.set("sql.diagnostics.ring_size", 2)
    ids = [tdiag.capture(t, STMT, elapsed_s=0.0)["id"] for _ in range(3)]
    listed = tdiag.bundles()
    assert [b["id"] for b in listed] == [ids[2], ids[1]]
    assert tdiag.get(ids[0]) is None
    files = sorted(os.listdir(dirs / "torch"))
    assert files == [f"bundle_{i:06d}.json" for i in ids[1:]]
    t.close()


def test_explain_analyze_debug_names_its_bundle(dirs):
    t, j = _pair()
    text = "explain analyze (debug) " + STMT
    got, want = explain(t.catalog, text), jexplain(j.catalog, text)
    assert got.splitlines()[-1].startswith("diagnostics bundle: ")
    assert want.splitlines()[-1].startswith("diagnostics bundle: ")
    bid = int(got.splitlines()[-1].split(": ")[1])
    b = tdiag.get(bid)
    assert b["trigger"] == "explain_analyze_debug"
    assert b["trace"]["name"] == "query"
    # a session answers it too, as rows of text (so it answers over pgwire)
    rows = t.execute(text)["info"].tolist()
    assert rows[-1].startswith("diagnostics bundle: ")
    assert int(rows[-1].split(": ")[1]) > bid
    t.close()
    j.close()


@pytest.mark.parametrize("name", NEW_TABLES)
def test_new_tables_schema_matches_reference(name):
    t, j = _pair()
    got = tcrdb.build(t.catalog, name).schema
    want = jcrdb.build(j.catalog, name).schema
    assert got.names == want.names
    assert [repr(x) for x in got.types] == [repr(x) for x in want.types]
    # and each answers a statement
    out = t.execute(f"select * from {name}")
    assert list(out) == list(got.names)
    t.close()
    j.close()


def test_new_tables_read_live_registries():
    t, _ = _pair()
    t.execute(STMT)
    m = t.execute("select name, value from crdb_internal.node_metrics")
    names = m["name"].tolist()
    assert "sql_queries" in names and "sql_warmup_menu_hits" in names
    assert m["value"][names.index("sql_queries")] > 0
    spans = t.execute("select operation from "
                      "crdb_internal.node_inflight_trace_spans")
    # this statement's own span is open while the table materializes
    assert "sql.execute" in spans["operation"].tolist()
    load = t.execute("select active_sessions, device_bytes_in_use, "
                     "queries_total from crdb_internal.cluster_load")
    assert load["active_sessions"][0] >= 1
    assert load["device_bytes_in_use"][0] == 0  # no card in use
    assert load["queries_total"][0] > 0
    t.close()
