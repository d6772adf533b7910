"""The reduced TPC-DS workload through the port against the JAX reference
on the CPU: the generator's tables equal at sf=0.01 (seed 19980401);
for all nine queries the plans, operator trees and results equal the
reference's, at the default tile and with 1024-row tiles, and under a
scaling (sf=0.05, every size threshold over 1000) where store_sales
streams and q65_lite's GROUP BY spills to the Grace aggregation in both
packages. The port's numpy oracle equals the results and the reference's
pandas oracle (tests/test_tpcds.py), and fused runs equal unfused ones
bit for bit. FLOAT64 averages compare within rtol=1e-12
(tpcds_oracle.FLOAT_RTOL), everything else exactly; against pandas,
which sums DECIMAL as floats, within test_tpcds's rtol=1e-9."""

import numpy as np
import pytest
import torch

from cockroach_tpu.bench import tpcds as jtpcds
from cockroach_tpu.flow.runtime import run_operator as jrun
from cockroach_tpu.plan import builder as jbuilder
from cockroach_tpu.utils import settings as jsettings
from cockroach_tpu_torch.bench import tpcds as ttpcds
from cockroach_tpu_torch.bench import tpcds_oracle
from cockroach_tpu_torch.bench.tpcds_run import run_tpcds
from cockroach_tpu_torch.flow.runtime import run_operator as trun
from cockroach_tpu_torch.plan import builder as tbuilder
from cockroach_tpu_torch.utils import settings as tsettings
from test_torch_external import REF_ONLY, SF10_SCALING, both_settings
from test_torch_external import structure
from test_torch_tpch_ladder import plan_repr, tree_matches


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: beside the other test workers, a full thread
    pool per process oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


SF = 0.01
QUERIES = tuple(jtpcds.QUERIES)
# SF10's shape at sf=0.05: store_sales (144,000 rows) over the scaled
# scan_stream_rows streams in 1048-row tiles, and q65_lite's (store,
# item) GROUP BY (about 5,400 groups) passes both the scaled workmem and
# a dense budget under its key space, as its 27 M groups do at SF10
SPILL_SF = 0.05
SPILL_SCALING = {**SF10_SCALING, "sql.distsql.dense_agg_states": 4096}


def _catalogs(sf):
    return (jtpcds.gen_tpcds(sf=sf),
            ttpcds.gen_tpcds(sf=sf, device="cpu"))


@pytest.fixture(scope="module")
def cats():
    return _catalogs(SF)


def _run_both(cats, q, settings=None):
    jcat, tcat = cats
    with both_settings(settings or {}, REF_ONLY if settings else None):
        jroot = jbuilder.build(jtpcds.QUERIES[q](jcat).optimized_plan(),
                               jcat)
        troot = tbuilder.build(ttpcds.QUERIES[q](tcat).optimized_plan(),
                               tcat)
        return jroot, jrun(jroot), troot, trun(troot)


@pytest.fixture(scope="module")
def runs(cats):
    """{query: (reference root, result, port root, result)}."""
    return {q: _run_both(cats, q) for q in QUERIES}


def test_generator_matches_reference(cats):
    jcat, tcat = cats
    assert sorted(tcat.tables) == sorted(jcat.tables)
    for name, jt in jcat.tables.items():
        tt = tcat.get(name)
        assert tt.schema.names == jt.schema.names, name
        assert [repr(t) for t in tt.schema.types] == [
            repr(t) for t in jt.schema.types], name
        for c in jt.schema.names:
            a, b = np.asarray(tt.columns[c]), np.asarray(jt.columns[c])
            assert a.dtype == b.dtype, (name, c)
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{c}")
        assert sorted(tt.dictionaries) == sorted(jt.dictionaries)
        for c, d in jt.dictionaries.items():
            assert list(tt.dictionaries[c].values) == list(d.values)
    assert tcat.get("store_sales").num_rows == int(2_880_000 * SF)


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_reference(cats, runs, q):
    jcat, tcat = cats
    jrel, trel = jtpcds.QUERIES[q](jcat), ttpcds.QUERIES[q](tcat)
    assert plan_repr(trel.plan) == plan_repr(jrel.plan)
    assert plan_repr(trel.optimized_plan()) == plan_repr(
        jrel.optimized_plan())
    jroot, want, troot, got = runs[q]
    tree_matches(jroot, troot)
    assert len(next(iter(got.values()))) > 0
    bad = tpcds_oracle.mismatch(q, got, want)
    assert bad is None, bad
    bad = tpcds_oracle.mismatch(q, got, tpcds_oracle.ORACLES[q](tcat))
    assert bad is None, bad


@pytest.mark.parametrize("q", QUERIES)
def test_1024_row_tiles_match_reference(cats, runs, q):
    _, _, _, default = runs[q]
    jroot, want, troot, got = _run_both(
        cats, q, {"sql.distsql.tile_size": 1024})
    assert tpcds_oracle.mismatch(q, got, want) is None
    assert tpcds_oracle.mismatch(q, got, default) is None


@pytest.fixture(scope="module")
def spill_runs():
    cats = _catalogs(SPILL_SF)
    return cats, {q: _run_both(cats, q, SPILL_SCALING) for q in QUERIES}


@pytest.mark.parametrize("q", QUERIES)
def test_streamed_and_spilled_match_reference(spill_runs, q):
    (_, tcat), out = spill_runs
    jroot, want, troot, got = out[q]
    assert structure(troot) == structure(jroot)
    streamed, spills = structure(troot)
    assert "store_sales" in streamed
    if q == "q65_lite":
        assert ("AggregateOp", "GraceAggregateOp") in spills
    assert tpcds_oracle.mismatch(q, got, want) is None
    assert tpcds_oracle.mismatch(q, got,
                                 tpcds_oracle.ORACLES[q](tcat)) is None


@pytest.mark.parametrize("q", QUERIES)
def test_numpy_oracle_matches_pandas_oracle(cats, q):
    """The port's numpy oracle against the reference's pandas oracle, on
    the reference's catalog (the same tables)."""
    from test_tpcds import _VALS, _oracle

    jcat, _ = cats
    want = _oracle(jcat, q)
    got = tpcds_oracle.ORACLES[q](jcat)
    assert len(next(iter(got.values()))) == len(want) > 0
    for k in want.columns:
        a, b = np.asarray(got[k]), want[k].to_numpy()
        if k in _VALS[q]:
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64), rtol=1e-9)
        else:
            assert list(a) == list(b), (q, k)


@pytest.mark.parametrize("q", QUERIES)
def test_fused_equals_unfused(cats, runs, q):
    _, tcat = cats
    tsettings.set("sql.distsql.fusion.enabled", False)
    try:
        unfused = trun(tbuilder.build(
            ttpcds.QUERIES[q](tcat).optimized_plan(), tcat))
    finally:
        tsettings.reset("sql.distsql.fusion.enabled")
    fused = runs[q][3]
    assert list(fused) == list(unfused)
    for k in fused:
        a, b = np.asarray(fused[k]), np.asarray(unfused[k])
        assert a.dtype == b.dtype and list(a) == list(b), (q, k)


def test_run_tpcds_holds_every_run_to_the_oracle(cats):
    _, tcat = cats
    res = run_tpcds(("q53_lite", "q65_lite"), runs=1, device="cpu",
                    catalog=tcat, window=True)
    assert res["store_sales_rows"] == tcat.get("store_sales").num_rows
    for q in ("q53_lite", "q65_lite", "sales_window"):
        assert res[q]["equal"] and res[q]["median_s"] > 0
    assert res["sales_window"]["rows"] == res["store_sales_rows"]
    assert jsettings.get("sql.distsql.fusion.enabled")
