"""TPC-H q1 and q3 through the port against the JAX reference on the CPU
(sf=0.005, seed 7): plans equal field by field, operator trees equal node
for node (the reference's fusion nodes aside) with the same join
strategies, results equal to the reference's run_operator (exactly, the
FLOAT64 averages within rtol=1e-12), the numpy oracle equal to both; the
duplicate-key join, TopK, ScalarAggregate and Distinct nodes equal the
reference's, and the plans still outside the port raise
NotImplementedError."""

import numpy as np
import pytest

from cockroach_tpu.bench import queries as jQ
from cockroach_tpu.bench import tpch as jtpch
from cockroach_tpu.flow import operators as jops
from cockroach_tpu.flow.runtime import run_operator as jrun
from cockroach_tpu.plan import builder as jbuilder
from cockroach_tpu_torch.bench import queries as tQ
from cockroach_tpu_torch.bench import tpch as ttpch
from cockroach_tpu_torch.bench import tpch_oracle
from cockroach_tpu_torch.bench.tpch_run import run_tpch
from cockroach_tpu_torch.flow import operators as tops
from cockroach_tpu_torch.flow.runtime import host_syncs
from cockroach_tpu_torch.flow.runtime import run_operator as trun
from cockroach_tpu_torch.ops import expr as tex
from cockroach_tpu_torch.ops import sort as tsort
from cockroach_tpu_torch.plan import builder as tbuilder
from cockroach_tpu_torch.plan import spec as S
from cockroach_tpu_torch.sql.rel import Rel
from cockroach_tpu_torch.utils import settings

SF, SEED = 0.005, 7
QUERIES = ("q1", "q3")
# the reference's fusion pass inserts these; the port runs unfused
FUSION_NODES = ("_BarrierSource", "FusedPipeline")


@pytest.fixture(scope="module")
def cats():
    return (jtpch.gen_tpch(sf=SF, seed=SEED),
            ttpch.gen_tpch(sf=SF, seed=SEED, device="cpu"))


@pytest.fixture(scope="module")
def runs(cats):
    """Each query built and run once through both packages:
    {query: (reference root, reference result, port root, port result)}."""
    jcat, tcat = cats
    out = {}
    for q in QUERIES:
        jroot = jbuilder.build(jQ.QUERIES[q](jcat).plan, jcat)
        troot = tbuilder.build(tQ.QUERIES[q](tcat).plan, tcat)
        out[q] = (jroot, jrun(jroot), troot, trun(troot))
    return out


@pytest.mark.parametrize("q", QUERIES)
def test_plan_matches_reference(cats, q):
    jcat, tcat = cats
    assert repr(tQ.QUERIES[q](tcat).plan) == repr(jQ.QUERIES[q](jcat).plan)


def _tree(op):
    """Pre-order (class name, operator) pairs without fusion nodes."""
    out = []
    stack = [op]
    while stack:
        o = stack.pop()
        if type(o).__name__ not in FUSION_NODES:
            out.append((type(o).__name__, o))
        stack.extend(reversed(o.children()))
    return out


@pytest.mark.parametrize("q", QUERIES)
def test_operator_tree_matches_reference(runs, q):
    jroot, _, troot, _ = runs[q]
    jt, tt = _tree(jroot), _tree(troot)
    assert [n for n, _ in tt] == [n for n, _ in jt]
    for (name, j), (_, t) in zip(jt, tt):
        assert t.output_schema.names == j.output_schema.names, name
        if name == "SmallGroupAggregateOp":
            assert (t.key_sizes, t.G) == (j.key_sizes, j.G)
        if name == "AggregateOp":
            assert (t.ordered, t.prefix_live) == (j.ordered, j.prefix_live)


def test_q3_join_strategies_match_reference(runs):
    """The semi join (orders x customer) probes by dense analytic
    addressing, the inner join (lineitem x orders) through the exact-key
    dense LUT: the reference's choices, after a run of each."""
    jroot, _, troot, _ = runs["q3"]
    jjoins = [o for n, o in _tree(jroot) if n == "HashJoinOp"]
    tjoins = [o for n, o in _tree(troot) if n == "HashJoinOp"]
    assert [t.strategy for t in tjoins] == [j._probe_kind for j in jjoins] \
        == ["lut", "analytic"]
    def info(a):
        return None if a is None else (a.key_lo, a.fanout, a.build_rows)

    for t, j in zip(tjoins, jjoins):
        assert info(t._analytic) == info(j._analytic)
        assert (t.exact_layout.segs, t.exact_layout.total_bits) == (
            j.exact_layout.segs, j.exact_layout.total_bits)


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_reference(runs, q):
    _, want, _, got = runs[q]
    assert got.keys() == want.keys()
    assert len(next(iter(got.values()))) > 0
    bad = tpch_oracle.mismatch(q, got, want)
    assert bad is None, bad


@pytest.mark.parametrize("q", QUERIES)
def test_oracle_matches_reference(cats, runs, q):
    _, want, _, got = runs[q]
    oracle = tpch_oracle.ORACLES[q](cats[1])
    assert tpch_oracle.mismatch(q, want, oracle) is None
    # the port's FLOAT64 averages divide like the oracle: bit-equal
    assert tpch_oracle.mismatch(q, got, oracle) is None
    for c in tpch_oracle.FLOAT_COLUMNS[q]:
        np.testing.assert_array_equal(got[c], oracle[c])


def test_host_syncs_counted(runs):
    assert sum(host_syncs(runs["q1"][2]).values()) == 3
    q3 = host_syncs(runs["q3"][2])
    assert any("HashJoinOp" in k for k in q3)
    assert any("LimitOp" in k for k in q3)


def test_rerun_and_run_tpch_on_cpu(cats, runs):
    _, want, troot, _ = runs["q3"]
    assert tpch_oracle.mismatch("q3", trun(troot), want) is None
    res = run_tpch(sf=0.002, seed=SEED, runs=1, device="cpu")
    assert list(res)[3:] == ["q1", "q3", "q9", "q18"]
    assert res["q1"]["equal"] and res["q3"]["equal"]
    assert res["q3"]["rows_per_sec"] > 0
    assert res["q9"]["held_to"] == "oracle" and res["q9"]["rows"] > 0
    rest = run_tpch(("q6", "q13"), catalog=cats[1], runs=0, device="cpu")
    assert rest["q13"]["held_to"] == "cold run" and rest["q13"]["rows"] > 0
    assert rest["q6"]["median_s"] is None and rest["q6"]["warm_s"] > 0
    assert Rel.run(tQ.q1(cats[1]))["count_order"].sum() > 0


def test_chip_smoke_tpch_helpers_on_cpu(cats):
    """The chip script's TPC-H phase pieces, rehearsed on the CPU: the
    per-operator breakdown (stats on) covers every operator of q3 and
    keeps its result, and the two-device parity check runs."""
    import chip_smoke

    tcat = cats[1]
    root = tbuilder.build(tQ.q3(tcat).plan, tcat)
    ms = chip_smoke.operator_breakdown(root)
    assert len(ms) == len(_tree(root)) and all(v >= 0 for v in ms.values())
    assert root.stats.rows == 10 and root.stats.batches == 1
    chip_smoke.check_tpch_parity("cpu", sf=0.002)
    rows = chip_smoke.check_tpch22_parity("cpu", sf=0.002, tile=1024)
    assert list(rows) == list(tQ.QUERIES) and rows["q16"] > 0
    assert settings.get("sql.distsql.tile_size") == 1 << 20


def test_reference_operator_names_exist():
    """The port's operator classes carry the reference's names, which the
    tree comparison above relies on."""
    for name in ("ScanOp", "FilterOp", "ProjectOp", "LimitOp", "AggregateOp",
                 "SmallGroupAggregateOp", "ScalarAggregateOp", "SortOp",
                 "TopKOp", "DistinctOp", "HashJoinOp"):
        assert hasattr(jops, name) and hasattr(tops, name)


# ---------------------------------------------------------------------------
# plans an earlier slice raised for, and what still raises


def test_duplicate_key_join_raises(cats):
    """Joins over duplicate build keys run and equal the reference's (as
    multisets: the reference's build sort is not stable inside a run of
    equal keys); right outer joins still raise."""
    from cockroach_tpu.sql.rel import Rel as JRel
    from test_torch_joins import _rows

    jcat, tcat = cats
    for how in ("inner", "semi"):
        out = []
        for R, cat, run, bld in ((JRel, jcat, jrun, jbuilder),
                                 (Rel, tcat, trun, tbuilder)):
            li = R.scan(cat, "lineitem", ("l_orderkey", "l_partkey"))
            ps = R.scan(cat, "partsupp", ("ps_partkey", "ps_suppkey"))
            rel = li.join(ps, on=[("l_partkey", "ps_partkey")], how=how,
                          build_unique=False)
            out.append(run(bld.build(rel.plan, cat)))
        assert len(out[1]["l_orderkey"]) > 0
        assert _rows(out[1]) == _rows(out[0])
    li = Rel.scan(tcat, "lineitem", ("l_orderkey", "l_partkey"))
    ps = Rel.scan(tcat, "partsupp", ("ps_partkey", "ps_suppkey"))
    with pytest.raises(NotImplementedError):
        li.join(ps, on=[("l_partkey", "ps_partkey")], how="right")


def test_topk_and_other_nodes_raise(cats):
    """TopK, ScalarAggregate and Distinct nodes build and equal the
    reference's; Union and partial-mode aggregation still raise."""
    from cockroach_tpu.ops import aggregation as jagg
    from cockroach_tpu.ops import sort as jsort
    from cockroach_tpu.plan import spec as JS
    from cockroach_tpu.sql.rel import Rel as JRel
    from cockroach_tpu_torch.ops import aggregation as tagg

    jcat, tcat = cats
    cols = ("o_orderkey", "o_totalprice", "o_orderpriority")
    jbase = JRel.scan(jcat, "orders", cols).plan
    tbase = Rel.scan(tcat, "orders", cols).plan
    nodes = [
        (JS.TopK(jbase, (jsort.SortKey(1, desc=True),), 10),
         S.TopK(tbase, (tsort.SortKey(1, desc=True),), 10)),
        (JS.ScalarAggregate(jbase, (jagg.AggSpec("sum", 1, "s"),
                                    jagg.AggSpec("count_rows", None, "n"))),
         S.ScalarAggregate(tbase, (tagg.AggSpec("sum", 1, "s"),
                                   tagg.AggSpec("count_rows", None, "n")))),
        (JS.Distinct(jbase, (2,)), S.Distinct(tbase, (2,))),
    ]
    for jnode, tnode in nodes:
        assert repr(tnode) == repr(jnode)
        want = jrun(jbuilder.build(jnode, jcat))
        got = trun(tbuilder.build(tnode, tcat))
        assert list(got) == list(want) and len(got[list(got)[0]]) > 0
        for name in want:
            np.testing.assert_array_equal(np.asarray(got[name]),
                                          np.asarray(want[name]))
    with pytest.raises(NotImplementedError, match="later SQL slice"):
        tbuilder.build(S.Union((tbase, tbase)), tcat)
    with pytest.raises(NotImplementedError, match="distributed stage"):
        tbuilder.build(S.Aggregate(tbase, (0,), (), mode="partial"), tcat)
    with pytest.raises(NotImplementedError, match="distributed stage"):
        tbuilder.build(S.ScalarAggregate(tbase, (), mode="partial"), tcat)


def test_run_executes_optimized_plan(cats, monkeypatch):
    """Rel.run executes optimized_plan() (top-k pushdown), which raises
    for a scan of a table with secondary indexes until the KV slice."""
    tcat = cats[1]
    rel = tQ.q3(tcat)
    opt = rel.optimized_plan()
    assert isinstance(opt, S.Limit) and isinstance(opt.input, S.TopK)
    assert isinstance(rel.plan.input, S.Sort)
    got = rel.run()
    want = trun(tbuilder.build(rel.plan, tcat))
    assert tpch_oracle.mismatch("q3", got, want) is None
    monkeypatch.setattr(tcat.get("orders"), "indexes", ("o_custkey",),
                        raising=False)
    with pytest.raises(NotImplementedError, match="KV slice"):
        rel.optimized_plan()


def test_streaming_scan_raises(cats):
    """A table over sql.distsql.scan_stream_rows no longer raises: it
    streams in tiles, with the same result as the resident scan."""
    tcat = cats[1]
    rel = Rel.scan(tcat, "lineitem", ("l_quantity",))
    rel = rel.filter(tex.Cmp("gt", rel.c("l_quantity"), tex.lit(0)))
    want = trun(tbuilder.build(rel.plan, tcat))
    settings.set("sql.distsql.scan_stream_rows", 1024)
    try:
        root = tbuilder.build(rel.plan, tcat)
        got = trun(root)
    finally:
        settings.reset("sql.distsql.scan_stream_rows")
    assert root.child.streaming
    np.testing.assert_array_equal(got["l_quantity"], want["l_quantity"])
