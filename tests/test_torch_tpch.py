"""TPC-H q1 and q3 through the port against the JAX reference on the CPU
(sf=0.005, seed 7): plans equal field by field, operator trees equal node
for node (fusion nodes, their positions and members included) with the
same join strategies and, after one run, the same learned join emission,
results equal to the reference's run_operator (exactly, the
FLOAT64 averages within rtol=1e-12), the numpy oracle equal to both; the
duplicate-key join, right outer join, TopK, ScalarAggregate, Distinct
and Union nodes equal the reference's, and so do the partial and final
aggregation stages (the cross-host plane's, flow/disthost.py)."""

import numpy as np
import pytest
import torch

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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: beside the other test workers, a full thread
    pool per process oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


SF, SEED = 0.005, 7
QUERIES = ("q1", "q3")


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
    """Pre-order (class name, operator) pairs, fusion nodes included."""
    out = []
    stack = [op]
    while stack:
        o = stack.pop()
        out.append((type(o).__name__, o))
        stack.extend(reversed(o.children()))
    return out


def fusion_matches(name, j, t) -> None:
    """A fusion node, or a join's learned emission (after a run), equal to
    the reference's."""
    if name == "FusedPipeline":
        assert [type(m).__name__ for m in t.members] == [
            type(m).__name__ for m in j.members]
    if name == "_BarrierSource":
        assert type(t.inner).__name__ == type(j.inner).__name__
    if name == "HashJoinOp":
        assert (t._fusable, t._gen_fusable) == (j._fusable, j._gen_fusable)
        assert (t._emit_mode, t._emit_cap) == (j._emit_mode, j._emit_cap)


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
        fusion_matches(name, j, t)


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
    """Joins over duplicate build keys, and the right outer join, run and
    equal the reference's (as multisets: the reference's build sort is
    not stable inside a run of equal keys)."""
    from cockroach_tpu.sql.rel import Rel as JRel
    from test_torch_joins import _rows

    jcat, tcat = cats
    for how in ("inner", "semi", "right"):
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


def test_topk_and_other_nodes_raise(cats):
    """TopK, ScalarAggregate, Distinct and Union nodes build and equal the
    reference's; so do a partial-mode aggregation's state columns and a
    ScalarAggregate planned as a partial stage (both builders make the
    complete operator for it)."""
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
        (JS.Union((jbase, jbase)), S.Union((tbase, tbase))),
    ]
    for jnode, tnode in nodes:
        assert repr(tnode) == repr(jnode)
        want = jrun(jbuilder.build(jnode, jcat))
        got = trun(tbuilder.build(tnode, tcat))
        assert list(got) == list(want) and len(got[list(got)[0]]) > 0
        for name in want:
            np.testing.assert_array_equal(np.asarray(got[name]),
                                          np.asarray(want[name]))
    staged = [
        (JS.Aggregate(jbase, (2,), (jagg.AggSpec("sum", 1, "s"),
                                    jagg.AggSpec("avg", 1, "a")),
                      mode="partial"),
         S.Aggregate(tbase, (2,), (tagg.AggSpec("sum", 1, "s"),
                                   tagg.AggSpec("avg", 1, "a")),
                     mode="partial")),
        (JS.ScalarAggregate(jbase, (jagg.AggSpec("max", 0, "m"),),
                            mode="partial"),
         S.ScalarAggregate(tbase, (tagg.AggSpec("max", 0, "m"),),
                           mode="partial")),
    ]
    for jnode, tnode in staged:
        want = jrun(jbuilder.build(jnode, jcat))
        got = trun(tbuilder.build(tnode, tcat))
        assert list(got) == list(want) and len(got[list(got)[0]]) > 0
        order_w = np.lexsort([np.asarray(want[n]) for n in want][::-1])
        order_g = np.lexsort([np.asarray(got[n]) for n in got][::-1])
        for name in want:
            np.testing.assert_array_equal(np.asarray(got[name])[order_g],
                                          np.asarray(want[name])[order_w])


def test_run_executes_optimized_plan(cats, monkeypatch):
    """Rel.run executes optimized_plan() (index selection, then top-k
    pushdown); index selection rewrites only scans of KV tables, so a
    host table that names indexes keeps its plan, as in the reference."""
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
    assert repr(rel.optimized_plan()) == repr(opt)


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
    # the fusion pass wraps the filter chain in a FusedPipeline
    assert type(root).__name__ == "FusedPipeline"
    assert root.top.child.streaming
    np.testing.assert_array_equal(got["l_quantity"], want["l_quantity"])


def test_same_multiset_equals_sorted_rows():
    """chip_smoke.same_multiset (np.lexsort on numeric columns) gives the
    answer of comparing chip_smoke.sorted_rows (a Python sort of row
    tuples), the check it speeds up, on permuted, altered, NULL-bearing
    and NaN-bearing results."""
    import chip_smoke

    rng = np.random.default_rng(5)
    for trial in range(300):
        n = int(rng.integers(0, 30))
        a = {"x": rng.integers(0, 4, n), "y": rng.random(n).round(1),
             "z": rng.integers(0, 2, n).astype(bool)}
        if trial % 7 == 0:  # a NULL: object columns take the slow path
            a["x"] = a["x"].astype(object)
            if n:
                a["x"][0] = None
        if trial % 11 == 0 and n:  # NaN: the slow path too
            a["y"][0] = np.nan
        b = {k: v[rng.permutation(n)] for k, v in a.items()}
        if n and trial % 3 == 0:
            b["y"] = b["y"].copy()
            b["y"][int(rng.integers(0, n))] += 1.0
        want = chip_smoke.sorted_rows(a) == chip_smoke.sorted_rows(b)
        assert chip_smoke.same_multiset(a, b) == want, trial
