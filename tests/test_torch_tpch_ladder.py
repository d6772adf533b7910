"""TPC-H q9 and q18, the rest of bench.py's ladder, through the port
against the JAX reference on the CPU (sf=0.005, seed 7): plans and
optimized plans equal, operator trees equal node for node with the same
join strategies, results equal to the reference's (exactly: both queries
have only INT, DATE, STRING and DECIMAL columns) and to the numpy oracles.
q18 runs at its default threshold, which no order reaches at this scale
(zero rows, as in the reference's own test), and at quantity=150, which
gives 100 rows."""

import re

import numpy as np
import pytest
import torch

from cockroach_tpu.bench import queries as jQ
from cockroach_tpu.bench import tpch as jtpch
from cockroach_tpu.flow.runtime import run_operator as jrun
from cockroach_tpu.plan import builder as jbuilder
from cockroach_tpu_torch.bench import queries as tQ
from cockroach_tpu_torch.bench import tpch as ttpch
from cockroach_tpu_torch.bench import tpch_oracle
from cockroach_tpu_torch.flow.runtime import host_syncs
from cockroach_tpu_torch.flow.runtime import run_operator as trun
from cockroach_tpu_torch.plan import builder as tbuilder
from test_torch_tpch import _tree, fusion_matches


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: beside the other test workers, a full thread
    pool per process oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


SF, SEED = 0.005, 7
# case -> (query, keyword arguments)
CASES = {"q9": ("q9", {}), "q18": ("q18", {}),
         "q18_150": ("q18", {"quantity": 150})}

_DICT = re.compile(
    r"<cockroach_tpu(_torch)?\.coldata\.batch\.Dictionary object at "
    r"0x[0-9a-f]+>")


def _nodes(plan):
    """Every plan node under `plan` (either package's plan.spec)."""
    stack = [plan]
    while stack:
        node = stack.pop()
        yield node
        for f in node.__dataclass_fields__:
            v = getattr(node, f)
            for x in (v if isinstance(v, tuple) else (v,)):
                if type(x).__module__.endswith("plan.spec"):
                    stack.append(x)


def plan_repr(plan) -> str:
    """A plan's repr with dictionary objects (plan-time str_transform
    outputs) named by their values instead of their addresses."""
    dicts = [tuple(d.values) for node in _nodes(plan)
             if type(node).__name__ == "Project"
             for _, d in node.dict_overrides]
    return _DICT.sub("Dictionary", repr(plan)) + repr(dicts)


def tree_matches(jroot, troot) -> None:
    """Operator trees equal node for node (fusion nodes, their positions
    and members included), with the same aggregation layouts, join
    strategies and, after a run, learned join emission."""
    jt, tt = _tree(jroot), _tree(troot)
    assert [n for n, _ in tt] == [n for n, _ in jt]
    for (name, j), (_, t) in zip(jt, tt):
        assert t.output_schema.names == j.output_schema.names, name
        if name == "SmallGroupAggregateOp":
            assert (t.key_sizes, t.G, t.key_lows) == (j.key_sizes, j.G,
                                                      j.key_lows)
        if name == "AggregateOp":
            assert (t.ordered, t.prefix_live) == (j.ordered, j.prefix_live)
        if name == "TopKOp":
            assert t.k == j.k
            assert [(k.col, k.desc) for k in t.keys] == [
                (k.col, k.desc) for k in j.keys]
        if name == "HashJoinOp":
            assert t.strategy == join_kind(j), name
            assert _analytic(t) == _analytic(j)
            if j.exact_layout is None:
                assert t.exact_layout is None
            else:
                assert (t.exact_layout.segs, t.exact_layout.total_bits) == (
                    j.exact_layout.segs, j.exact_layout.total_bits)
        fusion_matches(name, j, t)


def join_kind(j) -> str:
    """The reference's strategy of a join after a run: the probe kind of
    a probe-aligned join, else the general emit."""
    return getattr(j, "_probe_kind", None) or "general"


def _analytic(op):
    a = op._analytic
    return None if a is None else (a.key_lo, a.fanout, a.build_rows)


@pytest.fixture(scope="module")
def cats():
    return (jtpch.gen_tpch(sf=SF, seed=SEED),
            ttpch.gen_tpch(sf=SF, seed=SEED, device="cpu"))


@pytest.fixture(scope="module")
def runs(cats):
    """Each case's optimized plan built and run once through both
    packages, and the port's unoptimized plan:
    {case: (reference root, reference result, port root, port result,
    port Sort + Limit result)}."""
    jcat, tcat = cats
    out = {}
    for case, (q, kw) in CASES.items():
        jroot = jbuilder.build(jQ.QUERIES[q](jcat, **kw).optimized_plan(),
                               jcat)
        trel = tQ.QUERIES[q](tcat, **kw)
        troot = tbuilder.build(trel.optimized_plan(), tcat)
        out[case] = (jroot, jrun(jroot), troot, trun(troot),
                     trun(tbuilder.build(trel.plan, tcat)))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_plan_matches_reference(cats, case):
    jcat, tcat = cats
    q, kw = CASES[case]
    jrel, trel = jQ.QUERIES[q](jcat, **kw), tQ.QUERIES[q](tcat, **kw)
    assert plan_repr(trel.plan) == plan_repr(jrel.plan)
    assert plan_repr(trel.optimized_plan()) == plan_repr(
        jrel.optimized_plan())
    assert ("TopK" in repr(trel.optimized_plan())) == (q == "q18")


@pytest.mark.parametrize("case", list(CASES))
def test_operator_tree_matches_reference(runs, case):
    jroot, _, troot, _, _ = runs[case]
    tree_matches(jroot, troot)


def test_join_strategies(runs):
    """q9's five probes over lineitem are all dense analytic; q18 takes
    the reference's strategies (checked join by join above)."""
    kinds = [t.strategy for n, t in _tree(runs["q9"][2])
             if n == "HashJoinOp"]
    assert kinds == ["analytic"] * 5
    q18 = [t.strategy for n, t in _tree(runs["q18_150"][2])
           if n == "HashJoinOp"]
    assert len(q18) == 3 and "general" not in q18


@pytest.mark.parametrize("case", list(CASES))
def test_query_matches_reference(runs, case):
    _, want, _, got, plain = runs[case]
    q = CASES[case][0]
    assert list(got) == list(want)
    assert tpch_oracle.mismatch(q, got, want) is None
    # TopK + Limit equals Sort + Limit exactly
    assert tpch_oracle.mismatch(q, plain, got) is None
    for name in want:
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(want[name]))


@pytest.mark.parametrize("case", list(CASES))
def test_oracle_matches(cats, runs, case):
    _, want, _, got, _ = runs[case]
    q, kw = CASES[case]
    oracle = tpch_oracle.ORACLES[q](cats[1], **kw)
    assert tpch_oracle.mismatch(q, got, oracle) is None
    assert tpch_oracle.mismatch(q, want, oracle) is None


def test_row_counts(runs):
    """147 (nation, year) groups for q9 (first row ALGERIA, 1998); q18
    empty at the default threshold, 100 rows (its LIMIT) at 150."""
    q9 = runs["q9"][3]
    assert len(q9["nation"]) == 147
    assert (q9["nation"][0], q9["o_year"][0]) == ("ALGERIA", 1998)
    assert len(runs["q18"][3]["o_orderkey"]) == 0
    assert len(runs["q18_150"][3]["o_orderkey"]) == 100


def test_host_syncs_counted(runs):
    """q9: one read of the deferred emission count in each of its five
    joins (once per query, whatever the probe tiles), the dense
    aggregation's overflow check, the sort spool and the readback; q18's
    TopK adds none."""
    q9 = host_syncs(runs["q9"][2])
    assert sum(v for k, v in q9.items() if "HashJoinOp" in k) == 5
    q18 = host_syncs(runs["q18_150"][2])
    assert not any("TopKOp" in k for k in q18)
    assert any("LimitOp" in k for k in q18)
