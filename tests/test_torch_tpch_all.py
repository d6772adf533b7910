"""The other 18 TPC-H queries (all but bench.py's ladder q1, q3, q9, q18)
through the port against the JAX reference on the CPU (sf=0.005, seed
7): plans and optimized plans (TopK for q2, q10, q21) equal, operator
trees equal node for node with the same join strategies, results equal
to the reference's (exactly, FLOAT columns within rtol=1e-12), TopK
results equal to Sort + Limit, and once more with 1024-row scan tiles in
both packages, so scans, probes, the top-k fold, the scalar merge and the
aggregation merge-down run over several tiles."""

import pytest

from cockroach_tpu.bench import queries as jQ
from cockroach_tpu.bench import tpch as jtpch
from cockroach_tpu.flow.runtime import run_operator as jrun
from cockroach_tpu.plan import builder as jbuilder
from cockroach_tpu.utils import settings as jsettings
from cockroach_tpu_torch.bench import queries as tQ
from cockroach_tpu_torch.bench import tpch as ttpch
from cockroach_tpu_torch.bench import tpch_oracle
from cockroach_tpu_torch.flow.runtime import run_operator as trun
from cockroach_tpu_torch.plan import builder as tbuilder
from cockroach_tpu_torch.utils import settings as tsettings
from test_torch_tpch import _tree
from test_torch_tpch_ladder import plan_repr, tree_matches

SF, SEED = 0.005, 7
LADDER = ("q1", "q3", "q9", "q18")
QUERIES = tuple(q for q in tQ.QUERIES if q not in LADDER)
TOPK = ("q2", "q10", "q21")
TILE = 1024


@pytest.fixture(scope="module")
def cats():
    return (jtpch.gen_tpch(sf=SF, seed=SEED),
            ttpch.gen_tpch(sf=SF, seed=SEED, device="cpu"))


def _run_all(jcat, tcat):
    """{query: (reference root, reference result, port root, port result,
    port result of the unoptimized plan)} over optimized plans."""
    out = {}
    for q in QUERIES:
        jroot = jbuilder.build(jQ.QUERIES[q](jcat).optimized_plan(), jcat)
        trel = tQ.QUERIES[q](tcat)
        troot = tbuilder.build(trel.optimized_plan(), tcat)
        out[q] = (jroot, jrun(jroot), troot, trun(troot),
                  trun(tbuilder.build(trel.plan, tcat)))
    return out


@pytest.fixture(scope="module")
def runs(cats):
    return _run_all(*cats)


@pytest.fixture(scope="module")
def tiled_runs():
    """The same runs with 1024-row scan tiles in both packages (fresh
    catalogs: a table pads to a tile multiple at its first upload)."""
    tsettings.set("sql.distsql.tile_size", TILE)
    jsettings.set("sql.distsql.tile_size", TILE)
    try:
        return _run_all(jtpch.gen_tpch(sf=SF, seed=SEED),
                        ttpch.gen_tpch(sf=SF, seed=SEED, device="cpu"))
    finally:
        jsettings.reset("sql.distsql.tile_size")
        tsettings.reset("sql.distsql.tile_size")


@pytest.mark.parametrize("q", QUERIES)
def test_plan_matches_reference(cats, q):
    jcat, tcat = cats
    jrel, trel = jQ.QUERIES[q](jcat), tQ.QUERIES[q](tcat)
    assert plan_repr(trel.plan) == plan_repr(jrel.plan)
    assert plan_repr(trel.optimized_plan()) == plan_repr(
        jrel.optimized_plan())
    assert ("TopK" in repr(trel.optimized_plan())) == (q in TOPK)


@pytest.mark.parametrize("q", QUERIES)
def test_operator_tree_matches_reference(runs, q):
    jroot, _, troot, _, _ = runs[q]
    tree_matches(jroot, troot)


def test_duplicate_key_joins(runs):
    """The joins over duplicate build keys: q4's semi join and q22's anti
    join probe the dense LUT, q13's left join takes the general emit."""
    def kinds(q):
        return [(t.spec.join_type, t.spec.build_unique, t.strategy)
                for n, t in _tree(runs[q][2]) if n == "HashJoinOp"]

    assert ("semi", False, "lut") in kinds("q4")
    assert ("anti", False, "lut") in kinds("q22")
    assert ("left", False, "general") in kinds("q13")


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_reference(runs, q):
    _, want, _, got, _ = runs[q]
    assert list(got) == list(want)
    assert len(next(iter(want.values()))) > 0
    bad = tpch_oracle.mismatch(q, got, want)
    assert bad is None, bad


@pytest.mark.parametrize("q", TOPK)
def test_topk_equals_sort_limit(runs, q):
    _, _, _, got, plain = runs[q]
    bad = tpch_oracle.mismatch(q, got, plain)
    assert bad is None, bad


@pytest.mark.parametrize("q", QUERIES)
def test_multi_tile_matches_reference(tiled_runs, q):
    jroot, want, troot, got, plain = tiled_runs[q]
    tree_matches(jroot, troot)
    for res in (got, plain):
        bad = tpch_oracle.mismatch(q, res, want)
        assert bad is None, bad


def test_multi_tile_runs_span_tiles(tiled_runs):
    """Lineitem spans many tiles at 1024 rows: the scan of q6 feeds its
    scalar aggregate tile by tile, and q21's Distinct merges down."""
    _, _, troot, _, _ = tiled_runs["q6"]
    scan = troot
    while scan.children():
        scan = scan.children()[0]
    assert scan.table.num_rows > 10 * TILE and scan._res_tile == TILE
