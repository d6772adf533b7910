"""The port's distributed SQL path (plan/distribute.py, parallel/planner.py,
Rel.run_distributed) on the CPU, against the port's single-device runs
and the JAX reference's distributed runs (TPC-H sf=0.01, seed 11, the
catalog of tests/test_distsql.py):

- all 22 queries through ``run_distributed`` on meshes of 3 and 8 CPU
  shards equal the port's single-device ``rel.run()`` (which
  test_torch_tpch_all.py holds to the reference), on 3 shards every new
  program signature also run under the CUDA-graph capture guard;
- ``explain_distributed`` text equal to the reference's for all 22;
- the reference's cheap distributed cases (q1, q3, q6, q10 and the stage
  cases of test_distsql.py) equal to the reference's own distributed
  results on its 8-device mesh, with the same attempts, final capacity
  factor and dispatches (one per attempt);
- the skewed-window retry ending at the reference's factor;
- a hashed STRING join key away from its position, which the port joins
  and the reference cannot (its ``_join_bridges`` keys the hash tables
  by column index, ``hash_columns`` reads them by key position).

FLOAT results compare within rtol=1e-9 (test_distsql.py's bound: the
shards' partial sums add in another order); everything else exactly."""

from types import SimpleNamespace

import numpy as np
import pytest

import cockroach_tpu.catalog as jcatalog
from cockroach_tpu import coldata as jcd
from cockroach_tpu.bench import queries as jQ
from cockroach_tpu.bench import tpch as jtpch
from cockroach_tpu.flow import dispatch as jdispatch
from cockroach_tpu.kv import DB as jDB
from cockroach_tpu.kv import ManualClock as jClock
from cockroach_tpu.kv.table import create_kv_table as j_create_kv
from cockroach_tpu.ops import expr as jex
from cockroach_tpu.parallel import mesh as jmesh
from cockroach_tpu.parallel.planner import DistributedQuery as jDQ
from cockroach_tpu.sql.rel import Rel as jRel
from cockroach_tpu.storage import rowcodec as jrc
from cockroach_tpu.storage.lsm import Engine as jEngine
from cockroach_tpu.utils.errors import QueryError as jQueryError
from cockroach_tpu_torch import catalog as tcatalog
from cockroach_tpu_torch.bench import queries as tQ
from cockroach_tpu_torch.bench import tpch as ttpch
from cockroach_tpu_torch.coldata import types as tT
from cockroach_tpu_torch.flow import dispatch as tdispatch
from cockroach_tpu_torch.kv import DB as tDB
from cockroach_tpu_torch.kv import ManualClock as tClock
from cockroach_tpu_torch.kv.table import create_kv_table as t_create_kv
from cockroach_tpu_torch.ops import expr as tex
from cockroach_tpu_torch.parallel import mesh as tmesh
from cockroach_tpu_torch.parallel.planner import DistributedQuery as tDQ
from cockroach_tpu_torch.plan import distribute as tdist
from cockroach_tpu_torch.plan import spec as tS
from cockroach_tpu_torch.sql.rel import Rel as tRel
from cockroach_tpu_torch.storage import rowcodec as trc
from cockroach_tpu_torch.storage.lsm import Engine as tEngine

SF, SEED = 0.01, 11
RTOL = 1e-9  # tests/test_distsql.py's bound
QUERIES = tuple(sorted(tQ.QUERIES))

J = SimpleNamespace(Rel=jRel, ex=jex, cd=jcd, Q=jQ, DQ=jDQ,
                    dispatch=jdispatch)
T = SimpleNamespace(Rel=tRel, ex=tex, cd=tT, Q=tQ, DQ=tDQ,
                    dispatch=tdispatch)


@pytest.fixture(scope="module")
def cats():
    return (jtpch.gen_tpch(sf=SF, seed=SEED),
            ttpch.gen_tpch(sf=SF, seed=SEED, device="cpu"))


@pytest.fixture(scope="module")
def meshes():
    return jmesh.make_mesh(8), tmesh.make_mesh(8, device="cpu")


def same(got: dict, want: dict, order_by=None):
    """Equal results; `order_by` (column names) compares as row sets."""
    assert list(got) == list(want)
    if order_by is not None:
        got, want = (_sorted(r, order_by) for r in (got, want))
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, f"{k}: {g.shape} vs {w.shape}"
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64), rtol=RTOL,
                                       err_msg=k)
        else:
            assert g.tolist() == w.tolist(), k


def _sorted(res: dict, keys) -> dict:
    order = np.lexsort([np.asarray(res[k]) for k in reversed(keys)])
    return {k: np.asarray(v)[order] for k, v in res.items()}


# ---------------------------------------------------------------------------
# all 22 queries: distributed == single device, explain == reference


@pytest.mark.parametrize("shards", [3, 8])
@pytest.mark.parametrize("q", QUERIES)
def test_tpch_distributed_equals_single_device(cats, q, shards):
    tcat = cats[1]
    rel = tQ.QUERIES[q](tcat)
    want = rel.run()
    mesh = tmesh.make_mesh(shards, device="cpu")
    if shards == 3:  # the capture guard once per query: same code at 8
        with tdispatch.capture_checks():
            got = rel.run_distributed(mesh)
    else:
        got = rel.run_distributed(mesh)
    same(got, want)


@pytest.mark.parametrize("q", QUERIES)
def test_explain_distributed_matches_reference(cats, q):
    jcat, tcat = cats
    want = jQ.QUERIES[q](jcat).explain_distributed()
    assert tQ.QUERIES[q](tcat).explain_distributed() == want


# ---------------------------------------------------------------------------
# the reference's cheap distributed cases, port against reference


def groupby_exchange(P, cat):
    rel = P.Rel.scan(cat, "lineitem",
                     ("l_orderkey", "l_quantity", "l_extendedprice"))
    return rel.groupby(["l_orderkey"], [("q", "sum", "l_quantity"),
                                        ("n", "count_rows", None),
                                        ("p", "avg", "l_extendedprice")])


def scalar(P, cat):
    rel = P.Rel.scan(cat, "lineitem", ("l_extendedprice", "l_shipdate",
                                       "l_discount", "l_quantity"))
    rel = rel.filter(P.ex.Cmp("lt", rel.c("l_quantity"), P.ex.Const(
        25, rel.type_of("l_quantity"))))
    return rel.scalar_agg([("s", "sum", "l_extendedprice"),
                           ("lo", "min", "l_shipdate"),
                           ("hi", "max", "l_shipdate"),
                           ("n", "count_rows", None),
                           ("d", "avg", "l_discount")])


def distinct(P, cat):
    rel = P.Rel.scan(cat, "lineitem", ("l_shipmode",)).distinct()
    return rel.sort([("l_shipmode", False)])


def priority_counts(P, cat):
    li = P.Rel.scan(cat, "lineitem", ("l_orderkey", "l_shipdate"))
    li = li.filter(P.ex.Cmp("gt", li.c("l_shipdate"),
                            P.ex.lit(jtpch.d("1995-01-01"))))
    o = P.Rel.scan(cat, "orders", ("o_orderkey", "o_orderpriority"))
    j = li.join(o, on=[("l_orderkey", "o_orderkey")])
    return j.groupby(["o_orderpriority"], [("n", "count_rows", None)]).sort(
        [("o_orderpriority", False)])


def nation_counts(P, cat):
    s = P.Rel.scan(cat, "supplier", ("s_suppkey", "s_nationkey"))
    n = P.Rel.scan(cat, "nation", ("n_nationkey", "n_name"))
    j = s.join(n, on=[("s_nationkey", "n_nationkey")])
    return j.groupby(["n_name"], [("n", "count_rows", None)]).sort(
        [("n", True), ("n_name", False)])


def window_partition(P, cat):
    rel = P.Rel.scan(cat, "lineitem",
                     ("l_orderkey", "l_linenumber", "l_quantity"))
    return rel.window(["l_orderkey"], [("l_linenumber", False)],
                      [("rn", "row_number", None), ("s", "sum", "l_quantity")])


def anti_count(P, cat):
    c = P.Rel.scan(cat, "customer", ("c_custkey",))
    o = P.Rel.scan(cat, "orders", ("o_custkey",))
    return c.join(o, on=[("c_custkey", "o_custkey")], how="anti",
                  build_unique=False).scalar_agg([("n", "count_rows", None)])


def semi_count(P, cat):
    o = P.Rel.scan(cat, "orders", ("o_orderkey",))
    li = P.Rel.scan(cat, "lineitem", ("l_orderkey", "l_quantity"))
    li = li.filter(P.ex.Cmp("gt", li.c("l_quantity"), P.ex.Const(
        45, li.type_of("l_quantity"))))
    return o.join(li, on=[("o_orderkey", "l_orderkey")], how="semi",
                  build_unique=False).scalar_agg([("n", "count_rows", None)])


def stat_aggs(P, cat):
    rel = P.Rel.scan(cat, "lineitem", ("l_returnflag", "l_quantity",
                                       "l_extendedprice"))
    return rel.groupby(["l_returnflag"], [
        ("s", "stddev", "l_quantity"),
        ("vp", "var_pop", "l_extendedprice")]).sort([("l_returnflag", False)])


def query(name):
    return lambda P, cat: P.Q.QUERIES[name](cat)


CASES = {
    "q1": (query("q1"), {}, None),
    "q3": (query("q3"), {}, None),
    "q6": (query("q6"), {}, None),
    "q10": (query("q10"), {}, None),
    "groupby_exchange": (groupby_exchange, {}, ["l_orderkey"]),
    "scalar": (scalar, {}, None),
    "distinct": (distinct, {}, None),
    "shuffle_join": (priority_counts, {"broadcast_rows": 0}, None),
    "broadcast_join": (nation_counts, {}, None),
    "window_partition": (window_partition, {},
                         ["l_orderkey", "l_linenumber"]),
    "anti_join": (anti_count, {}, None),
    "semi_join": (semi_count, {}, None),
    "stat_aggs": (stat_aggs, {}, None),
}


def run_dq(P, rel, mesh, **kw):
    """-> (result, query, dispatches counted by the run)."""
    q = P.DQ(rel.plan, rel.catalog, mesh, **kw)
    d0 = P.dispatch.total()
    out = q.run()
    return out, q, P.dispatch.total() - d0


@pytest.mark.parametrize("case", list(CASES))
def test_distributed_case_matches_reference(cats, meshes, case):
    make, kw, order_by = CASES[case]
    jrel, trel = make(J, cats[0]), make(T, cats[1])
    assert trel.explain_distributed(**kw) == jrel.explain_distributed(**kw)
    jout, jq, jd = run_dq(J, jrel, meshes[0], **kw)
    tout, tq, td = run_dq(T, trel, meshes[1], **kw)
    same(tout, jout, order_by)
    assert (tq.factor, td) == (jq.factor, jd)
    assert td == tq.attempts  # one dispatch per attempt
    txt = trel.explain_distributed(**kw)
    if case == "groupby_exchange":
        assert "mode=partial" in txt and "mode=final" in txt
    if case == "shuffle_join":
        assert txt.count("exchange") >= 2
    if case == "broadcast_join":
        assert "broadcast" in txt
    if case == "q3":  # per-shard top-k, then a small gather and a merge
        d = tdist.distribute(trel.plan, cats[1])
        assert isinstance(d, tS.Limit) and isinstance(d.input, tS.Sort)
        assert isinstance(d.input.input, tS.Gather)
        inner = d.input.input.input
        assert isinstance(inner, tS.Limit) and isinstance(inner.input,
                                                          tS.Sort)


def test_overflow_retry_matches_reference(cats, meshes):
    """Every row on one window partition: one shard receives the whole
    table, the first attempts' buckets overflow, and the retry loop
    doubles the capacities to the reference's final factor, with one
    dispatch per attempt and the exact result."""
    def skewed(P, cat):
        rel = P.Rel.scan(cat, "lineitem", ("l_orderkey", "l_quantity"))
        rel = rel.project([("k", P.ex.Const(7, P.cd.INT64)),
                           ("o", P.ex.ColRef(0)), ("q", P.ex.ColRef(1))])
        return rel.window(["k"], [("o", False)], [("s", "sum", "q")])

    jout, jq, jd = run_dq(J, skewed(J, cats[0]), meshes[0])
    trel = skewed(T, cats[1])
    tout, tq, td = run_dq(T, trel, meshes[1])
    assert jq.factor > 1
    assert (tq.factor, td, tq.attempts) == (jq.factor, jd, jd)
    same(tout, jout, ["o", "s"])
    same(tout, trel.run(), ["o", "s"])


def test_kv_backed_table_distributes(meshes):
    """A KV-engine-backed table: the columnar snapshot row-shards like a
    host table; the port's distributed result equals the reference's."""
    def kv_rel(Engine, DB, Clock, Catalog, create, rc, cd, Rel):
        schema = cd.Schema.of(id=cd.INT64, grp=cd.INT64,
                              val=cd.DECIMAL(12, 2))
        db = DB(Engine(key_width=16, val_width=rc.value_width(schema),
                       memtable_size=1 << 12), Clock())
        cat = Catalog()
        t = create(cat, db, "m", schema, pk="id")
        n = 3000
        t.bulk_load({"id": np.arange(n), "grp": np.arange(n) % 13,
                     "val": (np.arange(n) * 7 + 1) % 1000})
        return (Rel.scan(cat, "m", ("grp", "val"))
                .groupby(["grp"], [("s", "sum", "val"),
                                   ("c", "count_rows", None)])
                .sort([("grp", False)]))

    jrel = kv_rel(jEngine, jDB, jClock, jcatalog.Catalog, j_create_kv, jrc,
                  jcd, jRel)
    trel = kv_rel(lambda **kw: tEngine(device="cpu", **kw), tDB, tClock,
                  lambda: tcatalog.Catalog("cpu"), t_create_kv, trc, tT,
                  tRel)
    want = jrel.run_distributed(meshes[0])
    got = trel.run_distributed(meshes[1])
    same(got, want)
    same(got, trel.run())


def test_string_join_key_away_from_its_position(cats, meshes):
    """A hashed STRING join key at column 1 of the probe and key position
    0: the port keys its hash tables by position and joins; the
    reference's _join_bridges keys them by column index, and its
    hash_columns finds no table for position 0 (ROADMAP Queue 3)."""
    def rel_of(P, cat):
        c = P.Rel.scan(cat, "customer", ("c_custkey", "c_mktsegment"))
        seg = P.Rel.scan(cat, "customer", ("c_mktsegment",)).distinct()
        seg = seg.project([("seg", seg.c("c_mktsegment")),
                           ("one", P.ex.lit(1))])
        j = c.join(seg, on=[("c_mktsegment", "seg")], how="inner")
        return j.groupby(["seg"], [("n", "count_rows", None)]).sort(
            [("seg", False)])

    trel = rel_of(T, cats[1])
    got = trel.run_distributed(meshes[1])
    want = trel.run()
    same(got, want)
    assert len(want["seg"]) == 5 and int(np.sum(want["n"])) == 1500
    with pytest.raises(jQueryError, match="KeyError"):
        rel_of(J, cats[0]).run_distributed(meshes[0])
