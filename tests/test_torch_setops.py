"""Right, full and cross joins, UNION ALL, string_agg and EXPLAIN
(ANALYZE) of the port against the JAX reference on the CPU, on the
tables of tests/test_join.py's outer-join cases and TPC-H at sf=0.005,
seed 7. Results equal as multisets of rows (a union's arms and a join's
duplicate runs come out in plan order, which both packages share, but
the reference's build sort is not stable inside a key run); the
dictionary refusals raise in both; EXPLAIN text equals the reference's
line for line, fusion-group tags included, and EXPLAIN ANALYZE's tree
has the reference's shape and operator labels."""

import re

import numpy as np
import pytest
import torch

from cockroach_tpu import catalog as jcatalog
from cockroach_tpu.bench import queries as jQ
from cockroach_tpu.bench import tpch as jtpch
from cockroach_tpu.coldata import types as jty
from cockroach_tpu.ops import expr as jex
from cockroach_tpu.sql.rel import Rel as JRel
from cockroach_tpu.utils import settings as jsettings
from cockroach_tpu_torch import catalog as tcatalog
from cockroach_tpu_torch.bench import queries as tQ
from cockroach_tpu_torch.bench import tpch as ttpch
from cockroach_tpu_torch.coldata import types as tty
from cockroach_tpu_torch.flow import operators as tops
from cockroach_tpu_torch.ops import expr as tex
from cockroach_tpu_torch.plan import builder as tbuilder
from cockroach_tpu_torch.plan import spec as TS
from cockroach_tpu_torch.sql.rel import Rel as TRel
from cockroach_tpu_torch.utils import settings as tsettings
from test_torch_tpch_ladder import plan_repr


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: beside the other test workers, a full thread
    pool per process oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


SF, SEED = 0.005, 7
PKG = {"ref": (jcatalog, jty, jex, JRel, jsettings),
       "port": (tcatalog, tty, tex, TRel, tsettings)}


def _outer_catalog(side):
    cat_mod, ty = PKG[side][0], PKG[side][1]
    c = cat_mod.Catalog() if side == "ref" else cat_mod.Catalog("cpu")
    c.add(cat_mod.Table.from_strings(
        "l", ty.Schema.of(lk=ty.INT64, lv=ty.INT64, ls=ty.STRING),
        {"lk": np.array([1, 2, 2, 3, 5]),
         "lv": np.array([10, 20, 21, 30, 50]),
         "ls": np.array(["a", "b", "b", "c", "e"], dtype=object)}))
    c.add(cat_mod.Table.from_strings(
        "r", ty.Schema.of(rk=ty.INT64, rv=ty.INT64, rs=ty.STRING),
        {"rk": np.array([2, 3, 3, 4]),
         "rv": np.array([200, 300, 301, 400]),
         "rs": np.array(["x", "y", "y", "z"], dtype=object)}))
    c.add(cat_mod.Table.from_strings(
        "gg", ty.Schema.of(g=ty.INT64, s=ty.STRING, n=ty.INT64),
        {"g": np.array([1, 2, 1, 3, 1, 2, 3]),
         "s": np.array(["p", "q", "r", "s", "t", "u", "v"], dtype=object),
         "n": np.arange(7)},
        valids={"g": np.array([1, 1, 1, 1, 1, 1, 0], dtype=bool),
                "s": np.array([1, 1, 0, 1, 1, 1, 1], dtype=bool)}))
    return c


@pytest.fixture(scope="module")
def outer():
    return {side: _outer_catalog(side) for side in PKG}


def rows(res: dict) -> list:
    """A result as a sorted list of row tuples (None sorts first)."""
    cols = [list(v) for v in res.values()]
    key = lambda r: tuple((x is not None, x) for x in r)  # noqa: E731
    return sorted(zip(*cols), key=key)


def both(outer, build):
    """build(Rel class, catalog, expr module) -> Rel in each package;
    returns (reference result, port result), plans checked equal."""
    out = {}
    for side, (_, _, ex, R, _) in PKG.items():
        rel = build(R, outer[side], ex)
        out[side] = (plan_repr(rel.plan), rel.run())
    assert out["port"][0] == out["ref"][0]
    assert list(out["port"][1]) == list(out["ref"][1])
    return out["ref"][1], out["port"][1]


JOIN_CASES = {
    "right": lambda R, c, ex: R.scan(c, "l").join(
        R.scan(c, "r"), on=[("lk", "rk")], how="right", build_unique=False),
    "full": lambda R, c, ex: R.scan(c, "l").join(
        R.scan(c, "r"), on=[("lk", "rk")], how="full", build_unique=False),
    "right_unique_build": lambda R, c, ex: R.scan(c, "r").join(
        R.scan(c, "l", ("lk", "lv")).filter(
            ex.Cmp("ne", R.scan(c, "l").c("lv"), ex.lit(21))),
        on=[("rk", "lk")], how="right"),
    "cross": lambda R, c, ex: R.scan(c, "l", ("lk", "lv")).cross_join(
        R.scan(c, "r", ("rk", "rs"))),
    "union_all": lambda R, c, ex: R.scan(c, "l", ("lk", "lv")).union_all(
        R.scan(c, "l", ("lk", "lv"))),
    "union_empty_arm": lambda R, c, ex: R.scan(c, "l", ("lk", "ls")).union_all(
        R.scan(c, "l", ("lk", "ls")).filter(ex.Cmp(
            "gt", R.scan(c, "l").c("lk"), R.scan(c, "l").c("lk")))),
}


@pytest.mark.parametrize("case", list(JOIN_CASES))
def test_set_operations_match_reference(outer, case):
    want, got = both(outer, JOIN_CASES[case])
    assert len(next(iter(got.values()))) > 0
    assert rows(got) == rows(want)
    if case == "right":
        # the null-extended probe STRING decodes to None
        nulls = [s for v, s in zip(got["lv"], got["ls"]) if v is None]
        assert nulls and all(s is None for s in nulls)
    if case == "cross":
        assert len(got["lk"]) == 5 * 4


def test_union_all_refusals_match_reference(outer):
    """Arity, type-family and dictionary refusals raise in both."""
    for side, (_, _, ex, R, _) in PKG.items():
        c = outer[side]
        lv = R.scan(c, "l", ("lk", "lv"))
        with pytest.raises(ValueError, match="arity"):
            lv.union_all(R.scan(c, "r"))
        with pytest.raises(ValueError, match="type families"):
            lv.union_all(R.scan(c, "l", ("lk", "ls")))
        with pytest.raises(ValueError, match="shared dictionary"):
            R.scan(c, "l", ("ls",)).union_all(R.scan(c, "r", ("rs",)))
        proj = R.scan(c, "l", ("lk",)).project(
            [("ls", ex.Const(7, R.scan(c, "l").type_of("ls")))])
        with pytest.raises(ValueError, match="provably all-NULL"):
            R.scan(c, "l", ("ls",)).union_all(proj)


def test_union_plan_builds_union_op(outer):
    c = outer["port"]
    base = TRel.scan(c, "l", ("lk",)).plan
    root = tbuilder.build(TS.Union((base, base)), c)
    assert isinstance(root, tops.UnionOp) and len(root.children()) == 2


# ---------------------------------------------------------------------------
# string_agg


SAGG_CASES = {
    "by_int": lambda R, c, ex: R.scan(c, "gg").groupby(
        ["g"], [("x", "string_agg", "s", ","), ("n", "count_rows", None)]),
    "two_keys_sep": lambda R, c, ex: R.scan(c, "gg").groupby(
        ["g", "n"], [("x", "string_agg", "s", " | ")]),
    "string_key": lambda R, c, ex: R.scan(c, "l").groupby(
        ["ls"], [("x", "string_agg", "ls", "-"), ("sum", "sum", "lv")]),
}


@pytest.mark.parametrize("case", list(SAGG_CASES))
def test_string_agg_matches_reference(outer, case):
    want, got = both(outer, SAGG_CASES[case])
    assert rows(got) == rows(want)
    assert any(isinstance(v, str) for v in got["x"])


def test_string_agg_downstream_refusals(outer):
    """Grouping, ordering or windowing by a string_agg result is refused
    (its dictionary fills only at runtime); the reference refuses the
    same plans (its runtime wraps the ValueError in a QueryError)."""
    for side, (_, _, ex, R, _) in PKG.items():
        c = outer[side]
        agg = R.scan(c, "gg").groupby(["g"], [("x", "string_agg", "s",
                                               ",")])
        for bad in (agg.groupby(["x"], [("n", "count_rows", None)]),
                    agg.sort([("x", False)]),
                    agg.window(["g"], [("x", False)],
                               [("rn", "row_number", None)])):
            with pytest.raises(Exception, match="string_agg result"):
                bad.run()


# ---------------------------------------------------------------------------
# EXPLAIN and EXPLAIN ANALYZE


@pytest.fixture(scope="module")
def hcats():
    return {"ref": jtpch.gen_tpch(sf=SF, seed=SEED),
            "port": ttpch.gen_tpch(sf=SF, seed=SEED, device="cpu")}


EXPLAIN_CASES = {
    "q1": lambda R, c, Q: Q.QUERIES["q1"](c),
    "q3": lambda R, c, Q: Q.QUERIES["q3"](c),
    "q18": lambda R, c, Q: Q.QUERIES["q18"](c),
    "window_merge_union": lambda R, c, Q: (
        R.scan(c, "lineitem", ("l_orderkey", "l_quantity"))
        .merge_join(R.scan(c, "orders", ("o_orderkey", "o_custkey")),
                    ("l_orderkey", "o_orderkey"))
        .window(["o_custkey"], [("l_quantity", False)],
                [("rk", "rank", None)])
        .select("o_custkey", "rk")
        .union_all(R.scan(c, "orders", ("o_custkey", "o_orderkey")))),
}


def _explained(hcats, case, fusion: bool, analyze: bool):
    out = {}
    for side, Q in (("ref", jQ), ("port", tQ)):
        R, st = PKG[side][3], PKG[side][4]
        rel = EXPLAIN_CASES[case](R, hcats[side], Q)
        st.set("sql.distsql.fusion.enabled", fusion)
        try:
            out[side] = rel.explain_analyze() if analyze else rel.explain()
        finally:
            st.reset("sql.distsql.fusion.enabled")
    return out


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("case", list(EXPLAIN_CASES))
def test_explain_matches_reference(hcats, case, fusion):
    out = _explained(hcats, case, fusion, analyze=False)
    assert out["port"] == out["ref"]
    if case.startswith("q"):
        assert ("[pipeline" in out["port"]) == fusion


_STATS = re.compile(r"  \[rows=\d+ batches=\d+ bytes=\d+ time=[0-9.]+ms "
                    r"self=-?[0-9.]+ms( max mem=[0-9.]+ [KM]iB)?( spilled)?\]")


def _tree_lines(text: str) -> list[str]:
    """The plan-tree lines of EXPLAIN ANALYZE, stats removed."""
    lines = text.split("\ntrace:")[0].splitlines()
    for line in lines:
        assert _STATS.search(line), line
    return [_STATS.sub("", line) for line in lines]


@pytest.mark.parametrize("case", ["q3", "window_merge_union"])
def test_explain_analyze_matches_reference(hcats, case):
    out = _explained(hcats, case, True, analyze=True)
    (jtext, jres), (ttext, tres) = out["ref"], out["port"]
    assert _tree_lines(ttext) == _tree_lines(jtext)
    assert rows(tres) == rows(jres)
    dispatches, compiles = ttext.splitlines()[-2:]
    assert dispatches.startswith("kernel dispatches: ")
    assert int(dispatches.split(": ")[1]) > 0
    assert compiles.startswith("kernel compiles: ")
    assert "operator/" in ttext.split("\ntrace:")[1]
