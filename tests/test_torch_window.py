"""Window functions and the merge join of the port against the JAX
reference on the CPU, on the same inputs: TPC-H lineitem and orders at
sf=0.005, seed 7, and hand-built tables with ties, NULLs, NaN and
infinities, BYTES order keys and int64 extremes.

Every window function, every frame kind (ROWS, RANGE with INT, DECIMAL
and FLOAT keys ascending and descending, GROUPS, peer-only RANGE) and
every EXCLUDE option runs through both packages' plan builders and
runtimes. Integer, DECIMAL, STRING and BOOL columns equal exactly, NULL
only NULL. FLOAT columns (avg, percent_rank, cume_dist, FLOAT sums)
equal within rtol=1e-12 plus atol=1e-9: the port's prefix sums add in
torch's order and the reference's in XLA's, so a framed FLOAT sum that
cancels to near zero differs in its last bits."""

import numpy as np
import pytest
import torch

from cockroach_tpu import catalog as jcatalog
from cockroach_tpu.bench import tpch as jtpch
from cockroach_tpu.coldata import batch as jbatch
from cockroach_tpu.coldata import types as jty
from cockroach_tpu.flow.runtime import run_operator as jrun
from cockroach_tpu.ops import join as jjoin
from cockroach_tpu.ops import sort as jsort
from cockroach_tpu.ops import window as jwin
from cockroach_tpu.plan import builder as jbuilder
from cockroach_tpu.plan import spec as JS
from cockroach_tpu.sql.rel import Rel as JRel
from cockroach_tpu_torch import catalog as tcatalog
from cockroach_tpu_torch.bench import tpch as ttpch
from cockroach_tpu_torch.coldata import batch as tbatch
from cockroach_tpu_torch.coldata import types as tty
from cockroach_tpu_torch.flow import operators as tops
from cockroach_tpu_torch.flow.runtime import run_operator as trun
from cockroach_tpu_torch.ops import join as tjoin
from cockroach_tpu_torch.ops import sort as tsort
from cockroach_tpu_torch.ops import window as twin
from cockroach_tpu_torch.plan import builder as tbuilder
from cockroach_tpu_torch.plan import spec as TS
from cockroach_tpu_torch.sql.rel import Rel as TRel


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: beside the other test workers, a full thread
    pool per process oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


SF, SEED = 0.005, 7
FLOAT_RTOL, FLOAT_ATOL = 1e-12, 1e-9

# (reference module set, port module set) for building the same plan
J = (jcatalog, jty, jsort, jwin, jjoin, JS, JRel, jbuilder, jrun)
T = (tcatalog, tty, tsort, twin, tjoin, TS, TRel, tbuilder, trun)


def results_equal(got: dict, want: dict) -> None:
    """Column for column: FLOAT within the stated bound, the rest
    exactly, NULL (None) only equal to NULL, NaN equal to NaN."""
    assert list(got) == list(want)
    for k in want:
        a = np.asarray(got[k], dtype=object)
        b = np.asarray(want[k], dtype=object)
        assert a.shape == b.shape, k
        for i, (x, y) in enumerate(zip(a, b)):
            if x is None or y is None:
                assert x is None and y is None, (k, i, x, y)
            elif isinstance(y, float) or isinstance(x, float):
                x, y = float(x), float(y)
                if np.isnan(y) or np.isnan(x):
                    assert np.isnan(x) and np.isnan(y), (k, i, x, y)
                elif np.isinf(y) or np.isinf(x):
                    assert x == y, (k, i, x, y)
                else:
                    assert abs(x - y) <= FLOAT_ATOL + FLOAT_RTOL * abs(y), (
                        k, i, x, y)
            else:
                assert x == y, (k, i, x, y)


def _table(mods, name, types: dict, raw: dict, valids=None):
    cat_mod, ty = mods[0], mods[1]
    schema = ty.Schema(tuple(types), tuple(types.values()))
    return cat_mod.Table.from_strings(name, schema, raw, valids=valids)


def both_catalogs(tables) -> tuple:
    """The same hand-built tables in a reference and a port catalog.
    tables: {name: (types as {col: (ref type, port type)}, raw, valids)}."""
    jcat, tcat = jcatalog.Catalog(), tcatalog.Catalog("cpu")
    for name, (types, raw, valids) in tables.items():
        jcat.add(_table(J, name, {c: t[0] for c, t in types.items()}, raw,
                        valids))
        tcat.add(_table(T, name, {c: t[1] for c, t in types.items()}, raw,
                        valids))
    return jcat, tcat


def run_window(mods, cat, table, cols, part, order, specs):
    """A Window node over a scan: part/order by column name, order items
    (name, desc); specs (out name, func, input name or None, options)."""
    _, _, sort_m, win_m, _, S, R, bld, run = mods
    rel = R.scan(cat, table, cols)
    node = S.Window(
        rel.plan, tuple(rel.idx(c) for c in part),
        tuple(sort_m.SortKey(rel.idx(c), desc=d) for c, d in order),
        tuple(win_m.WindowSpec(f, None if c is None else rel.idx(c), name,
                               **opts)
              for name, f, c, opts in specs))
    return run(bld.build(node, cat))


def window_both(cats, *args):
    jcat, tcat = cats
    want = run_window(J, jcat, *args)
    got = run_window(T, tcat, *args)
    results_equal(got, want)
    return got


@pytest.fixture(scope="module")
def tpch_cats():
    return (jtpch.gen_tpch(sf=SF, seed=SEED),
            ttpch.gen_tpch(sf=SF, seed=SEED, device="cpu"))


# ---------------------------------------------------------------------------
# TPC-H lineitem: every function, running and whole-partition frames


def _each(funcs, col, **opts):
    return [(f"{f}_{col or 'star'}", f, col, dict(opts)) for f in funcs]


AGGS = ("sum", "count", "min", "max", "avg", "first_value", "last_value")
LINEITEM_CASES = {
    "rank_family": (
        ("l_orderkey",), (("l_quantity", False),),
        [("rn", "row_number", None, {}), ("rk", "rank", None, {}),
         ("drk", "dense_rank", None, {}), ("pr", "percent_rank", None, {}),
         ("cd", "cume_dist", None, {}), ("nt", "ntile", None, {"offset": 3}),
         ("lag1", "lag", "l_quantity", {}),
         ("lead2", "lead", "l_extendedprice", {"offset": 2})]),
    "partition_and_running": (
        ("l_orderkey",), (("l_linenumber", False),),
        _each(AGGS, "l_quantity") + _each(("count",), None)
        + [(f"r_{n}", f, c, {"running": True})
           for n, f, c, _ in _each(AGGS, "l_extendedprice")
           + _each(("count",), None)]),
    "string_partition_desc": (
        ("l_returnflag",), (("l_shipdate", True), ("l_orderkey", False)),
        _each(("min", "max", "first_value", "last_value", "lag"),
              "l_shipmode")
        + [("rmin", "min", "l_shipmode", {"running": True}),
           ("fmax", "max", "l_shipmode", {"frame": (3, 0)}),
           ("n", "count", None, {})]),
    "no_partition": (
        (), (("l_orderkey", False), ("l_linenumber", True)),
        [("rn", "row_number", None, {}), ("drk", "dense_rank", None, {}),
         ("rs", "sum", "l_quantity", {"running": True}),
         ("mv", "avg", "l_discount", {"frame": (2, 2)})]),
}


@pytest.mark.parametrize("case", list(LINEITEM_CASES))
def test_lineitem_windows_match_reference(tpch_cats, case):
    part, order, specs = LINEITEM_CASES[case]
    cols = ("l_orderkey", "l_linenumber", "l_quantity", "l_extendedprice",
            "l_discount", "l_returnflag", "l_shipmode", "l_shipdate")
    got = window_both(tpch_cats, "lineitem", cols, part, order, specs)
    assert len(got["l_orderkey"]) > 0
    if case == "string_partition_desc":
        assert isinstance(got["min_l_shipmode"][0], str)


def test_rel_window_matches_reference(tpch_cats):
    """Rel.window (one frame for every function) builds the same plan and
    result in both packages."""
    jcat, tcat = tpch_cats
    out = []
    for R, cat, run in ((JRel, jcat, jrun), (TRel, tcat, trun)):
        rel = R.scan(cat, "orders", ("o_custkey", "o_totalprice",
                                     "o_orderkey", "o_orderpriority"))
        w = rel.window(["o_custkey"], [("o_totalprice", False),
                                       ("o_orderkey", False)],
                       [("rs", "sum", "o_totalprice"),
                        ("mx", "max", "o_orderpriority"),
                        ("prev", "lag", "o_orderkey", 2)], running=True)
        out.append((repr(w.plan), w.run()))
    assert out[1][0] == out[0][0]
    results_equal(out[1][1], out[0][1])


# ---------------------------------------------------------------------------
# hand-built tables: ties, NULLs, NaN, infinities


def _hand_tables():
    rng = np.random.default_rng(29)
    n = 240
    f = np.round(rng.normal(0, 4, n), 1)
    f[::17] = np.nan
    f[5::23] = np.inf
    f[7::29] = -np.inf
    raw = {
        "g": rng.integers(0, 5, n),
        "o": rng.integers(0, 30, n),
        "d": rng.integers(-500, 500, n),
        "x": rng.integers(-50, 50, n),
        "f": f,
        "s": np.array([f"s{v:02d}" for v in rng.integers(0, 12, n)],
                      dtype=object),
    }
    valids = {"g": rng.random(n) > 0.05, "o": rng.random(n) > 0.08,
              "d": rng.random(n) > 0.1, "x": rng.random(n) > 0.1,
              "f": rng.random(n) > 0.06, "s": rng.random(n) > 0.1}
    types = {"g": (jty.INT64, tty.INT64), "o": (jty.INT64, tty.INT64),
             "d": (jty.DECIMAL(12, 2), tty.DECIMAL(12, 2)),
             "x": (jty.INT64, tty.INT64),
             "f": (jty.FLOAT64, tty.FLOAT64),
             "s": (jty.STRING, tty.STRING)}
    mx, mn = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    ext = {"g": np.array([1, 1, 1, 1, 2, 2, 2]),
           "o": np.arange(7),
           "v": np.array([mx, mn, mx, 5, mn, mx, 0])}
    ext_valid = {"v": np.array([1, 1, 1, 0, 1, 1, 0], dtype=bool)}
    ext_types = {c: (jty.INT64, tty.INT64) for c in ext}
    return {"h": (types, raw, valids), "ext": (ext_types, ext, ext_valid)}


@pytest.fixture(scope="module")
def hand_cats():
    return both_catalogs(_hand_tables())


FRAMED = ("sum", "count", "avg", "min", "max", "first_value", "last_value")


def _framed(cols, funcs=FRAMED, **opts):
    return [(f"{f}_{c}_{i}", f, c, dict(opts))
            for i, (c, f) in enumerate((c, f) for c in cols for f in funcs)]


# each frame kind runs every framed function over one column, and a few
# more over the other column types (FLOAT with NaN and infinities,
# DECIMAL, STRING through its rank table)
HAND_CASES = {
    "rows": (("g",), (("o", False), ("x", False)),
             _framed(("x",), frame=(2, 1))
             + _framed(("f",), ("sum", "min", "first_value"), frame=(2, 1))
             # 2 FOLLOWING .. 3 FOLLOWING: empty past the partition edge
             + _framed(("s",), ("min", "max", "last_value"), frame=(-2, 3))
             + _framed(("d",), ("sum",), frame=(None, None))
             + [("n", "count", None, {"frame": (1, 1)})]),
    "range_int": (("g",), (("o", False),),
                  _framed(("x",), frame=(1, 2), frame_kind="range")
                  + _framed(("f",), ("sum", "min"), frame=(1, 2),
                            frame_kind="range")
                  + _framed(("d",), ("sum",), frame=(None, 0),
                            frame_kind="range")
                  + _framed(("x",), ("max",), frame=(0, None),
                            frame_kind="range")),
    "range_decimal_desc": (("g",), (("d", True),),
                           _framed(("x",), ("sum", "min", "first_value",
                                            "count"),
                                   frame=(0.5, 1.25), frame_kind="range")),
    "range_float_nan_inf": (("g",), (("f", True),),
                            _framed(("x",), ("sum", "min", "last_value",
                                             "count"),
                                    frame=(1.5, None), frame_kind="range")
                            + _framed(("s",), ("min",), frame=(1.5, None),
                                      frame_kind="range")
                            + _framed(("d",), ("avg",), frame=(0, 2.0),
                                      frame_kind="range")),
    "range_peers_multikey": (("s",), (("o", False), ("x", True)),
                             _framed(("d",), ("sum", "max"),
                                     frame=(None, 0), frame_kind="range")),
    "groups": (("g",), (("o", False),),
               _framed(("x",), frame=(1, 1), frame_kind="groups")
               + _framed(("f",), ("sum",), frame=(None, 0),
                         frame_kind="groups")
               + _framed(("d",), ("min",), frame=(0, 2),
                         frame_kind="groups")),
    "exclude": (("g",), (("o", False),),
                _framed(("x",), ("sum", "min", "first_value", "count"),
                        frame=(2, 2), exclude="current")
                + _framed(("d",), ("sum", "max", "last_value"), frame=(2, 2),
                          exclude="group")
                + _framed(("x",), ("sum", "min", "avg", "count"),
                          frame=(3, 1), exclude="ties")
                + _framed(("f",), ("sum", "min"), frame=(None, None),
                          frame_kind="range", exclude="group")
                + _framed(("d",), ("max",), frame=(1, 1),
                          frame_kind="groups", exclude="ties")),
    "ranks_with_nulls": (("g",), (("o", True),),
                         [("rk", "rank", None, {}),
                          ("drk", "dense_rank", None, {}),
                          ("cd", "cume_dist", None, {}),
                          ("pr", "percent_rank", None, {}),
                          ("nt", "ntile", None, {"offset": 4}),
                          ("lead_s", "lead", "s", {}),
                          ("rmin", "min", "s", {"running": True}),
                          ("rmax", "max", "f", {"running": True}),
                          ("wmin", "min", "f", {}),
                          ("rsum", "sum", "f", {"running": True})]),
}


@pytest.mark.parametrize("case", list(HAND_CASES))
def test_frames_match_reference(hand_cats, case):
    part, order, specs = HAND_CASES[case]
    got = window_both(hand_cats, "h", None, part, order, specs)
    assert len(got["g"]) == 240


def test_int64_extremes_match_reference(hand_cats):
    """Values at int64 max and min beside NULLs: min/max/sum results at
    the extremes are values, not the identity sentinels."""
    specs = ([(f"{f}_w", f, "v", {}) for f in ("min", "max", "first_value")]
             + [(f"{f}_r", f, "v", {"frame": (1, 0)})
                for f in ("min", "max", "count")]
             + [("rmax", "max", "v", {"running": True})])
    got = window_both(hand_cats, "ext", None, ("g",), (("o", False),), specs)
    mx = np.iinfo(np.int64).max
    assert list(got["max_w"][:4]) == [mx] * 4


def test_compute_windows_bytes_order_key():
    """ORDER BY a BYTES column at the module level: peers compare every
    lane, so ties on b"ab" and b"ba" share ranks."""
    keys = np.zeros((6, 4), dtype=np.uint8)
    for i, v in enumerate([b"ba", b"ab", b"aa", b"bb", b"ab", b"ba"]):
        keys[i, : len(v)] = np.frombuffer(v, dtype=np.uint8)
    arrays = {"g": np.ones(6, np.int64), "k": keys, "v": np.arange(6)}
    outs = []
    for ty, batch, sort_m, win_m in ((jty, jbatch, jsort, jwin),
                                     (tty, tbatch, tsort, twin)):
        schema = ty.Schema.of(g=ty.INT64, k=ty.BYTES(4), v=ty.INT64)
        kw = {"device": "cpu"} if batch is tbatch else {}
        b = batch.from_host(schema, arrays, capacity=8, **kw)
        specs = tuple(win_m.WindowSpec(f, c, f) for f, c in (
            ("rank", None), ("dense_rank", None), ("row_number", None),
            ("lag", 2), ("cume_dist", None)))
        out = win_m.compute_windows(b, schema, (0,), (sort_m.SortKey(1),),
                                    specs)
        outs.append([(np.asarray(c.data), np.asarray(c.valid))
                     for c in out.cols] + [np.asarray(out.mask)])
    for (jd, jv), (td, tv) in zip(outs[0][:-1], outs[1][:-1]):
        m = outs[0][-1]
        np.testing.assert_array_equal(tv[m], jv[m])
        np.testing.assert_array_equal(td[m][tv[m]], jd[m][jv[m]])
    np.testing.assert_array_equal(outs[1][-1], outs[0][-1])
    np.testing.assert_array_equal(np.sort(outs[1][3][0][:6]),
                                  [1, 2, 2, 4, 4, 6])


def test_window_plan_node_builds_window_op(tpch_cats):
    _, tcat = tpch_cats
    rel = TRel.scan(tcat, "orders", ("o_custkey", "o_orderkey")).window(
        ["o_custkey"], [("o_orderkey", False)], [("rn", "row_number", None)])
    root = tbuilder.build(rel.plan, tcat)
    assert isinstance(root, tops.WindowOp)


# ---------------------------------------------------------------------------
# merge join


def _mj_tables():
    mx = np.iinfo(np.int64).max
    i64 = (jty.INT64, tty.INT64)
    s = (jty.STRING, tty.STRING)
    return {
        "t1": ({"a": i64, "x": i64},
               {"a": np.array([1, 2, 2, 3, 9]), "x": np.arange(5)}, None),
        "t2": ({"b": i64, "y": i64},
               {"b": np.array([2, 2, 3, 4]), "y": np.arange(4) * 10}, None),
        "e1": ({"a": i64, "x": i64},
               {"a": np.array([mx, 5]), "x": np.array([1, 2])}, None),
        "e2": ({"b": i64, "y": i64},
               {"b": np.array([mx, 7]), "y": np.array([10, 20])}, None),
        "c1": ({"a": i64, "s": s, "x": i64},
               {"a": np.array([1, 1, 2, 2, 3, 0]),
                "s": np.array(["u", "v", "u", "u", "u", "u"], dtype=object),
                "x": np.arange(6)},
               {"a": np.array([1, 1, 1, 1, 1, 0], dtype=bool),
                "s": np.array([1, 1, 1, 1, 0, 1], dtype=bool)}),
        "c2": ({"b": i64, "t": s, "y": i64},
               {"b": np.array([1, 2, 2, 3, 0]),
                "t": np.array(["v", "u", "u", "w", "u"], dtype=object),
                "y": np.arange(5) * 10},
               {"b": np.array([1, 1, 1, 1, 0], dtype=bool)}),
    }


@pytest.fixture(scope="module")
def mj_cats():
    return both_catalogs(_mj_tables())


MJ_CASES = {
    "dups_inner": ("t1", "t2", ("a", "b"), "inner"),
    "dups_semi": ("t1", "t2", ("a", "b"), "semi"),
    "dups_anti": ("t1", "t2", ("a", "b"), "anti"),
    "dups_left": ("t1", "t2", ("a", "b"), "left"),
    "int64_extremes": ("e1", "e2", ("a", "b"), "inner"),
    "composite_inner": ("c1", "c2", [("a", "b"), ("s", "t")], "inner"),
    "composite_semi": ("c1", "c2", [("a", "b"), ("s", "t")], "semi"),
    "composite_anti": ("c1", "c2", [("a", "b"), ("s", "t")], "anti"),
}


@pytest.mark.parametrize("case", list(MJ_CASES))
def test_merge_join_matches_reference(mj_cats, case):
    left, right, on, how = MJ_CASES[case]
    jcat, tcat = mj_cats
    out = []
    for R, cat, run, bld in ((JRel, jcat, jrun, jbuilder),
                             (TRel, tcat, trun, tbuilder)):
        rel = R.scan(cat, left).merge_join(R.scan(cat, right), on, how=how)
        out.append((repr(rel.plan), run(bld.build(rel.plan, cat))))
    assert out[1][0] == out[0][0]
    results_equal(out[1][1], out[0][1])
    if case == "int64_extremes":
        assert list(out[1][1]["y"]) == [10]


def test_merge_join_equals_hash_join(tpch_cats):
    """lineitem x orders on the order key: the merge join equals the hash
    join (as multisets of rows), and the reference's merge join."""
    jcat, tcat = tpch_cats
    res = {}
    for name, R, cat in (("ref", JRel, jcat), ("port", TRel, tcat)):
        li = R.scan(cat, "lineitem", ("l_orderkey", "l_quantity"))
        orders = R.scan(cat, "orders", ("o_orderkey", "o_totalprice"))
        res[name] = (li.merge_join(orders, ("l_orderkey", "o_orderkey")).run(),
                     li.join(orders, on=[("l_orderkey", "o_orderkey")],
                             build_unique=False).run())
    mj, hj = res["port"]
    rows = lambda d: sorted(zip(*(list(v) for v in d.values())))  # noqa
    assert len(mj["l_orderkey"]) > 0
    assert rows(mj) == rows(hj)
    results_equal(mj, res["ref"][0])


def test_merge_join_builds_merge_join_op(mj_cats):
    _, tcat = mj_cats
    rel = TRel.scan(tcat, "t1").merge_join(TRel.scan(tcat, "t2"), ("a", "b"))
    root = tbuilder.build(rel.plan, tcat)
    assert isinstance(root, tops.MergeJoinOp)
    assert isinstance(root.build, tops.ScanOp)
