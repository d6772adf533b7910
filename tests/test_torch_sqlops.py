"""The port's SQL kernels against the JAX reference on the CPU, on the same
seeded inputs: expression evaluation (tests/test_expr.py's cases and a
matrix over every node kind, negative DECIMALs and NULLs included),
sort-key packing and stable sorts, segmented scans, sort-based and dense
aggregation, and the unique-build join strategies. Integer, DECIMAL,
DATE, BOOL and code results equal exactly; FLOAT results within
rtol=1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cockroach_tpu import coldata as jcd
from cockroach_tpu.ops import aggregation as jagg
from cockroach_tpu.ops import expr as jex
from cockroach_tpu.ops import join as jjoin
from cockroach_tpu.ops import keys as jkeys
from cockroach_tpu.ops import segscan as jseg
from cockroach_tpu.ops import sort as jsort
from cockroach_tpu_torch.coldata import batch as tbatch
from cockroach_tpu_torch.coldata import types as tty
from cockroach_tpu_torch.ops import aggregation as tagg
from cockroach_tpu_torch.ops import expr as tex
from cockroach_tpu_torch.ops import join as tjoin
from cockroach_tpu_torch.ops import keys as tkeys
from cockroach_tpu_torch.ops import segscan as tseg
from cockroach_tpu_torch.ops import sort as tsort

RTOL = 1e-12


def port_type(t) -> tty.SQLType:
    return tty.SQLType(tty.Family(t.family.value), t.width, t.precision,
                       t.scale)


def pair(jschema, arrays, valids=None, capacity=None, mask=None):
    """The same host columns as a reference batch and a port batch."""
    tschema = tty.Schema(jschema.names,
                         tuple(port_type(t) for t in jschema.types))
    jb = jcd.from_host(jschema, arrays, valids=valids, capacity=capacity)
    tb = tbatch.from_host(tschema, arrays, valids=valids, capacity=capacity,
                          device="cpu")
    if mask is not None:
        jb = jb.with_mask(jb.mask & mask)
        tb = tb.with_mask(tb.mask & torch.from_numpy(mask))
    return jschema, tschema, jb, tb


def as_np(x) -> np.ndarray:
    """A reference or port array as numpy; 64-bit words compare as their
    bit patterns (the port carries uint64 as int64)."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int64) if a.dtype == np.uint64 else a


def same(got, want, where=None, rtol=RTOL):
    g, w = as_np(got), as_np(want)
    if where is not None:
        g, w = g[where], w[where]
    if w.dtype.kind == "f" or g.dtype.kind == "f":
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), rtol=rtol, atol=0)
    else:
        np.testing.assert_array_equal(g, w)


def same_host(got: dict, want: dict, rtol=RTOL):
    assert list(got) == list(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape, k
        if b.dtype.kind == "f" and a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=k)
        else:
            assert all(x == y or (x is None and y is None)
                       or (x != x and y != y) for x, y in zip(a, b)), k


# ---------------------------------------------------------------------------
# expressions


@pytest.fixture(scope="module")
def expr_batch():
    rng = np.random.default_rng(12)
    n = 200
    schema = jcd.Schema.of(
        a=jcd.INT64, b=jcd.FLOAT64, d=jcd.DECIMAL(10, 2),
        e=jcd.DECIMAL(12, 4), dt=jcd.DATE, s=jcd.STRING, x=jcd.BOOL,
        y=jcd.BOOL, ts=jcd.TIMESTAMP, i32=jcd.INT32,
    )
    arrays = {
        "a": rng.integers(-40, 40, n),
        "b": np.round(rng.normal(0, 20, n), 3),
        "d": rng.integers(-100_000, 100_000, n),  # -1000.00 .. 1000.00
        "e": rng.integers(-10**7, 10**7, n),
        "dt": rng.integers(-40_000, 40_000, n).astype(np.int32),
        "s": rng.integers(0, 5, n).astype(np.int32),
        "x": rng.random(n) < 0.5,
        "y": rng.random(n) < 0.5,
        "ts": rng.integers(-10**15, 10**15, n),
        "i32": rng.integers(-1000, 1000, n).astype(np.int32),
    }
    arrays["d"][:8] = [-155, 155, -150, 150, -5, 5, 0, -1]  # rounding ties
    valids = {c: rng.random(n) < 0.85 for c in ("a", "d", "b", "y", "dt")}
    return pair(schema, arrays, valids=valids, capacity=256)


def _c(name):
    return ("col", name)


COLS = {"a": 0, "b": 1, "d": 2, "e": 3, "dt": 4, "s": 5, "x": 6, "y": 7,
        "ts": 8, "i32": 9}
D2 = ("DECIMAL", 10, 2)

# expression trees as nested tuples, built in either package by _build
EXPRS = [
    ("Cmp", "gt", _c("a"), ("lit", 1)),
    ("Cmp", "le", _c("d"), ("const", 3.99, D2)),
    ("Cmp", "lt", _c("d"), _c("e")),
    ("Cmp", "ge", _c("b"), _c("d")),
    ("Cmp", "eq", _c("dt"), ("lit", 10957)),
    ("Cmp", "ne", _c("s"), ("const", 2, ("INT32",))),
    ("BinOp", "+", _c("a"), _c("a")),
    ("BinOp", "-", _c("a"), ("lit", 7)),
    ("BinOp", "*", _c("a"), _c("i32")),
    ("BinOp", "+", _c("d"), _c("e")),
    ("BinOp", "-", _c("d"), _c("e")),
    ("BinOp", "*", _c("d"), _c("e")),
    ("BinOp", "*", _c("d"), ("BinOp", "-", ("const", 1.0, D2), _c("d"))),
    ("BinOp", "/", _c("d"), _c("a")),
    ("BinOp", "/", _c("a"), ("lit", 0)),
    ("BinOp", "+", _c("b"), _c("d")),
    ("BinOp", "*", _c("b"), _c("b")),
    ("BinOp", "+", _c("dt"), ("lit", 30)),
    ("BinOp", "-", _c("d"), _c("a")),
    ("and", ("Cmp", "gt", _c("a"), ("lit", 0)), _c("y")),
    ("or", _c("x"), _c("y"), ("Cmp", "lt", _c("b"), ("lit", 0.0))),
    ("Not", _c("y")),
    ("IsNull", _c("d"), False),
    ("IsNull", _c("a"), True),
    ("Case", ((("Cmp", "gt", _c("a"), ("lit", 3)), ("lit", 100)),
              (("Cmp", "lt", _c("a"), ("lit", -3)), ("lit", -100))),
     ("lit", 0)),
    ("Case", ((_c("y"), _c("d")),), ("const", -2.5, D2)),
    ("Coalesce", (_c("a"), _c("i32"), ("lit", 0))),
    ("Coalesce", (_c("d"), ("const", 0.0, D2))),
    ("Greatest", (_c("a"), ("lit", 2), _c("i32")), False),
    ("Greatest", (_c("d"), ("const", 1.5, D2)), True),
    ("Greatest", (_c("b"), _c("d"), _c("a")), False),
    ("Cast", _c("d"), ("INT64",)),
    ("Cast", _c("d"), ("DECIMAL", 10, 1)),
    ("Cast", _c("e"), ("DECIMAL", 12, 0)),
    ("Cast", _c("d"), ("DECIMAL", 12, 4)),
    ("Cast", _c("b"), ("INT64",)),
    ("Cast", _c("b"), ("DECIMAL", 12, 2)),
    ("Cast", _c("a"), ("DECIMAL", 12, 2)),
    ("Cast", _c("d"), ("FLOAT64",)),
    ("Cast", _c("a"), ("BOOL",)),
    ("Cast", _c("d"), ("BOOL",)),
    ("Cast", _c("dt"), ("TIMESTAMP",)),
    ("Cast", _c("ts"), ("DATE",)),
    ("Cast", _c("a"), ("INT32",)),
    ("ExtractYear", _c("dt")),
    ("ExtractYear", _c("ts")),
    ("CodeLookup", "s", "bool"),
    ("CodeLookup", "s", "string"),
] + [("ExtractPart", p, _c("dt")) for p in jex.EXTRACT_PARTS] + [
    ("ExtractPart", "epoch", _c("ts")), ("ExtractPart", "month", _c("ts")),
] + [("Func1", f, _c(c)) for f in ("abs", "ceil", "floor", "round",
                                   "sign", "trunc")
     for c in ("a", "b", "d")] + [
    ("Func1", f, _c("b")) for f in ("sqrt", "cbrt", "exp", "ln", "log10",
                                    "degrees", "radians", "sin", "cos",
                                    "tan", "cot", "asin", "acos", "atan",
                                    "sinh", "cosh", "tanh")] + [
    ("Func1", "sqrt", _c("d")), ("Func1", "ln", _c("a")),
    ("Func2", "pow", _c("b"), ("lit", 2.0)),
    ("Func2", "pow", _c("d"), ("lit", 0.5)),
    ("Func2", "atan2", _c("b"), _c("d")),
    ("Func2", "mod", _c("a"), ("lit", -7)),
    ("Func2", "mod", _c("i32"), _c("a")),
    ("Func2", "div", _c("i32"), _c("a")),
    ("Func2", "div", _c("b"), ("lit", 3.0)),
    ("Func2", "mod", _c("b"), _c("d")),
    ("Func2", "round2", _c("d"), ("lit", 1)),
    ("Func2", "round2", _c("d"), ("lit", 3)),
    ("Func2", "round2", _c("b"), ("lit", 2)),
    ("Func2", "round2", _c("a"), ("lit", -1)),
    ("Param", 0, ("INT64",), _c("a")),
]


def _type(m, spec):
    kind = spec[0]
    if kind == "DECIMAL":
        return m.DECIMAL(spec[1], spec[2])
    return getattr(m, kind)


def _build(e, ex, tmod):
    """One expression tree in the package whose expr module is `ex` and
    whose type constructors live in `tmod`."""
    k = e[0]

    def b(x):
        return _build(x, ex, tmod)

    if k == "col":
        return ex.ColRef(COLS[e[1]])
    if k == "lit":
        return ex.lit(e[1])
    if k == "const":
        return ex.Const(e[1], _type(tmod, e[2]))
    if k in ("Cmp", "BinOp"):
        return getattr(ex, k)(e[1], b(e[2]), b(e[3]))
    if k in ("and", "or"):
        return ex.BoolOp(k, tuple(b(x) for x in e[1:]))
    if k == "Not":
        return ex.Not(b(e[1]))
    if k == "IsNull":
        return ex.IsNull(b(e[1]), e[2])
    if k == "Case":
        return ex.Case(tuple((b(c), b(v)) for c, v in e[1]), b(e[2]))
    if k == "Coalesce":
        return ex.Coalesce(tuple(b(x) for x in e[1]))
    if k == "Greatest":
        return ex.Greatest(tuple(b(x) for x in e[1]), e[2])
    if k == "Cast":
        return ex.Cast(b(e[1]), _type(tmod, e[2]))
    if k == "ExtractYear":
        return ex.ExtractYear(b(e[1]))
    if k == "ExtractPart":
        return ex.ExtractPart(e[1], b(e[2]))
    if k == "Func1":
        return ex.Func1(e[1], b(e[2]))
    if k == "Func2":
        return ex.Func2(e[1], b(e[2]), b(e[3]))
    if k == "CodeLookup":
        if e[2] == "bool":
            return ex.CodeLookup(COLS[e[1]],
                                 np.array([True, False, True, True, False]))
        return ex.CodeLookup(COLS[e[1]], np.array([4, 3, 2, 1, 0], np.int32),
                             out_type=tmod.STRING)
    if k == "Param":
        return ex.BinOp("+", b(e[3]), ex.Param(e[1], _type(tmod, e[2])))
    raise AssertionError(k)


def _eval(e, ex, tmod, cols, schema):
    tree = _build(e, ex, tmod)
    with ex.param_scope((11,)):
        return ex.eval_expr(tree, cols, schema)


@pytest.mark.parametrize("e", EXPRS, ids=[str(i) for i in range(len(EXPRS))])
def test_eval_expr_matches_reference(expr_batch, e):
    jschema, tschema, jb, tb = expr_batch
    wd, wv = _eval(e, jex, jcd, jb.cols, jschema)
    gd, gv = _eval(e, tex, tty, tb.cols, tschema)
    want_t = jex.expr_type(_build(e, jex, jcd), jschema)
    assert tex.expr_type(_build(e, tex, tty), tschema) == port_type(want_t)
    same(gv, wv)
    v = as_np(wv)
    assert as_np(gd).dtype == as_np(wd).dtype
    same(gd, wd, where=v)


def test_filter_mask_matches_reference(expr_batch):
    jschema, tschema, jb, tb = expr_batch
    e = ("and", ("Cmp", "gt", _c("d"), ("const", -250.0, D2)),
         ("or", _c("y"), ("Cmp", "le", _c("a"), ("lit", 5))))
    same(tex.filter_mask(tb, tschema, _build(e, tex, tty)),
         jex.filter_mask(jb, jschema, _build(e, jex, jcd)))


def test_expr_bounds_match_reference():
    schema = jcd.Schema.of(a=jcd.INT64, dt=jcd.DATE, d=jcd.DECIMAL(12, 2))
    tschema = tty.Schema(schema.names, tuple(port_type(t)
                                             for t in schema.types))
    stats = {0: (-5, 9), 1: (8035, 10500), 2: (0, 100)}
    trees = [("BinOp", "*", _c("a"), ("lit", -3)), ("ExtractYear", ("col", "dt")),
             ("BinOp", "-", _c("a"), _c("a")), ("Cast", _c("a"), ("INT32",)),
             ("BinOp", "+", _c("d"), ("lit", 1))]
    cols = {"a": 0, "dt": 1, "d": 2}
    for t in trees:
        def bind(x):
            if isinstance(x, tuple) and x and x[0] == "col":
                return ("colidx", cols[x[1]])
            return tuple(bind(y) for y in x) if isinstance(x, tuple) else x

        def build(x, ex, tmod):
            if x[0] == "colidx":
                return ex.ColRef(x[1])
            return _build(x, ex, tmod) if x[0] in ("lit", "const") else \
                _rebuild(x, ex, tmod, build)

        got = tex.expr_bounds(build(bind(t), tex, tty), tschema, stats)
        want = jex.expr_bounds(build(bind(t), jex, jcd), schema, stats)
        assert got == want, t


def _rebuild(x, ex, tmod, build):
    k = x[0]
    if k in ("Cmp", "BinOp"):
        return getattr(ex, k)(x[1], build(x[2], ex, tmod),
                              build(x[3], ex, tmod))
    if k == "ExtractYear":
        return ex.ExtractYear(build(x[1], ex, tmod))
    if k == "Cast":
        return ex.Cast(build(x[1], ex, tmod), _type(tmod, x[2]))
    raise AssertionError(k)


def test_test_expr_cases():
    """tests/test_expr.py's oracles, held by the port directly."""
    schema = tty.Schema.of(a=tty.INT64, b=tty.FLOAT64, d=tty.DECIMAL(10, 2),
                           dt=tty.DATE)
    b = tbatch.from_host(schema, {
        "a": np.array([1, 2, 3, 4, 5]),
        "b": np.array([0.5, 1.5, 2.5, 3.5, 4.5]),
        "d": np.array([100, 250, 399, 1000, 5]),
        "dt": np.array([0, 365, 10956, 10957, 19000], dtype=np.int32),
    }, valids={"a": np.array([True, True, False, True, True])}, capacity=8,
        device="cpu")
    m = tex.filter_mask(b, schema, tex.Cmp("gt", tex.ColRef(0), tex.lit(1)))
    assert m.numpy()[:5].tolist() == [False, True, False, True, True]
    pred = tex.Cmp("le", tex.ColRef(2), tex.Const(3.99, tty.DECIMAL(10, 2)))
    assert tex.filter_mask(b, schema, pred).numpy()[:5].tolist() == [
        True, True, True, False, True]
    d, _ = tex.eval_expr(tex.BinOp("*", tex.ColRef(2), tex.ColRef(2)),
                         b.cols, schema)
    assert int(d[1]) == 62500
    d, _ = tex.eval_expr(tex.ExtractYear(tex.ColRef(3)), b.cols, schema)
    assert d.numpy()[:5].tolist() == [1970, 1971, 1999, 2000, 2022]
    d, v = tex.eval_expr(tex.BinOp("/", tex.ColRef(0), tex.lit(0)), b.cols,
                         schema)
    assert not v.numpy()[:5].any()


# ---------------------------------------------------------------------------
# sort keys and sorts


@pytest.fixture(scope="module")
def sort_batch():
    rng = np.random.default_rng(21)
    n = 300
    schema = jcd.Schema.of(i=jcd.INT64, f=jcd.FLOAT64, d=jcd.DECIMAL(12, 2),
                           dt=jcd.DATE, s=jcd.STRING, b=jcd.BOOL,
                           w=jcd.BYTES(12))
    f = rng.integers(-3, 3, n).astype(np.float64)
    f[rng.random(n) < 0.1] = np.nan
    arrays = {
        "i": rng.integers(-4, 4, n), "f": f,
        "d": rng.integers(-300, 300, n),
        "dt": rng.integers(9000, 9010, n).astype(np.int32),
        "s": rng.integers(0, 4, n).astype(np.int32),
        "b": rng.random(n) < 0.5,
        "w": rng.integers(0, 3, (n, 12)).astype(np.uint8),
    }
    valids = {c: rng.random(n) < 0.85 for c in ("i", "f", "d", "s")}
    mask = rng.random(512) < 0.9
    batches = pair(schema, arrays, valids=valids, capacity=512, mask=mask)
    ranks = jcd.Dictionary(np.array(["m", "b", "z", "a"], dtype=object)).ranks
    return batches, {4: ranks}


SORT_KEYS = [
    ((0, False, None),),
    ((0, True, None),),
    ((0, False, False), (2, True, True)),
    ((1, True, None), (0, False, None)),
    ((1, False, None),),
    ((4, False, None), (0, True, None)),
    ((5, True, None), (3, False, None), (2, False, None)),
    ((6, False, None),),
    ((6, True, None), (4, True, False)),
]


@pytest.mark.parametrize("keys", SORT_KEYS, ids=[str(i) for i in
                                                 range(len(SORT_KEYS))])
@pytest.mark.parametrize("stats", [False, True])
def test_sort_perm_matches_reference(sort_batch, keys, stats):
    (jschema, tschema, jb, tb), ranks = sort_batch
    col_stats = {0: (-4, 3), 2: (-300, 299), 3: (9000, 9009)} if stats else None
    jk = tuple(jsort.SortKey(*k) for k in keys)
    tk = tuple(tsort.SortKey(*k) for k in keys)
    want_ops = jsort.pack_sort_operands(jb, jschema, jk, ranks, col_stats)
    got_ops = tsort.pack_sort_operands(tb, tschema, tk, ranks, col_stats)
    assert len(got_ops) == len(want_ops)
    for g, w in zip(got_ops, want_ops):
        same(g, w, rtol=0)
    same(tsort.sort_perm(tb, tschema, tk, ranks, col_stats),
         jsort.sort_perm(jb, jschema, jk, ranks, col_stats))


@pytest.mark.parametrize("col", range(7))
@pytest.mark.parametrize("desc", [False, True])
def test_order_keys_match_reference(sort_batch, col, desc):
    (jschema, tschema, jb, tb), ranks = sort_batch
    jk, tk = jsort.SortKey(col, desc), tsort.SortKey(col, desc)
    want = jsort.order_keys(jb.cols[col].data, jb.cols[col].valid, jk,
                            jschema.types[col], ranks.get(col))
    got = tsort.order_keys(tb.cols[col].data, tb.cols[col].valid, tk,
                           tschema.types[col], ranks.get(col))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        same(g, w, rtol=0)


def test_key_segment_packing_straddles_words():
    """Segments of 1, 37, 64 and 29 bits cross word boundaries: the
    packed words equal the reference's bit patterns."""
    rng = np.random.default_rng(4)
    n = 100
    vals = [rng.integers(0, 2, n), rng.integers(0, 1 << 37, n),
            rng.integers(-(1 << 62), 1 << 62, n), rng.integers(0, 1 << 29, n)]
    bits = [1, 37, 64, 29]
    jsegs = [jkeys.BitSeg(b, jnp.asarray(v).astype(jnp.uint64))
             for b, v in zip(bits, vals)]
    tsegs = [tkeys.BitSeg(b, torch.from_numpy(v)) for b, v in zip(bits, vals)]
    want = jkeys.pack_operands(jsegs)
    got = tkeys.pack_operands(tsegs)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        same(g, w, rtol=0)


def test_limit_mask_matches_reference(sort_batch):
    (jschema, tschema, jb, tb), _ = sort_batch
    same(tsort.limit_mask(tb, 17, offset=5).mask,
         jsort.limit_mask(jb, 17, offset=5).mask)


# ---------------------------------------------------------------------------
# segmented scans


@pytest.fixture(scope="module")
def seg_inputs():
    rng = np.random.default_rng(8)
    n = 300
    boundary = rng.random(n) < 0.1
    boundary[0] = True
    vals = rng.integers(-1000, 1000, n)
    live = np.ones(n, bool)
    live[-37:] = False
    return boundary, vals, live


@pytest.mark.parametrize("op", ["add", "minimum", "maximum"])
@pytest.mark.parametrize("reverse", [False, True])
def test_seg_scan_matches_reference(seg_inputs, op, reverse):
    boundary, vals, _ = seg_inputs
    want = jseg.seg_scan(getattr(jnp, op), jnp.asarray(vals),
                         jnp.asarray(boundary), reverse=reverse)
    got = tseg.seg_scan(getattr(torch, op), torch.from_numpy(vals),
                        torch.from_numpy(boundary), reverse=reverse)
    same(got, want)


def test_seg_scan_multi_ends_totals_match_reference(seg_inputs):
    boundary, vals, live = seg_inputs
    jb, jv, jl = (jnp.asarray(x) for x in (boundary, vals, live))
    tb, tv, tl = (torch.from_numpy(x) for x in (boundary, vals, live))
    want = jseg.seg_scan_multi([jnp.add, jnp.maximum], [jv, jv * 3], jb)
    got = tseg.seg_scan_multi([torch.add, torch.maximum], [tv, tv * 3], tb)
    for g, w in zip(got, want):
        same(g, w)
    same(tseg.seg_ends(tb, tl), jseg.seg_ends(jb, jl))
    same(tseg.totals_everywhere(got[0], tb, tl),
         jseg.totals_everywhere(want[0], jb, jl))
    n_want = int(boundary.sum())
    for cap_out in (n_want, 400):
        w = jseg.compact_to_slots(jb, cap_out)
        g = tseg.compact_to_slots(tb, cap_out)
        same(g[:n_want], w[:n_want])
        assert g.shape[0] == w.shape[0]


# ---------------------------------------------------------------------------
# aggregation


@pytest.fixture(scope="module")
def agg_batch():
    rng = np.random.default_rng(33)
    n = 400
    schema = jcd.Schema.of(k1=jcd.INT64, k2=jcd.STRING, v=jcd.INT64,
                           f=jcd.FLOAT64, d=jcd.DECIMAL(12, 2), x=jcd.BOOL,
                           dt=jcd.DATE)
    arrays = {
        "k1": rng.integers(0, 6, n), "k2": rng.integers(0, 3, n).astype(
            np.int32),
        "v": rng.integers(-10**6, 10**6, n), "f": rng.normal(0, 100, n),
        "d": rng.integers(-10**5, 10**5, n), "x": rng.random(n) < 0.6,
        "dt": rng.integers(8000, 11000, n).astype(np.int32),
    }
    valids = {c: rng.random(n) < 0.85 for c in ("k1", "k2", "v", "f", "d",
                                                 "x")}
    mask = rng.random(512) < 0.8
    return pair(schema, arrays, valids=valids, capacity=512, mask=mask)


AGGS = [("sum", 2), ("sum", 3), ("sum", 4), ("count", 2), ("count_rows", None),
        ("min", 2), ("max", 4), ("min", 6), ("max", 3), ("avg", 4),
        ("avg", 3), ("any_not_null", 2), ("bool_and", 5), ("bool_or", 5),
        ("sum_f", 4), ("sum_sq", 3)]


def _specs(mod, aggs):
    return tuple(mod.AggSpec(f, c, f"{f}_{c}") for f, c in aggs)


@pytest.mark.parametrize("group_cols,stats", [
    ((0,), None), ((0, 1), None), ((1, 0), {0: (0, 5), 1: (0, 2)}),
    ((6,), None), ((), None),
])
def test_sort_groupby_matches_reference(agg_batch, group_cols, stats):
    jschema, tschema, jb, tb = agg_batch
    want, wn = jagg.sort_groupby(jb, jschema, group_cols, _specs(jagg, AGGS),
                                 col_stats=stats)
    got, gn = tagg.sort_groupby(tb, tschema, group_cols, _specs(tagg, AGGS),
                                col_stats=stats)
    assert int(gn) == int(wn)
    out = jagg.groupby_output_schema(jschema, group_cols, _specs(jagg, AGGS))
    tout = tagg.groupby_output_schema(tschema, group_cols, _specs(tagg, AGGS))
    assert tout.names == out.names
    same_host(tbatch.to_host(got, tout), jcd.to_host(want, out))


def test_sort_groupby_presorted_matches_reference(agg_batch):
    jschema, tschema, jb, tb = agg_batch
    order = np.argsort(np.asarray(jb.cols[0].data), kind="stable")
    jb = jcd.Batch(cols=tuple(jcd.Column(c.data[order], c.valid[order])
                              for c in jb.cols), mask=jb.mask[order])
    t_order = torch.from_numpy(order)
    tb = tbatch.Batch(cols=tuple(tbatch.Column(c.data[t_order],
                                               c.valid[t_order])
                                 for c in tb.cols), mask=tb.mask[t_order])
    aggs = AGGS[:6]
    want, _ = jagg.sort_groupby(jb, jschema, (0,), _specs(jagg, aggs),
                                presorted=True)
    got, _ = tagg.sort_groupby(tb, tschema, (0,), _specs(tagg, aggs),
                               presorted=True)
    out = jagg.groupby_output_schema(jschema, (0,), _specs(jagg, aggs))
    same_host(tbatch.to_host(got, port_out(out)), jcd.to_host(want, out))


def port_out(schema):
    return tty.Schema(schema.names, tuple(port_type(t) for t in schema.types))


DENSE_AGGS = [("sum", 2), ("sum", 4), ("sum", 3), ("count", 4),
              ("count_rows", None), ("min", 2), ("max", 6),
              ("any_not_null", 4), ("avg", 4)]


@pytest.mark.parametrize("kernel", ["scatter", "onehot"])
def test_dense_states_match_reference(agg_batch, kernel):
    jschema, tschema, jb, tb = agg_batch
    group_cols, sizes, lows = (0, 1), (6, 3), (0, 0)
    G, strides = jagg.dense_layout(sizes)
    assert tagg.dense_layout(sizes) == (G, strides)
    jcode, joob = jagg.dense_group_codes(jb, group_cols, strides, sizes, lows)
    tcode, toob = tagg.dense_group_codes(tb, group_cols, strides, sizes, lows)
    same(tcode, jcode)
    same(toob, joob)
    aggs = DENSE_AGGS if kernel == "scatter" else DENSE_AGGS[:-1]
    jspecs, _, jfinal = jagg.partial_layout(jschema, group_cols,
                                            _specs(jagg, aggs))
    tspecs, _, tfinal = tagg.partial_layout(tschema, group_cols,
                                            _specs(tagg, aggs))
    if kernel == "scatter":
        jst, jrows = jagg.dense_scatter_states(jb, jschema, jcode, G, jspecs)
        tst, trows = tagg.dense_scatter_states(tb, tschema, tcode, G, tspecs)
    else:
        jst, jrows = jagg.smallgroup_partial_states(jb, jschema, jcode, G,
                                                    jspecs)
        tst, trows = tagg.smallgroup_partial_states(tb, tschema, tcode, G,
                                                    tspecs)
    same(trows, jrows)
    for (gd, gv), (wd, wv) in zip(tst, jst):
        same(gv, wv)
        same(gd, wd, where=as_np(wv))
    # two tiles' states merge elementwise, then finalize
    jst2 = jagg.merge_dense_states(jspecs, jst, jst)
    tst2 = tagg.merge_dense_states(tspecs, tst, tst)
    want = jagg.dense_finalize(jschema, group_cols, strides, sizes, G, jfinal,
                               jst2, jrows * 2, key_lows=lows)
    got = tagg.dense_finalize(tschema, group_cols, strides, sizes, G, tfinal,
                              tst2, trows * 2, key_lows=lows)
    out = jagg.agg_output_schema(jschema, group_cols, _specs(jagg, aggs))
    same_host(tbatch.to_host(got, port_out(out)), jcd.to_host(want, out))


@pytest.mark.parametrize("func", ["avg", "var", "stddev", "var_pop",
                                  "stddev_pop", "sum"])
def test_partial_layout_and_finalize_match_reference(agg_batch, func):
    jschema, tschema, jb, tb = agg_batch
    aggs = ((func, 4),)
    jspecs, jstate, jfinal = jagg.partial_layout(jschema, (0,),
                                                 _specs(jagg, aggs))
    tspecs, tstate, tfinal = tagg.partial_layout(tschema, (0,),
                                                 _specs(tagg, aggs))
    assert tstate == port_out(jstate)
    assert [s.func for s in tspecs] == [s.func for s in jspecs]
    wpart, _ = jagg.sort_groupby(jb, jschema, (0,), jspecs)
    gpart, _ = tagg.sort_groupby(tb, tschema, (0,), tspecs)
    want = jagg.finalize_states(wpart, jfinal, 1)
    got = tagg.finalize_states(gpart, tfinal, 1)
    out = jagg.agg_output_schema(jschema, (0,), _specs(jagg, aggs))
    assert tagg.agg_output_schema(tschema, (0,), _specs(tagg, aggs)) == \
        port_out(out)
    same_host(tbatch.to_host(got, port_out(out)), jcd.to_host(want, out))


# ---------------------------------------------------------------------------
# joins


def _join_inputs(rng, build_rows=300, probe_rows=700, dense=False):
    bkeys = (np.arange(1, build_rows + 1) if dense
             else rng.permutation(np.arange(5, 5 + 3 * build_rows))[
                 :build_rows])
    bschema = jcd.Schema.of(bk=jcd.INT64, bv=jcd.DECIMAL(12, 2),
                            bs=jcd.STRING)
    barr = {"bk": bkeys, "bv": rng.integers(-10**6, 10**6, build_rows),
            "bs": rng.integers(0, 3, build_rows).astype(np.int32)}
    bmask = rng.random(512) < 0.85
    pschema = jcd.Schema.of(pk=jcd.INT64, pv=jcd.INT64)
    parr = {"pk": rng.integers(0, 3 * build_rows + 10, probe_rows),
            "pv": rng.integers(0, 100, probe_rows)}
    pvalid = {"pk": rng.random(probe_rows) < 0.9}
    pmask = rng.random(1024) < 0.9
    build = pair(bschema, barr, capacity=512, mask=bmask)
    probe = pair(pschema, parr, valids=pvalid, capacity=1024, mask=pmask)
    stats_b = {0: (int(bkeys.min()), int(bkeys.max()))}
    stats_p = {0: (int(parr["pk"].min()), int(parr["pk"].max()))}
    return probe, build, stats_p, stats_b


@pytest.fixture(scope="module")
def join_inputs():
    return _join_inputs(np.random.default_rng(41))


def test_exact_keys_and_index_match_reference(join_inputs):
    probe, build, stats_p, stats_b = join_inputs
    args = (probe[0], (0,), build[0], (0,), stats_p, stats_b, {}, True)
    layout = jjoin.plan_exact_key(*args)
    tlayout = tjoin.plan_exact_key(probe[1], (0,), build[1], (0,), stats_p,
                                   stats_b, {}, True)
    assert (tlayout.segs, tlayout.total_bits) == (layout.segs,
                                                  layout.total_bits)
    for (_, _, jb, tb) in (probe, build):
        wk, wa = jjoin.exact_keys(jb, (0,), layout)
        gk, ga = tjoin.exact_keys(tb, (0,), tlayout)
        same(gk, wk)
        same(ga, wa)
    wsh, word = jjoin.build_index(build[2], build[0], (0,),
                                  exact_layout=layout)
    gsh, gord = tjoin.build_index(build[3], build[1], (0,),
                                  exact_layout=tlayout)
    same(gsh, wsh)
    live = as_np(wsh) != -1  # sentinel ties order arbitrarily in lax.sort
    same(gord, word, where=live)


@pytest.mark.parametrize("side", ["left", "right"])
def test_bsearch_matches_reference(side):
    """Unsigned order over words with bit 63 set, queries past both ends."""
    rng = np.random.default_rng(2)
    words = np.sort(rng.integers(0, 2**64, 257, dtype=np.uint64))
    words[10:14] = words[10]
    queries = np.concatenate([words[::7], rng.integers(0, 2**64, 50,
                                                       dtype=np.uint64),
                              np.array([0, 2**64 - 1], dtype=np.uint64)])
    want = jjoin.bsearch(jnp.asarray(words), jnp.asarray(queries), side=side)
    got = tjoin.bsearch(torch.from_numpy(words.view(np.int64)),
                        torch.from_numpy(queries.view(np.int64)), side=side)
    same(got, want)


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("strategy", ["sorted", "lut"])
def test_unique_join_matches_reference(join_inputs, how, strategy):
    (pjs, pts, pjb, ptb), (bjs, bts, bjb, btb), stats_p, stats_b = join_inputs
    layout = jjoin.plan_exact_key(pjs, (0,), bjs, (0,), stats_p, stats_b, {},
                                  True)
    tlayout = tjoin.plan_exact_key(pts, (0,), bts, (0,), stats_p, stats_b, {},
                                   True)
    jspec, tspec = jjoin.JoinSpec(how), tjoin.JoinSpec(how)
    if strategy == "sorted":
        want = jjoin.hash_join_unique(pjb, pjs, (0,), bjb, bjs, (0,), jspec,
                                      exact_layout=layout)
        got = tjoin.hash_join_unique(ptb, pts, (0,), btb, bts, (0,), tspec,
                                     exact_layout=tlayout)
    else:
        lut = jjoin.build_dense_lut(bjb, (0,), layout)
        tlut = tjoin.build_dense_lut(btb, (0,), tlayout)
        same(tlut, lut)
        wi, wf = jjoin.dense_lut_probe(pjb, (0,), layout, lut)
        gi, gf = tjoin.dense_lut_probe(ptb, (0,), tlayout, tlut)
        same(gf, wf)
        same(gi, wi, where=as_np(wf))
        want = jjoin.emit_unique(pjb, bjb, jspec, wi, wf)
        got = tjoin.emit_unique(ptb, btb, tspec, gi, gf)
    out = jjoin.join_output_schema(pjs, bjs, jspec)
    assert tjoin.join_output_schema(pts, bts, tspec) == port_out(out)
    same_host(tbatch.to_host(got, port_out(out)), jcd.to_host(want, out))


@pytest.mark.parametrize("fanout", [1, 4])
def test_dense_analytic_probe_matches_reference(fanout):
    rng = np.random.default_rng(fanout)
    n_keys = 120
    bschema = jcd.Schema.of(k=jcd.INT64, k2=jcd.INT64, v=jcd.INT64)
    barr = {"k": np.repeat(np.arange(3, 3 + n_keys), fanout),
            "k2": np.tile(np.arange(fanout) * 7, n_keys),
            "v": rng.integers(0, 1000, n_keys * fanout)}
    bmask = rng.random(1024) < 0.8
    bj, bt = pair(bschema, barr, capacity=1024, mask=bmask)[2:]
    pschema = jcd.Schema.of(pk=jcd.INT64, pk2=jcd.INT64)
    m = 500
    parr = {"pk": rng.integers(0, n_keys + 8, m),
            "pk2": rng.integers(0, fanout, m) * 7 + (rng.random(m) < 0.1)}
    pj, pt = pair(pschema, parr, valids={"pk": rng.random(m) < 0.9},
                  capacity=512)[2:]
    keys = (0, 1) if fanout > 1 else (0,)
    jinfo = jjoin.DenseAnalytic(3, fanout, n_keys * fanout)
    tinfo = tjoin.DenseAnalytic(3, fanout, n_keys * fanout)
    wi, wf = jjoin.dense_analytic_probe(pj, keys, bj, keys, jinfo)
    gi, gf = tjoin.dense_analytic_probe(pt, keys, bt, keys, tinfo)
    same(gf, wf)
    same(gi, wi, where=as_np(wf))
    assert as_np(wf).sum() > 50
