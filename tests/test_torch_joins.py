"""The port's duplicate-key and hashed-key joins, row hashing, scalar
aggregation states, top-k selection and DISTINCT against the JAX reference
on the CPU, on the same seeded inputs. Hash bits equal exactly (the
port's int64 bit patterns against the reference's uint64); joins equal as
multisets of rows (the reference's build sort is not stable inside a run
of equal keys); everything else equals exactly, FLOAT within rtol=1e-12."""

import numpy as np
import pytest
import torch

from cockroach_tpu import catalog as jcatalog
from cockroach_tpu import coldata as jcd
from cockroach_tpu.flow.runtime import run_operator as jrun
from cockroach_tpu.ops import aggregation as jagg
from cockroach_tpu.ops import hashing as jhash
from cockroach_tpu.ops import join as jjoin
from cockroach_tpu.ops import sort as jsort
from cockroach_tpu.plan import builder as jbuilder
from cockroach_tpu.sql.rel import Rel as JRel
from cockroach_tpu.utils import settings as jsettings
from cockroach_tpu_torch import catalog as tcatalog
from cockroach_tpu_torch.coldata import batch as tbatch
from cockroach_tpu_torch.flow import operators as tops
from cockroach_tpu_torch.flow.runtime import host_syncs
from cockroach_tpu_torch.flow.runtime import run_operator as trun
from cockroach_tpu_torch.ops import aggregation as tagg
from cockroach_tpu_torch.ops import hashing as thash
from cockroach_tpu_torch.ops import join as tjoin
from cockroach_tpu_torch.ops import sort as tsort
from cockroach_tpu_torch.plan import builder as tbuilder
from cockroach_tpu_torch.sql.rel import Rel as TRel
from cockroach_tpu_torch.utils import settings as tsettings
from test_torch_sqlops import pair, port_out, same, same_host
from test_torch_tpch import _tree

TILE = 1024


@pytest.fixture
def tset():
    """The port's settings.set, every port setting reset afterwards."""
    yield tsettings.set
    tsettings.reset()


# ---------------------------------------------------------------------------
# row hashing


@pytest.fixture(scope="module")
def hash_inputs():
    rng = np.random.default_rng(23)
    n = 600
    schema = jcd.Schema.of(i=jcd.INT64, dec=jcd.DECIMAL(12, 2), dt=jcd.DATE,
                           b=jcd.BOOL, f=jcd.FLOAT64, s=jcd.STRING)
    f = rng.normal(0, 1e3, n)
    f[:40] = 0.0
    f[40:80] = -0.0
    f[80:90] = np.inf
    arrays = {"i": rng.integers(-2**62, 2**62, n),
              "dec": rng.integers(-10**9, 10**9, n),
              "dt": rng.integers(0, 20000, n).astype(np.int32),
              "b": rng.random(n) < 0.5, "f": f,
              "s": rng.integers(0, 5, n).astype(np.int32)}
    valids = {c: rng.random(n) < 0.85 for c in arrays}
    table = jcd.Dictionary(np.array(["", "a", "TRUCK", "zz", "Brand#45"],
                                    dtype=object)).hashes
    return pair(schema, arrays, valids=valids, capacity=1024), table


@pytest.mark.parametrize("cols", [(0,), (1,), (2,), (3,), (4,), (5,),
                                  (0, 5, 4), (3, 2, 1)])
def test_hash_columns_match_reference(hash_inputs, cols):
    (js, ts, jb, tb), table = hash_inputs
    jt = {i: table for i, c in enumerate(cols) if c == 5}
    tt = {i: table for i, c in enumerate(cols) if c == 5}
    want = jhash.hash_columns([jb.cols[c] for c in cols],
                              [js.types[c] for c in cols], jt)
    got = thash.hash_columns([tb.cols[c] for c in cols],
                             [ts.types[c] for c in cols], tt)
    assert got.dtype == torch.int64
    same(got, want)
    for nb in (1, 7, 1000, 65521, 2**31 - 1):
        same(thash.bucket(got, nb), jhash.bucket(want, nb))


def test_hash_float_zero_and_nulls(hash_inputs):
    """-0.0 hashes like 0.0, and a NULL key hashes to the NULL sentinel
    whatever its data."""
    (js, ts, jb, tb), _ = hash_inputs
    f = tb.cols[4]
    h = thash.hash_columns([f], [ts.types[4]])
    pos = (f.data == 0.0) & f.valid & ~torch.signbit(f.data)
    neg = (f.data == 0.0) & f.valid & torch.signbit(f.data)
    assert pos.any() and neg.any()
    assert torch.unique(h[pos | neg]).numel() == 1
    assert torch.unique(h[~f.valid]).numel() == 1


def test_bucket_unsigned_modulo():
    words = np.array([0, 1, 2**63, 2**64 - 1, 2**63 - 1, 12345678901234567],
                     dtype=np.uint64)
    for nb in (3, 1000, 2**31 - 1):
        got = thash.bucket(torch.from_numpy(words.view(np.int64)), nb)
        np.testing.assert_array_equal(got.numpy(),
                                      (words % np.uint64(nb)).astype(np.int32))
    with pytest.raises(ValueError):
        thash.bucket(torch.zeros(2, dtype=torch.int64), 0)


# ---------------------------------------------------------------------------
# hash_join_general, function level


def _dup_inputs(rng):
    """A build side with duplicate keys (an int key and a FLOAT key with
    -0.0 against 0.0) and a probe side with NULL keys and dead rows."""
    nb, npr = 400, 900
    bschema = jcd.Schema.of(k=jcd.INT64, f=jcd.FLOAT64, v=jcd.INT64)
    bk = rng.integers(0, 150, nb)
    barr = {"k": bk, "f": np.where(bk % 7 == 0, -0.0, bk * 0.5),
            "v": rng.integers(0, 10**6, nb)}
    pschema = jcd.Schema.of(pk=jcd.INT64, pf=jcd.FLOAT64, w=jcd.INT64)
    pk = rng.integers(0, 200, npr)
    parr = {"pk": pk, "pf": np.where(pk % 7 == 0, 0.0, pk * 0.5),
            "w": rng.integers(0, 100, npr)}
    pvalid = {"pk": rng.random(npr) < 0.9, "pf": rng.random(npr) < 0.9}
    build = pair(bschema, barr, capacity=512,
                 mask=rng.random(512) < 0.9)
    probe = pair(pschema, parr, valids=pvalid, capacity=1024,
                 mask=rng.random(1024) < 0.9)
    return probe, build


def _rows(res: dict) -> list:
    """A result's rows as a sorted multiset."""
    names = list(res)
    n = len(res[names[0]]) if names else 0
    out = []
    for i in range(n):
        row = []
        for c in names:
            x = res[c][i]
            row.append(None if x is None else
                       x.item() if hasattr(x, "item") else x)
        out.append(tuple(row))
    return sorted(out, key=repr)


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("layout", ["exact", "hashed"])
def test_hash_join_general_matches_reference(how, layout):
    rng = np.random.default_rng(5)
    (pjs, pts, pjb, ptb), (bjs, bts, bjb, btb) = _dup_inputs(rng)
    keys = (0,) if layout == "exact" else (1,)
    stats_p = {0: (0, 199)}
    stats_b = {0: (0, 149)}
    jl = jjoin.plan_exact_key(pjs, keys, bjs, keys, stats_p, stats_b, {},
                              True)
    tl = tjoin.plan_exact_key(pts, keys, bts, keys, stats_p, stats_b, {},
                              True)
    if layout == "hashed":
        assert jl is None and tl is None
    else:
        assert (tl.segs, tl.total_bits) == (jl.segs, jl.total_bits)
    jspec, tspec = jjoin.JoinSpec(how, False), tjoin.JoinSpec(how, False)
    want, wtotal = jjoin.hash_join_general(
        pjb, pjs, keys, bjb, bjs, keys, jspec, 8192, exact_layout=jl)
    syncs = []
    got, gtotal = tjoin.hash_join_general(
        ptb, pts, keys, btb, bts, keys, tspec, 8192, exact_layout=tl,
        sync=lambda x: syncs.append(1) or int(x))
    # the reference's anti total also counts dead probe rows; the port's
    # is the rows kept
    assert int(gtotal) == (int(want.mask.sum()) if how == "anti"
                           else int(wtotal)) > 0
    assert len(syncs) == (0 if how in ("semi", "anti") else 1) + (
        layout == "hashed")
    out = jjoin.join_output_schema(pjs, bjs, jspec)
    assert tjoin.join_output_schema(pts, bts, tspec) == port_out(out)
    g = tbatch.to_host(got, port_out(out))
    w = jcd.to_host(want, out)
    if how in ("semi", "anti"):
        same_host(g, w)  # probe-aligned: the same rows in the same order
    else:
        assert _rows(g) == _rows(w)
        # probe row first, then sorted build position: probe order kept
        same(g["w"], w["w"])


def test_hash_join_general_capacity_and_order():
    """A capacity under the total truncates (the caller retries bigger);
    a callable capacity sizes the tile from the total."""
    rng = np.random.default_rng(6)
    (_, pts, _, ptb), (_, bts, _, btb) = _dup_inputs(rng)
    layout = tjoin.plan_exact_key(pts, (0,), bts, (0,), {0: (0, 199)},
                                  {0: (0, 149)}, {}, True)
    spec = tjoin.JoinSpec("inner", False)
    full, total = tjoin.hash_join_general(ptb, pts, (0,), btb, bts, (0,),
                                          spec, lambda n: n + 5,
                                          exact_layout=layout)
    assert full.capacity == total + 5 and int(full.mask.sum()) == total
    cut, total2 = tjoin.hash_join_general(ptb, pts, (0,), btb, bts, (0,),
                                          spec, 64, exact_layout=layout)
    assert total2 == total and cut.capacity == 64
    for a, b in zip(cut.cols, full.cols):
        assert torch.equal(a.data, b.data[:64])


# ---------------------------------------------------------------------------
# HashJoinOp over catalogs: duplicate and hashed keys, several probe tiles


def _catalogs(tables: dict):
    """The same host tables as a reference catalog and a port catalog."""
    jcat = jcatalog.Catalog()
    host = {}
    for name, (schema, cols, valids, dicts) in tables.items():
        jcat.add(jcatalog.Table(
            name, schema, cols, valids=valids,
            dictionaries={c: jcd.Dictionary(v) for c, v in dicts.items()}))
        host[name] = {
            "columns": cols,
            "types": {n: (t.family.value, t.width, t.precision, t.scale)
                      for n, t in zip(schema.names, schema.types)},
            "valids": valids, "dictionaries": dicts}
    return jcat, tcatalog.catalog_from_host(host, device="cpu")


@pytest.fixture(scope="module")
def join_cats():
    rng = np.random.default_rng(31)
    words = np.array(["", "a", "b", "TRUCK", "zz", "q"], dtype=object)
    npr = 3000
    pk = rng.integers(0, 130, npr)
    probe = (jcd.Schema.of(f=jcd.FLOAT64, s=jcd.STRING, k=jcd.INT64,
                           wide=jcd.INT64, w=jcd.INT64),
             {"f": np.where(pk % 9 == 0, -0.0, pk * 0.25),
              "s": rng.integers(0, 6, npr).astype(np.int32),
              "k": pk, "wide": pk * (1 << 33) + 7,
              "w": np.arange(npr)},
             {"f": rng.random(npr) < 0.9, "k": rng.random(npr) < 0.9},
             {"s": words})
    nb = 500
    bk = rng.integers(0, 100, nb)
    bwords = np.array(["q", "zz", "b", "a", "absent"], dtype=object)
    build = (jcd.Schema.of(f=jcd.FLOAT64, s=jcd.STRING, k=jcd.INT64,
                           wide=jcd.INT64, v=jcd.INT64),
             {"f": np.where(bk % 9 == 0, 0.0, bk * 0.25),
              "s": rng.integers(0, 5, nb).astype(np.int32),
              "k": bk, "wide": bk * (1 << 33) + 7,
              "v": rng.integers(0, 10**6, nb)},
             {"f": rng.random(nb) < 0.95},
             {"s": bwords})
    fan = (jcd.Schema.of(k=jcd.INT64, v=jcd.INT64),
           {"k": np.repeat(np.arange(5, 105), 3),
            "v": rng.integers(0, 10**6, 300)}, {}, {})
    uk = rng.permutation(200)[:120]
    uniq = (jcd.Schema.of(f=jcd.FLOAT64, s=jcd.STRING, v=jcd.INT64),
            {"f": uk * 0.25, "s": (uk % 5).astype(np.int32),
             "v": rng.integers(0, 10**6, 120)}, {}, {"s": bwords})
    return _catalogs({"probe": probe, "build": build, "fan": fan,
                      "uniq": uniq})


# build table, join key pairs, build_unique, and the strategy of the
# probe-aligned joins (semi / anti; inner / left over unique keys)
JOINS = {
    "lut": ("build", [("k", "k")], False, "lut"),
    "sorted": ("build", [("wide", "wide")], False, "sorted"),
    "analytic": ("fan", [("k", "k")], False, "analytic"),
    "hashed": ("build", [("f", "f"), ("s", "s")], False, "sorted"),
    "hashed_unique": ("uniq", [("f", "f"), ("s", "s")], True, "sorted"),
}


def _join_both(cats, how, kind, tset):
    jcat, tcat = cats
    table, on, unique, _ = JOINS[kind]
    tset("sql.distsql.tile_size", TILE)
    jsettings.set("sql.distsql.tile_size", TILE)
    try:
        jrel = JRel.scan(jcat, "probe").join(JRel.scan(jcat, table), on=on,
                                             how=how, build_unique=unique)
        jroot = jbuilder.build(jrel.plan, jcat)
        want = jrun(jroot)
    finally:
        jsettings.reset("sql.distsql.tile_size")
    trel = TRel.scan(tcat, "probe").join(TRel.scan(tcat, table), on=on,
                                         how=how, build_unique=unique)
    assert repr(trel.plan) == repr(jrel.plan)
    troot = tbuilder.build(trel.plan, tcat)
    got = trun(troot)
    jj = [o for n, o in _tree(jroot) if n == "HashJoinOp"][0]
    tj = [o for n, o in _tree(troot) if n == "HashJoinOp"][0]
    return want, got, jj, tj, troot


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("kind", list(JOINS))
def test_hash_join_op_matches_reference(join_cats, how, kind, tset):
    want, got, jj, tj, troot = _join_both(join_cats, how, kind, tset)
    assert list(got) == list(want) and len(want[list(want)[0]]) > 0
    assert _rows(got) == _rows(want)
    if kind.startswith("hashed"):
        assert jj.exact_layout is None and tj.exact_layout is None
    else:
        assert (tj.exact_layout.segs, tj.exact_layout.total_bits) == (
            jj.exact_layout.segs, jj.exact_layout.total_bits)
    # the reference names the probe kind of probe-aligned joins only;
    # inner and left joins over duplicate keys take the general emit
    want_kind = getattr(jj, "_probe_kind", None) or "general"
    assert tj.strategy == want_kind
    if how in ("inner", "left") and not JOINS[kind][2]:
        assert tj.strategy == "general"  # never the LUT over duplicates
    else:
        assert tj.strategy == JOINS[kind][3]
    # three probe tiles, each one counted host sync or more
    assert sum(host_syncs(troot).values()) >= 3


def test_general_join_output_exceeds_probe_tile(join_cats, tset):
    """Each 1024-row probe tile of an inner join over duplicate keys emits
    more rows than the tile holds, at the canonical capacity of its
    total; downstream operators take the larger tiles."""
    _, tcat = join_cats
    tset("sql.distsql.tile_size", TILE)
    rel = TRel.scan(tcat, "probe").join(TRel.scan(tcat, "build"),
                                        on=[("k", "k")], build_unique=False)
    root = tbuilder.build(rel.plan, tcat)
    root.init()
    caps = []
    while (b := root.next_batch()) is not None:
        caps.append(b.capacity)
    assert len(caps) == 3 and max(caps) > TILE
    probe, build = tcat.get("probe"), tcat.get("build")
    pk = probe.columns["k"][probe.valids["k"]]
    per_key = np.bincount(build.columns["k"], minlength=200)
    res = rel.groupby(["k"], [("n", "count_rows", None)]).run()
    assert res["n"].sum() == per_key[pk].sum()


# ---------------------------------------------------------------------------
# scalar aggregation states


SCALAR_FUNCS = ["count_rows", "count", "sum", "avg", "min", "max",
                "var", "stddev", "var_pop", "stddev_pop", "bool_and",
                "bool_or"]


@pytest.fixture(scope="module")
def scalar_batch():
    rng = np.random.default_rng(13)
    n = 700
    schema = jcd.Schema.of(i=jcd.INT64, dec=jcd.DECIMAL(12, 2),
                           f=jcd.FLOAT64, b=jcd.BOOL)
    arrays = {"i": rng.integers(-10**9, 10**9, n),
              "dec": rng.integers(-10**6, 10**6, n),
              "f": rng.normal(0, 100, n), "b": rng.random(n) < 0.7}
    valids = {c: rng.random(n) < 0.8 for c in arrays}
    return schema, arrays, valids


def _scalar_specs(schema, mod):
    specs = []
    for func in SCALAR_FUNCS:
        for col in range(len(schema.names)):
            t = schema.types[col]
            if func in ("bool_and", "bool_or") and t.family.name != "BOOL":
                continue
            if func not in ("bool_and", "bool_or", "count", "count_rows",
                            "min", "max") and t.family.name == "BOOL":
                continue
            specs.append(mod.AggSpec(func, None if func == "count_rows"
                                     else col, f"{func}_{col}"))
            if func == "count_rows":
                break
    return tuple(specs)


def _scalar_result(mod, cd, specs, schema, batches):
    acc = None
    for b in batches:
        st = mod.scalar_tile_states(b, specs, schema)
        acc = st if acc is None else mod.scalar_merge_states(specs, acc, st)
    names = tuple(s.name for s in specs)
    types = tuple(cd.FLOAT64 if s.func == "avg"
                  else mod.agg_output_type(s, schema) for s in specs)
    out = cd.Schema(names, types)
    kw = {"device": "cpu"} if mod is tagg else {}
    return mod.scalar_result_batch(specs, schema, out, acc, **kw), out


@pytest.mark.parametrize("case", ["tiles", "empty", "all_null", "no_tiles"])
def test_scalar_states_match_reference(scalar_batch, case):
    schema, arrays, valids = scalar_batch
    n = len(arrays["i"])
    if case == "all_null":
        valids = {c: np.zeros(n, dtype=bool) for c in arrays}
    parts = []
    for lo in range(0, n, 300):
        sl = {c: a[lo:lo + 300] for c, a in arrays.items()}
        sv = {c: v[lo:lo + 300] for c, v in valids.items()}
        mask = None
        if case == "empty":
            mask = np.zeros(512, dtype=bool)
        parts.append(pair(schema, sl, valids=sv, capacity=512, mask=mask))
    if case == "no_tiles":
        parts = []
    js, ts = pair(schema, {c: a[:1] for c, a in arrays.items()})[:2]
    specs_j = _scalar_specs(js, jagg)
    specs_t = _scalar_specs(ts, tagg)
    from cockroach_tpu_torch.coldata import types as tty
    want, wout = _scalar_result(jagg, jcd, specs_j, js, [p[2] for p in parts])
    got, gout = _scalar_result(tagg, tty, specs_t, ts, [p[3] for p in parts])
    assert gout == port_out(wout) and got.capacity == 1
    same_host(tbatch.to_host(got, gout), jcd.to_host(want, wout))
    if case != "tiles":
        res = tbatch.to_host(got, gout)
        for s in specs_t:
            expect = 0 if s.func in ("count", "count_rows") else None
            if s.func == "count_rows" and case == "all_null":
                expect = n
            assert res[s.name][0] == expect, s.name


def test_scalar_aggregate_op_empty_input(join_cats):
    """One row even when the filter keeps nothing: count 0, the rest
    NULL, in both packages."""
    from cockroach_tpu.ops import expr as jex
    from cockroach_tpu_torch.ops import expr as tex

    jcat, tcat = join_cats
    out = []
    for R, ex_, cat, run, bld in ((JRel, jex, jcat, jrun, jbuilder),
                                   (TRel, tex, tcat, trun, tbuilder)):
        r = R.scan(cat, "probe")
        r = r.filter(ex_.Cmp("lt", r.c("w"), ex_.lit(-1)))
        r = r.scalar_agg([("n", "count_rows", None), ("s", "sum", "k"),
                          ("a", "avg", "f"), ("m", "min", "k")])
        out.append(run(bld.build(r.plan, cat)))
    assert list(out[1].values()) and out[1]["n"][0] == 0
    same_host(out[1], out[0])
    assert out[1]["s"][0] is None and out[1]["a"][0] is None


# ---------------------------------------------------------------------------
# top-k


@pytest.fixture(scope="module")
def topk_batch_inputs():
    rng = np.random.default_rng(17)
    n = 900
    schema = jcd.Schema.of(a=jcd.INT64, f=jcd.FLOAT64, s=jcd.STRING,
                           row=jcd.INT64)
    arrays = {"a": rng.integers(0, 6, n), "f": rng.integers(0, 3, n) * 0.5,
              "s": rng.integers(0, 4, n).astype(np.int32),
              "row": np.arange(n)}
    valids = {"a": rng.random(n) < 0.9, "f": rng.random(n) < 0.9}
    return pair(schema, arrays, valids=valids, capacity=1024,
                mask=rng.random(1024) < 0.85)


@pytest.mark.parametrize("k", [1, 7, 40, 200, 2000])
@pytest.mark.parametrize("keys", [((0, True),), ((1, False), (0, True)),
                                  ((2, False), (1, True))])
def test_topk_batch_matches_reference(topk_batch_inputs, k, keys):
    """Heavy ties, so the k boundary falls inside a run of equal keys:
    the first k rows of the stable order, as Sort + LIMIT keeps them."""
    js, ts, jb, tb = topk_batch_inputs
    ranks = {2: np.array([3, 0, 2, 1], dtype=np.int32)}
    jk = tuple(jsort.SortKey(c, desc=d) for c, d in keys)
    tk = tuple(tsort.SortKey(c, desc=d) for c, d in keys)
    cap = max(1024, k)
    want = jsort.topk_batch(jb, js, jk, k, cap, ranks)
    got = tsort.topk_batch(tb, ts, tk, k, cap, ranks)
    same_host(tbatch.to_host(got, ts), jcd.to_host(want, js))
    full = tsort.limit_mask(tsort.sort_batch(tb, ts, tk, ranks), k)
    same_host(tbatch.to_host(got, ts), tbatch.to_host(full, ts))


def test_topk_op_folds_tiles_like_sort_limit(join_cats, tset):
    """TopKOp over three probe tiles with ties at the boundary equals
    SortOp + LimitOp, and the reference's TopK plan."""
    jcat, tcat = join_cats
    tset("sql.distsql.tile_size", TILE)
    rel = TRel.scan(tcat, "probe").sort([("k", True), ("s", False)])
    rel = rel.limit(50, offset=3)
    opt = rel.optimized_plan()
    assert "TopK" in repr(opt) and "TopK" not in repr(rel.plan)
    root = tbuilder.build(opt, tcat)
    assert isinstance(root.child, tops.TopKOp) and root.child.k == 53
    got = trun(root)
    plain = trun(tbuilder.build(rel.plan, tcat))
    same_host(got, plain)
    jsettings.set("sql.distsql.tile_size", TILE)
    try:
        jrel = JRel.scan(jcat, "probe").sort([("k", True), ("s", False)])
        jrel = jrel.limit(50, offset=3)
        assert repr(opt) == repr(jrel.optimized_plan())
        want = jrun(jbuilder.build(jrel.optimized_plan(), jcat))
    finally:
        jsettings.reset("sql.distsql.tile_size")
    same_host(got, want)
    assert len(got["w"]) == 50


# ---------------------------------------------------------------------------
# DISTINCT


@pytest.mark.parametrize("cols", [None, ["s"], ["k", "s"], ["f"]])
def test_distinct_op_matches_reference(join_cats, cols, tset):
    jcat, tcat = join_cats
    tset("sql.distsql.tile_size", TILE)
    jsettings.set("sql.distsql.tile_size", TILE)
    try:
        jrel = JRel.scan(jcat, "build").select("k", "s", "f").distinct(cols)
        want = jrun(jbuilder.build(jrel.plan, jcat))
    finally:
        jsettings.reset("sql.distsql.tile_size")
    trel = TRel.scan(tcat, "build").select("k", "s", "f").distinct(cols)
    assert repr(trel.plan) == repr(jrel.plan)
    root = tbuilder.build(trel.plan, tcat)
    assert isinstance(root, tops.DistinctOp)
    got = trun(root)
    same_host(got, want)
    assert sum(host_syncs(root).values()) >= 1


@pytest.mark.parametrize("grouped", [False, True])
def test_grace_aggregation_matches_reference(grouped, tset):
    """With a 4096-row budget the group count exceeds every merge-down,
    so the aggregation splits into hash partitions; the output, batch
    order included, equals the reference's Grace aggregation."""
    from cockroach_tpu.bench import tpch as jtpch
    from cockroach_tpu_torch.bench import tpch as ttpch

    jcat = jtpch.gen_tpch(sf=0.002, seed=3)
    tcat = ttpch.gen_tpch(sf=0.002, seed=3, device="cpu")
    cols = ("l_orderkey", "l_suppkey", "l_quantity", "l_extendedprice")
    out = []
    for R, cat, run, bld in ((JRel, jcat, jrun, jbuilder),
                             (TRel, tcat, trun, tbuilder)):
        r = R.scan(cat, "lineitem", cols)
        if grouped:
            # three keys: a code space past the dense path's, so the
            # sort-based AggregateOp runs
            r = r.groupby(["l_suppkey", "l_orderkey", "l_quantity"],
                          [("p", "sum", "l_extendedprice"),
                           ("n", "count_rows", None)])
        else:
            r = r.distinct(["l_orderkey", "l_suppkey"])
        root = bld.build(r.plan, cat)
        if R is TRel:
            tset("sql.distsql.workmem_rows", 4096)
            tset("sql.distsql.tile_size", 2048)
            out.append(run(root))
            agg = root if grouped else root._inner
            assert agg.stats.spilled
        else:
            jsettings.set("sql.distsql.workmem_rows", 4096)
            jsettings.set("sql.distsql.tile_size", 2048)
            try:
                root = bld.build(r.plan, cat)
                out.append(run(root))
            finally:
                jsettings.reset("sql.distsql.workmem_rows")
                jsettings.reset("sql.distsql.tile_size")
    assert len(out[0]["l_orderkey"]) > 4096
    same_host(out[1], out[0])


def test_hashed_string_key_away_from_its_position():
    """A hashed join whose STRING key's column index differs from its key
    position: the port keys dictionary hash tables by key position. The
    reference keys them by column index and fails with a KeyError here
    (ROADMAP Queue 3), so the port is held to numpy instead."""
    rng = np.random.default_rng(8)
    n = 300
    words = np.array(["a", "b", "c", "d"], dtype=object)
    f = rng.integers(0, 40, n) * 0.5
    s = rng.integers(0, 4, n).astype(np.int32)
    table = {"columns": {"x": np.arange(n), "f": f, "s": s},
             "types": {"x": ("int", 64, 0, 0), "f": ("float", 64, 0, 0),
                       "s": ("string", 0, 0, 0)},
             "dictionaries": {"s": words}}
    bwords = np.array(["d", "c", "b", "a"], dtype=object)  # other codes
    bt = {"columns": {"x": np.arange(n), "f": f, "s": (3 - s)},
          "types": table["types"], "dictionaries": {"s": bwords}}
    cat = tcatalog.catalog_from_host({"p": table, "b": bt}, device="cpu")
    for on in ([("s", "s"), ("f", "f")], [("f", "f"), ("s", "s")]):
        rel = TRel.scan(cat, "p").join(TRel.scan(cat, "b"), on=on,
                                       how="inner", build_unique=False)
        root = tbuilder.build(rel.plan, cat)
        assert root.exact_layout is None
        from cockroach_tpu_torch.ops import expr as tex

        got = trun(tbuilder.build(rel.project(
            [(n, tex.ColRef(i)) for n, i in (("pf", 1), ("ps", 2),
                                             ("bf", 4), ("bs", 5))]).plan,
            cat))
        # build code 3 - c holds the probe's word c
        pairs = (f[:, None] == f[None, :]) & (s[:, None] == s[None, :])
        assert len(got["pf"]) == int(pairs.sum()) > n
        np.testing.assert_array_equal(got["pf"], got["bf"])
        np.testing.assert_array_equal(got["ps"], got["bs"])
