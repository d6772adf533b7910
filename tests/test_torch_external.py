"""The port's streaming scan and external operators (flow/external.py:
external sort, Grace hash join, host-staged Grace aggregation) against
the JAX reference on the CPU.

- TPC-H q3, q7, q9, q18 (also at quantity=150) and q21 at sf=0.01 under
  the SF10 scaling: every size threshold divided by 1000 and
  ``dense_lut_bits`` 24 -> 14, so each table, and each key range, stands
  to its threshold as at SF10. Results equal the reference's (the parity
  rules of ``bench/tpch_oracle.mismatch``), the same scans stream and the
  same operators spill to the same external operators; the spill-staging
  account is back at 0 after each query and no query monitor leaks.
- The external sort forced over INT, DATE, FLOAT (NaN and NULL), STRING,
  BOOL and DESC keys: equal primary words, boundaries and output order.
- The Grace hash join forced for inner, left, semi and anti joins, with
  partitions past workmem (merge-run probing) and with a heavy hitter
  (the hot lane): equal to the reference as multisets of rows (its build
  sort is not stable inside a key run) and to the in-memory join.
- HostPartitions through ``spill_dir``, the merge join and the Grace
  partition function against the reference, and a streaming scan equal
  to the resident scan of the same table.
"""

import numpy as np
import pytest

from cockroach_tpu import coldata as jcd
from cockroach_tpu.bench import queries as jQ
from cockroach_tpu.bench import tpch as jtpch
from cockroach_tpu.flow import external as jext
from cockroach_tpu.flow.runtime import run_operator as jrun
from cockroach_tpu.ops import merge_join as jmj
from cockroach_tpu.ops import sort as jsort
from cockroach_tpu.ops.join import JoinSpec as JJoinSpec
from cockroach_tpu.plan import builder as jbuilder
from cockroach_tpu.plan import spec as JS
from cockroach_tpu.sql.rel import Rel as JRel
from cockroach_tpu.utils import settings as jsettings
from cockroach_tpu_torch import catalog as tcatalog
from cockroach_tpu_torch.bench import queries as tQ
from cockroach_tpu_torch.bench import tpch as ttpch
from cockroach_tpu_torch.bench import tpch_oracle
from cockroach_tpu_torch.coldata import batch as tbatch
from cockroach_tpu_torch.flow import external as text
from cockroach_tpu_torch.flow import memory as tmem
from cockroach_tpu_torch.flow import operators as tops
from cockroach_tpu_torch.flow.runtime import run_operator as trun
from cockroach_tpu_torch.ops import merge_join as tmj
from cockroach_tpu_torch.ops import sort as tsort
from cockroach_tpu_torch.ops.join import JoinSpec as TJoinSpec
from cockroach_tpu_torch.plan import builder as tbuilder
from cockroach_tpu_torch.plan import spec as TS
from cockroach_tpu_torch.sql.rel import Rel as TRel
from cockroach_tpu_torch.utils import metric as tmetric
from cockroach_tpu_torch.utils import settings as tsettings
from test_torch_joins import _catalogs, _rows
from test_torch_sqlops import pair, same, same_host
from test_torch_tpch import _tree

SF, SEED = 0.01, 7

# the SF10 scaling: thresholds over 1000, the LUT's key bits 24 -> 14
SF10_SCALING = {
    "sql.distsql.scan_stream_rows": (1 << 23) // 1000,
    "sql.distsql.workmem_rows": (1 << 21) // 1000,
    "sql.distsql.workmem_bytes": (2 << 30) // 1000,
    "sql.distsql.tile_size": (1 << 20) // 1000,
    "sql.distsql.dense_agg_states": (1 << 23) // 1000,
    "sql.distsql.dense_lut_bits": 14,
}
# the reference's accelerator-only dense budget, scaled likewise
REF_ONLY = {"sql.distsql.dense_agg.accel_max_states": (1 << 19) // 1000}

CASES = {"q3": ("q3", {}), "q7": ("q7", {}), "q9": ("q9", {}),
         "q18": ("q18", {}), "q18_150": ("q18", {"quantity": 150}),
         "q21": ("q21", {})}
# the streamed scans and spills of each case under the scaling
WANT = {
    "q3": (["lineitem", "orders"], []),
    "q7": (["lineitem", "orders"], [("SortOp", "ExternalSortOp")]),
    "q9": (["lineitem", "orders"], []),
    "q18": (["lineitem", "lineitem", "orders"],
            [("AggregateOp", "GraceAggregateOp")]),
    "q21": (["lineitem", "lineitem", "lineitem", "orders"],
            [("AggregateOp", "GraceAggregateOp")] * 2
            + [("DistinctOp", "GraceAggregateOp")] * 2),
}
# at quantity=150 the final GROUP BY (about 600 orders) spills too
WANT["q18_150"] = (["lineitem", "lineitem", "orders"],
                   [("AggregateOp", "GraceAggregateOp")] * 2)


class both_settings:
    """Set settings in both packages for a block, then reset them."""

    def __init__(self, values: dict, ref_only: dict | None = None):
        self.values = values
        self.ref_only = ref_only or {}

    def __enter__(self):
        for n, v in {**self.values, **self.ref_only}.items():
            jsettings.set(n, v)
        for n, v in self.values.items():
            tsettings.set(n, v)

    def __exit__(self, *exc):
        for n in {**self.values, **self.ref_only}:
            jsettings.reset(n)
        for n in self.values:
            tsettings.reset(n)


def _walk(op):
    stack = [op]
    while stack:
        o = stack.pop()
        yield o
        stack.extend(reversed(o.children()))


def structure(root):
    """(streamed tables, [(operator, the external operator it spilled
    to)]) of a run operator tree, either package."""
    streamed = sorted(o.table.name for o in _walk(root)
                      if type(o).__name__ == "ScanOp" and o.streaming)
    spills = []
    for o in _walk(root):
        ext = getattr(o, "_external", None) or getattr(o, "_grace", None)
        if type(o).__name__ == "DistinctOp":
            ext = o._inner._external
        if ext is not None:
            spills.append((type(o).__name__, type(ext).__name__))
    return streamed, sorted(spills)


@pytest.fixture(scope="module")
def sf10_runs():
    """Each case run once through both packages under the SF10 scaling:
    {case: (reference root, result, port root, result, staged bytes
    left after the port's run, port query-monitor leaks)}."""
    jcat = jtpch.gen_tpch(sf=SF, seed=SEED)
    tcat = ttpch.gen_tpch(sf=SF, seed=SEED, device="cpu")
    staging = tmem.staging_monitor("flow/spill-staging")
    out = {}
    with both_settings(SF10_SCALING, REF_ONLY):
        for case, (q, kw) in CASES.items():
            jroot = jbuilder.build(
                jQ.QUERIES[q](jcat, **kw).optimized_plan(), jcat)
            troot = tbuilder.build(
                tQ.QUERIES[q](tcat, **kw).optimized_plan(), tcat)
            leaks = tmem.drain_failure_count()
            got = trun(troot)
            out[case] = (jroot, jrun(jroot), troot, got, staging.used,
                         tmem.drain_failure_count() - leaks)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_sf10_scaling_matches_reference(sf10_runs, case):
    jroot, want, troot, got, staged_left, leaks = sf10_runs[case]
    assert list(got) == list(want)
    bad = tpch_oracle.mismatch(CASES[case][0], got, want)
    assert bad is None, bad
    assert structure(troot) == structure(jroot)
    assert structure(troot) == WANT[case]
    assert staged_left == 0 and leaks == 0
    if case == "q18_150":
        assert len(got["o_orderkey"]) > 0


def test_sf10_scaling_spills_stage_on_the_host(sf10_runs):
    """q21's Grace aggregations stage their partitions on the host (one
    counted host sync per staged tile), and q7's external sort splits
    its rows at quantile boundaries."""
    troot = sf10_runs["q21"][2]
    aggs = [o._inner if type(o).__name__ == "DistinctOp" else o
            for o in _walk(troot)
            if type(o).__name__ in ("AggregateOp", "DistinctOp")]
    spilled = [a for a in aggs if a._external is not None]
    assert spilled and all(a.stats.spilled and a.stats.staged_bytes > 0
                           for a in spilled)
    sort = [o for o in _walk(sf10_runs["q7"][2])
            if type(o).__name__ == "SortOp"][0]
    assert sort.stats.spilled and len(sort._external.bounds) >= 1


# ---------------------------------------------------------------------------
# external sort


@pytest.fixture(scope="module")
def sort_tables():
    """One table of every key family the external sort partitions by."""
    rng = np.random.default_rng(31)
    n = 5000
    schema = jcd.Schema.of(i=jcd.INT64, dt=jcd.DATE, f=jcd.FLOAT64,
                           s=jcd.STRING, b=jcd.BOOL, r=jcd.INT64)
    f = rng.normal(0, 100, n).round(1)
    f[rng.random(n) < 0.05] = np.nan
    f[:50] = -0.0
    cols = {"i": rng.integers(-10**12, 10**12, n),
            "dt": rng.integers(8000, 10000, n).astype(np.int32),
            "f": f, "s": rng.integers(0, 6, n).astype(np.int32),
            "b": rng.random(n) < 0.3, "r": np.arange(n, dtype=np.int64)}
    valids = {c: rng.random(n) < 0.9 for c in ("i", "dt", "f", "s", "b")}
    dicts = {"s": np.array(["pear", "apple", "", "zebra", "Fig", "kiwi"],
                           dtype=object)}
    return _catalogs({"t": (schema, cols, valids, dicts)})


# (column, desc, nulls_first) of the primary key; the row id breaks ties
SORT_CASES = {
    "int": ("i", False, None), "int_desc": ("i", True, None),
    "date": ("dt", False, None), "float": ("f", False, None),
    "float_desc": ("f", True, None), "float_nulls_last": ("f", False, False),
    "string": ("s", False, None), "string_desc": ("s", True, None),
    "bool": ("b", False, None), "bool_desc": ("b", True, None),
}


@pytest.mark.parametrize("case", list(SORT_CASES))
def test_external_sort_matches_reference(sort_tables, case):
    jcat, tcat = sort_tables
    col, desc, nf = SORT_CASES[case]
    scaled = {"sql.distsql.tile_size": 1024,
              "sql.distsql.workmem_rows": 1024}
    out = []
    with both_settings(scaled):
        for R, cat, run, bld, srt, spec in (
                (JRel, jcat, jrun, jbuilder, jsort, JS),
                (TRel, tcat, trun, tbuilder, tsort, TS)):
            scan = R.scan(cat, "t")
            keys = (srt.SortKey(scan.idx(col), desc, nf),
                    srt.SortKey(scan.idx("r")))
            root = bld.build(spec.Sort(scan.plan, keys), cat)
            out.append((root, run(root)))
    (jroot, want), (troot, got) = out
    same_host(got, want)
    assert len(got["r"]) == 5000
    ext = troot._external
    assert troot.stats.spilled and ext is not None
    # the reference's words over the same rows give the same boundaries
    tb = tcat.get("t")
    schema = jcat.get("t").schema
    arrays = {c: np.asarray(jcat.get("t").columns[c]) for c in schema.names}
    valids = {c: np.asarray(v) for c, v in jcat.get("t").valids.items()}
    js, ts_, jb, tbb = pair(schema, arrays, valids)
    ci = schema.index(col)
    ranks = tb.dictionaries["s"].ranks if col == "s" else None
    jw = jext._primary_u64(jb, js, jsort.SortKey(ci, desc, nf), ranks)
    tw = text._primary_u64(tbb, ts_, tsort.SortKey(ci, desc, nf), ranks)
    same(tw, jw)
    u = np.asarray(jw)[np.asarray(jb.mask)]
    P = min(8, max(1, (len(u) + 1023) // 1024 * 2))
    bounds = np.unique(np.quantile(u, np.linspace(0, 1, P + 1)[1:-1])
                       .astype(np.uint64))
    np.testing.assert_array_equal(ext.bounds, bounds)


# ---------------------------------------------------------------------------
# Grace hash join


def _join_catalogs(seed, np_rows, nb_rows, nkeys, hot_key=None, hot_build=0,
                   hot_probe=0):
    """test_spill_join's tables: probe p(k, w), build b(bk, v)."""
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, nkeys, np_rows).astype(np.int64)
    bk = rng.integers(0, int(nkeys * 1.25), nb_rows).astype(np.int64)
    if hot_key is not None:
        pk[:hot_probe] = hot_key
        bk[:hot_build] = hot_key
        rng.shuffle(pk)
        rng.shuffle(bk)
    p = (jcd.Schema.of(k=jcd.INT64, w=jcd.INT64),
         {"k": pk, "w": rng.integers(0, 100, np_rows).astype(np.int64)},
         {}, {})
    b = (jcd.Schema.of(bk=jcd.INT64, v=jcd.INT64),
         {"bk": bk, "v": rng.integers(0, 100, nb_rows).astype(np.int64)},
         {}, {})
    return _catalogs({"p": p, "b": b})


@pytest.fixture(scope="module")
def hybrid_cats():
    return _join_catalogs(11, 8000, 30000, nkeys=1500)


@pytest.fixture(scope="module")
def skew_cats():
    return _join_catalogs(13, 8000, 12000, nkeys=4000, hot_key=77,
                          hot_build=200, hot_probe=800)


def _grace_join(cats, how, workmem, skew_frac=None, ref=True):
    """(reference result or None, port result, port HashJoinOp)."""
    jcat, tcat = cats
    values = {"sql.distsql.workmem_bytes": workmem,
              "sql.distsql.tile_size": 2048}
    if skew_frac is not None:
        values["sql.distsql.grace_skew_frac"] = skew_frac
    with both_settings(values):
        want = None
        if ref:
            want = JRel.scan(jcat, "p").join(
                JRel.scan(jcat, "b"), on=[("k", "bk")], how=how,
                build_unique=False).run()
        rel = TRel.scan(tcat, "p").join(TRel.scan(tcat, "b"),
                                        on=[("k", "bk")], how=how,
                                        build_unique=False)
        root = tbuilder.build(rel.optimized_plan(), tcat)
        got = trun(root)
    join = [o for n, o in _tree(root) if n == "HashJoinOp"][0]
    return want, got, join


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_grace_join_merge_runs_match_reference(hybrid_cats, how):
    """Partitions past workmem reload their build side as sorted runs
    and merge-probe them (ops/merge_join)."""
    merge0 = tmetric.GRACE_JOIN_MERGE_PARTS.value
    spills0 = tmetric.GRACE_JOIN_SPILLS.value
    want, got, join = _grace_join(hybrid_cats, how, 1 << 16)
    assert join.strategy == "grace" and join.stats.spilled
    assert tmetric.GRACE_JOIN_SPILLS.value > spills0
    assert tmetric.GRACE_JOIN_MERGE_PARTS.value > merge0
    _, plain, pjoin = _grace_join(hybrid_cats, how, 2 << 30, ref=False)
    assert pjoin.strategy != "grace"
    # every probe key has build rows here: the anti join keeps none
    assert (len(_rows(got)) > 0) == (how != "anti")
    assert _rows(got) == _rows(want) == _rows(plain)


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_grace_join_hot_lane_matches_reference(skew_cats, how):
    """A heavy-hitter key's build rows stay resident on the device and
    its probe rows take the hot lane."""
    routed0 = tmetric.GRACE_JOIN_SKEW_ROUTED.value
    want, got, join = _grace_join(skew_cats, how, 1 << 16, skew_frac=0.01)
    assert tmetric.GRACE_JOIN_SKEW_ROUTED.value > routed0
    _, plain, _ = _grace_join(skew_cats, how, 2 << 30, skew_frac=0.0,
                              ref=False)
    assert _rows(got) == _rows(want) == _rows(plain)


def test_grace_partition_function_matches_reference(skew_cats):
    """make_bucket_fn: equal partition ids and hash bits."""
    jcat, tcat = skew_cats
    jt, tt = jcat.get("b"), tcat.get("b")
    schema = jt.schema
    arrays = {c: np.asarray(jt.columns[c]) for c in schema.names}
    js, ts_, jb, tb = pair(schema, arrays)
    jp, jh = jext.make_bucket_fn(js, (0, 1), {}, 8, with_hash=True)(jb)
    tp, th = text.make_bucket_fn(ts_, (0, 1), {}, 8, with_hash=True)(tb)
    same(tp, jp)
    same(th, jh)


# ---------------------------------------------------------------------------
# merge join


@pytest.fixture(scope="module")
def merge_inputs():
    rng = np.random.default_rng(41)
    schema = jcd.Schema.of(k=jcd.INT64, s=jcd.STRING, f=jcd.FLOAT64,
                           x=jcd.INT64)
    pvals = np.array(["a", "b", "c", "d"], dtype=object)
    bvals = np.array(["d", "c", "e", "a"], dtype=object)  # other codes

    def side(n, seed_shift):
        f = rng.integers(-2, 3, n).astype(np.float64)
        f[:5] = -0.0
        f[5:9] = np.nan
        arrays = {"k": rng.integers(0, 30, n), "s":
                  rng.integers(0, 4, n).astype(np.int32), "f": f,
                  "x": np.arange(n) + seed_shift}
        valids = {"k": rng.random(n) < 0.9, "f": rng.random(n) < 0.9}
        return pair(schema, arrays, valids, capacity=1024,
                    mask=rng.random(1024) < 0.95)

    pd_, bd = jcd.Dictionary(pvals), jcd.Dictionary(bvals)
    return side(700, 0), side(900, 10**6), {1: pd_}, {1: bd}


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("keys", [(0,), (0, 1), (2,), (1, 2, 0)])
def test_merge_join_matches_reference(merge_inputs, how, keys):
    (js, ts_, jp, tp), (_, _, jb, tb), pdicts, bdicts = merge_inputs
    pranks, branks = tmj.rank_tables_for(ts_, keys, pdicts, keys, bdicts)
    jpr, jbr = jmj.rank_tables_for(js, keys, pdicts, keys, bdicts)
    for a, b in zip(pranks + branks, jpr + jbr):
        assert (a is None and b is None) or np.array_equal(a, b)
    tidx = tmj.build_merge_index(tb, ts_, keys, branks)
    jidx = jmj.build_merge_index(jb, js, keys, jbr)
    for g, w in zip(tidx[0], jidx[0]):
        same(g, w)
    same(tidx[2], jidx[2])
    cap = 1 << 16
    got, total = tmj.merge_join(tp, ts_, keys, tb, ts_, keys,
                                TJoinSpec(how), cap, pranks, branks)
    want, wtotal = jmj.merge_join(jp, js, keys, jb, js, keys,
                                  JJoinSpec(how), cap, jpr, jbr)
    if how in ("inner", "left"):
        assert total == int(wtotal) > 0
    names = tuple(f"{side}{c}" for side in "pb" for c in js.names)
    osch = js.concat(js) if how in ("inner", "left") else js
    osch_t = ts_.concat(ts_) if how in ("inner", "left") else ts_
    wantr = jcd.to_host(want, osch)
    gotr = tbatch.to_host(got, osch_t)

    def rows(res):  # NaN as a string, so equal rows compare equal
        return _rows({n: np.array(["nan" if isinstance(x, float) and x != x
                                   else x for x in a], dtype=object)
                      for n, a in zip(names, res.values())})

    assert rows(gotr) == rows(wantr)


# ---------------------------------------------------------------------------
# host partitions and the streaming scan


def test_host_partitions_spill_dir_match_reference(tmp_path, skew_cats):
    """Tiles staged through spill_dir reload equal to the reference's
    host partitions; the files go with free() and the staging account
    returns to where it was."""
    jcat, tcat = skew_cats
    t = jcat.get("p")
    schema = t.schema
    arrays = {c: np.asarray(t.columns[c]) for c in schema.names}
    js, ts_, jb, tb = pair(schema, arrays, capacity=8192,
                           mask=np.random.default_rng(5).random(8192) < 0.7)
    jpids = np.asarray(jext.make_bucket_fn(js, (0,), {}, 4)(jb))
    tpids = text.make_bucket_fn(ts_, (0,), {}, 4)(tb)
    staging = tmem.staging_monitor("flow/spill-staging")
    used0 = staging.used
    jparts = jext.HostPartitions(js, 4)
    jext.stage_batch(jb, js, jpids, jparts)
    tparts = text.HostPartitions(ts_, 4, spill_dir=str(tmp_path))
    op = tops.ScanOp(tcat.get("p"))
    for half in (slice(0, 4096), slice(4096, 8192)):
        part = tbatch.Batch(
            cols=tuple(tbatch.Column(c.data[half], c.valid[half])
                       for c in tb.cols), mask=tb.mask[half])
        text.stage_batch(op, part, tpids[half], tparts)
    assert op.stats.host_syncs == 2
    assert len(list(tmp_path.iterdir())) == 8
    assert staging.used > used0
    for pid in range(4):
        assert tparts.rows[pid] == jparts.rows[pid] > 0
        want = jcd.to_host(jparts.reload(pid), js)
        got = tbatch.to_host(tparts.reload(pid), ts_)
        same_host(got, want)
        runs = list(tparts.reload_runs(pid, 1024))
        assert len(runs) == -(-tparts.rows[pid] // 1024)
        tparts.free(pid)
        jparts.free(pid)
    assert list(tmp_path.iterdir()) == []
    assert staging.used == used0


def test_streaming_scan_equals_resident_scan():
    """lineitem at sf=0.01 over a lowered scan_stream_rows streams in
    4096-row tiles (the reference's tile rule), the last one short; its
    rows equal the resident scan's."""
    tcat = ttpch.gen_tpch(sf=SF, seed=SEED, device="cpu")
    jcat = jtpch.gen_tpch(sf=SF, seed=SEED)
    cols = ("l_orderkey", "l_quantity", "l_shipdate", "l_returnflag")
    res = tops.ScanOp(tcat.get("lineitem"), cols)
    want = trun(res)
    assert not res.streaming
    with both_settings({"sql.distsql.scan_stream_rows": 8388,
                        "sql.distsql.tile_size": 1024}):
        st = tbuilder.build(TRel.scan(tcat, "lineitem", cols).plan, tcat)
        st.init()
        tiles = []
        while (b := st.next_batch()) is not None:
            tiles.append(b)
        got = trun(st)
        jst = jbuilder.build(JRel.scan(jcat, "lineitem", cols).plan, jcat)
        jst.init()
        assert jst.streaming and jst._stream_tile == st._stream.tile
    n = tcat.get("lineitem").num_rows
    assert st.streaming and st._stream.tile == 4096
    assert len(tiles) == -(-n // 4096)
    assert all(t.capacity == 4096 for t in tiles)
    assert int(tiles[-1].mask.sum()) == n % 4096 > 0
    assert not bool(tiles[-1].cols[0].valid[n % 4096:].any())
    same_host(got, want)
    assert st._stream.h2d_bytes > 0


def test_operators_take_reference_thresholds():
    """Each swap reads the reference's setting: a spool one tile over
    workmem_rows spills the sort; under it, nothing spills."""
    rng = np.random.default_rng(2)
    n = 3000
    t = {"t": {"columns": {"a": rng.integers(0, 50, n)},
               "types": {"a": ("int", 64, 0, 0)}}}
    cat = tcatalog.catalog_from_host(t, device="cpu")
    for rows, spills in ((1024, True), (1 << 21, False)):
        tsettings.set("sql.distsql.tile_size", 1024)
        tsettings.set("sql.distsql.workmem_rows", rows)
        try:
            root = tbuilder.build(TRel.scan(cat, "t").sort([("a", False)])
                                  .plan, cat)
            got = trun(root)
        finally:
            tsettings.reset()
        assert root.stats.spilled == spills
        np.testing.assert_array_equal(got["a"], np.sort(t["t"]["columns"]["a"]))


def test_settings_set_and_reset():
    assert tsettings.get("sql.distsql.grace_skew_sample") == 1024
    assert tsettings.get("sql.distsql.grace_skew_frac") == 0.05
    tsettings.set("sql.distsql.dense_lut_bits", 14)
    assert tsettings.get("sql.distsql.dense_lut_bits") == 14
    with pytest.raises(ValueError):
        tsettings.set("sql.distsql.workmem_bytes", 10)
    with pytest.raises(TypeError):
        tsettings.set("sql.distsql.shape_buckets.enabled", 1)
    tsettings.reset("sql.distsql.dense_lut_bits")
    assert tsettings.get("sql.distsql.dense_lut_bits") == 24
    with pytest.raises(KeyError):
        tsettings.reset("no.such.setting")
