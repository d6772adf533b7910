"""Fusion in the port (flow/fuse.py, flow/dispatch.py, the fused pulls
and speculative join emission of flow/operators.py) on the CPU, where
``dispatch.jit`` composes each chain eagerly (the card replays it as a
CUDA graph; ``chip_smoke.py`` holds that path).

The cases of the reference's tests/test_fusion.py,
tests/test_dispatch_budget.py and tests/test_recompiles.py:
``sql.distsql.fusion.enabled=off`` is the oracle every fused run equals
bit for bit (all 22 TPC-H queries at sf=0.005, seed 7, each fused run's
new signatures checked by the capture guard, the CPU's stand-in for a
CUDA graph capture), through the speculative-capacity retry path, the
general duplicate-key probe, the readback shrink's overflow patch and
forced Grace spills. The port's steady dispatch counts stay within
scripts/check_dispatch_budget.py's recorded budgets (the reference's
count printed beside), a repeat query compiles nothing, and host syncs
do not grow with the number of probe tiles. The fused port's equality
with the reference (results, operator trees with their fusion nodes, and
learned join emission) is held by test_torch_tpch.py,
test_torch_tpch_ladder.py and test_torch_tpch_all.py, whose port runs
are fused by default.
"""

import numpy as np
import pytest
import torch

from cockroach_tpu_torch.bench import queries as Q
from cockroach_tpu_torch.bench import tpch
from cockroach_tpu_torch.coldata.batch import from_host, to_host
from cockroach_tpu_torch.coldata.types import INT64, Schema
from cockroach_tpu_torch.flow import dispatch
from cockroach_tpu_torch.flow import fuse
from cockroach_tpu_torch.flow import runtime
from cockroach_tpu_torch.flow.operators import HashJoinOp, ScanOp
from cockroach_tpu_torch.plan import builder
from cockroach_tpu_torch.sql.rel import Rel
from cockroach_tpu_torch.utils import metric, settings

SF, SEED = 0.005, 7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tiny tiles gain nothing from intra-op threads, and several
    test workers' thread pools on shared cores slow each other down."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def cat():
    return tpch.gen_tpch(sf=SF, seed=SEED, device="cpu")


def _run(rel, fusion: bool, overlap: bool = True):
    settings.set("sql.distsql.fusion.enabled", fusion)
    settings.set("sql.distsql.readback_overlap", overlap)
    try:
        return runtime.run_operator(builder.build(rel.optimized_plan(),
                                                  rel.catalog))
    finally:
        settings.reset("sql.distsql.fusion.enabled")
        settings.reset("sql.distsql.readback_overlap")


def _assert_identical(got, want):
    assert list(got) == list(want)
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.shape == w.shape, name
        if g.dtype == object or w.dtype == object:
            assert list(g) == list(w), name
        else:
            # bit-identical, not allclose: fusion must not reassociate
            np.testing.assert_array_equal(g, w, err_msg=name)


def _walk(op):
    yield op
    for c in op.children():
        yield from _walk(c)


@pytest.mark.parametrize("qname", sorted(Q.QUERIES))
def test_tpch_fusion_equivalence(cat, qname):
    rel = Q.QUERIES[qname](cat)
    with dispatch.capture_checks():
        fused = _run(rel, fusion=True)
    _assert_identical(fused, _run(rel, fusion=False))


def test_fusion_nodes_inserted_only_when_enabled(cat):
    rel = Q.q3(cat)
    settings.set("sql.distsql.fusion.enabled", False)
    try:
        plain = builder.build(rel.optimized_plan(), cat)
    finally:
        settings.reset("sql.distsql.fusion.enabled")
    fused = builder.build(rel.optimized_plan(), cat)
    kinds = {type(o) for o in _walk(fused)}
    assert fuse.FusedPipeline in kinds or fuse._BarrierSource in kinds \
        or any(isinstance(o, HashJoinOp) for o in _walk(fused))
    assert not any(isinstance(o, (fuse.FusedPipeline, fuse._BarrierSource))
                   for o in _walk(plain))
    assert type(fuse.unwrap(fused)).__name__ == type(plain).__name__


def test_readback_overlap_equivalence(cat):
    rel = Q.QUERIES["q3"](cat)
    _assert_identical(_run(rel, fusion=True, overlap=True),
                      _run(rel, fusion=True, overlap=False))


def test_retry_path_equivalence(cat):
    """Shrinking a learned join emission capacity must trigger the
    post_run_update -> re-run path and still give the unfused result."""
    rel = Q.QUERIES["q3"](cat)
    oracle = _run(rel, fusion=False)
    root = builder.build(rel.optimized_plan(), cat)
    runtime.run_operator(root)  # learn emission capacities
    joins = [o for o in _walk(root) if isinstance(o, HashJoinOp)]
    assert joins, "q3 plan lost its hash joins"
    for j in joins:
        j._emit_mode = "compact"
        j._emit_cap = 16  # guaranteed overflow at sf 0.005
    inits = 0
    orig_init = root.init

    def counting_init():
        nonlocal inits
        inits += 1
        orig_init()

    root.init = counting_init
    res = runtime.run_operator(root)
    assert inits >= 2, "overflow did not trigger the re-run path"
    _assert_identical(res, oracle)


def test_retry_gives_up_when_capacities_never_converge(cat, monkeypatch):
    root = builder.build(Q.q3(cat).optimized_plan(), cat)
    join = next(o for o in _walk(root) if isinstance(o, HashJoinOp))
    monkeypatch.setattr(join, "post_run_update", lambda: True)
    with pytest.raises(RuntimeError, match="failed to converge"):
        runtime.run_operator(root)


def test_readback_shrink_overflow_patch():
    """A large tile compacts to capacity/64 with no host sync; when the
    deferred count shows the compaction truncated live rows, finish()
    re-materializes from the retained original: no row lost."""
    schema = Schema(("v",), (INT64,))
    cap = runtime._ReadbackShrink.MIN_CAP
    live = cap // 2  # far more live rows than the cap/64 target
    b = from_host(schema, {"v": np.arange(live, dtype=np.int64)},
                  capacity=cap, device="cpu")
    shrink = runtime._ReadbackShrink()
    small = shrink.shrink(b)
    assert small.capacity == cap >> 6  # speculation actually engaged
    outs = [to_host(small, schema, {})]
    assert len(outs[0]["v"]) < live  # truncated before the patch
    shrink.finish(outs, schema, {})
    np.testing.assert_array_equal(outs[0]["v"],
                                  np.arange(live, dtype=np.int64))
    # small tiles pass through untouched (no compaction to pay)
    tiny = from_host(schema, {"v": np.arange(10, dtype=np.int64)},
                     capacity=1024, device="cpu")
    assert shrink.shrink(tiny) is tiny


def test_general_probe_fusion_equivalence(cat):
    """Duplicate-key inner probes fuse as speculative emitters under
    sql.distsql.fusion.general_probe; the gated-off run, where the probe
    breaks the chain, is the oracle. The speculation starts small enough
    here that the first run overflows and re-runs."""
    rel = (Rel.scan(cat, "orders")
           .join(Rel.scan(cat, "lineitem"),
                 on=[("o_orderkey", "l_orderkey")], how="inner",
                 build_unique=False)
           .groupby(["o_orderkey"], [("n", "count_rows", None)]))
    settings.set("sql.distsql.fusion.general_probe", False)
    try:
        want = _run(rel, fusion=True)
    finally:
        settings.reset("sql.distsql.fusion.general_probe")
    _assert_identical(_run(rel, fusion=True), want)
    settings.set("sql.distsql.tile_size", 1024)
    try:
        root = builder.build(rel.optimized_plan(), cat)
        join = next(o for o in _walk(root) if isinstance(o, HashJoinOp))
        assert join._emit_mode == "general"
        join._emit_cap = 1024  # below a probe tile's true total
        got = runtime.run_operator(root)
    finally:
        settings.reset("sql.distsql.tile_size")
    assert join._emit_cap > 1024  # the overflow grew the capacity
    _assert_identical(got, want)


@pytest.mark.parametrize("qname", ["q9", "q18"])
def test_spill_and_skew_forced_tpch_equivalence(cat, qname):
    """Forced Grace spills (workmem down to its floor, the skew sampler
    armed) change no bit of the fused result."""
    rel = Q.QUERIES[qname](cat)
    want = _run(rel, fusion=True)
    spills0 = metric.GRACE_JOIN_SPILLS.value
    settings.set("sql.distsql.workmem_bytes", 1 << 16)
    settings.set("sql.distsql.grace_skew_frac", 0.02)
    try:
        got = _run(rel, fusion=True)
    finally:
        settings.reset("sql.distsql.workmem_bytes")
        settings.reset("sql.distsql.grace_skew_frac")
    assert metric.GRACE_JOIN_SPILLS.value > spills0, "never spilled"
    _assert_identical(got, want)


# ---------------------------------------------------------------------------
# dispatch budget, recompiles, syncs

# scripts/check_dispatch_budget.py's recorded constants
BUDGET_STEADY = {"q1": 10, "q9": 24, "q18": 27}
BUDGET_PER_TILE = 1.25


@pytest.fixture(scope="module")
def budget_cats():
    from cockroach_tpu.bench.tpch import gen_tpch as jgen

    return jgen(sf=0.001, seed=3), tpch.gen_tpch(sf=0.001, seed=3,
                                                 device="cpu")


def _steady_dispatches(tcat, tile: int, qname: str) -> int:
    settings.set("sql.distsql.tile_size", tile)
    try:
        root = builder.build(Q.QUERIES[qname](tcat).optimized_plan(), tcat)
        runtime.run_operator(root)  # warm: adaptive capacity learning
        d0 = dispatch.total()
        runtime.run_operator(root)
        return dispatch.total() - d0
    finally:
        settings.reset("sql.distsql.tile_size")


@pytest.mark.parametrize("qname", ["q1", "q9", "q18"])
def test_dispatch_budget(budget_cats, qname):
    from cockroach_tpu.utils import settings as jsettings
    from scripts.check_dispatch_budget import _steady_dispatches as jsteady

    jcat, tcat = budget_cats
    got = _steady_dispatches(tcat, 1024, qname)
    try:
        ref = jsteady(jcat, 1024, qname)
    finally:
        jsettings.reset("sql.distsql.tile_size")
    print(f"{qname} steady dispatches: port {got}, reference {ref}")
    assert got <= BUDGET_STEADY[qname], (got, ref)


def test_dispatch_budget_per_tile(budget_cats):
    _, tcat = budget_cats
    tiles = -(-tcat.get("lineitem").num_rows // 1024)
    steady = _steady_dispatches(tcat, 1024, "q1")
    halved = _steady_dispatches(tcat, 512, "q1")
    per_tile = (halved - steady) / tiles
    print(f"q1 dispatches per extra tile: {per_tile} "
          f"({steady} -> {halved}, {tiles} tiles)")
    assert per_tile <= BUDGET_PER_TILE


@pytest.mark.parametrize("qname", ["q1", "q3", "q9", "q18"])
def test_repeat_query_compiles_nothing(cat, qname):
    """The first run compiles, the second may compile the shapes its
    learned join capacities pick, and a third compiles nothing (on the
    card: captures no graph)."""
    root = builder.build(Q.QUERIES[qname](cat).optimized_plan(), cat)
    c0 = dispatch.compiles()
    first = runtime.run_operator(root)
    c1 = dispatch.compiles()
    runtime.run_operator(root)
    c2 = dispatch.compiles()
    third = runtime.run_operator(root)
    assert c1 > c0
    assert dispatch.compiles() == c2
    _assert_identical(third, first)


@pytest.mark.parametrize("qname", ["q3", "q9"])
def test_probe_syncs_do_not_grow_with_tiles(cat, qname):
    """Probe-aligned joins read their emission counts once per query,
    whatever the number of probe tiles (the port synced once per probe
    tile before fusion)."""
    syncs = {}
    for tile in (1024, 8192):
        settings.set("sql.distsql.tile_size", tile)
        try:
            root = builder.build(Q.QUERIES[qname](cat).optimized_plan(), cat)
            runtime.run_operator(root)
        finally:
            settings.reset("sql.distsql.tile_size")
        scan = next(o for o in _walk(root) if isinstance(o, ScanOp)
                    and o.table.name == "lineitem")
        assert scan._res_tile == tile  # 30 probe tiles, then 4
        joins = [o for o in _walk(root) if isinstance(o, HashJoinOp)
                 and o.probe_aligned]
        syncs[tile] = sum(j.stats.host_syncs for j in joins)
    assert syncs[1024] == syncs[8192] > 0


# ---------------------------------------------------------------------------
# flow/dispatch on the CPU


def test_jit_counts_dispatches_and_signatures():
    fn = dispatch.jit(lambda x, k: x * k)
    d0, c0 = dispatch.total(), dispatch.compiles()
    a = torch.arange(4)
    fn(a, 2)
    fn(a + 1, 2)  # same signature
    fn(a, 3)  # a new non-tensor value
    fn(torch.arange(8), 2)  # a new shape
    assert dispatch.total() - d0 == 4
    assert dispatch.compiles() - c0 == 3


def test_jit_kernel_cache_shares_by_key():
    dispatch.clear_kernel_cache()
    h0 = dispatch.kernel_cache_hits()
    key = dispatch.kernel_key("test", (1, 2))
    f = dispatch.jit(lambda x: x + 1, key=key)
    g = dispatch.jit(lambda x: x + 2, key=key)
    assert f is g and dispatch.kernel_cache_hits() == h0 + 1
    assert dispatch.kernel_key("test", [1]) is None  # unhashable: no sharing
    dispatch.clear_kernel_cache()
    assert dispatch.kernel_cache_size() == 0


def test_jit_carry_returns_new_state():
    step = dispatch.jit(lambda acc, x: (acc + x.sum(), None), carry=True)
    acc = torch.zeros((), dtype=torch.int64)
    for i in range(3):
        acc, _ = step(acc, torch.full((4,), i))
    assert int(acc) == 12


@pytest.mark.parametrize("case", ["item", "nonzero", "mask_index",
                                  "host_array", "unique", "repeat"])
def test_capture_guard_refuses_host_reads(case):
    x = torch.arange(8)
    fns = {
        "item": lambda t: t[0] + int(t.sum()),
        "nonzero": lambda t: torch.nonzero(t),
        "mask_index": lambda t: t[t > 3],
        "host_array": lambda t: t + torch.from_numpy(np.ones(8, np.int64)),
        "unique": lambda t: torch.unique(t),
        "repeat": lambda t: torch.repeat_interleave(t, t),
    }
    fn = dispatch.jit(fns[case])
    with dispatch.capture_checks():
        with pytest.raises(dispatch.GraphCaptureError, match="captured"):
            fn(x)
    fn(x)  # outside the checks the same call runs


def test_capture_guard_admits_static_shapes():
    fn = dispatch.jit(lambda t: (torch.repeat_interleave(
        t, t, output_size=28), torch.searchsorted(t, t), t.sort().values))
    with dispatch.capture_checks():
        out = fn(torch.arange(8))
    assert out[0].shape == (28,)


def test_own_and_persist_pass_cpu_tensors_through():
    b = from_host(Schema(("v",), (INT64,)), {"v": np.arange(3)},
                  capacity=1024, device="cpu")
    assert dispatch.own(b) is b
    store: list = []
    assert dispatch.persist(store, b) is b and store == []
