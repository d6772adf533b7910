"""The port's across-hosts DistSQL plane (cockroach_tpu_torch/flow/
{dcn,wire,disthost}.py, coldata/arrow.py and the distribution operators)
against the reference's on the CPU: the plan wire format's JSON equal to
the reference's; the numpy batch framing's round trip equal to the
reference's Arrow round trip; the two-process aggregation and hash join
(spawned hosts, TPC-H sf=0.005, seed 23) equal to one port device and to
the reference's own two-process run; cancellation poisoning a flow id;
degradation onto a surviving host; EXPLAIN's lines; the ordered
fan-in; the arrow converters against the reference's. Floats of a
distributed aggregation compare within rtol=1e-9 (the shards' partial
sums add in another order); everything else exactly. Torch runs on one
thread."""

import json
import multiprocessing as mp
import queue
import socket
import time

import numpy as np
import pytest
import torch

from cockroach_tpu.bench import tpch as jtpch
from cockroach_tpu.coldata import arrow as jarrow
from cockroach_tpu.coldata import types as JT
from cockroach_tpu.coldata.batch import Dictionary as JDict
from cockroach_tpu.coldata.batch import from_host as jfrom_host
from cockroach_tpu.flow import dcn as jdcn
from cockroach_tpu.flow import disthost as jdh
from cockroach_tpu.flow import wire as jwire
from cockroach_tpu.ops import aggregation as jagg
from cockroach_tpu.ops import expr as jex
from cockroach_tpu.plan import spec as JS
from cockroach_tpu_torch.bench import tpch as ttpch
from cockroach_tpu_torch.coldata import arrow as tarrow
from cockroach_tpu_torch.coldata import types as TT
from cockroach_tpu_torch.coldata.batch import Dictionary as TDict
from cockroach_tpu_torch.coldata.batch import from_host as tfrom_host
from cockroach_tpu_torch.flow import dcn as tdcn
from cockroach_tpu_torch.flow import disthost as tdh
from cockroach_tpu_torch.flow import wire as twire
from cockroach_tpu_torch.flow.operator import Operator
from cockroach_tpu_torch.flow.operators import OrderedSyncOp
from cockroach_tpu_torch.flow.runtime import run_operator
from cockroach_tpu_torch.ops import aggregation as tagg
from cockroach_tpu_torch.ops import expr as tex
from cockroach_tpu_torch.ops.sort import SortKey
from cockroach_tpu_torch.plan import builder as tbuilder
from cockroach_tpu_torch.plan import spec as TS
from cockroach_tpu_torch.utils import metric

SF, SEED = 0.005, 23
RTOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# -- plans in either package ---------------------------------------------------


def _filter(S, ex, cat):
    sch = cat.get("orders").schema
    return S.Filter(S.TableScan("orders", None),
                    ex.Cmp("gt", ex.ColRef(sch.index("o_totalprice")),
                           ex.lit(1000.0)))


def _agg(S, ex, A, cat):
    """The reference's two-process aggregation (tests/test_dcn.py)."""
    sch = cat.get("orders").schema
    return S.Aggregate(
        _filter(S, ex, cat),
        group_cols=(sch.index("o_shippriority"),),
        aggs=(A.AggSpec("count_rows", None, "n"),
              A.AggSpec("sum", sch.index("o_totalprice"), "total"),
              A.AggSpec("max", sch.index("o_orderdate"), "latest")),
        mode="complete")


def _q1(S, A, cat):
    """q1's shape: lineitem grouped by two STRING keys."""
    li = cat.get("lineitem").schema
    return S.Aggregate(
        S.TableScan("lineitem"),
        group_cols=(li.index("l_returnflag"), li.index("l_linestatus")),
        aggs=(A.AggSpec("sum", li.index("l_quantity"), "sum_qty"),
              A.AggSpec("avg", li.index("l_extendedprice"), "avg_price"),
              A.AggSpec("count_rows", None, "count_order")))


def _join(S, ex):
    """The reference's hash-repartitioned join (tests/test_dcn.py)."""
    return S.HashJoin(
        probe=S.TableScan("lineitem", ("l_orderkey", "l_extendedprice")),
        build=S.Filter(S.TableScan("orders", ("o_orderkey", "o_totalprice")),
                       ex.Cmp("lt", ex.ColRef(1), ex.lit(10000.0))),
        probe_keys=(0,), build_keys=(0,))


def _fragment(S, T):
    sch = T.Schema(("k", "v"), (T.INT64, T.FLOAT64))
    return S.HashJoin(
        S.StreamUnion((
            S.RemoteStream(("127.0.0.1", 1234), "f1", 1001, sch),
            S.RemoteStream(("127.0.0.1", 1235), "f1", 1003, sch),
        )),
        S.HashBucket(S.TableScan("orders", ("o_orderkey",), shard=(0, 2)),
                     (0,), 2, 1),
        (0,), (0,))


def _exprs(ex, T):
    """One of each expression kind the wire carries."""
    c0, c1 = ex.ColRef(0), ex.ColRef(1)
    return (
        ex.BoolOp("and", (ex.Not(ex.IsNull(c0, negate=True)),
                          ex.Cmp("le", ex.BinOp("*", c0, ex.lit(2)),
                                 ex.lit(7)))),
        ex.Coalesce((c1, ex.Const(1.5, T.FLOAT64))),
        ex.Cast(ex.ExtractYear(ex.ColRef(2)), T.INT32),
        ex.Func1("abs", c1),
        ex.Case(((ex.Cmp("eq", c0, ex.lit(1)), ex.lit(10)),), ex.lit(20)),
        ex.CodeLookup(3, np.array([True, False, True]), T.BOOL),
    )


def test_wire_json_equals_reference():
    """enc_plan gives the reference's JSON for a filter, an aggregation
    (partial mode, over a projection of every expression kind) and a
    repartitioned join fragment; dec_plan rebuilds the port's plan."""
    jcat = jtpch.gen_tpch(sf=0.001, seed=SEED)
    tcat = ttpch.gen_tpch(sf=0.001, seed=SEED, device="cpu")
    plans = {}
    for name, S, ex, A, T, cat in (
            ("jax", JS, jex, jagg, JT, jcat),
            ("torch", TS, tex, tagg, TT, tcat)):
        proj = S.Project(S.TableScan("t", shard=(1, 3)), _exprs(ex, T),
                         tuple("abcdef"))
        plans[name] = [
            _filter(S, ex, cat),
            S.Aggregate(proj, (0,), (A.AggSpec("sum", 1, "s"),
                                     A.AggSpec("avg", 2, "a")),
                        mode="partial"),
            _fragment(S, T),
        ]
    for jp, tp in zip(plans["jax"], plans["torch"]):
        jj = json.dumps(jwire.enc_plan(jp), sort_keys=True)
        tj = json.dumps(twire.enc_plan(tp), sort_keys=True)
        assert tj == jj
        back = twire.dec_plan(json.loads(tj))
        assert json.dumps(twire.enc_plan(back), sort_keys=True) == tj
    assert twire.dec_plan(twire.enc_plan(plans["torch"][2])) == \
        plans["torch"][2]


# -- the batch framing --------------------------------------------------------


def _case(name: str, rng):
    """(schema spec, host arrays, valids, dictionary values, live mask)."""
    n = 41
    if name == "empty":
        spec = (("k", "INT64"), ("s", "STRING"), ("d", "DECIMAL"))
        arrays = {"k": np.zeros(0, np.int64), "s": np.zeros(0, np.int32),
                  "d": np.zeros(0, np.int64)}
        return spec, arrays, {}, ["x", "y"], np.zeros(0, bool)
    spec = {
        "nulls": (("i", "INT64"), ("f", "FLOAT64"), ("h", "INT32")),
        "decimal": (("d", "DECIMAL"), ("e", "DECIMAL")),
        "date": (("dt", "DATE"), ("i", "INT64")),
        "string": (("s", "STRING"), ("i", "INT64")),
        "bool": (("b", "BOOL"), ("i", "INT64")),
    }[name]
    arrays, valids = {}, {}
    for col, kind in spec:
        if kind in ("INT64", "DECIMAL"):
            a = rng.integers(-10**9, 10**9, n)
        elif kind == "FLOAT64":
            a = rng.normal(size=n) * 1e3
        elif kind in ("INT32", "DATE"):
            a = rng.integers(0, 20000, n).astype(np.int32)
        elif kind == "STRING":
            a = rng.integers(0, 4, n).astype(np.int32)
        else:
            a = rng.random(n) < 0.5
        arrays[col] = a
        if kind != "BOOL":  # the reference cannot carry a NULL BOOL
            valids[col] = rng.random(n) < 0.7
    live = rng.random(n) < 0.6
    return spec, arrays, valids, ["pear", "apple", "fig", "kiwi"], live


def _types(T, spec):
    return T.Schema(tuple(c for c, _ in spec), tuple(
        T.DECIMAL(15, 2) if k == "DECIMAL" else getattr(T, k)
        for _, k in spec))


@pytest.mark.parametrize("case", ["nulls", "decimal", "date", "string",
                                  "bool", "empty"])
def test_framing_round_trip_equals_reference_arrow(case):
    """The port's numpy framing round-trips a batch's live rows to the
    same Batch (capacity, mask, data, validity), schema and dictionaries
    as the reference's Arrow IPC round trip of the same batch."""
    spec, arrays, valids, dvals, live = _case(case, np.random.default_rng(3))
    got = {}
    for name, T, from_host, Dict, codec in (
            ("jax", JT, jfrom_host, JDict, jdcn),
            ("torch", TT, tfrom_host, TDict, tdcn)):
        sch = _types(T, spec)
        kw = {} if name == "jax" else {"device": "cpu"}
        b = from_host(sch, arrays, valids=valids, **kw)
        mask = np.zeros(b.capacity, bool)
        mask[:len(live)] = live
        b = b.with_mask(torch.from_numpy(mask) if name == "torch"
                        else __import__("jax").numpy.asarray(mask))
        dicts = {i: Dict(np.array(dvals, dtype=object))
                 for i, (_, k) in enumerate(spec) if k == "STRING"}
        payload = codec._encode_batch(b, sch, dicts)
        out = (codec._decode_batch(payload) if name == "jax"
               else codec._decode_batch(payload, "cpu"))
        got[name] = out
    (jb, js, jd), (tb, ts, td) = got["jax"], got["torch"]
    assert ts.names == js.names
    assert [repr(t) for t in ts.types] == [repr(t) for t in js.types]
    assert tb.capacity == jb.capacity
    np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
    for tc, jc in zip(tb.cols, jb.cols):
        np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data))
        np.testing.assert_array_equal(tc.valid.numpy(),
                                      np.asarray(jc.valid))
    assert sorted(td) == sorted(jd)
    for i in td:
        assert list(td[i].values) == list(jd[i].values)


def test_null_bool_round_trips_where_the_reference_raises():
    """A NULL BOOL: the port's framing carries it (data False, invalid);
    the reference's Arrow decode raises (``fill_null(0)`` on a boolean
    array, ROADMAP Queue 3 item 35)."""
    arrays = {"b": np.array([True, False, True])}
    valids = {"b": np.array([True, False, True])}
    tb = tfrom_host(TT.Schema(("b",), (TT.BOOL,)), arrays, valids=valids,
                    device="cpu")
    out, _s, _d = tdcn._decode_batch(
        tdcn._encode_batch(tb, TT.Schema(("b",), (TT.BOOL,)), {}), "cpu")
    assert out.cols[0].data[:3].tolist() == [True, False, True]
    assert out.cols[0].valid[:3].tolist() == [True, False, True]
    jb = jfrom_host(JT.Schema(("b",), (JT.BOOL,)), arrays, valids=valids)
    payload = jdcn._encode_batch(jb, JT.Schema(("b",), (JT.BOOL,)), {})
    with pytest.raises(Exception, match="boolean"):
        jdcn._decode_batch(payload)


def test_stream_dictionary_mismatch_raises():
    """Codes read against the plan's dictionary: a stream whose batch
    carries another dictionary for the column is refused."""
    sch = TT.Schema(("s",), (TT.STRING,))
    b = tfrom_host(sch, {"s": np.array([0, 1], np.int32)}, device="cpu")
    a, c = socket.socketpair()
    try:
        inbox = tdcn.FlowInbox(
            c, sch, {0: TDict(np.array(["a", "b"], dtype=object))},
            device="cpu")
        for vals in (["a", "b"], ["b", "a"]):
            tdcn._send_msg(a, tdcn._encode_batch(
                b, sch, {0: TDict(np.array(vals, dtype=object))}))
        assert inbox.next_batch() is not None
        with pytest.raises(ValueError, match="differs"):
            inbox.next_batch()
    finally:
        a.close()
        c.close()


def test_arrow_converters_equal_reference():
    """The port's pyarrow converters (imported inside the functions)
    give the reference's Arrow table for a TPC-H table, and read it
    back to the same host columns."""
    jcat = jtpch.gen_tpch(sf=0.001, seed=SEED)
    tcat = ttpch.gen_tpch(sf=0.001, seed=SEED, device="cpu")
    for name in ("orders", "nation"):
        jt = jarrow.table_to_arrow(jcat.get(name))
        tt = tarrow.table_to_arrow(tcat.get(name))
        assert tt.equals(jt)
        back = tarrow.table_from_arrow(name, tt)
        ref = jarrow.table_from_arrow(name, jt)
        assert back.schema.names == ref.schema.names
        for c in ref.schema.names:
            np.testing.assert_array_equal(back.columns[c], ref.columns[c])


# -- two processes --------------------------------------------------------------


def _reporting(serve, q, stop):
    """Runs a child's body, handing its queue the traceback of a failure
    before it exits, so the parent fails at once with the cause."""
    try:
        serve(q, stop)
    except BaseException:
        import traceback

        q.put(traceback.format_exc())
        raise


def _serve_port(q, stop):
    _reporting(_serve_port_body, q, stop)


def _serve_reference(q, stop):
    _reporting(_serve_reference_body, q, stop)


def _serve_port_body(q, stop):
    """Child process: a port HostFlowServer on the CPU over the seeded
    catalog; fragments arrive as plan specs and build here. It serves
    until `stop` is set (its own queue would hand back its address)."""
    import torch

    torch.set_num_threads(1)
    from cockroach_tpu_torch.bench import tpch
    from cockroach_tpu_torch.flow.disthost import HostFlowServer

    cat = tpch.gen_tpch(sf=SF, seed=SEED, device="cpu")
    srv = HostFlowServer(cat, device="cpu").serve_background()
    q.put(tuple(srv.addr))
    stop.wait()
    srv.close()


def _serve_reference_body(q, stop):
    """Child process: the reference's HostFlowServer, as its own test
    starts it (tests/test_dcn.py)."""
    from cockroach_tpu.utils.backend import force_cpu_backend

    force_cpu_backend()
    from cockroach_tpu.bench import tpch
    from cockroach_tpu.flow.disthost import HostFlowServer

    srv = HostFlowServer(tpch.gen_tpch(sf=SF, seed=SEED)).serve_background()
    q.put(tuple(srv.addr))
    stop.wait()
    srv.close()


def _host_addr(q, p, timeout_s: float = 300.0):
    """The address a host process serves on. Raises with the child's
    traceback, or at once when it exits without one, or after
    `timeout_s`: a host that cannot start fails its tests, not the run."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            got = q.get(timeout=1.0)
        except queue.Empty:
            if not p.is_alive():
                raise RuntimeError(f"host process exited with code "
                                   f"{p.exitcode} before serving")
            if time.monotonic() > deadline:
                raise TimeoutError(f"host process not serving after "
                                   f"{timeout_s:.0f} s")
            continue
        if isinstance(got, str):
            raise RuntimeError("host process failed:\n" + got)
        return got


@pytest.fixture(scope="module")
def hosts():
    """Two port hosts and two reference hosts, spawned together."""
    ctx = mp.get_context("spawn")
    stop = ctx.Event()
    procs = []
    for target in (_serve_port, _serve_port, _serve_reference,
                   _serve_reference):
        q = ctx.Queue()
        p = ctx.Process(target=target, args=(q, stop), daemon=True)
        p.start()
        procs.append((q, p))
    try:
        addrs = [_host_addr(q, p) for q, p in procs]
        yield {"torch": addrs[:2], "jax": addrs[2:]}
    finally:
        stop.set()
        for _q, p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()


@pytest.fixture(scope="module")
def cats():
    return (jtpch.gen_tpch(sf=SF, seed=SEED),
            ttpch.gen_tpch(sf=SF, seed=SEED, device="cpu"))


def _rows(res) -> np.ndarray:
    rows = np.stack([np.asarray(res[k], dtype=np.float64)
                     for k in sorted(res)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def test_aggregation_across_two_processes(hosts, cats):
    """Remote partial fragments over scan shards and the gateway's final
    stage equal one port device and the reference's two-process run."""
    jcat, tcat = cats
    tplan = _agg(TS, tex, tagg, tcat)
    one = run_operator(tbuilder.build(tplan, tcat))
    got = tdh.run_distributed_hosts(tplan, tcat, hosts["torch"])
    ref = jdh.run_distributed_hosts(_agg(JS, jex, jagg, jcat), jcat,
                                    hosts["jax"])
    assert list(got) == list(one) == list(ref)
    np.testing.assert_allclose(_rows(got), _rows(one), rtol=RTOL)
    np.testing.assert_allclose(_rows(got), _rows(ref), rtol=RTOL)
    assert tdh.explain_hosts(tplan, 2) == jdh.explain_hosts(
        _agg(JS, jex, jagg, jcat), 2)


def test_string_keyed_aggregation_across_two_processes(hosts, cats):
    """q1's shape: STRING group keys cross the wire as codes read against
    the gateway's own dictionaries; equal to one device."""
    _jcat, tcat = cats
    plan = _q1(TS, tagg, tcat)
    one = run_operator(tbuilder.build(plan, tcat))
    got = tdh.run_distributed_hosts(plan, tcat, hosts["torch"])
    assert list(got) == list(one)
    for k in ("l_returnflag", "l_linestatus", "count_order"):
        assert list(got[k]) == list(one[k])
    for k in ("sum_qty", "avg_price"):
        np.testing.assert_allclose(got[k], one[k], rtol=RTOL)


def test_hash_repartitioned_join_across_two_processes(hosts, cats):
    """Every host scans its shard of both sides and scatters rows by key
    hash; each joins one partition; the gateway unions the joined streams.
    Equal (as row multisets) to one device and to the reference's
    two-process join."""
    jcat, tcat = cats
    one = run_operator(tbuilder.build(_join(TS, tex), tcat))
    got = tdh.run_distributed_join(_join(TS, tex), tcat, hosts["torch"])
    ref = jdh.run_distributed_join(_join(JS, jex), jcat, hosts["jax"])
    assert sorted(got) == sorted(one) == sorted(ref)
    assert len(got["l_orderkey"]) > 0
    np.testing.assert_array_equal(_rows(got), _rows(one))
    np.testing.assert_array_equal(_rows(got), _rows(ref))
    assert tdh.explain_host_join(_join(TS, tex), 2) == \
        jdh.explain_host_join(_join(JS, jex), 2)


def test_cancel_poisons_the_flow_id(hosts, cats):
    """CANCEL_FLOW removes a flow's registered streams and poisons its id:
    a late setup and a stream attach for it fail at once."""
    _jcat, tcat = cats
    addr = hosts["torch"][0]
    frag = TS.TableScan("nation")
    tdh.setup_flow(addr, "poisoned1", {0: frag, 1: frag})
    c0 = metric.DIST_FLOWS_CANCELLED.value
    assert tdh.cancel_flow(addr, "poisoned1") == 2
    assert metric.DIST_FLOWS_CANCELLED.value == c0 + 2
    with pytest.raises(RuntimeError, match="cancelled"):
        tdh.setup_flow(addr, "poisoned1", {0: frag})
    schema = tcat.get("nation").schema
    with pytest.raises(RuntimeError, match="flow cancelled"):
        tdh.attach_stream(addr, "poisoned1", 0, schema, device="cpu")


def test_degrades_onto_the_surviving_host(hosts, cats):
    """A host that does not answer: the gateway cancels the flow, probes
    which hosts still answer and re-plans onto the survivor; the result
    equals one device and distsql_degraded_queries counts it."""
    _jcat, tcat = cats
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_addr = dead.getsockname()
    dead.close()
    plan = _agg(TS, tex, tagg, tcat)
    one = run_operator(tbuilder.build(plan, tcat))
    d0 = metric.DIST_DEGRADED.value
    got = tdh.run_distributed_hosts(plan, tcat,
                                    [hosts["torch"][0], dead_addr])
    assert metric.DIST_DEGRADED.value == d0 + 1
    np.testing.assert_allclose(_rows(got), _rows(one), rtol=RTOL)


def test_host_fragments_reject_unshardable_plans():
    sortp = TS.Sort(TS.TableScan("orders"), ())
    with pytest.raises(TypeError):
        tdh.plan_host_fragments(
            TS.Aggregate(sortp, (0,), (tagg.AggSpec("count_rows", None,
                                                    "n"),)), 2)
    with pytest.raises(TypeError):
        tdh.plan_host_fragments(TS.TableScan("orders"), 2)


def test_host_server_defaults_to_the_card(cats):
    """``device`` defaults to "cuda": without a card the server raises;
    a catalog on another device is refused."""
    _jcat, tcat = cats
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="catalog on cpu"):
            tdh.HostFlowServer(tcat)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdh.HostFlowServer(tcat)


# -- the ordered fan-in ---------------------------------------------------------

_SCHEMA = TT.Schema(("x", "tag"), (TT.INT64, TT.INT64))


class _SortedSource(Operator):
    """A pre-sorted stream in tiles of `tile` rows."""

    def __init__(self, values, tag, tile=4, schema=_SCHEMA):
        super().__init__()
        self.output_schema = schema
        self.values = list(values)
        self.tag = tag
        self.tile = tile
        self.pulls = 0

    def init(self):
        super().init()
        self._i = 0

    def _next(self):
        if self._i >= len(self.values):
            return None
        chunk = self.values[self._i:self._i + self.tile]
        self._i += len(chunk)
        self.pulls += 1
        return tfrom_host(self.output_schema, {
            "x": np.array(chunk), "tag": np.full(len(chunk), self.tag)},
            device="cpu")


def test_ordered_fan_in_streams_in_order():
    """Sorted inputs merge into one sorted stream, the first tile out
    after one pull per input (the barrier), not after an input ends."""
    a = _SortedSource(list(range(0, 100, 2)), tag=0, tile=5)
    b = _SortedSource(list(range(1, 100, 2)), tag=1, tile=5)
    op = OrderedSyncOp((a, b), (SortKey(0),))
    op.init()
    assert op._streaming
    first = op.next_batch()
    assert 0 < int(first.mask.sum()) <= 10
    assert a.pulls <= 2 and b.pulls <= 2
    xs = list(first.cols[0].data[first.mask].tolist())
    while True:
        t = op.next_batch()
        if t is None:
            break
        xs.extend(t.cols[0].data[t.mask].tolist())
    assert xs == list(range(100))
    c = _SortedSource([1, 4, 7], tag=0)
    d = _SortedSource([2, 3, 9, 11], tag=1)
    out = run_operator(OrderedSyncOp((c, d), (SortKey(0, desc=False),)))
    assert list(out["x"]) == [1, 2, 3, 4, 7, 9, 11]


def test_ordered_fan_in_float_keys_spool_and_sort():
    sch = TT.Schema(("x", "tag"), (TT.FLOAT64, TT.INT64))
    a = _SortedSource([0.5, 1.5, 2.5], tag=0, schema=sch)
    b = _SortedSource([1.0, 2.0], tag=1, schema=sch)
    op = OrderedSyncOp((a, b), (SortKey(0),))
    out = run_operator(op)
    assert not op._streaming
    assert list(out["x"]) == [0.5, 1.0, 1.5, 2.0, 2.5]


# -- the one-shot flow server and the stream deadlines ---------------------------


@pytest.fixture
def _tight_io_deadline():
    from cockroach_tpu_torch.utils import settings

    settings.set("flow.dcn.io_timeout_s", 0.3)
    yield 0.3
    settings.reset("flow.dcn.io_timeout_s")


def test_flow_server_streams_a_scan_past_bad_clients(cats,
                                                     _tight_io_deadline):
    """A FlowServer's registered scan streams whole to an inbox on the
    CPU after an empty handshake, an unknown flow name, a torn frame and
    a client that never sends its handshake (shed at the io deadline);
    the dial arms the stream's read deadline; the drained inbox closes
    its socket."""
    import time

    from cockroach_tpu_torch.flow.operators import ScanOp
    from cockroach_tpu_torch.utils import settings

    _jcat, tcat = cats
    orders = tcat.get("orders")
    srv = tdcn.FlowServer({"orders": lambda: ScanOp(orders)}
                          ).serve_background()
    try:
        for junk in (None, b"no-such-flow", b"\xff\xff"):
            s = socket.create_connection(tuple(srv.addr))
            if junk == b"no-such-flow":
                tdcn._send_msg(s, junk)
            elif junk:
                s.sendall(junk)
            s.close()
        silent = socket.create_connection(tuple(srv.addr))
        time.sleep(_tight_io_deadline * 3)
        inbox = tdcn.setup_remote_flow(srv.addr, "orders", orders.schema,
                                       device="cpu")
        assert inbox.sock.gettimeout() == settings.get(
            "flow.dcn.io_timeout_s")
        settings.set("flow.dcn.io_timeout_s", 30.0)
        inbox.sock.settimeout(30.0)
        got = run_operator(inbox)
        want = run_operator(tbuilder.build(TS.TableScan("orders"), tcat))
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        assert inbox.frames >= 1 and inbox.sock.fileno() == -1
        silent.close()
    finally:
        srv.close()


def test_inbox_read_times_out_on_silent_remote(_tight_io_deadline):
    """A server that takes the handshake and goes silent surfaces as a
    timeout on the inbox's read, not a hang."""
    import threading
    import time

    srv = socket.create_server(("127.0.0.1", 0))
    conns = []
    t = threading.Thread(target=lambda: conns.append(srv.accept()[0]),
                         daemon=True)
    t.start()
    inbox = tdcn.setup_remote_flow(srv.getsockname(), "never",
                                   TT.Schema(("k",), (TT.INT64,)),
                                   device="cpu")
    t0 = time.monotonic()
    with pytest.raises(socket.timeout):
        inbox._next()
    assert time.monotonic() - t0 < 5.0
    inbox.close()
    t.join(timeout=5)
    for c in conns:
        c.close()
    srv.close()
