"""Shared tile streams (flow/sharedscan.py) in the port against the
reference.

Each scenario runs through both packages with
``sql.distsql.sharedscan.enabled`` on, on the CPU: concurrent resident
scans of one table ride one stream, and every subscriber's rows equal a
solo scan's and the reference's, bit for bit (a wrong shared mask shows
up as phantom or lost rows). A KV table's persistent decode writes into
buffers the table owns, so a stream never serves tiles of another
snapshot: the KV case decodes at a newer snapshot while a stream is
attached."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cockroach_tpu import catalog as jcatalog
from cockroach_tpu.coldata import types as jT
from cockroach_tpu.flow import sharedscan as jsharedscan
from cockroach_tpu.flow.operators import ScanOp as jScanOp
from cockroach_tpu.kv import DB as jDB
from cockroach_tpu.kv import ManualClock as jClock
from cockroach_tpu.kv import table as jtable
from cockroach_tpu.storage.lsm import Engine as jEngine
from cockroach_tpu.utils import faults as jfaults
from cockroach_tpu.utils import metric as jmetric
from cockroach_tpu.utils import settings as jsettings
from cockroach_tpu_torch import catalog as tcatalog
from cockroach_tpu_torch.coldata import types as tT
from cockroach_tpu_torch.flow import sharedscan as tsharedscan
from cockroach_tpu_torch.flow.operators import ScanOp as tScanOp
from cockroach_tpu_torch.kv import DB as tDB
from cockroach_tpu_torch.kv import ManualClock as tClock
from cockroach_tpu_torch.kv import table as ttable
from cockroach_tpu_torch.storage.lsm import Engine as tEngine
from cockroach_tpu_torch.utils import faults as tfaults
from cockroach_tpu_torch.utils import metric as tmetric
from cockroach_tpu_torch.utils import settings as tsettings

J = SimpleNamespace(
    name="jax", T=jT, Catalog=jcatalog.Catalog, Table=jcatalog.Table,
    ScanOp=jScanOp, sharedscan=jsharedscan, metric=jmetric,
    settings=jsettings, faults=jfaults, DB=jDB, Clock=jClock,
    Engine=jEngine, table=jtable)
T = SimpleNamespace(
    name="torch", T=tT, Catalog=lambda: tcatalog.Catalog("cpu"),
    Table=tcatalog.Table, ScanOp=tScanOp, sharedscan=tsharedscan,
    metric=tmetric, settings=tsettings, faults=tfaults, DB=tDB,
    Clock=tClock, Engine=lambda **kw: tEngine(device="cpu", **kw),
    table=ttable)
PKGS = (J, T)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _gate():
    """Shared streams on for the test body in both packages; registries
    always drained."""
    for P in PKGS:
        P.settings.set("sql.distsql.sharedscan.enabled", True)
    yield
    for P in PKGS:
        P.settings.reset("sql.distsql.sharedscan.enabled")
        P.settings.reset("sql.distsql.sharedscan.window")
        P.faults.disarm()
        P.sharedscan.reset()


def _cat(P, n=512, seed=3):
    rng = np.random.default_rng(seed)
    cat = P.Catalog()
    cat.add(P.Table(
        name="fact",
        schema=P.T.Schema(("f_key", "f_val"), (P.T.INT64, P.T.FLOAT64)),
        columns={
            "f_key": np.arange(n, dtype=np.int64),
            "f_val": rng.uniform(0.0, 10.0, n),
        },
    ))
    return cat


def _rows(tiles) -> list[tuple]:
    """Live rows of a tile sequence (mask applied)."""
    out = []
    for t in tiles:
        mask = np.asarray(t.mask)
        cols = [np.asarray(c.data) for c in t.cols]
        for i in np.nonzero(mask)[0]:
            out.append(tuple(c[i].item() for c in cols))
    return out


def _drain(op) -> list:
    tiles = []
    while True:
        t = op._next()
        if t is None:
            return tiles
        tiles.append(t)


def _solo(P, table, tile):
    P.settings.set("sql.distsql.sharedscan.enabled", False)
    solo = P.ScanOp(table, tile=tile)
    solo.init()
    want = _rows(_drain(solo))
    solo.close()
    P.settings.set("sql.distsql.sharedscan.enabled", True)
    return want


def _two_scans(P):
    table = _cat(P).get("fact")
    tile = 128
    want = _solo(P, table, tile)
    a = P.ScanOp(table, tile=tile)
    b = P.ScanOp(table, tile=tile)
    attached0 = P.metric.SQL_SHARED_SCAN_ATTACHED.value
    saved0 = P.metric.SQL_SHARED_SCAN_DISPATCHES_SAVED.value
    a.init()
    b.init()
    assert a._shared is not None and a._shared is b._shared
    # the second attach to a live stream counts
    assert P.metric.SQL_SHARED_SCAN_ATTACHED.value == attached0 + 1
    # interleave: a produces each tile, b consumes it for free
    rows_a, rows_b = [], []
    while True:
        ta = a._next()
        tb = b._next()
        assert (ta is None) == (tb is None)
        if ta is None:
            break
        rows_a.extend(_rows([ta]))
        rows_b.extend(_rows([tb]))
    assert rows_a == want
    assert rows_b == want
    saved = P.metric.SQL_SHARED_SCAN_DISPATCHES_SAVED.value - saved0
    a.close()
    b.close()
    # stream died with its last subscriber
    assert not P.sharedscan._streams
    return want, saved


def test_two_scans_share_one_stream_bit_identical():
    (jwant, jsaved), (twant, tsaved) = (_two_scans(P) for P in PKGS)
    assert twant == jwant
    assert tsaved == jsaved > 0


def _mid_stream(P):
    """b attaches after a consumed half the table and a detaches before
    the end — both still see every row exactly once."""
    table = _cat(P).get("fact")
    tile = 64
    want = _solo(P, table, tile)
    a = P.ScanOp(table, tile=tile)
    a.init()
    n_tiles = a._batch.capacity // tile
    tiles_a = [a._next() for _ in range(n_tiles // 2)]
    b = P.ScanOp(table, tile=tile)
    b.init()  # mid-stream attach: same stream, own cursor from tile 0
    assert b._shared is a._shared
    tiles_a.extend(_drain(a))
    a.close()
    assert P.sharedscan._streams  # b still holds the stream open
    tiles_b = _drain(b)
    b.close()
    assert not P.sharedscan._streams
    assert _rows(tiles_a) == want
    # b started from tile 0 after the window may have trimmed early
    # tiles: those slice solo (catch-up) and must still be identical
    assert _rows(tiles_b) == want
    return want


def test_attach_mid_stream_and_detach_mid_stream():
    assert _mid_stream(T) == _mid_stream(J)


def _lagging(P):
    table = _cat(P, n=512).get("fact")
    tile = 64
    P.settings.set("sql.distsql.sharedscan.window", 1)
    want = _solo(P, table, tile)
    a = P.ScanOp(table, tile=tile)
    b = P.ScanOp(table, tile=tile)
    a.init()
    b.init()
    tiles_a = _drain(a)  # sprints ahead; the window keeps the last tile
    tiles_b = _drain(b)  # every earlier tile is gone: solo catch-up
    a.close()
    b.close()
    assert _rows(tiles_a) == want
    assert _rows(tiles_b) == want
    return want


def test_lagging_subscriber_catches_up_solo():
    """A subscriber further behind than the window slices its own tiles
    and still sees every row (the stream never waits for laggards)."""
    assert _lagging(T) == _lagging(J)


@pytest.mark.parametrize("P", PKGS, ids=lambda P: P.name)
def test_sharding_and_gate_off_run_solo(P):
    table = _cat(P).get("fact")
    sharded = P.ScanOp(table, tile=128, shard=(0, 2))
    sharded.init()
    assert sharded._shared is None  # sharded scans never share
    sharded.close()
    P.settings.set("sql.distsql.sharedscan.enabled", False)
    plain = P.ScanOp(table, tile=128)
    plain.init()
    assert plain._shared is None
    plain.close()


def _attach_fault(P):
    table = _cat(P, n=600, seed=7).get("fact")
    want = _solo(P, table, 128)
    spec = P.faults.FaultSpec(kind="error", p=1.0, max_fires=1)
    P.faults.arm(31, {"flow.sharedscan.attach": spec})
    a = P.ScanOp(table, tile=128)
    a.init()
    assert a._shared is None  # fault: degraded to solo slicing
    b = P.ScanOp(table, tile=128)
    b.init()
    assert b._shared is not None  # max_fires spent: normal attach
    got_a, got_b = _rows(_drain(a)), _rows(_drain(b))
    a.close()
    b.close()
    assert got_a == want
    assert got_b == want
    assert not P.sharedscan._streams
    assert spec.fires == 1
    return want


@pytest.mark.chaos
def test_sharedscan_attach_fault_runs_solo_identical():
    """An injected fault at "flow.sharedscan.attach" degrades that scan
    to slicing its own tiles — identical rows, no stream joined; with
    max_fires=1 the second scan attaches normally."""
    assert _attach_fault(T) == _attach_fault(J)


# -- KV tables: snapshot tokens, never identity -------------------------------


def _kv(P, n=300):
    T_ = P.T
    schema = T_.Schema(("id", "v"), (T_.INT64, T_.INT64))
    db = P.DB(P.Engine(key_width=24, val_width=32, memtable_size=64),
              P.Clock())
    cat = P.Catalog()
    t = P.table.create_kv_table(cat, db, "kvt", schema, pk="id")

    def ins(txn):
        for i in range(n):
            t.insert(txn, {"id": i, "v": i * 7})

    db.txn(ins)
    return db, t


def _kv_tile(P, t) -> int:
    probe = P.ScanOp(t)
    probe.init()
    cap = probe._batch.capacity
    probe.close()
    assert cap % 4 == 0
    return cap // 4


def _kv_scenario(P):
    db, t = _kv(P)
    tile = _kv_tile(P, t)
    want = _solo(P, t, tile)
    # two scans at one snapshot: equal tokens, one stream
    a = P.ScanOp(t, tile=tile)
    b = P.ScanOp(t, tile=tile)
    a.init()
    b.init()
    assert a._snap is not None and a._snap == b._snap
    assert b._shared is a._shared is not None
    got_a, got_b = _rows(_drain(a)), _rows(_drain(b))
    a.close()
    b.close()
    assert got_a == want and got_b == want

    # a stream attached at one snapshot; a write, then a scan decodes at
    # the newer one: it never joins the old stream
    a = P.ScanOp(t, tile=tile)
    a.init()
    first = a._next()
    old = _rows([first])
    db.txn(lambda txn: t.insert(txn, {"id": 10_000, "v": -1}))
    b = P.ScanOp(t, tile=tile)
    b.init()
    assert b._snap is not None and b._snap != a._snap
    assert b._shared is not a._shared
    new_rows = _rows(_drain(b))
    b.close()
    a.close()
    assert not P.sharedscan._streams
    assert old == want[:len(old)]
    return want, new_rows, a, b


def test_kv_scans_share_by_snapshot_token():
    """Both packages: equal tokens share one stream; a decode at a newer
    snapshot runs on a stream of its own (or solo), with the new row."""
    jwant, jnew, _, _ = _kv_scenario(J)
    twant, tnew, _, _ = _kv_scenario(T)
    assert twant == jwant
    assert tnew == jnew
    assert (10_000, -1) in tnew


def test_kv_stream_never_serves_another_snapshot():
    """The port's KV decode rewrites the table's buffers in place, so the
    is-identity the host path trusts would share tiles across
    snapshots. A stream whose buffers a decode at another snapshot
    rewrote hands out no tile after it: its subscribers slice their own,
    and the decoding scan's attach retires it."""
    P = T
    db, t = _kv(P)
    tile = _kv_tile(P, t)
    a = P.ScanOp(t, tile=tile)
    a.init()
    s = a._shared
    assert s is not None and s.snap == a._snap
    # the same buffers, as the host path's identity test would see them
    assert all(x.data is y.data for x, y in zip(
        a._batch.cols, t.device_batch(a.output_schema.names,
                                      persistent=True).cols))
    # that decode was at the same snapshot: the stream still serves
    assert s.next_tile(a, 0)[0] == "tile"
    db.txn(lambda txn: t.insert(txn, {"id": 10_000, "v": -1}))
    b = P.ScanOp(t, tile=tile)
    b.init()  # decodes at the newer snapshot into the same buffers
    assert b._shared is not None and b._shared is not s
    assert s.stale and tsharedscan._streams[s.key] is b._shared
    # the old stream serves nothing after the rewrite, not even the tile
    # it had buffered
    assert s.next_tile(a, 0) == ("solo", None)
    assert s.next_tile(a, 1) == ("solo", None)
    assert not s._tiles
    a.close()
    b.close()
    assert not tsharedscan._streams
