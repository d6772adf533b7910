"""The port's LSM engine and YCSB-E workload against the JAX reference on
the CPU: the same operation sequence through ``cockroach_tpu``'s Engine and
``cockroach_tpu_torch``'s Engine(device="cpu") gives the same reads, either
engine replays the other's WAL, and run_ycsb_e agrees on what it counts."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from cockroach_tpu.bench.ycsb import run_ycsb_e as jax_ycsb
from cockroach_tpu.storage.lsm import Engine as JaxEngine
from cockroach_tpu.storage.lsm import WriteIntentError as JaxIntentError
from cockroach_tpu_torch.bench.ycsb import run_ycsb_e as torch_ycsb
from cockroach_tpu_torch.storage import blockcache
from cockroach_tpu_torch.storage.lsm import Engine as TorchEngine
from cockroach_tpu_torch.storage.lsm import WriteIntentError

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _torch_engine(**kw):
    return TorchEngine(device="cpu", **kw)


@pytest.fixture(autouse=True)
def _cold_port_cache():
    blockcache.node_cache().clear()
    yield
    blockcache.node_cache().clear()


def test_engine_sequence_matches_reference():
    want = chip_smoke.parity_ops(JaxEngine, JaxIntentError)
    got = chip_smoke.parity_ops(_torch_engine, WriteIntentError)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, g[0]
    assert any(r[1] == "WriteIntentError" for r in got)
    assert got[-1][1][0] > 0  # compactions ran


def test_scan_batch_window_growth_matches_reference():
    """A version-dense key truncates every 128-row window with no complete
    row, so scan_batch grows its window (x4) and learns it; both engines
    grow alike and return the same scans."""
    out = []
    for make in (JaxEngine, _torch_engine):
        eng = make(key_width=16, val_width=16, memtable_size=1 << 20)
        for t in range(1, 301):
            eng.put(b"a", b"a%03d" % t, ts=t)
        for i in range(100):
            eng.put(b"b%03d" % i, b"b%d" % i, ts=5)
        eng.delete(b"b007", ts=6)
        eng.flush()
        got = eng.scan_batch([b"a", b"b000", b"a", b"b090"], ts=200,
                             max_keys=16)
        out.append((got, dict(eng._scan_windows)))
        eng.close()
    assert out[0] == out[1]
    assert out[1][1][16] > 128


# ---------------------------------------------------------------- WAL


def _write_history(eng):
    """Puts, deletes, an overflow value, intents of two txns resolved one
    each way, and a bulk ingest (side file + link record)."""
    rng = np.random.default_rng(3)
    for i in range(120):
        eng.put(b"w%04d" % rng.integers(0, 80), b"v%d" % i, ts=1 + i // 40)
    for i in range(0, 80, 9):
        eng.delete(b"w%04d" % i, ts=5)
    eng.put(b"long", b"L" * 40, ts=6)
    for i in range(10):
        eng.put(b"w%04d" % (3 * i), b"t7-%d" % i, ts=8, txn=7)
        eng.put(b"x%04d" % i, b"t9-%d" % i, ts=8, txn=9)
    eng.resolve_intents(7, commit_ts=10, commit=True)
    eng.resolve_intents(9, commit_ts=10, commit=False)
    keys = np.zeros((50, 16), np.uint8)
    for i in range(50):
        keys[i, :5] = np.frombuffer(b"i%04d" % i, np.uint8)
    vals = np.full((50, 16), ord("z"), np.uint8)
    eng.ingest(keys, vals, ts=11)
    eng.put(b"w0001", b"after", ts=12)


def _reads(eng):
    return [eng.scan(None, None, ts=100),
            eng.scan(b"w0010", b"w0050", ts=4),
            eng.scan(b"i0010", None, ts=100, max_keys=20),
            [eng.get(k, ts=100) for k in (b"long", b"w0003", b"x0001",
                                          b"i0042", b"w0001")]]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_wal_cross_replay(tmp_path, writer):
    wal = str(tmp_path / "store.wal")
    make_w, make_r = ((lambda **kw: JaxEngine(**kw)), _torch_engine)
    if writer == "torch":
        make_w, make_r = make_r, make_w
    eng = make_w(key_width=16, val_width=16, memtable_size=64, wal_path=wal)
    _write_history(eng)
    want = _reads(eng)
    eng.close()
    assert list(tmp_path.glob("store.wal.ingest*.npz"))
    again = make_r(key_width=16, val_width=16, memtable_size=64,
                   wal_path=wal)
    try:
        assert _reads(again) == want
    finally:
        again.close()


@pytest.mark.parametrize("record", ["clear", "batch"])
def test_wal_unported_record_raises(tmp_path, record):
    """The record kinds slice 1 left unported (a span clear, an RPC batch)
    now replay: the port reopens the reference's WAL to its reads, and
    with the batch's replay-cache entry."""
    wal = str(tmp_path / "store.wal")
    eng = JaxEngine(key_width=16, val_width=16, wal_path=wal)
    eng.put(b"a", b"1", ts=1)
    if record == "clear":
        eng.clear_span(b"a", b"b")
    else:
        eng.apply_rpc_batch("client", 1, [(b"b", b"2", 2, 0, False)],
                            resp={"ok": True})
    want = eng.scan(None, None, ts=10)
    eng.close()
    again = _torch_engine(key_width=16, val_width=16, wal_path=wal)
    try:
        assert again.scan(None, None, ts=10) == want
        assert again.replay_cache_get("client", 1) == (
            {"ok": True} if record == "batch" else None)
    finally:
        again.close()


# --------------------------------------------------------------- YCSB


@pytest.mark.parametrize("chunk", [1 << 17, 1024])
def test_ycsb_matches_reference(chunk):
    kw = dict(n_keys=4096, ops=64, seed=0, ingest_chunk=chunk)
    want = jax_ycsb(**kw)
    got = torch_ycsb(device="cpu", **kw)
    for k in ("n_keys", "bit_identical", "compactions", "runs",
              "point_ops", "bloom_skips", "ops", "rows_scanned"):
        assert got[k] == want[k], k
    assert got["bit_identical"]


# ---------------------------------------------------- device and imports


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchEngine()
    with pytest.raises(RuntimeError, match="cuda"):
        torch_ycsb(n_keys=16, ops=1)
    TorchEngine(device="cpu").close()


def test_chip_smoke_refuses_without_the_card_or_the_package(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       env=dict(env, CUDA_VISIBLE_DEVICES=""), cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and not r.stdout
    assert "is_available() is False" in r.stderr
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    r = subprocess.run([sys.executable, str(alone)], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and not r.stdout
    assert "No module named 'cockroach_tpu_torch'" in r.stderr


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "cockroach_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"cockroach_tpu_torch/flow/dispatch.py",
            "cockroach_tpu_torch/flow/fuse.py",
            "cockroach_tpu_torch/storage/rowcodec.py",
            "cockroach_tpu_torch/storage/disk.py",
            "cockroach_tpu_torch/kv/hlc.py",
            "cockroach_tpu_torch/kv/txn.py",
            "cockroach_tpu_torch/kv/table.py",
            "cockroach_tpu_torch/kv/index.py",
            "cockroach_tpu_torch/kv/jobs.py",
            "cockroach_tpu_torch/kv/liveness.py",
            "cockroach_tpu_torch/kv/tenant.py",
            "cockroach_tpu_torch/sql/schemachange.py",
            "cockroach_tpu_torch/utils/external_storage.py",
            "cockroach_tpu_torch/plan/indexopt.py",
            "cockroach_tpu_torch/bench/tpch_kv.py",
            "cockroach_tpu_torch/utils/retry.py",
            "cockroach_tpu_torch/kv/dist.py",
            "cockroach_tpu_torch/kv/loadstats.py",
            "cockroach_tpu_torch/kv/queues.py",
            "cockroach_tpu_torch/kv/allocator.py",
            "cockroach_tpu_torch/kv/rpc.py",
            "cockroach_tpu_torch/kv/dialer.py",
            "cockroach_tpu_torch/kv/coalesce.py",
            "cockroach_tpu_torch/kv/replication.py",
            "cockroach_tpu_torch/kv/tsdb.py",
            "cockroach_tpu_torch/kv/upgrade.py",
            "cockroach_tpu_torch/flow/gossip.py",
            "cockroach_tpu_torch/bench/load.py",
            "cockroach_tpu_torch/bench/ycsb.py",
            "cockroach_tpu_torch/server/node.py",
            "cockroach_tpu_torch/server/http.py",
            "cockroach_tpu_torch/server/debugzip.py",
            "cockroach_tpu_torch/cli.py",
            "cockroach_tpu_torch/flow/dcn.py",
            "cockroach_tpu_torch/flow/wire.py",
            "cockroach_tpu_torch/flow/disthost.py",
            "cockroach_tpu_torch/coldata/arrow.py",
            "cockroach_tpu_torch/flow/sharedscan.py",
            "cockroach_tpu_torch/lint/core.py",
            "cockroach_tpu_torch/lint/__main__.py",
            "cockroach_tpu_torch/lint/sharedstate.py",
            "cockroach_tpu_torch/lint/hostsync.py"} <= names
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "cockroach_tpu"}
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"
        # the card machine has no pyarrow: only the Arrow converters
        # import it, inside their functions
        rel = str(f.relative_to(ROOT))
        if rel != "cockroach_tpu_torch/coldata/arrow.py":
            assert "pyarrow" not in _imported_roots(f), rel
        else:
            top = ast.parse(f.read_text()).body
            assert not any(
                isinstance(n, (ast.Import, ast.ImportFrom))
                and "pyarrow" in ast.dump(n) for n in top), rel


@pytest.mark.chaos
def test_torn_wal_append_recovers(tmp_path):
    """A put whose WAL append tears (fault site storage.wal.append, kind
    partial) raises and leaves half a record; reopening truncates it and
    keeps every earlier write."""
    from cockroach_tpu_torch.utils import faults

    wal = str(tmp_path / "store.wal")
    eng = _torch_engine(key_width=16, wal_path=wal)
    eng.put(b"a", b"1", ts=1)
    faults.arm(0, {"storage.wal.append": faults.FaultSpec(kind="partial")})
    try:
        with pytest.raises(faults.InjectedFault):
            eng.put(b"b", b"2", ts=2)
    finally:
        faults.disarm()
    eng.close()
    again = _torch_engine(key_width=16, wal_path=wal)
    try:
        assert again.scan(None, None, ts=10) == [(b"a", b"1")]
        again.put(b"c", b"3", ts=3)
        assert again.get(b"c", ts=10) == b"3"
    finally:
        again.close()
