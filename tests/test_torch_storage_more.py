"""The port's engine methods beyond slice 1 against the JAX reference on
the CPU: checkpoints (either package's opens in the other with the same
live rows), WAL record kinds 3-5 (import, clear, RPC batch) written byte
for byte as the reference writes them and replayed, export/import with
the overflow heap, span clears, the replay cache, the stats and
refresh-check lookups, and storage/disk.py."""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from cockroach_tpu.storage import disk as jdisk
from cockroach_tpu.storage.lsm import Engine as jEngine
from cockroach_tpu_torch.storage import disk as tdisk
from cockroach_tpu_torch.storage.lsm import Engine as tEngine
from cockroach_tpu_torch.utils import metric as tmetric

J = SimpleNamespace(name="jax", Engine=jEngine,
                    open=lambda p, **kw: jEngine.open_checkpoint(p, **kw))
T = SimpleNamespace(
    name="torch", Engine=lambda **kw: tEngine(device="cpu", **kw),
    open=lambda p, **kw: tEngine.open_checkpoint(p, device="cpu", **kw))
PKGS = (J, T)


def history(eng) -> list:
    """A write history touching every WAL record kind, and what it reads
    back: puts, an intent and its resolution, a batch, an import, a span
    clear, stats and the refresh-check lookups."""
    out = []
    for i in range(12):
        eng.put(b"k%02d" % i, b"v%d" % i, ts=i + 1)
    eng.put(b"big", b"B" * 40, ts=3)  # overflow heap
    eng.put(b"k03", b"", ts=20, txn=0)
    eng.delete(b"k04", ts=21)
    eng.put(b"k05", b"prov", ts=22, txn=7)
    out.append((eng.other_intent(b"k05", 0), eng.other_intent(b"k05", 7),
                eng.intent_keys(7), eng.newest_committed_ts(b"k03")))
    eng.resolve_intents(7, 25, commit=True)
    eng.apply_rpc_batch("c1", 4, [(b"m1", b"x", 30, 0, False),
                                  (b"k06", b"", 31, 0, True)],
                        resp={"ok": True})
    out.append((eng.replay_cache_get("c1", 4), eng.replay_cache_get("c1", 3)))
    src = eng.export_span(b"k08", b"k10")
    eng.clear_span(b"k08", b"k10")
    out.append(eng.scan(None, None, ts=100))
    src["key"] = src["key"].copy()
    src["key"][:, 0] = ord("z")  # land the export at z08, z09
    eng.import_rows(src)
    out.append(eng.span_stats(b"k", b"l"))
    out.append(eng.has_committed_writes_in(b"k00", b"k99", 21, 30))
    out.append(eng.has_committed_writes_in(b"k01", None, 5, 100, point=True))
    s = eng.compute_stats()
    out.append((s.live_count, s.key_count, s.val_count, s.intent_count))
    eng.wal_sync()
    out.append(eng.scan(None, None, ts=100))
    out.append(eng.get(b"big", ts=100))
    return out


def test_engine_methods_and_wal_bytes_match_reference(tmp_path):
    """The same history reads the same in both packages and writes the
    same WAL bytes (every record kind, the import side file's name
    included); each package replays the other's log to the same reads and
    replay cache."""
    wals, reads, files = {}, {}, {}
    for P in PKGS:
        d = tmp_path / P.name
        d.mkdir()
        eng = P.Engine(key_width=16, val_width=8, memtable_size=5,
                       wal_path=str(d / "store.wal"))
        reads[P.name] = history(eng)
        eng.close()
        wals[P.name] = (d / "store.wal").read_bytes()
        files[P.name] = sorted(os.listdir(d))
    assert reads["torch"] == reads["jax"]
    assert reads["torch"][1] == ({"ok": True}, None)
    assert (b"z08", b"v8") in reads["torch"][-2]
    assert wals["torch"] == wals["jax"]
    assert files["torch"] == files["jax"] and len(files["torch"]) == 2
    for writer, reader in ((J, T), (T, J)):
        d = tmp_path / writer.name
        again = reader.Engine(key_width=16, val_width=8,
                              wal_path=str(d / "store.wal"))
        try:
            assert [again.scan(None, None, ts=100),
                    again.get(b"big", ts=100)] == reads[writer.name][-2:]
            assert again.replay_cache_get("c1", 4) == {"ok": True}
        finally:
            again.close()


def _fill(eng):
    for i in range(10):
        eng.put(f"k{i}".encode(), str(i).encode(), ts=i + 1)
    eng.put(b"long", b"0123456789abcdef" * 9, ts=2)
    eng.put(b"k3", b"prov", ts=50, txn=9)
    eng.apply_rpc_batch("c9", 2, [(b"m", b"1", 60, 0, False)], resp=[1, 2])


@pytest.mark.parametrize("writer,reader", [(J, T), (T, J), (T, T)])
def test_checkpoint_opens_across_packages(tmp_path, writer, reader):
    """A checkpoint (runs, overflow heap, replay cache, intents) plus the
    WAL written after it opens in the other package with the same live
    rows, lock table and replay cache."""
    wal, ck = str(tmp_path / "wal.log"), str(tmp_path / "ck")
    eng = writer.Engine(key_width=16, val_width=16, memtable_size=3,
                        wal_path=wal)
    _fill(eng)
    eng.checkpoint(ck)
    assert os.path.getsize(wal) == 4  # just the magic: records truncated
    eng.put(b"post", b"wal", ts=70)  # only in the WAL
    want = (eng.scan(None, None, ts=100, txn=9), eng.intent_keys(9),
            eng.compute_stats().live_count)
    eng.close()
    got = reader.open(ck, wal_path=wal)
    try:
        assert (got.scan(None, None, ts=100, txn=9), got.intent_keys(9),
                got.compute_stats().live_count) == want
        assert got.replay_cache_get("c9", 2) == [1, 2]
        assert got.newest_committed_ts(b"k5") == 6
        assert got.get(b"post", ts=100) == b"wal"
    finally:
        got.close()


def test_varwidth_export_import_rehomes_blobs():
    out = []
    for P in PKGS:
        src = P.Engine(val_width=16)
        src.put(b"k1", b"A" * 100, ts=1)
        src.put(b"k2", b"sm", ts=2)
        src.put(b"k3", b"B" * 333, ts=3)
        rows = src.export_span(None, None)
        dst = P.Engine(val_width=16)
        dst.put(b"zzz", b"C" * 77, ts=1)  # offsets cannot line up
        dst.import_rows(rows)
        out.append([dst.get(k, ts=10) for k in (b"k1", b"k2", b"k3",
                                                 b"zzz")])
        out.append({k: np.asarray(v).tobytes() for k, v in rows.items()})
    assert out[2] == out[0] == [b"A" * 100, b"sm", b"B" * 333, b"C" * 77]
    assert out[3] == out[1]


def test_disk_monitor_and_ballast(tmp_path):
    """WAL appends feed the monitor; its p99 and slow flag follow the
    reference's rules; the ballast reserves and releases its bytes."""
    mons = []
    for D in (jdisk, tdisk):
        mon = D.DiskMonitor(str(tmp_path), window=16)
        for ms in (1, 2, 3, 150, 4):
            mon.observe(ms / 1e3)
        mons.append((mon.p99_ms(), mon.is_slow()))
        path = D.create_ballast(str(tmp_path), size_bytes=3 << 20)
        assert os.path.getsize(path) == 3 << 20
        assert D.release_ballast(str(tmp_path))
        assert not D.release_ballast(str(tmp_path))
    assert mons[1] == mons[0] == (150.0, True)
    eng = tEngine(val_width=8, wal_path=str(tmp_path / "w.log"),
                  device="cpu")
    mon = tdisk.DiskMonitor(str(tmp_path))
    eng.disk_monitor = mon
    eng.put(b"a", b"1", ts=1)
    assert len(mon.samples) == 1
    assert mon.probe() >= 0 and tmetric.DISK_PROBES.value >= 1
    eng.close()
