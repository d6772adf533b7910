"""YCSB workload over the MVCC engine — BASELINE config #5 (scan-heavy E);
counterpart of ``cockroach_tpu.bench.ycsb`` with ``device=``.

Reference: pkg/workload/ycsb (workload E: 95% short range scans with
zipfian-ish starts, 5% inserts). The microbench drives the engine's real
read path — merged-view + mvcc_scan_filter on device — interleaved with
writes, so it prices the read-after-write merge cost the LSM design pays.

Load uses the bulk-ingest path (AddSSTable analog): the RunBuilder
(storage/ingest.py) accumulates chunks into device-built sorted/deduped
runs that link into the LSM with one WAL record per run; the operation
phase then measures scans against the multi-run LSM it produced. A
per-key put-path control over a sample of the keyspace prices the
ingest-vs-write asymmetry (``ingest_speedup``) and proves the two paths
produce bit-identical MVCC scans (``bit_identical``); a point-get phase
prices the bloom + block-cache read stack.

With ``stores`` > 1 the same workload runs over a DistSender cluster
(kv/dist.py): the keyspace split into ``stores`` equal ranges, each on a
store of its own, the load through ``DistSender.ingest`` (one
``searchsorted`` routes each chunk), the scans through
``DistSender.scan_batch`` (one ``Engine.scan_batch`` pass per store; a
scan that crosses its range's end is continued on the next range). The
reference has no such argument; its own tests run the same operations
over a DistSender (tests/test_dist_kv.py, tests/test_ranger.py).

Every scan is held to a host model of what was loaded and inserted,
after the timed window; over a cluster one scan across each range
boundary is held to it too.
"""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np

from ..device import resolve_device
from ..kv.dist import DistSender, make_cluster, spread
from ..storage import ingest as bulk
from ..storage.lsm import Engine


def _key(i: int) -> bytes:
    return b"user%012d" % i


def _keys_batch(idx: np.ndarray) -> np.ndarray:
    """Vectorized b'user%012d' encoding -> [N, 16] uint8."""
    n = len(idx)
    out = np.zeros((n, 16), dtype=np.uint8)
    out[:, :4] = np.frombuffer(b"user", dtype=np.uint8)
    digits = idx.astype(np.int64).copy()
    for p in range(12):
        out[:, 15 - p] = (digits % 10) + ord("0")
        digits //= 10
    return out


def _vals_for(keys: np.ndarray) -> np.ndarray:
    vals = np.zeros((len(keys), 16), dtype=np.uint8)
    vals[:, 0] = ord("v")
    vals[:, 1:9] = keys[:, 7:15]  # value derived from key digits
    return vals


def _model_scan(start: int, n: int, n_keys: int,
                inserted: list) -> list[tuple[bytes, bytes]]:
    """What an ``n``-row scan from loaded key ``start`` must return: the
    loaded keys from there, then the inserts, which all sort past the
    loaded keyspace in the order they were made."""
    kb = _keys_batch(np.arange(start, min(start + n, n_keys)))
    out = [(bytes(k), bytes(v)) for k, v in zip(kb, _vals_for(kb))]
    return out + inserted[:n - len(out)]


def _engines(eng) -> list[Engine]:
    if isinstance(eng, DistSender):
        return [s.engine for s in eng.stores.values()]
    return [eng]


def run_ycsb_e(
    n_keys: int = 4096,
    ops: int = 64,
    scan_len: int = 64,
    insert_frac: float = 0.05,
    seed: int = 0,
    ingest_chunk: int = 1 << 17,
    concurrency: int = 64,
    stores: int = 1,
    device: str = "cuda",
) -> dict:
    """Bulk-load n_keys (chunked ingest -> compaction churn), then run
    `ops` operations (scan_len-row scans + insert_frac inserts). Returns
    load + op throughputs; a scan that differs from the host model
    raises.

    Scans go through scan_batch in groups of `concurrency` — the
    vectorized analog of the reference's concurrent YCSB workers (pkg/
    workload/ycsb runs many goroutines against one store; over a remote-
    attached TPU, batching is the only way past the 1/RTT serial floor).

    `stores` > 1 runs the workload over that many stores, one range each
    (the module's docstring); the put-path control stays single-engine
    and is left out there.

    `device` places every engine ("cuda" by default; raises without
    a card unless "cpu")."""
    import sys

    resolve_device(device)
    rng = np.random.default_rng(seed)
    tmp = tempfile.mkdtemp(prefix="ycsb_wal_")
    if stores > 1:
        eng = make_cluster(stores, device=device, wal_dir=tmp,
                           key_width=16, val_width=16, memtable_size=4096)
        moved = spread(eng, [_key(j * n_keys // stores)
                             for j in range(1, stores)])
    else:
        eng = Engine(key_width=16, val_width=16, memtable_size=4096,
                     wal_path=f"{tmp}/ingest.wal", device=device)
    engines = _engines(eng)

    t_load = time.time()
    ts = 1
    # the run builder links runs into one engine; a cluster routes each
    # chunk through DistSender.ingest
    rb = (bulk.RunBuilder(eng, ts=ts) if bulk.enabled() and stores == 1
          else None)
    for lo in range(0, n_keys, ingest_chunk):
        hi = min(lo + ingest_chunk, n_keys)
        keys = _keys_batch(np.arange(lo, hi))
        vals = _vals_for(keys)
        if rb is not None:
            rb.add(keys, vals)
        else:
            eng.ingest(keys, vals, ts=ts)
        print(f"# ycsb load {hi}/{n_keys} ({time.time()-t_load:.0f}s, "
              f"{sum(e.stats.compactions for e in engines)} compactions)",
              file=sys.stderr, flush=True)
    if rb is not None:
        rb.finish()
    ts += 1
    load_s = time.time() - t_load
    compactions_load = sum(e.stats.compactions for e in engines)

    put_rate, ident, eng_put = None, None, None
    if stores == 1:
        # put-path control: the same rows, one WAL'd put at a time, over
        # a sample of the keyspace — the per-key write cost bulk ingest
        # exists to skip, and the bit-identity oracle for the ingest path
        sample_n = min(n_keys, 16384)
        eng_put = Engine(key_width=16, val_width=16, memtable_size=4096,
                         wal_path=f"{tmp}/put.wal", device=device)
        skeys = _keys_batch(np.arange(sample_n))
        svals = _vals_for(skeys)
        t_put = time.time()
        for i in range(sample_n):
            eng_put.put(bytes(skeys[i]), bytes(svals[i]), ts=1)
        put_s = time.time() - t_put
        put_rate = sample_n / put_s if put_s > 0 else 0.0
        ident = (eng.scan(_key(0), _key(sample_n), ts=ts, max_keys=sample_n)
                 == eng_put.scan(_key(0), _key(sample_n), ts=ts,
                                 max_keys=sample_n))
        print(f"# ycsb put control {put_rate:.0f} keys/s, "
              f"bit_identical={ident}", file=sys.stderr, flush=True)
    # warm BOTH source-set shapes the op phase will see before timing:
    # runs-only (post-flush) and runs+memtable (after the first insert —
    # the memtable source changes the scan kernel's source tuple)
    t_warm = time.time()
    eng.scan_batch([_key(0)] * concurrency, ts=ts, max_keys=scan_len)
    eng.put(_key(n_keys), b"warm", ts=ts)
    inserted = [(_key(n_keys), b"warm")]
    ts += 1
    next_pk = n_keys + 1
    eng.scan_batch([_key(0)] * concurrency, ts=ts, max_keys=scan_len)
    warm_s = time.time() - t_warm
    print(f"# ycsb scan warmup {warm_s:.0f}s", file=sys.stderr, flush=True)

    # point-get phase: the bloom -> block cache -> seek-window read
    # stack (50% present keys, 50% definite misses — the misses are
    # where blooms earn their bits)
    from ..storage import blockcache
    from ..utils import metric

    n_point = min(1024, 4 * ops)
    pt_keys = [_key(int(rng.integers(0, n_keys))) if i % 2 == 0
               else b"ghost%011d" % i for i in range(n_point)]
    eng.get(pt_keys[0], ts=ts)  # warm the point-path kernels
    bc0 = blockcache.node_cache().stats()
    skips0 = metric.BLOOM_SKIPS.value
    t_pt = time.time()
    for k in pt_keys:
        eng.get(k, ts=ts)
    pt_s = time.time() - t_pt
    bc1 = blockcache.node_cache().stats()
    lookups = (bc1["hits"] - bc0["hits"]) + (bc1["misses"] - bc0["misses"])
    hit_rate = (bc1["hits"] - bc0["hits"]) / lookups if lookups else 0.0
    print(f"# ycsb points {n_point} in {pt_s:.2f}s "
          f"(cache hit rate {hit_rate:.2f})", file=sys.stderr, flush=True)

    rows = 0
    scanned = []  # (start index, inserts before the scan, rows)
    t0 = time.time()
    done = 0
    while done < ops:
        group = min(concurrency, ops - done)
        starts = []
        for _ in range(group):
            if rng.random() < insert_frac:
                v = b"v%08d" % next_pk
                eng.put(_key(next_pk), v, ts=ts)
                inserted.append((_key(next_pk), v))
                next_pk += 1
                ts += 1
            else:
                starts.append(int(rng.integers(0, n_keys)))
        n_scans = len(starts)
        # pad to a FIXED batch shape (multi_scan_sources jit-specializes on B;
        # ragged tails would each compile their own kernel)
        keys = [_key(i) for i in starts] + [_key(0)] * (concurrency
                                                         - n_scans)
        got = eng.scan_batch(keys, ts=ts, max_keys=scan_len)[:n_scans]
        for i, res in zip(starts, got):
            rows += len(res)
            scanned.append((i, len(inserted), res))
        done += group
        print(f"# ycsb ops {done}/{ops} ({time.time()-t0:.1f}s)",
              file=sys.stderr, flush=True)
    el = time.time() - t0
    # untimed: the scans against the model, and over a cluster one scan
    # across each range boundary
    crossing = 0
    if stores > 1:
        bounds = [int(d.start_key[4:]) for d in eng.meta.snapshot()[1:]]
        starts = [max(0, b - scan_len // 2) for b in bounds]
        got = eng.scan_batch([_key(i) for i in starts], ts=ts,
                             max_keys=scan_len)
        scanned += [(i, len(inserted), res) for i, res in zip(starts, got)]
    for i, upto, res in scanned:
        want = _model_scan(i, scan_len, n_keys, inserted[:upto])
        if res != want:
            raise AssertionError(
                f"ycsb scan from {_key(i)!r}: returned {res[:2]}..., "
                f"the model {want[:2]}...")
        if stores > 1 and res and eng.meta.lookup(res[0][0]).range_id \
                != eng.meta.lookup(res[-1][0]).range_id:
            crossing += 1
    compactions = sum(e.stats.compactions for e in engines)
    runs = sum(e.stats.runs for e in engines)
    out = {}
    if stores > 1:
        out = {"stores": stores,
               "ranges": [(d.range_id, d.store_id,
                           eng.stores[d.store_id].engine.span_stats(
                               d.start_key, d.end_key)["versions"])
                          for d in eng.meta.snapshot()],
               "moved_rows_at_spread": moved,
               "compactions_in_load": compactions_load,
               "scans_crossing_a_range": crossing}
    for e in engines:
        e.close()
    if eng_put is not None:
        eng_put.close()
    shutil.rmtree(tmp, ignore_errors=True)
    load_rate = n_keys / load_s if load_s > 0 else 0.0
    return {
        "n_keys": n_keys,
        "load_s": round(load_s, 3),
        "load_keys_per_sec": round(load_rate),
        "put_keys_per_sec": None if put_rate is None else round(put_rate),
        "ingest_speedup": (None if put_rate is None
                           else round(load_rate / put_rate, 2) if put_rate
                           else 0.0),
        "bit_identical": None if ident is None else bool(ident),
        "compactions": compactions,
        "runs": runs,
        "warm_s": warm_s,
        "point_ops": n_point,
        "point_ops_per_sec": round(n_point / pt_s) if pt_s > 0 else 0,
        "blockcache_hit_rate": round(hit_rate, 3),
        "bloom_skips": int(metric.BLOOM_SKIPS.value - skips0),
        "ops": ops,
        "ops_per_sec": ops / el,
        "rows_scanned": rows,
        "rows_per_sec": rows / el if el > 0 else 0.0,
        "elapsed_s": el,
        "scans_checked": len(scanned),
        **out,
    }
