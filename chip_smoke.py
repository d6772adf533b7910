#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cockroach_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--phases kernels,tpch,...] [--verbose]
        [--detail PATH]

``--phases`` picks phases from PHASES (default all, in that order); the
kernel builds, both kernels against their plain versions, the kernel
table and the last line always run, and a phase makes what an unselected
earlier one would have handed it (the SF1 catalog, the SF1 distributed
runs). Each phase prints one summary line; ``--verbose``, or one
selected phase, prints its full line, and ``--detail`` writes every full
line to a file. The ``{"phases": ...}`` line gives each phase's seconds.
The default run is held to TIME_BUDGET_S seconds and to OUTPUT_BUDGET
bytes before the kernel table; it prints both figures.

Builds both CUDA kernels from ``cockroach_tpu_torch/csrc`` at first use,
holds each kernel against its plain PyTorch version on the card (exact
equality: every output is an integer or a bool), drives YCSB-E at
bench.py's configuration (2^20 keys, 512 ops, 64-row scans, 128-way
batches) through the port's engine on the card, checks the engine on the
card against the same engine on the CPU, and times both kernels.

Before YCSB it runs the SQL executor: TPC-H q1 and q3 at SF0.01 on the
card against the CPU; all 22 queries at SF0.05 with 2^16-row tiles on
the card against the CPU, through both ``rel.plan`` and
``rel.optimized_plan()``; then at SF1 (bench.py's seed) on the card
bench.py's ladder (q1, q3, q9, q18), every run held to the numpy oracle
(``bench/tpch_oracle.py``), timed by ``bench/tpch_run.run_tpch`` and
profiled once; it prints the ``{"tpch": ...}`` line. Then the other 18
queries at SF1 on the card, each cold and warm (the warm result equal to
the cold one), on the ``{"tpch22": ...}`` line. Then TPC-H at SF10
(BASELINE config #2's own scale, where lineitem and orders stream and
q18's and q21's aggregations spill to the host-staged Grace
aggregation): all 22 queries at sf=0.01 under the SF10 scaling (every
size threshold over 1000) on the card against the CPU, with the same
streamed scans and spills; SF10 generated; q3, q9 and q18 timed and held
to the numpy oracle in every run and profiled once; q7 and q21 cold and
warm; a forced Grace hash join (q3) and external sort (q7), each equal
to its default run; the ``{"tpch_sf10": ...}`` line. Neither storage
kernel runs on those paths (``tpch_launches`` and ``sf10_launches`` in
the kernel table count their launches).

SQL over the MVCC store (``kv/``, ``storage/rowcodec.py``), right after
the SF1 phase: all 22 queries over KV tables at sf=0.01 on the card equal
the CPU and the host tables on the card; the SF1 catalog bulk-loaded into
one ``key_width=16`` engine on the card (``bench/tpch_kv.py``), bench.py's
ladder over KV held to the oracle in every run and profiled once, RF1 and
RF2 in transactions, the ladder again held to the oracle of the refreshed
data (fused, with CUDA graphs), then orders in a second engine with an
index on o_custkey: 100 lookups through ``IndexScanOp``, each equal to the
full scan, and a checkpoint plus WAL reopened on the card with the same
live rows; the ``{"tpch_kv": ...}`` line (``kv_launches`` in the kernel
table counts the storage kernels' launches in the load, the ladders and
the refresh functions). Between the ladders, q1 as four standing views
(60, 90, 120 and 150 days before 1998-12-01; ``bench/views.KVViews``) on
the loaded engine, each equal to a fresh q1 over KV at creation and after
the flush that follows RF1 and RF2 (on orders instead when priming
lineitem's shadow passes KV_VIEW_PRIME_LIMIT_S): the prime's seconds and
peak RSS, create ms, events, ms, dispatches and device-to-host bytes per
poll of each flush; the flushes' K2 merges are witnessed with the rest.

The SQL front door (``sql/parser.py``, ``binder.py``, ``plancache.py``,
``session.py``, ``server/pgwire.py``, ``bench/load.py``), after the KV
phase over the SF1 catalog: a ``PgServer`` on the card; one connection
sends the 22 TPC-H texts (``bench/tpch_sql.py``; q5 under the cost-based
join order), each cold, again with a plan-cache hit and verbatim from the
memo, every result equal to the hand-built plan on the card and q1, q3,
q9, q18 to the oracle, beside parse + bind ms, captures per run and the
hand-built median; the 22 plans stay cached within the plan cache's
byte budget (``plancache.MAX_DEVICE_FRACTION`` of the card); q6
rebound with three literal sets captures no graph and equals the
cache-off results; 4 connections at once run q1, q3, q18 and q6 (three
literal sets) twice, each equal to one connection; ``run_mixed_load`` with 8 sessions for 3 s at SF1 reads
back every acknowledged insert; the ``{"sql": ...}`` line
(``sql_launches`` in the kernel table).

The warm menu (``sql/warmmenu.py``), statement diagnostics
(``sql/diagnostics.py``) and the rest of crdb_internal, after the SQL
phase: a ``PgServer`` over a fresh copy of the SF1 host catalog warms its
menu (the 22 TPC-H texts, q5 under the cost-based join order in a
second build, and the ladder course) before it accepts a connection;
each item's status, runs and captures and the plan cache's bytes within
its budget, nothing evicted and no entry at 0 bytes; three serving runs
of each text over the wire, none of a compiled item capturing a graph,
each equal to the hand-built plan (q1, q3, q9, q18 to the oracle);
EXPLAIN ANALYZE (DEBUG) of q3 naming its bundle; the four new
crdb_internal tables; ``bench/warmup.run_warmup_ab`` at sf=0.05 (menu
off and on, each in a process of its own: equal checksums, no serving
compile with the menu); the ``{"menu": ...}`` line. TPC-C
(``bench/tpcc.py``) after it: the load at the spec's cardinalities
(TPCC_W warehouses), ``run_mix(txns=TPCC_TXNS)``, ``check_consistency``,
tpmC, new-order p50/p99, retries, give-ups and the device lock's p99
wait; a small run on the card and on the CPU with equal final tables;
the ``{"tpcc": ...}`` line (``menu_launches`` and ``tpcc_launches`` in
the kernel table). Materialized views (``bench/views.run_views``, the
``views`` phase): 1000 views in one shape class over a 240-row KV table,
8 rounds of 64 writes, one flush a round, each of at most one dispatch
(one CUDA graph replay) and no base rescan, sampled views equal to fresh
rescans; the ``{"views": ...}`` line. The changefeed fan-out
(``bench/fanout.run_fanout``, the ``fanout`` phase): 1000 subscribers on
one hub polling the engine on the card, streams equal to the history
after reconnects, the staging account drained; the ``{"fanout": ...}``
line (``views_launches``, ``fanout_launches``).

The SPMD plane (``plan/distribute.py``, ``parallel/``,
``Rel.run_distributed``): right after the SF1 phase, q3, q9 and q18 at
SF1 through ``bench/tpch_dist.run_dist`` on meshes of 3 and 8 shards on
the card (every run held to the oracle; cold, warm, median, idle share,
dispatches, attempts, capacity factor, rows through all_to_all, upload
seconds, peak memory, beside the one-device median); after the SF10
phase, all 22 queries at sf=0.01 (seed 11) over 1, 3 and 8 shards equal
to the one-device card run, the 8-shard runs equal to the CPU's with the
same capacity factor, explain_distributed equal to the CPU's text, the
skewed-window retry at the CPU's factor; then BASELINE config #3's three
nodes as 3 shards: each of q3, q9, q18 at SF10 over its host tables, or
at the largest scale whose predicted footprint (its SF1 peak of reserved
memory, grown as the capacities do: doubled per exchange and rounded to
powers of two) fits the card, on the ``{"distsql": ...}`` line (``distsql_launches`` in the kernel table: neither storage kernel
is on that path).

Fusion (``flow/fuse.py``, ``flow/dispatch.py``): all 22 queries at SF0.05
and under the SF10 scaling fused equal to unfused bit for bit, CUDA
graphs captured in the first fused run and none in a repeat run; at SF1
and SF10, q3, q9 and q18 fused and unfused in turn (medians, idle share,
host syncs, dispatches and host launch calls per tile, captures, peak
memory) on the ``{"fusion": ...}`` line, after the SF10 phase.

TPC-DS (``bench/tpcds.py``, BASELINE config #4's workload) after it:
the nine queries at sf=0.01 on the card equal the CPU and the unfused
card (exactly, FLOAT averages within rtol=1e-12), at the default tile
and with 1024-row tiles, as do
window queries of every function family and frame kind (ROWS, RANGE,
GROUPS, EXCLUDE, a STRING partition, DESC order, NULL keys) and the
merge join, right, full and cross joins, UNION ALL and string_agg
(windows row for row, joins as multisets of rows); the host's RAM (``/proc/meminfo``) and
peak RSS printed; SF10 generated (seed 19980401); the nine and
``tpcds.sales_window`` (a window over all 28.8 M store_sales rows)
timed by ``bench/tpcds_run.run_tpcds``, every run equal to the numpy
oracle, and profiled once; the ``{"tpcds": ...}`` line, which also
carries the SF1 phase's lineitem x orders merge join against the hash
join (equal results, both timed). Result
lines are compact JSON with floats to 4 significant digits, and the
script prints its byte count before the kernel table: all of it has to
fit in the 24 KB a remote run returns.

The line before the last is ``{"kernels": [...]}``, the line before that
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Any failed phase raises, so the script
exits non-zero; without CUDA it exits non-zero before any result.
"""

from __future__ import annotations

import bisect
import faulthandler
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from cockroach_tpu_torch import _build
from cockroach_tpu_torch.storage import cuda_merge, cuda_scan, mvcc
from cockroach_tpu_torch.storage.keys import flip, key_words

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
# timed repeats after the cold and warm runs in the SF1, SF10, fusion,
# KV and TPC-DS phases: cut from 5 to keep the default run within
# TIME_BUDGET_S beside the menu and TPC-C phases (PERF.md lists the cuts)
DEPTH_RUNS = 1
K1_BYTES_PER_ROW = 16 + 8 + 8 + 1 + 1 + 2  # key, ts, txn, tomb, mask; 2 out
K2_BYTES_PER_ROW = 16 + 8 + 8 + 1  # key, ts, seq, mask in
K2_PERM_BYTES = 4


_written = 0  # bytes of standard output so far
OUTPUT_BUDGET = 20_000  # bytes before the kernel table, default run
TIME_BUDGET_S = 1000.0  # seconds of the default run

# set by main: print each phase's full result line (else its summary),
# and a file that takes every full result line
VERBOSE = False
_detail = None


def write_line(line: str) -> None:
    """One line of standard output, counted: everything the script prints
    has to fit in the output a remote run returns."""
    global _written
    print(line, flush=True)
    _written += len(line.encode()) + 1


def log(msg: str) -> None:
    write_line(f"# {msg}")


def _sig4(x):
    """Floats rounded to 4 significant digits, all the way down."""
    if isinstance(x, float):
        return float(f"{x:.4g}")
    if isinstance(x, dict):
        return {k: _sig4(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_sig4(v) for v in x]
    return x


def emit(obj: dict, summary: dict | None = None) -> None:
    """A compact JSON result line, floats to 4 significant digits: `obj`
    under --verbose or when one phase runs, else its `summary`. `obj`
    also goes to the --detail file, when one is named."""
    if _detail is not None:
        _detail.write(json.dumps(_sig4(obj), separators=(",", ":")) + "\n")
        _detail.flush()
    shown = obj if VERBOSE or summary is None else summary
    write_line(json.dumps(_sig4(shown), separators=(",", ":")))


# ---------------------------------------------------------------------------
# inputs


def scan_windows(rng, B: int, window: int, nkeys: int = 30,
                 versions: int = 3) -> dict[str, np.ndarray]:
    """Random MVCC windows in the multi-scan layout: each row holds sorted
    (key asc, ts desc) entries with intents of txns 1 and 2, tombstones
    and a dead tail."""
    n = B * window
    f = {"key": np.zeros((n, 16), np.uint8), "ts": np.zeros(n, np.int64),
         "seq": np.zeros(n, np.int64), "txn": np.zeros(n, np.int64),
         "tomb": np.zeros(n, bool), "value": np.zeros((n, 8), np.uint8),
         "vlen": np.zeros(n, np.int32), "mask": np.zeros(n, bool)}
    for b in range(B):
        entries = []
        for _ in range(int(rng.integers(5, max(6, window // 2)))):
            key = b"k%06d" % rng.integers(0, nkeys)
            for _ in range(int(rng.integers(1, versions + 1))):
                entries.append((key, int(rng.integers(1, 100)),
                                int(rng.integers(0, 3)),
                                bool(rng.random() < 0.2)))
        entries.sort(key=lambda e: (e[0], -e[1]))
        for i, (key, t, x, tb) in enumerate(entries[:window]):
            j = b * window + i
            f["key"][j, :len(key)] = np.frombuffer(key, np.uint8)
            f["ts"][j], f["txn"][j], f["tomb"][j] = t, x, tb
            f["mask"][j] = True
    return f


def edge_windows(window: int) -> dict[str, np.ndarray]:
    """Three rows: empty, one key with every version a tombstone, and one
    key run spanning the whole row."""
    n = 3 * window
    f = {"key": np.zeros((n, 16), np.uint8), "ts": np.zeros(n, np.int64),
         "seq": np.zeros(n, np.int64), "txn": np.zeros(n, np.int64),
         "tomb": np.zeros(n, bool), "value": np.zeros((n, 8), np.uint8),
         "vlen": np.zeros(n, np.int32), "mask": np.zeros(n, bool)}
    for i in range(20):
        j = window + i
        f["key"][j, :4] = np.frombuffer(b"aaaa", np.uint8)
        f["ts"][j], f["tomb"][j], f["mask"][j] = 100 - i, True, True
    for i in range(window):
        j = 2 * window + i
        f["key"][j, :4] = np.frombuffer(b"bbbb", np.uint8)
        f["ts"][j], f["mask"][j] = 10_000 - i, True
        f["txn"][j] = 3 if i % 97 == 5 else 0
    return f


def user_keys(ids: np.ndarray) -> np.ndarray:
    """b"user%07d" keys, zero-padded to 16 bytes."""
    out = np.zeros((len(ids), 16), np.uint8)
    out[:, :4] = np.frombuffer(b"user", np.uint8)
    d = ids.astype(np.int64).copy()
    for p in range(7):
        out[:, 10 - p] = d % 10 + ord("0")
        d //= 10
    return out


def grown_row(rng, lanes: int) -> dict[str, np.ndarray]:
    """One window row of `lanes` lanes, as window growth makes them: key
    runs of random length (ts descending within a run) of which none
    starts at a multiple of 1,024 lanes, so a run crosses every chunk
    edge of the scan-filter kernel; intents of txns 1-3, tombstones,
    scattered dead lanes and a dead tail."""
    i = np.arange(lanes)
    starts = np.unique(np.concatenate(
        [[0], rng.integers(1, lanes, lanes // 6)]))
    starts = starts[(starts % 1024 != 0) | (starts == 0)]
    run = np.searchsorted(starts, i, side="right") - 1
    dec = np.cumsum(rng.integers(1, 12, lanes))
    f = {"key": user_keys(run), "seq": np.zeros(lanes, np.int64),
         "ts": (rng.integers(20, 400, len(starts))[run]
                - (dec - dec[starts[run]])).astype(np.int64),
         "txn": rng.choice(np.array([0, 0, 0, 0, 1, 2, 3]), lanes),
         "tomb": rng.random(lanes) < 0.15,
         "value": np.zeros((lanes, 8), np.uint8),
         "vlen": np.zeros(lanes, np.int32),
         "mask": (rng.random(lanes) < 0.98) & (i < lanes - lanes // 20)}
    return f


def sorted_run(rng, n: int, cap: int, nkeys: int, device,
               ties: bool = False, key_lo: int = 0,
               dead: float = 0.05) -> mvcc.KVBlock:
    """A sorted run of `cap` rows, n of them written (a `dead` share of
    them dead) with keys from [key_lo, key_lo + nkeys), the rest a dead
    pad tail. With `ties`, every row is live and shares ts and seq, so
    equal keys are equal composite keys."""
    f = {"key": np.zeros((cap, 16), np.uint8), "ts": np.zeros(cap, np.int64),
         "seq": np.zeros(cap, np.int64), "txn": np.zeros(cap, np.int64),
         "tomb": np.zeros(cap, bool), "value": np.zeros((cap, 8), np.uint8),
         "vlen": np.zeros(cap, np.int32), "mask": np.zeros(cap, bool)}
    f["key"][:n] = user_keys(key_lo + rng.integers(0, nkeys, n))
    f["ts"][:n] = 7 if ties else rng.integers(1, 1000, n)
    f["seq"][:n] = 9 if ties else rng.integers(1, 1 << 40, n)
    f["txn"][:n] = rng.integers(0, 2, n)
    f["tomb"][:n] = rng.random(n) < 0.15
    f["value"][:n, :4] = np.arange(n, dtype=np.int32).view(np.uint8).reshape(
        n, 4)
    f["vlen"][:n] = 4
    f["mask"][:n] = True if ties else rng.random(n) >= dead
    return mvcc.sort_block(mvcc.kvblock_from_numpy(f, device))


def live_rows(blk: mvcc.KVBlock) -> dict[str, np.ndarray]:
    m = blk.mask
    return {f: getattr(blk, f)[m].cpu().numpy() for f in mvcc.FIELDS}


def same_rows(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[f], b[f]) for f in mvcc.FIELDS)


# ---------------------------------------------------------------------------
# kernel checks


def check_scan_filter(dev) -> int:
    """K1 against its plain version on the card; returns the max abs
    difference (0 or the phase raises)."""
    rng = np.random.default_rng(11)
    cases = [("ycsb 128x640", scan_windows(rng, 128, 640), 640),
             ("window 64x128", scan_windows(rng, 64, 128), 128),
             ("grown 4x4096", scan_windows(rng, 4, 4096, nkeys=60,
                                           versions=40), 4096),
             ("grown row 1x65536", grown_row(rng, 65536), 65536),
             ("edges x640", edge_windows(640), 640),
             ("edges x2048", edge_windows(2048), 2048)]
    cases = [(name, mvcc.kvblock_from_numpy(f, dev), window)
             for name, f, window in cases]
    # the same rows one row into larger tensors: ts, txn, tomb and mask
    # lose the alignment of the kernel's wide loads (keys keep 16 bytes)
    cases.append(("ycsb 128x640 as offset views",
                  cases[0][1].map(lambda x: torch.cat([x[:1], x])[1:]), 640))
    worst = 0
    for name, blk, window in cases:
        for read_ts, reader in ((50, 0), (10, 0), (50, 1), (200, 2),
                                (50_000, 0), (50_000, 3)):
            got = cuda_scan.scan_filter(blk, read_ts, reader, window)
            want = cuda_scan.scan_filter_plain(blk, read_ts, reader, window)
            torch.cuda.synchronize()
            for g, w, what in zip(got, want, ("selected", "conflict")):
                err = int((g.to(torch.int8) - w.to(torch.int8)).abs().max())
                worst = max(worst, err)
                if err:
                    raise AssertionError(
                        f"scan_filter {what} differs from its plain version "
                        f"on {name} at read_ts={read_ts} reader={reader}")
        log(f"K1 scan_filter == plain on {name} "
            f"({int(blk.mask.sum())} live lanes)")
    return worst


def _plain_pair(a, b):
    return cuda_merge.gather_merged(a, b, cuda_merge.merge_perm_plain(a, b))


def check_tournament(runs: tuple) -> None:
    """merge_runs on the card against the same tournament of plain
    merges, field by field, and its live rows against merge_blocks."""
    got = cuda_merge.merge_runs(runs)
    want = runs
    while len(want) > 1:
        nxt = [_plain_pair(want[i], want[i + 1])
               for i in range(0, len(want) - 1, 2)]
        want = tuple(nxt + list(want[len(want) - len(want) % 2:]))
    ref = mvcc.merge_blocks(runs, cap=got.capacity)
    torch.cuda.synchronize()
    for f in mvcc.FIELDS:
        if not torch.equal(getattr(got, f), getattr(want[0], f)):
            raise AssertionError(f"{len(runs)}-run tournament differs in {f}")
    if not same_rows(live_rows(got), live_rows(ref)):
        raise AssertionError(f"{len(runs)}-run tournament live rows differ "
                             f"from sort")
    log(f"K2 {len(runs)}-run tournament == plain "
        f"({int(got.mask.sum())} live rows)")


def check_merge(dev) -> int:
    """K2 against its plain version on the card: permutations and merged
    live rows equal, and equal to merge_blocks' stable sort."""
    rng = np.random.default_rng(5)
    worst = 0

    def pair_case(name, a, b):
        nonlocal worst
        got = cuda_merge.merge_perm(a, b)
        want = cuda_merge.merge_perm_plain(a, b)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        if err:
            raise AssertionError(f"merge permutation differs on {name}")
        merged = cuda_merge.gather_merged(a, b, got)
        ref = mvcc.merge_blocks((a, b), cap=merged.capacity)
        if not same_rows(live_rows(merged), live_rows(ref)):
            raise AssertionError(f"merged live rows differ on {name}")
        log(f"K2 merge_path == plain on {name} "
            f"({int(merged.mask.sum())} live rows)")

    big = 1 << 17
    pair_case("2x4096 with dead padding",
              sorted_run(rng, 3000, 4096, 500, dev),
              sorted_run(rng, 4096, 4096, 500, dev))
    pair_case("2x2^17 (YCSB load shape)",
              sorted_run(rng, big, big, big // 2, dev),
              sorted_run(rng, big, big, big // 2, dev))
    pair_case("live (key, ts, seq) ties",
              sorted_run(rng, 900, 1024, 40, dev, ties=True),
              sorted_run(rng, 1024, 1024, 40, dev, ties=True))
    low = sorted_run(rng, 20_000, 1 << 15, 5000, dev, dead=0.0)
    high = sorted_run(rng, 1 << 15, 1 << 15, 5000, dev, key_lo=5000,
                      dead=0.0)
    pair_case("all of A below all of B", low, high)
    pair_case("all of A above all of B", high, low)
    one = sorted_run(rng, 1, 1, 10, dev)
    many = sorted_run(rng, big, big, big // 2, dev)
    pair_case("1 row against 2^17", one, many)
    pair_case("2^17 rows against 1", many, one)
    pair_case("2x8192 live ties of one key over many tiles",
              sorted_run(rng, 8192, 8192, 1, dev, ties=True),
              sorted_run(rng, 8192, 8192, 1, dev, ties=True))
    pair_case("dead tails of unequal lengths",
              sorted_run(rng, 500, 8192, 300, dev, dead=0.3),
              sorted_run(rng, 2000, 2048, 300, dev))
    pair_case("2x2^20 (several waves)",
              sorted_run(rng, 1 << 20, 1 << 20, 1 << 19, dev),
              sorted_run(rng, 1 << 20, 1 << 20, 1 << 19, dev))
    pair_case("2x2^23 (the TPC-H SF1 KV load's largest merge)",
              sorted_run(rng, 1 << 23, 1 << 23, 1 << 22, dev),
              sorted_run(rng, 1 << 23, 1 << 23, 1 << 22, dev))

    check_tournament(tuple(
        sorted_run(rng, int(rng.integers(500, 2048)), 2048, 300, dev)
        for _ in range(4)))
    check_tournament(tuple(
        sorted_run(rng, int(rng.integers(1, cap + 1)), cap, 3000, dev)
        for cap in (4096, 8192, 1024, 8192, 2048, 4096, 8192, 1)))
    return worst


# ---------------------------------------------------------------------------
# YCSB-E with a scan oracle


class YcsbRecorder:
    """Records the main engine's writes and batched scans, in order, so
    that every scan can be replayed against a host dict afterwards."""

    def __init__(self, engine_cls):
        self.cls = engine_cls
        self.events: list[tuple] = []
        self.orig = {n: getattr(engine_cls, n)
                     for n in ("put", "ingest", "scan_batch")}

    def __enter__(self):
        rec, orig = self, self.orig

        def put(eng, key, value, ts, txn=0):
            rec.events.append(("put", id(eng), bytes(key), bytes(value),
                               int(ts)))
            return orig["put"](eng, key, value, ts, txn)

        def ingest(eng, keys, values, ts, seq=None, vlens=None,
                   presorted=False):
            vl = (np.full(len(keys), values.shape[1]) if vlens is None
                  else np.asarray(vlens))
            rec.events.append(("ingest", id(eng), np.array(keys),
                               np.array(values), vl, int(ts)))
            return orig["ingest"](eng, keys, values, ts, seq=seq,
                                  vlens=vlens, presorted=presorted)

        def scan_batch(eng, starts, ts, txn=0, max_keys=64):
            out = orig["scan_batch"](eng, starts, ts, txn=txn,
                                     max_keys=max_keys)
            rec.events.append(("scan", id(eng), list(starts), int(ts),
                               int(max_keys), out))
            return out

        self.cls.put, self.cls.ingest = put, ingest
        self.cls.scan_batch = scan_batch
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.cls, n, fn)

    def check(self) -> int:
        """Replays the scanned engine's history into a host dict and holds
        every recorded scan result against it; returns the scans checked."""
        scanned = {e[1] for e in self.events if e[0] == "scan"}
        if len(scanned) != 1:
            raise AssertionError(f"expected one scanned engine: {scanned}")
        eid = scanned.pop()
        newest: dict[bytes, tuple[int, bytes]] = {}
        order: list[bytes] = []
        checked = 0
        for e in self.events:
            if e[1] != eid:
                continue
            if e[0] == "put":
                _, _, k, v, ts = e
                if k not in newest:
                    bisect.insort(order, k)
                if k not in newest or ts >= newest[k][0]:
                    newest[k] = (ts, v)
            elif e[0] == "ingest":
                _, _, keys, vals, vl, ts = e
                for row, val, n in zip(keys, vals, vl):
                    k = bytes(row).rstrip(b"\x00")
                    if k not in newest:
                        order.append(k)
                    if k not in newest or ts >= newest[k][0]:
                        newest[k] = (ts, bytes(val[:n]))
                order.sort()
            else:
                _, _, starts, ts, max_keys, out = e
                for s, got in zip(starts, out):
                    want, i = [], bisect.bisect_left(order, bytes(s))
                    while len(want) < max_keys and i < len(order):
                        k = order[i]
                        if newest[k][0] <= ts:
                            want.append((k, newest[k][1]))
                        i += 1
                    if got != want:
                        raise AssertionError(
                            f"scan from {s!r} at ts {ts}: engine returned "
                            f"{got[:3]}..., oracle {want[:3]}...")
                    checked += 1
        return checked


def run_ycsb(card: str) -> dict:
    from cockroach_tpu_torch.bench.ycsb import run_ycsb_e
    from cockroach_tpu_torch.storage.lsm import Engine

    with YcsbRecorder(Engine) as rec:
        cuda_scan.scan_filter.launches = 0
        cuda_merge.merge_perm.launches = 0
        t0 = time.perf_counter()
        y = run_ycsb_e(n_keys=1 << 20, ops=512, scan_len=64,
                       concurrency=128, seed=0, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"scan_filter": cuda_scan.scan_filter.launches,
                    "merge_path": cuda_merge.merge_perm.launches}
    if not y["bit_identical"]:
        raise AssertionError("YCSB ingest and put paths disagree")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
    checked = rec.check()
    if checked < 128:
        raise AssertionError(f"only {checked} scans held against the oracle")
    log(f"YCSB-E: {checked} scans match the host oracle; launches {launches}")
    emit({"ycsb_e": y, "wall_s": wall, "card": card, "launches": launches},
         {"ycsb_e": {k: y[k] for k in ("ops_per_sec", "rows_per_sec",
                                       "load_s", "point_ops_per_sec")},
          "wall_s": wall, "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# TPC-H: the SQL executor (q1, q3) on the card


TPCH_SEED = 19920101  # bench.py's seed


def device_profile(fn) -> dict:
    """Run fn() once under torch.profiler: the device's busy time (sum of
    kernel, copy and memset durations on the card) against the run's wall
    time, and the device operations that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = per_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us()
            acc[1] += 1
    busy_us = sum(v[0] for v in per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:3]
    return {"wall_s": wall_us / 1e6,
            "device_busy_s": busy_us / 1e6 if busy_us else "not measured",
            "idle_share": (1 - busy_us / wall_us) if busy_us
            else "not measured",
            "top_device_ops": [[n[:32], v[0] / 1e3, v[1]] for n, v in top]}


def tpch_results(sf: float, devices, seed: int = TPCH_SEED,
                 queries=("q1", "q3"), optimized: bool = False) -> list:
    """`queries` through the port's plan builder and runtime (over
    ``rel.plan``, or ``rel.optimized_plan()``) over a catalog generated
    on each of `devices`: one {query: result} per device."""
    from cockroach_tpu_torch.bench import queries as Q
    from cockroach_tpu_torch.bench.tpch import gen_tpch
    from cockroach_tpu_torch.flow.runtime import run_operator
    from cockroach_tpu_torch.plan import builder

    out = []
    for dev in devices:
        cat = gen_tpch(sf=sf, seed=seed, device=dev)
        res = {}
        for q in queries:
            rel = Q.QUERIES[q](cat)
            plan = rel.optimized_plan() if optimized else rel.plan
            res[q] = run_operator(builder.build(plan, cat))
        out.append(res)
    return out


def check_tpch_parity(dev, sf: float = 0.01) -> None:
    """The same TPC-H data on the card and on the CPU give the same q1 and
    q3 results (the FLOAT64 averages within the oracle's bound)."""
    from cockroach_tpu_torch.bench import tpch_oracle

    on_card, on_cpu = tpch_results(sf, (dev, "cpu"))
    for q in on_card:
        bad = tpch_oracle.mismatch(q, on_card[q], on_cpu[q])
        if bad is not None:
            raise AssertionError(f"TPC-H SF{sf} card != CPU: {bad}")
    log(f"TPC-H SF{sf}: q1 and q3 on the card equal the CPU's")


def check_tpch22_parity(dev, sf: float = 0.05, tile: int = 1 << 16) -> dict:
    """All 22 queries at `sf` with `tile`-row scan tiles (so lineitem
    spans several tiles), on the card against the CPU, through rel.plan
    and through rel.optimized_plan() (TopK for q2, q3, q10, q18, q21):
    integer, DECIMAL, DATE, BOOL and STRING columns exactly, FLOAT within
    rtol=1e-12. Returns the result rows per query."""
    from cockroach_tpu_torch.bench import queries as Q
    from cockroach_tpu_torch.bench import tpch_oracle
    from cockroach_tpu_torch.utils import settings

    queries = tuple(Q.QUERIES)
    settings.set("sql.distsql.tile_size", tile)
    try:
        runs = {opt: tpch_results(sf, (dev, "cpu"), queries=queries,
                                  optimized=opt) for opt in (False, True)}
    finally:
        settings.reset("sql.distsql.tile_size")
    rows = {}
    for q in queries:
        want = runs[False][1][q]
        for opt in (False, True):
            for side, res in zip(("card", "CPU"), runs[opt]):
                bad = tpch_oracle.mismatch(q, res[q], want)
                if bad is not None:
                    raise AssertionError(
                        f"TPC-H SF{sf} {side} "
                        f"({'optimized_plan' if opt else 'plan'}) != CPU "
                        f"(plan): {bad}")
        rows[q] = len(next(iter(want.values())))
    log(f"TPC-H SF{sf}, {tile}-row tiles: all 22 queries on the card equal "
        "the CPU's, through plan and optimized_plan")
    return rows


def time_dense_agg(cat) -> dict:
    """The first candidate for a hand-written kernel on the TPC-H path:
    q1's per-tile dense aggregation (SmallGroupAggregateOp.tile_states:
    group codes, then every state by index_add_ scatter) on the first
    lineitem tile as the main path gives it (filtered and projected),
    timed with CUDA events; its bound counts the tile's columns, valid
    bitmaps and mask read once (the [G] states written are negligible)."""
    from cockroach_tpu_torch.bench import queries as Q
    from cockroach_tpu_torch.ops import aggregation as agg_ops
    from cockroach_tpu_torch.plan import builder

    root = builder.build(Q.q1(cat).plan, cat)
    agg = root.child
    root.init()
    tile = agg.child.next_batch()
    used = set(agg.group_cols) | {s.col for s in agg.partial_specs
                                  if s.col is not None}
    nbytes = tile.mask.numel() + sum(
        c.data.numel() * c.data.element_size() + c.valid.numel()
        for i, c in enumerate(tile.cols) if i in used)
    code, _ = agg_ops.dense_group_codes(tile, agg.group_cols, agg.strides,
                                        agg.key_sizes, agg.key_lows)
    seg = torch.where(tile.mask, code, agg.G)
    vals = tile.cols[agg.partial_specs[0].col].data
    # the reference's accelerator formulation (a [rows, G] one-hot
    # membership matrix) on the same tile, held equal to the scatter
    scatter, _ = agg_ops.dense_scatter_states(
        tile, agg.base_schema, code, agg.G, agg.partial_specs)
    onehot, _ = agg_ops.smallgroup_partial_states(
        tile, agg.base_schema, code, agg.G, agg.partial_specs)
    for (sd, sv), (od, ov) in zip(scatter, onehot):
        if not (torch.equal(sd, od) and torch.equal(sv, ov)):
            raise AssertionError("one-hot dense states != scatter states")
    one_bytes = (vals.numel() * vals.element_size()
                 + seg.numel() * seg.element_size())
    out = {"op": "SmallGroupAggregateOp.tile_states (dense_group_codes + "
                 "dense_scatter_states)",
           "rows": tile.capacity, "groups": agg.G,
           "states": len(agg.partial_specs),
           "ms": device_ms(lambda: agg.tile_states(tile)),
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes",
           "onehot_ms": device_ms(
               lambda: agg_ops.smallgroup_partial_states(
                   tile, agg.base_schema, code, agg.G, agg.partial_specs)),
           "index_add_ms": device_ms(
               lambda: torch.zeros(agg.G + 1, dtype=vals.dtype,
                                   device=vals.device).index_add_(
                                       0, seg, vals)),
           "index_add_bytes": one_bytes,
           "index_add_bound_ms": one_bytes / HBM_BYTES_PER_S * 1e3}
    root.close()
    return out


def operator_breakdown(root) -> dict:
    """Wall time per operator (exclusive of its children) over one run
    with per-operator stats on: the card is synchronized around every
    tile pull, so each operator's time holds its own device work, and
    the sum exceeds an unobserved run's time by those waits."""
    from cockroach_tpu_torch.flow.runtime import run_operator

    root.collect_stats(True)
    run_operator(root)
    root.collect_stats(False)
    out = {}
    stack = [root]
    while stack:
        op = stack.pop()
        out[f"{len(out)}:{type(op).__name__}"] = (
            op.stats.exclusive(op.children()) * 1e3)
        stack.extend(reversed(op.children()))
    return out


def top_ms(ms: dict, n: int = 4) -> dict:
    """The n largest entries of an {operator: ms} breakdown."""
    return dict(sorted(ms.items(), key=lambda kv: -kv[1])[:n])


def brief(r: dict) -> dict:
    """One query's run_tpch figures without the per-operator detail."""
    keep = ("cold_s", "warm_s", "median_s", "rows_per_sec", "rows",
            "host_syncs_total", "peak_device_bytes", "streamed", "spills",
            "h2d_bytes", "h2d_s", "upload_waits", "fill_wait_s",
            "staged_bytes")
    out = {k: r[k] for k in keep if k in r}
    if "host_syncs_total" not in out and "host_syncs" in r:
        out["host_syncs_total"] = sum(r["host_syncs"].values())
    return out


# ---------------------------------------------------------------------------
# fusion: fused against unfused on the card

_LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def launch_profile(fn) -> dict:
    """One run of fn() under torch.profiler: the device's busy time and
    idle share, the launch calls the host issued (kernels, graph replays,
    copies, memsets: the runtime API events of those names) and the
    device operations that ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = 0.0
    device_ops = launches = graphs = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy_us += e.time_range.elapsed_us()
            device_ops += 1
        elif e.name in _LAUNCH_APIS:
            launches += 1
            graphs += e.name == "cudaGraphLaunch"
    return {"wall_s": wall_us / 1e6,
            "idle_share": (1 - busy_us / wall_us) if busy_us
            else "not measured",
            "host_launches": launches, "graph_launches": graphs,
            "device_ops": device_ops}


def lineitem_tiles(root) -> int:
    """Probe tiles of the run: lineitem's scan tiles."""
    from cockroach_tpu_torch.flow.operators import ScanOp

    stack = [root]
    while stack:
        op = stack.pop()
        if isinstance(op, ScanOp) and op.table.name == "lineitem":
            tile = op._stream.tile if op.streaming else op._res_tile
            return -(-op.table.num_rows // tile)
        stack.extend(op.children())
    raise AssertionError("no lineitem scan in the plan")


def same_result(a: dict, b: dict) -> bool:
    """Bit-for-bit equal query results (NaN equal to NaN)."""
    if list(a) != list(b):
        return False
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if x.dtype == object:
            if list(x) != list(y):
                return False
        elif not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
            return False
    return True


def _fusion(on: bool):
    from cockroach_tpu_torch.utils import settings

    settings.set("sql.distsql.fusion.enabled", on)


def fusion_runs(cat, q: str, on: bool, runs: int) -> tuple[dict, dict]:
    """Query q over cat with fusion on or off: a cold run, a second run
    (join capacities learned in the first take effect), then `runs` more,
    timed; then one profiled run. Graph captures of each stage, host
    syncs, dispatches, launches and peak memory. -> (figures, result)"""
    import gc

    from cockroach_tpu_torch.bench import queries as Q
    from cockroach_tpu_torch.flow import dispatch
    from cockroach_tpu_torch.flow.runtime import (host_syncs, io_report,
                                                  run_operator)
    from cockroach_tpu_torch.plan import builder
    from cockroach_tpu_torch.utils import settings

    _fusion(on)
    try:
        dispatch.clear_kernel_cache()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        root = builder.build(Q.QUERIES[q](cat).optimized_plan(), cat)
        caps = []
        t_cold = None
        for _ in range(2):
            c0 = dispatch.captures()
            t0 = time.perf_counter()
            want = run_operator(root)
            torch.cuda.synchronize()
            t_cold = t_cold or time.perf_counter() - t0
            caps.append(dispatch.captures() - c0)
        c0, d0, e0 = dispatch.captures(), dispatch.total(), dispatch.eager()
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            got = run_operator(root)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if not same_result(got, want):
                raise AssertionError(f"{q} (fusion {on}): a repeat run "
                                     "differs from the first")
        caps.append(dispatch.captures() - c0)
        disp = (dispatch.total() - d0) / runs
        eager = (dispatch.eager() - e0) / runs
        r0 = dispatch.replays()
        fill_s = io_report(root)["fill_wait_s"]
        prof = launch_profile(lambda: run_operator(root))
        replays = dispatch.replays() - r0
        tiles = lineitem_tiles(root)
        med = statistics.median(times)
        fig = {"median_ms": med * 1e3,
               "rows_per_sec": cat.get("lineitem").num_rows / med,
               "cold_ms": t_cold * 1e3, "captures": caps,
               "host_syncs": sum(host_syncs(root).values()),
               "dispatches": disp, "dispatches_per_tile": disp / tiles,
               "eager_dispatches": eager, "replays": replays,
               "launches_per_tile": prof["host_launches"] / tiles,
               "graph_launches": prof["graph_launches"],
               "device_ops_per_tile": prof["device_ops"] / tiles,
               "idle_share": prof["idle_share"], "tiles": tiles,
               "fill_wait_s": fill_s, "base_gb": base / 1e9,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}
        return fig, want
    finally:
        settings.reset("sql.distsql.fusion.enabled")


def fusion_compare(cat, queries=("q3", "q9", "q18"), runs: int = 5) -> dict:
    """Each query fused and unfused in turn on one card: the figures of
    fusion_runs side by side, the two results held equal bit for bit,
    and the fused path held to its contract: graphs captured on the first
    run, none on a repeat run, no eager device function."""
    out = {}
    for q in queries:
        unfused, a = fusion_runs(cat, q, False, runs)
        fused, b = fusion_runs(cat, q, True, runs)
        if not same_result(a, b):
            raise AssertionError(f"{q}: fused != unfused")
        if fused["captures"][0] <= 0 or fused["replays"] <= 0:
            raise AssertionError(f"{q}: no CUDA graph captured or replayed")
        if fused["captures"][2] or unfused["captures"][2]:
            raise AssertionError(f"{q}: a repeat run captured graphs: "
                                 f"{fused['captures']}")
        if fused["eager_dispatches"]:
            raise AssertionError(f"{q}: {fused['eager_dispatches']} per-tile "
                                 "device functions ran outside a graph")
        out[q] = {"unfused": unfused, "fused": fused}
    return out


def check_fusion22(dev, sf: float, tile: int | None = None,
                   scaling: dict | None = None) -> dict:
    """All 22 queries at `sf` on the card, unfused once and fused three
    times: every fused run equal to the unfused one bit for bit, graphs
    captured in the first fused run and none in the third (the second
    may capture the shapes join capacities learned in the first)."""
    from cockroach_tpu_torch.bench import queries as Q
    from cockroach_tpu_torch.bench.tpch import gen_tpch
    from cockroach_tpu_torch.flow import dispatch
    from cockroach_tpu_torch.flow.runtime import run_operator
    from cockroach_tpu_torch.plan import builder
    from cockroach_tpu_torch.utils import settings

    sets = dict(scaling or {})
    if tile is not None:
        sets["sql.distsql.tile_size"] = tile
    for n, v in sets.items():
        settings.set(n, v)
    caps = [0, 0, 0]
    replays0 = dispatch.replays()
    try:
        cat = gen_tpch(sf=sf, seed=TPCH_SEED, device=dev)
        for q in Q.QUERIES:
            plan = Q.QUERIES[q](cat).optimized_plan()
            _fusion(False)
            want = run_operator(builder.build(plan, cat))
            _fusion(True)
            root = builder.build(plan, cat)
            for i in range(3):
                c0 = dispatch.captures()
                got = run_operator(root)
                caps[i] += dispatch.captures() - c0
                if not same_result(got, want):
                    raise AssertionError(f"{q} at sf={sf}: fused run {i} "
                                         "!= unfused")
    finally:
        settings.reset()
    if caps[0] <= 0 or caps[2]:
        raise AssertionError(f"captures per fused run {caps}")
    replays = dispatch.replays() - replays0
    log(f"fusion sf={sf}: 22 fused == unfused, captures {caps}")
    return {"equal": True, "captures": caps, "replays": replays}


def run_tpch_phase(card: str, fusion: dict, sf: float = 1.0):
    """The SQL main path on the card: the SF0.01 and SF0.05 parity checks
    (and at SF0.05 fused against unfused), then at SF1 bench.py's ladder
    through run_tpch (every run held to the numpy oracle), one profiled
    run of each ladder query, the other 18 queries cold and warm, and q3,
    q9 and q18 fused against unfused (into `fusion`). Returns the figures
    (the ladder's run_tpch output under "ladder") and the SF1 catalog."""
    from cockroach_tpu_torch.bench import queries as Q
    from cockroach_tpu_torch.bench.tpch import gen_tpch
    from cockroach_tpu_torch.bench.tpch_run import LADDER, run_tpch
    from cockroach_tpu_torch.flow.runtime import host_syncs, run_operator
    from cockroach_tpu_torch.plan import builder

    check_tpch_parity(torch.device("cuda"))
    rows_sf005 = check_tpch22_parity(torch.device("cuda"))
    fusion["sf0.05_22"] = check_fusion22(torch.device("cuda"), 0.05,
                                         tile=1 << 16)
    t0 = time.perf_counter()
    cat = gen_tpch(sf=sf, seed=TPCH_SEED, device="cuda")
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    cuda_scan.scan_filter.launches = 0
    cuda_merge.merge_perm.launches = 0
    res = run_tpch(LADDER, sf=sf, seed=TPCH_SEED, runs=DEPTH_RUNS,
                   device="cuda", catalog=cat)
    profiles = {}
    syncs = {}
    operator_ms = {}
    for q in LADDER:
        root = builder.build(Q.QUERIES[q](cat).optimized_plan(), cat)
        run_operator(root)
        profiles[q] = device_profile(lambda root=root: run_operator(root))
        syncs[q] = sum(host_syncs(root).values())
        operator_ms[q] = top_ms(operator_breakdown(root))
    candidate = time_dense_agg(cat)
    others = tuple(q for q in Q.QUERIES if q not in LADDER)
    rest = run_tpch(others, sf=sf, seed=TPCH_SEED, runs=0, device="cuda",
                    catalog=cat)
    storage_launches = {"scan_filter": cuda_scan.scan_filter.launches,
                        "merge_path": cuda_merge.merge_perm.launches}
    out = {"sf": sf, "lineitem_rows": res["lineitem_rows"], "gen_s": gen_s,
           **{q: brief(res[q]) for q in LADDER},
           "profiles": profiles,
           "kernel_candidate": candidate,
           "syncs_per_query": syncs,
           "operator_exclusive_ms": operator_ms,
           "storage_kernel_launches": storage_launches,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "card_vs_cpu_sf0.01": True,
           "card_vs_cpu_sf0.05_22_rows": rows_sf005, "card": card}
    log(f"SF{sf:g} ladder equal to the oracle")
    emit({"tpch": out},
         {"tpch": {"sf": sf, "gen_s": gen_s,
                   "median_s": {q: res[q]["median_s"] for q in LADDER},
                   "peak_device_bytes": out["peak_device_bytes"]}})
    tpch22 = {q: [rest[q]["cold_s"], rest[q]["warm_s"], rest[q]["rows"],
                  sum(rest[q]["host_syncs"].values())] for q in others}
    log(f"SF{sf:g} other {len(others)}: warm equal to cold")
    emit({"tpch22": {"columns": ["cold_s", "warm_s", "rows", "host_syncs"],
                     **tpch22}, "card": card},
         {"tpch22_warm_s": {q: v[1] for q, v in tpch22.items()}})
    fusion[f"sf{sf:g}"] = fusion_compare(cat, runs=DEPTH_RUNS)
    log(f"SF{sf:g} fusion: q3 q9 q18 fused == unfused")
    out["merge_join"] = merge_vs_hash(cat)
    out["ladder"] = res
    return out, cat


# ---------------------------------------------------------------------------
# SQL over the MVCC store (kv/table.py, kv/txn.py, kv/index.py)

KV_DIR = ".kvstore"  # checkpoint and WAL of the index engine, removed after


def kv_scan_ops(root) -> list:
    """The scans of KV tables in a tree."""
    from cockroach_tpu_torch.flow.operators import ScanOp
    from cockroach_tpu_torch.kv.table import KVTable

    out, stack = [], [root]
    while stack:
        op = stack.pop()
        stack.extend(op.children())
        if isinstance(op, ScanOp) and isinstance(op.table, KVTable):
            out.append(op)
    return out


def kv_table_syncs(cat) -> int:
    """Device -> host reads the catalog's KV tables have made so far."""
    return sum(getattr(t, "host_syncs", 0) for t in cat.tables.values())


class K2Witness:
    """While open, every pair of runs the engine merges through K2
    (cuda_merge.merge_pair, which merge_runs calls) is merged again by
    merge_perm_plain on the same blocks on the card: the permutations
    and every field of the merged rows must be equal. The plain merges
    are no launches; their seconds (`seconds`) are part of the caller's
    timings."""

    def __init__(self):
        import threading

        self.pairs = self.max_rows = 0
        self.seconds = 0.0
        # the matview step's flushes merge on the caller's thread, a hub
        # poll on its own: one check at a time, counts exact
        self._mu = threading.Lock()

    def __enter__(self):
        self.merge_pair = cuda_merge.merge_pair

        def checked(a, b):
            with self._mu:
                return check(a, b)

        def check(a, b):
            got = cuda_merge.merge_perm(a, b)
            if a.key.device.type != "cuda":
                return cuda_merge.gather_merged(a, b, got)  # no kernel
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = cuda_merge.merge_perm_plain(a, b)
            where = f"{a.capacity}+{b.capacity}-row merge {self.pairs}"
            if not torch.equal(got, want):
                raise AssertionError(f"K2 permutation != plain on the KV "
                                     f"path ({where})")
            ig, iw = got.clamp(min=0).long(), want.clamp(min=0).long()
            for f in mvcc.FIELDS:
                both = torch.cat([getattr(a, f), getattr(b, f)])
                if not torch.equal(both[ig], both[iw]):
                    raise AssertionError(f"K2 merged {f} != plain on the KV "
                                         f"path ({where})")
            self.pairs += 1
            self.max_rows = max(self.max_rows, a.capacity + b.capacity)
            self.seconds += time.perf_counter() - t0
            return cuda_merge.gather_merged(a, b, got)

        cuda_merge.merge_pair = checked
        return self

    def __exit__(self, *exc):
        cuda_merge.merge_pair = self.merge_pair


def check_kv_parity(dev, sf: float = 0.01) -> dict:
    """All 22 queries over KV tables on the card equal the same on the CPU
    and the host-table run on the card (FLOAT columns within 1e-9: the
    KV plans sum in another order)."""
    from cockroach_tpu_torch.bench import queries as Q
    from cockroach_tpu_torch.bench import tpch_kv
    from cockroach_tpu_torch.bench.tpch import gen_tpch
    from cockroach_tpu_torch.flow.runtime import run_operator
    from cockroach_tpu_torch.plan import builder

    cats = {}
    for d in (dev, torch.device("cpu")):
        host = gen_tpch(sf=sf, seed=TPCH_SEED, device=d)
        cats[d.type] = (host, tpch_kv.load_tpch_kv(host, device=d)[0])
    rows = {}
    for q in Q.QUERIES:
        res = {k: run_operator(builder.build(
            Q.QUERIES[q](c).optimized_plan(), c))
            for k, c in (("kv", cats[dev.type][1]), ("cpu", cats["cpu"][1]),
                         ("host", cats[dev.type][0]))}
        for other in ("cpu", "host"):
            bad = first_difference(res["kv"], res[other], rtol=1e-9)
            if bad is not None:
                raise AssertionError(
                    f"{q} over KV on the card != {other}: {bad}")
        rows[q] = len(next(iter(res["kv"].values())))
    return {"sf": sf, "queries": len(rows),
            "rows": sum(rows.values()), "equal": True}


def kv_ladder(cat, oracle_cat, dev, runs: int,
              ops_ms: dict | None = None) -> dict:
    """bench.py's ladder over KV: run_tpch_kv's figures (every run held to
    the oracle) plus, for each query, one profiled run of a tree that has
    run once, with its syncs (the operators' counted syncs, a KV scan
    counting its table's intent check, and any other read a KV table
    made during the run, all measured), the KV tables' reads while
    planning, and the memory still allocated after it; with `ops_ms`,
    each query's three costliest operators (exclusive ms) go there."""
    from cockroach_tpu_torch.bench import queries as Q
    from cockroach_tpu_torch.bench.tpch_kv import run_tpch_kv
    from cockroach_tpu_torch.bench.tpch_run import LADDER
    from cockroach_tpu_torch.flow.runtime import host_syncs, run_operator
    from cockroach_tpu_torch.plan import builder

    res = run_tpch_kv(cat, oracle_cat, LADDER, runs=runs, device=dev)
    out = {}
    for q in LADDER:
        r = res[q]
        s0 = kv_table_syncs(cat)
        root = builder.build(Q.QUERIES[q](cat).optimized_plan(), cat)
        plan_syncs = kv_table_syncs(cat) - s0
        run_operator(root)  # the tree's first run learns its capacities
        s0 = kv_table_syncs(cat)
        prof = device_profile(lambda root=root: run_operator(root))
        scans = kv_scan_ops(root)
        # table reads outside the scans' decodes (none expected)
        other = (kv_table_syncs(cat) - s0
                 - sum(op.stats.host_syncs for op in scans))
        syncs = sum(host_syncs(root).values()) + other
        resident = torch.cuda.memory_allocated()
        if ops_ms is not None:
            ops_ms[q] = top_ms(operator_breakdown(root), 3)
        out[q] = [r["median_s"], r["cold_s"], r["decode_s"],
                  prof["idle_share"], syncs, plan_syncs, len(scans),
                  r["peak_device_bytes"], resident]
    return out


def kv_index_phase(host, dev) -> dict:
    """orders in an indexed engine (with a WAL): 100 lookups on o_custkey
    through IndexScanOp, each equal to the full scan and to the host
    rows; then a checkpoint, writes after it (WAL only), and the
    checkpoint plus WAL reopened on the card with the same live rows."""
    import shutil

    from cockroach_tpu_torch.bench import tpch_kv
    from cockroach_tpu_torch.catalog import Catalog
    from cockroach_tpu_torch.flow.runtime import run_operator
    from cockroach_tpu_torch.kv import DB, Clock
    from cockroach_tpu_torch.kv.table import load_catalog_from_engine
    from cockroach_tpu_torch.plan import builder
    from cockroach_tpu_torch.storage.lsm import Engine
    from cockroach_tpu_torch.utils import settings

    shutil.rmtree(KV_DIR, ignore_errors=True)
    os.makedirs(KV_DIR)
    wal = os.path.join(KV_DIR, "orders.wal")
    try:
        cat, db, load = tpch_kv.index_engine(host, device=dev, wal_path=wal)
        orders = host.get("orders")
        okey = np.asarray(orders.columns["o_orderkey"])
        ocust = np.asarray(orders.columns["o_custkey"])
        picks = np.random.default_rng(5).choice(ocust, 100, replace=False)

        def lookup(ck, index: bool):
            settings.set("sql.opt.index_scan.enabled", index)
            try:
                plan = tpch_kv.custkey_lookup(cat, ck).optimized_plan()
            finally:
                settings.reset("sql.opt.index_scan.enabled")
            assert ("IndexScan" in repr(plan)) == index
            root = builder.build(plan, cat)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_operator(root)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0

        lookup(int(picks[0]), True)
        ms, full_ms, rows = [], [], 0
        for ck in picks:
            got, secs = lookup(int(ck), True)
            full, fsecs = lookup(int(ck), False)
            want = sorted(okey[ocust == ck].tolist())
            if (sorted(got["o_orderkey"].tolist()) != want
                    or tpch_kv.sorted_rows(got)
                    != tpch_kv.sorted_rows(full)):
                raise AssertionError(f"o_custkey={ck}: index lookup != "
                                     "full scan")
            ms.append(secs * 1e3)
            full_ms.append(fsecs * 1e3)
            rows += len(want)
        ck_path = os.path.join(KV_DIR, "ck")
        eng = db.engine
        t0 = time.perf_counter()
        eng.checkpoint(ck_path)
        write_s = time.perf_counter() - t0
        rf = tpch_kv.gen_refresh(host, 0.01, seed=2)
        db.txn(lambda t: cat.get("orders").insert_rows(t, rf["rf1_orders"]))
        live = eng.compute_stats().live_count
        nrows = cat.get("orders").snapshot_live_rows()
        eng.close()
        t0 = time.perf_counter()
        eng2 = Engine.open_checkpoint(ck_path, wal_path=wal, device=dev)
        torch.cuda.synchronize()
        open_s = time.perf_counter() - t0
        cat2 = Catalog(dev)
        load_catalog_from_engine(cat2, DB(eng2, Clock()))
        t2 = cat2.get("orders")
        if (eng2.compute_stats().live_count != live
                or t2.snapshot_live_rows() != nrows
                or [i.name for i in t2.indexes] != ["o_custkey_idx"]):
            raise AssertionError("reopened checkpoint + WAL differs")
        eng2.close()
        return {"rows": load["rows"], "load_s": load["load_s"],
                "lookups": len(ms), "matched_rows": rows,
                "median_ms": statistics.median(ms), "max_ms": max(ms),
                "full_scan_median_ms": statistics.median(full_ms),
                "ckpt": {"write_s": write_s, "open_s": open_s,
                         "live_versions": live, "rows": nrows,
                         "wal_rows": len(rf["rf1_orders"]["o_orderkey"])}}
    finally:
        shutil.rmtree(KV_DIR, ignore_errors=True)


KV_VIEW_PRIME_LIMIT_S = 45.0  # past it, the views step runs on orders


def kv_views(cat, db) -> dict:
    """Standing views over TPC-H in KV (bench/views.KVViews): q1 at four
    ship-date cutoffs on lineitem, created after the load; if priming
    lineitem's shadow passes KV_VIEW_PRIME_LIMIT_S, the views move to
    orders (a dense grouped aggregate over o_orderstatus) and lineitem's
    prime seconds stay in the record. Every view equals a fresh run of
    its query at creation."""
    from cockroach_tpu_torch.bench.views import KVViews

    out: dict = {}
    mv = KVViews(cat, db, base="lineitem")
    if mv.prime_s > KV_VIEW_PRIME_LIMIT_S:
        out["lineitem_prime_s"] = mv.prime_s
        out["lineitem_shadow_rows"] = mv.shadow_rows
        mv.close()
        mv = KVViews(cat, db, base="orders")
    bad = mv.check()
    if bad:
        raise AssertionError(f"views over KV at creation: {bad}")
    out.update({"mv": mv, "base": mv.base, "days": list(mv.days),
                "prime_s": mv.prime_s, "shadow_rows": mv.shadow_rows,
                "peak_rss_gb": mv.peak_rss_gb,
                "rss_growth_gb": mv.rss_growth_gb,
                "create_ms": mv.create_ms, "check_s": mv.check_s})
    log(f"{len(mv.days)} views on {mv.base}: shadow of {mv.shadow_rows} "
        f"rows primed in {mv.prime_s:.1f}s, each == a fresh rescan")
    return out


def kv_views_flush(views: dict, when: str, k2: "K2Witness") -> dict:
    """One pump and flush of the views after a refresh function, each
    view then held to a fresh run of its query over KV (rewrite off);
    the flush's K2 merges are witnessed like the rest of the phase (their
    check's seconds: `k2_check_s`)."""
    mv = views["mv"]
    c0 = k2.seconds
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = mv.flush()
    torch.cuda.synchronize()
    out["wall_ms"] = (time.perf_counter() - t0) * 1e3
    if out["dispatches"] > 1 or out["events"] == 0:
        raise AssertionError(f"views flush after {when}: {out}")
    bad = mv.check()
    if bad:
        raise AssertionError(f"views after {when} != fresh rescan: {bad}")
    out["k2_check_s"] = k2.seconds - c0
    log(f"views after {when}: {out['events']} events in one flush of "
        f"{out['dispatches']} dispatch, each view == a fresh rescan")
    return out


def run_kv_phase(card: str, host, host_ladder: dict, sf: float = 1.0,
                 runs: int = DEPTH_RUNS, dev="cuda") -> tuple[dict, dict]:
    """SQL over the MVCC store on the card: the sf=0.01 parity run, then
    `host` (TPC-H at `sf`) bulk-loaded into one engine, bench.py's ladder over
    KV, RF1 and RF2 in transactions, the ladder again (held to the oracle
    of the refreshed data), the index lookups and the checkpoint. Prints
    the ``{"tpch_kv": ...}`` line; returns it and the storage kernels'
    launches on the main path (load, ladders, refresh functions)."""
    import gc

    from cockroach_tpu_torch.bench import tpch_kv
    from cockroach_tpu_torch.flow import dispatch

    dev = torch.device(dev)
    parity = check_kv_parity(dev)
    log("TPC-H sf0.01 over KV: 22 queries card == CPU == host tables")
    # the parity run's catalogs, engines and graphs are garbage now:
    # free them before the SF1 load rather than at a collection inside it
    gc.collect()
    torch.cuda.synchronize()
    cuda_scan.scan_filter.launches = 0
    cuda_merge.merge_perm.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with K2Witness() as k2:
        cat, db, load = tpch_kv.load_tpch_kv(host, device=dev)
        load["k2_check_s"] = k2.seconds
        load["view_slots"] = db.engine._merged_view().capacity
        ops_ms: dict = {}
        before = kv_ladder(cat, host, dev, runs, ops_ms)
        rf = tpch_kv.gen_refresh(host, sf)
        t_views = time.perf_counter()
        views = kv_views(cat, db)
        c0 = k2.seconds
        rf1 = tpch_kv.apply_rf1(cat, db, rf)
        views["rf1"] = kv_views_flush(views, "RF1", k2)
        c1 = k2.seconds
        rf2 = tpch_kv.apply_rf2(cat, db, rf)
        views["rf2"] = kv_views_flush(views, "RF2", k2)
        # both refresh functions, without the flushes after them
        rf2["k2_check_s"] = (c1 - c0 - views["rf1"]["k2_check_s"]
                             + k2.seconds - c1 - views["rf2"]["k2_check_s"])
        t_close = time.perf_counter()
        views.pop("mv").close()
        views["close_s"] = time.perf_counter() - t_close
        views["step_s"] = time.perf_counter() - t_views
        load["view_slots_after_rf"] = db.engine._merged_view().capacity
        after = kv_ladder(cat, tpch_kv.refreshed_catalog(host, rf), dev,
                          runs)
    launches = {"scan_filter": cuda_scan.scan_filter.launches,
                "merge_path": cuda_merge.merge_perm.launches}
    if k2.pairs != launches["merge_path"]:
        raise AssertionError(f"K2 checked {k2.pairs} merges of "
                             f"{launches['merge_path']} launches")
    log(f"K2 == plain on all {k2.pairs} KV-path merges (largest "
        f"{k2.max_rows} rows)")
    load["engine_bytes_after_rf"] = tpch_kv.engine_bytes(db.engine)
    index = kv_index_phase(host, dev)
    # the cached graphs hold the KV decodes they read by reference
    del cat, db
    dispatch.clear_kernel_cache()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"parity": parity, "load": load,
           "columns": ["median_s", "cold_s", "decode_s", "idle_share",
                       "syncs", "plan_syncs", "kv_scans", "peak_bytes",
                       "resident_bytes"],
           "k2_checked": [k2.pairs, k2.max_rows],
           "host_median_s": {q: host_ladder[q]["median_s"]
                             for q in before if q in host_ladder},
           "before": before, "ops_ms": ops_ms, "rf1": rf1, "rf2": rf2,
           "views": views, "after": after,
           "index": index, "launches": launches, "card": card}
    log("TPC-H SF1 over KV: ladder == oracle before and after RF1/RF2; "
        "index lookups == full scan; checkpoint + WAL reopened")
    emit({"tpch_kv": out},
         {"tpch_kv": {"load_s": load["load_s"],
                      "median_s_before": {q: v[0] for q, v in before.items()},
                      "median_s_after": {q: v[0] for q, v in after.items()},
                      "views": {k: views[k] for k in (
                          "base", "prime_s", "peak_rss_gb", "create_ms")}
                      | {f: {k: views[f][k] for k in (
                          "events", "flush_ms", "dispatches",
                          "d2h_bytes_per_poll")} for f in ("rf1", "rf2")},
                      "launches": launches}})
    return out, launches


# ---------------------------------------------------------------------------
# The SQL front door (sql/parser.py, binder.py, plancache.py, session.py,
# server/pgwire.py, bench/load.py)


class PgClient:
    """A Postgres v3 client over one socket: simple queries, text rows."""

    def __init__(self, addr):
        import socket
        import struct

        self._struct = struct
        self.sock = socket.create_connection(addr, timeout=600)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._buf = bytearray()
        body = struct.pack("!I", 196608) + b"user\x00smoke\x00\x00"
        self.sock.sendall(struct.pack("!I", len(body) + 4) + body)
        self._until_ready()

    def _until_ready(self) -> list:
        """Every message up to ReadyForQuery, read in 64 KB chunks."""
        msgs = []
        buf = self._buf
        off = 0
        while True:
            while len(buf) - off < 5 or len(buf) - off < 1 + int.from_bytes(
                    buf[off + 1:off + 5], "big"):
                c = self.sock.recv(1 << 16)
                if not c:
                    raise ConnectionError("server closed the connection")
                buf += c
            tag = bytes(buf[off:off + 1])
            n = int.from_bytes(buf[off + 1:off + 5], "big")
            msgs.append((tag, bytes(buf[off + 5:off + 1 + n])))
            off += 1 + n
            if tag == b"Z":
                self._buf = buf[off:]
                return msgs

    def query(self, sql: str) -> dict:
        """{column: [text or None]} of one statement; raises on an
        ErrorResponse."""
        st = self._struct
        body = sql.encode() + b"\x00"
        self.sock.sendall(b"Q" + st.pack("!I", len(body) + 4) + body)
        names, rows = [], []
        for tag, body in self._until_ready():
            if tag == b"E":
                raise AssertionError(
                    f"server error: {body.decode(errors='replace')}")
            if tag == b"T":
                off = 2
                for _ in range(st.unpack("!H", body[:2])[0]):
                    end = body.index(b"\x00", off)
                    names.append(body[off:end].decode())
                    off = end + 1 + 18
            elif tag == b"D":
                off, row = 2, []
                for _ in range(st.unpack("!H", body[:2])[0]):
                    ln = st.unpack("!i", body[off:off + 4])[0]
                    off += 4
                    row.append(None if ln < 0
                               else body[off:off + ln].decode())
                    off += max(ln, 0)
                rows.append(row)
        return {n: [r[i] for r in rows] for i, n in enumerate(names)}

    def close(self) -> None:
        self.sock.sendall(b"X" + self._struct.pack("!I", 4))
        self.sock.close()


def wire_arrays(wire: dict, like: dict) -> dict:
    """Text columns from the wire as arrays typed like `like`'s columns
    (its column order): integers and floats parsed, text kept, NULL as
    None."""
    out = {}
    for name, ref in like.items():
        vals = wire[name]
        kind = np.asarray(ref).dtype.kind
        if kind in "iu" and None not in vals:
            out[name] = np.array([int(v) for v in vals], dtype=np.int64)
        elif kind == "f" and None not in vals:
            out[name] = np.array([float(v) for v in vals])
        elif kind == "b" and None not in vals:
            out[name] = np.array([v == "t" for v in vals])
        else:
            out[name] = np.array(vals, dtype=object)
    return out


def wire_mismatch(q: str, wire: dict, want: dict) -> str | None:
    """None when the wire's rows equal `want` (tpch_oracle.mismatch's
    bounds over `want`'s columns)."""
    from cockroach_tpu_torch.bench import tpch_oracle

    missing = [c for c in want if c not in wire]
    if missing:
        return f"{q}: columns {missing} missing on the wire"
    return tpch_oracle.mismatch(q, wire_arrays(wire, want), want)


def q6_text(text: str, discount: float, quantity: int) -> str:
    """q6 with its discount (the BETWEEN's midpoint) and quantity."""
    out = text.replace("between 0.05 and 0.07",
                       f"between {discount - 0.01:.2f} and "
                       f"{discount + 0.01:.2f}")
    return out.replace("< 24", f"< {quantity}")


Q6_LITERALS = ((0.06, 24), (0.05, 25), (0.07, 23))
# the binder's default (heuristic) join order joins q5's customer to its
# supplier on their nation key before orders: about 3.6e10 rows at SF1,
# a 32 GiB emission tile (ROADMAP Queue 3 item 17, as in the reference);
# the cost-based order joins orders first
SQL_JOIN_ORDER = {"q5": "cost"}
SQL_CONCURRENT = ("q1", "q3", "q6", "q18")


def wire_ms(conn, text: str) -> tuple[float, dict]:
    t0 = time.perf_counter()
    got = conn.query(text)
    return (time.perf_counter() - t0) * 1e3, got


def run_sql_phase(card: str, cat, dev="cuda", sessions: int = 8,
                  duration_s: float = 3.0, sf: float = 1.0,
                  hand: dict | None = None) -> dict:
    """The SQL front door on the card over the SF1 host catalog: a
    PgServer on `dev`; one connection sends all 22 TPC-H texts (q5 under
    the cost-based join order, ``SQL_JOIN_ORDER``), each cold,
    again with the plan cache hit (a text that differs by whitespace) and
    verbatim (the memo), every result equal to the hand-built Rel on the
    card (q1, q3, q9, q18 also to the oracle), parse + bind timed in
    process, each plan's device bytes counted, all 22 kept within the
    plan cache's byte budget; q6 rebound with three literal sets captures no new graph and
    equals the cache-off result; 4 connections at once run q1, q3, q6
    (three literal sets) and q18 twice each, equal to one
    connection; then the mixed serving load (bench/load.py) with
    `sessions` sessions for `duration_s` seconds, every acknowledged
    insert read back. Prints the ``{"sql": ...}`` line and returns it."""
    import threading

    from cockroach_tpu_torch.bench import queries as Q
    from cockroach_tpu_torch.bench import tpch_oracle
    from cockroach_tpu_torch.bench.load import run_mixed_load
    from cockroach_tpu_torch.bench.tpch_sql import TPCH_SQL
    from cockroach_tpu_torch.flow import dispatch
    from cockroach_tpu_torch.server.pgwire import PgServer
    from cockroach_tpu_torch.sql import parser as P
    from cockroach_tpu_torch.sql import plancache, sqlstats
    from cockroach_tpu_torch.sql.binder import Binder

    t_phase = time.perf_counter()
    queries = sorted(TPCH_SQL, key=lambda q: int(q[1:]))
    srv = PgServer(catalog=cat, device=dev).serve_background()
    conn = PgClient(srv.addr)
    per_q = {}
    hand = {} if hand is None else hand  # the hand-built results, by query
    held = {}
    cache = plancache.cache_for(cat)
    entries0, evictions0 = len(cache), cache.evictions
    try:
        for q in queries:
            text = TPCH_SQL[q]
            rel = Q.QUERIES[q](cat)
            hand[q] = rel.run()  # warm: its graphs captured
            hand_ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                again = rel.run()
                hand_ms.append((time.perf_counter() - t0) * 1e3)
            bad = tpch_oracle.mismatch(q, again, hand[q])
            if bad is not None:
                raise AssertionError(f"hand-built {q} not repeatable: {bad}")
            order = SQL_JOIN_ORDER.get(q)
            if order is not None:
                conn.query("SET CLUSTER SETTING sql.opt.join_order = "
                           f"'{order}'")
            try:
                pb = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    Binder(cat).bind(P.parse_statement(text))
                    pb.append((time.perf_counter() - t0) * 1e3)
                row = [statistics.median(pb)]
                caps = []
                for variant in (text, text + " ", text + " "):
                    c0 = dispatch.captures()
                    ms, got = wire_ms(conn, variant)
                    caps.append(dispatch.captures() - c0)
                    bad = wire_mismatch(q, got, hand[q])
                    if bad is not None:
                        raise AssertionError(f"SQL {q} over the wire != "
                                             f"hand-built: {bad}")
                    row.append(ms)
            finally:
                if order is not None:
                    conn.query("SET CLUSTER SETTING sql.opt.join_order = "
                               "'heuristic'")
            oracle = tpch_oracle.ORACLES.get(q)
            if oracle is not None:
                bad = wire_mismatch(q, got, oracle(cat))
                if bad is not None:
                    raise AssertionError(f"SQL {q} != oracle: {bad}")
            row.append(statistics.median(hand_ms))
            if caps[2]:
                raise AssertionError(f"SQL {q}: the memo run captured "
                                     f"{caps[2]} graphs")
            row += caps[:2]
            fp = sqlstats.fingerprint(text)
            held[q] = next((e.storages for e in cache.entries()
                            if e.fingerprint == fp), {})
            # what its entry holds, MB
            row.append(round(sum(held[q].values()) / 1e6))
            if torch.device(dev).type == "cuda":
                row.append(round(torch.cuda.memory_reserved() / 1e9))
            per_q[q] = row
        log("SQL: 22 texts over the wire == hand-built (cold, hit, memo), "
            "ladder == oracle, memo captured nothing")
        # each of the 22 plans was cached, and the cache stays within its
        # byte budget, evicting only when the plans' distinct bytes pass
        # it: each storage once, as the cache counts it, from each entry
        # as its query left it, before a later query evicted it (an
        # address freed by an eviction and reused keys apart by its size)
        distinct = {(p, n) for d in held.values() for p, n in d.items()}
        plans = {"entries": len(cache) - entries0,
                 "evictions": cache.evictions - evictions0,
                 "bytes": cache.bytes, "budget": cache.budget(),
                 "held_by_22": sum(n for _, n in distinct)}
        budget = plans["budget"]  # None off the card: no byte bound
        if (plans["entries"] + plans["evictions"] != len(queries)
                or (budget is not None and cache.bytes > budget)
                or (plans["evictions"] and (
                    budget is None or plans["held_by_22"] <= budget))):
            raise AssertionError(f"the 22 plans not cached within the "
                                 f"budget: {plans}")
        log(f"SQL: the 22 plans hold {plans['held_by_22']} device bytes, "
            f"{cache.bytes} cached, budget {plans['budget']}, "
            f"{plans['evictions']} evicted")
        # q6 rebound: one cache entry, no new capture after the first run
        entries0 = len(cache)
        q6 = {}
        caps = []
        for disc, qty in Q6_LITERALS:
            _, q6[(disc, qty)] = wire_ms(
                conn, q6_text(TPCH_SQL["q6"], disc, qty))
            caps.append(dispatch.captures())
        if len(set(caps)) != 1:
            raise AssertionError(f"q6 rebinds captured graphs: {caps}")
        if len(cache) != entries0:
            raise AssertionError("q6 rebinds made new cache entries")
        conn.query("SET CLUSTER SETTING sql.plan_cache.enabled = false")
        try:
            for (disc, qty), got in q6.items():
                want = conn.query(q6_text(TPCH_SQL["q6"], disc, qty))
                if got != want:
                    raise AssertionError(
                        f"q6 ({disc}, {qty}) cached {got} != uncached "
                        f"{want}")
        finally:
            conn.query("SET CLUSTER SETTING sql.plan_cache.enabled = true")
        if len({v["revenue"][0] for v in q6.values()}) != 3:
            raise AssertionError("q6's three literal sets gave equal results")
        log("SQL q6 rebound x3: one entry, no capture, == cache off")
        # 4 connections at once against one
        texts = [TPCH_SQL["q1"], TPCH_SQL["q3"], TPCH_SQL["q18"]] + [
            q6_text(TPCH_SQL["q6"], d, n) for d, n in Q6_LITERALS]
        reps = 2
        single = [conn.query(t) for t in texts]
        t0 = time.perf_counter()
        for _ in range(reps):
            for t in texts:
                conn.query(t)
        one_s = time.perf_counter() - t0
        outs, errs = [], []

        def client():
            c = PgClient(srv.addr)
            try:
                for _ in range(reps):
                    outs.append([c.query(t) for t in texts])
            except Exception as e:  # noqa: BLE001 - re-raised below
                errs.append(e)
            finally:
                c.close()

        threads = [threading.Thread(target=client) for _ in range(4)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        four_s = time.perf_counter() - t0
        if errs:
            raise errs[0]
        if len(outs) != 4 * reps or any(o != single for o in outs):
            raise AssertionError("4 concurrent connections != one")
        log(f"SQL 4 connections x {reps} x {len(texts)} statements == one "
            "connection")
    finally:
        conn.close()
        srv.close()
    # dropping the cached plans hands their device bytes back
    plans["bytes_at_end"] = cache.bytes
    if torch.device(dev).type == "cuda":
        a0 = torch.cuda.memory_allocated()
        cache.clear()
        plans["freed_by_clear"] = a0 - torch.cuda.memory_allocated()
    load = run_mixed_load(sessions=sessions, duration_s=duration_s, sf=sf,
                          device=dev, catalog=cat)
    if not load["readback_ok"] or load["errors"] or load["threads_alive"]:
        raise AssertionError(f"mixed load failed: {load}")
    log(f"mixed load: {sessions} sessions x {duration_s:g}s, every insert "
        "read back")
    out = {"columns": ["parse_bind_ms", "cold_ms", "warm_ms", "memo_ms",
                       "handbuilt_ms", "cold_captures", "warm_captures",
                       "entry_mb", "reserved_gb"],
           **per_q,
           "plan_cache": plans,
           # graphs captured by the 2nd and 3rd literal sets (0)
           "q6_rebind_captures": caps[-1] - caps[0],
           # one connection's share alone, and 4 connections at once
           "concurrent": {"statements_per_conn": reps * len(texts),
                          "one_conn_s": one_s, "four_conns_s": four_s},
           "load": {k: load.get(k) for k in (
               "sessions", "duration_s", "ops_per_sec", "point_ops_per_sec",
               "inserts_per_sec", "analytic_ops_per_sec", "conflicts",
               "p99_queue_wait_ms", "p99_exec_wait_ms", "p99_stmt_ms",
               "p99_point_ms", "p99_analytic_ms", "peak_bytes",
               "device_peak_bytes", "inserted_keys", "missing_inserts")},
           "phase_s": time.perf_counter() - t_phase, "card": card}
    emit({"sql": out},
         {"sql": {"warm_ms": {q: r[2] for q, r in per_q.items()},
                  "plan_cache_gb": plans["bytes"] / 1e9,
                  "q6_rebind_captures": out["q6_rebind_captures"],
                  "load_ops_per_sec": load.get("ops_per_sec"),
                  "p99_stmt_ms": load.get("p99_stmt_ms"),
                  "phase_s": out["phase_s"]}})
    return out


# ---------------------------------------------------------------------------
# The warm menu (sql/warmmenu.py), statement diagnostics (sql/diagnostics.py)
# and the rest of crdb_internal, behind a PgServer

MENU_BUDGET_S = 600.0  # the menu's wall budget here (the setting's default
# is 30 s, less than the 22 texts' cold runs at SF1 take)
NEW_VTABLES = ("crdb_internal.node_metrics",
               "crdb_internal.node_inflight_trace_spans",
               "crdb_internal.cluster_load",
               "crdb_internal.node_warmup_menu")


def _join_order(conn, q: str, reset: bool = False) -> None:
    """q's join order (SQL_JOIN_ORDER) set over `conn`, or reset."""
    order = SQL_JOIN_ORDER.get(q)
    if order is not None:
        conn.query("SET CLUSTER SETTING sql.opt.join_order = "
                   f"'{'heuristic' if reset else order}'")


def run_menu_phase(card: str, cat, dev="cuda", warmup_sf: float = 0.05,
                   hand: dict | None = None) -> dict:
    """The warm menu on the card over a fresh copy of the SF1 host catalog
    (no device columns, no cached plan, no shared graph: a server's cold
    start): a PgServer with ``sql.warmup.menu.enabled`` builds its menu,
    the 22 TPC-H texts as the explicit course, before it accepts a
    connection; every item's status, runs and captures, and the cache's
    bytes (what each entry holds) against its budget, none evicted and
    none at 0 bytes; then over the wire three serving runs of each text,
    each run's ms and new captures (0 for every compiled item) and its
    result equal to the hand-built plan (q1, q3, q9, q18 also to the
    oracle); EXPLAIN ANALYZE (DEBUG) of q3 and its bundle's sections; the
    four new crdb_internal tables' row counts; then bench/warmup's cold
    A/B at `warmup_sf` in two processes. q5 runs under the cost-based
    join order (SQL_JOIN_ORDER; its default order cannot run at SF1,
    ROADMAP Queue 3 item 17): its menu item carries that setting, and
    it is first on the menu (its capture needs the most memory). Prints
    the ``{"menu": ...}`` line."""
    import gc

    from cockroach_tpu_torch.bench import queries as Q
    from cockroach_tpu_torch.bench import tpch_oracle
    from cockroach_tpu_torch.bench.tpch_sql import TPCH_SQL
    from cockroach_tpu_torch.bench.warmup import run_warmup_ab
    from cockroach_tpu_torch.flow import dispatch
    from cockroach_tpu_torch.server.pgwire import PgServer
    from cockroach_tpu_torch.sql import (diagnostics, plancache, sqlstats,
                                         warmmenu)
    from cockroach_tpu_torch.sql.session import Session
    from cockroach_tpu_torch.utils import settings

    t_phase = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    # the earlier phases' plans and graphs go first
    plancache.cache_for(cat).clear()
    dispatch.clear_kernel_cache()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    fresh = host_twin(cat)
    queries = sorted(TPCH_SQL, key=lambda q: int(q[1:]))
    cache = plancache.cache_for(fresh)
    warmmenu.reset()
    settings.set("sql.warmup.menu.enabled", True)
    settings.set("sql.warmup.menu.budget_s", MENU_BUDGET_S)
    served: dict = {}
    try:
        t0 = time.perf_counter()
        boot = Session(catalog=fresh, device=dev)
        boot.close()
        menu = [(TPCH_SQL[q], {"sql.opt.join_order": order})
                for q, order in SQL_JOIN_ORDER.items()]
        menu += [TPCH_SQL[q] for q in queries if q not in SQL_JOIN_ORDER]
        srv = PgServer(catalog=fresh, db=boot.db, device=dev, menu=menu)
        build_s = time.perf_counter() - t0
        srv.serve_background()
        rows = {r["fingerprint"]: r for r in warmmenu.menu_rows()}
        item = {q: rows[sqlstats.fingerprint(TPCH_SQL[q])] for q in queries}
        held = {e.fingerprint: e.bytes for e in cache.entries()}
        log("menu items (status, runs, captures, MB held): " + json.dumps(
            {q: [item[q]["status"][:4], item[q]["runs"],
                 item[q]["captures"],
                 round(held.get(item[q]["fingerprint"], 0) / 1e6)]
             for q in queries}, separators=(",", ":")))
        plans = {"entries": len(cache), "bytes": cache.bytes,
                 "budget": cache.budget(), "evictions": cache.evictions,
                 "entry_gb_max": max((e.bytes for e in cache.entries()),
                                     default=0) / 1e9,
                 "zero_byte_entries": sum(1 for e in cache.entries()
                                          if e.bytes == 0)}
        courses: dict = {}
        for r in rows.values():
            k = f"{r['source']}_{r['status']}"
            courses[k] = courses.get(k, 0) + 1
        log(f"menu: built in {build_s:.1f}s, items {courses}, cache "
            f"{cache.bytes / 1e9:.2f} of {(plans['budget'] or 0) / 1e9:.2f}"
            f" GB, {plans['zero_byte_entries']} entries at 0 bytes")
        conn = PgClient(srv.addr)
        try:
            for q in queries:
                runs = []
                _join_order(conn, q)
                try:
                    for _ in range(3):
                        c0 = (dispatch.captures() if on_card
                              else dispatch.compiles())
                        ms, got = wire_ms(conn, TPCH_SQL[q])
                        c1 = (dispatch.captures() if on_card
                              else dispatch.compiles())
                        runs.append((ms, c1 - c0, got))
                finally:
                    _join_order(conn, q, reset=True)
                served[q] = runs
            explain = conn.query("EXPLAIN ANALYZE (DEBUG) " + TPCH_SQL["q3"])
            last = explain["info"][-1]
            if not last.startswith("diagnostics bundle: "):
                raise AssertionError(f"EXPLAIN ANALYZE (DEBUG): {last}")
            bundle_id = int(last.split(": ")[1])
            bundle = diagnostics.get(bundle_id)
            if bundle is None or bundle["trace"] is None:
                raise AssertionError(f"bundle {bundle_id} missing its trace")
            vtables = {}
            for name in NEW_VTABLES:
                got = conn.query(f"select * from {name}")
                vtables[name.split(".")[1]] = len(next(iter(got.values())))
        finally:
            conn.close()
            srv.close()
        per_q = {}
        bad = []
        for q in queries:
            # the SQL phase's hand-built results over the same tables, or
            # made here after serving (cold wrappers while it served)
            want = (hand[q] if hand and q in hand
                    else Q.QUERIES[q](fresh).run())
            oracle = tpch_oracle.ORACLES.get(q)
            owant = oracle(fresh) if oracle is not None else None
            eq = []
            for _, _, got in served[q]:
                ok = wire_mismatch(q, got, want) is None
                if owant is not None:
                    ok = ok and wire_mismatch(q, got, owant) is None
                eq.append(ok)
            r = item[q]
            per_q[q] = [r["status"], r["runs"], r["captures"],
                        round(r["seconds"], 3)] + [
                x for ms, caps, _ in served[q] for x in (ms, caps)] + [
                all(eq)]
            if not all(eq):
                bad.append(f"{q} != hand-built or oracle")
            if r["status"] == "compiled" and any(
                    caps for _, caps, _ in served[q]):
                bad.append(f"{q} captured "
                           f"{[c for _, c, _ in served[q]]} after the menu")
        if plans["evictions"] or plans["zero_byte_entries"] or (
                plans["budget"] is not None
                and plans["bytes"] > plans["budget"]):
            bad.append(f"plan cache after the menu: {plans}")
        if bad:
            raise AssertionError("menu: " + "; ".join(bad))
    finally:
        for name in ("sql.warmup.menu.enabled", "sql.warmup.menu.budget_s"):
            settings.reset(name)
    log("menu: 22 texts x 3 serving runs == hand-built (ladder == oracle), "
        "no compiled item captured a graph while serving; EXPLAIN ANALYZE "
        f"(DEBUG) bundle {bundle_id}; vtables {vtables}")
    cache.clear()
    del fresh
    warm = run_warmup_ab(sf=warmup_sf, device=dev)
    if not warm["menu_oracle_ok"] or warm["on"]["serving_compiles"]:
        raise AssertionError(f"warmup A/B: checksums equal "
                             f"{warm['menu_oracle_ok']}, on-mode serving "
                             f"compiles {warm['on']['serving_compiles']}")
    cold = {m: {k: warm[m].get(k) for k in (
        "statements", "cold_s", "serving_compiles", "serving_captures",
        "menu_build_s", "menu_kernels", "menu_hits")} for m in ("off", "on")}
    log(f"warmup A/B sf={warmup_sf:g}: checksums equal, cold "
        f"{cold['off']['cold_s']}s -> {cold['on']['cold_s']}s")
    out = {"columns": ["status", "runs", "menu_captures", "menu_s",
                       "ms1", "caps1", "ms2", "caps2", "ms3", "caps3",
                       "equal"],
           **per_q,
           "join_order": SQL_JOIN_ORDER, "build_s": build_s,
           "items": courses, "plan_cache": plans,
           "warmup_cold": {**cold, "sf": warmup_sf,
                           "cold_menu_speedup": warm["cold_menu_speedup"]},
           "explain_debug": {"bundle": bundle_id,
                             "sections": sorted(bundle)},
           "vtables": vtables,
           "phase_s": time.perf_counter() - t_phase, "card": card}
    emit({"menu": out},
         {"menu": {"build_s": build_s, "items": courses,
                   "cache_gb": plans["bytes"] / 1e9,
                   "budget_gb": (plans["budget"] or 0) / 1e9,
                   "serving_ms": {q: statistics.median(
                       [ms for ms, _, _ in served[q]]) for q in queries},
                   "serving_captures": sum(c for q in queries
                                           for _, c, _ in served[q]),
                   "cold_menu_speedup": warm["cold_menu_speedup"],
                   "bundle": bundle_id, "vtables": vtables,
                   "phase_s": out["phase_s"]}})
    return out


# ---------------------------------------------------------------------------
# TPC-C (bench/tpcc.py) over the session's KV engine

# roachtest's local repro configuration (pkg/cmd/roachtest/tests/
# tpcc.go:1107-1157, BASELINE.md) runs 12 warehouses at the spec's
# cardinalities. The load parses and encodes every row's SQL text on the
# host, about 16 s a warehouse on the card's machine (96 s for 6), and
# each transaction's time grows with the tables, so the default run's
# time budget, not the load, sets W and the transaction count (PERF.md §4)
TPCC_W = 3
TPCC_SPEC = {"districts": 10, "customers": 3000, "items": 100_000}
TPCC_TXNS = 100
TPCC_SMALL = {"warehouses": 2, "districts": 4, "customers": 30,
              "items": 1000}
TPCC_SMALL_TXNS = 60
TPCC_TABLES = {"warehouse": "w_id", "district": "d_pk", "customer": "c_pk",
               "orders": "o_pk", "new_order": "no_pk",
               "order_line": "ol_pk", "item": "i_id", "stock": "s_pk"}


def tpcc_state(sess) -> dict:
    """Every TPC-C table, ordered by its primary key."""
    return {t: sess.execute(f"select * from {t} order by {pk}")
            for t, pk in TPCC_TABLES.items()}


def same_tables(a: dict, b: dict) -> str | None:
    """None when two tpcc_state snapshots are equal row for row."""
    for t in TPCC_TABLES:
        if list(a[t]) != list(b[t]):
            return f"{t}: columns {list(a[t])} != {list(b[t])}"
        for c in a[t]:
            if not np.array_equal(np.asarray(a[t][c]), np.asarray(b[t][c])):
                return f"{t}.{c} differs"
    return None


def tpcc_load(sess, **sizes) -> tuple[float, float]:
    """bench/tpcc.load with IO pacing off, as for a bulk import, then a
    flush and a full compaction; returns the two parts' seconds."""
    from cockroach_tpu_torch.bench import tpcc
    from cockroach_tpu_torch.utils import settings

    settings.set("admission.io_pacing.enabled", False)
    try:
        t0 = time.perf_counter()
        tpcc.load(sess, **sizes)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sess.db.engine.flush()
        sess.db.engine.compact(bottom=True)
    finally:
        settings.reset("admission.io_pacing.enabled")
    return load_s, time.perf_counter() - t0


def tpcc_small_state(device: str, threads: int | None = None) -> dict:
    """The small TPC-C run on `device` (TPCC_SMALL loaded, TPCC_SMALL_TXNS
    transactions at seed 0, the consistency checks); its final tables."""
    from cockroach_tpu_torch.bench import tpcc
    from cockroach_tpu_torch.sql import Session

    if threads is not None:
        torch.set_num_threads(threads)
    s = Session(val_width=256, device=device)
    try:
        tpcc_load(s, **TPCC_SMALL)
        tpcc.run_mix(s, txns=TPCC_SMALL_TXNS, seed=0, **TPCC_SMALL)
        tpcc.check_consistency(s, warehouses=TPCC_SMALL["warehouses"],
                               districts=TPCC_SMALL["districts"])
        return tpcc_state(s)
    finally:
        s.close()


def run_tpcc_phase(card: str, dev="cuda", warehouses: int = TPCC_W,
                   txns: int = TPCC_TXNS) -> dict:
    """TPC-C on the card through bench/tpcc.py: the load at the spec's
    cardinalities with `warehouses` warehouses into one session's KV
    engine (IO pacing off for the load, as for a bulk import; a flush
    and a full compaction after it), ``run_mix(txns, seed=0)`` at the
    spec's mix with each NewOrder call timed here, ``check_consistency``;
    then a small run (TPCC_SMALL, TPCC_SMALL_TXNS transactions) on the
    card and on the CPU, their final states equal row for row. The CPU's
    small run goes in a process of its own on one thread, beside the
    load. Prints the ``{"tpcc": ...}`` line."""
    import concurrent.futures
    import multiprocessing

    from cockroach_tpu_torch.bench import tpcc
    from cockroach_tpu_torch.bench.load import (_hist_snapshot,
                                                hist_quantile_from_deltas)
    from cockroach_tpu_torch.sql import Session
    from cockroach_tpu_torch.utils import metric

    t_phase = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    on_cpu = pool.submit(tpcc_small_state, "cpu", 1)
    sess = Session(val_width=256, device=dev)
    load_s, compact_s = tpcc_load(sess, warehouses=warehouses, **TPCC_SPEC)
    log(f"TPC-C W={warehouses}: loaded in {load_s:.1f}s, compacted in "
        f"{compact_s:.1f}s")
    no_ms: list = []
    new_order = tpcc.new_order

    def timed_new_order(*a, **k):
        t = time.perf_counter()
        try:
            return new_order(*a, **k)
        finally:
            no_ms.append((time.perf_counter() - t) * 1e3)

    hist = metric.EXEC_LOCK_WAIT_SECONDS
    ex0, _ = _hist_snapshot(hist)
    tpcc.new_order = timed_new_order
    try:
        mix = tpcc.run_mix(sess, txns=txns, warehouses=warehouses,
                           seed=0, **TPCC_SPEC)
    finally:
        tpcc.new_order = new_order
    ex1, _ = _hist_snapshot(hist)
    t0 = time.perf_counter()
    tpcc.check_consistency(sess, warehouses=warehouses,
                           districts=TPCC_SPEC["districts"])
    check_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else None
    sess.close()
    del sess
    log(f"TPC-C W={warehouses}: {txns} transactions, consistency holds")
    try:
        card_state = tpcc_small_state(dev)
        cpu_state = on_cpu.result(timeout=900)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    bad = same_tables(card_state, cpu_state)
    if bad is not None:
        raise AssertionError(f"TPC-C small run, card != CPU: {bad}")
    log(f"TPC-C small run ({TPCC_SMALL_TXNS} txns): card == CPU, "
        "row for row")
    out = {"warehouses": warehouses, **TPCC_SPEC, "load_s": load_s,
           "compact_s": compact_s, "txns": txns, "counts": mix["counts"],
           "tpmC": mix["tpmC"], "mix_s": mix["elapsed_s"],
           "new_order_p50_ms": float(np.percentile(no_ms, 50)),
           "new_order_p99_ms": float(np.percentile(no_ms, 99)),
           "retries": mix["retries"], "give_ups": mix["give_ups"],
           "exec_lock_p99_ms": 1e3 * hist_quantile_from_deltas(
               hist.buckets, ex0, ex1, 0.99),
           "check_s": check_s, "device_peak_bytes": peak,
           "small_card_eq_cpu": True,
           "phase_s": time.perf_counter() - t_phase, "card": card}
    emit({"tpcc": out})
    return out


# ---------------------------------------------------------------------------
# Materialized views and the changefeed fan-out (flow/viewmaint.py,
# sql/matview.py, kv/changefeed.py, kv/fanout.py; bench/views.py and
# bench/fanout.py, bench.py's `views` and `fanout` jobs)

VIEWS_N, VIEWS_ROUNDS, VIEWS_WRITES = 1000, 8, 64
FANOUT_SUBSCRIBERS = 1000
FANOUT_DURATION_S = 5.0  # bench.py's 10 s, cut by the default run's budget


def run_views_phase(card: str, dev="cuda", views: int = VIEWS_N,
                    rounds: int = VIEWS_ROUNDS) -> dict:
    """bench/views.run_views on the card: `views` standing views in one
    shape class over a 240-row KV table, `rounds` rounds of 64 writes
    (60% inserts, 30% updates, 10% deletes, seed 7), one flush a round.
    Fails unless every flush took at most one dispatch, no steady flush
    rescanned the base table, and the sampled views equal fresh rescans.
    K2 merges on the path (none: the session's keys are 24 bytes) are
    witnessed. Prints the ``{"views": ...}`` line."""
    from cockroach_tpu_torch.bench.views import run_views

    t0 = time.perf_counter()
    with K2Witness() as k2:
        r = run_views(views=views, rounds=rounds,
                      writes_per_round=VIEWS_WRITES, device=dev)
    r.update(phase_s=time.perf_counter() - t0, k2_checked=k2.pairs,
             card=card)
    ok = (r["views_dispatch_ok"] and r["views_oracle_ok"]
          and r["dispatches_per_flush_max"] <= 1
          and r["full_rescans_steady"] == 0)
    if not ok:
        raise AssertionError(f"views bench failed its gates: {r}")
    log(f"views: {views} views, {rounds} flushes of <= 1 dispatch, "
        "sampled views == fresh rescans")
    keys = ("setup_s", "steady_s", "refresh_lag_p50_ms",
            "refresh_lag_p99_ms", "dispatches_per_flush_mean",
            "dispatches_per_flush_max", "captures_per_flush_after_first",
            "full_rescans_steady", "minmax_rescans_steady",
            "exec_lock_wait_p99_s", "views_dispatch_ok", "views_oracle_ok")
    emit({"views": r}, {"views": {k: r[k] for k in keys}})
    return r


def run_fanout_phase(card: str, dev="cuda",
                     subscribers: int = FANOUT_SUBSCRIBERS,
                     duration_s: float = FANOUT_DURATION_S) -> dict:
    """bench/fanout.run_fanout on the card: `subscribers` subscribers
    (20 never read behind 4 KB socket buffers, 20 dropped mid-stream and
    reconnected from their frontier, the rest fast) over 32 keys, 30
    transactions of 8 puts. Fails unless the sampled and reconnected
    streams equal the changefeed history and the staging account drained
    to 0 after close. K2 merges on the path are witnessed. Prints the
    ``{"fanout": ...}`` line."""
    from cockroach_tpu_torch.bench.fanout import run_fanout

    t0 = time.perf_counter()
    with K2Witness() as k2:
        r = run_fanout(subscribers=subscribers, duration_s=duration_s,
                       device=dev)
    r.update(duration_s=duration_s, phase_s=time.perf_counter() - t0,
             k2_checked=k2.pairs, card=card)
    if not r["fanout_oracle_ok"] or r["staging_bytes_after_close"] != 0:
        raise AssertionError(f"fanout bench failed its gates: {r}")
    log(f"fanout: {r['subscribers_sustained']} of {r['subscribers']} "
        "subscribers sustained; streams == history; staging drained to 0")
    emit({"fanout": r})
    return r


# the SF10 scaling of the sf=0.01 parity run: every size threshold over
# 1000, the dense LUT's key bits 24 -> 14, so each table and key range
# stands to its threshold as at SF10
SF10_SCALING = {
    "sql.distsql.scan_stream_rows": (1 << 23) // 1000,
    "sql.distsql.workmem_rows": (1 << 21) // 1000,
    "sql.distsql.workmem_bytes": (2 << 30) // 1000,
    "sql.distsql.tile_size": (1 << 20) // 1000,
    "sql.distsql.dense_agg_states": (1 << 23) // 1000,
    "sql.distsql.dense_lut_bits": 14,
}


def check_sf10_scaling_parity(dev, sf: float = 0.01) -> dict:
    """All 22 queries at `sf` under the SF10 scaling, on the card against
    the CPU through ``optimized_plan()``: equal results, and the same
    scans streamed and the same operators spilled to the same external
    operators on both. Returns {query: (streamed, spills)}."""
    from cockroach_tpu_torch.bench import queries as Q
    from cockroach_tpu_torch.bench import tpch_oracle
    from cockroach_tpu_torch.bench.tpch import gen_tpch
    from cockroach_tpu_torch.flow.runtime import io_report, run_operator
    from cockroach_tpu_torch.plan import builder
    from cockroach_tpu_torch.utils import settings

    for n, v in SF10_SCALING.items():
        settings.set(n, v)
    try:
        runs = []
        for d in (dev, "cpu"):
            cat = gen_tpch(sf=sf, seed=TPCH_SEED, device=d)
            res = {}
            for q in Q.QUERIES:
                root = builder.build(Q.QUERIES[q](cat).optimized_plan(), cat)
                out = run_operator(root)
                rep = io_report(root)
                res[q] = (out, (rep["streamed"], rep["spills"]))
            runs.append(res)
    finally:
        settings.reset()
    shapes = {}
    for q in Q.QUERIES:
        (got, gs), (want, ws) = runs[0][q], runs[1][q]
        bad = tpch_oracle.mismatch(q, got, want)
        if bad is not None:
            raise AssertionError(f"SF10 scaling, sf={sf}: card != CPU: {bad}")
        if gs != ws:
            raise AssertionError(f"SF10 scaling {q}: card streamed/spilled "
                                 f"{gs}, CPU {ws}")
        shapes[q] = gs
    log(f"SF10 scaling at sf={sf}: all 22 queries on the card equal the "
        "CPU's, with the same streamed scans and spills")
    return shapes


def forced_spill(cat, q: str, setting: str, value: int, want) -> dict:
    """Run `q` over `cat` with `setting` lowered to `value`: its result
    must equal `want` (the default run's); returns what spilled."""
    from cockroach_tpu_torch.bench import queries as Q
    from cockroach_tpu_torch.bench import tpch_oracle
    from cockroach_tpu_torch.flow.runtime import io_report, run_operator
    from cockroach_tpu_torch.plan import builder
    from cockroach_tpu_torch.utils import settings

    settings.set(setting, value)
    try:
        root = builder.build(Q.QUERIES[q](cat).optimized_plan(), cat)
        t0 = time.perf_counter()
        got = run_operator(root)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        settings.reset(setting)
    bad = tpch_oracle.mismatch(q, got, want)
    if bad is not None:
        raise AssertionError(f"{q} with {setting}={value} != default: {bad}")
    return {"setting": setting, "value": value, "s": secs,
            **io_report(root)}


def run_sf10_phase(card: str, fusion: dict, sf: float = 10.0,
                   dev="cuda") -> dict:
    """TPC-H at SF10, BASELINE config #2's scale: the SF10-scaling parity
    run at sf=0.01, then SF10 generated (seed 19920101) and q3, q9, q18
    timed through run_tpch (every run held to the numpy oracle) and
    profiled once; q7 and q21 cold and warm (warm equal to cold); q3 with
    workmem_bytes lowered until its orders build spills to the Grace hash
    join, and q9 and q7 with workmem_rows at its floor, each equal to its
    default run. Returns the figures and the SF10 catalog."""
    from cockroach_tpu_torch.bench import queries as Q
    from cockroach_tpu_torch.bench.tpch import gen_tpch
    from cockroach_tpu_torch.bench.tpch_run import peak_rss_bytes, run_tpch
    from cockroach_tpu_torch.flow.runtime import run_operator
    from cockroach_tpu_torch.plan import builder

    t_phase = time.perf_counter()
    shapes = check_sf10_scaling_parity(torch.device(dev))
    fusion["sf10_scaling_sf0.01_22"] = check_fusion22(
        torch.device(dev), 0.01, scaling=SF10_SCALING)
    t0 = time.perf_counter()
    cat = gen_tpch(sf=sf, seed=TPCH_SEED, device=dev)
    gen_s = time.perf_counter() - t0
    gen_rss = peak_rss_bytes()
    log(f"SF{sf:g} generated {gen_s:.1f}s")
    ladder = ("q3", "q9", "q18")
    res = run_tpch(ladder, sf=sf, seed=TPCH_SEED, runs=DEPTH_RUNS, device=dev,
                   catalog=cat)
    profiles = {}
    for q in ladder:
        root = builder.build(Q.QUERIES[q](cat).optimized_plan(), cat)
        profiles[q] = device_profile(lambda root=root: run_operator(root))
        res[q] = brief(res[q])
        res[q]["idle_share"] = profiles[q]["idle_share"]
        res[q]["device_busy_s"] = profiles[q]["device_busy_s"]
        res[q]["top_device_ops"] = profiles[q]["top_device_ops"]
    ext = run_tpch(("q7", "q21"), sf=sf, seed=TPCH_SEED, runs=0,
                   device=dev, catalog=cat)
    if not any("GraceAggregateOp" in s for s in ext["q21"]["spills"]):
        raise AssertionError(f"q21 at SF{sf:g} did not spill its DISTINCT: "
                             f"{ext['q21']['spills']}")
    defaults = {q: run_operator(builder.build(
        Q.QUERIES[q](cat).optimized_plan(), cat)) for q in ("q3", "q7", "q9")}
    # 64 MiB at SF10: q3's orders build (about 1.4 M rows) passes it
    # within a few tiles, while each Grace partition's build fits it
    budget = max(1 << 16, int((64 << 20) * sf / 10))
    forced = {
        "q3_grace_join": forced_spill(cat, "q3", "sql.distsql.workmem_bytes",
                                      budget, defaults["q3"]),
        "q9_workmem_rows_floor": forced_spill(
            cat, "q9", "sql.distsql.workmem_rows", 1024, defaults["q9"]),
        "q7_external_sort": forced_spill(
            cat, "q7", "sql.distsql.workmem_rows", 1024, defaults["q7"]),
    }
    if "HashJoinOp->GraceHashJoinOp" not in forced["q3_grace_join"]["spills"]:
        raise AssertionError("q3's build did not spill to the Grace join: "
                             f"{forced['q3_grace_join']['spills']}")
    if "SortOp->ExternalSortOp" not in forced["q7_external_sort"]["spills"]:
        raise AssertionError("q7's sort did not spill: "
                             f"{forced['q7_external_sort']['spills']}")
    out = {"sf": sf, "lineitem_rows": res["lineitem_rows"], "gen_s": gen_s,
           "gen_peak_rss_bytes": gen_rss,
           **{q: res[q] for q in ladder},
           **{q: brief(ext[q]) for q in ("q7", "q21")},
           "forced": forced, "sf10_scaling_sf0.01_22": shapes,
           "phase_s": time.perf_counter() - t_phase, "card": card}
    log(f"SF{sf:g}: ladder equal to the oracle, forced spills equal the "
        f"default runs, {out['phase_s']:.0f}s")
    emit({"tpch_sf10": out},
         {"tpch_sf10": {**{q: res[q]["median_s"] for q in ladder},
                        **{q: ext[q]["warm_s"] for q in ("q7", "q21")},
                        "gen_s": gen_s, "phase_s": out["phase_s"]}})
    fusion[f"sf{sf:g}"] = fusion_compare(cat, runs=DEPTH_RUNS)
    log(f"SF{sf:g} fusion: q3 q9 q18 fused == unfused")
    return out, cat


# ---------------------------------------------------------------------------
# the SPMD plane: Rel.run_distributed over meshes of shards on the card

DIST_SEED = 11  # tests/test_distsql.py's catalog
DIST_MESHES = (1, 3, 8)
DIST_QUERIES = ("q3", "q9", "q18")
DIST_RTOL = 1e-9  # tests/test_distsql.py's bound: shard-order FLOAT sums
DIST_COLUMNS = ["median_s", "cold_s", "idle_share", "dispatches",
                "attempts", "factor", "a2a_rows", "upload_s",
                "peak_bytes", "peak_reserved_bytes", "single_median_s"]


def skewed_window(cat):
    """tests/test_distsql.py's retry case: one window partition over all
    of lineitem, so one shard receives every row and the first attempts'
    buckets overflow."""
    from cockroach_tpu_torch.coldata.types import INT64
    from cockroach_tpu_torch.ops import expr as ex
    from cockroach_tpu_torch.sql.rel import Rel

    rel = Rel.scan(cat, "lineitem", ("l_orderkey", "l_quantity"))
    rel = rel.project([("k", ex.Const(7, INT64)), ("o", ex.ColRef(0)),
                       ("q", ex.ColRef(1))])
    return rel.window(["k"], [("o", False)], [("s", "sum", "q")])


def check_distsql_parity(dev, sf: float = 0.01) -> dict:
    """All 22 queries at `sf` (seed 11) through DistributedQuery on meshes
    of 1, 3 and 8 shards on the card, each equal to the single-device
    card run, the 8-shard runs equal to the CPU's 8-shard runs with the
    same capacity factor, explain_distributed equal to the CPU's text;
    the skewed-window retry ending at the CPU's factor."""
    from cockroach_tpu_torch.bench import queries as Q
    from cockroach_tpu_torch.bench.tpch import gen_tpch
    from cockroach_tpu_torch.flow import dispatch
    from cockroach_tpu_torch.parallel.mesh import make_mesh
    from cockroach_tpu_torch.parallel.planner import DistributedQuery

    t0 = time.perf_counter()
    card = gen_tpch(sf=sf, seed=DIST_SEED, device=dev)
    cpu = gen_tpch(sf=sf, seed=DIST_SEED, device="cpu")
    meshes = {d: make_mesh(d, device=dev) for d in DIST_MESHES}
    cpu8 = make_mesh(8, device="cpu")
    caps = dispatch.captures()
    retried = {}
    for q in sorted(Q.QUERIES):
        rel, crel = Q.QUERIES[q](card), Q.QUERIES[q](cpu)
        if rel.explain_distributed() != crel.explain_distributed():
            raise AssertionError(f"{q}: explain_distributed card != CPU")
        want = rel.run()
        factors = []
        for d, mesh in meshes.items():
            dq = DistributedQuery(rel.plan, card, mesh)
            got = dq.run()
            bad = first_difference(got, want, rtol=DIST_RTOL)
            if bad is not None:
                raise AssertionError(
                    f"{q} over {d} shards != one device on the card: {bad}")
            factors.append(dq.factor)
        cq = DistributedQuery(crel.plan, cpu, cpu8)
        bad = first_difference(got, cq.run(), rtol=DIST_RTOL)
        if bad is not None or cq.factor != factors[-1]:
            raise AssertionError(f"{q} over 8 shards card != CPU: {bad}, "
                                 f"factor {factors[-1]} vs {cq.factor}")
        if max(factors) > 1:
            retried[q] = factors
    skew = {}
    for name, c, mesh in (("card", card, meshes[8]), ("cpu", cpu, cpu8)):
        rel = skewed_window(c)
        dq = DistributedQuery(rel.plan, c, mesh)
        skew[name] = (dq.run(), dq.factor, dq.attempts)
    if skew["card"][1] != skew["cpu"][1] or skew["card"][1] == 1:
        raise AssertionError(f"skewed retry: factor {skew['card'][1]} on the "
                             f"card, {skew['cpu'][1]} on the CPU")
    if sorted_rows(skew["card"][0]) != sorted_rows(skew["cpu"][0]):
        raise AssertionError("skewed retry: card rows != CPU rows")
    out = {"sf": sf, "queries": len(Q.QUERIES), "meshes": list(DIST_MESHES),
           "retried": retried, "skew_factor": skew["card"][1],
           "skew_attempts": skew["card"][2],
           "captures": dispatch.captures() - caps,
           "s": time.perf_counter() - t0}
    log(f"distsql: 22 queries over {list(DIST_MESHES)} shards equal one "
        f"device, 8 shards equal the CPU, skewed retry factor "
        f"{out['skew_factor']} on both, {out['s']:.0f}s")
    return out


def dist_runs(cat, shards: int, single: dict, queries=DIST_QUERIES,
              runs: int = 1, dev="cuda") -> dict:
    """`queries` over `shards` shards (bench/tpch_dist.run_dist, every
    run held to the oracle), one more run of each profiled; compact rows
    of DIST_COLUMNS, the single-device median beside them."""
    from cockroach_tpu_torch.bench.tpch_dist import run_dist

    def profile(q, dq):
        return {"idle_share": device_profile(dq.run)["idle_share"]}

    res = run_dist(queries, shards=shards, runs=runs, device=dev,
                   catalog=cat, after=profile)
    rows = {}
    for q in queries:
        r = res[q]
        r["peak_bytes"] = r["peak_device_bytes"]
        r["single_median_s"] = single.get(q)
        rows[q] = [r[c] for c in DIST_COLUMNS]
    return rows


def host_twin(cat):
    """The catalog's host tables (not its KV tables) on a fresh catalog
    with no device columns: the distributed path uploads its own shards
    from the host columns, and the menu phase starts cold."""
    from cockroach_tpu_torch.catalog import Catalog, Table

    twin = Catalog(cat.device)
    for t in cat.tables.values():
        if not isinstance(t, Table):
            continue
        twin.add(Table(name=t.name, schema=t.schema, columns=t.columns,
                       valids=t.valids, dictionaries=t.dictionaries,
                       ordering=t.ordering))
    return twin


def run_distsql_sf1(sf1, ladder: dict | None, dev="cuda") -> dict:
    """At SF1, beside the ladder (when the tpch phase ran): q3, q9, q18
    over 3 and 8 shards."""
    single = ({} if ladder is None
              else {q: ladder[q]["median_s"] for q in DIST_QUERIES})
    out = {f"{d}_shards": dist_runs(sf1, d, single, dev=dev)
           for d in (3, 8)}
    log("distsql SF1: q3 q9 q18 over 3 and 8 shards equal to the oracle")
    return out


def dist_growth(rows1: int, sf: float, shards: int) -> float:
    """How a query's capacities grow from SF1 to `sf` on `shards` shards:
    the ratio of lineitem's first exchange tile, pow2(2 x its shard
    capacity), as parallel/planner.py sizes it (every later stage scales
    with it)."""
    from cockroach_tpu_torch.parallel.planner import _pow2

    def tile(rows):
        return _pow2(2 * max(1024, -(-rows // (shards * 1024)) * 1024))

    return tile(int(rows1 * sf)) / tile(rows1)


def run_distsql_phase(card: str, parity: dict, sf1: dict, cat10,
                      single10: dict, rows1: int, dev="cuda") -> None:
    """BASELINE config #3's three nodes as a 3-shard mesh: each of q3, q9,
    q18 at SF10 (the one-device SF10 medians, `single10`, beside it), or
    at the largest scale whose predicted footprint (its SF1 3-shard peak
    of reserved memory times dist_growth) fits the card's free memory
    with a margin; a query that fits only at SF1 keeps its SF1 row.
    Prints the {"distsql": ...} line."""
    import gc

    from cockroach_tpu_torch.bench.tpch import gen_tpch
    from cockroach_tpu_torch.flow import dispatch

    t0 = time.perf_counter()
    dispatch.clear_kernel_cache()
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    col = DIST_COLUMNS.index("peak_reserved_bytes")
    scale, predicted = {}, {}
    for q in DIST_QUERIES:
        res1 = sf1["3_shards"][q][col]
        fits = [s for s in (10, 5, 3, 2)
                if res1 * dist_growth(rows1, s, 3) <= 0.8 * free]
        scale[q] = fits[0] if fits else 1
        predicted[q] = res1 * dist_growth(rows1, scale[q], 3)
    log(f"distsql: {free / 2**30:.1f} GiB free; scales {scale}, predicted "
        f"reserved GiB "
        f"{ {q: round(v / 2**30, 1) for q, v in predicted.items()} }")
    rows = {}  # a query that fits only at SF1 keeps its row in "sf1"
    for sf in sorted(set(scale.values()) - {1}, reverse=True):
        qs = tuple(q for q in DIST_QUERIES if scale[q] == sf)
        cat = (cat10 if sf == 10 and cat10 is not None
               else gen_tpch(sf=sf, seed=TPCH_SEED, device=dev))
        rows.update(dist_runs(cat, 3, single10 if sf == 10 else {}, qs,
                              dev=dev))
        del cat
        gc.collect()
    cut = {q: f"SF{scale[q]}: one 80 GB card holds all three shards"
           for q in DIST_QUERIES if scale[q] < 10}
    out = {"parity": parity, "columns": DIST_COLUMNS, "sf1": sf1,
           "config3_3_shards": {"scale": scale, **rows},
           "cut": cut or None,
           "predicted_reserved_bytes": predicted, "free_bytes": free,
           "phase_s": time.perf_counter() - t0, "card": card}
    log(f"distsql config #3: q3 q9 q18 over 3 shards at {scale} equal to "
        f"the oracle")
    col = DIST_COLUMNS.index("median_s")
    emit({"distsql": out},
         {"distsql": {"scale": scale,
                      "median_s": {q: r[col] for q, r in rows.items()},
                      "phase_s": out["phase_s"]}})


# ---------------------------------------------------------------------------
# TPC-DS: window functions, merge join, set operations, and SF10


TPCDS_SEED = 19980401  # the reduced generator's default seed


def merge_vs_hash(cat, runs: int = 3) -> dict:
    """lineitem joined to orders on the order key, as a merge join and as
    the hash join the planner picks: equal results (as sorted rows), the
    cold run and the median of `runs` more of each."""
    from cockroach_tpu_torch.flow.runtime import run_operator
    from cockroach_tpu_torch.plan import builder
    from cockroach_tpu_torch.sql.rel import Rel

    li = Rel.scan(cat, "lineitem",
                  ("l_orderkey", "l_quantity", "l_extendedprice"))
    od = Rel.scan(cat, "orders", ("o_orderkey", "o_totalprice",
                                  "o_orderdate"))
    rels = {"merge": li.merge_join(od, ("l_orderkey", "o_orderkey")),
            "hash": li.join(od, on=[("l_orderkey", "o_orderkey")])}
    out, res = {}, {}
    for name, rel in rels.items():
        root = builder.build(rel.optimized_plan(), cat)
        times = []
        for _ in range(runs + 1):
            t0 = time.perf_counter()
            res[name] = run_operator(root)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = {"cold_s": times[0],
                     "median_s": statistics.median(times[1:]),
                     "operator": type(root).__name__}
    if sorted_rows(res["merge"]) != sorted_rows(res["hash"]):
        raise AssertionError("merge join != hash join on lineitem x orders")
    out["rows"] = len(res["merge"]["l_orderkey"])
    log(f"merge join == hash join on lineitem x orders ({out['rows']} rows)")
    return out


def sorted_rows(res: dict) -> list:
    """A result as a sorted multiset of rows (NULL first in each column)."""
    cols = [np.asarray(v, dtype=object) for v in res.values()]
    key = lambda r: tuple((x is not None, x) for x in r)  # noqa: E731
    return sorted(zip(*cols), key=key)


def tpcds_cases(cat) -> dict:
    """{name: (Rel, ordered)} over a TPC-DS catalog: one window query per
    function family and frame kind (ROWS, RANGE over a DECIMAL key in
    DESC order, GROUPS, EXCLUDE, a STRING partition, NULL keys from a
    left join), then the merge join, right, full and cross joins, UNION
    ALL and string_agg. `ordered`: the output order is defined (a window
    sorts its input), else rows compare as a multiset."""
    from cockroach_tpu_torch.ops import expr as ex
    from cockroach_tpu_torch.sql.rel import Rel

    ss = Rel.scan(cat, "store_sales", (
        "ss_sold_date_sk", "ss_item_sk", "ss_store_sk", "ss_promo_sk",
        "ss_quantity", "ss_list_price", "ss_ext_sales_price"))
    it = Rel.scan(cat, "item", ("i_item_sk", "i_brand", "i_category"))
    pr = Rel.scan(cat, "promotion")

    def cmp(rel, op, col, v):
        return rel.filter(ex.Cmp(op, rel.c(col), ex.lit(v)))

    late = cmp(pr, "ge", "p_promo_sk", 2)
    sit = ss.join(it, on=[("ss_item_sk", "i_item_sk")])
    spr = ss.join(late, on=[("ss_promo_sk", "p_promo_sk")], how="left")

    def aggs(col):
        return [(f"{f}_{col}", f, col) for f in (
            "sum", "count", "avg", "min", "max", "first_value",
            "last_value")]

    by_store = ["ss_store_sk"]
    big = cmp(ss, "gt", "ss_quantity", 95)
    return {
        "w_ranks": (ss.window(
            by_store, [("ss_sold_date_sk", True), ("ss_item_sk", False)],
            [("rn", "row_number", None), ("rk", "rank", None),
             ("drk", "dense_rank", None), ("pr", "percent_rank", None),
             ("cd", "cume_dist", None), ("nt", "ntile", None, 5),
             ("lag", "lag", "ss_quantity"),
             ("lead", "lead", "ss_quantity", 2)]), True),
        "w_whole": (ss.window(by_store, [("ss_item_sk", False)],
                              aggs("ss_ext_sales_price")), True),
        "w_running": (ss.window(by_store, [("ss_sold_date_sk", False)],
                                aggs("ss_quantity"), running=True), True),
        "w_rows_string_partition": (sit.window(
            ["i_category"], [("ss_sold_date_sk", False),
                             ("ss_item_sk", False)],
            aggs("ss_ext_sales_price") + [("mn", "min", "i_brand")],
            frame=(3, 1)), True),
        "w_range_desc": (ss.window(by_store, [("ss_list_price", True)],
                                   aggs("ss_quantity"), frame=(1.5, 2.0),
                                   frame_kind="range"), True),
        "w_groups": (ss.window(by_store, [("ss_quantity", False)],
                               aggs("ss_ext_sales_price"), frame=(1, 1),
                               frame_kind="groups"), True),
        "w_exclude_group": (ss.window(
            by_store, [("ss_quantity", False)], aggs("ss_list_price"),
            frame=(2, 2), exclude="group"), True),
        "w_exclude_ties": (ss.window(
            by_store, [("ss_quantity", False)],
            [("s", "sum", "ss_ext_sales_price"),
             ("mx", "max", "ss_ext_sales_price"),
             ("c", "count", "ss_ext_sales_price")],
            frame=(2, 2), exclude="ties"), True),
        "w_null_keys": (spr.window(
            ["p_channel_email"], [("p_promo_sk", False),
                                  ("ss_item_sk", False)],
            [("rk", "rank", None), ("s", "sum", "ss_quantity"),
             ("mn", "min", "p_channel_event")], running=True), True),
        "merge_inner": (ss.merge_join(it, ("ss_item_sk", "i_item_sk")),
                        False),
        "merge_semi": (it.merge_join(ss, ("i_item_sk", "ss_item_sk"),
                                     how="semi"), False),
        "merge_left": (pr.merge_join(big, ("p_promo_sk", "ss_promo_sk"),
                                     how="left"), False),
        "right": (big.join(pr, on=[("ss_promo_sk", "p_promo_sk")],
                           how="right"), False),
        "full": (cmp(big, "le", "ss_promo_sk", 1).join(
            late, on=[("ss_promo_sk", "p_promo_sk")], how="full"), False),
        "cross": (Rel.scan(cat, "store").cross_join(late), False),
        "union_all": (big.select("ss_item_sk", "ss_quantity").union_all(
            cmp(ss, "lt", "ss_quantity", 3).select("ss_item_sk",
                                                   "ss_quantity")), False),
        "string_agg": (it.groupby(["i_brand"], [
            ("cats", "string_agg", "i_category", ","),
            ("n", "count_rows", None)]), False),
    }


def first_difference(a: dict, b: dict, rtol: float = 0.0) -> str | None:
    """Where two results first differ (column, row, values), or None:
    floats within `rtol` (NaN equal to NaN), everything else exactly."""
    if list(a) != list(b):
        return f"columns {list(a)} != {list(b)}"
    for k in a:
        x, y = np.asarray(a[k], dtype=object), np.asarray(b[k], dtype=object)
        if x.shape != y.shape:
            return f"{k}: {x.shape[0]} rows != {y.shape[0]}"
        diff = [i for i, (u, v) in enumerate(zip(x, y))
                if not (u == v or (u != u and v != v) or (
                    isinstance(u, float) and isinstance(v, float)
                    and abs(u - v) <= rtol * abs(v)))]
        if diff:
            i = diff[0]
            return f"{k} row {i} of {len(diff)}: {x[i]!r} != {y[i]!r}"
    return None


def _same(a: dict, b: dict, ordered: bool) -> bool:
    """Windows row for row, FLOAT columns within 1e-12 (a DECIMAL
    average divides by 10^scale, which the card does as a multiply by
    the reciprocal, one ULP off IEEE division at times); joins as
    multisets of rows."""
    if ordered:
        return first_difference(a, b, rtol=1e-12) is None
    return list(a) == list(b) and sorted_rows(a) == sorted_rows(b)


def check_tpcds_parity(dev, sf: float = 0.01) -> dict:
    """TPC-DS at `sf` on the card against the CPU, and fused against
    unfused on the card: the nine queries at the default tile and with
    1024-row tiles, exactly but for the FLOAT averages of q7, q53_lite
    and q65_lite (within tpcds_oracle.FLOAT_RTOL: a DECIMAL average sums
    scaled floats, in the order of the card's atomic adds), and every
    case of tpcds_cases (windows row for row, FLOAT within 1e-12; joins
    as multisets). Returns the result rows per case."""
    from cockroach_tpu_torch.bench import tpcds, tpcds_oracle
    from cockroach_tpu_torch.utils import settings

    cats = {d: tpcds.gen_tpcds(sf=sf, seed=TPCDS_SEED, device=d)
            for d in (dev, "cpu")}
    rows = {}
    for tile in (None, 1024):
        if tile is not None:
            settings.set("sql.distsql.tile_size", tile)
        try:
            for q in tpcds.QUERIES:
                res = {}
                for d, cat in cats.items():
                    res[d] = tpcds.QUERIES[q](cat).run()
                _fusion(False)
                try:
                    res["unfused"] = tpcds.QUERIES[q](cats[dev]).run()
                finally:
                    settings.reset("sql.distsql.fusion.enabled")
                for other in ("cpu", "unfused"):
                    bad = tpcds_oracle.mismatch(q, res[dev], res[other])
                    if bad is not None:
                        raise AssertionError(
                            f"TPC-DS (tile {tile}) card != {other}: {bad}")
                rows[q] = len(next(iter(res["cpu"].values())))
        finally:
            settings.reset("sql.distsql.tile_size")
    cases = {d: tpcds_cases(cat) for d, cat in cats.items()}
    for name, (rel, ordered) in cases[dev].items():
        got = rel.run()
        want = cases["cpu"][name][0].run()
        _fusion(False)
        try:
            unfused = rel.run()
        finally:
            settings.reset("sql.distsql.fusion.enabled")
        for other, res in (("cpu", want), ("unfused", unfused)):
            if not _same(got, res, ordered):
                raise AssertionError(f"TPC-DS case {name}: card != {other}: "
                                     f"{first_difference(got, res, 1e-12)}")
        n = len(next(iter(want.values())))
        if n == 0:
            raise AssertionError(f"TPC-DS case {name} returned no rows")
        rows[name] = n
    log(f"TPC-DS sf={sf}: 9 queries (default and 1024-row tiles) and "
        f"{len(cases['cpu'])} window/join cases equal on card, CPU and "
        "unfused")
    return rows


def host_ram() -> dict:
    """The host's MemTotal and MemAvailable (/proc/meminfo) and this
    process's peak RSS so far, in bytes."""
    from cockroach_tpu_torch.bench.tpch_run import peak_rss_bytes

    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":", 1)
            if k in ("MemTotal", "MemAvailable"):
                out[k] = int(v.split()[0]) * 1024
    out["peak_rss"] = peak_rss_bytes()
    return out


TPCDS_COLUMNS = ["cold_s", "warm_s", "median_s", "rows_per_sec", "rows",
                 "host_syncs", "idle_share", "h2d_gb", "h2d_s", "fill_wait_s",
                 "streamed", "staged_gb", "peak_device_gb", "spills"]


def run_tpcds_phase(card: str, merge_join: dict, sf: float = 10.0,
                    dev="cuda") -> dict:
    """TPC-DS (BASELINE config #4's workload at SF10): the sf=0.01 card,
    CPU and unfused checks; the TPC-H catalogs freed and the host's RAM
    printed; SF10 generated (seed 19980401); the nine queries and the
    full-size sales_window timed through run_tpcds (cold, warm, median
    of DEPTH_RUNS, every run equal to the numpy oracle) and profiled once; the
    {"tpcds": ...} line, with `merge_join` (the SF1 merge join against
    the hash join)."""
    import gc

    from cockroach_tpu_torch.bench import tpcds
    from cockroach_tpu_torch.bench.tpcds_run import run_tpcds
    from cockroach_tpu_torch.bench.tpch_run import peak_rss_bytes
    from cockroach_tpu_torch.flow import dispatch
    from cockroach_tpu_torch.flow.runtime import run_operator
    from cockroach_tpu_torch.plan import builder

    t_phase = time.perf_counter()
    parity = check_tpcds_parity(torch.device(dev))
    # the TPC-H catalogs die with their phases; their operators' cached
    # functions and graphs go here
    dispatch.clear_kernel_cache()
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    ram = host_ram()
    log(f"host RAM: total {ram['MemTotal'] / 2**30:.1f} GiB, available "
        f"{ram['MemAvailable'] / 2**30:.1f} GiB, peak RSS so far "
        f"{ram['peak_rss'] / 2**30:.1f} GiB")
    t0 = time.perf_counter()
    cat = tpcds.gen_tpcds(sf=sf, seed=TPCDS_SEED, device=dev)
    gen_s = time.perf_counter() - t0
    gen_rss = peak_rss_bytes()
    log(f"TPC-DS SF{sf:g} generated in {gen_s:.1f}s")
    res = run_tpcds("all", sf=sf, runs=DEPTH_RUNS, device=dev, catalog=cat,
                    window=True)
    table = {}
    for q in tuple(tpcds.QUERIES) + ("sales_window",):
        r = res[q]
        rel = (tpcds.sales_window(cat) if q == "sales_window"
               else tpcds.QUERIES[q](cat))
        root = builder.build(rel.optimized_plan(), cat)
        prof = device_profile(lambda root=root: run_operator(root))
        table[q] = [r["cold_s"], r["warm_s"], r["median_s"],
                    r["rows_per_sec"], r["rows"],
                    sum(r["host_syncs"].values()), prof["idle_share"], r["h2d_bytes"] / 1e9, r["h2d_s"],
                    r["fill_wait_s"], len(r["streamed"]),
                    r["staged_bytes"] / 1e9,
                    (r["peak_device_bytes"] or 0) / 1e9, r["spills"]]
        del root
    if not any("GraceAggregateOp" in s for s in res["q65_lite"]["spills"]):
        raise AssertionError("q65_lite at SF10 did not spill its GROUP BY: "
                             f"{res['q65_lite']['spills']}")
    out = {"sf": sf, "store_sales_rows": res["store_sales_rows"],
           "gen_s": gen_s, "gen_peak_rss": gen_rss, "host_ram": ram,
           "sf0.01_card_cpu_unfused": {
               "equal": True, "queries": 9, "tiles": ["default", 1024],
               "cases": len(parity) - 9, "rows": sum(parity.values())},
           "columns": TPCDS_COLUMNS, **table,
           "merge_join_sf1": merge_join,
           "phase_s": time.perf_counter() - t_phase, "card": card}
    log(f"TPC-DS SF{sf:g}: 9 queries and sales_window equal to the oracle "
        f"in every run, {out['phase_s']:.0f}s")
    col = TPCDS_COLUMNS.index("median_s")
    emit({"tpcds": out},
         {"tpcds": {"median_s": {q: r[col] for q, r in table.items()},
                    "gen_s": gen_s, "phase_s": out["phase_s"]}})
    return out


# ---------------------------------------------------------------------------
# engine parity: the same operation sequence on two engines


def _key(i: int) -> bytes:
    return b"k%07d" % i


def parity_ops(make_engine, intent_error, n_keys: int = 2000) -> list:
    """A fixed sequence of writes, intents, resolutions, flushes and
    compactions on one engine; returns every read result (and every
    WriteIntentError as (keys, txns)) in order."""
    rng = np.random.default_rng(17)
    eng = make_engine(key_width=16, val_width=16, memtable_size=256,
                      l0_trigger=4)
    out: list = []

    def read(tag, fn):
        try:
            out.append((tag, fn()))
        except intent_error as e:
            out.append((tag, "WriteIntentError", list(e.keys),
                        list(e.txns)))

    def reads(tag, ts, txn=0):
        starts = [_key(int(i)) for i in rng.integers(0, n_keys, 24)]
        read(f"{tag}/batch", lambda: eng.scan_batch(starts, ts=ts, txn=txn,
                                                    max_keys=16))
        lo = int(rng.integers(0, n_keys - 100))
        read(f"{tag}/scan", lambda: eng.scan(_key(lo), _key(lo + 60), ts=ts,
                                             txn=txn))
        read(f"{tag}/scan_max", lambda: eng.scan(_key(lo), None, ts=ts,
                                                 txn=txn, max_keys=40))
        for i in rng.integers(0, n_keys + 50, 6):
            read(f"{tag}/get{int(i)}",
                 lambda i=i: eng.get(_key(int(i)), ts=ts, txn=txn))

    keys = np.zeros((n_keys, 16), np.uint8)
    vals = np.zeros((n_keys, 16), np.uint8)
    for i in range(n_keys):
        keys[i, :8] = np.frombuffer(_key(i), np.uint8)
        vals[i, :6] = np.frombuffer(b"v%05d" % (i % 100000), np.uint8)
    eng.ingest(keys[: n_keys // 2], vals[: n_keys // 2], ts=1)
    eng.ingest(keys[n_keys // 2:], vals[n_keys // 2:], ts=1)
    reads("ingested", ts=5)
    for i in range(700):
        k = _key(int(rng.integers(0, n_keys)))
        if i % 7 == 3:
            eng.delete(k, ts=2 + i // 100)
        else:
            eng.put(k, b"p%05d" % i, ts=2 + i // 100)
    reads("written", ts=6)
    reads("past", ts=3)
    for i in range(60):
        eng.put(_key(int(rng.integers(0, n_keys))), b"t101-%d" % i, ts=20,
                txn=101)
        eng.put(_key(int(rng.integers(0, n_keys))), b"t202-%d" % i, ts=21,
                txn=202)
    reads("intents", ts=25)
    reads("own101", ts=25, txn=101)
    reads("below-intents", ts=15)
    eng.resolve_intents(101, commit_ts=30, commit=True)
    eng.resolve_intents(202, commit_ts=31, commit=False)
    reads("resolved", ts=35)
    for i in range(1500):
        eng.put(_key(int(rng.integers(0, n_keys))), b"c%05d" % i,
                ts=40 + i // 300)
    reads("compacted", ts=50)
    eng.compact(bottom=True)
    reads("bottom", ts=50)
    read("full", lambda: eng.scan(None, None, ts=60))
    read("stats", lambda: (eng.stats.compactions, eng.stats.runs,
                           eng.stats.flushes))
    eng.close()
    return out


def check_parity() -> None:
    from cockroach_tpu_torch.storage.lsm import Engine, WriteIntentError

    def factory(device):
        return lambda **kw: Engine(device=device, **kw)

    merge0 = cuda_merge.merge_perm.launches
    scan0 = cuda_scan.scan_filter.launches
    on_card = parity_ops(factory("cuda"), WriteIntentError)
    on_cpu = parity_ops(factory("cpu"), WriteIntentError)
    if on_card != on_cpu:
        bad = next(i for i, (a, b) in enumerate(zip(on_card, on_cpu))
                   if a != b)
        raise AssertionError(f"engine on the card differs from the CPU at "
                             f"read {bad}: {on_card[bad][0]}")
    errors = sum(1 for r in on_card if r[1] == "WriteIntentError")
    stats = on_card[-1][1]
    if stats[0] == 0 or errors == 0:
        raise AssertionError("parity sequence ran no compaction or intent")
    log(f"engine parity card == CPU over {len(on_card)} reads "
        f"({errors} WriteIntentErrors, compactions/runs/flushes {stats}; "
        f"merges {cuda_merge.merge_perm.launches - merge0}, "
        f"filters {cuda_scan.scan_filter.launches - scan0} on the card)")


# ---------------------------------------------------------------------------
# timing


def device_ms(fn, reps: int = 30, lead_cycles: int = 20_000_000) -> float:
    """Median device time of fn(): each call is bracketed by CUDA events
    behind a spin kernel, so the host's enqueue time stays out of it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(lead_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernels_per_call(fn) -> int | str:
    """CUDA kernels one call of fn() runs, from a torch.profiler trace of
    a second call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return n or "not measured"


def time_kernels(dev, errs: dict) -> list[dict]:
    """Both kernels at the main path's shapes, each row with an empty
    launch's time (`floor_ms`) beside it; `launches` is filled in from
    the main path's run."""
    rng = np.random.default_rng(3)
    floor = device_ms(lambda: torch.cuda._sleep(0))
    win = mvcc.kvblock_from_numpy(scan_windows(rng, 128, 640), dev)
    rows = win.capacity
    k1 = {
        "name": "scan_filter", "route": "cuda",
        "source": "cockroach_tpu_torch/csrc/scan_filter.cu",
        "replaces": "cockroach_tpu/storage/pallas_scan.py:169",
        "launches": None,
        "max_abs_err": errs["scan_filter"],
        "ms": device_ms(lambda: cuda_scan.scan_filter(win, 50, 0, 640)),
        "plain_ms": device_ms(
            lambda: cuda_scan.scan_filter_plain(win, 50, 0, 640)),
        "bound_ms": rows * K1_BYTES_PER_ROW / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None, "floor_ms": floor,
        "shape": f"128 windows x 640 lanes ({rows} rows)",
    }
    a = sorted_run(rng, 1 << 17, 1 << 17, 1 << 16, dev)
    b = sorted_run(rng, 1 << 17, 1 << 17, 1 << 16, dev)
    n = cuda_merge.merged_rows(a.capacity, b.capacity)
    packed = flip(key_words(torch.cat([a.key, b.key]))[:, 0])
    a20 = sorted_run(rng, 1 << 20, 1 << 20, 1 << 19, dev)
    b20 = sorted_run(rng, 1 << 20, 1 << 20, 1 << 19, dev)

    def k2_bound(x, y):
        return ((x.capacity + y.capacity) * K2_BYTES_PER_ROW
                + cuda_merge.merged_rows(x.capacity, y.capacity)
                * K2_PERM_BYTES) / HBM_BYTES_PER_S * 1e3

    k2 = {
        "name": "merge_path", "route": "cuda",
        "source": "cockroach_tpu_torch/csrc/merge_path.cu",
        "replaces": "cockroach_tpu/storage/pallas_merge.py:181",
        "launches": None,
        "max_abs_err": errs["merge_path"],
        "ms": device_ms(lambda: cuda_merge.merge_perm(a, b)),
        "plain_ms": device_ms(lambda: cuda_merge.merge_perm_plain(a, b)),
        "bound_ms": k2_bound(a, b),
        "bound_by": "bytes",
        "library_ms": device_ms(
            lambda: torch.sort(packed, stable=True)),
        "floor_ms": floor,
        "cuda_launches_per_call": kernels_per_call(
            lambda: cuda_merge.merge_perm(a, b)),
        "shape": f"2 x 2^17 rows -> {n} slots",
        # several waves of blocks, where bytes rather than latency bound it
        "ms_2x2^20": device_ms(lambda: cuda_merge.merge_perm(a20, b20)),
        "bound_ms_2x2^20": k2_bound(a20, b20),
    }
    return [k1, k2]


# ---------------------------------------------------------------------------


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


PHASES = ("kernels", "tpch", "distsql_sf1", "kv", "sql", "menu", "tpcc",
          "views", "fanout", "sf10", "distsql", "tpcds", "ycsb", "parity")
# phases whose storage-kernel launches the kernel table reports
LAUNCH_PHASES = ("tpch", "kv", "sql", "menu", "tpcc", "views", "fanout",
                 "sf10", "distsql", "tpcds")


def parse_args(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--phases", default=",".join(PHASES),
        help="comma list of phases to run, in the script's order "
             f"(default all: {','.join(PHASES)}); the kernel builds and "
             "checks, the kernel table and the last line always run")
    ap.add_argument("--verbose", action="store_true",
                    help="print each phase's full result line (the "
                         "default when one phase is selected)")
    ap.add_argument("--detail", metavar="PATH",
                    help="also write every phase's full result line to "
                         "PATH")
    a = ap.parse_args(argv)
    chosen = [p.strip() for p in a.phases.split(",") if p.strip()]
    unknown = sorted(set(chosen) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; choose from {PHASES}")
    a.phases = set(chosen) | {"kernels"}
    return a


def _zero_launches() -> None:
    cuda_scan.scan_filter.launches = 0
    cuda_merge.merge_perm.launches = 0


def _launches() -> dict:
    return {"scan_filter": cuda_scan.scan_filter.launches,
            "merge_path": cuda_merge.merge_perm.launches}


def main(argv=None) -> int:
    global VERBOSE, _detail
    faulthandler.enable()  # a crash in native code prints the Python stack
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import gc

    phases = args.phases
    VERBOSE = args.verbose or len(phases) <= 2
    if args.detail:
        _detail = open(args.detail, "w", encoding="utf-8")
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda};"
        f" phases {[p for p in PHASES if p in phases]}")
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"built {list(_build.SOURCES)} in {secs:.1f}s")
    for name in _build.SOURCES:
        rep = _build.OUT / f"{name}.log"
        if rep.is_file():
            for line in rep.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"{name}: {line.strip()}")
    errs = {"scan_filter": check_scan_filter(dev),
            "merge_path": check_merge(dev)}
    # timed and profiled before the YCSB phases: a torch.profiler session
    # after the long profiled run records no device events on the card
    kernels = time_kernels(dev, errs)
    seconds = {"kernels": time.perf_counter() - t0}
    st: dict = {}
    launches: dict = {}
    fusion: dict = {}

    def sf1():
        """The SF1 host catalog: the tpch phase's, or made here."""
        if "sf1" not in st:
            from cockroach_tpu_torch.bench.tpch import gen_tpch

            st["sf1"] = gen_tpch(sf=1.0, seed=TPCH_SEED, device=dev)
        return st["sf1"]

    def run(name, fn):
        """Phase `name` when selected: its seconds, and the storage
        kernels' launches from zero."""
        if name not in phases:
            return None
        t = time.perf_counter()
        _zero_launches()
        out = fn()
        launches[name] = _launches()
        seconds[name] = time.perf_counter() - t
        return out

    def tpch_phase():
        st["tpch"], st["sf1"] = run_tpch_phase(card, fusion)
        return st["tpch"]

    def ladder():
        return st["tpch"]["ladder"] if "tpch" in st else None

    run("tpch", tpch_phase)
    if "tpch" in st:  # the SF1 runs alone, not the parity checks
        launches["tpch"] = st["tpch"]["storage_kernel_launches"]
    run("distsql_sf1", lambda: st.__setitem__(
        "dist_sf1", run_distsql_sf1(sf1(), ladder())))
    kv = run("kv", lambda: run_kv_phase(card, sf1(), ladder() or {}))
    if kv is not None:  # the witnessed path alone, not the index lookups
        launches["kv"] = kv[1]
    hand: dict = {}  # the SQL phase's hand-built TPC-H results at SF1
    run("sql", lambda: run_sql_phase(card, sf1(), hand=hand))
    run("menu", lambda: run_menu_phase(card, sf1(), hand=hand))
    run("tpcc", lambda: run_tpcc_phase(card))
    gc.collect()
    run("views", lambda: run_views_phase(card))
    gc.collect()
    run("fanout", lambda: run_fanout_phase(card))
    rows1 = (st["tpch"]["lineitem_rows"] if "tpch" in st
             else sf1().get("lineitem").num_rows if "distsql" in phases
             else None)
    if "distsql" in phases and "dist_sf1" not in st:
        st["dist_sf1"] = run_distsql_sf1(sf1(), ladder())
    st.pop("sf1", None)
    gc.collect()

    def sf10_phase():
        sf10, cat10 = run_sf10_phase(card, fusion)
        st["sf10"] = sf10
        # the SPMD plane reads the SF10 host tables (device columns freed)
        st["twin"] = host_twin(cat10)

    run("sf10", sf10_phase)
    if fusion:
        emit({"fusion": fusion, "card": card},
             {"fusion_median_ms": {
                 f"{sf}_{q}": [v["unfused"]["median_ms"],
                               v["fused"]["median_ms"]]
                 for sf, qs in fusion.items() if sf in ("sf1", "sf10")
                 for q, v in qs.items()}})

    def distsql_phase():
        parity = check_distsql_parity(dev)
        single10 = ({q: st["sf10"][q]["median_s"] for q in DIST_QUERIES}
                    if "sf10" in st else {})
        run_distsql_phase(card, parity, st["dist_sf1"], st.pop("twin", None),
                          single10, rows1)

    run("distsql", distsql_phase)
    st.pop("twin", None)
    if "distsql_sf1" in launches:  # one path: the SPMD plane's
        sf1_n = launches.pop("distsql_sf1")
        launches["distsql"] = {k: n + launches.get("distsql", {}).get(k, 0)
                               for k, n in sf1_n.items()}
    run("tpcds", lambda: run_tpcds_phase(
        card, st["tpch"]["merge_join"] if "tpch" in st else None))
    ycsb = run("ycsb", lambda: run_ycsb(card))
    run("parity", check_parity)
    for k in kernels:
        name = k["name"]
        # the main path's launches: YCSB-E, the one path of both kernels
        k["launches"] = ycsb[name] if ycsb is not None else None
        for p in LAUNCH_PHASES:
            n = launches.get(p, {}).get(name)
            k[f"{p}_launches"] = n
            if n is not None:
                k[f"on_{p}_path"] = n > 0
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    emit({"phases": {**seconds, "total": total}})
    log(f"total {total:.1f}s (default-run budget {TIME_BUDGET_S:.0f}s)")
    write_line(card)
    log(f"{_written} bytes written before the kernel table (default-run "
        f"budget {OUTPUT_BUDGET})")
    if _detail is not None:
        _detail.close()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
