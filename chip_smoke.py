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
to the numpy oracle in every run, q3 profiled once; q7 and q21 cold and
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
literal sets) once, each equal to one connection, then once more with
``sql.distsql.sharedscan.enabled`` on (flow/sharedscan.py), equal again,
printing the ``{"sharedscan": ...}`` line (scans attached to a live
stream, tiles taken from one, both passes' seconds); ``run_mixed_load``
with 8 sessions for 3 s at SF1 reads back every acknowledged insert; the
``{"sql": ...}`` line (``sql_launches`` in the kernel table).

The warm menu (``sql/warmmenu.py``), statement diagnostics
(``sql/diagnostics.py``) and the rest of crdb_internal, after the SQL
phase: ``Node.start`` serves pgwire over a fresh copy of the SF1 host
catalog and warms its menu (``warmmenu.warm_node``: the 22 TPC-H texts,
q5 under the cost-based join order, and the ladder course) before it
returns;
each item's status, runs and captures and the plan cache's bytes within
its budget, nothing evicted and no entry at 0 bytes; two serving runs
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
the kernel table). The control plane (``kv/liveness.py``,
``kv/jobs.py``, ``sql/schemachange.py``, ``utils/external_storage.py``,
``kv/tenant.py``; the ``jobs`` phase) after it: TPC-C at W=1 loaded,
ALTER TABLE ADD a STRING column (customer) and an INT column (stock,
claimed by node 1 of two liveness records, which dies after chunk 50;
node 2 adopts it once node 1 expires, and node 1's late checkpoint is
fenced), 10 transactions and the consistency checks on the new
descriptors, DROP COLUMN, BACKUP to ``nodelocal://``, 5 transactions,
RESTORE with every table's digest back to the backup's and the old
engine freed, a tenant's isolation and a revoked capability, and
``bench/load.run_tenant_overload`` at the reference's defaults (every
refusal typed; the goodput and isolation verdicts reported); the same sequence at TPCC_SMALL on the card and the CPU
with equal final tables; the ``{"jobs": ...}`` line (``jobs_launches``).
Materialized views (``bench/views.run_views``, the
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
the card (every run held to the oracle; cold, warm, median, idle share
of q3 over 3 shards,
dispatches, attempts, capacity factor, rows through all_to_all, upload
seconds, peak memory, beside the one-device median); after the SF10
phase, all 22 queries at sf=0.01 (seed 11) over 1, 3 and 8 shards equal
to the one-device card run, the 8-shard runs equal to the CPU's with the
same capacity factor, explain_distributed equal to the CPU's text, the
skewed-window retry at the CPU's factor (the CPU's half in a spawned
process beside the card's); then BASELINE config #3's three
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
cold and warm through ``bench/tpcds_run.run_tpcds``, every run equal to the numpy
oracle, sales_window profiled once; the ``{"tpcds": ...}`` line, which also
carries the SF1 phase's lineitem x orders merge join against the hash
join (equal results, both timed).

KV distribution and the cluster services (``kv/dist.py``,
``loadstats.py``, ``queues.py``, ``allocator.py``, ``rpc.py``,
``dialer.py``, ``coalesce.py``, ``replication.py``, ``tsdb.py``,
``upgrade.py``, ``flow/gossip.py``; the ``dist`` phase, after ``ycsb``),
on a three-store cluster on the card: YCSB-E at the ycsb phase's size
through ``bench/ycsb.run_ycsb_e(stores=3)`` (the keyspace in thirds,
one a store; the load through ``DistSender.ingest``, the scans through
``DistSender.scan_batch``, every scan and one across each range boundary
held to a host model after the timed window; K1 and K2 launches, every
K2 merge of the phase held to ``merge_perm_plain`` and counted against
K2's launches); the range lifecycle under skew (load
splits, a lease transfer, moves onto idle stores with rows, seconds and
device bytes, the re-merge once the load decays, run by the
RangeLifecycle that ``Node.start`` builds over the DistSender; every
read equal to the model; ``/hot_ranges`` from the node's admin port,
``crdb_internal.hot_ranges`` and SHOW RANGES through a Session equal to
Meta); two ``Node``s over the cluster (kv, gossip and HTTP ports, lease
loops) and a LeaseRouter: 250 range-addressed batches, node 1 crashed,
the put in flight typed ambiguous, the router rerouted to node 2 after
its lease loop's failover with no double apply;
``bench/load.run_coalesce_ab`` at bench.py's defaults but one round of
three; a ReplicationStream into a standby engine equal to the source at
the cutover frontier; ``TimeSeriesDB.record`` every second and
``run_upgrades`` twice; TPC-H q1, q3, q9, q18 at SF0.1 over three
stores with lineitem split in three, held to the oracle; the ``{"dist":
...}`` line (``dist_launches``).

The node and SQL across processes (``server/node.py``, ``http.py``,
``debugzip.py``, ``cli.py``, ``flow/dcn.py``, ``wire.py``,
``disthost.py``; the ``node`` and ``hosts`` phases, after ``dist``): ``python
-m cockroach_tpu_torch.cli --start`` as a child on the card (readiness
seconds; pgwire CREATE, INSERT and a SELECT reading every row back; the
admin endpoints; ``cli hot-ranges`` and ``cli debug zip`` with the
reference's members; SIGINT and exit 0) and ``cli --demo-tpch 0.01 -e
<q1>`` on the card equal to ``--cpu``; then two ``HostFlowServer``
processes over TPC-H SF1 (generated while the node phase runs) and this
process as the gateway: q1 and the hash-repartitioned join across them
equal to one device, q1 with host 2 killed mid-flow degraded onto host
1, rows/s beside one device's, frames and bytes streamed, the framing's
cost per batch against a socket's; the ``{"node": ...}`` and
``{"hosts": ...}`` lines (``node_launches`` and ``hosts_launches``
count the kernels' launches in the child processes too: each CLI child
reports its counts at exit, each host process before its kill or stop).
Result
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
import contextlib
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
    YCSB_FIGURES.update({k: y[k] for k in ("load_s", "ops_per_sec",
                                           "rows_per_sec")})
    return launches


# the single-engine YCSB-E's figures of this run, beside the cluster's
YCSB_FIGURES: dict = {}


# ---------------------------------------------------------------------------
# KV distribution and the cluster services (the ``dist`` phase)


DIST_STORES = 3  # one store per node of CockroachDB's smallest cluster
DIST_KEYS = 1 << 20  # the ycsb phase's keys and operations
DIST_OPS = 512
DIST_LIFE_KEYS = 1 << 16  # the lifecycle's keyspace, the stream's span
DIST_LIFE_OPS = 2000
DIST_RPC_BATCHES = 250  # a depth cut from 1,000 for the default run's budget
DIST_HB_S = 1.0  # the nodes' heartbeat and lease-loop interval
DIST_COALESCE = {"rounds": 1}  # bench.py's 3 rounds before node and hosts
DIST_SQL_SF = 0.1


class ManualTime:
    """The load stats' injectable monotonic clock, stepped by the phase."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def life_keys(idx: np.ndarray) -> np.ndarray:
    """b"y%07d" keys as [N, 16] uint8 rows (the lifecycle's keyspace)."""
    out = np.zeros((len(idx), 16), np.uint8)
    out[:, 0] = ord("y")
    digits = idx.astype(np.int64).copy()
    for p in range(7):
        out[:, 7 - p] = digits % 10 + ord("0")
        digits //= 10
    return out


class TsdbTicker:
    """Records ``metric.DEFAULT`` into a TimeSeriesDB every ``every_s``
    seconds on a thread of its own, until closed (the node's metrics
    scraper). The timeseries keys are long, so its store is a 96-byte-key
    engine of its own on the card."""

    def __init__(self, dev, every_s: float = 1.0):
        import threading

        from cockroach_tpu_torch.kv.tsdb import TimeSeriesDB
        from cockroach_tpu_torch.kv.txn import DB
        from cockroach_tpu_torch.storage.lsm import Engine
        from cockroach_tpu_torch.utils import metric

        self.db = DB(Engine(key_width=96, val_width=16, device=dev))
        self.ts = TimeSeriesDB(self.db)
        self.samples = 0
        self.ticks = 0
        self.error = None
        self._stop = threading.Event()

        def loop():
            try:
                while True:
                    self.samples += self.ts.record(metric.DEFAULT)
                    self.ticks += 1
                    if self._stop.wait(every_s):
                        return
            except Exception as e:  # noqa: BLE001 - re-raised by close()
                self.error = e

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="tsdb-ticker")
        self._thread.start()

    def close(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=60)
        if self.error is not None:
            raise AssertionError(f"tsdb record failed: {self.error!r}")
        series = self.ts.query("range_moves")
        if len(series) != self.ticks:
            raise AssertionError(f"tsdb: {self.ticks} records, "
                                 f"{len(series)} range_moves samples")
        return {"ticks": self.ticks, "samples": self.samples,
                "range_moves_series": [v for _, v in series][-3:]}


def dist_ycsb(dev, n_keys: int, ops: int) -> dict:
    """Step 1: YCSB-E over DIST_STORES stores, every scan held to the
    host model (the boundary-crossing ones included). Its launches are
    the difference of two readings of the phase's counts."""
    from cockroach_tpu_torch.bench.ycsb import run_ycsb_e

    before = _launches()
    t0 = time.perf_counter()
    y = run_ycsb_e(n_keys=n_keys, ops=ops, scan_len=64, concurrency=64,
                   seed=0, ingest_chunk=1 << 16, stores=DIST_STORES,
                   device=dev)
    _sync(dev)
    y["wall_s"] = time.perf_counter() - t0
    y["launches"] = {k: n - before[k] for k, n in _launches().items()}
    if y["scans_crossing_a_range"] < DIST_STORES - 1:
        raise AssertionError("no scan crossed a range boundary")
    if torch.device(dev).type == "cuda":
        for k, n in y["launches"].items():
            if n <= 0:
                raise AssertionError(f"{k} never launched in the cluster's "
                                     "YCSB-E")
    return y


def dist_lifecycle(dev, n_keys: int, n_ops: int, seed: int = 7):
    """Step 2: tests/test_ranger.py's skewed workload (80% of the puts on
    the first fifth of the keyspace) over DIST_STORES stores holding
    n_keys ingested rows, on manual clocks, under node 1: ``Node.start``
    over the cluster's DB wires the DistSender's lease guard and builds
    the RangeLifecycle (as the reference's node does; the phase ticks it
    rather than its timer, and places stores 2 and 3 on node 2). Load
    splits, a lease transfer and a hot range moved to an idle store,
    then the re-merge once the load decays. Every read equals the dict
    model; ``/hot_ranges`` from node 1's admin port,
    crdb_internal.hot_ranges and SHOW RANGES through a Session equal the
    lifecycle's payload and Meta."""
    import random
    import urllib.request
    from types import SimpleNamespace

    from cockroach_tpu_torch.kv import liveness, loadstats
    from cockroach_tpu_torch.kv.dist import make_cluster
    from cockroach_tpu_torch.kv.hlc import ManualClock
    from cockroach_tpu_torch.kv.txn import DB
    from cockroach_tpu_torch.server.node import Node
    from cockroach_tpu_torch.sql.session import Session
    from cockroach_tpu_torch.utils import metric, settings

    clk = ManualTime()
    # 32-byte values: the liveness and lease records (24 bytes) stay
    # inline, where the rangefeed's merged view over the stores reads them
    ds = make_cluster(DIST_STORES, device=dev, key_width=16, val_width=32,
                      memtable_size=4096)
    db = DB(ds, ManualClock(start=1_000))
    keys = life_keys(np.arange(n_keys))
    vals = np.zeros((n_keys, 8), np.uint8)
    vals[:, 0] = ord("v")
    vals[:, 1:8] = keys[:, 1:8]
    t0 = time.perf_counter()
    ds.ingest(keys, vals, ts=db.clock.now())
    _sync(dev)
    out = {"keys": n_keys, "ingest_s": time.perf_counter() - t0}
    model = {bytes(k[:8]): bytes(v) for k, v in zip(keys, vals)}
    load = loadstats.RangeLoadStats(half_life_s=5.0, sample_size=32,
                                    seed=3, clock=clk)
    ds.load = load
    t0 = time.perf_counter()
    node = Node(1, db=db, heartbeat_interval_s=DIST_HB_S, ttl_ms=120_000,
                metrics_interval_s=3600.0, adopt_interval_s=3600.0,
                device=dev).start(
                    gossip_port=None, http_port=0)
    out["node_start_s"] = time.perf_counter() - t0
    life = node.ranger
    if life is None or ds.lease_check is None:
        raise AssertionError("Node.start wired no lifecycle or lease guard")
    life.stop()  # ticked below: the same decisions run after run
    life.store_nodes = {1: 1, 2: 2, 3: 2}  # stores 2 and 3 are node 2's
    lm = node.leases
    nl2 = liveness.NodeLiveness(db, 2, ttl_ms=120_000)
    nl2.heartbeat()
    lm.acquire(1)
    moves = []
    move = ds.move_range

    on_card = torch.device(dev).type == "cuda"

    def timed_move(range_id, to_store):
        a0, t1 = _allocated(on_card), time.perf_counter()
        n = move(range_id, to_store)
        _sync(dev)
        moves.append({"range": range_id, "to_store": to_store, "rows": n,
                      "s": time.perf_counter() - t1,
                      "device_bytes": [a0, _allocated(on_card)]})
        return n

    ds.move_range = timed_move
    c0 = (metric.KV_RANGE_SPLITS.value, metric.KV_LEASE_TRANSFERS.value,
          metric.KV_RANGE_MERGES.value)
    settings.set("kv.range.split_qps_threshold", 5.0)
    try:
        rng = random.Random(seed)
        hot = n_keys // 5
        t0 = time.perf_counter()
        for _ in range(n_ops):
            i = (rng.randrange(hot) if rng.random() < 0.8
                 else hot + rng.randrange(n_keys - hot))
            k, v = b"y%07d" % i, b"w%07d" % rng.randrange(10_000_000)
            db.put(k, v)
            model[k] = v
        _sync(dev)
        out["ops_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(4):
            life.tick()
        _sync(dev)
        out["ticks_s"] = time.perf_counter() - t0
        descs = ds.meta.snapshot()
        out["splits"] = metric.KV_RANGE_SPLITS.value - c0[0]
        out["lease_transfers"] = metric.KV_LEASE_TRANSFERS.value - c0[1]
        out["split_keys"] = [d.start_key.decode() for d in descs[1:]]
        out["ranges"] = [[d.range_id, d.store_id,
                          lm.holder(d.range_id).node_id] for d in descs]
        if not out["splits"] or not out["lease_transfers"] or not moves:
            raise AssertionError(f"lifecycle: no split, transfer or move: "
                                 f"{out}")
        if len({d.store_id for d in descs}) < 2:
            raise AssertionError("every range still on one store")
        out["moves"] = list(moves)
        if dict(db.scan(b"y", b"z")) != model:
            raise AssertionError("reads after the splits != the model")
        report = life.hot_ranges()["hotRanges"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{node.admin.port}/hot_ranges",
                timeout=30) as r:
            served = json.loads(r.read())["hotRanges"]
        if (sorted((h["rangeId"], h["storeId"], h["leaseholder"])
                   for h in served)
                != sorted((d.range_id, d.store_id,
                           lm.holder(d.range_id).node_id) for d in descs)):
            raise AssertionError(f"/hot_ranges {served} != Meta {descs}")
        out["hot_ranges_http"] = len(served)
        sess = Session(db=db, device=dev)
        sess.catalog._crdb_node = SimpleNamespace(ranger=life)
        hot_t = sess.execute("select * from crdb_internal.hot_ranges")
        want = {"range_id": [r["rangeId"] for r in report],
                "store_id": [r["storeId"] for r in report],
                "leaseholder": [r["leaseholder"] for r in report],
                "start_key": [r["startKey"] for r in report]}
        got = {c: np.asarray(hot_t[c]).tolist() for c in want}
        if got != want or sorted(want["range_id"]) != sorted(
                d.range_id for d in descs):
            raise AssertionError(f"hot_ranges {got} != {want}")
        shown = sess.execute("show ranges")
        if (np.asarray(shown["range_id"]).tolist()
                != [d.range_id for d in descs]
                or np.asarray(shown["store_id"]).tolist()
                != [d.store_id for d in descs]):
            raise AssertionError("SHOW RANGES != Meta")
        sess.close()
        clk.advance(3600.0)
        t0 = time.perf_counter()
        for _ in range(10):
            life.tick()
            if len(ds.meta.snapshot()) == 1:
                break
        _sync(dev)
        out["remerge_s"] = time.perf_counter() - t0
        out["merges"] = metric.KV_RANGE_MERGES.value - c0[2]
        if len(ds.meta.snapshot()) != 1 or not out["merges"]:
            raise AssertionError("the cold ranges never re-merged")
        if dict(db.scan(b"y", b"z")) != model:
            raise AssertionError("reads after the re-merge != the model")
        out["moves_after_merge"] = len(moves) - len(out["moves"])
    finally:
        settings.reset("kv.range.split_qps_threshold")
        ds.move_range = move
        t0 = time.perf_counter()
        node.stop()
        out["node_stop_s"] = time.perf_counter() - t0
    return out, db, ds, model


def _wait(cond, what: str, timeout_s: float = 30.0) -> float:
    """Seconds until cond() holds; raises after timeout_s."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)
    return time.perf_counter() - t0


def crash_node(node) -> None:
    """A node's process dies with its store left as it was: its loops
    stop without a clean ``stop`` (nothing released or unwired, the
    liveness record left to expire) and its Batch server
    closes under its clients' open connections."""
    node._stop.set()
    for t in node._threads:
        t.join(timeout=5)
    node.kv_rpc.close()
    node.kv_rpc = None


def dist_failover(db, ds, batches: int) -> dict:
    """Step 3: two Nodes over the cluster's DB, started with kv_port=0,
    gossip_port=0, http_port=0 and the range in lease_ranges, as
    tests/test_chaos.py wires them (their lease loops acquire and
    advertise the lease, their Batch servers carry the lease guard, node
    1 gossips with node 2; the allocator is off while they start, so no
    second lifecycle splits the range under the step). A LeaseRouter over
    node 2's gossip and dialer sends `batches` range-addressed puts to
    node 1; node 2 refuses the range. Then node 1 crashes (its loops
    stop, its Batch server closes): the put in flight surfaces as
    AmbiguousResultError, and a read through the router retries while
    node 1's record expires and node 2's lease loop fences it and takes
    the lease; the read lands on node 2 (the reroute), shows the
    ambiguous put absent, and it is re-sent; node 1's next heartbeat is
    fenced. Every key holds exactly one version."""
    import base64
    import threading

    from cockroach_tpu_torch.kv import liveness
    from cockroach_tpu_torch.kv.dist import LeaseRouter
    from cockroach_tpu_torch.kv.rpc import AmbiguousResultError
    from cockroach_tpu_torch.server.node import Node
    from cockroach_tpu_torch.utils import settings
    from cockroach_tpu_torch.utils.retry import RangeRetryBudget

    def e(b):
        return base64.b64encode(b).decode()

    dev = ds.device
    (rid,) = [d.range_id for d in ds.meta.snapshot()]
    kw = dict(db=db, heartbeat_interval_s=DIST_HB_S, ttl_ms=120_000,
              metrics_interval_s=3600.0, adopt_interval_s=3600.0,
              lease_ranges=[rid], device=dev)
    lm1 = liveness.LeaseManager(liveness.NodeLiveness(db, 1,
                                                      ttl_ms=120_000))
    lm1.liveness.heartbeat()
    if getattr(lm1.holder(rid), "node_id", None) != 1:
        lm1.transfer(rid, 1)  # the lifecycle may have left it on node 2
    out: dict = {}
    nodes = []
    settings.set("kv.allocator.enabled", False)
    try:
        # node 2 starts first, so the sender carries node 2's routing
        # guard: both nodes route through this one DistSender, and node
        # 1's guard would refuse node 2's own lease write once node 1 is
        # fenced (ROADMAP Queue 3 item 36)
        t0 = time.perf_counter()
        n2 = Node(2, **kw).start(gossip_port=0, kv_port=0, http_port=0)
        nodes.append(n2)
        n1 = Node(1, gossip_peers=[n2.gossip_addr()], **kw).start(
            gossip_port=0, kv_port=0, http_port=0)
        nodes.append(n1)
        out["nodes_start_s"] = time.perf_counter() - t0
        settings.reset("kv.allocator.enabled")
        out["lease_s"] = _wait(
            lambda: str(n2.gossip.get_info(f"lease/{rid}") or "")
            .startswith("1:")
            and n2.gossip.get_info("node/1/kv") is not None,
            "node 2 to learn node 1's lease and address")
        # the read below retries every 50 ms until node 2's lease loop
        # (every DIST_HB_S) has fenced node 1 and taken the lease: a
        # budget for the 10 s deadline, not the default 16 tokens
        router = LeaseRouter(n2.gossip, n2.dialer,
                             budget=RangeRetryBudget(budget=400.0),
                             resolve_timeout_s=10.0)
        t0 = time.perf_counter()
        for i in range(batches):
            router.batch(rid, [{"op": "put", "key": e(b"rpc%05d" % i),
                                "value": e(b"v%05d" % i)}])
        out["batches"] = batches
        out["batches_per_s"] = batches / (time.perf_counter() - t0)
        try:
            n2.dialer.dial(2).batch([{"op": "put", "key": e(b"rpcno"),
                                      "value": e(b"x")}], range_id=rid)
            raise AssertionError("node 2 served a range it does not hold")
        except liveness.NotLeaseHolderError:
            pass
        crash_node(n1)
        t0 = time.perf_counter()
        try:
            router.batch(rid, [{"op": "put", "key": e(b"rpc%05d" % batches),
                                "value": e(b"maybe")}])
            raise AssertionError("a put to a closed server succeeded")
        except AmbiguousResultError as err:
            out["ambiguous"] = {"cid": err.cid, "seq": err.seq}
        done = {}

        def read():
            try:
                done["out"] = router.batch(rid, [{"op": "get", "key": e(
                    b"rpc%05d" % batches)}])
                done["ms"] = (time.perf_counter() - t0) * 1e3
            except Exception as err:  # noqa: BLE001 - re-raised below
                done["err"] = err

        th = threading.Thread(target=read)
        th.start()
        db.clock.advance(2 * n1.liveness.ttl_ms)  # node 1's record lapses
        th.join(timeout=60)
        if "err" in done or "out" not in done:
            raise AssertionError(f"the router never rerouted: {done}")
        if done["out"] != [{"value": None}] or router.leaseholder(rid) != 2:
            raise AssertionError(f"reroute read {done['out']}")
        out["reroute_ms"] = done["ms"]
        router.batch(rid, [{"op": "put", "key": e(b"rpc%05d" % batches),
                            "value": e(b"resent")}])
        try:
            n1.liveness.heartbeat()
            raise AssertionError("node 1 was not fenced")
        except liveness.EpochFencedError:
            pass
        (d,) = ds.meta.snapshot()
        got = ds.stores[d.store_id].engine.export_span(b"rpc0", b"rpc9")
        uniq, counts = np.unique(np.asarray(got["key"]), axis=0,
                                 return_counts=True)
        if len(uniq) != batches + 1 or counts.max() != 1:
            raise AssertionError(f"{len(uniq)} keys, most versions "
                                 f"{counts.max()}: a double apply")
        out["versions_per_key"] = int(counts.max())
    finally:
        settings.reset("kv.allocator.enabled")
        t0 = time.perf_counter()
        for n in reversed(nodes):
            n.stop()
        out["nodes_stop_s"] = time.perf_counter() - t0
    return out


def dist_replication(db, dev, model: dict, inserts: int = 256) -> dict:
    """Step 5: a ReplicationStream from a RangefeedServer over the
    lifecycle cluster's keyspace ("y") into a standby single engine on
    the card: the catch-up (events/s), then `inserts` puts while it runs
    live (the frontier's lag behind a put: median and most of the nine
    sampled); after cutover the standby's scan at the frontier equals
    the cluster's."""
    from cockroach_tpu_torch.kv.changefeed import RangefeedServer
    from cockroach_tpu_torch.kv.hlc import ManualClock
    from cockroach_tpu_torch.kv.replication import ReplicationStream
    from cockroach_tpu_torch.kv.txn import DB
    from cockroach_tpu_torch.storage.lsm import Engine

    # the stream lands in one memtable (2^17 rows): no flush, so the
    # IOGovernor's write pacing of a many-run LSM (1 ms a put per run over
    # its healthy count) never engages mid-stream
    standby = DB(Engine(key_width=16, val_width=16, memtable_size=1 << 17,
                        device=dev), ManualClock(start=1))
    srv = RangefeedServer(db, poll_interval_s=0.02, device=dev)
    try:
        t0 = time.perf_counter()
        repl = ReplicationStream(srv.addr, standby, start=b"y",
                                 end=b"z").run_background()
        n0 = len(model)
        mark = db.put(b"y%07d" % n0, b"n%07d" % 0)
        if not repl.wait_for_frontier(mark, timeout_s=300.0):
            raise AssertionError(f"frontier {repl.frontier} never reached "
                                 f"{mark}")
        catchup_s = time.perf_counter() - t0
        caught = repl.applied
        # live: each insert's wait until the frontier passes it
        lags = []
        for i in range(1, inserts):
            mark = db.put(b"y%07d" % (n0 + i), b"n%07d" % i)
            if i % 32 == 0 or i == inserts - 1:
                t1 = time.perf_counter()
                if not repl.wait_for_frontier(mark, timeout_s=60.0):
                    raise AssertionError("the live frontier stalled")
                lags.append((time.perf_counter() - t1) * 1e3)
        frontier = repl.cutover()
        got = standby.scan(b"y", b"z", ts=frontier)
        want = db.scan(b"y", b"z", ts=frontier)
        if got != want or len(want) != n0 + inserts:
            raise AssertionError(f"standby {len(got)} rows != source "
                                 f"{len(want)} at the frontier")
        return {"events": repl.applied, "rows": len(want),
                "catchup_events": caught, "catchup_s": catchup_s,
                "events_per_s": caught / catchup_s,
                "frontier_lag_ms": sorted(lags)[len(lags) // 2],
                "frontier_lag_max_ms": max(lags),
                "reconnects": repl.reconnects}
    finally:
        srv.close()
        standby.engine.close()


def dist_sql(dev, sf: float) -> dict:
    """Step 7: TPC-H at `sf` loaded into a DIST_STORES-store cluster
    (16-byte keys), lineitem's span split in three and the pieces moved
    to stores 1-3; bench.py's ladder over KV held to the oracle."""
    from cockroach_tpu_torch.bench import tpch_kv
    from cockroach_tpu_torch.bench.tpch import gen_tpch
    from cockroach_tpu_torch.bench.tpch_run import LADDER
    from cockroach_tpu_torch.storage import rowcodec

    host = gen_tpch(sf=sf, seed=TPCH_SEED, device=dev)
    cat, db, load = tpch_kv.load_tpch_kv(host, device=dev,
                                         stores=DIST_STORES)
    ds = db.engine
    li = cat.get("lineitem")
    cols = host.get("lineitem").columns
    pks = np.sort(np.asarray(tpch_kv.lineitem_key(
        np.asarray(cols["l_orderkey"]), np.asarray(cols["l_linenumber"]))))
    cut = rowcodec.encode_pk_batch(li.table_id, pks[[len(pks) // 3,
                                                     2 * len(pks) // 3]])
    start, end = rowcodec.table_span(li.table_id)
    bounds = [bytes(k).rstrip(b"\x00") for k in cut]
    for b in bounds + [end]:
        ds.split_at(b)
    moved = []
    t0 = time.perf_counter()
    for b, to in zip(bounds, (2, 3)):
        moved.append(ds.move_range(ds.meta.lookup(b).range_id, to))
    _sync(dev)
    move_s = time.perf_counter() - t0
    res = tpch_kv.run_tpch_kv(cat, host, LADDER, runs=0, device=dev)
    if {res[q]["held_to"] for q in LADDER} != {"oracle"}:
        raise AssertionError("a ladder query was not held to the oracle")
    return {"sf": sf, "load_s": load["load_s"], "rows": load["rows"],
            "ranges": [[d.range_id, d.store_id] for d in
                       ds.meta.snapshot()],
            "lineitem_moved": moved, "move_s": move_s,
            "ladder_ms": {q: [res[q]["cold_s"] * 1e3, res[q]["warm_s"] * 1e3]
                          for q in LADDER},
            "held_to": {q: res[q]["held_to"] for q in LADDER}}


def run_dist_phase(card: str, dev="cuda", n_keys: int = DIST_KEYS,
                   ops: int = DIST_OPS, life_keys_n: int = DIST_LIFE_KEYS,
                   life_ops: int = DIST_LIFE_OPS,
                   batches: int = DIST_RPC_BATCHES, sql_sf: float = DIST_SQL_SF,
                   coalesce_kw: dict | None = None) -> dict:
    """The seven steps of the ``dist`` phase; every gate raises. Every K2
    merge of the phase is held to merge_perm_plain (K2Witness), and on
    the card their number must equal K2's launches in the phase."""
    from cockroach_tpu_torch.bench.load import run_coalesce_ab
    from cockroach_tpu_torch.kv.upgrade import (BINARY_VERSION,
                                                 active_version, run_upgrades)

    secs: dict = {}
    k2_before = cuda_merge.merge_perm.launches
    with K2Witness() as k2:
        ticker = TsdbTicker(dev)
        t = time.perf_counter()
        y = dist_ycsb(dev, n_keys, ops)
        secs["ycsb"] = time.perf_counter() - t
        t = time.perf_counter()
        life, db, ds, model = dist_lifecycle(dev, life_keys_n, life_ops)
        secs["lifecycle"] = time.perf_counter() - t
        t = time.perf_counter()
        rpc = dist_failover(db, ds, batches)
        secs["failover"] = time.perf_counter() - t
        t = time.perf_counter()
        coal = run_coalesce_ab(device=dev, **(DIST_COALESCE
                                               if coalesce_kw is None
                                               else coalesce_kw))
        if not coal["coalesce_oracle_ok"] or coal["coalesce_errors"]:
            raise AssertionError(f"commit train: {coal}")
        secs["coalesce"] = time.perf_counter() - t
        t = time.perf_counter()
        repl = dist_replication(db, dev, model)
        secs["replication"] = time.perf_counter() - t
        ups = [run_upgrades(db), run_upgrades(db)]
        if ups[1] or active_version(db) != BINARY_VERSION:
            raise AssertionError(f"run_upgrades not idempotent: {ups}")
        t = time.perf_counter()
        sql = dist_sql(dev, sql_sf)
        secs["sql"] = time.perf_counter() - t
        ts = ticker.close()
    k2_launches = cuda_merge.merge_perm.launches - k2_before
    if torch.device(dev).type == "cuda" and k2.pairs != k2_launches:
        raise AssertionError(f"K2 checked {k2.pairs} merges of "
                             f"{k2_launches} launches in the dist phase")
    for s in ds.stores.values():
        s.engine.close()
    out = {"ycsb_e": y, "single_engine_ycsb": dict(YCSB_FIGURES),
           "lifecycle": life, "failover": rpc,
           "coalesce": coal, "replication": repl,
           "tsdb": ts, "upgrades": {"ran": ups,
                                    "version": list(BINARY_VERSION)},
           "sql": sql, "k2_merges_checked": k2.pairs,
           "k2_launches": k2_launches,
           "k2_check_s": k2.seconds, "steps_s": secs, "card": card}
    emit({"dist": out}, {"dist": {
        "ycsb": {k: y[k] for k in ("load_s", "ops_per_sec",
                                   "rows_per_sec", "launches")},
        "single": dict(YCSB_FIGURES),
        "splits": life["splits"], "moves": len(life["moves"]),
        "merges": life["merges"], "reroute_ms": rpc["reroute_ms"],
        "coalesce_speedup": coal["coalesce_speedup"],
        "repl_events_per_s": repl["events_per_s"],
        "sql_ms": sql["ladder_ms"], "steps_s": secs}})
    return out


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


def fusion_runs(cat, q: str, on: bool, runs: int,
                profile: bool = True) -> tuple[dict, dict]:
    """Query q over cat with fusion on or off: a cold run, a second run
    (join capacities learned in the first take effect), then `runs` more,
    timed; then, with `profile`, one profiled run. Graph captures of each
    stage, host syncs, dispatches, graph replays of the timed runs,
    launches (profiled) and peak memory. -> (figures, result)"""
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
        r0 = dispatch.replays()
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
        replays = (dispatch.replays() - r0) / runs
        fill_s = io_report(root)["fill_wait_s"]
        prof = (launch_profile(lambda: run_operator(root)) if profile
                else dict.fromkeys(("host_launches", "graph_launches",
                                    "device_ops", "idle_share")))
        tiles = lineitem_tiles(root)
        med = statistics.median(times)
        fig = {"median_ms": med * 1e3,
               "rows_per_sec": cat.get("lineitem").num_rows / med,
               "cold_ms": t_cold * 1e3, "captures": caps,
               "host_syncs": sum(host_syncs(root).values()),
               "dispatches": disp, "dispatches_per_tile": disp / tiles,
               "eager_dispatches": eager, "replays": replays,
               "launches_per_tile": (None if prof["host_launches"] is None
                                     else prof["host_launches"] / tiles),
               "graph_launches": prof["graph_launches"],
               "device_ops_per_tile": (None if prof["device_ops"] is None
                                       else prof["device_ops"] / tiles),
               "idle_share": prof["idle_share"], "tiles": tiles,
               "fill_wait_s": fill_s, "base_gb": base / 1e9,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}
        return fig, want
    finally:
        settings.reset("sql.distsql.fusion.enabled")


def fusion_compare(cat, queries=("q3", "q9", "q18"), runs: int = 5,
                   profiled=("q3", "q9", "q18")) -> dict:
    """Each query fused and unfused in turn on one card: the figures of
    fusion_runs side by side, the two results held equal bit for bit,
    and the fused path held to its contract: graphs captured on the first
    run and replayed in the timed runs, none captured on a repeat run, no
    eager device function. The queries in `profiled` get a profiled run
    each way."""
    out = {}
    for q in queries:
        unfused, a = fusion_runs(cat, q, False, runs, q in profiled)
        fused, b = fusion_runs(cat, q, True, runs, q in profiled)
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
    # q3 alone profiled each way, as at SF10 (a depth cut for the 1000 s
    # budget: q9's and q18's profiles went)
    fusion[f"sf{sf:g}"] = fusion_compare(cat, runs=DEPTH_RUNS,
                                         profiled=("q3",))
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
              ops_ms: dict | None = None, profiled=None) -> dict:
    """bench.py's ladder over KV: run_tpch_kv's figures (every run held to
    the oracle) plus, for each query of `profiled` (default all), one
    profiled run of a tree that has run once, with its syncs (the operators' counted syncs, a KV scan
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
        if profiled is not None and q not in profiled:
            out[q] = [r["median_s"], r["cold_s"], r["decode_s"], None, None,
                      None, None, r["peak_device_bytes"], None]
            continue
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
        # q3 alone profiled after the refresh (a depth cut for the
        # 1000 s budget, PERF.md §4)
        after = kv_ladder(cat, tpch_kv.refreshed_catalog(host, rf), dev,
                          runs, profiled=("q3",))
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
    (three literal sets) and q18 once each, equal to one
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
    from cockroach_tpu_torch.utils import metric

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
            for _ in range(DEPTH_RUNS):
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
        reps = 1
        single = [conn.query(t) for t in texts]
        t0 = time.perf_counter()
        for _ in range(reps):
            for t in texts:
                conn.query(t)
        one_s = time.perf_counter() - t0

        def four_conns(what: str) -> float:
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
            secs = time.perf_counter() - t0
            if errs:
                raise errs[0]
            if len(outs) != 4 * reps or any(o != single for o in outs):
                raise AssertionError(
                    f"4 concurrent connections{what} != one")
            log(f"SQL 4 connections{what} x {reps} x {len(texts)} "
                "statements == one connection")
            return secs

        four_s = four_conns("")
        # the same four again over shared tile streams (flow/sharedscan.py)
        attached0 = metric.SQL_SHARED_SCAN_ATTACHED.value
        saved0 = metric.SQL_SHARED_SCAN_DISPATCHES_SAVED.value
        conn.query("SET CLUSTER SETTING sql.distsql.sharedscan.enabled = "
                   "true")
        try:
            shared_s = four_conns(" with sharedscan")
        finally:
            conn.query("SET CLUSTER SETTING sql.distsql.sharedscan.enabled "
                       "= false")
        sharedscan = {
            "attached": int(metric.SQL_SHARED_SCAN_ATTACHED.value
                            - attached0),
            "dispatches_saved": int(
                metric.SQL_SHARED_SCAN_DISPATCHES_SAVED.value - saved0),
            "four_conns_s": shared_s, "off_s": four_s, "card": card}
        emit({"sharedscan": sharedscan})
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
MENU_SERVING_RUNS = 2  # each text served after the menu (a depth cut from 3)
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
    start): with ``sql.warmup.menu.enabled``, ``Node.start(pg_port=0,
    http_port=0)`` serves pgwire over the catalog and builds the menu
    (``warmmenu.warm_node``), the 22 TPC-H texts as the explicit course,
    before it returns; every item's status, runs and captures, and the cache's
    bytes (what each entry holds) against its budget, none evicted and
    none at 0 bytes; then over the wire MENU_SERVING_RUNS serving runs of
    each text, each run's ms and new captures (0 for every compiled item) and its
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
    from cockroach_tpu_torch.server.node import Node
    from cockroach_tpu_torch.sql import (diagnostics, plancache, sqlstats,
                                         warmmenu)
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
        menu = [(TPCH_SQL[q], {"sql.opt.join_order": order})
                for q, order in SQL_JOIN_ORDER.items()]
        menu += [TPCH_SQL[q] for q in queries if q not in SQL_JOIN_ORDER]
        t0 = time.perf_counter()
        # Node.start serves pgwire over the catalog and builds the menu
        # (sql/warmmenu.warm_node) before it returns
        node = Node(1, catalog=fresh, menu=menu, ttl_ms=60_000,
                    metrics_interval_s=3600.0, device=dev).start(
                        gossip_port=None, pg_port=0, http_port=0)
        build_s = time.perf_counter() - t0
        srv = node.pg
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
                    for _ in range(MENU_SERVING_RUNS):
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
            node.stop()
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
    log(f"menu: 22 texts x {MENU_SERVING_RUNS} serving runs == hand-built "
        "(ladder == oracle), "
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
                       *(f"{k}{i}" for i in range(1, MENU_SERVING_RUNS + 1)
                         for k in ("ms", "caps")), "equal"],
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
TPCC_W = 1
TPCC_SPEC = {"districts": 10, "customers": 3000, "items": 100_000}
TPCC_TXNS = 25
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


@contextlib.contextmanager
def io_pacing_off():
    """The IOGovernor's write pacing off for the block (a bulk import or
    rewrite), as an operator would set it."""
    from cockroach_tpu_torch.utils import settings

    settings.set("admission.io_pacing.enabled", False)
    try:
        yield
    finally:
        settings.reset("admission.io_pacing.enabled")


def tpcc_load(sess, **sizes) -> tuple[float, float]:
    """bench/tpcc.load with IO pacing off, as for a bulk import, then a
    flush and a full compaction; returns the two parts' seconds."""
    from cockroach_tpu_torch.bench import tpcc

    with io_pacing_off():
        t0 = time.perf_counter()
        tpcc.load(sess, **sizes)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sess.db.engine.flush()
        sess.db.engine.compact(bottom=True)
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
# Node liveness, jobs fencing and orphan adoption, online ALTER TABLE,
# BACKUP/RESTORE and tenants (kv/liveness.py, kv/jobs.py,
# sql/schemachange.py, utils/external_storage.py, kv/tenant.py) over TPC-C
# at W=1: the schema-change roachtests' work on a loaded TPC-C, reduced to
# one session

JOBS_TTL_MS = 500  # the two nodes' liveness ttl
JOBS_CRASH_AFTER = 50  # node 1 crashes after this chunk of the stock ALTER
# TPC-C transactions on the new descriptors, and after the backup (gone at
# the restore): depth cuts from 20 and 10 for the default run's budget
JOBS_MIX_TXNS = 10
JOBS_LOST_TXNS = 5
JOBS_SMALL_CRASH_AFTER = 2  # TPCC_SMALL's stock: 2000 rows, 4 chunks


def table_digests(state: dict) -> dict:
    """sha256 of each table's tpcc_state columns (names, dtypes, bytes)."""
    import hashlib

    out = {}
    for t, cols in state.items():
        h = hashlib.sha256()
        for c, v in cols.items():
            a = np.asarray(v)
            h.update(f"{c}:{a.dtype}:{a.shape}".encode())
            h.update("\x00".join(map(str, a.tolist())).encode()
                     if a.dtype == object else np.ascontiguousarray(a)
                     .tobytes())
        out[t] = h.hexdigest()
    return out


def state_rows(state: dict) -> set:
    """Every row of a tpcc_state snapshot as (table, row tuple)."""
    return {(t, row) for t, cols in state.items()
            for row in zip(*(np.asarray(v).tolist()
                             for v in cols.values()))}


def _allocated(on_card: bool) -> int | None:
    if not on_card:
        return None
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def timed_alter(sess, text: str, on_card: bool, say=log) -> dict:
    """One ALTER TABLE through the session, its backfill unpaced as a bulk
    rewrite (io_pacing_off): rows, chunks, the backfill's and the
    descriptor swap's times, device bytes before and after."""
    from cockroach_tpu_torch.sql import schemachange

    swap_s = []
    swap = schemachange._swap_descriptor

    def timed_swap(*a, **k):
        t = time.perf_counter()
        try:
            return swap(*a, **k)
        finally:
            swap_s.append(time.perf_counter() - t)

    name = text.split()[2]
    rows = int(sess.execute(f"select count(*) as n from {name}")["n"][0])
    before = _allocated(on_card)
    schemachange._swap_descriptor = timed_swap
    t0 = time.perf_counter()
    try:
        with io_pacing_off():
            sess.execute(text)
    finally:
        schemachange._swap_descriptor = swap
    total = time.perf_counter() - t0
    backfill_s = total - sum(swap_s)
    out = {"rows": rows, "chunks": -(-rows // schemachange.CHUNK_ROWS),
           "backfill_s": backfill_s, "rows_per_s": rows / backfill_s,
           "swap_ms": 1e3 * sum(swap_s), "device_bytes_before": before,
           "device_bytes_after": _allocated(on_card)}
    say(f"jobs: {text}: {rows} rows, {out['chunks']} chunks, backfill "
        f"{backfill_s:.2f}s ({out['rows_per_s']:.0f} rows/s), swap "
        f"{out['swap_ms']:.1f} ms, device bytes {before} -> "
        f"{out['device_bytes_after']}")
    return out


def crash_and_failover(sess, text: str, crash_after: int, say=log) -> dict:
    """`text` (an ALTER TABLE) as a schema_change job claimed by node 1,
    whose process dies right after the checkpoint of chunk `crash_after`
    (the resumer driven directly, its checkpoint raising, as
    tests/test_schemachange.py does). Node 1 stops heartbeating; once
    its record expires node 2's adopt_orphans fences it and resumes from
    the checkpoint; node 1's late checkpoint must raise EpochFencedError.
    The catalog serves the old schema until the swap. Both backfills run
    unpaced, as timed_alter's do."""
    from cockroach_tpu_torch.kv.jobs import Registry
    from cockroach_tpu_torch.kv.liveness import EpochFencedError, NodeLiveness
    from cockroach_tpu_torch.sql import schemachange as sc
    from cockroach_tpu_torch.sql.parser import parse_statement

    class Crash(Exception):
        pass

    stmt = parse_statement(text)
    db, cat = sess.db, sess.catalog
    lv1 = NodeLiveness(db, 1, ttl_ms=JOBS_TTL_MS)
    lv2 = NodeLiveness(db, 2, ttl_ms=JOBS_TTL_MS)
    lv1.heartbeat()
    lv2.heartbeat()
    reg1 = Registry(db, node_id=1, liveness=lv1)
    reg2 = Registry(db, node_id=2, liveness=lv2)
    for reg in (reg1, reg2):
        sc.register_schema_change_job(reg, cat)
    job = reg1.create("schema_change", sc.plan_alter(cat, db, stmt))
    claimed = reg1._claim(job.job_id, reg1.load(job.job_id))
    assert claimed.claim_node == 1 and claimed.claim_epoch == 1, claimed
    checkpoint = reg1.checkpoint
    done = {"n": 0}

    def crashing_checkpoint(j):
        checkpoint(j)
        done["n"] += 1
        if done["n"] == crash_after:
            raise Crash(f"node 1 died after chunk {crash_after}")

    reg1.checkpoint = crashing_checkpoint
    t0 = time.perf_counter()
    try:
        with io_pacing_off():
            sc.backfill(reg1, claimed, cat)
        raise AssertionError("the injected crash did not happen")
    except Crash:
        pass
    crash_s = time.perf_counter() - t0
    reg1.checkpoint = checkpoint
    table = cat.tables[stmt.name]
    if stmt.column.name in table.schema.names:
        raise AssertionError("the new column is visible before the swap")
    last_pk = reg1.load(job.job_id).progress["last_pk"]
    # node 1 is dark; node 2 keeps heartbeating until node 1 expires
    while lv2.is_live(1):
        lv2.heartbeat()
        time.sleep(0.01)
    t_expired = time.perf_counter()
    claims, chunks2 = [], []
    claim, checkpoint2 = reg2._claim, reg2.checkpoint

    def timed_claim(*a, **k):
        claims.append(time.perf_counter())
        return claim(*a, **k)

    def counted_checkpoint(j):
        if j.state == "running" and "last_pk" in j.progress:
            chunks2.append(j.progress["last_pk"])
        return checkpoint2(j)

    reg2._claim, reg2.checkpoint = timed_claim, counted_checkpoint
    with io_pacing_off():
        adopted = reg2.adopt_orphans()
    resume_s = time.perf_counter() - t_expired
    reg2._claim, reg2.checkpoint = claim, checkpoint2
    if [j.job_id for j in adopted] != [job.job_id]:
        raise AssertionError(f"node 2 adopted {adopted}, not job "
                             f"{job.job_id}")
    final = reg2.load(job.job_id)
    if final.state != "succeeded" or final.claim_node != 2:
        raise AssertionError(f"adopted job ended {final.state} on node "
                             f"{final.claim_node}")
    if stmt.column.name not in cat.tables[stmt.name].schema.names:
        raise AssertionError("the swap did not install the new column")
    try:
        reg1.checkpoint(claimed)
        raise AssertionError("node 1's late checkpoint was not fenced")
    except EpochFencedError:
        pass
    try:
        lv1.heartbeat()
        raise AssertionError("node 1's heartbeat was not fenced")
    except EpochFencedError:
        pass
    sess._invalidate_plans()  # the job ran beside the session
    rows = int(sess.execute(f"select count(*) as n from {stmt.name}")
               ["n"][0])
    chunks = -(-rows // sc.CHUNK_ROWS)
    # chunk txns run in all: node 1's before the crash, node 2's after
    rerun = crash_after + len(chunks2) - chunks
    if not 0 <= rerun <= 1:
        raise AssertionError(f"{rerun} chunks re-ran after the failover")
    say(f"jobs: {stmt.name} ALTER: node 1 died after chunk {crash_after} "
        f"({crash_s:.2f}s), node 2 adopted {1e3 * (claims[0] - t_expired):.1f}"
        f" ms after expiry and finished in {resume_s:.2f}s, {rerun} chunks "
        "re-run, node 1 fenced")
    return {"rows": rows, "chunks": chunks,
            "chunks_before_crash": crash_after, "crash_last_pk": last_pk,
            "crash_s": crash_s, "node1_epoch": lv2._read(1).epoch,
            "expiry_to_adoption_ms": 1e3 * (claims[0] - t_expired),
            "resume_s": resume_s, "chunks_rerun": rerun, "fenced": True}


def jobs_sequence(sess, sizes: dict, crash_after: int, backup_uri: str,
                  on_card: bool = False, say=log) -> dict:
    """Steps 3-7 of the jobs phase on a loaded TPC-C session: ALTER ADD a
    STRING column (customer), ALTER ADD an INT column (stock) with the
    crash and failover, the TPC-C mix and its consistency on the new
    descriptors, ALTER DROP the STRING column, BACKUP, more transactions,
    RESTORE with every table's digest back to the backup's."""
    import gc
    import weakref

    from cockroach_tpu_torch.bench import tpcc

    w, d = sizes["warehouses"], sizes["districts"]
    spec = {k: sizes[k] for k in ("districts", "customers", "items")}
    out = {"add_string": timed_alter(
        sess, "ALTER TABLE customer ADD COLUMN c_credit STRING "
              "DEFAULT 'GC'", on_card, say)}
    out["failover"] = crash_and_failover(
        sess, "ALTER TABLE stock ADD COLUMN s_remote_cnt INT DEFAULT 0",
        crash_after, say)
    mix = tpcc.run_mix(sess, txns=JOBS_MIX_TXNS, warehouses=w, seed=1,
                       **spec)
    tpcc.check_consistency(sess, warehouses=w, districts=d)
    n_gc = int(sess.execute("select count(*) as n from customer where "
                            "c_credit = 'GC'")["n"][0])
    n_cust = w * d * sizes["customers"]
    remote = sess.execute("select sum(s_remote_cnt) as s from stock")["s"]
    if n_gc != n_cust or int(remote[0]) != 0:
        raise AssertionError(f"new columns: {n_gc} of {n_cust} customers "
                             f"at 'GC', sum(s_remote_cnt) {remote[0]}")
    out["mix"] = {"txns": JOBS_MIX_TXNS, "counts": mix["counts"],
                  "give_ups": mix["give_ups"], "consistent": True}
    out["drop_string"] = timed_alter(
        sess, "ALTER TABLE customer DROP COLUMN c_credit", on_card, say)
    gc.collect()
    before = _allocated(on_card)
    t0 = time.perf_counter()
    bk = sess.execute(f"BACKUP TO '{backup_uri}'")
    backup_s = time.perf_counter() - t0
    if bk["state"] != "succeeded":
        raise AssertionError(f"BACKUP ended {bk['state']}")
    from cockroach_tpu_torch.utils.external_storage import resolve_dir_uri

    path = resolve_dir_uri(backup_uri)
    nbytes = sum(os.path.getsize(os.path.join(r, f))
                 for r, _, fs in os.walk(path) for f in fs)
    at_backup = tpcc_state(sess)
    tpcc.run_mix(sess, txns=JOBS_LOST_TXNS, warehouses=w, seed=2, **spec)
    written = state_rows(tpcc_state(sess)) - state_rows(at_backup)
    old = weakref.ref(sess.db.engine)
    t0 = time.perf_counter()
    sess.execute(f"RESTORE FROM '{backup_uri}'")
    restore_s = time.perf_counter() - t0
    gc.collect()
    if old() is not None:
        raise AssertionError("the pre-RESTORE engine is still referenced")
    after = _allocated(on_card)
    restored = tpcc_state(sess)
    if table_digests(restored) != table_digests(at_backup):
        bad = same_tables(restored, at_backup)
        raise AssertionError(f"RESTORE != the backup: {bad}")
    tpcc.check_consistency(sess, warehouses=w, districts=d)
    if not written or written & state_rows(restored):
        raise AssertionError("rows written after the backup survived")
    say(f"jobs: BACKUP {backup_s:.2f}s ({nbytes} bytes), RESTORE "
        f"{restore_s:.2f}s, {len(written)} rows gone, digests equal, device "
        f"bytes {before} -> {after}")
    out["backup"] = {"backup_s": backup_s, "bytes": nbytes,
                     "restore_s": restore_s, "rows_gone": len(written),
                     "lost_txns": JOBS_LOST_TXNS, "digests_equal": True,
                     "consistent": True, "device_bytes_before": before,
                     "device_bytes_after": after, "old_engine_freed": True}
    return out


def jobs_small_state(device: str, threads: int | None = None) -> dict:
    """jobs_sequence at TPCC_SMALL on `device`, crashing after chunk
    JOBS_SMALL_CRASH_AFTER, backing up under a temporary nodelocal base;
    its final tables."""
    import tempfile

    from cockroach_tpu_torch.sql import Session
    from cockroach_tpu_torch.utils.external_storage import set_nodelocal_base

    if threads is not None:
        torch.set_num_threads(threads)
    s = Session(val_width=256, device=device)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            set_nodelocal_base(tmp)
            tpcc_load(s, **TPCC_SMALL)
            jobs_sequence(s, TPCC_SMALL, JOBS_SMALL_CRASH_AFTER,
                          "nodelocal://1/small", say=lambda msg: None)
        return tpcc_state(s)
    finally:
        s.close()


def tenant_checks(sess, dev) -> dict:
    """CREATE TENANT, a tenant session on `dev` creating, writing and
    reading a table the system session cannot see, and REVOKE
    CAPABILITY can_create_table refusing its next CREATE TABLE."""
    from cockroach_tpu_torch.kv.tenant import CapabilityError
    from cockroach_tpu_torch.sql import Session

    rec = sess.execute("CREATE TENANT t1")
    ts = Session(db=sess.db, tenant="t1", device=dev)
    try:
        ts.execute("CREATE TABLE t1_kv (k INT PRIMARY KEY, v INT)")
        ts.execute("INSERT INTO t1_kv VALUES " + ", ".join(
            f"({k}, {k * 7})" for k in range(64)))
        got = ts.execute("SELECT sum(v) AS s FROM t1_kv")["s"]
        tid = ts.catalog.tables["t1_kv"].table_id
        in_slice = ts.tenant.id_lo <= tid <= ts.tenant.id_hi
        if int(got[0]) != 7 * sum(range(64)) or not in_slice:
            raise AssertionError(f"tenant table: sum {got[0]}, id {tid}")
        try:
            sess.execute("SELECT v FROM t1_kv")
            raise AssertionError("the system session sees t1's table")
        except KeyError:  # the catalog's unknown-table error
            pass
    finally:
        ts.close()
    sess.execute("ALTER TENANT t1 REVOKE CAPABILITY can_create_table")
    ts = Session(db=sess.db, tenant="t1", device=dev)
    try:
        ts.execute("CREATE TABLE t1_more (k INT PRIMARY KEY)")
        raise AssertionError("a revoked capability let CREATE TABLE pass")
    except CapabilityError:
        pass
    finally:
        ts.close()
    return {"tenant_id": int(rec["tenant_id"]), "table_id": tid,
            "isolated": True, "capability_refused": True}


def run_jobs_phase(card: str, dev="cuda", warehouses: int = 1,
                   crash_after: int = JOBS_CRASH_AFTER,
                   overload_s: float = 6.0) -> dict:
    """The jobs phase: TPC-C at `warehouses` (TPCC_SPEC's cardinalities)
    loaded into one session's engine on `dev`, then jobs_sequence (two
    ALTERs, the crash/failover between nodes 1 and 2, TPC-C on the new
    descriptors, DROP COLUMN, BACKUP/RESTORE), the tenant checks and
    run_tenant_overload at the reference's defaults: every refusal typed
    is held, the goodput and isolation verdicts are reported (the
    reference's admission fails them too: ROADMAP Queue 3 item 28);
    then jobs_sequence at TPCC_SMALL on the card and on the CPU (a
    spawned process of its own, beside the rest), final states equal
    row for row. Any K2 merge is held to the plain merge (K2Witness).
    Prints the ``{"jobs": ...}`` line."""
    import concurrent.futures
    import multiprocessing
    import tempfile

    from cockroach_tpu_torch.bench.load import run_tenant_overload
    from cockroach_tpu_torch.sql import Session
    from cockroach_tpu_torch.utils.external_storage import set_nodelocal_base

    t_phase = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    on_cpu = pool.submit(jobs_small_state, "cpu", 1)
    sizes = {"warehouses": warehouses, **TPCC_SPEC}
    try:
        with K2Witness() as k2, tempfile.TemporaryDirectory() as tmp:
            set_nodelocal_base(tmp)
            sess = Session(val_width=256, device=dev)
            load_s, compact_s = tpcc_load(sess, **sizes)
            log(f"jobs: TPC-C W={warehouses} loaded in {load_s:.1f}s")
            out = {"warehouses": warehouses, **TPCC_SPEC, "load_s": load_s,
                   "compact_s": compact_s}
            out.update(jobs_sequence(sess, sizes, crash_after,
                                     "nodelocal://1/tpcc", on_card))
            out["tenants"] = tenant_checks(sess, dev)
            log(f"jobs: tenants {out['tenants']}")
            sess.close()
            del sess
            t0 = time.perf_counter()
            ovl = run_tenant_overload(duration_s=overload_s, device=dev)
            ovl["seconds"] = time.perf_counter() - t0
            out["overload"] = ovl
            log("jobs: overload " + json.dumps(_sig4({
                k: v for k, v in ovl.items()
                if k not in ("rejections_by_reason", "last_error")})))
            if not ovl["oracle_typed_ok"]:
                raise AssertionError(f"tenant overload: a refusal was not "
                                     f"a typed AdmissionRejectedError, or "
                                     f"none was shed: {ovl}")
            if not ovl["oracle_ok"]:
                log("jobs: the overload oracle failed (goodput "
                    f"{ovl['oracle_goodput_ok']}, isolation "
                    f"{ovl['oracle_isolation_ok']}): ROADMAP Queue 3 "
                    "item 28")
            t0 = time.perf_counter()
            card_state = jobs_small_state(dev)
            out["small_s"] = time.perf_counter() - t0
            cpu_state = on_cpu.result(timeout=900)
        out["k2_witnessed_pairs"] = k2.pairs
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    bad = same_tables(card_state, cpu_state)
    if bad is not None:
        raise AssertionError(f"jobs small run, card != CPU: {bad}")
    out.update({"small_card_eq_cpu": True,
                "phase_s": time.perf_counter() - t_phase, "card": card})
    a, f, b = out["add_string"], out["failover"], out["backup"]
    emit({"jobs": out}, {"jobs": {
        "load_s": load_s, "add_rows_per_s": a["rows_per_s"],
        "stock_resume_s": f["resume_s"],
        "adoption_ms": f["expiry_to_adoption_ms"],
        "rerun": f["chunks_rerun"], "backup_s": b["backup_s"],
        "restore_s": b["restore_s"], "rows_gone": b["rows_gone"],
        "overload_goodput": ovl["goodput_frac_of_saturation"],
        "isolation": ovl["isolation_ratio"],
        "overload_oracle_ok": ovl["oracle_ok"], "small_eq": True,
        "phase_s": out["phase_s"]}})
    return out


# ---------------------------------------------------------------------------
# Materialized views and the changefeed fan-out (flow/viewmaint.py,
# sql/matview.py, kv/changefeed.py, kv/fanout.py; bench/views.py and
# bench/fanout.py, bench.py's `views` and `fanout` jobs)

VIEWS_N, VIEWS_ROUNDS, VIEWS_WRITES = 1000, 8, 64
FANOUT_SUBSCRIBERS = 1000
FANOUT_DURATION_S = 2.0  # bench.py's 10 s, cut by the default run's budget


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
    timed through run_tpch (every run held to the numpy oracle); q7 and
    q21 cold and warm (warm equal to cold); q3 with
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
    # one profiled run at SF10, of q3 (a depth cut for the 1000 s
    # budget: q9's and q18's profiles went)
    for q in ladder:
        res[q] = brief(res[q])
    root = builder.build(Q.QUERIES["q3"](cat).optimized_plan(), cat)
    prof = device_profile(lambda: run_operator(root))
    del root
    for k in ("idle_share", "device_busy_s", "top_device_ops"):
        res["q3"][k] = prof[k]
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
    # q3 alone profiled each way (a depth cut for the 1000 s budget)
    fusion[f"sf{sf:g}"] = fusion_compare(cat, runs=DEPTH_RUNS,
                                         profiled=("q3",))
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


def distsql_cpu_half(sf: float, threads: int = 4) -> dict:
    """The CPU's half of check_distsql_parity, in a process of its own:
    each query's explain_distributed text, its 8-shard result (columns as
    object arrays) and capacity factor; under "skew" the skewed window's
    sorted rows, factor and attempts."""
    from cockroach_tpu_torch.bench import queries as Q
    from cockroach_tpu_torch.bench.tpch import gen_tpch
    from cockroach_tpu_torch.parallel.mesh import make_mesh
    from cockroach_tpu_torch.parallel.planner import DistributedQuery

    torch.set_num_threads(threads)
    cpu = gen_tpch(sf=sf, seed=DIST_SEED, device="cpu")
    cpu8 = make_mesh(8, device="cpu")
    out = {}
    for q in sorted(Q.QUERIES):
        crel = Q.QUERIES[q](cpu)
        cq = DistributedQuery(crel.plan, cpu, cpu8)
        res = cq.run()
        out[q] = (crel.explain_distributed(),
                  {k: np.asarray(v, dtype=object) for k, v in res.items()},
                  cq.factor)
    dq = DistributedQuery(skewed_window(cpu).plan, cpu, cpu8)
    out["skew"] = (sorted_rows(dq.run()), dq.factor, dq.attempts)
    return out


def check_distsql_parity(dev, sf: float = 0.01) -> dict:
    """All 22 queries at `sf` (seed 11) through DistributedQuery on meshes
    of 1, 3 and 8 shards on the card, each equal to the single-device
    card run, the 8-shard runs equal to the CPU's 8-shard runs with the
    same capacity factor, explain_distributed equal to the CPU's text;
    the skewed-window retry ending at the CPU's factor. The CPU's half
    runs in a spawned process (distsql_cpu_half) beside the card's."""
    import concurrent.futures
    import multiprocessing

    from cockroach_tpu_torch.bench import queries as Q
    from cockroach_tpu_torch.bench.tpch import gen_tpch
    from cockroach_tpu_torch.flow import dispatch
    from cockroach_tpu_torch.parallel.mesh import make_mesh
    from cockroach_tpu_torch.parallel.planner import DistributedQuery

    t0 = time.perf_counter()
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        on_cpu = pool.submit(distsql_cpu_half, sf)
        card = gen_tpch(sf=sf, seed=DIST_SEED, device=dev)
        meshes = {d: make_mesh(d, device=dev) for d in DIST_MESHES}
        caps = dispatch.captures()
        retried = {}
        on_card = {}
        for q in sorted(Q.QUERIES):
            rel = Q.QUERIES[q](card)
            want = rel.run()
            factors = []
            for d, mesh in meshes.items():
                dq = DistributedQuery(rel.plan, card, mesh)
                got = dq.run()
                bad = first_difference(got, want, rtol=DIST_RTOL)
                if bad is not None:
                    raise AssertionError(f"{q} over {d} shards != one device "
                                         f"on the card: {bad}")
                factors.append(dq.factor)
            on_card[q] = (rel.explain_distributed(), got, factors[-1])
            if max(factors) > 1:
                retried[q] = factors
        dq = DistributedQuery(skewed_window(card).plan, card, meshes[8])
        skew_card = (sorted_rows(dq.run()), dq.factor, dq.attempts)
        captures = dispatch.captures() - caps
        cpu = on_cpu.result(timeout=900)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    for q, (text, got, factor) in on_card.items():
        ctext, cgot, cfactor = cpu[q]
        if text != ctext:
            raise AssertionError(f"{q}: explain_distributed card != CPU")
        bad = first_difference(got, cgot, rtol=DIST_RTOL)
        if bad is not None or cfactor != factor:
            raise AssertionError(f"{q} over 8 shards card != CPU: {bad}, "
                                 f"factor {factor} vs {cfactor}")
    skew_cpu = cpu["skew"]
    if skew_card[1] != skew_cpu[1] or skew_card[1] == 1:
        raise AssertionError(f"skewed retry: factor {skew_card[1]} on the "
                             f"card, {skew_cpu[1]} on the CPU")
    if skew_card[0] != skew_cpu[0]:
        raise AssertionError("skewed retry: card rows != CPU rows")
    out = {"sf": sf, "queries": len(Q.QUERIES), "meshes": list(DIST_MESHES),
           "retried": retried, "skew_factor": skew_card[1],
           "skew_attempts": skew_card[2], "captures": captures,
           "s": time.perf_counter() - t0}
    log(f"distsql: 22 queries over {list(DIST_MESHES)} shards equal one "
        f"device, 8 shards equal the CPU, skewed retry factor "
        f"{out['skew_factor']} on both, {out['s']:.0f}s")
    return out


def dist_runs(cat, shards: int, single: dict, queries=DIST_QUERIES,
              runs: int = 1, dev="cuda", profiled=DIST_QUERIES) -> dict:
    """`queries` over `shards` shards (bench/tpch_dist.run_dist, every
    run held to the oracle), one more run of each of `profiled`
    profiled; compact rows of DIST_COLUMNS, the single-device median
    beside them."""
    from cockroach_tpu_torch.bench.tpch_dist import run_dist

    def idle(q, dq):
        return {"idle_share": (device_profile(dq.run)["idle_share"]
                               if q in profiled else None)}

    res = run_dist(queries, shards=shards, runs=runs, device=dev,
                   catalog=cat, after=idle)
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
    over 3 and 8 shards, q3 over 3 shards profiled (the other profiles:
    depth cuts for the 1000 s budget, PERF.md §4)."""
    single = ({} if ladder is None
              else {q: ladder[q]["median_s"] for q in DIST_QUERIES})
    out = {f"{d}_shards": dist_runs(sf1, d, single, dev=dev,
                                    profiled=("q3",) if d == 3 else ())
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
        # q3 alone profiled past SF1 (a depth cut for the 1000 s
        # budget); the SF1 runs keep theirs
        rows.update(dist_runs(cat, 3, single10 if sf == 10 else {}, qs,
                              dev=dev, profiled=("q3",)))
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


def merge_vs_hash(cat, runs: int = DEPTH_RUNS) -> dict:
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
    if not same_multiset(res["merge"], res["hash"]):
        raise AssertionError("merge join != hash join on lineitem x orders")
    out["rows"] = len(res["merge"]["l_orderkey"])
    log(f"merge join == hash join on lineitem x orders ({out['rows']} rows)")
    return out


def sorted_rows(res: dict) -> list:
    """A result as a sorted multiset of rows (NULL first in each column)."""
    cols = [np.asarray(v, dtype=object) for v in res.values()]
    key = lambda r: tuple((x is not None, x) for x in r)  # noqa: E731
    return sorted(zip(*cols), key=key)


def same_multiset(a: dict, b: dict) -> bool:
    """sorted_rows(a) == sorted_rows(b), through one np.lexsort a side
    when every column is a numeric array with no NaN (not a Python sort
    of millions of row tuples), else through sorted_rows."""
    ca = [np.asarray(v) for v in a.values()]
    cb = [np.asarray(v) for v in b.values()]
    numeric = all(c.dtype.kind in "iufb" and not (
        c.dtype.kind == "f" and np.isnan(c).any()) for c in ca + cb)
    if not numeric:
        return sorted_rows(a) == sorted_rows(b)
    if len(ca) != len(cb) or {len(c) for c in ca + cb} != {len(ca[0])}:
        return False
    oa, ob = np.lexsort(ca[::-1]), np.lexsort(cb[::-1])
    return all(np.array_equal(x[oa], y[ob]) for x, y in zip(ca, cb))


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
    return list(a) == list(b) and same_multiset(a, b)


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
    full-size sales_window timed through run_tpcds (cold and warm, every
    run equal to the numpy oracle), sales_window
    profiled once; the
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
    # cold and warm runs only (the timed repeat: a depth cut for the
    # 1000 s budget, PERF.md §4); every run is held to the oracle
    res = run_tpcds("all", sf=sf, runs=0, device=dev, catalog=cat,
                    window=True)
    table = {}
    for q in tuple(tpcds.QUERIES) + ("sales_window",):
        r = res[q]
        rel = (tpcds.sales_window(cat) if q == "sales_window"
               else tpcds.QUERIES[q](cat))
        # one profiled run, of sales_window alone (the nine's profiles: a
        # depth cut for the 1000 s budget)
        idle = None
        if q == "sales_window":
            root = builder.build(rel.optimized_plan(), cat)
            idle = device_profile(
                lambda root=root: run_operator(root))["idle_share"]
            del root
        table[q] = [r["cold_s"], r["warm_s"], r["median_s"],
                    r["rows_per_sec"], r["rows"],
                    sum(r["host_syncs"].values()), idle, r["h2d_bytes"] / 1e9, r["h2d_s"],
                    r["fill_wait_s"], len(r["streamed"]),
                    r["staged_bytes"] / 1e9,
                    (r["peak_device_bytes"] or 0) / 1e9, r["spills"]]
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
    col = TPCDS_COLUMNS.index("warm_s")
    emit({"tpcds": out},
         {"tpcds": {"warm_s": {q: r[col] for q, r in table.items()},
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


# ---------------------------------------------------------------------------
# The node and its entry points; SQL across processes

NODE_ROWS = 200  # rows the node phase inserts over pgwire
NODE_DEMO_SF = 0.01  # the CLI's --demo-tpch scale, card against CPU
# the reference's debug zip members (cockroach_tpu/server/debugzip.py's
# _ENDPOINTS, which this script cannot import)
ZIP_FILES = ("metrics.txt", "nodes.json", "jobs.json", "settings.json",
             "statements.json", "hot_ranges.json", "contention.json",
             "spans.json", "diagnostics.json", "load.json")
NODE_ENDPOINTS = ("/health", "/_status/nodes", "/_status/jobs",
                  "/_status/statements", "/_status/vars", "/hot_ranges")
HOSTS = 2  # HostFlowServer processes of the hosts phase
HOSTS_SF = 1.0
HOSTS_RTOL = 1e-9  # shard-order FLOAT sums (tests/test_torch_disthost.py)


# A CLI child: the module run as ``python -m`` runs it; at exit the
# storage kernels' launches in that process, on a line of stderr.
CLI_CHILD = """
import atexit, json, runpy, sys

def report():
    from cockroach_tpu_torch.storage import cuda_merge, cuda_scan
    print("child launches " + json.dumps({
        "scan_filter": cuda_scan.scan_filter.launches,
        "merge_path": cuda_merge.merge_perm.launches}),
        file=sys.stderr, flush=True)

atexit.register(report)
runpy.run_module("cockroach_tpu_torch.cli", run_name="__main__",
                 alter_sys=True)
"""


def _cli(args: list, dev) -> subprocess.Popen:
    """``python -m cockroach_tpu_torch.cli`` in a child process, on the
    card (``--cpu`` when `dev` is the CPU), reporting its kernel launches
    at exit (``CLI_CHILD``)."""
    cpu = ["--cpu"] if torch.device(dev).type == "cpu" else []
    if args and args[0] in ("hot-ranges", "debug"):
        cpu = []
    return subprocess.Popen(
        [sys.executable, "-c", CLI_CHILD, *args, *cpu],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _child_launches(stderr: str, what: str) -> dict:
    """The launch counts a CLI child printed at exit."""
    for line in reversed(stderr.splitlines()):
        if line.startswith("child launches "):
            return json.loads(line[len("child launches "):])
    raise AssertionError(f"{what} reported no launch counts")


def _add_launches(into: dict, more: dict) -> dict:
    return {k: into.get(k, 0) + n for k, n in more.items()}


def _finish(p: subprocess.Popen, what: str, timeout: float = 300.0):
    """(stdout, stderr) of a child that must exit 0."""
    try:
        so, se = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        raise AssertionError(f"{what}: no exit in {timeout:.0f}s")
    if p.returncode != 0:
        raise AssertionError(f"{what} exited {p.returncode}: {se[-800:]}")
    return so, se


def _http_json(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        body = r.read()
        if r.status != 200:
            raise AssertionError(f"{path}: HTTP {r.status}")
    return body.decode() if path == "/_status/vars" else json.loads(body)


def run_node_phase(card: str, dev="cuda") -> dict:
    """The node's entry point on the card: ``python -m
    cockroach_tpu_torch.cli --start --pg-port 0 --http-port 0`` as a
    child process (the readiness line and its seconds); over pgwire
    CREATE TABLE, NODE_ROWS rows in four INSERTs and a SELECT that reads
    every one back; /health, /_status/nodes, /_status/jobs,
    /_status/statements, /_status/vars and /hot_ranges; ``cli
    hot-ranges --url`` and ``cli debug zip --url`` (the archive holds
    the reference's members); SIGINT, on which the child stops its node
    and exits 0. Beside it ``cli --demo-tpch 0.01 -e <q1>`` on the card
    and with ``--cpu``: equal rendered tables. Prints the ``{"node":
    ...}`` line."""
    import re
    import signal
    import zipfile

    from cockroach_tpu_torch.bench.tpch_sql import TPCH_SQL

    t_phase = time.perf_counter()
    out: dict = {}
    demo_args = ["--demo-tpch", str(NODE_DEMO_SF), "-e", TPCH_SQL["q1"]]
    demo = {"card": _cli(demo_args, dev), "cpu": _cli(demo_args, "cpu")}
    t0 = time.perf_counter()
    p = _cli(["--start", "--pg-port", "0", "--http-port", "0"], dev)
    verbs: dict = {}
    children: dict = {}
    try:
        line = p.stdout.readline()
        out["ready_s"] = time.perf_counter() - t0
        m = re.fullmatch(r"node 1 serving: pgwire 127\.0\.0\.1:(\d+) "
                         r"http 127\.0\.0\.1:(\d+)\n", line)
        if not m:
            p.kill()
            raise AssertionError(f"readiness line {line!r}: "
                                 f"{p.stderr.read()[-800:]}")
        pg, http = int(m.group(1)), int(m.group(2))
        os.makedirs(KV_DIR, exist_ok=True)
        zpath = os.path.join(KV_DIR, "node_debug.zip")
        url = f"http://127.0.0.1:{http}"
        # the verbs' processes start now: they reach the node while the
        # pgwire statements run
        t_verbs = time.perf_counter()
        verbs = {"hot_ranges": _cli(["hot-ranges", "--url", url], dev),
                 "zip": _cli(["debug", "zip", zpath, "--url", url], dev)}
        conn = PgClient(("127.0.0.1", pg))
        try:
            t0 = time.perf_counter()
            conn.query("create table node_t (k int primary key, v int, "
                       "s string)")
            want = {k: (k * 7 % 1000, f"s{k % 13}") for k in range(NODE_ROWS)}
            keys = sorted(want)
            for part in range(4):
                chunk = keys[part::4]
                conn.query("insert into node_t values " + ", ".join(
                    f"({k}, {want[k][0]}, '{want[k][1]}')" for k in chunk))
            out["insert_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            got = conn.query("select k, v, s from node_t order by k")
            out["select_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            conn.close()
        back = {int(k): (int(v), s) for k, v, s in
                zip(got["k"], got["v"], got["s"])}
        if back != want:
            raise AssertionError(f"{len(back)} of {NODE_ROWS} inserts read "
                                 "back, or read back changed")
        out["rows_read_back"] = len(back)
        pay = {path: _http_json(http, path) for path in NODE_ENDPOINTS}
        if pay["/health"] != {"nodeId": 1, "isLive": True}:
            raise AssertionError(f"/health {pay['/health']}")
        if [(n["nodeId"], n["isLive"]) for n in
                pay["/_status/nodes"]["nodes"]] != [(1, True)]:
            raise AssertionError(f"/_status/nodes {pay['/_status/nodes']}")
        fps = [r["fingerprint"] for r in
               pay["/_status/statements"]["statements"]]
        if not any("node_t" in f for f in fps):
            raise AssertionError(f"/_status/statements lacks node_t: {fps}")
        if "# TYPE sql_queries counter" not in pay["/_status/vars"]:
            raise AssertionError("/_status/vars lacks sql_queries")
        if pay["/hot_ranges"] != {"hotRanges": []} or "jobs" not in \
                pay["/_status/jobs"]:
            raise AssertionError(f"/hot_ranges or /_status/jobs: {pay}")
        out["endpoints"] = {k: len(json.dumps(v)) for k, v in pay.items()}
        hot, se = _finish(verbs["hot_ranges"], "cli hot-ranges")
        children = _add_launches(children,
                                 _child_launches(se, "cli hot-ranges"))
        _, se = _finish(verbs["zip"], "cli debug zip")
        children = _add_launches(children,
                                 _child_launches(se, "cli debug zip"))
        out["verbs_s"] = time.perf_counter() - t_verbs
        if "rangeId" not in hot or "(0 rows)" not in hot:
            raise AssertionError(f"cli hot-ranges printed {hot!r}")
        with zipfile.ZipFile(zpath) as z:
            names = sorted(z.namelist())
        os.remove(zpath)
        if names != sorted("debug/" + n for n in ZIP_FILES):
            raise AssertionError(f"debug zip holds {names}")
        out["zip_files"] = len(names)
        t0 = time.perf_counter()
        p.send_signal(signal.SIGINT)
        so, se = _finish(p, "the node's child", timeout=60)
        out["stop_s"] = time.perf_counter() - t0
        children = _add_launches(children,
                                 _child_launches(se, "the node's child"))
        if "node 1 stopped" not in so:
            raise AssertionError("the child exited without stopping its node")
    except BaseException:
        for c in [*demo.values(), *verbs.values()]:
            if c.poll() is None:
                c.kill()
                c.wait()
        raise
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    t0 = time.perf_counter()
    shown = {}
    for k, v in demo.items():
        what = f"cli --demo-tpch ({k})"
        shown[k], se = _finish(v, what)
        children = _add_launches(children, _child_launches(se, what))
    # the launches of every child: added to this process's by main()
    out["child_launches"] = children
    out["demo_wait_s"] = time.perf_counter() - t0
    if shown["card"] != shown["cpu"] or "(4 rows)" not in shown["card"]:
        raise AssertionError(f"demo q1 on the card {shown['card']!r} != "
                             f"the CPU's {shown['cpu']!r}")
    out["demo_q1_equal"] = True
    out["phase_s"] = time.perf_counter() - t_phase
    out["card"] = card
    emit({"node": out}, {"node": {k: out[k] for k in (
        "ready_s", "insert_ms", "select_ms", "rows_read_back", "verbs_s",
        "stop_s", "demo_q1_equal", "child_launches", "phase_s")}})
    return out


def _host_main(q, stop, sf: float, dev: str) -> None:
    """A host process of the hosts phase: TPC-H at `sf` generated from the
    seed on `dev`, a HostFlowServer over it; its address on `q`, then,
    for each message on `stop` (a queue of its own: a process killed
    while it waits on a shared event would wedge that event), what its
    outboxes have sent and the kernels' launches in this process, until
    the message is "stop"."""
    from cockroach_tpu_torch.bench.tpch import gen_tpch
    from cockroach_tpu_torch.flow.disthost import HostFlowServer

    t0 = time.perf_counter()
    cat = gen_tpch(sf=sf, seed=TPCH_SEED, device=dev)
    srv = HostFlowServer(cat, device=dev).serve_background()
    q.put((tuple(srv.addr), time.perf_counter() - t0))
    while True:
        msg = stop.get()
        q.put({"sent": dict(srv.sent), "launches": _launches()})
        if msg == "stop":
            break
    srv.close()


class HostPool:
    """HOSTS spawned host processes (``_host_main``), started before the
    node phase so their catalogs generate while it runs; the gateway's
    own catalog generates on a thread meanwhile."""

    def __init__(self, dev, sf: float = HOSTS_SF, n: int = HOSTS):
        import multiprocessing as mp
        import threading

        from cockroach_tpu_torch.bench.tpch import gen_tpch

        ctx = mp.get_context("spawn")
        self.closed = False
        self.procs = []
        for _ in range(n):
            q, stop = ctx.Queue(), ctx.Queue()
            p = ctx.Process(target=_host_main, args=(q, stop, sf, str(dev)),
                            daemon=True)
            p.start()
            self.procs.append((q, stop, p))
        self.cat = None

        def gen():
            self.cat = gen_tpch(sf=sf, seed=TPCH_SEED, device=dev)

        self.thread = threading.Thread(target=gen, daemon=True)
        self.thread.start()

    def ready(self, timeout: float = 900.0):
        """(addresses, each host's generation seconds, the gateway's
        catalog)."""
        got = [q.get(timeout=timeout) for q, _, _ in self.procs]
        self.thread.join(timeout=timeout)
        if self.cat is None:
            raise AssertionError("the gateway's catalog never generated")
        return [a for a, _ in got], [s for _, s in got], self.cat

    def counts(self, i: int) -> dict:
        """Host i's sent streams and kernel launches so far."""
        q, stop, _p = self.procs[i]
        stop.put("counts")
        return q.get(timeout=60)

    def kill(self, i: int) -> None:
        p = self.procs[i][2]
        p.kill()
        p.join(timeout=30)

    def close(self) -> list:
        """Stop every host; each live one's last ``counts``."""
        self.closed = True
        for _q, stop, p in self.procs:
            if p.is_alive():
                stop.put("stop")
        sent = []
        for q, _stop, p in self.procs:
            if p.is_alive():
                try:
                    sent.append(q.get(timeout=60))
                except Exception:  # noqa: BLE001 - a dead host reports nothing
                    sent.append(None)
            else:
                sent.append(None)
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        return sent


def framing_cost(cat, dev) -> dict:
    """One 2^20-row batch of four lineitem columns (INT, DECIMAL, DATE,
    dictionary STRING) framed on the card and unframed back (ms each,
    mean of 5 after one warm-up), beside the same bytes over a loopback
    socket: which of the two sets a stream's pace."""
    import socket
    import threading

    from cockroach_tpu_torch.coldata.batch import from_host
    from cockroach_tpu_torch.flow import dcn

    li = cat.get("lineitem")
    names = ("l_orderkey", "l_extendedprice", "l_shipdate", "l_returnflag")
    n = min(1 << 20, li.num_rows)
    sch = li.schema.select(tuple(li.schema.index(c) for c in names))
    b = from_host(sch, {c: np.asarray(li.columns[c])[:n] for c in names},
                  device=dev)
    dicts = {3: li.dictionaries["l_returnflag"]}
    payload = dcn._encode_batch(b, sch, dicts)
    dcn._decode_batch(payload, dev)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(5):
        payload = dcn._encode_batch(b, sch, dicts)
    enc_ms = (time.perf_counter() - t0) / 5 * 1e3
    t0 = time.perf_counter()
    for _ in range(5):
        dcn._decode_batch(payload, dev)
    _sync(dev)
    dec_ms = (time.perf_counter() - t0) / 5 * 1e3
    a, c = socket.socketpair()
    try:
        got = {}

        def drain():
            for _ in range(5):
                got["n"] = len(dcn._recv_batch_msg(c))

        th = threading.Thread(target=drain)
        th.start()
        t0 = time.perf_counter()
        for _ in range(5):
            dcn._send_msg(a, payload)
        th.join()
        sock_ms = (time.perf_counter() - t0) / 5 * 1e3
    finally:
        a.close()
        c.close()
    return {"rows": n, "bytes": len(payload), "encode_ms": enc_ms,
            "decode_ms": dec_ms, "socket_ms": sock_ms,
            "paced_by": "framing" if enc_ms + dec_ms > sock_ms
            else "socket"}


def run_hosts_phase(card: str, pool: HostPool, dev="cuda") -> dict:
    """SQL across processes on the card (flow/disthost.py): HOSTS
    HostFlowServer processes, each over TPC-H SF1 generated from the seed
    (tests/test_dcn.py's shape at full scale), and this process as the
    gateway: q1 as remote partial aggregations over lineitem shards and
    the final stage here (cold, then timed warm); the hash-repartitioned
    join of tests/test_dcn.py; q1 again with host 2 killed once the flow
    is set up on both hosts (at its first stream attach), so the gateway
    cancels and degrades onto host 1 (the re-planned query drains one
    stream, and host 1 sends rows: a fallback onto the gateway alone
    fails the gate). Each result equals the one-device
    result on the card (FLOAT within HOSTS_RTOL; the join as a multiset
    of rows). Reports seconds, lineitem rows/s beside one device's,
    frames, rows and bytes streamed, the framing's cost per batch
    against the socket's, and ``distsql_degraded_queries``. Prints the
    ``{"hosts": ...}`` line."""
    from cockroach_tpu_torch.bench import queries as Q
    from cockroach_tpu_torch.flow import disthost
    from cockroach_tpu_torch.flow.runtime import run_operator
    from cockroach_tpu_torch.ops import expr as ex
    from cockroach_tpu_torch.plan import builder
    from cockroach_tpu_torch.plan import spec as S
    from cockroach_tpu_torch.utils import metric

    t_phase = time.perf_counter()
    out: dict = {}
    try:
        t0 = time.perf_counter()
        addrs, gen_s, cat = pool.ready()
        out["wait_s"] = time.perf_counter() - t0
        out["host_gen_s"] = gen_s
        rows = cat.get("lineitem").num_rows
        q1 = Q.q1(cat).plan
        agg = q1.input if isinstance(q1, S.Sort) else q1
        plans = {"q1": agg, "join": S.HashJoin(
            probe=S.TableScan("lineitem", ("l_orderkey", "l_extendedprice")),
            build=S.Filter(S.TableScan("orders",
                                       ("o_orderkey", "o_totalprice")),
                           ex.Cmp("lt", ex.ColRef(1), ex.lit(10000.0))),
            probe_keys=(0,), build_keys=(0,))}
        one, one_s = {}, {}
        for name, plan in plans.items():
            run_operator(builder.build(plan, cat))  # captures
            t0 = time.perf_counter()
            one[name] = run_operator(builder.build(plan, cat))
            _sync(dev)
            one_s[name] = time.perf_counter() - t0
        s0 = disthost.stream_stats()
        d0 = metric.DIST_DEGRADED.value
        runs = {}

        def by_groups(res):
            keys = list(res)[:2]
            n = len(res[keys[0]])
            order = sorted(range(n), key=lambda i: tuple(
                res[k][i] for k in keys))
            return {k: np.asarray(v)[order] for k, v in res.items()}

        def check(name, got):
            want = one[name]
            if name == "join":
                ok = same_multiset(got, want) and len(
                    next(iter(want.values()))) > 0
            else:
                ok = first_difference(by_groups(got), by_groups(want),
                                      HOSTS_RTOL) is None
            if not ok:
                raise AssertionError(f"hosts {name} != one device")

        for name, fn in (("q1", disthost.run_distributed_hosts),
                         ("join", disthost.run_distributed_join)):
            times = []
            for _ in range(2 if name == "q1" else 1):
                t0 = time.perf_counter()
                got = fn(plans[name], cat, addrs)
                _sync(dev)
                times.append(time.perf_counter() - t0)
                check(name, got)
            runs[name] = times
        if metric.DIST_DEGRADED.value != d0:
            raise AssertionError("a healthy run degraded")
        s1 = disthost.stream_stats()
        sent0 = pool.counts(0)["sent"]
        killed = {}
        orig = disthost.attach_stream

        def attach(addr, *a, **kw):
            if not killed and tuple(addr) == tuple(addrs[1]):
                # both hosts hold the flow's fragments now; host 2's
                # counts are read just before its kill
                killed["counts"] = pool.counts(1)
                t0 = time.perf_counter()
                pool.kill(1)
                killed["kill_s"] = time.perf_counter() - t0
            return orig(addr, *a, **kw)

        disthost.attach_stream = attach
        try:
            t0 = time.perf_counter()
            got = disthost.run_distributed_hosts(plans["q1"], cat, addrs)
            _sync(dev)
            runs["q1_degraded"] = [time.perf_counter() - t0]
        finally:
            disthost.attach_stream = orig
        check("q1", got)
        degraded = metric.DIST_DEGRADED.value - d0
        if not killed or degraded != 1:
            raise AssertionError(f"host 2 killed {bool(killed)}, degraded "
                                 f"{degraded} times (want 1)")
        # degraded onto host 1, not run on the gateway alone: the
        # re-planned query drained one stream, and host 1 sent rows
        s2 = disthost.stream_stats()
        sent1 = pool.counts(0)["sent"]
        survivor = {"gateway_streams": s2["streams"] - s1["streams"],
                    "gateway_frames": s2["frames"] - s1["frames"],
                    "host1_streams": sent1["streams"] - sent0["streams"],
                    "host1_rows": sent1["rows"] - sent0["rows"]}
        if (survivor["gateway_streams"] != 1
                or survivor["gateway_frames"] <= 0
                or survivor["host1_streams"] < 1
                or survivor["host1_rows"] <= 0):
            raise AssertionError(f"the degraded q1 did not run on host 1: "
                                 f"{survivor}")
        out.update({
            "runs_s": runs, "one_device_s": one_s,
            "q1_rows_per_s": rows / runs["q1"][-1],
            "q1_one_device_rows_per_s": rows / one_s["q1"],
            "join_rows_per_s": rows / runs["join"][0],
            "join_one_device_rows_per_s": rows / one_s["join"],
            "gateway_streams": {k: s1[k] - s0[k] for k in s1},
            "degraded_queries": degraded, "degraded_onto": survivor,
            "framing": framing_cost(cat, dev),
        })
    finally:
        final = pool.close()
    # host 2's counts from just before its kill, host 1's at its stop
    hosts = [final[0], killed.get("counts")]
    if any(h is None for h in hosts):
        raise AssertionError(f"a host reported no counts: {hosts}")
    out["hosts_sent"] = [h["sent"] for h in hosts]
    out["rows_streamed"] = sum(h["rows"] for h in out["hosts_sent"])
    out["bytes_framed"] = sum(h["bytes"] for h in out["hosts_sent"])
    # the launches of both hosts: added to this process's by main()
    out["child_launches"] = _add_launches(hosts[0]["launches"],
                                          hosts[1]["launches"])
    out["phase_s"] = time.perf_counter() - t_phase
    out["card"] = card
    emit({"hosts": out}, {"hosts": {
        "runs_s": runs, "one_device_s": one_s,
        "q1_rows_per_s": [out["q1_rows_per_s"],
                          out["q1_one_device_rows_per_s"]],
        "rows_streamed": out["rows_streamed"],
        "bytes_framed": out["bytes_framed"],
        "degraded": degraded, "degraded_onto": survivor,
        "framing": out["framing"], "child_launches": out["child_launches"],
        "phase_s": out["phase_s"]}})
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


PHASES = ("kernels", "tpch", "distsql_sf1", "kv", "sql", "menu", "tpcc",
          "jobs", "views", "fanout", "sf10", "distsql", "tpcds", "ycsb",
          "dist", "node", "hosts", "parity")
# phases whose storage-kernel launches the kernel table reports
LAUNCH_PHASES = ("tpch", "kv", "sql", "menu", "tpcc", "jobs", "views",
                 "fanout", "sf10", "distsql", "tpcds", "dist", "node",
                 "hosts")


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
    run("jobs", lambda: run_jobs_phase(card))
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
    gc.collect()
    run("dist", lambda: run_dist_phase(card))
    # the hosts generate their SF1 catalogs while the node phase runs
    pool = HostPool(dev) if "hosts" in phases else None
    try:
        for name, fn in (("node", lambda: run_node_phase(card)),
                         ("hosts", lambda: run_hosts_phase(card, pool))):
            got = run(name, fn)
            if got is not None:  # the path's child processes too
                launches[name] = _add_launches(launches[name],
                                               got["child_launches"])
    finally:
        if pool is not None and not pool.closed:
            pool.close()
    gc.collect()
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
