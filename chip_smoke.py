#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cockroach_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

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

The line before the last is ``{"kernels": [...]}``, the line before that
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Any failed phase raises, so the script
exits non-zero; without CUDA it exits non-zero before any result.
"""

from __future__ import annotations

import bisect
import json
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
K1_BYTES_PER_ROW = 16 + 8 + 8 + 1 + 1 + 2  # key, ts, txn, tomb, mask; 2 out
K2_BYTES_PER_ROW = 16 + 8 + 8 + 1  # key, ts, seq, mask in
K2_PERM_BYTES = 4


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


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
    print(json.dumps({"ycsb_e": y, "wall_s": wall, "card": card,
                      "launches": launches}), flush=True)
    return launches


def profile_ycsb() -> dict:
    """A second YCSB-E run at the same configuration under torch.profiler:
    the device's busy time (sum of kernel and copy durations on the card)
    against the run's wall time, and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cockroach_tpu_torch.bench.ycsb import run_ycsb_e

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_ycsb_e(n_keys=1 << 20, ops=512, scan_len=64, concurrency=128,
                   seed=0, device="cuda")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name] = (per_name.get(e.name, 0.0)
                                + e.time_range.elapsed_us())
    busy_us = sum(per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_s": wall_us / 1e6,
           "device_busy_s": busy_us / 1e6 if busy_us else "not measured",
           "device_idle_share": (1 - busy_us / wall_us) if busy_us
           else "not measured",
           "top_device_ms": {n[:80]: us / 1e3 for n, us in top}}
    print(json.dumps({"ycsb_e_profile": out}), flush=True)
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
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_s": wall_us / 1e6,
            "device_busy_s": busy_us / 1e6 if busy_us else "not measured",
            "idle_share": (1 - busy_us / wall_us) if busy_us
            else "not measured",
            "top_device_ops": [{"name": n[:120], "ms": v[0] / 1e3,
                                "calls": v[1]} for n, v in top]}


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


def run_tpch_phase(card: str, sf: float = 1.0) -> dict:
    """The SQL main path on the card: the SF0.01 and SF0.05 parity checks,
    then at SF1 bench.py's ladder through run_tpch (every run held to the
    numpy oracle), one profiled run of each ladder query, and the other
    18 queries cold and warm."""
    from cockroach_tpu_torch.bench import queries as Q
    from cockroach_tpu_torch.bench.tpch import gen_tpch
    from cockroach_tpu_torch.bench.tpch_run import LADDER, run_tpch
    from cockroach_tpu_torch.flow.runtime import host_syncs, run_operator
    from cockroach_tpu_torch.plan import builder

    check_tpch_parity(torch.device("cuda"))
    rows_sf005 = check_tpch22_parity(torch.device("cuda"))
    t0 = time.perf_counter()
    cat = gen_tpch(sf=sf, seed=TPCH_SEED, device="cuda")
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    cuda_scan.scan_filter.launches = 0
    cuda_merge.merge_perm.launches = 0
    res = run_tpch(LADDER, sf=sf, seed=TPCH_SEED, runs=5,
                   device="cuda", catalog=cat)
    profiles = {}
    syncs = {}
    operator_ms = {}
    for q in LADDER:
        root = builder.build(Q.QUERIES[q](cat).optimized_plan(), cat)
        run_operator(root)
        profiles[q] = device_profile(lambda root=root: run_operator(root))
        syncs[q] = sum(host_syncs(root).values())
        operator_ms[q] = operator_breakdown(root)
    candidate = time_dense_agg(cat)
    others = tuple(q for q in Q.QUERIES if q not in LADDER)
    rest = run_tpch(others, sf=sf, seed=TPCH_SEED, runs=0, device="cuda",
                    catalog=cat)
    storage_launches = {"scan_filter": cuda_scan.scan_filter.launches,
                        "merge_path": cuda_merge.merge_perm.launches}
    out = {"sf": sf, "lineitem_rows": res["lineitem_rows"], "gen_s": gen_s,
           **{q: res[q] for q in LADDER},
           "idle_share": profiles["q3"]["idle_share"],
           "device_busy_s": profiles["q3"]["device_busy_s"],
           "top_device_ops": profiles["q3"]["top_device_ops"],
           "q1_profile": profiles["q1"],
           "q9_profile": profiles["q9"], "q18_profile": profiles["q18"],
           "kernel_candidate": candidate,
           "syncs_per_query": syncs,
           "operator_exclusive_ms": operator_ms,
           "storage_kernel_launches": storage_launches,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "card_vs_cpu_sf0.01": True,
           "card_vs_cpu_sf0.05_22_rows": rows_sf005, "card": card}
    log(f"TPC-H SF{sf}: " + ", ".join(
        f"{q} {res[q]['median_s'] * 1e3:.1f} ms" for q in LADDER)
        + " (median), equal to the numpy oracle")
    print(json.dumps({"tpch": out}), flush=True)
    tpch22 = {q: {"cold_s": rest[q]["cold_s"], "warm_s": rest[q]["warm_s"],
                  "rows": rest[q]["rows"],
                  "host_syncs": sum(rest[q]["host_syncs"].values())}
              for q in others}
    log(f"TPC-H SF{sf}: the other {len(others)} queries ran cold and warm, "
        "warm equal to cold")
    print(json.dumps({"tpch22": tpch22, "card": card}), flush=True)
    return out


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


def run_sf10_phase(card: str, sf: float = 10.0, dev="cuda") -> dict:
    """TPC-H at SF10, BASELINE config #2's scale: the SF10-scaling parity
    run at sf=0.01, then SF10 generated (seed 19920101) and q3, q9, q18
    timed through run_tpch (every run held to the numpy oracle) and
    profiled once; q7 and q21 cold and warm (warm equal to cold); q3 with
    workmem_bytes lowered until its orders build spills to the Grace hash
    join, and q9 and q7 with workmem_rows at its floor, each equal to its
    default run."""
    from cockroach_tpu_torch.bench import queries as Q
    from cockroach_tpu_torch.bench.tpch import gen_tpch
    from cockroach_tpu_torch.bench.tpch_run import peak_rss_bytes, run_tpch
    from cockroach_tpu_torch.flow.runtime import run_operator
    from cockroach_tpu_torch.plan import builder

    t_phase = time.perf_counter()
    shapes = check_sf10_scaling_parity(torch.device(dev))
    t0 = time.perf_counter()
    cat = gen_tpch(sf=sf, seed=TPCH_SEED, device=dev)
    gen_s = time.perf_counter() - t0
    gen_rss = peak_rss_bytes()
    log(f"TPC-H SF{sf:g} generated in {gen_s:.1f}s, peak RSS "
        f"{gen_rss / 2**30:.2f} GiB")
    ladder = ("q3", "q9", "q18")
    res = run_tpch(ladder, sf=sf, seed=TPCH_SEED, runs=5, device=dev,
                   catalog=cat)
    profiles = {}
    for q in ladder:
        root = builder.build(Q.QUERIES[q](cat).optimized_plan(), cat)
        profiles[q] = device_profile(lambda root=root: run_operator(root))
        res[q]["idle_share"] = profiles[q]["idle_share"]
        res[q]["device_busy_s"] = profiles[q]["device_busy_s"]
        res[q]["top_device_ops"] = profiles[q]["top_device_ops"][:5]
        log(f"SF{sf:g} {q}: median {res[q]['median_s'] * 1e3:.1f} ms, idle "
            f"share {profiles[q]['idle_share']}, H2D "
            f"{res[q]['h2d_bytes'] / 1e9:.3f} GB in {res[q]['h2d_s']:.3f} s, "
            f"syncs {res[q]['host_syncs_total']}, spills {res[q]['spills']}")
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
           **{q: ext[q] for q in ("q7", "q21")},
           "forced": forced, "sf10_scaling_sf0.01_22": shapes,
           "phase_s": time.perf_counter() - t_phase, "card": card}
    log(f"TPC-H SF{sf:g}: q3, q9, q18 equal to the numpy oracle in every "
        "run; q7 and q21 warm equal to cold; the forced Grace join and "
        "external sort equal the default runs "
        f"({out['phase_s']:.1f}s in all)")
    print(json.dumps({"tpch_sf10": out}), flush=True)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
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
    tpch = run_tpch_phase(card)
    cuda_scan.scan_filter.launches = 0
    cuda_merge.merge_perm.launches = 0
    run_sf10_phase(card)
    sf10_launches = {"scan_filter": cuda_scan.scan_filter.launches,
                     "merge_path": cuda_merge.merge_perm.launches}
    launches = run_ycsb(card)
    profile_ycsb()
    check_parity()
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["tpch_launches"] = tpch["storage_kernel_launches"][k["name"]]
        k["sf10_launches"] = sf10_launches[k["name"]]
        k["on_tpch_path"] = k["tpch_launches"] + k["sf10_launches"] > 0
    torch.cuda.synchronize()
    log(f"total {time.perf_counter() - t0:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
