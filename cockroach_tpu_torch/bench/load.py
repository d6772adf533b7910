"""Mixed-workload serving-load harness; the port of
``cockroach_tpu.bench.load``'s ``run_mixed_load`` and
``run_tenant_overload``.

N concurrent ``Session``s over one shared KV store and the TPC-H catalog,
each thread mixing YCSB-style point ops (point SELECT / INSERT on the
``ycsb_kv`` table) with small TPC-H-flavoured analytic statements
(scan-aggregate and top-K over lineitem/orders), every statement through
``Session.execute``: admission (utils/admission.py: queue-wait lands in
``admission_wait_seconds``, p99 recovered from the histogram's bucket
deltas), the memory monitors (flow/memory.py: the root's high-water is
the peak) and the serialized query execution of flow/dispatch.exec_lock
(each query's wait for the device lands in
``sql_exec_lock_wait_seconds``, read the same way). Each statement's
latency, admission to reply, is kept per class for exact percentiles.
After the run every acknowledged insert is read back (``readback_ok``).

``run_tenant_overload`` is the multi-tenant overload-survival oracle: a
well-behaved tenant alone, then beside a noisy one past the node's
capacity (kv/tenant.py tenants, utils/admission.py's per-tenant buckets
and fair share). ``run_coalesce_ab`` is the commit train's A/B
(kv/coalesce.py): coalescing off against on over a WAL store, and the
bit-identity oracle.
"""

from __future__ import annotations

import threading
import time

import numpy as np

_PK_STRIDE = 1 << 20

_ANALYTIC_SQL = (
    "SELECT l_returnflag, l_linestatus, sum(l_quantity) AS sum_qty, "
    "count(*) AS count_order FROM lineitem "
    "GROUP BY l_returnflag, l_linestatus "
    "ORDER BY l_returnflag, l_linestatus",
    "SELECT o_orderpriority, count(*) AS n FROM orders "
    "GROUP BY o_orderpriority ORDER BY n DESC LIMIT 5",
    # high-cardinality group-by (q18's first stage): the per-order partial
    # states actually occupy the agg spool, so the run's peak-HBM figure
    # reflects real buffering, not just 6-group partial tiles
    "SELECT l_orderkey, sum(l_quantity) AS sq FROM lineitem "
    "GROUP BY l_orderkey ORDER BY sq DESC LIMIT 10",
)


def _hist_snapshot(h) -> tuple[list[int], int]:
    with h._lock:
        return list(h.counts), h.n


def hist_quantile_from_deltas(buckets, before: list[int],
                              after: list[int], q: float) -> float:
    """Quantile from two cumulative-count snapshots of a fixed-bucket
    histogram (the Prometheus histogram_quantile discipline): returns the
    upper bound of the bucket where the q-th delta observation lands, 0.0
    when no observations arrived between the snapshots. The overflow
    bucket reports the last finite bound (a floor, not an estimate)."""
    deltas = [a - b for a, b in zip(after, before)]
    total = sum(deltas)
    if total <= 0:
        return 0.0
    rank = q * total
    seen = 0.0
    for i, d in enumerate(deltas):
        seen += d
        if seen >= rank:
            return float(buckets[i]) if i < len(buckets) else float(
                buckets[-1])
    return float(buckets[-1])


class _Counters:
    __slots__ = ("lock", "point_ops", "analytic_ops", "inserts",
                 "conflicts", "shed", "errors", "last_error", "inserted",
                 "latency")

    def __init__(self):
        self.lock = threading.Lock()
        self.inserted: list[int] = []  # acknowledged insert keys
        # seconds of each completed statement, by class
        self.latency: dict[str, list[float]] = {
            "point": [], "insert": [], "analytic": []}
        self.point_ops = 0
        self.analytic_ops = 0
        self.inserts = 0
        self.conflicts = 0
        self.shed = 0
        self.errors = 0
        self.last_error = ""


def _load_worker(sess, stop: threading.Event, ctr: _Counters,
                 n_keys: int, analytic_frac: float, insert_frac: float,
                 seed: int) -> None:
    from ..kv.txn import TransactionRetryError
    from ..storage.lsm import WriteIntentError
    from ..utils.errors import AdmissionRejectedError

    rng = np.random.default_rng(seed)
    # per-thread pk range: no write-write conflicts (the reference's
    # 1000 keys per thread would overlap once a thread inserts more)
    next_pk = n_keys + _PK_STRIDE * seed
    while not stop.is_set():
        try:
            r = rng.random()
            t0 = time.perf_counter()
            if r < analytic_frac:
                sess.execute(_ANALYTIC_SQL[int(rng.integers(
                    0, len(_ANALYTIC_SQL)))])
                with ctr.lock:
                    ctr.analytic_ops += 1
                    ctr.latency["analytic"].append(time.perf_counter() - t0)
            elif r < analytic_frac + insert_frac:
                sess.execute(
                    f"INSERT INTO ycsb_kv VALUES ({next_pk}, {next_pk % 997})")
                with ctr.lock:
                    ctr.inserts += 1
                    ctr.inserted.append(next_pk)
                    ctr.latency["insert"].append(time.perf_counter() - t0)
                next_pk += 1
            else:
                k = int(rng.integers(0, n_keys))
                sess.execute(f"SELECT v FROM ycsb_kv WHERE k = {k}")
                with ctr.lock:
                    ctr.point_ops += 1
                    ctr.latency["point"].append(time.perf_counter() - t0)
        except (WriteIntentError, TransactionRetryError):
            # retryable read/write conflict (a point read landed on a
            # concurrent insert's intent): the client-retry case, counted
            # as contention rather than failure — the 40001 shape
            with ctr.lock:
                ctr.conflicts += 1
        except AdmissionRejectedError as e:
            # the node shed this statement (queue bound / rate limit /
            # overload): the 53300 shape — counted as shed-not-failed,
            # and the client backs off by the rejection's hint
            with ctr.lock:
                ctr.shed += 1
            stop.wait(min(max(e.retry_after_s, 0.002), 0.05))
        except Exception as e:  # counted and reported; the thread goes on
            with ctr.lock:
                ctr.errors += 1
                ctr.last_error = f"{type(e).__name__}: {e}"[:200]


def _p99_ms(seconds: list[float]) -> float:
    return 1e3 * float(np.percentile(seconds, 99)) if seconds else 0.0


def run_mixed_load(sessions: int = 4, duration_s: float = 3.0,
                   sf: float = 0.01, n_keys: int = 512,
                   analytic_frac: float = 0.2, insert_frac: float = 0.1,
                   seed: int = 0, device="cuda", catalog=None) -> dict:
    """N concurrent sessions x (YCSB point ops + TPC-H analytics) for
    duration_s; returns throughput by class, p99 admission queue-wait,
    p99 wait for the device, p99 statement latency (all and by class),
    peak bytes, and whether every acknowledged insert reads back.

    Setup (untimed): the TPC-H catalog at ``sf`` on `device` (or the
    given `catalog`, which must live there), one session over a fresh KV
    store on that device, the ``ycsb_kv`` table created and seeded, and
    the analytic plans warmed. Then ``sessions`` threads share that
    store and catalog, each through its own Session."""
    import torch

    from ..device import resolve_device
    from ..flow import memory
    from ..sql.session import Session
    from ..utils import admission, metric
    from .tpch import gen_tpch_cached

    dev = resolve_device(device)
    cat = catalog if catalog is not None else gen_tpch_cached(sf,
                                                              device=dev)
    boot = Session(catalog=cat, device=dev)
    boot.execute("CREATE TABLE ycsb_kv (k INT PRIMARY KEY, v INT)")
    # seed in multi-row INSERTs (one statement per row would pay the
    # admission and planning toll n_keys times before the clock starts)
    chunk = 128
    for lo in range(0, n_keys, chunk):
        rows = ", ".join(f"({k}, {k % 997})"
                         for k in range(lo, min(lo + chunk, n_keys)))
        boot.execute(f"INSERT INTO ycsb_kv VALUES {rows}")
    # warm the analytic plans and the point read off the clock (plans
    # and graphs are process-wide, so workers serve steady state from
    # their first op)
    for stmt in _ANALYTIC_SQL:
        boot.execute(stmt)
    boot.execute("SELECT v FROM ycsb_kv WHERE k = 0")

    workers = [Session(catalog=cat, db=boot.db, bootstrap=False, device=dev)
               for _ in range(sessions)]

    wait_h = metric.ADMISSION_WAIT_SECONDS
    wait_before, n_before = _hist_snapshot(wait_h)
    exec_h = metric.EXEC_LOCK_WAIT_SECONDS
    exec_before, exec_n_before = _hist_snapshot(exec_h)
    mem_floor = memory.ROOT.high_water
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    ctr = _Counters()
    stop = threading.Event()
    threads = [
        threading.Thread(
            target=_load_worker,
            args=(s, stop, ctr, n_keys, analytic_frac, insert_frac,
                  seed + i + 1),
            name=f"load-{i}", daemon=True)
        for i, s in enumerate(workers)
    ]
    t0 = time.time()
    for t in threads:
        t.start()
    stop.wait(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=60.0)
    elapsed = time.time() - t0
    alive = sum(t.is_alive() for t in threads)

    wait_after, n_after = _hist_snapshot(wait_h)
    exec_after, exec_n_after = _hist_snapshot(exec_h)
    q = admission.sql_queue()
    # every acknowledged insert reads back its value
    res = boot.execute("SELECT k, v FROM ycsb_kv")
    got = dict(zip(np.asarray(res["k"]).tolist(),
                   np.asarray(res["v"]).tolist()))
    missing = [k for k in ctr.inserted if got.get(k) != k % 997]

    total_ops = ctr.point_ops + ctr.analytic_ops + ctr.inserts
    out = {
        "sessions": sessions,
        "duration_s": elapsed,
        "ops": total_ops,
        "ops_per_sec": total_ops / elapsed if elapsed > 0 else 0.0,
        "point_ops": ctr.point_ops,
        "analytic_ops": ctr.analytic_ops,
        "inserts": ctr.inserts,
        "point_ops_per_sec": ctr.point_ops / elapsed,
        "analytic_ops_per_sec": ctr.analytic_ops / elapsed,
        "inserts_per_sec": ctr.inserts / elapsed,
        "conflicts": ctr.conflicts,
        "shed": ctr.shed,
        "errors": ctr.errors,
        "last_error": ctr.last_error,
        "threads_alive": alive,
        "admission_waits": n_after - n_before,
        "p99_queue_wait_ms": 1e3 * hist_quantile_from_deltas(
            wait_h.buckets, wait_before, wait_after, 0.99),
        "p50_queue_wait_ms": 1e3 * hist_quantile_from_deltas(
            wait_h.buckets, wait_before, wait_after, 0.50),
        # each query's wait for the device (one query at a time on it)
        "exec_lock_waits": exec_n_after - exec_n_before,
        "p99_exec_wait_ms": 1e3 * hist_quantile_from_deltas(
            exec_h.buckets, exec_before, exec_after, 0.99),
        # statement latency, admission to reply: all classes and each
        "p99_stmt_ms": _p99_ms(sum(ctr.latency.values(), [])),
        **{f"p99_{c}_ms": _p99_ms(v) for c, v in ctr.latency.items()},
        "admission_slots": q.slots,
        "admission_timeouts": q.timeouts,
        "peak_bytes": memory.ROOT.high_water,
        "peak_bytes_floor": mem_floor,  # the node's peak before the run
        "spills": memory.ROOT.spills,
        "drain_failures": memory.drain_failure_count(),
        "rows_in_table": len(got),
        "inserted_keys": len(ctr.inserted),
        "missing_inserts": len(missing),
        "readback_ok": not missing and len(got) == n_keys + len(
            ctr.inserted),
    }
    if dev.type == "cuda":
        out["device_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    for s in workers:
        s.close()
    boot.close()
    return out


# ------------------------------------------- multi-tenant overload oracle

def _point_worker(sess, stop: threading.Event, ctr: _Counters,
                  n_keys: int, think_s: float, seed: int) -> None:
    """Point-select worker for the overload phases: AdmissionRejected is
    shed-not-failed (the client honors the retry-after hint, bounded);
    think_s > 0 paces the tenant below its fair share (open-loop-ish)."""
    from ..kv.txn import TransactionRetryError
    from ..storage.lsm import WriteIntentError
    from ..utils.errors import AdmissionRejectedError

    rng = np.random.default_rng(seed)
    while not stop.is_set():
        k = int(rng.integers(0, n_keys))
        try:
            sess.execute(f"SELECT v FROM ycsb_kv WHERE k = {k}")
            with ctr.lock:
                ctr.point_ops += 1
        except AdmissionRejectedError as e:
            with ctr.lock:
                ctr.shed += 1
            stop.wait(min(max(e.retry_after_s, 0.002), 0.05))
        except (WriteIntentError, TransactionRetryError):
            with ctr.lock:
                ctr.conflicts += 1
        except Exception as e:  # counted and reported; the thread goes on
            with ctr.lock:
                ctr.errors += 1
                ctr.last_error = f"{type(e).__name__}: {e}"[:200]
        if think_s > 0:
            stop.wait(think_s)


def _run_phase(make_threads, duration_s: float) -> float:
    stop = threading.Event()
    threads = make_threads(stop)
    t0 = time.time()
    for t in threads:
        t.start()
    stop.wait(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=30.0)
    return time.time() - t0


def run_tenant_overload(duration_s: float = 6.0, sf: float = 0.004,
                        n_keys: int = 256, slots: int = 2,
                        max_queue_depth: int = 4,
                        well_sessions: int = 4, noisy_sessions: int = 8,
                        seed: int = 0, device="cuda") -> dict:
    """The overload-survival oracle (bench.py's ``load`` job):

    Phase 1 (saturation / solo baseline): the well-behaved tenant alone,
    closed-loop, with more sessions than slots — measures the node's
    saturation throughput and the tenant's solo p99 queue-wait.

    Phase 2 (overload): the same tenant paced to ~1/4 of saturation
    beside a noisy tenant whose closed-loop sessions offer several times
    the node's capacity, with a token-bucket cap from its admission_rate
    capability and the queue bounded at ``max_queue_depth``. The oracle:

    - goodput stays >= 80% of saturation (no collapse past saturation);
    - every refusal is a typed AdmissionRejectedError (53300 shape),
      never a raw exception;
    - the noisy neighbor cannot push the well-behaved tenant's p99
      queue-wait past 2x its solo baseline.

    The catalog, the store and every session live on `device`. Each run
    has a catalog of its own (the cached TPC-H tables plus its
    ``ycsb_kv``), so a process may run it again."""
    from ..catalog import Catalog
    from ..device import resolve_device
    from ..kv.tenant import TenantRegistry
    from ..sql.session import Session
    from ..utils import admission
    from .tpch import gen_tpch_cached

    dev = resolve_device(device)
    cat = Catalog(dev)
    cat.tables.update(gen_tpch_cached(sf, device=dev).tables)
    boot = Session(catalog=cat, device=dev)
    boot.execute("CREATE TABLE ycsb_kv (k INT PRIMARY KEY, v INT)")
    chunk = 128
    for lo in range(0, n_keys, chunk):
        rows = ", ".join(f"({k}, {k % 997})"
                         for k in range(lo, min(lo + chunk, n_keys)))
        boot.execute(f"INSERT INTO ycsb_kv VALUES {rows}")
    boot.execute("SELECT v FROM ycsb_kv WHERE k = 0")  # warm plan/kernels

    reg = TenantRegistry(boot.db)
    reg.bootstrap()
    well = reg.create("well_behaved")
    reg.create("noisy")

    # a dedicated bounded queue for the run (the process queue may be
    # sized otherwise): swapped in exactly like the admission tests do
    saved = admission._SQL_QUEUE
    q = admission.WorkQueue(slots=slots, max_queue_depth=max_queue_depth)
    admission._SQL_QUEUE = q
    try:
        def mk_sessions(tenant_name, n):
            return [Session(catalog=cat, db=boot.db, bootstrap=False,
                            tenant=tenant_name, device=dev)
                    for _ in range(n)]

        # ---- phase 1: saturation + solo baseline (well tenant alone)
        well_s = mk_sessions("well_behaved", well_sessions)
        # untimed ramp: pay per-session first-execution costs off the
        # clock, or the short solo window understates saturation
        for s in well_s:
            for k in (1, 2):
                s.execute(f"SELECT v FROM ycsb_kv WHERE k = {k}")
        ctr1 = _Counters()
        d1 = _run_phase(
            lambda stop: [
                threading.Thread(
                    target=_point_worker,
                    args=(s, stop, ctr1, n_keys, 0.0, seed + 100 + i),
                    name=f"well-solo-{i}", daemon=True)
                for i, s in enumerate(well_s)],
            duration_s * 0.4)
        sat_per_sec = ctr1.point_ops / d1 if d1 > 0 else 0.0
        solo_waits = q.tenant_wait_samples(well.tenant_id)
        solo_p99_ms = _p99_ms(solo_waits)

        # ---- phase 2: overload. The noisy bucket sits above capacity
        # (1.2x saturation) so it only clips bursts: steady-state shed
        # comes from the queue bound, fairness from the stride scheduler
        reg.set_capability("noisy", "admission_rate",
                           max(10.0, 1.2 * sat_per_sec))
        reg.set_capability("noisy", "admission_burst", 16)
        noisy_s = mk_sessions("noisy", noisy_sessions)
        for s in noisy_s:
            for k in (1, 2):
                s.execute(f"SELECT v FROM ycsb_kv WHERE k = {k}")
        # pace well to ~25% of saturation across its threads
        think_s = (4.0 * well_sessions / sat_per_sec
                   if sat_per_sec > 0 else 0.01)
        n_solo_waits = len(solo_waits)
        ctr_w, ctr_n = _Counters(), _Counters()
        d2 = _run_phase(
            lambda stop: [
                threading.Thread(
                    target=_point_worker,
                    args=(s, stop, ctr_w, n_keys, think_s, seed + 200 + i),
                    name=f"well-ovl-{i}", daemon=True)
                for i, s in enumerate(well_s)
            ] + [
                threading.Thread(
                    target=_point_worker,
                    args=(s, stop, ctr_n, n_keys, 0.0, seed + 300 + i),
                    name=f"noisy-ovl-{i}", daemon=True)
                for i, s in enumerate(noisy_s)],
            duration_s * 0.6)
        goodput_ops = ctr_w.point_ops + ctr_n.point_ops
        shed = ctr_w.shed + ctr_n.shed
        attempts = goodput_ops + shed
        goodput_per_sec = goodput_ops / d2 if d2 > 0 else 0.0
        offered_per_sec = attempts / d2 if d2 > 0 else 0.0
        ovl_p99_ms = _p99_ms(
            q.tenant_wait_samples(well.tenant_id)[n_solo_waits:])

        errors = ctr1.errors + ctr_w.errors + ctr_n.errors
        isolation = (ovl_p99_ms / solo_p99_ms if solo_p99_ms > 0
                     else (0.0 if ovl_p99_ms == 0 else float("inf")))
        goodput_frac = (goodput_per_sec / sat_per_sec
                        if sat_per_sec > 0 else 0.0)
        oracle = {
            "oracle_goodput_ok": goodput_frac >= 0.8,
            "oracle_typed_ok": errors == 0 and shed > 0,
            "oracle_isolation_ok": isolation <= 2.0,
        }
        out = {
            "slots": slots,
            "max_queue_depth": max_queue_depth,
            "saturation_ops_per_sec": sat_per_sec,
            "goodput_per_sec": goodput_per_sec,
            "offered_per_sec": offered_per_sec,
            "offered_x_saturation": (offered_per_sec / sat_per_sec
                                     if sat_per_sec else 0.0),
            "goodput_frac_of_saturation": goodput_frac,
            "shed": shed,
            "conflicts": ctr1.conflicts + ctr_w.conflicts + ctr_n.conflicts,
            "errors": errors,
            "last_error": (ctr_n.last_error or ctr_w.last_error
                           or ctr1.last_error),
            "well_solo_p99_wait_ms": solo_p99_ms,
            "well_overload_p99_wait_ms": ovl_p99_ms,
            "isolation_ratio": isolation,
            "rejections_by_reason": dict(q.rejections_by_reason),
            **oracle,
            "oracle_ok": all(oracle.values()),
        }
        for s in well_s + noisy_s:
            s.close()
        return out
    finally:
        admission._SQL_QUEUE = saved
        boot.close()



# ------------------------------------------------- the commit train's A/B


def _coalesce_worker(db, stop: threading.Event, tid: int, n_hot: int,
                     lat: list, ctr: _Counters, seed: int) -> None:
    """Mixed-DML worker over the non-txn KV surface (the coalescer's
    lane): 90% put / 10% delete over per-thread keys, so the A/B measures
    batching, not conflicts. Per-op wall time lands in ``lat``."""
    rng = np.random.default_rng(seed)
    j = 0
    while not stop.is_set():
        r = rng.random()
        k = f"cl-{tid}-{j % n_hot}"
        t0 = time.perf_counter()
        try:
            if r < 0.9:
                db.put(k, f"v{tid}-{j}".encode())
            else:
                db.delete(k)
        except Exception as e:  # noqa: BLE001 - counted and reported
            with ctr.lock:
                ctr.errors += 1
                ctr.last_error = f"{type(e).__name__}: {e}"[:200]
            j += 1
            continue
        lat.append(time.perf_counter() - t0)
        with ctr.lock:
            ctr.point_ops += 1
        j += 1


def _coalesce_oracle(threads: int = 4, ops: int = 200, seed: int = 7,
                     device="cuda") -> bool:
    """Bit-identity oracle: one deterministic concurrent mixed-DML script
    run coalesced and solo against fresh stores on ``device`` must leave
    byte-identical visible state (keys and values; timestamps are clock
    readings and differ between any two runs, solo included)."""
    from ..kv.txn import DB
    from ..utils import settings

    scripts = []
    for t in range(threads):
        rng = np.random.default_rng(seed * 1000 + t)
        ops_t = []
        for j in range(ops):
            r = rng.random()
            k = f"or-{t}-{int(rng.integers(0, 32))}"
            if r < 0.6:
                ops_t.append(("put", k, f"v{t}-{j}".encode()))
            elif r < 0.8:
                ops_t.append(("delete", k, b""))
            else:
                ops_t.append(("get", k, b""))
        scripts.append(ops_t)

    def run(coalesced: bool):
        db = DB(device=device)
        settings.set("kv.batch.coalesce.enabled", coalesced)
        try:
            def w(script):
                for kind, k, v in script:
                    if kind == "put":
                        db.put(k, v)
                    elif kind == "delete":
                        db.delete(k)
                    else:
                        db.get(k)
            ths = [threading.Thread(target=w, args=(s,), daemon=True)
                   for s in scripts]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=60.0)
        finally:
            settings.set("kv.batch.coalesce.enabled", False)
        return sorted(db.scan(None, None))

    return run(False) == run(True)


def _coalesce_phase(on: bool, sessions: int, duration_s: float,
                    n_hot: int, device="cuda") -> dict:
    """One timed phase over a fresh WAL-backed (fsync) store."""
    import os
    import tempfile

    from ..kv.txn import DB
    from ..storage.lsm import Engine
    from ..utils import metric, settings

    with tempfile.TemporaryDirectory() as td:
        db = DB(Engine(wal_path=os.path.join(td, "wal.log"),
                       wal_fsync=True, device=device))
        settings.set("kv.batch.coalesce.enabled", on)
        m0 = metric.KV_BATCH_COALESCED.value
        try:
            ctr = _Counters()
            lats: list[list[float]] = [[] for _ in range(sessions)]
            stop = threading.Event()
            threads = [
                threading.Thread(
                    target=_coalesce_worker,
                    args=(db, stop, i, n_hot, lats[i], ctr, 500 + i),
                    name=f"coal-{i}", daemon=True)
                for i in range(sessions)
            ]
            t0 = time.time()
            for t in threads:
                t.start()
            stop.wait(duration_s)
            stop.set()
            for t in threads:
                t.join(timeout=30.0)
            elapsed = time.time() - t0
        finally:
            settings.set("kv.batch.coalesce.enabled", False)
        db.engine.close()
        flat = [x for lat in lats for x in lat]
        return {
            "ops_per_sec": ctr.point_ops / elapsed if elapsed > 0 else 0.0,
            "p99_wait_ms": _p99_ms(flat),
            "errors": ctr.errors,
            "last_error": ctr.last_error,
            "coalesced_ops": metric.KV_BATCH_COALESCED.value - m0,
        }


def run_coalesce_ab(sessions: int = 16, duration_s: float = 2.0,
                    n_hot: int = 64, rounds: int = 3,
                    device: str = "cuda") -> dict:
    """Coalescing off against on over a WAL-backed (fsync) store on
    ``device`` ("cuda" by default; raises without a card unless "cpu"):
    ``sessions`` threads of mixed non-txn DML, each seeded by its
    index, the same both phases.
    Phases interleave (off, on x rounds) and the speedup is the median
    of per-round ratios, as in the reference; ``coalesce_oracle_ok`` is
    the bit-identity oracle."""
    from ..device import resolve_device

    resolve_device(device)
    offs, ons = [], []
    for _ in range(max(1, rounds)):
        offs.append(_coalesce_phase(False, sessions, duration_s, n_hot,
                                    device))
        ons.append(_coalesce_phase(True, sessions, duration_s, n_hot,
                                   device))

    def med(vals):
        vals = sorted(vals)
        return vals[len(vals) // 2]

    off_ops = med([p["ops_per_sec"] for p in offs])
    on_ops = med([p["ops_per_sec"] for p in ons])
    ratios = [on["ops_per_sec"] / off["ops_per_sec"]
              for off, on in zip(offs, ons) if off["ops_per_sec"] > 0]
    off_p99 = med([p["p99_wait_ms"] for p in offs])
    on_p99 = med([p["p99_wait_ms"] for p in ons])
    return {
        "coalesce_sessions": sessions,
        "coalesce_rounds": len(offs),
        "coalesce_off_ops_per_sec": off_ops,
        "coalesce_on_ops_per_sec": on_ops,
        "coalesce_speedup": med(ratios) if ratios else 0.0,
        "coalesce_off_p99_wait_ms": off_p99,
        "coalesce_on_p99_wait_ms": on_p99,
        "coalesce_p99_wait_ratio": on_p99 / off_p99 if off_p99 > 0 else 0.0,
        "coalesce_batched_ops": sum(p["coalesced_ops"] for p in ons),
        "coalesce_errors": (sum(p["errors"] for p in offs)
                            + sum(p["errors"] for p in ons)),
        "coalesce_last_error": next((p["last_error"] for p in offs + ons
                                     if p["last_error"]), None),
        "coalesce_oracle_ok": _coalesce_oracle(device=device),
    }
