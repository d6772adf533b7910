"""Mixed-workload serving-load harness; the port of
``cockroach_tpu.bench.load``'s ``run_mixed_load``.

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

The reference's ``run_coalesce_ab`` and ``run_tenant_overload`` wait for
``kv/coalesce.py`` and ``kv/tenant.py``.
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
