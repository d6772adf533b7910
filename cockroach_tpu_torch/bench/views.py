"""Materialized-view maintenance bench — the 1k-standing-views oracle; the
port of ``cockroach_tpu.bench.views``.

One base table, a fleet of ~1k registered views all sharing ONE shape
class (same parameterized q1 shape, distinct date literals), refreshed
against a sustained write stream of inserts, updates and deletes. The
payload shows:

- **refresh lag** p50/p99 (wall-clock age of the oldest buffered event
  when its flush lands) while every flush refreshes the whole fleet;
- **dispatches per flush** is O(shape classes), NOT O(views): the delta
  kernel folds the staged event tiles into every view's accumulator row
  in one batched dispatch (``views_dispatch_ok``); on the card each
  dispatch is one CUDA graph replay, and ``captures_per_flush_after_first``
  counts the graphs the steady flushes had to capture (0 when the tile
  buckets repeat);
- **delta vs rescan**: the steady path does delta work only — zero
  base-table rescans after the create-time population;
- **identity** (``views_oracle_ok``): sampled views equal a fresh full
  rescan of their defining query with the planner rewrite off;
- ``exec_lock_wait_p99_s``: the upper bound of the histogram bucket that
  holds the 99th percentile of the waits for the device lock during the
  steady rounds (``bench/load.hist_quantile_from_deltas``).

``KVViews`` is the same plane over TPC-H in KV: q1 (or, on orders, a
dense grouped aggregate over ``o_orderstatus``) as standing views at
several date cutoffs over the catalog and DB that
``bench/tpch_kv.load_tpch_kv`` built, flushed after each refresh function
and each held to a fresh run of its query over KV with the rewrite off.
"""

from __future__ import annotations

import os
import resource
import time

import numpy as np

_FLAGS = "ABCDEFGH"


def _dates(n: int) -> list[str]:
    out = []
    for y in range(1995, 1999):
        for mo in range(1, 13):
            for dd in range(1, 29):
                out.append(f"{y}-{mo:02d}-{dd:02d}")
    step = max(1, len(out) // n)
    return (out[::step] * ((n // len(out[::step])) + 1))[:n]


def _q(date: str) -> str:
    return ("SELECT flag, sum(qty) AS sq, avg(price) AS ap, count(*) AS n "
            f"FROM t WHERE d <= DATE '{date}' GROUP BY flag ORDER BY flag")


def run_views(views: int = 1000, rounds: int = 8,
              writes_per_round: int = 64, base_rows: int = 240,
              sample: int = 5, device="cuda") -> dict:
    """Run the matview bench on `device` (the card unless the caller
    passes ``"cpu"``); returns the reference's ``detail["views"]``
    payload keys plus the device figures above."""
    from ..flow import dispatch
    from ..sql import Session, matview
    from ..utils import metric, settings
    from .load import _hist_snapshot, hist_quantile_from_deltas

    s = Session(val_width=160, device=device)
    s.execute("CREATE TABLE t (k INT PRIMARY KEY, flag STRING, "
              "qty DECIMAL(12,2), price DECIMAL(12,2), d DATE)")
    rng = np.random.default_rng(7)
    dates = _dates(max(views, 1))
    t0 = time.perf_counter()
    for lo in range(0, base_rows, 40):
        rows = ", ".join(
            f"({k}, '{_FLAGS[k % len(_FLAGS)]}', {k % 97}.25, "
            f"{(k * 3) % 89}.50, DATE '{dates[k % len(dates)]}')"
            for k in range(lo, min(lo + 40, base_rows)))
        s.execute(f"INSERT INTO t VALUES {rows}")
    for i in range(views):
        s.execute(f"CREATE MATERIALIZED VIEW v{i} AS {_q(dates[i])}")
    setup_s = time.perf_counter() - t0

    reg = matview.registry_for(s.catalog)
    m = reg.maintainers["t"]
    full0 = metric.MATVIEW_FULL_RESCANS.value
    mm0 = metric.MATVIEW_MINMAX_RESCANS.value
    ev0 = metric.MATVIEW_DELTA_EVENTS.value
    lock = metric.EXEC_LOCK_WAIT_SECONDS
    lock0, _ = _hist_snapshot(lock)

    live = list(range(base_rows))
    next_k = base_rows
    lags_ms: list[float] = []
    per_flush: list[int] = []
    captures: list[int] = []
    compiles: list[int] = []
    flush_ms: list[float] = []
    t1 = time.perf_counter()
    for _ in range(rounds):
        stmts = []
        for _ in range(writes_per_round):
            op = rng.integers(0, 10)
            if op < 6 or not live:
                stmts.append(
                    f"INSERT INTO t VALUES ({next_k}, "
                    f"'{_FLAGS[next_k % len(_FLAGS)]}', "
                    f"{next_k % 53}.75, {next_k % 71}.25, "
                    f"DATE '{dates[next_k % len(dates)]}')")
                live.append(next_k)
                next_k += 1
            elif op < 9:
                k = int(live[int(rng.integers(0, len(live)))])
                stmts.append(f"UPDATE t SET qty = {k % 61}.50, "
                             f"price = {k % 43}.00 WHERE k = {k}")
            else:
                k = live.pop(int(rng.integers(0, len(live))))
                stmts.append(f"DELETE FROM t WHERE k = {k}")
        for st in stmts:
            s.execute(st)
        m.pump()
        d0, c0, k0 = dispatch.total(), dispatch.captures(), \
            dispatch.compiles()
        f0 = time.perf_counter()
        m.flush()
        flush_ms.append((time.perf_counter() - f0) * 1e3)
        per_flush.append(dispatch.total() - d0)
        captures.append(dispatch.captures() - c0)
        compiles.append(dispatch.compiles() - k0)
        vs = m.views()
        if vs:
            lags_ms.append(vs[0].last_lag_s * 1e3)
    steady_s = time.perf_counter() - t1
    lock_p99 = hist_quantile_from_deltas(
        lock.buckets, lock0, _hist_snapshot(lock)[0], 0.99)

    full_steady = metric.MATVIEW_FULL_RESCANS.value - full0
    mm_steady = metric.MATVIEW_MINMAX_RESCANS.value - mm0
    events = metric.MATVIEW_DELTA_EVENTS.value - ev0
    classes = len(m.classes)

    # sampled identity oracle: standing state vs fresh full rescan,
    # planner rewrite OFF so the reference cannot serve from the view
    oracle_ok = True
    idx = sorted({int(i) for i in
                  np.linspace(0, views - 1, num=min(sample, views))})
    prev = settings.get("sql.matview.rewrite.enabled")
    settings.set("sql.matview.rewrite.enabled", False)
    try:
        for i in idx:
            fresh = s.execute(_q(dates[i]))
            got = s.execute(f"SELECT * FROM v{i} ORDER BY flag")
            same = list(fresh) == list(got) and all(
                np.array_equal(np.asarray(fresh[c]), np.asarray(got[c]))
                for c in fresh)
            if not same:
                oracle_ok = False
    finally:
        settings.set("sql.matview.rewrite.enabled", prev)
    matview.close_all(s.catalog)
    s.close()

    return {
        "views": views,
        "rounds": rounds,
        "writes_per_round": writes_per_round,
        "shape_classes": classes,
        "setup_s": setup_s,
        "steady_s": steady_s,
        "events_applied": int(events),
        "refresh_lag_p50_ms": float(np.percentile(lags_ms, 50)),
        "refresh_lag_p99_ms": float(np.percentile(lags_ms, 99)),
        "flush_ms": flush_ms,
        "dispatches_per_flush_mean": float(np.mean(per_flush)),
        "dispatches_per_flush_max": int(max(per_flush)),
        "captures_per_flush_after_first": int(max(captures[1:], default=0)),
        "compiles_per_flush_after_first": int(max(compiles[1:], default=0)),
        "full_rescans_steady": int(full_steady),
        "minmax_rescans_steady": int(mm_steady),
        "delta_vs_rescan": float(events) / max(1.0, full_steady + mm_steady),
        "exec_lock_wait_p99_s": lock_p99,
        # O(kernels), not O(views): every flush refreshed the whole fleet
        # in at most one dispatch per shape class, with no steady-state
        # base rescans
        "views_dispatch_ok": bool(
            max(per_flush) <= classes and full_steady == 0),
        "views_oracle_ok": bool(oracle_ok),
    }


Q1_VIEW_DAYS = (60, 90, 120, 150)


def q1_view_text(days: int) -> str:
    """TPC-H q1 with its ship-date cutoff `days` before 1998-12-01."""
    from .tpch_sql import TPCH_SQL

    q = TPCH_SQL["q1"]
    if "date '1998-12-01' - 90" not in q:
        raise ValueError("q1's text no longer holds its 90-day cutoff")
    return q.replace("date '1998-12-01' - 90",
                     f"date '1998-12-01' - {int(days)}")


def orders_view_text(days: int) -> str:
    """Orders by status, to `days` before TPC-H's last order date."""
    return ("select o_orderstatus, count(*) as n, "
            "sum(o_totalprice) as total_price from orders "
            f"where o_orderdate <= date '1998-08-02' - {int(days)} "
            "group by o_orderstatus order by o_orderstatus")


# base table -> (view text for a cutoff in days, the ORDER BY of a read)
KV_VIEWS = {"lineitem": (q1_view_text, "l_returnflag, l_linestatus"),
            "orders": (orders_view_text, "o_orderstatus")}


def same_result(a: dict, b: dict, schema) -> str | None:
    """None when two results are equal — FLOAT columns within rtol 1e-12,
    every other column exactly — else the first differing column."""
    from ..coldata.types import Family

    if list(a) != list(b):
        return f"columns {list(a)} != {list(b)}"
    for name, t in zip(schema.names, schema.types):
        x, y = np.asarray(a[name]), np.asarray(b[name])
        if x.shape != y.shape:
            return f"{name}: {x.shape} rows != {y.shape}"
        ok = (np.allclose(x.astype(np.float64), y.astype(np.float64),
                          rtol=1e-12, atol=0.0)
              if t.family is Family.FLOAT else np.array_equal(x, y))
        if not ok:
            return f"{name}: {x.tolist()} != {y.tolist()}"
    return None


class KVViews:
    """Standing views over TPC-H in KV (`cat`, `db` from
    ``bench/tpch_kv.load_tpch_kv``), one per cutoff in `days`, all in one
    shape class on `base`'s maintainer (``KV_VIEWS``). The feed is
    pumped by ``flush`` (the bench's deterministic poll) and the hub's
    own poller is parked, so the refresh functions between flushes run
    as they do without views."""

    def __init__(self, cat, db, days=Q1_VIEW_DAYS, base="lineitem"):
        from ..sql import Session, matview

        self.days = tuple(days)
        self.base = base
        self.text, self.order = KV_VIEWS[base]
        self.names = [f"{base}_v{i}" for i in range(len(self.days))]
        self.sess = Session(catalog=cat, db=db, key_width=16,
                            bootstrap=False, device=cat.device)
        rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        t0 = time.perf_counter()
        self.create_ms = []
        for name, d in zip(self.names, self.days):
            t1 = time.perf_counter()
            self.sess.execute(
                f"CREATE MATERIALIZED VIEW {name} AS {self.text(d)}")
            self.create_ms.append((time.perf_counter() - t1) * 1e3)
            if name == self.names[0]:
                self.reg = matview.registry_for(cat)
                self.reg.hub.poll_interval_s = 3600.0
        self.create_s = time.perf_counter() - t0
        self.check_s: list[float] = []
        self.m = self.reg.maintainers[base]
        self.prime_s = self.m.prime_s
        self.shadow_rows = len(self.m._shadow)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        self.peak_rss_gb = rss / 2**20  # ru_maxrss is in KiB on Linux
        self.rss_growth_gb = (rss - rss0) / 2**20

    def read(self, i: int) -> dict:
        return self.sess.execute(
            f"SELECT * FROM {self.names[i]} ORDER BY {self.order}")

    def flush(self) -> dict:
        """Pump the feed once and flush: events, ms, dispatches and
        captures of the flush, and the changefeed scan's device-to-host
        bytes per poll."""
        from ..flow import dispatch
        from ..kv.changefeed import scan_stats
        from ..utils import metric

        s0 = scan_stats()
        ev0 = metric.MATVIEW_DELTA_EVENTS.value
        sheds0 = metric.CHANGEFEED_SHEDS.value
        t0 = time.perf_counter()
        self.m.pump()
        pump_ms = (time.perf_counter() - t0) * 1e3
        d0, c0 = dispatch.total(), dispatch.captures()
        t1 = time.perf_counter()
        self.m.flush()
        flush_ms = (time.perf_counter() - t1) * 1e3
        s1 = scan_stats()
        polls = max(1, s1["scans"] - s0["scans"])
        return {"events": int(metric.MATVIEW_DELTA_EVENTS.value - ev0),
                # the buffer overflowed its budget: the flush read the
                # delta with a catch-up scan of the table's span instead
                "sheds": int(metric.CHANGEFEED_SHEDS.value - sheds0),
                "pump_ms": pump_ms, "flush_ms": flush_ms,
                "dispatches": dispatch.total() - d0,
                "captures": dispatch.captures() - c0,
                "d2h_bytes_per_poll": (s1["d2h_bytes"]
                                       - s0["d2h_bytes"]) / polls,
                "copies_per_poll": (s1["copies"] - s0["copies"]) / polls}

    def check(self) -> list[str]:
        """Each view against a fresh run of its query over KV with the
        planner rewrite off: the differences found (empty when every view
        holds)."""
        from ..utils import settings

        t0 = time.perf_counter()
        bad = []
        prev = settings.get("sql.matview.rewrite.enabled")
        settings.set("sql.matview.rewrite.enabled", False)
        try:
            # the views first: reading one re-hosts it, which re-keys the
            # plan cache; the fresh queries after them share one entry
            got = [self.read(i) for i in range(len(self.names))]
            for i, (name, d) in enumerate(zip(self.names, self.days)):
                view = self.reg.views[name]
                fresh = self.sess.execute(self.text(d))
                diff = same_result(fresh, got[i], view.out_schema)
                if diff is not None:
                    bad.append(f"{name} ({d} days): {diff}")
        finally:
            settings.set("sql.matview.rewrite.enabled", prev)
        self.check_s.append(time.perf_counter() - t0)
        return bad

    def close(self) -> None:
        from ..sql import matview

        for name in self.names:
            self.sess.execute(f"DROP MATERIALIZED VIEW {name}")
        if not self.reg.views:
            matview.close_all(self.sess.catalog)
        self.sess.close()


if __name__ == "__main__":
    import json

    print(json.dumps(run_views(
        views=int(os.environ.get("BENCH_VIEWS_N", "1000")),
        rounds=int(os.environ.get("BENCH_VIEWS_ROUNDS", "8")),
    ), indent=2))
