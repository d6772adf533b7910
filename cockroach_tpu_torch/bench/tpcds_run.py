"""The nine reduced TPC-DS queries through the port, timed — what
``bench/tpch_run.py`` does for TPC-H.

    python3 -m cockroach_tpu_torch.bench.tpcds_run [--sf 1.0] [--runs 5]
        [--queries q3,q7,... | all] [--window]

For each query: one operator tree over ``rel.optimized_plan()`` (what
``Rel.run`` executes), built once and re-run. The first run is timed
alone (``cold_s``), then the second (``warm_s``), then the median of
``runs`` more (``median_s``); ``rows_per_sec`` is store_sales' row count
over the median. Every run is held to ``bench/tpcds_oracle.py``; a
mismatch raises. Prints one JSON object with the figures, the result
rows, host syncs, what the last run streamed, spilled, uploaded and
staged (``flow/runtime.io_report``), peak device memory and host RSS,
the generation's seconds and peak RSS, and the device. ``--window`` also
times ``bench/tpcds.sales_window`` (every store_sales row) the same way.
At ``--sf 10`` store_sales (28.8 M rows) streams in 2^20-row tiles.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..device import resolve_device
from ..flow.runtime import host_syncs, io_report, run_operator
from ..plan import builder as plan_builder
from . import tpcds, tpcds_oracle
from .tpch_run import peak_rss_bytes

QUERIES = tuple(tpcds.QUERIES)


def _timed_run(root, dev: torch.device):
    t0 = time.perf_counter()
    res = run_operator(root)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return res, time.perf_counter() - t0


def time_query(name: str, rel, oracle, runs: int, dev: torch.device,
               rows: int) -> dict:
    """Cold, warm and `runs` timed runs of one Rel, each equal to
    `oracle` (a {column: array} answer) under tpcds_oracle.mismatch's
    rules for `name`."""
    root = plan_builder.build(rel.optimized_plan(), rel.catalog)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(runs + 2):
        res, secs = _timed_run(root, dev)
        bad = tpcds_oracle.mismatch(name, res, oracle)
        if bad is not None:
            raise AssertionError(f"{name} disagrees with the oracle: {bad}")
        times.append(secs)
    med = statistics.median(times[2:]) if runs else None
    return {"cold_s": times[0], "warm_s": times[1], "median_s": med,
            "rows_per_sec": rows / med if runs else None,
            "rows": len(next(iter(res.values()))), "equal": True,
            "held_to": "oracle", "host_syncs": host_syncs(root),
            **io_report(root),
            "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None),
            "peak_rss_bytes": peak_rss_bytes()}


def run_tpcds(queries=QUERIES, sf: float = 1.0, seed: int = 19980401,
              runs: int = 5, device="cuda", catalog=None,
              window: bool = False) -> dict:
    """Time `queries` (names, or "all") on `device` over a TPC-DS catalog
    at scale `sf` (or the given `catalog`, on the same device); every
    run is checked against the numpy oracle. With runs=0 only the cold
    and warm runs are made; `window` adds sales_window."""
    if queries == "all":
        queries = QUERIES
    dev = resolve_device(device)
    cat = catalog if catalog is not None else tpcds.gen_tpcds(
        sf=sf, seed=seed, device=dev)
    if cat.device != dev:
        raise ValueError(f"catalog lives on {cat.device}, not {dev}")
    nrows = cat.get("store_sales").num_rows
    out = {"sf": sf, "store_sales_rows": nrows, "device": str(dev)}
    for q in queries:
        out[q] = time_query(q, tpcds.QUERIES[q](cat),
                            tpcds_oracle.ORACLES[q](cat), runs, dev, nrows)
    if window:
        out["sales_window"] = time_query(
            "sales_window", tpcds.sales_window(cat),
            tpcds_oracle.sales_window(cat), runs, dev, nrows)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=19980401)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--queries", default="all",
                    help='comma-separated names, or "all" for the nine')
    ap.add_argument("--window", action="store_true",
                    help="also time the full-size sales_window")
    a = ap.parse_args()
    queries = "all" if a.queries == "all" else tuple(a.queries.split(","))
    t0 = time.perf_counter()
    cat = tpcds.gen_tpcds(sf=a.sf, seed=a.seed,
                          device=resolve_device(a.device))
    gen = {"gen_s": time.perf_counter() - t0,
           "gen_peak_rss_bytes": peak_rss_bytes()}
    res = run_tpcds(queries, sf=a.sf, seed=a.seed, runs=a.runs,
                    device=a.device, catalog=cat, window=a.window)
    res.update(gen)
    if res["device"].startswith("cuda"):
        res["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
