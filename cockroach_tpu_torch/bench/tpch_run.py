"""TPC-H queries through the port, timed — the counterpart of bench.py's
``_bench_query``.

    python3 -m cockroach_tpu_torch.bench.tpch_run [--sf 1.0] [--runs 5]
        [--queries q1,q3,q9,q18 | all]

The default is bench.py's ladder (q1, q3, q9, q18); ``all`` runs the 22.
For each query: one operator tree over ``rel.optimized_plan()`` (what
``Rel.run`` executes), built once and re-run. The first run is timed
alone (``cold_s``), then the second (``warm_s``), then the median of
``runs`` more (``median_s``); ``rows_per_sec`` is lineitem's row count
over the median, as bench.py reports it. Every run's result is held to
``bench/tpch_oracle.py`` where it has the query (q1, q3, q9, q18), else to
the cold run's result; a mismatch raises. Prints one JSON object with the
figures, the result rows and the host syncs per query, what the last run
streamed, spilled, uploaded and staged (``flow/runtime.io_report``), the
peak device memory and host RSS per query, the generation's seconds and
peak RSS, and the device. ``--sf 10`` (BASELINE config #2's scale)
streams lineitem and orders; it needs about 18 GB of host RAM.
"""

from __future__ import annotations

import argparse
import json
import resource
import statistics
import time

import torch

from ..device import resolve_device
from ..flow.runtime import host_syncs, io_report, run_operator
from ..plan import builder as plan_builder
from . import queries as Q
from . import tpch_oracle
from .tpch import gen_tpch


def _timed_run(root, dev: torch.device):
    t0 = time.perf_counter()
    res = run_operator(root)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return res, time.perf_counter() - t0


LADDER = ("q1", "q3", "q9", "q18")


def peak_rss_bytes() -> int:
    """This process's peak resident set so far (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def run_tpch(queries=LADDER, sf: float = 1.0, seed: int = 19920101,
             runs: int = 5, device="cuda", catalog=None,
             oracle_catalog=None) -> dict:
    """Time `queries` (names, or "all") on `device` over a TPC-H catalog
    at scale `sf` (or the given `catalog`, on the same device); every
    result is checked against the numpy oracle of `oracle_catalog`'s host
    columns (default: the catalog itself), or without one against the
    cold run. With runs=0 only the cold and warm runs are made."""
    if queries == "all":
        queries = tuple(Q.QUERIES)
    dev = resolve_device(device)
    cat = catalog if catalog is not None else gen_tpch(sf=sf, seed=seed,
                                                       device=dev)
    if cat.device != dev:
        raise ValueError(f"catalog lives on {cat.device}, not {dev}")
    nrows = cat.get("lineitem").num_rows
    out = {"sf": sf, "lineitem_rows": nrows, "device": str(dev)}
    for q in queries:
        root = plan_builder.build(Q.QUERIES[q](cat).optimized_plan(), cat)
        oracle = tpch_oracle.ORACLES.get(q)
        want = (oracle(oracle_catalog or cat) if oracle is not None
                else None)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(runs + 2):
            res, secs = _timed_run(root, dev)
            if want is None:
                want = res
            bad = tpch_oracle.mismatch(q, res, want)
            if bad is not None:
                raise AssertionError(
                    f"{q} disagrees with the "
                    f"{'oracle' if oracle else 'cold run'}: {bad}")
            times.append(secs)
        med = statistics.median(times[2:]) if runs else None
        out[q] = {"cold_s": times[0], "warm_s": times[1], "median_s": med,
                  "rows_per_sec": nrows / med if runs else None,
                  "rows": len(next(iter(res.values()))), "equal": True,
                  "held_to": "oracle" if oracle else "cold run",
                  "host_syncs": host_syncs(root), **io_report(root),
                  "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                        if dev.type == "cuda" else None),
                  "peak_rss_bytes": peak_rss_bytes()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=19920101)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--queries", default=",".join(LADDER),
                    help='comma-separated names, or "all" for the 22')
    a = ap.parse_args()
    queries = "all" if a.queries == "all" else tuple(a.queries.split(","))
    t0 = time.perf_counter()
    cat = gen_tpch(sf=a.sf, seed=a.seed, device=resolve_device(a.device))
    gen = {"gen_s": time.perf_counter() - t0,
           "gen_peak_rss_bytes": peak_rss_bytes()}
    res = run_tpch(queries, sf=a.sf, seed=a.seed, runs=a.runs,
                   device=a.device, catalog=cat)
    res.update(gen)
    if res["device"].startswith("cuda"):
        res["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
