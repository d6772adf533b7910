"""TPC-H queries through the distributed path (``Rel.run_distributed``'s
``DistributedQuery``), timed — the counterpart of ``tpch_run`` for a mesh.

    python3 -m cockroach_tpu_torch.bench.tpch_dist [--sf 1.0] [--shards 3]
        [--runs 5] [--queries q3,q9,q18]

A mesh of ``--shards`` shards on one device (BASELINE config #3's three
nodes by default). For each query one ``DistributedQuery`` is built and
run: the first run (construction, the sharded scans' upload, the retry
loop and, on the card, the capture of each attempt's CUDA graph) is
timed alone (``cold_s``), then the second (``warm_s``, a replay at the
final capacity factor), then the median of ``runs`` more. Every run is
held to ``bench/tpch_oracle.py`` where it has the query, else to the
cold run. Per query: attempts and final ``factor`` of the cold run, its
dispatches (one per attempt), the rows its all_to_all exchanges sent,
the upload seconds of the sharded scans, and the peak device memory
(allocated and reserved).
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import time

import torch

from ..device import resolve_device
from ..flow import dispatch
from ..parallel.mesh import make_mesh
from ..parallel.planner import DistributedQuery
from . import queries as Q
from . import tpch_oracle
from .tpch import gen_tpch

DIST = ("q3", "q9", "q18")


def _timed(fn, dev: torch.device):
    t0 = time.perf_counter()
    res = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return res, time.perf_counter() - t0


def run_dist(queries=DIST, shards: int = 3, sf: float = 1.0,
             seed: int = 19920101, runs: int = 5, device="cuda",
             catalog=None, after=None) -> dict:
    """Time `queries` through DistributedQuery on a mesh of `shards`
    shards on `device`, over a TPC-H catalog at `sf` (or `catalog`).
    `after(q, query)`, when given, adds its figures to the query's (a
    profile of one more run)."""
    dev = resolve_device(device)
    cat = catalog if catalog is not None else gen_tpch(sf=sf, seed=seed,
                                                       device=dev)
    mesh = make_mesh(shards, device=dev)
    out = {"sf": sf, "shards": shards, "device": str(dev),
           "lineitem_rows": cat.get("lineitem").num_rows}
    holder: dict = {}
    for q in queries:
        rel = Q.QUERIES[q](cat)
        oracle = tpch_oracle.ORACLES.get(q)
        want = oracle(cat) if oracle is not None else None
        holder.clear()  # the last query's program and its graph pool
        dq = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        d0 = dispatch.total()

        def cold():
            holder["q"] = DistributedQuery(rel.plan, cat, mesh)
            return holder["q"].run()

        res, cold_s = _timed(cold, dev)
        dq = holder["q"]
        first = {"attempts": dq.attempts, "factor": dq.factor,
                 "dispatches": dispatch.total() - d0,
                 "a2a_rows": dq.a2a_rows, "upload_s": dq.upload_s}
        want = want if want is not None else res
        times = [cold_s]
        while True:
            bad = tpch_oracle.mismatch(q, res, want)
            if bad is not None:
                raise AssertionError(
                    f"{q} over {shards} shards disagrees with the "
                    f"{'oracle' if oracle else 'cold run'}: {bad}")
            if len(times) == runs + 2:
                break
            res, secs = _timed(dq.run, dev)
            times.append(secs)
        out[q] = {"cold_s": times[0], "warm_s": times[1],
                  "median_s": statistics.median(times[2:]) if runs else None,
                  "rows": len(next(iter(res.values()))),
                  "held_to": "oracle" if oracle else "cold run",
                  **first,
                  "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                        if dev.type == "cuda" else None),
                  "peak_reserved_bytes": (torch.cuda.max_memory_reserved(dev)
                                          if dev.type == "cuda" else None)}
        if after is not None:
            out[q].update(after(q, dq))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=19920101)
    ap.add_argument("--shards", type=int, default=3)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--queries", default=",".join(DIST))
    a = ap.parse_args()
    res = run_dist(tuple(a.queries.split(",")), shards=a.shards, sf=a.sf,
                   seed=a.seed, runs=a.runs, device=a.device)
    if res["device"].startswith("cuda"):
        res["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
