"""Cold-wall A/B: first-execution latency with and without the warm menu;
the port of ``cockroach_tpu.bench.warmup``.

    python3 -m cockroach_tpu_torch.bench.warmup [--sf 0.05] [--device cuda]

Each phase runs in a process of its own (``run_warmup_ab`` starts two, as
bench.py runs its ``warmup_off`` and ``warmup_on`` jobs), so each starts
with an empty process-global graph cache and "first execution" is cold:

- **off**: serve the ladder-shaped statements on a cold catalog: every
  first execution pays parse, bind, build and its CUDA graph captures.
  ``cold_s`` is that wall.
- **on**: build the warm menu first (``sql/warmmenu.py``, the path a
  ``PgServer`` takes before it accepts a connection), then serve the SAME
  statements: the menu already captured every (template, rung) graph,
  so serving-path compiles must be 0 and ``cold_s`` is replay.

``cold_menu_speedup = cold_off / cold_on``; equal checksums across the
two phases say a warmed plan returns the bytes a cold one does.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

__all__ = ["run_warmup_cold", "run_warmup_ab"]


def _checksum(out) -> str:
    """Stable digest of one statement's result columns."""
    import numpy as np

    h = hashlib.sha256()
    if isinstance(out, dict):
        for name in sorted(out):
            h.update(name.encode())
            col = out[name]
            try:
                h.update(np.asarray(col).tobytes())
            except (TypeError, ValueError):
                h.update(repr(col).encode())
    else:
        h.update(repr(out).encode())
    return h.hexdigest()[:16]


def run_warmup_cold(menu: bool, sf: float = 0.05, device="cuda") -> dict:
    """One phase over a fresh TPC-H catalog, in this process. Returns the
    cold wall, the serving path's new signatures (``serving_compiles``)
    and CUDA graph captures (``serving_captures``, 0 off the card), the
    per-statement checksums and, with the menu, its build seconds."""
    from ..flow import dispatch
    from ..sql import warmmenu
    from ..sql.session import Session
    from ..utils import metric, settings
    from . import tpch

    cat = tpch.gen_tpch_cached(sf=sf, device=device)
    boot = Session(catalog=cat, device=cat.device)
    out: dict = {"menu": bool(menu)}
    try:
        stmts = warmmenu._ladder_statements(cat)
        out["statements"] = len(stmts)
        if menu:
            settings.set("sql.warmup.menu.enabled", True)
            t0 = time.perf_counter()
            k0 = dispatch.compiles()
            warmmenu.build_menu(cat, boot.db, block=True)
            out["menu_build_s"] = round(time.perf_counter() - t0, 3)
            out["menu_kernels"] = dispatch.compiles() - k0
        serve = Session(catalog=cat, db=boot.db, bootstrap=False,
                        device=cat.device)
        try:
            hits0 = metric.SQL_WARMUP_MENU_HITS.value
            c0, g0 = dispatch.compiles(), dispatch.captures()
            sums = []
            t0 = time.perf_counter()
            for s in stmts:
                sums.append(_checksum(serve.execute(s)))
            out["cold_s"] = round(time.perf_counter() - t0, 4)
            out["serving_compiles"] = dispatch.compiles() - c0
            out["serving_captures"] = dispatch.captures() - g0
            out["menu_hits"] = int(metric.SQL_WARMUP_MENU_HITS.value - hits0)
            out["checksums"] = sums
        finally:
            serve.close()
    finally:
        if menu:
            settings.reset("sql.warmup.menu.enabled")
        boot.close()
    return out


def run_warmup_ab(sf: float = 0.05, device="cuda",
                  timeout_s: float = 600.0) -> dict:
    """Both phases, each in a fresh process (off, then on); returns
    ``{"off": ..., "on": ..., "cold_menu_speedup": ...,
    "menu_oracle_ok": ...}``."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out: dict = {}
    for phase in ("off", "on"):
        proc = subprocess.run(
            [sys.executable, "-m", "cockroach_tpu_torch.bench.warmup",
             "--sf", str(sf), "--device", str(device), "--menu", phase],
            cwd=root, capture_output=True, text=True, timeout=timeout_s)
        if proc.returncode != 0:
            raise RuntimeError(
                f"warmup {phase} exited {proc.returncode}: "
                f"{proc.stderr[-2000:]}")
        out[phase] = json.loads(proc.stdout.strip().splitlines()[-1])
    off, on = out["off"], out["on"]
    out["cold_menu_speedup"] = (off["cold_s"] / on["cold_s"]
                                if on["cold_s"] > 0 else None)
    out["menu_oracle_ok"] = off["checksums"] == on["checksums"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=0.05)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--menu", choices=("off", "on", "both"),
                    default="both",
                    help="one phase in this process, or both in two")
    a = ap.parse_args(argv)
    if a.menu == "both":
        res = run_warmup_ab(a.sf, a.device)
    else:
        res = run_warmup_cold(a.menu == "on", a.sf, a.device)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
