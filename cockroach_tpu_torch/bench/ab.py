"""Two checkouts of the repo on one card, in turns: YCSB-E and both
kernels' device times.

    python3 -m cockroach_tpu_torch.bench.ab OTHER_CHECKOUT

Runs a fresh process in OTHER_CHECKOUT, then two in this checkout, then
one more in OTHER_CHECKOUT (other, this, this, other), so that drift of
the card or its host shows as a spread rather than as a difference. Each
process builds its kernels, warms up on a small YCSB-E run, runs YCSB-E
at bench.py's size (2^20 keys, 512 ops, 64-row scans, 128-way batches)
on the card, and times an empty launch, K1 at 128 windows x 640 lanes
and K2 at 2 x 2^17 rows with that checkout's ``chip_smoke.device_ms``
on the same seeded inputs. Prints one JSON line per turn and the card's
name and power limit; exits non-zero if a turn fails.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

_TURN = r"""
import json, time
import numpy as np, torch
import chip_smoke
from cockroach_tpu_torch import _build
from cockroach_tpu_torch.bench.ycsb import run_ycsb_e
from cockroach_tpu_torch.storage import cuda_merge, cuda_scan, mvcc

_build.build_all()
run_ycsb_e(n_keys=1 << 14, ops=128, scan_len=64, concurrency=128, seed=1,
           device="cuda")
torch.cuda.synchronize()
t0 = time.perf_counter()
y = run_ycsb_e(n_keys=1 << 20, ops=512, scan_len=64, concurrency=128,
               seed=0, device="cuda")
torch.cuda.synchronize()
wall = time.perf_counter() - t0
dev = torch.device("cuda")
rng = np.random.default_rng(3)
win = mvcc.kvblock_from_numpy(chip_smoke.scan_windows(rng, 128, 640), dev)
a = chip_smoke.sorted_run(rng, 1 << 17, 1 << 17, 1 << 16, dev)
b = chip_smoke.sorted_run(rng, 1 << 17, 1 << 17, 1 << 16, dev)
ms = chip_smoke.device_ms
print("TURN " + json.dumps({
    "ycsb_e": y, "wall_s": wall,
    "floor_ms": ms(lambda: torch.cuda._sleep(0)),
    "scan_filter_ms": ms(lambda: cuda_scan.scan_filter(win, 50, 0, 640)),
    "merge_ms": ms(lambda: cuda_merge.merge_perm(a, b))}))
"""


def turn(checkout: pathlib.Path) -> dict:
    r = subprocess.run([sys.executable, "-c", _TURN], cwd=checkout,
                       capture_output=True, text=True, timeout=900)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("TURN ")]
    if r.returncode or not lines:
        raise RuntimeError(f"turn in {checkout} failed (exit "
                           f"{r.returncode}):\n{r.stderr[-4000:]}")
    return json.loads(lines[-1][len("TURN "):])


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    other = pathlib.Path(argv[0]).resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    for tree in (other, ROOT, ROOT, other):
        out = dict(turn(tree), checkout=str(tree), card=card)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
