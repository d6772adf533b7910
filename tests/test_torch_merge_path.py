"""A model of the merge-path kernel's partition on the CPU.

``csrc/merge_path.cu`` gives each block a tile of output slots: two warps
find where the tile's first and last diagonals cross the merge path by a
32-ary search, the block stages exactly the tile's rows of A and B, and
each thread co-ranks its own sub-diagonal inside the tile by binary
search and merges its items serially. On equal composite keys A's row
goes first. The CUDA kernel runs only on the card; this file holds a
numpy model of that partition against ``merge_perm_plain`` (the stable
sort of [A; B]), at tile shapes that do and do not divide the input, so
an off-by-one in the tie rule or a tile edge shows here."""

import bisect

import numpy as np
import pytest
import torch

import chip_smoke
from cockroach_tpu_torch.storage import cuda_merge, mvcc

CPU = torch.device("cpu")
SIGN = np.uint64(1 << 63)
LANES = 32  # lanes of the searching warp


def composite(blk: mvcc.KVBlock) -> list[tuple]:
    """Each row's composite key as the kernel compares it, unsigned: dead
    flag, big-endian key words, ts and seq descending."""
    words = blk.key.numpy().view(">u8").astype(np.uint64)
    ts = ~(blk.ts.numpy().view(np.uint64) ^ SIGN)
    seq = ~(blk.seq.numpy().view(np.uint64) ^ SIGN)
    dead = (~blk.mask.numpy()).astype(np.uint64)
    return [tuple(int(v) for v in row)
            for row in zip(dead, words[:, 0], words[:, 1], ts, seq)]


def corank_warp(a: list, b: list, d: int) -> tuple[int, int]:
    """The kernel's `corank`: A rows among the first d merged rows, and
    the rounds the 32-ary search took."""
    lo, hi = max(0, d - len(b)), min(d, len(a))
    rounds = 0
    while lo < hi:
        n = hi - lo
        p = [lo + n * k // LANES if n >= LANES else lo + k
             for k in range(LANES)]
        before = [(n >= LANES or k < n) and a[p[k]] <= b[d - 1 - p[k]]
                  for k in range(LANES)]
        first = before.index(False) if False in before else -1
        last = LANES - 1 if first < 0 else first - 1
        if last >= 0:
            lo = p[last] + 1
        if first >= 0:
            hi = p[first]
        rounds += 1
    return lo, rounds


def merge_path_model(a: list, b: list, n_out: int, threads: int,
                     items: int) -> np.ndarray:
    """The permutation the kernel writes, tile by tile."""
    tile = threads * items
    n = len(a) + len(b)
    perm = []
    for slot0 in range(0, n_out, tile):
        d0, d1 = min(slot0, n), min(slot0 + tile, n)
        a0, a1 = corank_warp(a, b, d0)[0], corank_warp(a, b, d1)[0]
        cnt = d1 - d0
        na = min(max(a1 - a0, 0), cnt)
        nb = cnt - na
        b0 = d0 - a0
        sa, sb = a[a0:a0 + na], b[b0:b0 + nb]
        out = [None] * cnt
        for t in range(threads):
            t0 = min(t * items, cnt)
            lo, hi = max(0, t0 - nb), min(t0, na)
            while lo < hi:
                mid = (lo + hi) // 2
                if sa[mid] <= sb[t0 - 1 - mid]:
                    lo = mid + 1
                else:
                    hi = mid
            i, j = lo, t0 - lo
            for s in range(t0, min(t0 + items, cnt)):
                if i < na and (j >= nb or sa[i] <= sb[j]):
                    out[s] = a0 + i
                    i += 1
                else:
                    out[s] = len(a) + b0 + j
                    j += 1
        perm += out + [-1] * (min(tile, n_out - slot0) - cnt)
    return np.array(perm, dtype=np.int64)


def _runs(kind: str, n_a: int, n_b: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (chip_smoke.sorted_run(rng, n_a, n_a, 50, CPU),
                chip_smoke.sorted_run(rng, n_b, n_b, 50, CPU))
    if kind == "one key":
        return (chip_smoke.sorted_run(rng, n_a, n_a, 1, CPU, ties=True),
                chip_smoke.sorted_run(rng, n_b, n_b, 1, CPU, ties=True))
    # dead tails: a third of each run written, 30% of that dead
    return (chip_smoke.sorted_run(rng, (n_a + 2) // 3, n_a, 50, CPU,
                                  dead=0.3),
            chip_smoke.sorted_run(rng, (n_b + 2) // 3, n_b, 50, CPU,
                                  dead=0.3))


@pytest.mark.parametrize("tile", [(256, 4), (4, 3), (7, 5)],
                         ids=["kernel", "12", "35"])
@pytest.mark.parametrize("kind", ["random", "one key", "dead tails"])
@pytest.mark.parametrize("sizes", [(1, 1), (1, 1024), (1024, 1),
                                   (600, 600), (5, 3000), (2900, 7)])
def test_model_matches_plain(sizes, kind, tile):
    a, b = _runs(kind, *sizes, seed=sum(sizes))
    n_out = cuda_merge.merged_rows(a.capacity, b.capacity)
    got = merge_path_model(composite(a), composite(b), n_out, *tile)
    want = cuda_merge.merge_perm_plain(a, b).numpy()
    np.testing.assert_array_equal(got, want)


def test_ties_take_a_first():
    """All rows equal: every tile takes A's rows, then B's, in row
    order — the index tie-break of the stable sort."""
    a, b = _runs("one key", 40, 30, seed=1)
    got = merge_path_model(composite(a), composite(b), 128, 4, 3)
    np.testing.assert_array_equal(got[:70], np.arange(70))
    assert (got[70:] == -1).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corank_rounds_at_ycsb_size(seed):
    """At 2 x 2^17 rows the 32-ary search needs at most 4 rounds, and it
    agrees with bisection on every diagonal it is asked."""
    rng = np.random.default_rng(seed)
    a = sorted(rng.integers(0, 1 << 18, 1 << 17).tolist())
    b = sorted(rng.integers(0, 1 << 18, 1 << 17).tolist())
    for d in [0, 1, 1023, 1 << 17, (1 << 18) - 1, 1 << 18,
              *rng.integers(0, 1 << 18, 20).tolist()]:
        i, rounds = corank_warp(a, b, d)
        assert rounds <= 4
        # the first i rows of A and d - i of B are the d smallest, A first
        lo, hi = max(0, d - len(b)), min(d, len(a))
        want = lo + bisect.bisect_left(
            [a[m] > b[d - 1 - m] for m in range(lo, hi)], True)
        assert i == want
