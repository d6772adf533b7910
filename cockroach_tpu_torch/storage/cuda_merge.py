"""LSM run merge — the CUDA merge-path kernel ``csrc/merge_path.cu`` and
its wrappers (counterpart of ``cockroach_tpu.storage.pallas_merge``).

Two runs, each sorted under the canonical MVCC order (dead rows
included), merge in one launch: each block finds where its slice of the
output crosses the merge path and merges that slice in shared memory. K
runs merge as a pairwise tournament of log2(K) rounds. Only the
permutation into [A; B] leaves the kernel; ``merge_pair`` gathers the
block once from it.

The permutation equals that of a stable sort of [A; B] under the
canonical MVCC order (``mvcc._mvcc_sort_operands``), ties included: on
equal composite keys the kernel takes A's row first. The plain version
(``merge_perm_plain``) is that stable sort. On CPU tensors
``merge_perm`` runs the plain version; on CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import mvcc
from .keys import INT64_MIN

# Re-derived for the card. The TPU kernel held the whole merge in VMEM
# (2^17 rows). This kernel reads the runs from device memory and keeps
# only one 1,024-slot tile per block in shared memory, so only device
# memory bounds it. A merge of N output rows holds a 4-byte permutation
# entry per row, the concatenated inputs and the gathered output block
# (62 B/row each at 16-byte keys and values): about 130 B/row. 2^26 rows
# is then ~8.7 GB, about a ninth of an H100's 80 GB, leaving the rest to
# the resident runs; the row index also stays far inside int32. The YCSB
# bulk-load merge (2 x 2^17 rows, bound 2 * 2 * 2^17 = 2^19) is well
# inside it.
MAX_MERGE_ROWS = 1 << 26
_MIN_HALF = 64  # the reference's smallest merge (one 128-lane row)

_lib = None


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("merge_path")
        p = ctypes.c_void_p
        i64 = ctypes.c_longlong
        lib.ct_merge_path.argtypes = [p, p, p, p, i64, p, p, p, p, i64, i64,
                                      p, p]
        lib.ct_merge_path.restype = ctypes.c_int
        lib.ct_merge_path_error.argtypes = [ctypes.c_int]
        lib.ct_merge_path_error.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def merged_rows(n_a: int, n_b: int) -> int:
    """Capacity of a merged pair: 2 * next_pow2(max(n_a, n_b)), at least
    128 (the reference's layout)."""
    return 2 * max(_next_pow2(max(n_a, n_b)), _MIN_HALF)


def merge_perm_plain(a: mvcc.KVBlock, b: mvcc.KVBlock) -> torch.Tensor:
    """[N] int32: the stable sort of [A; B] under the canonical MVCC
    order, then -1 for the N - n_a - n_b pad slots."""
    n = merged_rows(a.capacity, b.capacity)
    big = mvcc.concat_blocks((a, b))
    p = mvcc._stable_argsort(mvcc._mvcc_sort_operands(big))
    pads = torch.full((n - big.capacity,), -1, dtype=torch.int32,
                      device=big.device)
    return torch.cat([p.to(torch.int32), pads])


def _check(blk: mvcc.KVBlock, dev: torch.device) -> None:
    n = blk.capacity
    want = {"key": (torch.uint8, (n, 16)), "ts": (torch.int64, (n,)),
            "seq": (torch.int64, (n,)), "mask": (torch.bool, (n,))}
    for f, (dtype, shape) in want.items():
        t = getattr(blk, f)
        if t.device != dev:
            raise ValueError(f"merge_perm: {f} on {t.device}, expected {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"merge_perm: {f} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"merge_perm: {f} is not contiguous")
    if blk.key.data_ptr() % 16:
        raise ValueError("merge_perm: key rows must be 16-byte aligned")


def merge_perm(a: mvcc.KVBlock, b: mvcc.KVBlock) -> torch.Tensor:
    """Permutation merging two sorted runs: indices into [A; B], sorted by
    the canonical MVCC order, pads (-1) last. Each run must be sorted
    under that order, dead rows included (as ``mvcc.sort_block`` and
    ``gather_merged`` leave them)."""
    if a.key.device.type == "cpu" and b.key.device.type == "cpu":
        return merge_perm_plain(a, b)
    dev = a.key.device
    if dev.type != "cuda":
        raise ValueError(f"merge_perm: unsupported device {dev}")
    _check(a, dev)
    _check(b, dev)
    n_a, n_b = a.capacity, b.capacity
    n = merged_rows(n_a, n_b)
    if n > MAX_MERGE_ROWS:
        raise ValueError(f"merge_perm: {n} rows exceed MAX_MERGE_ROWS")
    lib = _kernel()
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ct_merge_path(
        a.key.data_ptr(), a.ts.data_ptr(), a.seq.data_ptr(),
        a.mask.data_ptr(), n_a, b.key.data_ptr(), b.ts.data_ptr(),
        b.seq.data_ptr(), b.mask.data_ptr(), n_b, n, perm.data_ptr(),
        stream)
    if rc:
        raise RuntimeError("merge path kernel launch failed: "
                           + lib.ct_merge_path_error(rc).decode())
    merge_perm.launches += 1
    return perm


merge_perm.launches = 0


def gather_merged(a: mvcc.KVBlock, b: mvcc.KVBlock,
                  perm: torch.Tensor) -> mvcc.KVBlock:
    """The merged block from a permutation into [A; B]. Pad slots are dead
    and sort last among dead rows (all-ones key, oldest ts and seq), so a
    merged block stays fully sorted for the next tournament round."""
    big = mvcc.concat_blocks((a, b))
    pad = perm < 0
    out = big.map(lambda x: x[perm.clamp(min=0).long()])
    return mvcc.KVBlock(
        key=out.key.masked_fill(pad[:, None], 0xFF),
        ts=out.ts.masked_fill(pad, INT64_MIN),
        seq=out.seq.masked_fill(pad, INT64_MIN),
        txn=out.txn.masked_fill(pad, 0),
        tomb=out.tomb & ~pad,
        value=out.value.masked_fill(pad[:, None], 0),
        vlen=out.vlen.masked_fill(pad, 0),
        mask=out.mask & ~pad,
    )


def merge_pair(a: mvcc.KVBlock, b: mvcc.KVBlock) -> mvcc.KVBlock:
    """Merge two sorted KVBlocks into one sorted KVBlock of capacity
    ``merged_rows(a.capacity, b.capacity)`` (pad rows dead)."""
    return gather_merged(a, b, merge_perm(a, b))


def eligible(blocks: tuple[mvcc.KVBlock, ...]) -> bool:
    """The tournament's last round merges at most next_pow2(K) *
    next_pow2(max cap) rows; past MAX_MERGE_ROWS the caller takes the
    concat + sort merge."""
    if len(blocks) < 2:
        return False
    bound = (_next_pow2(len(blocks))
             * 2 * _next_pow2(max(b.capacity for b in blocks)))
    return bound <= MAX_MERGE_ROWS


def merge_runs(blocks: tuple[mvcc.KVBlock, ...]) -> mvcc.KVBlock:
    """K-way merge as a pairwise tournament of merge-path merges."""
    runs = list(blocks)
    while len(runs) > 1:
        nxt = [merge_pair(runs[i], runs[i + 1])
               for i in range(0, len(runs) - 1, 2)]
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]
