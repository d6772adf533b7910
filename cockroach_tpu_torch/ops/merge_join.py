"""Merge join over exact keys — the colexecjoin mergejoiner analog; the
port of the functions of ``cockroach_tpu.ops.merge_join`` that the Grace
hash join's hybrid degrade runs (``flow/external.py``): a build run
sorted by its exact composite key (``build_merge_index``) and probe rows
that find their match run ``[lo, hi)`` by a lexicographic binary search
(``lex_bsearch``) — no advance loop, no hashes, no collisions.

Key lanes follow the port's uint64 convention (int64 bit patterns,
unsigned order after flipping bit 63): each key column maps to an
order-preserving 64-bit word, NULL and dead rows to the all-ones
sentinel, and a composite key compares lane by lane. ``MergeJoinOp``
(flow/operators.py) runs ``merge_join`` with ``sync=None``: the output
capacity is fixed and the total stays on the device, so a probe is
captured as one CUDA graph and the operator re-runs a probe whose total
passed the capacity.
"""

from __future__ import annotations

import numpy as np
import torch

from ..coldata.batch import Batch, Column, device_table
from ..coldata.types import Family, Schema
from ..storage.keys import flip
from .join import JoinSpec
from .sort import stable_argsort

_SENTINEL = -1  # the uint64 all-ones word as an int64 bit pattern
_TOP = -(1 << 63)  # bit 63 alone, as an int64


def _u64_key(batch: Batch, key: int, schema: Schema, rank_table=None):
    """Order-preserving 64-bit word of one key column (int64 bit
    pattern); NULL/dead -> the sentinel, which matches nothing."""
    c = batch.cols[key]
    t = schema.types[key]
    if t.family is Family.STRING:
        if rank_table is None:
            raise ValueError("STRING merge join needs a rank table")
        table = device_table(rank_table, c.data.device)
        codes = torch.clamp(c.data.to(torch.int64), 0, table.shape[0] - 1)
        payload = table[codes].to(torch.int64) ^ _TOP
    elif t.family is Family.FLOAT:
        # IEEE total-order words; -0.0 == 0.0 and NaN == NaN (Postgres
        # float equality)
        f = c.data.to(torch.float64)
        f = torch.where(f == 0.0, 0.0, f)
        f = torch.where(torch.isnan(f), float("nan"), f)
        u = f.view(torch.int64)
        payload = torch.where(u < 0, ~u, u | _TOP)
    elif t.family is Family.BOOL:
        payload = c.data.to(torch.int64)
    else:
        payload = c.data.to(torch.int64) ^ _TOP
    active = batch.mask & c.valid
    return torch.where(active, payload, _SENTINEL), active


def _norm_keys(key) -> tuple[int, ...]:
    return (key,) if isinstance(key, int) else tuple(key)


def rank_tables_for(probe_schema: Schema, probe_key, probe_dicts,
                    build_key, build_dicts):
    """Per-key-position STRING rank tables: the probe dictionary's rank
    space, build codes remapped into it (build values the probe lacks
    rank past its range, so they equal nothing). Returns (probe_ranks,
    build_ranks), None for non-STRING keys."""
    pkeys = _norm_keys(probe_key)
    bkeys = _norm_keys(build_key)
    probe_ranks: list = []
    build_ranks: list = []
    for pk, bk in zip(pkeys, bkeys):
        if probe_schema.types[pk].family is not Family.STRING:
            probe_ranks.append(None)
            build_ranks.append(None)
            continue
        pd = probe_dicts[pk]
        bd = build_dicts[bk]
        probe_ranks.append(pd.ranks)
        ranks = []
        for i, v in enumerate(bd.values):
            code = pd.code_of(str(v))
            ranks.append(pd.ranks[code] if code >= 0
                         else len(pd.values) + i)
        # crlint: allow-host-sync(ranks is a host python list, not a device array)  # crlint: allow-mem-accounting(dictionary-sized rank table, metadata not query data)
        build_ranks.append(np.array(ranks, dtype=np.int32))
    return tuple(probe_ranks), tuple(build_ranks)


def _norm_ranks(rank_tables, nkeys: int) -> tuple:
    """One table for a single key, or a tuple/dict by key position."""
    if rank_tables is None:
        return (None,) * nkeys
    if isinstance(rank_tables, dict):
        return tuple(rank_tables.get(i) for i in range(nkeys))
    if isinstance(rank_tables, (list, tuple)):
        if len(rank_tables) != nkeys:
            raise ValueError("one rank table per key position")
        return tuple(rank_tables)
    if nkeys != 1:
        raise ValueError("a single rank table serves a single key")
    return (rank_tables,)


def _u64_keys(batch: Batch, keys: tuple[int, ...], schema: Schema,
              rank_tables):
    """(per-column key lanes, combined active): a row is active only when
    every key column is non-NULL."""
    ranks = _norm_ranks(rank_tables, len(keys))
    lanes = []
    active = batch.mask
    for k, rt in zip(keys, ranks):
        lane, a = _u64_key(batch, k, schema, rt)
        lanes.append(lane)
        active = active & a
    return tuple(lanes), active


def lex_bsearch(sorted_lanes, query_lanes, side: str = "left"):
    """Branchless binary search over lexicographic tuples of 64-bit words
    (unsigned order): log2(n) rounds of one gather and one composed tuple
    compare per lane. Returns int64 positions."""
    n = sorted_lanes[0].shape[0]
    bits = max(1, int(n).bit_length())
    sl = [flip(s) for s in sorted_lanes]
    ql = [flip(q) for q in query_lanes]
    pos = torch.zeros(ql[0].shape, dtype=torch.int64, device=ql[0].device)
    for sb in range(bits - 1, -1, -1):
        cand = pos + (1 << sb)
        at = torch.clamp(cand - 1, 0, n - 1)
        lt = torch.zeros(pos.shape, dtype=torch.bool, device=pos.device)
        eq = torch.ones(pos.shape, dtype=torch.bool, device=pos.device)
        for s, q in zip(sl, ql):
            v = s[at]
            lt = lt | (eq & (v < q))
            eq = eq & (v == q)
        ok = lt if side == "left" else (lt | eq)
        pos = torch.where((cand <= n) & ok, cand, pos)
    return pos


# crlint: allow-mem-accounting(traced kernel: index lanes are shaped like the build batch the operator already charged)
def build_merge_index(build: Batch, schema: Schema, key, rank_table=None):
    """Sort build rows by exact (composite) key -> (sorted key lanes,
    original row index, active prefix). Inactive (dead or NULL-key) rows
    sort after the active ones of an equal-key run, and prefix[i] counts
    the active rows before sorted position i, so a probe run [lo, hi)
    has its active matches at [lo, lo + prefix[hi] - prefix[lo])."""
    keys = _norm_keys(key)
    lanes, active = _u64_keys(build, keys, schema, rank_table)
    order = stable_argsort([*lanes, ~active])
    sks = tuple(lane[order] for lane in lanes)
    sorted_active = active[order].to(torch.int64)
    prefix = torch.cat([torch.zeros(1, dtype=torch.int64,
                                    device=build.device),
                        torch.cumsum(sorted_active, 0)])
    return sks, order, prefix


# crlint: allow-mem-accounting(traced kernel: buffers are device transients sized by out_capacity, which the dispatching operator reserves)
def merge_join(
    probe: Batch,
    probe_schema: Schema,
    probe_key,
    build: Batch,
    build_schema: Schema,
    build_key,
    spec: JoinSpec,
    out_capacity,
    probe_rank_table=None,
    build_rank_table=None,
    build_index=None,
    sync=int,
):
    """-> (out_batch, total_rows). Semi and anti joins are probe-aligned
    (total: a device scalar of the rows kept). Inner and left joins emit
    the k-th match of probe row i at slot base[i] + k (a left join's
    unmatched live row one null-extended row at its base slot): output
    ordered by probe row, then sorted build position. `out_capacity` is
    the output tile's capacity, or a function of the total giving it;
    rows past it are dropped. The total becomes a host int via `sync`;
    with sync=None (an int `out_capacity`) it stays a device scalar and
    nothing reads the device on the host."""
    pkeys = _norm_keys(probe_key)
    bkeys = _norm_keys(build_key)
    cap = probe.capacity
    bcap = build.capacity
    dev = probe.device
    if build_index is None:
        build_index = build_merge_index(build, build_schema, bkeys,
                                        build_rank_table)
    sks, order, prefix = build_index
    pks, p_active = _u64_keys(probe, pkeys, probe_schema, probe_rank_table)
    lo = lex_bsearch(sks, pks, side="left")
    hi = lex_bsearch(sks, pks, side="right")
    # count only ACTIVE build rows of the run
    cnt = torch.where(p_active, prefix[hi] - prefix[lo], 0)
    if spec.join_type == "semi":
        keep = probe.mask & (cnt > 0)
        return probe.with_mask(keep), keep.sum(dtype=torch.int64)
    if spec.join_type == "anti":
        keep = probe.mask & (cnt == 0)
        return probe.with_mask(keep), keep.sum(dtype=torch.int64)
    if spec.join_type not in ("inner", "left"):
        raise ValueError(f"unsupported join type {spec.join_type}")
    out_rows = cnt
    if spec.join_type == "left":
        out_rows = torch.where(probe.mask, torch.clamp(cnt, min=1), cnt)
    ends = torch.cumsum(out_rows, 0)
    base = ends - out_rows
    if sync is None:
        # the probe row of output slot s: the first row whose run ends
        # past s (repeat_interleave without its host-side total)
        total = ends[-1]
        oc = out_capacity
        slot = torch.arange(oc, device=dev)
        out_p = torch.clamp(torch.searchsorted(ends, slot, right=True),
                            max=cap - 1)
        out_live = slot < total
    else:
        total = sync(out_rows.sum())
        oc = out_capacity(total) if callable(out_capacity) else out_capacity
        keep = min(total, oc)
        rows = torch.arange(cap, device=dev)
        out_p = torch.zeros(oc, dtype=torch.int64, device=dev)
        out_p[:keep] = torch.repeat_interleave(rows, out_rows,
                                               output_size=total)[:keep]
        slot = torch.arange(oc, device=dev)
        out_live = slot < keep
    k = slot - base[out_p]
    out_found = out_live & (k < cnt[out_p])
    out_b = order[torch.clamp(lo[out_p] + k, 0, bcap - 1)]
    pcols = tuple(
        Column(data=c.data[out_p], valid=c.valid[out_p] & out_live)
        for c in probe.cols)
    bcols = tuple(
        Column(data=c.data[out_b], valid=c.valid[out_b] & out_found)
        for c in build.cols)
    return Batch(cols=pcols + bcols, mask=out_live), total
