"""Window functions — the colexecwindow analog; the port of
``cockroach_tpu.ops.window``.

Every window function runs as a segmented pass over ONE sorted tile:

- sort by (partition keys, order keys) — ``ops/sort.sort_batch``;
- partition boundaries -> segment ids (``cumsum`` of the change flags);
- row_number / rank / dense_rank = position arithmetic over boundaries;
- running (unbounded preceding .. current row) aggregates = cumsum minus
  the segment's prefix; whole-partition aggregates = segment sums
  gathered back;
- lead/lag = shifted gathers with partition-edge NULLs;
- framed windows (ROWS, RANGE and GROUPS BETWEEN, with EXCLUDE): per-row
  frame bounds, prefix-sum differences for sum/count/avg, a sparse-table
  range-minimum query for min/max, gathers at the frame edge for
  first/last_value.

NULL ordering and peer semantics follow SQL: ORDER BY peers (ties) share
rank; rank counts peers, dense_rank doesn't skip.

Translation notes. ``jax.lax.associative_scan(jnp.maximum)`` over row
positions is ``torch.cummax``; the boundary-resetting running min/max is
the port's segmented log-step scan (``ops/segscan.seg_scan``);
``jax.ops.segment_min``/``segment_max`` are ``scatter_reduce`` onto the
operator's identity. Nothing here reads a device value on the host, so a
whole ``compute_windows`` call is captured as one CUDA graph on the card
(``flow/dispatch.jit``). FLOAT running and framed sums are prefix
differences added in torch's order, not XLA's: they agree with the
reference within a bound, integers and DECIMALs exactly.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..coldata.batch import Batch, Column, device_table
from ..coldata.types import FLOAT64, INT64, Family, Schema, SQLType
from . import sort as sort_ops
from .aggregation import _minmax_sentinel
from .segscan import seg_scan

WINDOW_FUNCS = (
    "row_number", "rank", "dense_rank", "lag", "lead",
    "sum", "count", "min", "max", "avg", "first_value", "last_value",
    "ntile", "percent_rank", "cume_dist",
)

_FRAMED = ("sum", "count", "avg", "min", "max", "first_value", "last_value")


@dataclass(frozen=True)
class WindowSpec:
    """One window function: func over column `col` (None for the rank
    family), `offset` for lead/lag (the bucket count for ntile),
    `running` selects the cumulative frame (rows unbounded preceding ..
    current row) against the whole partition.

    `frame` is the general BETWEEN spec as (preceding, following), None
    in either slot meaning UNBOUNDED: (2, 0) is ROWS BETWEEN 2 PRECEDING
    AND CURRENT ROW, (None, 0) equals running=True. It applies to
    sum/count/avg/min/max/first_value/last_value. frame_kind='range'
    reads the pair as ORDER-BY-value offsets over the single numeric
    order key (offset 0 is CURRENT ROW's peer-inclusive bound);
    frame_kind='groups' counts peer groups. `exclude` is SQL's EXCLUDE
    clause: "no_others" | "current" | "group" | "ties"."""

    func: str
    col: int | None = None
    name: str | None = None
    offset: int = 1
    running: bool = False
    frame: tuple | None = None
    frame_kind: str = "rows"
    exclude: str = "no_others"


def window_output_type(spec: WindowSpec, schema: Schema) -> SQLType:
    if spec.func in ("row_number", "rank", "dense_rank", "count", "ntile"):
        return INT64
    if spec.func in ("avg", "percent_rank", "cume_dist"):
        return FLOAT64
    return schema.types[spec.col]


def window_output_schema(schema: Schema,
                         specs: tuple[WindowSpec, ...]) -> Schema:
    names = list(schema.names)
    types = list(schema.types)
    for s in specs:
        names.append(s.name or s.func)
        types.append(window_output_type(s, schema))
    return Schema(tuple(names), tuple(types))


# ---------------------------------------------------------------------------
# segment primitives


def _seg_reduce(vals: torch.Tensor, seg: torch.Tensor, cap: int,
                is_min: bool) -> torch.Tensor:
    """jax.ops.segment_min / segment_max into `cap` slots: an empty
    segment holds the operator's identity."""
    out = torch.full((cap,), _minmax_sentinel(vals.dtype, is_min),
                     dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce(0, seg, vals, "amin" if is_min else "amax",
                              include_self=False)


def _seg_sum(vals: torch.Tensor, seg: torch.Tensor, cap: int) -> torch.Tensor:
    out = torch.zeros(cap, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg, vals)


def _before(c: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """c[start - 1] where start > 0, else 0: the prefix before a run."""
    prev = c[torch.clamp(start - 1, min=0)]
    return torch.where(start > 0, prev, torch.zeros_like(prev))


def _lanes_equal(data: torch.Tensor) -> torch.Tensor:
    """Row i+1 equal to row i (all lanes of a BYTES row)."""
    if data.dim() == 2:
        return torch.all(data[1:] == data[:-1], dim=-1)
    return data[1:] == data[:-1]


def _head_flag(dev) -> torch.Tensor:
    return torch.ones(1, dtype=torch.bool, device=dev)


def _partition_segments(batch: Batch, part_cols) -> torch.Tensor:
    """Segment id per row from partition-key change boundaries; the batch
    is sorted by partition keys (dead rows last)."""
    cap = batch.capacity
    if not part_cols:
        return torch.zeros(cap, dtype=torch.int64, device=batch.device)
    same = batch.mask[1:] & batch.mask[:-1]
    for c in part_cols:
        col = batch.cols[c]
        # equal non-NULLs, or both NULL (NULLs are peers in PARTITION BY)
        eq = ((_lanes_equal(col.data) & col.valid[1:] & col.valid[:-1])
              | (~col.valid[1:] & ~col.valid[:-1]))
        same = same & eq
    boundary = torch.cat([_head_flag(batch.device), ~same])
    return torch.cumsum(boundary.to(torch.int64), 0) - 1


def _order_peers(batch: Batch, order_keys, seg) -> torch.Tensor:
    """Boundary where (segment, order keys) change: peers share ranks."""
    cap = batch.capacity
    if not order_keys:
        return torch.ones(cap, dtype=torch.bool, device=batch.device)
    same = seg[1:] == seg[:-1]
    for k in order_keys:
        col = batch.cols[k.col]
        eq = _lanes_equal(col.data) | (~col.valid[1:] & ~col.valid[:-1])
        same = same & eq & (col.valid[1:] == col.valid[:-1])
    return torch.cat([_head_flag(batch.device), ~same])


def _peer_heads(peer_boundary, pos) -> torch.Tensor:
    """Per-row position of its peer group's first row (running max)."""
    head_pos = torch.where(peer_boundary, pos, torch.zeros_like(pos))
    return torch.cummax(head_pos, 0).values


_inverse_tables: dict = {}


def _inverse_ranks(ranks: np.ndarray) -> np.ndarray:
    """rank -> code for a dictionary's rank table, kept while the table
    lives, so a captured function reads it by reference."""
    key = id(ranks)
    inv = _inverse_tables.get(key)
    if inv is None:
        inv = np.empty(len(ranks), dtype=np.int32)
        # crlint: allow-host-sync(rank tables are host numpy)
        inv[np.asarray(ranks)] = np.arange(len(ranks), dtype=np.int32)
        _inverse_tables[key] = inv
        weakref.finalize(ranks, _inverse_tables.pop, key, None)
    return inv


def _minmax_input(col: Column, t: SQLType, col_idx: int, rank_tables, dev):
    """(values to reduce, rank -> code table or None): a STRING column
    reduces its byte-order ranks, not its insertion-order codes."""
    if t.family is not Family.STRING:
        return col.data, None
    ranks = rank_tables[col_idx]
    table = device_table(ranks, dev)
    data = table[torch.clamp(col.data.to(torch.int64), 0,
                             table.shape[0] - 1)]
    return data, device_table(_inverse_ranks(ranks), dev)


def _decode_rank(red: torch.Tensor, inv: torch.Tensor | None):
    if inv is None:
        return red
    return inv[torch.clamp(red.to(torch.int64), 0, inv.shape[0] - 1)]


# ---------------------------------------------------------------------------
# compute_windows


def compute_windows(
    batch: Batch,
    schema: Schema,
    part_cols: tuple[int, ...],
    order_keys: tuple[sort_ops.SortKey, ...],
    specs: tuple[WindowSpec, ...],
    rank_tables=None,
) -> Batch:
    """Sort by (partition, order) and append one column per WindowSpec."""
    rank_tables = rank_tables or {}
    sort_keys = tuple(sort_ops.SortKey(c) for c in part_cols) + tuple(
        order_keys)
    b = sort_ops.sort_batch(batch, schema, sort_keys, rank_tables)
    cap = b.capacity
    dev = b.device
    pos = torch.arange(cap, dtype=torch.int64, device=dev)

    seg = _partition_segments(b, part_cols)
    seg_start = _seg_reduce(torch.where(b.mask, pos, cap), seg, cap, True)
    start_of = seg_start[seg]  # per-row segment start position
    peer_boundary = _order_peers(b, order_keys, seg)
    # per-row last live position of the segment
    seg_end = _seg_reduce(torch.where(b.mask, pos, -1), seg, cap, False)[seg]

    new_cols = list(b.cols)
    for spec in specs:
        out_t = window_output_type(spec, schema)
        if spec.frame is not None and spec.func in _FRAMED:
            if (spec.frame_kind == "range"
                    and any(x not in (None, 0) for x in spec.frame)):
                # offset RANGE frames need one numeric key (Postgres
                # rule); peer-only frames work positionally for any key
                if len(order_keys) != 1:
                    raise ValueError(
                        "RANGE frames with offsets require exactly one "
                        "ORDER BY key (Postgres rule)")
                fam = schema.types[order_keys[0].col].family
                if fam not in (Family.INT, Family.FLOAT, Family.DECIMAL,
                               Family.DATE):
                    raise ValueError(
                        f"RANGE frame offsets need a numeric order key, "
                        f"got {fam}")
            d, v = _framed_window(b, schema, spec, seg, start_of, seg_end,
                                  pos, rank_tables, order_keys=order_keys,
                                  peer_boundary=peer_boundary)
            new_cols.append(Column(data=d, valid=v & b.mask))
            continue
        d, v = _unframed(spec, out_t, b, schema, seg, pos, start_of,
                         peer_boundary, rank_tables, cap)
        new_cols.append(Column(data=d, valid=v & b.mask))
    return Batch(cols=tuple(new_cols), mask=b.mask)


def _unframed(spec, out_t, b, schema, seg, pos, start_of, peer_boundary,
              rank_tables, cap):
    """One window function over the running or whole-partition frame."""
    i64 = torch.int64
    if spec.func == "row_number":
        return pos - start_of + 1, b.mask
    if spec.func in ("rank", "dense_rank"):
        if spec.func == "rank":
            return _peer_heads(peer_boundary, pos) - start_of + 1, b.mask
        # dense: peer boundaries in the partition so far
        pb = torch.cumsum(peer_boundary.to(i64), 0)
        # dead rows start at `cap`: clamp the gather, as XLA's does
        return pb - pb[torch.clamp(start_of, max=cap - 1)] + 1, b.mask
    if spec.func in ("ntile", "percent_rank", "cume_dist"):
        n = _seg_sum(b.mask.to(i64), seg, cap)[seg]  # partition row count
        idx = pos - start_of  # 0-based in partition
        if spec.func == "ntile":
            # SQL ntile(k): the first (n mod k) buckets get one extra row
            k = max(1, spec.offset)
            q = n // k
            r = n % k
            big = r * (q + 1)  # rows covered by the larger buckets
            d = torch.where(
                q == 0, idx + 1,
                torch.where(idx < big,
                            idx // torch.clamp(q + 1, min=1) + 1,
                            r + (idx - big) // torch.clamp(q, min=1) + 1))
            return d, b.mask
        if spec.func == "percent_rank":
            rank = (_peer_heads(peer_boundary, pos) - start_of + 1).to(
                torch.float64)
            denom = torch.clamp(n - 1, min=1).to(torch.float64)
            d = torch.where(n > 1, (rank - 1.0) / denom,
                            torch.zeros_like(rank))
            return d, b.mask
        # cume_dist = rows up to my peer group's last / partition rows
        peer_id = torch.cumsum(peer_boundary.to(i64), 0) - 1
        peer_last = _seg_reduce(torch.where(b.mask, pos, -1), peer_id, cap,
                                False)[peer_id]
        d = ((peer_last - start_of + 1).to(torch.float64)
             / torch.clamp(n, min=1).to(torch.float64))
        return d, b.mask
    if spec.func in ("lag", "lead"):
        col = b.cols[spec.col]
        off = spec.offset if spec.func == "lag" else -spec.offset
        src = pos - off
        inb = (src >= 0) & (src < cap)
        srcc = torch.clamp(src, 0, cap - 1)
        same_seg = inb & (seg[srcc] == seg)
        data = col.data[srcc]
        keep = same_seg.unsqueeze(-1) if data.dim() == 2 else same_seg
        d = torch.where(keep, data, torch.zeros_like(data))
        return d, same_seg & col.valid[srcc] & b.mask
    if spec.func == "count" and spec.col is None:  # count(*)
        vals = b.mask.to(i64)
        if spec.running:
            c = torch.cumsum(vals, 0)
            return c - _before(c, start_of), b.mask
        return _seg_sum(vals, seg, cap)[seg], b.mask
    if spec.func not in _FRAMED:
        raise ValueError(f"unknown window function {spec.func}")
    col = b.cols[spec.col]
    t = schema.types[spec.col]
    m = b.mask & col.valid
    cnt_m = m.to(i64)
    if spec.func in ("sum", "count", "avg"):
        if spec.func == "count":
            vals = cnt_m
        elif spec.func == "avg" or t.family is Family.FLOAT:
            vals = torch.where(m, col.data.to(torch.float64), 0.0)
        else:
            vals = torch.where(m, col.data.to(i64), 0)
        if spec.running:
            c = torch.cumsum(vals, 0)
            run = c - _before(c, start_of)
        else:
            run = _seg_sum(vals, seg, cap)[seg]
        if spec.func == "count":
            return run, b.mask
        if spec.func == "avg":
            if spec.running:
                cm = torch.cumsum(cnt_m, 0)
                n = cm - _before(cm, start_of)
            else:
                n = _seg_sum(cnt_m, seg, cap)[seg]
            d = run.to(torch.float64) / torch.where(
                n > 0, n, 1).to(torch.float64)
            if t.family is Family.DECIMAL:
                d = d / (10.0 ** t.scale)
            return d, b.mask & (n > 0)
        # a sum is NULL only where the whole partition has no value (the
        # reference's rule, running frames included)
        n = _seg_sum(cnt_m, seg, cap)[seg]
        d = run if t.family is Family.FLOAT else run.to(out_t.torch_dtype)
        return d, b.mask & (n > 0)
    if spec.func in ("min", "max"):
        is_min = spec.func == "min"
        data, inv = _minmax_input(col, t, spec.col, rank_tables, b.device)
        sent = _minmax_sentinel(data.dtype, is_min)
        vv = torch.where(m, data, torch.full_like(data, sent))
        if spec.running:
            # segmented running min/max: a boundary-resetting scan
            boundary = torch.cat([_head_flag(b.device), seg[1:] != seg[:-1]])
            red_rows = seg_scan(torch.minimum if is_min else torch.maximum,
                                vv, boundary)
            n = torch.cumsum(cnt_m, 0)
            nb = n - _before(n, start_of)
        else:
            red_rows = _seg_reduce(vv, seg, cap, is_min)[seg]
            nb = _seg_sum(cnt_m, seg, cap)[seg]
        return (_decode_rank(red_rows, inv).to(col.data.dtype),
                b.mask & (nb > 0))
    # first_value / last_value over the partition or the running frame
    last = spec.func == "last_value"
    if spec.running and last:  # running last_value is the current row
        return col.data, b.mask & col.valid
    # running first_value == the partition's first_value
    cand = torch.where(b.mask, pos, -1 if last else cap)
    idx = _seg_reduce(cand, seg, cap, not last)
    srcc = torch.clamp(idx[seg], 0, cap - 1)
    return col.data[srcc], b.mask & col.valid[srcc]


# ---------------------------------------------------------------------------
# framed windows


def _rmq_levels(vals: torch.Tensor, op) -> torch.Tensor:
    """Sparse table for range min/max queries: T[k, i] = reduce over
    [i, i + 2^k) (the out-of-range tail padded by repeating the last
    value). log2(cap) levels, written in place into one [K, cap] tensor:
    at a 2^25-row spool that is 26 x 2^25 int64 words, so the caller
    drops it as soon as it has been read."""
    cap = vals.shape[0]
    K = 1
    while (1 << (K - 1)) < cap:
        K += 1
    table = torch.empty((K, cap), dtype=vals.dtype, device=vals.device)
    table[0] = vals
    k = 1
    lvl = 1
    while k < cap:
        prev = table[lvl - 1]
        shifted = torch.cat([prev[k:], prev[-1:].expand(min(k, cap))])[:cap]
        table[lvl] = op(prev, shifted)
        k *= 2
        lvl += 1
    return table


def _rmq_query(table: torch.Tensor, op, lo: torch.Tensor, hi: torch.Tensor):
    """Per-row reduce over [lo, hi] (inclusive), widths data-dependent:
    level j = floor(log2(w)) by comparisons, then the two overlapping 2^j
    blocks combined."""
    K, cap = table.shape
    w = torch.clamp(hi - lo + 1, min=1)
    j = torch.zeros_like(w)
    for k in range(1, K):
        j = torch.where(w >= (1 << k), k, j)
    blk = torch.ones_like(j) << j
    flat = table.reshape(-1)
    a = flat[j * cap + torch.clamp(lo, 0, cap - 1)]
    c = flat[j * cap + torch.clamp(hi - blk + 1, 0, cap - 1)]
    return op(a, c)


def _lower_bound(u, q, lo0, hi0, strict: bool = False):
    """Per-row binary search: smallest idx in [lo0, hi0] with u[idx] >= q
    (u[idx] > q when strict; hi0 + 1 when none) — log2(cap) gather steps,
    a count fixed by the capacity, so no host sync."""
    n = u.shape[0]
    lo = lo0.to(torch.int64)
    hi = hi0.to(torch.int64) + 1
    for _ in range(max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)):
        active = lo < hi
        mid = (lo + hi) // 2
        um = u[torch.clamp(mid, 0, n - 1)]
        go_left = (um > q) if strict else (um >= q)
        hi = torch.where(active & go_left, mid, hi)
        lo = torch.where(active & ~go_left, mid + 1, lo)
    return lo


def _peer_run(peer_boundary, pos, mask, cap, order_keys, start_of, seg_end):
    """Per-row [first, last] position of the current row's PEER run.
    Without ORDER BY every partition row is a peer (SQL rule)."""
    if not order_keys:
        return start_of, seg_end
    peer_id = torch.cumsum(peer_boundary.to(torch.int64), 0) - 1
    ps = _seg_reduce(torch.where(mask, pos, cap), peer_id, cap, True)[peer_id]
    pe = _seg_reduce(torch.where(mask, pos, -1), peer_id, cap, False)[peer_id]
    return ps, pe


def _seg_run(pos, seg, member, cap, start_fallback, end_fallback):
    """Per-row [first, last] position of the rows where `member` holds,
    within the row's segment (fallbacks when the segment has none)."""
    first = _seg_reduce(torch.where(member, pos, cap), seg, cap, True)[seg]
    last = _seg_reduce(torch.where(member, pos, -1), seg, cap, False)[seg]
    return (torch.where(first == cap, start_fallback, first),
            torch.where(last == -1, end_fallback, last))


def _range_bounds(b: Batch, schema: Schema, spec: WindowSpec, order_keys,
                  seg, pos, start_of, seg_end):
    """Per-row RANGE frame bounds over the single numeric order key.

    Finite keys binary-search the sort-direction space u = sign * value
    (one monotone window [u - pre, u + fol] expresses ASC and DESC
    alike), within the segment's finite run. NULL rows — and, for
    floats, the NaN and +/-inf peer groups — take their frames from their
    contiguous peer run instead. INT/DECIMAL/DATE keys search in exact
    int64; only FLOAT keys search in float64."""
    cap = b.capacity
    k = order_keys[0]
    oc = b.cols[k.col]
    t = schema.types[k.col]
    valid = oc.valid & b.mask
    p, f = spec.frame

    if t.family is Family.FLOAT:
        data = oc.data.to(torch.float64)
        finite = valid & torch.isfinite(data)
        u = (-1.0 if k.desc else 1.0) * data
        pre = None if p is None else float(p)
        fol = None if f is None else float(f)
        park = float("inf")
    else:
        scale = 10 ** t.scale if t.family is Family.DECIMAL else 1
        data = oc.data.to(torch.int64)
        finite = valid
        u = (-1 if k.desc else 1) * data
        pre = None if p is None else int(round(float(p) * scale))
        fol = None if f is None else int(round(float(f) * scale))
        park = int(np.iinfo(np.int64).max)

    # masked-out positions never satisfy a comparison: park them at the
    # far end of the search space (searches stay in the finite run)
    fin_start, fin_end = _seg_run(pos, seg, finite, cap, start_of, seg_end)
    u = torch.where(finite, u, torch.full_like(u, park))

    lo = start_of if pre is None else _lower_bound(u, u - pre, fin_start,
                                                   fin_end)
    if fol is None:
        hi = seg_end
    else:
        # last idx with u <= q == (first idx with u > q) - 1
        hi = _lower_bound(u, u + fol, fin_start, fin_end, strict=True) - 1

    def run_frame(member):
        r_start, r_end = _seg_run(pos, seg, member, cap, start_of, seg_end)
        rlo = start_of if p is None else r_start
        rhi = seg_end if f is None else r_end
        return rlo, rhi

    # non-finite peer groups frame to their own contiguous run; unbounded
    # ends still reach the partition edge
    is_null = b.mask & ~oc.valid
    nlo, nhi = run_frame(is_null)
    lo = torch.where(is_null, nlo, lo)
    hi = torch.where(is_null, nhi, hi)
    if t.family is Family.FLOAT:
        fd = oc.data.to(torch.float64)
        for member in (valid & torch.isnan(fd), valid & torch.isposinf(fd),
                       valid & torch.isneginf(fd)):
            mlo, mhi = run_frame(member)
            lo = torch.where(member, mlo, lo)
            hi = torch.where(member, mhi, hi)
    return lo, hi


def _framed_window(b: Batch, schema: Schema, spec: WindowSpec, seg,
                   start_of, seg_end, pos, rank_tables, order_keys=(),
                   peer_boundary=None):
    """General ROWS/RANGE/GROUPS BETWEEN frame for the aggregate window
    functions: per-row frame bounds clamped to the partition;
    sums/counts/avgs by prefix-sum difference, min/max by the RMQ sparse
    table, first/last by a gather at the frame edge."""
    p, f = spec.frame
    cap = b.capacity
    i64 = torch.int64
    if spec.frame_kind == "groups":
        # the peer-id sequence is nondecreasing over the sorted batch, so
        # group-offset bounds are integer binary searches over it
        peer_id = torch.cumsum(peer_boundary.to(i64), 0) - 1
        lo = start_of if p is None else _lower_bound(
            peer_id, peer_id - int(p), start_of, seg_end)
        if f is None:
            hi = seg_end
        else:
            hi = _lower_bound(peer_id, peer_id + int(f), start_of, seg_end,
                              strict=True) - 1
    elif spec.frame_kind == "range":
        if all(x in (None, 0) for x in spec.frame):
            # peer-only frame (SQL's default shape): the peer run
            ps, pe = _peer_run(peer_boundary, pos, b.mask, cap, order_keys,
                               start_of, seg_end)
            lo = start_of if p is None else ps
            hi = seg_end if f is None else pe
        else:
            lo, hi = _range_bounds(b, schema, spec, order_keys, seg, pos,
                                   start_of, seg_end)
    else:
        lo = start_of if p is None else torch.maximum(start_of, pos - int(p))
        hi = seg_end if f is None else torch.minimum(seg_end, pos + int(f))
    empty = hi < lo  # e.g. 2 FOLLOWING AND 3 FOLLOWING past the edge

    # EXCLUDE: a contiguous sub-range of the frame — CURRENT ROW is
    # [pos, pos], GROUP/TIES the current peer run; TIES adds the current
    # row back. Sums subtract the excluded span; min/max query the two
    # surviving sub-ranges
    excl = spec.exclude
    keep_cur = None
    has_exc = None
    if excl != "no_others":
        if excl == "current":
            ex_lo, ex_hi = pos, pos
        else:
            ex_lo, ex_hi = _peer_run(peer_boundary, pos, b.mask, cap,
                                     order_keys, start_of, seg_end)
        exc_lo = torch.maximum(lo, ex_lo)
        exc_hi = torch.minimum(hi, ex_hi)
        has_exc = (exc_lo <= exc_hi) & ~empty
        if excl == "ties":
            keep_cur = (lo <= pos) & (pos <= hi)

    def range_sum(c, lo_, hi_, present):
        l_ = torch.clamp(lo_, 0, cap - 1)
        h_ = torch.clamp(hi_, 0, cap - 1)
        s = c[h_] - _before(c, l_)
        return torch.where(present, s, torch.zeros_like(s))

    def framed_total(per_row):
        """Sum of per_row over the frame, less the exclusions."""
        c = torch.cumsum(per_row, 0)
        tot = range_sum(c, lo, hi, ~empty)
        if has_exc is not None:
            tot = tot - range_sum(c, exc_lo, exc_hi, has_exc)
            if keep_cur is not None:
                tot = tot + torch.where(keep_cur, per_row,
                                        torch.zeros_like(per_row))
        return tot

    if spec.func in ("first_value", "last_value"):
        if keep_cur is not None:
            raise ValueError(
                "EXCLUDE TIES with first_value/last_value is not "
                "supported (bind-time rule)")
        lo_eff, hi_eff = lo, hi
        if has_exc is not None:
            # an edge inside the exclusion steps past it
            lo_eff = torch.where(has_exc & (exc_lo == lo), exc_hi + 1, lo)
            hi_eff = torch.where(has_exc & (exc_hi == hi), exc_lo - 1, hi)
        dead = empty | (hi_eff < lo_eff)
        col = b.cols[spec.col]
        edge = torch.clamp(lo_eff if spec.func == "first_value" else hi_eff,
                           0, cap - 1)
        return col.data[edge], col.valid[edge] & ~dead

    ones = torch.ones_like(b.mask)
    if spec.func == "count" and spec.col is None:
        return framed_total(b.mask.to(i64)), ones

    col = b.cols[spec.col]
    t = schema.types[spec.col]
    m = b.mask & col.valid
    wcnt = framed_total(m.to(i64))
    if spec.func in ("sum", "count", "avg"):
        if spec.func == "count":
            return wcnt, ones
        if spec.func == "avg" or t.family is Family.FLOAT:
            vals = torch.where(m, col.data.to(torch.float64), 0.0)
        else:
            vals = torch.where(m, col.data.to(i64), 0)
        wsum = framed_total(vals)
        if spec.func == "avg":
            d = wsum.to(torch.float64) / torch.where(
                wcnt > 0, wcnt, 1).to(torch.float64)
            if t.family is Family.DECIMAL:
                d = d / (10.0 ** t.scale)
            return d, wcnt > 0
        out_t = window_output_type(spec, schema)
        return wsum.to(out_t.torch_dtype), wcnt > 0

    # min / max through the RMQ sparse table
    is_min = spec.func == "min"
    data, inv = _minmax_input(col, t, spec.col, rank_tables, b.device)
    sent = _minmax_sentinel(data.dtype, is_min)
    vv = torch.where(m, data, torch.full_like(data, sent))
    op = torch.minimum if is_min else torch.maximum
    levels = _rmq_levels(vv, op)

    def rmq(lo_, hi_, present):
        r = _rmq_query(levels, op, torch.clamp(lo_, 0, cap - 1),
                       torch.clamp(hi_, 0, cap - 1))
        return torch.where(present & (lo_ <= hi_), r, torch.full_like(r, sent))

    if has_exc is None:
        red = rmq(lo, hi, ~empty)
    else:
        left = rmq(lo, exc_lo - 1, has_exc)
        right = rmq(exc_hi + 1, hi, has_exc)
        whole = rmq(lo, hi, ~empty & ~has_exc)
        red = op(op(left, right), whole)
        if keep_cur is not None:
            red = op(red, torch.where(keep_cur & m, vv,
                                      torch.full_like(vv, sent)))
    del levels
    return (_decode_rank(red, inv).to(col.data.dtype),
            (wcnt > 0) & ~empty)
