"""Grouped aggregation kernels — the hashAggregator / orderedAggregator
analog; the port of ``cockroach_tpu.ops.aggregation``.

Two strategies, as in the reference:

1. ``sort_groupby`` — the general path: sort the tile by the packed group
   key (ops/keys.py), mark segment boundaries, reduce per segment.
2. the dense path — for planner-bounded key spaces (e.g. TPC-H Q1's
   returnflag x linestatus): each row's dense group code IS its state
   slot, no sort (``dense_group_codes`` + ``dense_scatter_states``).

Both reduce by scatter over segment ids (``index_add_`` for sums and
counts, exact in int64; ``scatter_reduce`` for min/max): the reference's
CPU formulation, used here on every device. FLOAT sums add in another
order than the reference's (and, on CUDA, in a nondeterministic one), so
FLOAT states agree within a stated bound; DECIMAL and INT states exactly.

NULL semantics: NULLs form their own group; aggregates skip NULL inputs;
SUM/MIN/MAX over an empty (all-NULL) group is NULL; COUNT is 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..coldata.batch import Batch, Column, scatter_rows
from ..coldata.types import BOOL, FLOAT64, INT64, STRING, Family, Schema, SQLType
from . import keys as key_ops
from .sort import stable_argsort


@dataclass(frozen=True)
class AggSpec:
    # sum | count | count_rows | min | max | avg | any_not_null
    # | bool_and | bool_or | string_agg
    # | var | stddev | var_pop | stddev_pop | sum_sq (internal state)
    func: str
    col: int | None = None  # input column index (None for count_rows)
    name: str = ""
    sep: str = ","  # string_agg separator (ignored by every other func)


# statistical aggregates decompose into (sum, sum of squares, count) states
STAT_FUNCS = ("var", "stddev", "var_pop", "stddev_pop")


def agg_output_type(spec: AggSpec, schema: Schema) -> SQLType:
    if spec.func in ("count", "count_rows"):
        return INT64
    if spec.func in ("bool_and", "bool_or"):
        return BOOL
    if spec.func == "string_agg":
        return STRING
    if spec.func in ("avg",) + STAT_FUNCS or spec.func == "sum_sq":
        return FLOAT64
    t = schema.types[spec.col]
    if spec.func == "sum":
        # sum(int) stays int64 (CockroachDB promotes to DECIMAL); float
        # sums accumulate and return in float64
        if t.family is Family.FLOAT:
            return FLOAT64
        return t
    return t  # min/max/any_not_null keep input type


def _minmax_sentinel(dtype: torch.dtype, is_min: bool):
    """The identity of min (is_min) or max over `dtype`, a Python scalar."""
    if dtype.is_floating_point:
        return float("inf") if is_min else float("-inf")
    if dtype == torch.bool:
        return is_min
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min


def _seg_sum(vals: torch.Tensor, seg: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-segment sums into `cap` slots; rows with seg == cap drop."""
    out = torch.zeros(cap + 1, dtype=vals.dtype, device=vals.device)
    out.index_add_(0, seg, vals)
    return out[:cap]


def _seg_reduce(vals: torch.Tensor, seg: torch.Tensor, cap: int,
                is_min: bool) -> torch.Tensor:
    """Per-segment min or max into `cap` slots (the identity where a slot
    is empty); rows with seg == cap drop."""
    out = torch.full((cap + 1,), _minmax_sentinel(vals.dtype, is_min),
                     dtype=vals.dtype, device=vals.device)
    out = out.scatter_reduce(0, seg, vals, "amin" if is_min else "amax",
                             include_self=True)
    return out[:cap]


def _segment_agg(spec: AggSpec, col: Column | None, live, seg, cap: int,
                 t: SQLType | None):
    """Per-segment reduction -> (data[cap], valid[cap]) given segment ids
    in [0, cap]; id `cap` is a discarded slot."""
    dev = live.device
    ones = torch.ones(cap, dtype=torch.bool, device=dev)
    if spec.func == "count_rows":
        return _seg_sum(live.to(torch.int64), seg, cap), ones
    contributes = live & col.valid
    if spec.func == "count":
        return _seg_sum(contributes.to(torch.int64), seg, cap), ones
    nonempty = _seg_sum(contributes.to(torch.int64), seg, cap) > 0
    if spec.func in ("sum_f", "sum_sq"):
        d = col.data.to(torch.float64)
        if t is not None and t.family is Family.DECIMAL:
            d = d / (10.0 ** t.scale)
        if spec.func == "sum_sq":
            d = d * d
        vals = torch.where(contributes, d, 0.0)
        return _seg_sum(vals, seg, cap), nonempty
    if spec.func in ("sum", "avg"):
        if t.family is Family.FLOAT or spec.func == "avg":
            vals = torch.where(contributes, col.data.to(torch.float64), 0.0)
            s = _seg_sum(vals, seg, cap)
            if spec.func == "avg":
                cnt = _seg_sum(contributes.to(torch.int64), seg, cap)
                avg = s / torch.where(nonempty, cnt, 1).to(torch.float64)
                if t.family is Family.DECIMAL:
                    avg = avg / (10.0**t.scale)
                return avg, nonempty
            return s, nonempty
        vals = torch.where(contributes, col.data.to(torch.int64), 0)
        return _seg_sum(vals, seg, cap), nonempty
    if spec.func in ("min", "max"):
        is_min = spec.func == "min"
        vals = torch.where(contributes, col.data,
                           _minmax_sentinel(col.data.dtype, is_min))
        return _seg_reduce(vals, seg, cap, is_min), nonempty
    if spec.func == "any_not_null":
        vals = torch.where(contributes, col.data,
                           _minmax_sentinel(col.data.dtype, False))
        return _seg_reduce(vals, seg, cap, False), nonempty
    if spec.func in ("bool_and", "bool_or"):
        # AND = min over {0,1}, OR = max; non-contributing rows carry the
        # identity
        is_and = spec.func == "bool_and"
        vals = torch.where(contributes, col.data.to(torch.bool),
                           is_and).to(torch.int32)
        return _seg_reduce(vals, seg, cap, is_and).to(torch.bool), nonempty
    raise ValueError(f"unknown aggregate {spec.func}")


def sort_groupby(
    batch: Batch,
    schema: Schema,
    group_cols: tuple[int, ...],
    aggs: tuple[AggSpec, ...],
    out_capacity: int | None = None,
    col_stats: dict[int, tuple] | None = None,
    presorted: bool = False,
    compact: bool = True,
) -> tuple[Batch, torch.Tensor]:
    """General grouped aggregation over one tile. Output tile: one live row
    per group (group key columns first, then aggregates), groups in
    packed-key order, padded to capacity.

    Returns (batch, num_groups) with num_groups a device scalar. If
    num_groups > out_capacity the output is truncated and the caller must
    retry with a larger tile.

    presorted=True asserts equal group keys are already ADJACENT (clustered
    storage) and skips the key sort; compact=True then still pushes dead
    rows last with a one-operand stable sort, compact=False additionally
    asserts live rows form a prefix."""
    cap = batch.capacity
    cap_out = out_capacity or cap
    live = batch.mask
    dev = live.device
    col_stats = col_stats or {}

    # Sort live rows first, then by group keys (NULLs are their own group;
    # NULL rows' garbage data is zeroed inside key_segments).
    segs: list = [key_ops.BitSeg(1, (~live).to(torch.int64))]
    for gi in group_cols:
        c = batch.cols[gi]
        segs.extend(key_ops.key_segments(
            c.data, c.valid, schema.types[gi], desc=False, nulls_first=False,
            stats=col_stats.get(gi), order_semantics=False,
        ))
    operands = key_ops.pack_operands(segs)
    if not presorted:
        perm = stable_argsort(operands)
    elif compact:
        perm = stable_argsort([~live])
    else:
        perm = None  # identity permutation, zero sorts

    def rows(x):
        return x if perm is None else x[perm]

    key_words = [rows(w) for w in operands]
    live_s = rows(live)

    # Group boundaries: compare adjacent rows on the SORTED packed words
    # (word equality == full group-key equality, NULL==NULL included).
    idx = torch.arange(cap, device=dev)
    changed = torch.zeros(cap, dtype=torch.bool, device=dev)
    for w in key_words:
        changed = changed | (w != torch.roll(w, 1, 0))
    prev_live = torch.roll(live_s, 1, 0)
    boundary = live_s & ((idx == 0) | changed | ~prev_live)
    num_groups = boundary.sum(dtype=torch.int64)
    out_mask = torch.arange(cap_out, device=dev) < num_groups

    # Segment ids: each boundary row's key goes to its segment slot, every
    # row reduces into its segment (dead rows, sorted last, contribute
    # nothing); ids past the output capacity drop.
    seg = torch.clamp(torch.cumsum(boundary.to(torch.int64), 0) - 1, min=0)
    seg = torch.where(seg < cap_out, seg, cap_out)
    dest = torch.where(boundary, seg, cap_out)
    out_cols: list[Column] = []
    for gi in group_cols:
        c = batch.cols[gi]
        out_cols.append(Column(
            data=scatter_rows(rows(c.data), dest, cap_out),
            valid=scatter_rows(rows(c.valid), dest, cap_out)))
    for spec in aggs:
        col = t = None
        if spec.col is not None:
            t = schema.types[spec.col]
            c = batch.cols[spec.col]
            col = Column(data=rows(c.data), valid=rows(c.valid))
        data, valid = _segment_agg(spec, col, live_s, seg, cap_out, t)
        out_cols.append(Column(data=data, valid=valid & out_mask))
    return Batch(cols=tuple(out_cols), mask=out_mask), num_groups


def groupby_output_schema(
    schema: Schema, group_cols: tuple[int, ...], aggs: tuple[AggSpec, ...]
) -> Schema:
    names = [schema.names[i] for i in group_cols]
    types = [schema.types[i] for i in group_cols]
    for spec in aggs:
        names.append(spec.name or f"{spec.func}_{spec.col}")
        types.append(agg_output_type(spec, schema))
    return Schema(tuple(names), tuple(types))


_MERGE_FUNC = {
    "sum": "sum", "sum_f": "sum", "sum_sq": "sum", "count": "sum",
    "count_rows": "sum", "min": "min", "max": "max",
    "any_not_null": "any_not_null", "bool_and": "bool_and",
    "bool_or": "bool_or",
}


def partial_layout(
    schema: Schema, group_cols: tuple[int, ...], aggs: tuple[AggSpec, ...]
):
    """The partial-aggregation state layout shared by the partial and
    merge stages: group keys first, then state columns (avg -> sum +
    count; var/stddev -> sum, sum of squares, count).

    Returns (partial_specs, state_schema, final_map); final_map[j] locates
    output aggregate j's states relative to the first state column."""
    partial_specs: list[AggSpec] = []
    final_map = []
    for spec in aggs:
        si = len(partial_specs)
        if spec.func in STAT_FUNCS:
            partial_specs.append(AggSpec("sum_f", spec.col, f"_s{si}"))
            partial_specs.append(AggSpec("sum_sq", spec.col, f"_q{si}"))
            partial_specs.append(AggSpec("count", spec.col, f"_c{si}"))
            final_map.append((spec.func, si, si + 1, si + 2))
        elif spec.func == "avg":
            t = schema.types[spec.col]
            partial_specs.append(AggSpec("sum", spec.col, f"_s{si}"))
            partial_specs.append(AggSpec("count", spec.col, f"_c{si}"))
            final_map.append(("avg", si, si + 1, t))
        else:
            partial_specs.append(AggSpec(spec.func, spec.col, f"_st{si}"))
            final_map.append((spec.func, si))
    state_schema = groupby_output_schema(
        schema, group_cols, tuple(partial_specs)
    )
    return tuple(partial_specs), state_schema, final_map


def merge_specs_for(partial_specs: tuple[AggSpec, ...], num_keys: int):
    """Merge aggregation specs over the partial-state layout (group keys at
    0..num_keys-1, states after)."""
    return tuple(
        AggSpec(_MERGE_FUNC[s.func], num_keys + i, s.name)
        for i, s in enumerate(partial_specs)
    )


def finalize_states(state: Batch, final_map, num_keys: int) -> Batch:
    """Turn a merged partial-state batch into final SQL results (avg =
    sum / count in float64, then the decimal scale divided out)."""
    k = num_keys
    cols = list(state.cols[:k])
    for fm in final_map:
        if fm[0] in STAT_FUNCS:
            func, si, qi, ci = fm
            sm = state.cols[k + si].data.to(torch.float64)
            sq = state.cols[k + qi].data.to(torch.float64)
            n = state.cols[k + ci].data.to(torch.float64)
            safe_n = torch.where(n > 0, n, 1.0)
            mean = sm / safe_n
            if func.endswith("_pop"):
                var = torch.clamp(sq / safe_n - mean * mean, min=0.0)
                valid = state.cols[k + ci].data > 0
            else:
                denom = torch.where(n > 1, n - 1.0, 1.0)
                var = torch.clamp((sq - n * mean * mean) / denom, min=0.0)
                valid = state.cols[k + ci].data > 1
            d = torch.sqrt(var) if func.startswith("stddev") else var
            cols.append(Column(data=d, valid=valid & state.mask))
            continue
        if fm[0] == "avg":
            _, si, ci, t = fm
            s = state.cols[k + si]
            c = state.cols[k + ci]
            denom = torch.where(c.data > 0, c.data, 1).to(torch.float64)
            d = s.data.to(torch.float64) / denom
            if t.family is Family.DECIMAL:
                d = d / (10.0**t.scale)
            cols.append(Column(data=d, valid=s.valid & (c.data > 0)))
        else:
            cols.append(state.cols[k + fm[1]])
    return Batch(cols=tuple(cols), mask=state.mask)


# ---------------------------------------------------------------------------
# dense path: positionally aligned [G] states


def smallgroup_partial_states(
    batch: Batch,
    schema: Schema,
    codes: torch.Tensor,
    num_groups: int,
    specs: tuple[AggSpec, ...],
):
    """One-hot dense partial aggregation: a [tile, G] membership matrix and
    masked reductions over it — the reference's accelerator kernel for
    tiny G. Returns (state_cols, group_rows) like dense_scatter_states."""
    G = num_groups
    live = batch.mask
    codes = torch.clamp(codes.to(torch.int64), 0, G - 1)
    onehot = ((codes[:, None] == torch.arange(G, device=live.device)[None, :])
              & live[:, None])
    group_rows = onehot.sum(dim=0, dtype=torch.int64)
    out = []
    for spec in specs:
        if spec.func == "count_rows":
            out.append((group_rows, torch.ones(G, dtype=torch.bool,
                                               device=live.device)))
            continue
        col = batch.cols[spec.col]
        t = schema.types[spec.col]
        member = onehot & col.valid[:, None]
        cnt = member.sum(dim=0, dtype=torch.int64)
        nonempty = cnt > 0
        if spec.func == "count":
            out.append((cnt, torch.ones(G, dtype=torch.bool,
                                        device=live.device)))
        elif spec.func == "sum":
            if t.family is Family.FLOAT:
                v = torch.where(member, col.data.to(torch.float64)[:, None],
                                0.0)
            else:
                v = torch.where(member, col.data.to(torch.int64)[:, None], 0)
            out.append((v.sum(dim=0), nonempty))
        elif spec.func in ("min", "max", "any_not_null"):
            is_min = spec.func == "min"
            v = torch.where(member, col.data[:, None],
                            _minmax_sentinel(col.data.dtype, is_min))
            red = v.amin(dim=0) if is_min else v.amax(dim=0)
            out.append((red, nonempty))
        else:
            raise ValueError(f"unsupported dense-state aggregate {spec.func}")
    return out, group_rows


def merge_dense_states(specs: tuple[AggSpec, ...], acc, new):
    """Elementwise merge of positionally-aligned dense states."""
    out = []
    for spec, (ad, av), (nd, nv) in zip(specs, acc, new):
        if spec.func in ("sum", "count", "count_rows"):
            out.append((ad + nd, av | nv))
        elif spec.func == "min":
            out.append((torch.minimum(ad, nd), av | nv))
        elif spec.func in ("max", "any_not_null"):
            out.append((torch.maximum(ad, nd), av | nv))
        else:
            raise ValueError(spec.func)
    return out


# ---------------------------------------------------------------------------
# mesh reduction of positionally aligned states (sharded -> replicated)


def psum_dense_states(specs: tuple[AggSpec, ...], shard_states: list,
                      mesh) -> list:
    """Reduce per-shard dense (or scalar) states across the mesh: sums and
    counts ride psum, min/max pmin/pmax, bool_and/bool_or pmin/pmax over
    int32 lanes, valid flags OR (psum > 0). `shard_states`: one state
    list per shard; returns the reduced list for every shard."""
    from ..parallel import mesh as mesh_mod

    out_shards = [[] for _ in shard_states]
    for j, spec in enumerate(specs):
        ds = [st[j][0] for st in shard_states]
        vs = [st[j][1] for st in shard_states]
        if spec.func in ("sum", "count", "count_rows"):
            rd = mesh_mod.psum(ds, mesh)
        elif spec.func == "min":
            rd = mesh_mod.pmin(ds, mesh)
        elif spec.func in ("max", "any_not_null"):
            rd = mesh_mod.pmax(ds, mesh)
        elif spec.func == "avg":  # (sum, count)
            parts = [mesh_mod.psum([d[i] for d in ds], mesh)
                     for i in range(len(ds[0]))]
            rd = [tuple(p[s] for p in parts) for s in range(len(ds))]
        elif spec.func in ("bool_and", "bool_or"):
            red = mesh_mod.pmin if spec.func == "bool_and" else mesh_mod.pmax
            rd = [x.to(torch.bool) for x in
                  red([d.to(torch.int32) for d in ds], mesh)]
        else:
            raise ValueError(spec.func)
        rv = [x > 0 for x in
              mesh_mod.psum([v.to(torch.int32) for v in vs], mesh)]
        for s, out in enumerate(out_shards):
            out.append((rd[s], rv[s]))
    return out_shards


def dense_layout(key_sizes: tuple[int, ...]) -> tuple[int, tuple[int, ...]]:
    """(G, strides) for the dense group-code space: one extra code per key
    column for NULL (every NULL combination is its own group)."""
    eff = tuple(s + 1 for s in key_sizes)
    G = 1
    for s in eff:
        G *= s
    strides = []
    acc = 1
    for s in reversed(eff):
        strides.append(acc)
        acc *= s
    return G, tuple(reversed(strides))


def dense_group_codes(batch: Batch, group_cols, strides, key_sizes,
                      key_lows=None):
    """Per-row dense group code from bounded key columns (NULL maps to the
    extra per-column code), and the rows outside the planned bounds
    (stale stats), which are flagged rather than clipped into a neighbour."""
    dev = batch.device
    code = torch.zeros(batch.capacity, dtype=torch.int64, device=dev)
    oob = torch.zeros(batch.capacity, dtype=torch.bool, device=dev)
    lows = key_lows or (0,) * len(group_cols)
    for gi, st, size, lo in zip(group_cols, strides, key_sizes, lows):
        c = batch.cols[gi]
        v = c.data.to(torch.int64) - lo
        oob = oob | (c.valid & ((v < 0) | (v >= size)))
        ci = torch.where(c.valid, torch.clamp(v, 0, size - 1), size)
        code = code + ci * st
    return code, oob


def dense_scatter_states(
    batch: Batch,
    schema: Schema,
    codes: torch.Tensor,
    G: int,
    specs: tuple[AggSpec, ...],
):
    """Scatter dense-code partial aggregation: rows with group code g
    reduce into slot g of [G] state arrays — no sort, no one-hot. Dead
    rows drop. Returns (state_cols, group_rows), positionally aligned by
    code, so cross-tile merging is elementwise (merge_dense_states)."""
    live = batch.mask
    seg = torch.where(live, codes.to(torch.int64), G)
    group_rows = _seg_sum(live.to(torch.int64), seg, G)
    out = []
    for spec in specs:
        col = t = None
        if spec.col is not None:
            t = schema.types[spec.col]
            col = batch.cols[spec.col]
        out.append(_segment_agg(spec, col, live, seg, G, t))
    return out, group_rows


def dense_onehot_states(
    batch: Batch,
    schema: Schema,
    codes: torch.Tensor,
    G: int,
    specs: tuple[AggSpec, ...],
):
    """One-hot dense partial states (``smallgroup_partial_states``): the
    [rows, G] membership matrix, the right shape only for tiny G."""
    return smallgroup_partial_states(batch, schema, codes, G, specs)


def dense_finalize(base: Schema, group_cols, strides, key_sizes, G,
                   final_map, states, rows, key_lows=None) -> Batch:
    """Decode dense group codes back into key columns and finalize the
    aggregate states; groups with no rows are dead."""
    dev = rows.device
    gid = torch.arange(G, dtype=torch.int64, device=dev)
    lows = key_lows or (0,) * len(group_cols)
    cols = []
    for gi, st, size, lo in zip(group_cols, strides, key_sizes, lows):
        code_i = (gid // st) % (size + 1)
        t = base.types[gi]
        valid = code_i < size  # code==size means NULL key
        cols.append(Column(
            data=torch.where(valid, code_i + lo, 0).to(t.torch_dtype),
            valid=valid,
        ))
    mask = rows > 0
    for (d, v) in states:
        cols.append(Column(data=d, valid=v & mask))
    state_batch = Batch(cols=tuple(cols), mask=mask)
    return finalize_states(state_batch, final_map, len(group_cols))


# ---------------------------------------------------------------------------
# scalar (no GROUP BY) aggregation states


def scalar_tile_states(batch: Batch, aggs: tuple[AggSpec, ...],
                       base: Schema):
    """Per-tile scalar states: one (value, valid) pair of 0-d tensors per
    aggregate (avg carries (sum, count); var/stddev (sum, sum of
    squares, count))."""
    out = []
    for spec in aggs:
        if spec.func == "count_rows":
            out.append((batch.mask.sum(dtype=torch.int64),
                        torch.ones((), dtype=torch.bool, device=batch.device)))
            continue
        c = batch.cols[spec.col]
        t = base.types[spec.col]
        m = batch.mask & c.valid
        cnt = m.sum(dtype=torch.int64)
        if spec.func == "count":
            out.append((cnt, torch.ones((), dtype=torch.bool,
                                        device=batch.device)))
        elif spec.func in ("sum", "avg"):
            if t.family is Family.FLOAT or spec.func == "avg":
                s = torch.where(m, c.data.to(torch.float64), 0.0).sum()
            else:
                s = torch.where(m, c.data.to(torch.int64), 0).sum()
            out.append(((s, cnt) if spec.func == "avg" else s, cnt > 0))
        elif spec.func in ("min", "max"):
            is_min = spec.func == "min"
            vals = torch.where(m, c.data,
                               _minmax_sentinel(c.data.dtype, is_min))
            out.append((vals.min() if is_min else vals.max(), cnt > 0))
        elif spec.func in STAT_FUNCS:
            d = c.data.to(torch.float64)
            if t.family is Family.DECIMAL:
                d = d / (10.0 ** t.scale)
            s_ = torch.where(m, d, 0.0).sum()
            q_ = torch.where(m, d * d, 0.0).sum()
            ok = cnt > 0 if spec.func.endswith("_pop") else cnt > 1
            out.append(((s_, q_, cnt), ok))
        elif spec.func in ("bool_and", "bool_or"):
            is_and = spec.func == "bool_and"
            vals = torch.where(m, c.data.to(torch.bool), is_and)
            out.append((vals.all() if is_and else vals.any(), cnt > 0))
        else:
            raise ValueError(spec.func)
    return out


def scalar_merge_states(aggs: tuple[AggSpec, ...], acc, new):
    """Merge two tiles' scalar states, aggregate by aggregate."""
    out = []
    for spec, (a, av), (n, nv) in zip(aggs, acc, new):
        if spec.func in ("count", "count_rows"):
            out.append((a + n, av))
        elif spec.func == "sum":
            out.append((a + n, av | nv))
        elif spec.func == "avg":
            out.append(((a[0] + n[0], a[1] + n[1]), av | nv))
        elif spec.func in STAT_FUNCS:
            cnt = a[2] + n[2]
            ok = cnt > 0 if spec.func.endswith("_pop") else cnt > 1
            out.append(((a[0] + n[0], a[1] + n[1], cnt), ok))
        elif spec.func == "min":
            out.append((torch.minimum(a, n), av | nv))
        elif spec.func == "max":
            out.append((torch.maximum(a, n), av | nv))
        elif spec.func == "bool_and":
            out.append((a & n, av | nv))
        elif spec.func == "bool_or":
            out.append((a | n, av | nv))
        else:
            raise ValueError(spec.func)
    return out


def scalar_result_batch(aggs: tuple[AggSpec, ...], base: Schema,
                        out_schema: Schema, acc, device=None) -> Batch:
    """States -> one-row result Batch. acc=None means empty input (its
    row lands on `device`): counts are 0, everything else NULL."""
    if acc is not None:
        device = acc[0][1].device
    cols = []
    for spec, t, st in zip(aggs, out_schema.types,
                           acc if acc is not None else [None] * len(aggs)):
        if st is None:
            if spec.func in ("count", "count_rows"):
                d = torch.zeros(1, dtype=torch.int64, device=device)
                v = torch.ones(1, dtype=torch.bool, device=device)
            else:
                d = torch.zeros(1, dtype=t.torch_dtype, device=device)
                v = torch.zeros(1, dtype=torch.bool, device=device)
            cols.append(Column(data=d, valid=v))
            continue
        val, valid = st
        if spec.func in STAT_FUNCS:
            sm, sq, c = val
            n = c.to(torch.float64)
            safe_n = torch.where(n > 0, n, 1.0)
            mean = sm / safe_n
            if spec.func.endswith("_pop"):
                var = torch.clamp(sq / safe_n - mean * mean, min=0.0)
            else:
                denom = torch.where(n > 1, n - 1.0, 1.0)
                var = torch.clamp((sq - n * mean * mean) / denom, min=0.0)
            d = torch.sqrt(var) if spec.func.startswith("stddev") else var
        elif spec.func == "avg":
            s, c = val
            base_t = base.types[spec.col]
            d = s.to(torch.float64) / torch.where(c > 0, c, 1).to(
                torch.float64)
            if base_t.family is Family.DECIMAL:
                d = d / (10.0**base_t.scale)
        else:
            d = val.to(t.torch_dtype)
        cols.append(Column(data=d.reshape(1), valid=valid.reshape(1)))
    return Batch(cols=tuple(cols),
                 mask=torch.ones(1, dtype=torch.bool, device=device))


def agg_output_schema(
    base: Schema, group_cols: tuple[int, ...], aggs: tuple[AggSpec, ...],
    mode: str = "complete",
) -> Schema:
    """Output schema of an aggregation stage — the ONE place the group-key
    + per-agg naming/typing rule lives (avg -> FLOAT64, else
    agg_output_type)."""
    _, state_schema, final_map = partial_layout(base, group_cols, aggs)
    if mode == "partial":
        return state_schema
    k = len(group_cols)
    if mode == "final":
        names = list(state_schema.names[:k])
        types = list(state_schema.types[:k])
    else:
        names = [base.names[i] for i in group_cols]
        types = [base.types[i] for i in group_cols]
    for spec, fm in zip(aggs, final_map):
        names.append(spec.name or spec.func)
        types.append(FLOAT64 if fm[0] in ("avg",) + STAT_FUNCS
                     else agg_output_type(spec, base))
    return Schema(tuple(names), tuple(types))
