"""Flow operators — the colexec operator set over the Operator contract;
the port of the operators of ``cockroach_tpu.flow.operators`` that the
22 TPC-H queries run on one device: ScanOp (resident and streaming),
FilterOp, ProjectOp, LimitOp, AggregateOp (sort-groupby),
SmallGroupAggregateOp (dense codes), ScalarAggregateOp, SortOp, TopKOp,
DistinctOp and HashJoinOp (unique-build, existence and duplicate-key
joins, over exact packed or hashed keys).

Each operator runs its tile function as eager torch ops per tile (the
reference composes streaming chains into one jitted kernel; the port runs
the unfused tree). Buffering operators size their spools by LIVE row
count, one counted host sync per spool, so downstream work runs at the
smallest canonical capacity that fits the data. Past its budget
(``sql.distsql.workmem_rows`` or the ``workmem_bytes`` account of
``flow/memory``) a buffering operator swaps in its external variant
(``flow/external.py``): SortOp the external sort, HashJoinOp the Grace
hash join, AggregateOp and DistinctOp the Grace aggregation. Paths the
port has not brought over (partial-mode aggregation, string_agg) raise
NotImplementedError naming what waits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..catalog import SHAPE_BUCKETS, Table
from ..coldata.batch import Batch, Column, compact, concat, empty_batch
from ..coldata.types import FLOAT64, Family, Schema
from ..device import resolve_device
from ..ops import aggregation as agg_ops
from ..ops import expr as ex
from ..ops import join as join_ops
from ..ops import sort as sort_ops
from ..utils import settings
from .external import (ChainOp, ExternalSortOp, GraceAggregateOp,
                       GraceHashJoinOp)
from .memory import Allocator, batch_bytes, note_spill
from .operator import OneInputOperator, Operator, SourceOperator
from .upload import TileStream

NOT_PORTED = join_ops.NOT_PORTED


def _next_pow2(n: int) -> int:
    p = 1024
    while p < n:
        p *= 2
    return p


def _canonical_cap(n: int) -> int:
    """Canonical capacity for data-dependent intermediates (spools,
    compacted probe output): the catalog.SHAPE_BUCKETS rung ladder, pow2
    above it."""
    if settings.get("sql.distsql.shape_buckets.enabled"):
        for b in SHAPE_BUCKETS:
            if n <= b:
                return b
    return _next_pow2(n)


def _spool_cap(op: Operator, tiles: list[Batch]) -> int:
    """Canonical capacity fitting the spool's LIVE rows (concat compacts):
    one counted host sync for the whole spool."""
    live = torch.stack([t.mask.sum(dtype=torch.int64) for t in tiles]).sum()
    return _canonical_cap(max(1, op.sync_int(live)))


def _source_device(op: Operator) -> torch.device:
    """The device of the table under an operator chain."""
    while not isinstance(op, ScanOp):
        op = op.children()[0]
    return op.table.device


# ---------------------------------------------------------------------------
# Scan


class ScanOp(SourceOperator):
    """Tile-granular scan (cFetcher analog), in one of two modes:

    - resident: the table materializes once on the device
      (catalog.Table.device_batch, padded to a multiple of the tile) and
      bounded tiles slice from it as views;
    - streaming: a table over ``sql.distsql.scan_stream_rows`` never
      occupies the device whole. Its tiles upload host -> device double
      buffered (``flow/upload.TileStream``): the next tile's upload is
      started before the current one is handed on, so the copy overlaps
      the downstream work. The stream tile is the reference's:
      ``_next_pow2(max(4096, min(2^20, rows // 64)))``, or the
      operator's tile if larger.
    """

    def __init__(self, table: Table, columns: tuple[str, ...] | None = None,
                 tile: int | None = None):
        super().__init__()
        self.table = table
        names = columns or table.schema.names
        idxs = tuple(table.schema.index(n) for n in names)
        self.col_idxs = idxs
        self.output_schema = table.schema.select(idxs)
        full_dicts = table.dict_by_index()
        self.dictionaries = {
            i: full_dicts[ci] for i, ci in enumerate(idxs) if ci in full_dicts
        }
        by_name = table.col_stats()
        self.col_stats = {
            i: by_name[n] for i, n in enumerate(self.output_schema.names)
            if n in by_name
        }
        self.tile = tile
        self._batch = None
        self._offset = 0
        self.streaming = False
        self._stream = None

    def init(self):
        self.streaming = (self.table.num_rows
                          > settings.get("sql.distsql.scan_stream_rows"))
        if self.streaming:
            self._init_streaming()
        else:
            self._init_resident()
        self._offset = 0
        super().init()

    def _init_resident(self):
        self._batch = self.table.device_batch(self.output_schema.names)
        cap = self._batch.capacity
        tile = self.tile
        if tile is None or tile <= 0 or cap % tile != 0:
            tile = cap  # small tables: one tile
        self._res_tile = min(tile, cap)

    def _init_streaming(self):
        t = self.table
        nrows = t.num_rows
        # big tiles amortize launches; about 64 tiles per table keeps the
        # pipeline busy at any scale
        auto = _next_pow2(max(1 << 12, min(1 << 20, nrows // 64)))
        tile = max(self.tile or 0, auto)
        if self._stream is None or self._stream.tile != tile:
            names = self.output_schema.names
            self._stream = TileStream(
                self.output_schema,
                {n: np.asarray(t.columns[n]) for n in names},
                {n: np.asarray(t.valids[n]) for n in names if n in t.valids},
                nrows, tile, resolve_device(t.device or "cuda"))
        self._stream.reset()
        self._prefetched = None

    def _next_streaming(self):
        st = self._stream
        if self._offset >= st.nrows:
            return None
        cur = self._prefetched
        if cur is None:
            cur = st.upload(self._offset)
        nxt = self._offset + st.tile
        # start the next upload BEFORE handing the current tile on: its
        # copy overlaps the consumer's work on this one
        self._prefetched = st.upload(nxt) if nxt < st.nrows else None
        self._offset = nxt
        return st.get(cur)

    def _next(self):
        if self.streaming:
            return self._next_streaming()
        b = self._batch
        off = self._offset
        if off >= b.capacity:
            return None
        self._offset += self._res_tile
        if self._res_tile == b.capacity:
            return b
        end = off + self._res_tile
        return Batch(
            cols=tuple(Column(data=c.data[off:end], valid=c.valid[off:end])
                       for c in b.cols),
            mask=b.mask[off:end])


# ---------------------------------------------------------------------------
# Streaming ops


class FilterOp(OneInputOperator):
    """Predicate mask."""

    def __init__(self, child: Operator, predicate: ex.Expr):
        super().__init__(child)
        self.output_schema = child.output_schema
        self.predicate = predicate

    def _next(self):
        b = self.child.next_batch()
        if b is None:
            return None
        return b.with_mask(
            ex.filter_mask(b, self.output_schema, self.predicate))


class ProjectOp(OneInputOperator):
    def __init__(self, child: Operator, exprs: tuple[ex.Expr, ...],
                 names: tuple[str, ...], dict_overrides: tuple = ()):
        super().__init__(child)
        self.exprs = exprs  # HashJoinOp's dense-build walk maps keys through these
        schema = child.output_schema
        types = tuple(ex.expr_type(e, schema) for e in exprs)
        self.output_schema = Schema(tuple(names), types)
        # dictionaries survive through bare column references; host-side
        # string transforms attach theirs via dict_overrides
        self.dictionaries = {
            i: self.child.dictionaries[e.idx]
            for i, e in enumerate(exprs)
            if isinstance(e, ex.ColRef) and e.idx in self.child.dictionaries
        }
        for i, d in dict_overrides:
            self.dictionaries[i] = d
        # bounds propagate through computed columns, not just references
        self.col_stats = {}
        for i, e in enumerate(exprs):
            b = ex.expr_bounds(e, schema, self.child.col_stats)
            if b is not None:
                self.col_stats[i] = b

    def _next(self):
        b = self.child.next_batch()
        if b is None:
            return None
        schema = self.child.output_schema
        cols = []
        for e in self.exprs:
            d, v = ex.eval_expr(e, b.cols, schema)
            cols.append(Column(data=d, valid=v))
        return Batch(cols=tuple(cols), mask=b.mask)


class LimitOp(OneInputOperator):
    def __init__(self, child: Operator, limit: int, offset: int = 0):
        super().__init__(child)
        self.output_schema = child.output_schema
        self.limit = limit
        self.offset = offset

    def init(self):
        super().init()
        self._seen = 0
        self._done = False

    def _next(self):
        if self._done:
            return None
        b = self.child.next_batch()
        if b is None:
            return None
        pos = self._seen + torch.cumsum(b.mask.to(torch.int64), 0) - 1
        keep = (b.mask & (pos >= self.offset)
                & (pos < self.offset + self.limit))
        self._seen += self.sync_int(b.mask.sum())
        if self._seen >= self.offset + self.limit:
            self._done = True
        return b.with_mask(keep)


# ---------------------------------------------------------------------------
# Aggregation


class AggregateOp(OneInputOperator):
    """GROUP BY aggregation (hashAggregator analog), complete mode: each
    input tile reduces to a partial-state tile by sort_groupby; the spool
    merges down (concat + sort_groupby over the state layout) when it
    outgrows ``sql.distsql.workmem_rows`` or its byte account, and once at
    the end, then the states finalize.

    When a merge-down does not shrink under budget (the group count
    itself exceeds it), the spooled state tiles and the rest of the
    partial stream go to the Grace aggregation (flow/external.py), which
    stages them on the host in group-disjoint hash partitions and merges
    and finalizes one partition per output batch."""

    def __init__(
        self,
        child: Operator,
        group_cols: tuple[int, ...],
        aggs: tuple[agg_ops.AggSpec, ...],
        mode: str = "complete",
        ordered: bool = False,
        prefix_live: bool = False,
    ):
        super().__init__(child)
        if mode != "complete":
            raise NotImplementedError(
                f"{mode}-mode aggregation is a distributed stage, which "
                "waits for the port's multi-device slice (ROADMAP Queue 1)")
        if any(s.func == "string_agg" for s in aggs):
            raise NotImplementedError("string_agg " + NOT_PORTED)
        self.group_cols = group_cols
        self.aggs = aggs
        # ordered: equal group keys arrive adjacent (clustered scan); the
        # per-tile grouping skips its key sort. prefix_live: tiles are
        # live-prefix too, dropping the dead-row compaction sort.
        self.ordered = ordered
        self.prefix_live = prefix_live
        base = child.output_schema
        self.base_schema = base
        self.partial_specs, self.state_schema, self.final_map = (
            agg_ops.partial_layout(base, group_cols, aggs))
        k = len(group_cols)
        self.num_keys = k
        self.merge_specs = agg_ops.merge_specs_for(self.partial_specs, k)
        self.output_schema = agg_ops.agg_output_schema(base, group_cols, aggs)
        self.dictionaries = {
            group_cols.index(gi): d
            for gi, d in child.dictionaries.items() if gi in group_cols
        }
        self.key_stats = {
            group_cols.index(gi): s
            for gi, s in child.col_stats.items() if gi in group_cols
        }
        # STRING group keys without numeric stats still pack tight: the
        # dictionary size bounds the code range
        for pos, d in self.dictionaries.items():
            self.key_stats.setdefault(pos, (0, max(0, len(d) - 1)))
        self.col_stats = dict(self.key_stats)
        self.in_stats = {
            gi: s for gi, s in child.col_stats.items() if gi in group_cols
        }
        for gi in group_cols:
            if gi in child.dictionaries:
                self.in_stats.setdefault(
                    gi, (0, max(0, len(child.dictionaries[gi]) - 1)))
        self._spool_alloc = None

    def init(self):
        super().init()
        self._reset()

    def _reset(self):
        self._emitted = False
        self._tiles: list[Batch] = []
        self._external = None
        self._close_spool()  # a re-run: the prior account is dead

    def _close_spool(self) -> None:
        if self._spool_alloc is not None:
            self._spool_alloc.close()
            self._spool_alloc = None

    def _partial(self, b: Batch) -> Batch:
        # out_capacity == input capacity: groups <= live rows, so this
        # cannot overflow — no host sync per tile
        part, _ = agg_ops.sort_groupby(
            b, self.base_schema, self.group_cols, self.partial_specs,
            out_capacity=b.capacity, col_stats=self.in_stats,
            presorted=self.ordered, compact=not self.prefix_live)
        return part

    def merge(self, tiles: list[Batch], cap: int):
        """Merge state tiles into one tile of capacity `cap` ->
        (merged, group count as a device scalar)."""
        both = concat(tiles, capacity=cap)
        # ordered partials stay in scan order per tile, so their
        # concatenation is still clustered
        return agg_ops.sort_groupby(
            both, self.state_schema, tuple(range(self.num_keys)),
            self.merge_specs, out_capacity=cap, col_stats=self.key_stats,
            presorted=self.ordered, compact=True)

    def finalize(self, state: Batch) -> Batch:
        return agg_ops.finalize_states(state, self.final_map, self.num_keys)

    def _merge_down(self, tiles: list[Batch]) -> Batch:
        cap = _spool_cap(self, tiles)
        while True:
            merged, ng = self.merge(tiles, cap)
            n = self.sync_int(ng)
            if n <= cap:
                return merged
            cap = _canonical_cap(n)

    def _spool(self):
        """Spool per-tile partial states; merge down only when the spool
        exceeds workmem (rows, or the byte account); spill to the Grace
        aggregation when a merge-down stays over."""
        budget = settings.get("sql.distsql.workmem_rows")
        alloc = self._spool_alloc = Allocator("aggregation spool")

        def partials():
            while True:
                b = self.child.next_batch()
                if b is None:
                    return
                yield self._partial(b)

        source = partials()
        spooled = 0
        for part in source:
            self._tiles.append(part)
            spooled += part.capacity
            nb = batch_bytes(part)
            over = alloc.would_exceed(nb)
            # the tile is resident whether or not the budget likes it:
            # account it truthfully (forcing past the refusal)
            alloc.reserve(nb, force=over)
            if spooled > budget or over:
                self._tiles = [self._merge_down(self._tiles)]
                spooled = self._tiles[0].capacity
                alloc.release()
                mb = batch_bytes(self._tiles[0])
                over = alloc.would_exceed(mb)
                alloc.reserve(mb, force=over)
                if spooled > budget or over:
                    # the group count itself exceeds memory: hand the
                    # spooled states and the rest of the partial stream
                    # to the Grace aggregation
                    note_spill("agg")
                    self.stats.spilled = True
                    self._close_spool()
                    chain = ChainOp(self._tiles, self.state_schema,
                                    self.dictionaries, _Rest(source))
                    chain.init()
                    self._external = GraceAggregateOp(chain, self)
                    self._external.init()
                    self._external.stats = self.stats
                    self._tiles = []
                    return

    def _next(self):
        if self._external is not None:
            return self._external.next_batch()  # spilled: partitions
        if self._emitted:
            return None
        self._spool()
        if self._external is not None:
            return self._external.next_batch()
        self._emitted = True
        tiles, self._tiles = self._tiles, []
        if not tiles:
            self._close_spool()
            return None
        acc = tiles[0] if len(tiles) == 1 else self._merge_down(tiles)
        self._close_spool()  # the spool tiles are dead
        return self.finalize(acc)

    def close(self):
        super().close()
        self._close_spool()


class _Rest:
    """The rest of a spilling operator's partial stream, as a source."""

    def __init__(self, it):
        self._it = it

    def next_batch(self):
        return next(self._it, None)


class SmallGroupAggregateOp(OneInputOperator):
    """Dense-code aggregation for planner-bounded group key spaces: each
    row's dense group code IS its state slot (collision-free), states are
    positionally aligned [G] tensors merged elementwise across tiles — no
    sort, and one host sync per query (the stale-stats overflow check).

    Keys are dictionary codes (lo=0) or integer columns bounded by catalog
    stats (key_lows offsets). Rows outside the planned bounds go to a
    counted overflow; if any did, the spool re-runs through AggregateOp
    (the reference's correctness fallback) rather than mis-grouping."""

    def __init__(self, child: Operator, group_cols: tuple[int, ...],
                 aggs: tuple[agg_ops.AggSpec, ...], key_sizes: tuple[int, ...],
                 key_lows: tuple[int, ...] | None = None):
        super().__init__(child)
        self.group_cols = group_cols
        self.aggs = aggs
        self.key_sizes = key_sizes
        self.key_lows = key_lows or (0,) * len(group_cols)
        base = child.output_schema
        self.base_schema = base
        self.partial_specs, _, self.final_map = agg_ops.partial_layout(
            base, group_cols, aggs)
        self.G, self.strides = agg_ops.dense_layout(key_sizes)
        self.output_schema = agg_ops.agg_output_schema(base, group_cols, aggs)
        self.dictionaries = {
            group_cols.index(gi): d
            for gi, d in child.dictionaries.items() if gi in group_cols
        }
        self.col_stats = {
            group_cols.index(gi): s
            for gi, s in child.col_stats.items() if gi in group_cols
        }
        for pos, (size, lo) in enumerate(zip(self.key_sizes, self.key_lows)):
            self.col_stats.setdefault(pos, (lo, lo + size - 1))

    def init(self):
        super().init()
        self._emitted = False

    def tile_states(self, b: Batch):
        """One tile's dense partial states, row counts and overflow count."""
        code, oob = agg_ops.dense_group_codes(
            b, self.group_cols, self.strides, self.key_sizes, self.key_lows)
        states, rows = agg_ops.dense_scatter_states(
            b, self.base_schema, code, self.G, self.partial_specs)
        return states, rows, (oob & b.mask).sum(dtype=torch.int64)

    def _next(self):
        if self._emitted:
            return None
        self._emitted = True
        acc = None
        while True:
            b = self.child.next_batch()
            if b is None:
                break
            st = self.tile_states(b)
            if acc is None:
                acc = st
            else:
                acc = (agg_ops.merge_dense_states(self.partial_specs,
                                                  acc[0], st[0]),
                       acc[1] + st[1], acc[2] + st[2])
        if acc is None:
            return None
        if self.sync_int(acc[2]) > 0:
            # stale-stats overflow: re-run the input through the general
            # sort-groupby path (correctness over speed)
            fb = AggregateOp(self.child, self.group_cols, self.aggs)
            fb.init()
            return fb._next()
        states, rows, _ = acc
        return agg_ops.dense_finalize(
            self.base_schema, self.group_cols, self.strides, self.key_sizes,
            self.G, self.final_map, states, rows, key_lows=self.key_lows)


class ScalarAggregateOp(OneInputOperator):
    """Aggregation without GROUP BY: each tile reduces to one state per
    aggregate (0-d tensors), folded across tiles; exactly one output row,
    even on empty input (SQL scalar aggregate semantics). No host sync."""

    def __init__(self, child: Operator, aggs: tuple[agg_ops.AggSpec, ...]):
        super().__init__(child)
        self.aggs = aggs
        base = child.output_schema
        self.base_schema = base
        names, types = [], []
        for spec in aggs:
            names.append(spec.name or spec.func)
            types.append(FLOAT64 if spec.func == "avg"
                         else agg_ops.agg_output_type(spec, base))
        self.output_schema = Schema(tuple(names), tuple(types))
        self.dictionaries = {}
        self.col_stats = {}

    def init(self):
        super().init()
        self._emitted = False

    def _next(self):
        if self._emitted:
            return None
        self._emitted = True
        acc = None
        while True:
            b = self.child.next_batch()
            if b is None:
                break
            st = agg_ops.scalar_tile_states(b, self.aggs, self.base_schema)
            acc = st if acc is None else agg_ops.scalar_merge_states(
                self.aggs, acc, st)
        return agg_ops.scalar_result_batch(
            self.aggs, self.base_schema, self.output_schema, acc,
            device=_source_device(self.child))


# ---------------------------------------------------------------------------
# Sort


class SortOp(OneInputOperator):
    """Buffering sorter (NewSorter analog): spool all tiles, one stable
    device sort at the canonical capacity fitting the spool's LIVE rows.
    Past ``sql.distsql.workmem_rows`` spooled rows or the byte account,
    the spooled tiles and the rest of the input go to the external sort
    (flow/external.py)."""

    def __init__(self, child: Operator, keys: tuple[sort_ops.SortKey, ...]):
        super().__init__(child)
        self.output_schema = child.output_schema
        self.keys = keys
        self.rank_tables = {
            k.col: child.dictionaries[k.col].ranks
            for k in keys if k.col in child.dictionaries
        }

    def init(self):
        super().init()
        self._emitted = False
        self._external = None

    def _next(self):
        if self._external is not None:
            return self._external.next_batch()
        if self._emitted:
            return None
        budget = settings.get("sql.distsql.workmem_rows")
        alloc = Allocator("sort spool")
        tiles = []
        total = 0
        while True:
            b = self.child.next_batch()
            if b is None:
                break
            nb = batch_bytes(b)
            tiles.append(b)
            total += b.capacity
            over = alloc.would_exceed(nb)
            # account the tile even past the budget: it is resident
            alloc.reserve(nb, force=over)
            if total > budget or over:
                note_spill("sort")
                self.stats.spilled = True
                alloc.close()
                chain = ChainOp(tiles, self.output_schema,
                                self.child.dictionaries, self.child)
                self._external = ExternalSortOp(chain, self.keys,
                                                budget_rows=budget)
                self._external.init()
                self._external.stats = self.stats
                return self._external.next_batch()
        self._emitted = True
        alloc.close()  # the one-shot device sort consumes the spool
        if not tiles:
            return None
        big = concat(tiles, capacity=_spool_cap(self, tiles))
        return sort_ops.sort_batch(big, self.output_schema, self.keys,
                                   self.rank_tables, self.child.col_stats)


class TopKOp(OneInputOperator):
    """Top-k (sorttopk.go analog): fold a per-tile stable k-selection
    over the input, each step keeping the first k rows of the stable sort
    order at the canonical capacity of k, so ORDER BY ... LIMIT k neither
    spools the input nor sorts more than one tile plus 2k rows at a time.
    The accumulator's live rows come before the new tile's in each merge,
    so among equal keys earlier tiles' rows stay first: the output is the
    sorted top-k tile, bit-identical to SortOp + LimitOp. No host sync."""

    def __init__(self, child: Operator, keys: tuple[sort_ops.SortKey, ...],
                 k: int):
        super().__init__(child)
        self.output_schema = child.output_schema
        self.keys = keys
        self.k = int(k)
        self.rank_tables = {
            key.col: child.dictionaries[key.col].ranks
            for key in keys if key.col in child.dictionaries
        }
        self.acc_cap = _canonical_cap(self.k)

    def init(self):
        super().init()
        self._emitted = False

    def _select(self, b: Batch) -> Batch:
        return sort_ops.topk_batch(b, self.output_schema, self.keys, self.k,
                                   self.acc_cap, self.rank_tables,
                                   self.child.col_stats)

    def _next(self):
        if self._emitted:
            return None
        self._emitted = True
        acc = None
        while True:
            b = self.child.next_batch()
            if b is None:
                return acc
            sel = self._select(b)
            acc = sel if acc is None else self._select(
                concat([acc, sel], capacity=2 * self.acc_cap))


class DistinctOp(OneInputOperator):
    """DISTINCT via grouped aggregation with no aggregates (an inner
    AggregateOp over the child, whose host syncs count here)."""

    def __init__(self, child: Operator, cols: tuple[int, ...] | None = None):
        super().__init__(child)
        self.cols = cols or tuple(range(len(child.output_schema)))
        self.output_schema = child.output_schema.select(self.cols)
        self.dictionaries = {
            self.cols.index(i): d
            for i, d in child.dictionaries.items() if i in self.cols
        }
        self.col_stats = {
            self.cols.index(i): s
            for i, s in child.col_stats.items() if i in self.cols
        }
        self._inner = AggregateOp(child, self.cols, (), mode="complete")

    def init(self):
        super().init()
        self._inner._reset()
        self._inner.stats = self.stats

    def _next(self):
        return self._inner._next()

    def close(self):
        super().close()
        self._inner._close_spool()


# ---------------------------------------------------------------------------
# Join


class HashJoinOp(OneInputOperator):
    """hashJoiner analog: spool and index the build side once, stream
    probe tiles. Unique-build joins and existence joins (semi / anti,
    duplicate build keys included) are probe-aligned and pick their build
    strategy by the reference's rule:

    - ``analytic`` when the build side is a position-preserving chain
      (Scan + Filter/Project) over a table whose first build key is an
      affine function of the row index (Table.dense_key_info);
    - else ``lut`` when the exact packed key fits
      ``sql.distsql.dense_lut_bits`` (an
      existence probe only asks whether a slot is set, so any duplicate
      may win it);
    - else ``sorted`` (sorted exact keys or row hashes + binary search).

    Inner and left joins over duplicate build keys (``general``) index
    the build side sorted and emit every match through
    ``hash_join_general``, whose output tile is the canonical capacity
    of the tile's total (which may exceed the probe tile).

    Each probe-aligned tile's output compacts to the canonical capacity
    of its live rows (one counted host sync per tile; the reference
    learns a sticky capacity instead, to stay sync-free under jit)."""

    def __init__(
        self,
        probe: Operator,
        build: Operator,
        probe_keys: tuple[int, ...],
        build_keys: tuple[int, ...],
        spec: join_ops.JoinSpec,
    ):
        super().__init__(probe)
        if spec.join_type not in ("inner", "left", "semi", "anti"):
            raise ValueError(f"unsupported join type {spec.join_type}")
        self.build = build
        self.probe_keys = probe_keys
        self.build_keys = build_keys
        self.spec = spec
        self.output_schema = join_ops.join_output_schema(
            probe.output_schema, build.output_schema, spec)
        self.dictionaries = dict(probe.dictionaries)
        self.col_stats = dict(probe.col_stats)
        if spec.join_type not in ("semi", "anti"):
            off = len(probe.output_schema)
            for i, d in build.dictionaries.items():
                self.dictionaries[off + i] = d
            for i, s in build.col_stats.items():
                self.col_stats[off + i] = s
        # host-side string-key bridges, per key position: dictionary hash
        # tables (hashed keys) and build codes in the probe's code space
        self.probe_hash_tables = {}
        self.build_hash_tables = {}
        self.build_code_remaps = {}
        for pos, (pk, bk) in enumerate(zip(probe_keys, build_keys)):
            if probe.output_schema.types[pk].family is Family.STRING:
                pd = probe.dictionaries[pk]
                bd = build.dictionaries[bk]
                self.probe_hash_tables[pos] = pd.hashes
                self.build_hash_tables[pos] = bd.hashes
                self.build_code_remaps[pos] = np.array(
                    [pd.code_of(str(v)) for v in bd.values], dtype=np.int32)
        # exact packed keys when every key column is bounded; else hashes
        self.exact_layout = join_ops.plan_exact_key(
            probe.output_schema, probe_keys,
            build.output_schema, build_keys,
            probe.col_stats, build.col_stats,
            {pk: len(probe.dictionaries[pk]) for pk in probe_keys
             if pk in probe.dictionaries},
            have_remaps=True,
        )
        # unique-build and existence probes emit probe-aligned tiles
        self.probe_aligned = (spec.build_unique
                              or spec.join_type in ("semi", "anti"))
        self.strategy = None

    def _plan_analytic(self):
        """Dense analytic build detection: the build side is a position-
        preserving chain (Scan + Filter/Project only) over a table whose
        first build-key column is an affine function of the row index."""
        if not self.probe_aligned:
            return None
        key = self.build_keys[0]
        op = self.build
        while not isinstance(op, ScanOp):
            if isinstance(op, ProjectOp):
                e = op.exprs[key]
                if not isinstance(e, ex.ColRef):
                    return None
                key = e.idx
                op = op.child
            elif isinstance(op, FilterOp):
                op = op.child
            else:
                return None
        table = op.table
        name = table.schema.names[op.col_idxs[key]]
        got = table.dense_key_info().get(name)
        if got is None:
            return None
        lo, fanout = got
        if (self.spec.build_unique and fanout > 1
                and len(self.build_keys) < 2):
            return None  # fanout rows share the first key: not unique by it
        # the analytic build pins the whole table: honor the byte budget
        row_bytes = sum(
            ((t.width or 8) if t.family is Family.BYTES
             else t.dtype.itemsize) + 1
            for t in self.build.output_schema.types
        ) + 1
        if table.num_rows * row_bytes > settings.get(
                "sql.distsql.workmem_bytes"):
            return None
        return join_ops.DenseAnalytic(
            key_lo=lo, fanout=fanout, build_rows=table.num_rows)

    def init(self):
        self.build.init()
        super().init()
        self._built = False
        self._grace = None
        self._close_build()  # a re-run: the prior build is dead
        self._analytic = self._plan_analytic()

    def _close_build(self) -> None:
        if getattr(self, "_build_alloc", None) is not None:
            self._build_alloc.close()
        self._build_alloc = None

    def _sorted_index(self, batch: Batch):
        return join_ops.build_index(
            batch, self.build.output_schema, self.build_keys,
            self.build_hash_tables or None, exact_layout=self.exact_layout,
            exact_remaps=self.build_code_remaps or None)

    def _ensure_built(self):
        if self._built:
            return
        self._built = True
        tiles = []
        if self._analytic is not None:
            while True:
                b = self.build.next_batch()
                if b is None:
                    break
                tiles.append(b)
            # position-preserving concat (NO compaction): row i of the
            # build batch is row i of the table, so key arithmetic
            # addresses it; no live-count sync, no workmem spill
            self.strategy = "analytic"
            if tiles:
                self._build_batch = Batch(
                    cols=tuple(
                        Column(data=torch.cat([t.cols[i].data for t in tiles]),
                               valid=torch.cat([t.cols[i].valid
                                                for t in tiles]))
                        for i in range(len(tiles[0].cols))),
                    mask=torch.cat([t.mask for t in tiles]))
                self._index = None
                return
        else:
            alloc = self._build_alloc = Allocator("hash join build")
            while True:
                b = self.build.next_batch()
                if b is None:
                    break
                nb = batch_bytes(b)
                over = alloc.would_exceed(nb)
                # account the tile even past the budget: it is resident
                alloc.reserve(nb, force=over)
                if over:
                    # the build side exceeds workmem: both sides go to
                    # the Grace hash join
                    note_spill("join")
                    self.stats.spilled = True
                    self._close_build()
                    chain = ChainOp(tiles + [b], self.build.output_schema,
                                    self.build.dictionaries, self.build)
                    self._grace = GraceHashJoinOp(
                        self.child, chain, self.probe_keys, self.build_keys,
                        self.spec)
                    self._grace.init()
                    self._grace.stats = self.stats
                    self.strategy = "grace"
                    return
                tiles.append(b)
        layout = self.exact_layout
        sorted_kind = "sorted" if self.probe_aligned else "general"
        if not tiles:
            self._build_batch = empty_batch(self.build.output_schema, 1024,
                                            _source_device(self.build))
            self._index = self._sorted_index(self._build_batch)
            self.strategy = sorted_kind
            return
        big = concat(tiles, capacity=_spool_cap(self, tiles))
        self._build_batch = big
        if (self.probe_aligned and layout is not None
                and layout.total_bits
                <= settings.get("sql.distsql.dense_lut_bits")):
            self.strategy = "lut"
            self._index = join_ops.build_dense_lut(
                big, self.build_keys, layout, self.build_code_remaps or None)
        else:
            self.strategy = sorted_kind
            self._index = self._sorted_index(big)

    def _probe(self, p: Batch) -> Batch:
        build = self._build_batch
        if self.strategy == "analytic":
            fi, fo = join_ops.dense_analytic_probe(
                p, self.probe_keys, build, self.build_keys, self._analytic,
                self.build_code_remaps or None)
            return join_ops.emit_unique(p, build, self.spec, fi, fo)
        if self.strategy == "lut":
            fi, fo = join_ops.dense_lut_probe(
                p, self.probe_keys, self.exact_layout, self._index)
            return join_ops.emit_unique(p, build, self.spec, fi, fo)
        args = (p, self.child.output_schema, self.probe_keys, build,
                self.build.output_schema, self.build_keys, self.spec)
        kw = dict(probe_hash_tables=self.probe_hash_tables or None,
                  build_hash_tables=self.build_hash_tables or None,
                  build_code_remaps=self.build_code_remaps or None,
                  index=self._index, exact_layout=self.exact_layout,
                  sync=self.sync_int)
        if self.spec.build_unique:
            return join_ops.hash_join_unique(*args, **kw)
        # existence probe over duplicate build keys (probe-aligned), or
        # the general emit, already compacted at the canonical capacity of
        # its total
        out, _ = join_ops.hash_join_general(
            *args, out_capacity=lambda n: _canonical_cap(max(1, n)), **kw)
        return out

    def children(self):
        return [self.child, self.build]

    def _next(self):
        self._ensure_built()
        if self._grace is not None:
            return self._grace._next()
        p = self.child.next_batch()
        if p is None:
            return None
        out = self._probe(p)
        if self.strategy == "general":
            return out
        cap = _canonical_cap(max(1, self.sync_int(out.mask.sum())))
        if cap < out.capacity:
            out = compact(out, cap)
        return out

    def close(self):
        super().close()
        self.build.close()
        self._close_build()
        if self._grace is not None:
            self._grace.close()
