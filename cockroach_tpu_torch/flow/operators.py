"""Flow operators — the colexec operator set over the Operator contract;
the port of the operators of ``cockroach_tpu.flow.operators`` that the
22 TPC-H queries run on one device: ScanOp (resident mode), FilterOp,
ProjectOp, LimitOp, AggregateOp (sort-groupby), SmallGroupAggregateOp
(dense codes), ScalarAggregateOp, SortOp, TopKOp, DistinctOp and
HashJoinOp (unique-build, existence and duplicate-key joins, over exact
packed or hashed keys).

Each operator runs its tile function as eager torch ops per tile (the
reference composes streaming chains into one jitted kernel; the port runs
the unfused tree). Buffering operators size their spools by LIVE row
count, one counted host sync per spool, so downstream work runs at the
smallest canonical capacity that fits the data. Paths the port has not
brought over (streaming scans, spills to external operators, partial-mode
aggregation) raise NotImplementedError naming what waits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..catalog import SHAPE_BUCKETS, Table
from ..coldata.batch import Batch, Column, compact, concat, empty_batch
from ..coldata.types import FLOAT64, Family, Schema
from ..ops import aggregation as agg_ops
from ..ops import expr as ex
from ..ops import join as join_ops
from ..ops import sort as sort_ops
from ..ops.hashing import bucket, hash_columns
from ..utils import settings
from .operator import OneInputOperator, Operator, SourceOperator

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


def batch_bytes(b: Batch) -> int:
    """Device bytes of a batch's columns, bitmaps and mask."""
    n = b.mask.numel()
    for c in b.cols:
        n += c.data.numel() * c.data.element_size() + c.valid.numel()
    return n


# ---------------------------------------------------------------------------
# Scan


class ScanOp(SourceOperator):
    """Resident tile-granular scan (cFetcher analog): the table
    materializes once on the device (catalog.Table.device_batch, padded
    to a multiple of the tile) and bounded tiles slice from it as views."""

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

    def init(self):
        if self.table.num_rows > settings.get("sql.distsql.scan_stream_rows"):
            raise NotImplementedError(
                f"table {self.table.name} ({self.table.num_rows} rows) needs "
                "the streaming scan, which waits for the port's TPC-H SF10 "
                "step (ROADMAP Queue 1)")
        self._batch = self.table.device_batch(self.output_schema.names)
        cap = self._batch.capacity
        tile = self.tile
        if tile is None or tile <= 0 or cap % tile != 0:
            tile = cap  # small tables: one tile
        self._res_tile = min(tile, cap)
        self._offset = 0
        super().init()

    def _next(self):
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


GRACE_PARTS = 8  # the reference's Grace aggregation partition count


class AggregateOp(OneInputOperator):
    """GROUP BY aggregation (hashAggregator analog), complete mode: each
    input tile reduces to a partial-state tile by sort_groupby; the spool
    merges down (concat + sort_groupby over the state layout) when it
    outgrows ``sql.distsql.workmem_rows`` and once at the end, then the
    states finalize.

    When a merge-down still exceeds the budget (the group count itself
    does), the operator turns Grace: the spooled and every later state
    tile split by the group key's row hash (``ops/hashing``) into
    GRACE_PARTS group-disjoint partitions, and each partition merges,
    finalizes and streams out as its own batch — the reference's
    GraceAggregateOp with its partition function, so the output order
    equals the reference's. The partitions stay on the device as masked
    views of the state tiles; staging them on the host (flow/external.py)
    waits for the port's SF10 slice."""

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

    def init(self):
        super().init()
        self._reset()

    def _reset(self):
        self._emitted = False
        self._parts: list[list[Batch]] = []
        self.spilled = False

    def _partial(self, b: Batch) -> Batch:
        # out_capacity == input capacity: groups <= live rows, so this
        # cannot overflow — no host sync per tile
        part, _ = agg_ops.sort_groupby(
            b, self.base_schema, self.group_cols, self.partial_specs,
            out_capacity=b.capacity, col_stats=self.in_stats,
            presorted=self.ordered, compact=not self.prefix_live)
        return part

    def _merge_down(self, tiles: list[Batch]) -> Batch:
        k = self.num_keys
        cap = _spool_cap(self, tiles)
        while True:
            both = concat(tiles, capacity=cap)
            # ordered partials stay in scan order per tile, so their
            # concatenation is still clustered
            merged, ng = agg_ops.sort_groupby(
                both, self.state_schema, tuple(range(k)), self.merge_specs,
                out_capacity=cap, col_stats=self.key_stats,
                presorted=self.ordered, compact=True)
            n = self.sync_int(ng)
            if n <= cap:
                return merged
            cap = _canonical_cap(n)

    def _partitions(self, tiles: list[Batch]) -> list[list[Batch]]:
        """Each state tile as GRACE_PARTS masked views, by the bucket of
        its group key's row hash."""
        k = self.num_keys
        keys = range(k)
        tables = {pos: d.hashes for pos, d in self.dictionaries.items()
                  if pos < k}
        parts: list[list[Batch]] = [[] for _ in range(GRACE_PARTS)]
        for t in tiles:
            h = hash_columns([t.cols[i] for i in keys],
                             [self.state_schema.types[i] for i in keys],
                             tables or None)
            pid = bucket(h, GRACE_PARTS)
            for p in range(GRACE_PARTS):
                parts[p].append(t.with_mask(t.mask & (pid == p)))
        return parts

    def _next(self):
        if self._parts:
            return agg_ops.finalize_states(
                self._merge_down(self._parts.pop(0)), self.final_map,
                self.num_keys)
        if self._emitted:
            return None
        self._emitted = True
        budget = settings.get("sql.distsql.workmem_rows")
        tiles: list[Batch] = []
        spooled = 0
        while True:
            b = self.child.next_batch()
            if b is None:
                break
            part = self._partial(b)
            tiles.append(part)
            spooled += part.capacity
            if spooled > budget and not self.spilled:
                tiles = [self._merge_down(tiles)]
                spooled = tiles[0].capacity
                # the group count itself exceeds the budget: Grace
                self.spilled = spooled > budget
        if not tiles:
            return None
        if self.spilled:
            self._parts = self._partitions(tiles)
            return self._next()
        acc = tiles[0] if len(tiles) == 1 else self._merge_down(tiles)
        return agg_ops.finalize_states(acc, self.final_map, self.num_keys)


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
    device sort at the canonical capacity fitting the spool's LIVE rows."""

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

    def _next(self):
        if self._emitted:
            return None
        self._emitted = True
        budget = settings.get("sql.distsql.workmem_rows")
        tiles = []
        total = 0
        while True:
            b = self.child.next_batch()
            if b is None:
                break
            tiles.append(b)
            total += b.capacity
            if total > budget:
                raise NotImplementedError(
                    "the sort spool exceeds sql.distsql.workmem_rows: the "
                    "external sort " + NOT_PORTED)
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
    - else ``lut`` when the exact packed key fits ``DENSE_LUT_BITS`` (an
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
        self._analytic = self._plan_analytic()

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
        while True:
            b = self.build.next_batch()
            if b is None:
                break
            tiles.append(b)
        if self._analytic is not None:
            # position-preserving concat (NO compaction): row i of the
            # build batch is row i of the table, so key arithmetic
            # addresses it; no live-count sync
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
        if sum(batch_bytes(t) for t in tiles) > settings.get(
                "sql.distsql.workmem_bytes"):
            raise NotImplementedError(
                "the join build side exceeds sql.distsql.workmem_bytes: the "
                "Grace hash join " + NOT_PORTED)
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
                and layout.total_bits <= join_ops.DENSE_LUT_BITS):
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
