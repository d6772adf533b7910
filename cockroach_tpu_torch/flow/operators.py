"""Flow operators — the colexec operator set over the Operator contract;
the port of the one-device operators of ``cockroach_tpu.flow.operators``:
ScanOp (resident and streaming), FilterOp, ProjectOp, LimitOp,
AggregateOp (sort-groupby, string_agg on the host), SmallGroupAggregateOp
(dense codes), ScalarAggregateOp, SortOp, TopKOp, DistinctOp, HashJoinOp
(unique-build, existence and duplicate-key joins, over exact packed or
hashed keys), WindowOp, UnionOp and MergeJoinOp; and the distribution
operators: ScanOp's shards, HashBucketOp, RemoteStreamOp, OrderedSyncOp,
ParallelUnorderedSyncOp and the partial and final aggregation stages.

Two execution paths per operator, as in the reference:

- **Fused streaming segments** (the default): every streaming operator
  exposes ``stream_parts()``, a pure per-tile device function plus its
  device arguments. Buffering consumers (aggregation, sort, join build)
  compose the whole streaming chain beneath them (scan slice -> filter ->
  project -> probe-aligned join probes -> their own per-tile work) into
  ONE function through ``flow/dispatch.jit``: on the card, one CUDA graph
  captured once and replayed per tile. Probe-aligned joins emit at a
  learned, sticky capacity and duplicate-key joins at a speculative one;
  both check their true totals once per query (``post_run_update``), and
  the runtime re-runs the query when a capacity overflowed.
- **Per-operator functions** (``sql.distsql.fusion.enabled`` off, stats
  collection, or a barrier below): the classic pull loop, one function per
  operator per tile.

Buffering operators size their spools by LIVE row count, one counted host
sync per spool, so downstream work runs at the smallest canonical capacity
that fits the data. Past its budget (``sql.distsql.workmem_rows`` or the
``workmem_bytes`` account of ``flow/memory``) a buffering operator swaps
in its external variant (``flow/external.py``): SortOp the external sort,
HashJoinOp the Grace hash join, AggregateOp and DistinctOp the Grace
aggregation; those are barriers. WindowOp and MergeJoinOp's build have
no external variant, as in the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..catalog import SHAPE_BUCKETS, Table
from ..coldata.batch import (Batch, Column, Dictionary, compact, concat,
                             empty_batch)
from ..coldata.types import FLOAT64, Family, Schema
from ..device import resolve_device
from ..ops import aggregation as agg_ops
from ..ops import expr as ex
from ..ops import join as join_ops
from ..ops import sort as sort_ops
from ..utils import settings
from . import dispatch
from .external import (ChainOp, ExternalSortOp, GraceAggregateOp,
                       GraceHashJoinOp)
from .memory import Allocator, batch_bytes, note_spill
from .operator import OneInputOperator, Operator, SourceOperator
from .upload import TileStream


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
    # crlint: allow-mem-accounting(one int64 per spooled tile, bounded by the spool's tile count)
    live = torch.stack([t.mask.sum(dtype=torch.int64) for t in tiles]).sum()
    return _canonical_cap(max(1, op.sync_int(live)))


def _source_device(op: Operator) -> torch.device:
    """The device of the source under an operator chain: its table's, or
    a remote stream's own."""
    while not isinstance(op, SourceOperator):
        op = op.children()[0]
    table = getattr(op, "table", None)
    return table.device if table is not None else op.device


def _identity_fn(b):
    return b


def _runtime_dict(d) -> bool:
    """A string_agg output's dictionary, which fills only at runtime."""
    return getattr(d, "_runtime", False)


def _refuse_runtime_keys(child: Operator, cols, what: str) -> None:
    """Consumers whose plan reads a key's dictionary (ranks, sizes)
    refuse a string_agg output: at plan time its dictionary is empty."""
    for c in cols:
        if _runtime_dict(child.dictionaries.get(c)):
            raise ValueError(f"{what} a string_agg result is not supported "
                             "(its dictionary fills at runtime)")


_slice_parts_fns: dict[int, object] = {}


def _slice_parts_for(res_tile: int):
    """The chain head of a resident scan: one per tile size, shared by
    every resident scan, so consumer compositions stay cached across runs
    and queries."""
    fn = _slice_parts_fns.get(res_tile)
    if fn is None:
        def fn(token):
            b, off = token
            return _slice_tile(res_tile, b, off)

        fn = _slice_parts_fns.setdefault(res_tile, fn)
    return fn


def _slice_tile(tile: int, b: Batch, off: torch.Tensor) -> Batch:
    """Rows [off, off + tile) of a resident batch, `off` a device scalar:
    the slice is a gather inside the composed function, so one graph
    serves every tile of the table."""
    if tile == b.capacity:
        return b
    # crlint: allow-mem-accounting(runs inside the dispatch.jit program that slices a resident tile: a tile-length index lane in its graph pool)
    idx = off + torch.arange(tile, device=off.device)
    return Batch(
        cols=tuple(Column(data=c.data.index_select(0, idx),
                          valid=c.valid.index_select(0, idx))
                   for c in b.cols),
        mask=b.mask.index_select(0, idx))


def _tile_view(tile: int, b: Batch, off: int) -> Batch:
    """Rows [off, off + tile) of a resident batch as views (the unfused
    path: no launch)."""
    end = off + tile
    return Batch(
        cols=tuple(Column(data=c.data[off:end], valid=c.valid[off:end])
                   for c in b.cols),
        mask=b.mask[off:end])


class _FusedPull:
    """Drives a fused streaming chain: one function over (consumer tile fn
    o chain fn), pulled from the chain's source. Cached on the consumer so
    the composition is captured once per operator instance."""

    def __init__(self, parts, tile_fn):
        src, chain_fn, _ = parts
        self.src = src
        self.chain = chain_fn
        self._fn = dispatch.jit(lambda t, *a: tile_fn(chain_fn(t, *a)))

    def pull(self, parts):
        _, _, args = parts
        for t in self.src.stream_tiles():
            yield self._fn(t, *args)


def _fusion_enabled() -> bool:
    # off degrades EVERY fusion path (the plan-build pass of flow/fuse.py
    # and these consumer-driven compositions) to per-operator pulls: the
    # unfused oracle that fused runs are held to
    return settings.get("sql.distsql.fusion.enabled")


def _consume(op: OneInputOperator, tile_fn_name: str, tile_fn,
             fallback_fn=None):
    """Iterate tile_fn over the child's tiles, fused into one function
    with the child's streaming chain when possible; fallback_fn (the
    per-operator version of tile_fn) serves the classic pull path.
    tile_fn_name keys the cached composition on the consumer instance.

    Stats collection forces the per-operator path so every operator's
    batch and row counts stay observable. The tiles yielded are rewritten
    by the next one's call: a spool keeps copies (``_keep``)."""
    parts = (None if (op._collect or not _fusion_enabled())
             else op.child.stream_parts())
    if parts is None:
        fn = fallback_fn if fallback_fn is not None else tile_fn
        while True:
            b = op.child.next_batch()
            if b is None:
                return
            yield fn(b)
        return
    attr = f"_fused_{tile_fn_name}"
    cached = getattr(op, attr, None)
    if cached is None or cached.chain is not parts[1]:
        cached = _FusedPull(parts, tile_fn)
        setattr(op, attr, cached)
    yield from cached.pull(parts)


def _fold(op: OneInputOperator, tag: str, tile_raw, tile_jit, merge_raw,
          merge_jit):
    """Reduce tile_raw over the child's tiles, merging into an accumulator
    with merge_raw. The fused path composes (merge o tile o chain) into
    ONE step function carrying the accumulator in place, so folding
    consumers pay one dispatch per tile. Returns the final accumulator
    (None on empty input)."""
    parts = (None if (op._collect or not _fusion_enabled())
             else op.child.stream_parts())
    if parts is None:
        acc = None
        while True:
            b = op.child.next_batch()
            if b is None:
                return acc
            st = tile_jit(b)
            acc = dispatch.own(st) if acc is None else merge_jit(acc, st)
    src, cfn, args = parts
    attr = f"_fold_{tag}"
    cached = getattr(op, attr, None)
    if cached is None or cached[0] is not cfn:
        nc = len(args)
        seed = dispatch.jit(lambda t, *a: tile_raw(cfn(t, *a[:nc])))
        step = dispatch.jit(
            lambda acc, t, *a: (merge_raw(acc, tile_raw(cfn(t, *a[:nc]))),
                                None),
            carry=True)
        cached = (cfn, seed, step)
        setattr(op, attr, cached)
    _, seed, step = cached
    acc = None
    for t in src.stream_tiles():
        acc = seed(t, *args) if acc is None else step(acc, t, *args)[0]
    return acc


_chain_cache: dict = {}


def _compose_parts(op, child, raw_fn, key=None, extra=()):
    """Chain raw_fn onto the child's fused streaming function (arguments
    pass through; the composition is cached per operator instance). When
    the child's chain and this op both carry structural kernel keys, the
    composed chain is shared process-wide too, so two queries with
    identical fused prefixes share one function and its graphs.
    ``extra`` appends this op's runtime arguments (parameter values)
    after the child's; the chain splits them back out by position, so
    the values stay arguments, read at every call."""
    parts = child.stream_parts()
    if parts is None:
        return None
    src, cfn, cargs = parts
    ckey = getattr(child, "_parts_key", None)
    chain_key = (("chain", ckey, key, len(cargs))
                 if ckey is not None and key is not None else None)
    chain = getattr(op, "_chain_fn", None)
    if chain is None or getattr(op, "_chain_base", None) is not cfn:
        chain = (dispatch.cache_get(_chain_cache, chain_key)
                 if chain_key is not None else None)
        if chain is None:
            nc = len(cargs)

            def chain(t, *a):
                return raw_fn(cfn(t, *a[:nc]), *a[nc:])

            if chain_key is not None:
                try:
                    chain = _chain_cache.setdefault(chain_key, chain)
                except (ValueError, TypeError):
                    pass
        op._chain_fn = chain
        op._chain_base = cfn
    op._parts_key = chain_key
    return src, op._chain_fn, tuple(cargs) + tuple(extra)


def _keep(op: Operator, k: int, b: Batch) -> Batch:
    """Spooled tile k of `op`, copied out of the function that made it into
    buffers that keep their address from run to run (on the card), so the
    graphs of the spool's own functions read the spool by reference."""
    slots = op.__dict__.setdefault("_spool_slots", [])
    while len(slots) <= k:
        slots.append([])
    return dispatch.persist(slots[k], b)


def _consume_op(op: Operator, tag: str):
    """Pull every tile from `op`, fused with its streaming chain when
    possible (build-side spools ride one function, not one per operator).
    Each tile is rewritten by the next one's call."""
    parts = (None if (op._collect or not _fusion_enabled())
             else op.stream_parts())
    if parts is None:
        while True:
            b = op.next_batch()
            if b is None:
                return
            yield b
        return
    src, cfn, args = parts
    attr = f"_fused_src_{tag}"
    cached = getattr(op, attr, None)
    if cached is None or cached[0] is not cfn:
        cached = (cfn, dispatch.jit(cfn))
        setattr(op, attr, cached)
    fn = cached[1]
    for t in src.stream_tiles():
        yield fn(t, *args)


# ---------------------------------------------------------------------------
# Scan


def _wire_source_metadata(op, table, names: tuple[str, ...]) -> None:
    """The plan-static metadata every table source carries (ScanOp and
    IndexScanOp): column indexes, output schema, per-column dictionaries
    and (lo, hi) column stats."""
    idxs = tuple(table.schema.index(n) for n in names)
    op.col_idxs = idxs
    op.output_schema = table.schema.select(idxs)
    full_dicts = table.dict_by_index()
    op.dictionaries = {
        i: full_dicts[ci] for i, ci in enumerate(idxs) if ci in full_dicts
    }
    by_name = table.col_stats()
    op.col_stats = {i: by_name[n] for i, n in enumerate(op.output_schema.names)
                    if n in by_name}


class ScanOp(SourceOperator):
    """Tile-granular scan (cFetcher analog), in one of two modes:

    - resident: the table materializes on the device
      (``device_batch``, padded to a multiple of the tile) and bounded
      tiles slice from it as views. A host table materializes once; a KV
      table (kv/table.KVTable) decodes its merged view anew at every
      scan, straight into buffers the table keeps at one address per
      column (``device_batch(persistent=True)``), so the graphs that read
      the table by reference stay valid across scans and writes; the
      table's host reads (its intent check) count as this scan's syncs;
    - streaming: a table over ``sql.distsql.scan_stream_rows`` never
      occupies the device whole. Its tiles upload host -> device double
      buffered (``flow/upload.TileStream``): the next tile's upload is
      started before the current one is handed on, so the copy overlaps
      the downstream work. The stream tile is the reference's:
      ``_next_pow2(max(4096, min(2^20, rows // 64)))``, or the
      operator's tile if larger. Only tables with host columns stream:
      a KV table decodes whole.

    ``shard=(i, n)`` scans one of n shards (a host's share of a
    cross-host query, flow/disthost.py): live rows of rank
    ``[i*rows//n, (i+1)*rows//n)``, the last shard unbounded above.
    """

    def __init__(self, table: Table, columns: tuple[str, ...] | None = None,
                 tile: int | None = None,
                 shard: tuple[int, int] | None = None):
        super().__init__()
        self.table = table
        self.shard = shard
        _wire_source_metadata(self, table, columns or table.schema.names)
        self.tile = tile
        self._batch = None
        self._offset = 0
        self.streaming = False
        self._stream = None
        self._shared = None
        self._snap = None
        self._persistent = False

    def init(self):
        self.streaming = (
            hasattr(self.table, "columns")  # KV-backed tables decode whole
            and self.table.num_rows
            > settings.get("sql.distsql.scan_stream_rows"))
        table_syncs = getattr(self.table, "host_syncs", 0)
        if self.streaming:
            self._init_streaming()
        else:
            self._init_resident()
            # concurrent scans of the same resident table share one tile
            # stream (flow/sharedscan.py): attach returns None for solo
            if self._res_tile < self._batch.capacity:
                from . import sharedscan

                if self._shared is not None:  # re-init (capacity retry)
                    sharedscan.detach(self, self._shared)
                self._shared = sharedscan.attach(self)
        self._offset = 0
        super().init()
        self.stats.host_syncs += (getattr(self.table, "host_syncs", 0)
                                  - table_syncs)

    def close(self):
        if self._shared is not None:
            from . import sharedscan

            sharedscan.detach(self, self._shared)
            self._shared = None
        super().close()

    def _shard_bounds(self) -> tuple[int, int | None] | None:
        """Rank range [lo, hi) of this shard; the last shard is unbounded
        above (hi None): num_rows counts the newest visible rows now, and
        the scan's snapshot may hold more (an older snapshot, a txn's own
        inserts), which must still land in some shard."""
        if self.shard is None:
            return None
        i, n = self.shard
        rows = self.table.num_rows
        return (i * rows // n,
                None if i == n - 1 else (i + 1) * rows // n)

    def _init_resident(self):
        names = self.output_schema.names
        self._persistent = not hasattr(self.table, "columns")
        if self._persistent:
            b = self.table.device_batch(names, persistent=True)
            # the snapshot the table's buffers now hold (sharedscan's
            # attach compares it; identity proves nothing here)
            self._snap = self.table.decoded_snap
        else:
            b = self.table.device_batch(names)
        # the batch stays at its address: graphs read it by reference
        dispatch.mark_static(b)
        bounds = self._shard_bounds()
        if bounds is not None:
            # shard by live-row rank, not position: a KV table's live rows
            # sit at scattered positions of its merged view (a host
            # table's are a prefix, where rank is position). The new mask
            # is not marked static: graphs copy it in at each call.
            lo, hi = bounds
            rank = torch.cumsum(b.mask.to(torch.int64), 0) - 1
            keep = b.mask & (rank >= lo)
            if hi is not None:
                keep = keep & (rank < hi)
            b = b.with_mask(keep)
        self._batch = b
        cap = self._batch.capacity
        tile = self.tile
        if tile is None or tile <= 0 or cap % tile != 0:
            tile = cap  # small tables: one tile
        self._res_tile = min(tile, cap)
        dev = self._batch.device
        if getattr(self, "_offs_for", None) != (cap, self._res_tile, dev):
            # every tile's offset as a device scalar (the fused slice's
            # argument), made once
            self._offs = torch.arange(0, cap, self._res_tile, device=dev)
            self._offs_for = (cap, self._res_tile, dev)
        self._slice = functools.partial(_tile_view, self._res_tile)

    # crlint: allow-host-sync(catalog columns are host-resident numpy)
    def _init_streaming(self):
        t = self.table
        nrows = t.num_rows
        lo, hi = self._shard_bounds() or (0, None)
        hi = nrows if hi is None else hi
        nrows = hi - lo
        # big tiles amortize launches; about 64 tiles per table keeps the
        # pipeline busy at any scale
        auto = _next_pow2(max(1 << 12, min(1 << 20, nrows // 64)))
        tile = max(self.tile or 0, auto)
        if self._stream is None or self._stream.tile != tile:
            names = self.output_schema.names
            self._stream = TileStream(
                self.output_schema,
                {n: np.asarray(t.columns[n])[lo:hi] for n in names},
                {n: np.asarray(t.valids[n])[lo:hi]
                 for n in names if n in t.valids},
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

    def stream_parts(self):
        if not self._initialized:
            self.init()
        if self.streaming:
            self._parts_key = ("scan_stream",)
            return self, _identity_fn, ()
        self._parts_key = ("scan_slice", self._res_tile)
        return self, _slice_parts_for(self._res_tile), ()

    def stream_tiles(self):
        """Raw tiles for the fused path, from the start of the table:
        uploaded batches when streaming, else (resident batch, offset)
        tokens. The scan position advances as tiles go out, so a consumer
        that stops part way and falls back to next_batch() (SortOp's spill
        handoff) resumes after the tiles already delivered."""
        self._offset = 0
        if self.streaming:
            self._prefetched = None
            while True:
                t = self._next_streaming()
                if t is None:
                    return
                yield t
            return
        cap = self._batch.capacity
        while self._offset < cap:
            k = self._offset // self._res_tile
            self._offset += self._res_tile
            yield (self._batch, self._offs[k])

    def _next(self):
        if self.streaming:
            return self._next_streaming()
        b = self._batch
        off = self._offset
        if off >= b.capacity:
            return None
        if self._res_tile == b.capacity:
            self._offset += self._res_tile
            return b
        if self._shared is not None:
            kind, t = self._shared.next_tile(self, off // self._res_tile)
            if kind == "tile":
                self._offset += self._res_tile
                return t
            # window trimmed past us, or the stream went stale: slice
            # this tile solo (catch-up)
        self._offset += self._res_tile
        return self._slice(b, off)


class IndexScanOp(SourceOperator):
    """Index-backed read (plan/spec.IndexScan): resolve the matching
    primary keys from the secondary-index keyspace, then fetch the rows in
    one Streamer pass (joinreader + kvstreamer roles). The batch's
    capacity is sized by the match count, not the table."""

    def __init__(self, table, index_name: str, lo: int | None,
                 hi: int | None, columns: tuple[str, ...] | None = None):
        super().__init__()
        self.table = table
        self.ix = next(i for i in table.indexes if i.name == index_name)
        self.lo, self.hi = lo, hi
        self.names = tuple(columns or table.schema.names)
        _wire_source_metadata(self, table, self.names)
        self._batch = None

    def init(self):
        from ..kv import index as ixm

        pks = ixm.scan_pks(self.table, self.ix, self.lo, self.hi)
        self._batch = ixm.Streamer(self.table).fetch(pks, self.names)
        super().init()

    def _next(self):
        b, self._batch = self._batch, None
        return b


# ---------------------------------------------------------------------------
# Streaming ops


class HashBucketOp(OneInputOperator):
    """One outgoing stream of a HashRouter (colflow/routers.go:420): mask
    away the rows whose key-hash bucket is not `part` of `n_parts`. A
    producer runs one HashBucketOp per consumer over the same scan;
    together they partition the input exactly (the join and aggregation
    hash, so co-partitioned sides land on the same peer)."""

    def __init__(self, child: Operator, keys: tuple[int, ...],
                 n_parts: int, part: int):
        from ..ops import hashing

        super().__init__(child)
        self.output_schema = child.output_schema
        schema = child.output_schema
        for k in keys:
            if schema.types[k].family is Family.STRING:
                raise TypeError(
                    "cross-host repartition on STRING keys is not "
                    "supported (dictionary codes are per-process)")
        types = [schema.types[k] for k in keys]

        def raw(b: Batch) -> Batch:
            h = hashing.hash_columns([b.cols[k] for k in keys], types)
            return b.with_mask(
                b.mask & (hashing.bucket(h, n_parts) == part))

        self._key = dispatch.kernel_key(
            "hashbucket", schema, tuple(keys), n_parts, part)
        self._raw = raw
        self._fn = dispatch.jit(raw, key=self._key)

    def stream_parts(self):
        return _compose_parts(self, self.child, self._raw, key=self._key)

    def _next(self):
        b = self.child.next_batch()
        return None if b is None else self._fn(b)


class RemoteStreamOp(SourceOperator):
    """Leaf that attaches to a peer host's registered flow stream at init
    and pulls its batches onto ``device`` — the Inbox half of a
    host-to-host stream (colrpc/inbox.go:48; plan/spec.RemoteStream)."""

    def __init__(self, addr, flow_id: str, stream_id: int, schema,
                 device="cuda"):
        from .dcn import runtime_dictionaries

        super().__init__()
        self.addr = tuple(addr)
        self.flow_id = flow_id
        self.stream_id = stream_id
        self.output_schema = schema
        self.device = resolve_device(device)
        # STRING columns' dictionaries ride the stream's batches: parents
        # hold these objects, which fill in place at the first batch
        self.dictionaries = runtime_dictionaries(schema)
        self._inbox = None

    def init(self):
        from .disthost import attach_stream

        self._inbox = attach_stream(self.addr, self.flow_id,
                                    self.stream_id, self.output_schema,
                                    dictionaries=self.dictionaries,
                                    device=self.device)
        super().init()

    def _next(self):
        return self._inbox.next_batch()

    def close(self):
        if self._inbox is not None:
            self._inbox.close()


class FilterOp(OneInputOperator):
    """Predicate mask. With ``params`` (a plancache.ParamStore), the
    predicate's ex.Param leaves read their values from arguments of the
    function (0-d tensors, copied into a graph's input buffers at every
    replay) instead of constants, so a cached plan rebinds literals with
    no new capture (the prepared-plan fast path)."""

    def __init__(self, child: Operator, predicate: ex.Expr, params=None):
        super().__init__(child)
        self.output_schema = child.output_schema
        schema = child.output_schema
        self.predicate = predicate
        self._params = params
        if params is None:
            def raw(b: Batch) -> Batch:
                return b.with_mask(ex.filter_mask(b, schema, predicate))
        else:
            def raw(b: Batch, *pv) -> Batch:
                with ex.param_scope(pv):
                    return b.with_mask(ex.filter_mask(b, schema, predicate))

        self._key = dispatch.kernel_key(
            "filter", schema, predicate, params is not None)
        self._raw = raw
        self._fn = dispatch.jit(raw, key=self._key)

    def stream_parts(self):
        extra = () if self._params is None else self._params.args()
        return _compose_parts(self, self.child, self._raw, key=self._key,
                              extra=extra)

    def _next(self):
        b = self.child.next_batch()
        if b is None:
            return None
        if self._params is None:
            return self._fn(b)
        return self._fn(b, *self._params.args())


class ProjectOp(OneInputOperator):
    """Computed columns. With ``params`` (a plancache.ParamStore), ex.Param
    leaves read their values from function arguments, as in FilterOp (a
    DML statement's SET literals, sql/session.py)."""

    def __init__(self, child: Operator, exprs: tuple[ex.Expr, ...],
                 names: tuple[str, ...], dict_overrides: tuple = (),
                 params=None):
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

        def project(b: Batch) -> Batch:
            cols = []
            for e in exprs:
                d, v = ex.eval_expr(e, b.cols, schema)
                cols.append(Column(data=d, valid=v))
            return Batch(cols=tuple(cols), mask=b.mask)

        self._params = params
        if params is None:
            raw = project
        else:
            def raw(b: Batch, *pv) -> Batch:
                with ex.param_scope(pv):
                    return project(b)

        self._key = dispatch.kernel_key("project", schema, exprs,
                                        params is not None)
        self._raw = raw
        self._fn = dispatch.jit(raw, key=self._key)

    def stream_parts(self):
        extra = () if self._params is None else self._params.args()
        return _compose_parts(self, self.child, self._raw, key=self._key,
                              extra=extra)

    def _next(self):
        b = self.child.next_batch()
        if b is None:
            return None
        if self._params is None:
            return self._fn(b)
        return self._fn(b, *self._params.args())


class LimitOp(OneInputOperator):
    def __init__(self, child: Operator, limit: int, offset: int = 0):
        super().__init__(child)
        self.output_schema = child.output_schema
        self.limit = limit
        self.offset = offset

        def fn(b: Batch, seen):
            pos = seen + torch.cumsum(b.mask.to(torch.int64), 0) - 1
            keep = (b.mask & (pos >= offset) & (pos < offset + limit))
            return b.with_mask(keep), seen + b.mask.sum(dtype=torch.int64)

        self._fn = dispatch.jit(
            fn, key=dispatch.kernel_key("limit", offset, limit))

    def init(self):
        super().init()
        self._seen = None
        self._done = False

    def _next(self):
        if self._done:
            return None
        b = self.child.next_batch()
        if b is None:
            return None
        if self._seen is None:
            self._seen = torch.zeros((), dtype=torch.int64, device=b.device)
        out, self._seen = self._fn(b, self._seen)
        if self.sync_int(self._seen) >= self.offset + self.limit:
            self._done = True
        return out


# ---------------------------------------------------------------------------
# Aggregation


class AggregateOp(OneInputOperator):
    """GROUP BY aggregation (hashAggregator analog). Each input tile
    reduces to a partial-state tile by sort_groupby; the spool merges down
    (concat + sort_groupby over the state layout) when it outgrows
    ``sql.distsql.workmem_rows`` or its byte account, and once at the end,
    then the states finalize. ``mode``, as CRDB's local and final stages
    around a shuffle:

    - complete: input rows -> final results;
    - partial: input rows -> state columns (a remote fragment's output);
    - final: state columns in the partial layout (of ``input_schema``,
      the schema the aggregates were written over) -> final results.

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
        input_schema: Schema | None = None,
    ):
        super().__init__(child)
        if mode not in ("complete", "partial", "final"):
            raise ValueError(f"aggregation mode {mode!r}")
        self.mode = mode
        self.group_cols = group_cols
        self.aggs = aggs
        # string_agg runs OUTSIDE the device state pipeline, as in the
        # reference: per-row (group key, string) pairs are collected on
        # the host during the spool and joined at finalize (a variable-
        # width concatenation has no fixed-tile device form). The device
        # pipeline runs a count in its slot; _attach_saggs overwrites it.
        self._sagg = [(j, a) for j, a in enumerate(aggs)
                      if a.func == "string_agg"]
        if self._sagg:
            if mode != "complete":
                raise ValueError(
                    "string_agg runs in complete mode only (distributed "
                    "plans run it locally)")
            aggs = tuple(agg_ops.AggSpec("count", a.col, a.name)
                         if a.func == "string_agg" else a for a in aggs)
        # ordered: equal group keys arrive adjacent (clustered scan); the
        # per-tile grouping skips its key sort. prefix_live: tiles are
        # live-prefix too, dropping the dead-row compaction sort.
        self.ordered = ordered
        self.prefix_live = prefix_live
        base = input_schema if input_schema is not None \
            else child.output_schema
        self.base_schema = base
        self.partial_specs, self.state_schema, self.final_map = (
            agg_ops.partial_layout(base, group_cols, aggs))
        k = len(group_cols)
        self.num_keys = k
        self.merge_specs = agg_ops.merge_specs_for(self.partial_specs, k)
        self.output_schema = (
            self.state_schema if mode == "partial" else
            agg_ops.agg_output_schema(
                base, group_cols, self.aggs,
                "final" if mode == "final" else "complete"))
        if mode == "final":
            # the child emits the state layout: its keys are 0..k-1
            self.dictionaries = {i: d for i, d in child.dictionaries.items()
                                 if i < k}
            self.key_stats = {i: s for i, s in child.col_stats.items()
                              if i < k}
        else:
            self.dictionaries = {
                group_cols.index(gi): d
                for gi, d in child.dictionaries.items() if gi in group_cols
            }
            _refuse_runtime_keys(child, group_cols, "grouping by")
            self.key_stats = {
                group_cols.index(gi): s
                for gi, s in child.col_stats.items() if gi in group_cols
            }
        # STRING group keys without numeric stats still pack tight: the
        # dictionary size bounds the code range
        for pos, d in self.dictionaries.items():
            self.key_stats.setdefault(pos, (0, max(0, len(d) - 1)))
        self.col_stats = dict(self.key_stats)
        # string_agg outputs get an empty Dictionary now (parents copy the
        # reference at construction) that fills in place at finalize
        for j, _ in self._sagg:
            d = Dictionary(np.array([], dtype=object))
            d._runtime = True
            self.dictionaries[k + j] = d
        self.in_stats = {
            gi: s for gi, s in child.col_stats.items() if gi in group_cols
        } if mode != "final" else {}
        for gi in group_cols if mode != "final" else ():
            if gi in child.dictionaries:
                self.in_stats.setdefault(
                    gi, (0, max(0, len(child.dictionaries[gi]) - 1)))
        self._spool_alloc = None
        self._partial_fn = dispatch.jit(self._partial)
        self._merge_fn = dispatch.jit(self.merge)
        self._finalize_fn = dispatch.jit(self.finalize)

    def init(self):
        super().init()
        self._reset()

    def _reset(self):
        self._emitted = False
        self._tiles: list[Batch] = []
        self._external = None
        self._close_spool()  # a re-run: the prior account is dead
        self._sagg_rows = {j: {} for j, _ in self._sagg}

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
            merged, ng = self._merge_fn(tuple(tiles), cap)
            n = self.sync_int(ng)
            if n <= cap:
                return merged
            cap = _canonical_cap(n)

    def _spool(self):
        """Spool per-tile partial states; merge down only when the spool
        exceeds workmem (rows, or the byte account); spill to the Grace
        aggregation when a merge-down stays over."""
        budget = settings.get("sql.distsql.workmem_rows")
        alloc = self._spool_alloc = Allocator("aggregation spool", self.stats)

        if self._sagg:
            # a plain pull: every input tile hands its (group key,
            # string) pairs to the host before its device partial
            source = self._sagg_source()
        elif self.mode == "final":
            # state tiles arrive in the partial layout already
            source = _consume(self, "final", _identity_fn)
        else:
            source = _consume(self, "partial", self._partial,
                              self._partial_fn)
        spooled = 0
        for part in source:
            part = _keep(self, len(self._tiles), part)
            self._tiles.append(part)
            spooled += part.capacity
            nb = batch_bytes(part)
            over = alloc.would_exceed(nb)
            # the tile is resident whether or not the budget likes it:
            # account it truthfully (forcing past the refusal)
            alloc.reserve(nb, force=over)
            if spooled > budget or over:
                self._tiles = [dispatch.own(self._merge_down(self._tiles))]
                spooled = self._tiles[0].capacity
                alloc.release()
                mb = batch_bytes(self._tiles[0])
                over = alloc.would_exceed(mb)
                alloc.reserve(mb, force=over)
                if (spooled > budget or over) and not self._sagg:
                    # the group count itself exceeds memory: hand the
                    # spooled states and the rest of the partial stream
                    # to the Grace aggregation (string_agg's host state
                    # cannot spill: it stays over budget, accounted)
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
        # one tile is fully grouped unless it came from a final-mode
        # child (exchanged state rows may repeat group keys)
        acc = (tiles[0] if len(tiles) == 1 and self.mode != "final"
               else self._merge_down(tiles))
        self._close_spool()  # the spool tiles are dead
        if self.mode == "partial":
            return acc
        out = self._finalize_fn(acc)
        if self._sagg:
            out = self._attach_saggs(out)
        return out

    # -- string_agg host path ------------------------------------------------

    def _sagg_source(self):
        while True:
            b = self.child.next_batch()
            if b is None:
                return
            self._collect_sagg(b)
            yield self._partial_fn(b)

    # crlint: allow-host-sync(string_agg host path: hashable python keys, one counted host read of the tile)
    def _host_rows(self, b: Batch, cols) -> tuple[np.ndarray, list]:
        """(live row indices, hashable per-row keys over `cols`, None for
        a NULL): one counted host read of the tile."""
        self.stats.host_syncs += 1
        idx = np.flatnonzero(b.mask.cpu().numpy())
        parts = []
        for c in cols:
            data = b.cols[c].data.cpu().numpy()[idx]
            valid = b.cols[c].valid.cpu().numpy()[idx]
            parts.append([None if not ok else data[i].item()
                          for i, ok in enumerate(valid)])
        keys = list(zip(*parts)) if parts else [()] * len(idx)
        return idx, keys

    # crlint: allow-host-sync(string_agg host path: object-dtype strings cannot live on device)
    def _collect_sagg(self, b: Batch) -> None:
        """Append each live row's string to its group's list, in row
        order."""
        idx, keys = self._host_rows(b, self.group_cols)
        if not len(idx):
            return
        for j, spec in self._sagg:
            col = b.cols[spec.col]
            data = col.data.cpu().numpy()[idx]
            valid = col.valid.cpu().numpy()[idx]
            d = self.child.dictionaries.get(spec.col)
            store = self._sagg_rows[j]
            for key, code, ok in zip(keys, data, valid):
                if ok:
                    v = str(d.values[int(code)]) if d is not None \
                        else str(code)
                    store.setdefault(key, []).append(v)

    def _attach_saggs(self, final: Batch) -> Batch:
        """Overwrite each string_agg placeholder column with codes into
        its runtime Dictionary of per-group concatenations."""
        k = self.num_keys
        idx, keys = self._host_rows(final, range(k))
        cols = list(final.cols)
        for j, spec in self._sagg:
            store = self._sagg_rows[j]
            joined = [spec.sep.join(store[key]) if store.get(key) else None
                      for key in keys]
            uniq = sorted({v for v in joined if v is not None})
            # crlint: allow-host-sync(string_agg host path: runs once at finalize)
            self.dictionaries[k + j].reset(np.array(uniq, dtype=object))
            code_of = {v: c for c, v in enumerate(uniq)}
            codes = np.zeros(final.capacity, np.int32)
            valid = np.zeros(final.capacity, bool)
            for row, v in zip(idx, joined):
                if v is not None:
                    codes[row] = code_of[v]
                    valid[row] = True
            dev = final.device
            cols[k + j] = Column(
                data=torch.from_numpy(codes).to(dev),
                valid=torch.from_numpy(valid).to(dev) & final.mask)
        return Batch(cols=tuple(cols), mask=final.mask)

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
        self._tile_fn = dispatch.jit(self.tile_states)
        self._merge_fn = dispatch.jit(self.merge_states)
        self._finalize_fn = dispatch.jit(self.finalize)

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

    def merge_states(self, acc, new):
        return (agg_ops.merge_dense_states(self.partial_specs, acc[0], new[0]),
                acc[1] + new[1], acc[2] + new[2])

    def finalize(self, acc) -> Batch:
        states, rows, _ = acc
        return agg_ops.dense_finalize(
            self.base_schema, self.group_cols, self.strides, self.key_sizes,
            self.G, self.final_map, states, rows, key_lows=self.key_lows)

    def _next(self):
        if self._emitted:
            return None
        self._emitted = True
        acc = _fold(self, "dense", self.tile_states, self._tile_fn,
                    self.merge_states, self._merge_fn)
        if acc is None:
            return None
        if self.sync_int(acc[2]) > 0:
            # stale-stats overflow: re-run the input through the general
            # sort-groupby path (correctness over speed)
            fb = AggregateOp(self.child, self.group_cols, self.aggs)
            fb.init()
            return fb._next()
        return self._finalize_fn(acc)


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
        self._tile_raw = lambda b: agg_ops.scalar_tile_states(b, aggs, base)
        self._tile_fn = dispatch.jit(self._tile_raw)
        self._merge_raw = (
            lambda acc, new: agg_ops.scalar_merge_states(aggs, acc, new))
        self._merge_fn = dispatch.jit(self._merge_raw)

    def init(self):
        super().init()
        self._emitted = False

    def _next(self):
        if self._emitted:
            return None
        self._emitted = True
        acc = _fold(self, "scalar", self._tile_raw, self._tile_fn,
                    self._merge_raw, self._merge_fn)
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
        _refuse_runtime_keys(child, [k.col for k in keys], "ORDER BY")
        self.rank_tables = {
            k.col: child.dictionaries[k.col].ranks
            for k in keys if k.col in child.dictionaries
        }
        self._fn = dispatch.jit(self._sort)

    def _sort(self, tiles, cap: int) -> Batch:
        big = concat(list(tiles), capacity=cap)
        return sort_ops.sort_batch(big, self.output_schema, self.keys,
                                   self.rank_tables, self.child.col_stats)

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
        alloc = Allocator("sort spool", self.stats)
        tiles = []
        total = 0
        for b in _consume(self, "spool", _identity_fn):
            b = _keep(self, len(tiles), b)
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
        return self._fn(tuple(tiles), _spool_cap(self, tiles))


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
        _refuse_runtime_keys(child, [key.col for key in keys], "ORDER BY")
        self.rank_tables = {
            key.col: child.dictionaries[key.col].ranks
            for key in keys if key.col in child.dictionaries
        }
        self.acc_cap = _canonical_cap(self.k)
        self._tile_fn = dispatch.jit(self._select)
        self._merge_fn = dispatch.jit(self._merge)

    def init(self):
        super().init()
        self._emitted = False

    def _select(self, b: Batch) -> Batch:
        return sort_ops.topk_batch(b, self.output_schema, self.keys, self.k,
                                   self.acc_cap, self.rank_tables,
                                   self.child.col_stats)

    def _merge(self, acc: Batch, new: Batch) -> Batch:
        # concat compacts acc's live rows BEFORE new's, so the stable
        # re-selection keeps earlier tiles' rows first among equal keys
        return self._select(concat([acc, new], capacity=2 * self.acc_cap))

    def _next(self):
        if self._emitted:
            return None
        self._emitted = True
        return _fold(self, "topk", self._select, self._tile_fn, self._merge,
                     self._merge_fn)


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
    ``hash_join_general``.

    Emission, as in the reference (sticky across runs of one tree):

    - ``learn`` (probe-aligned joins, first run): the probe output keeps
      the probe tile's capacity, and its largest live count is carried on
      the device, read once at query end (``post_run_update``);
    - ``compact``: each probe tile's output compacts to the learned
      capacity; an overflow (rows lost) is caught at query end and the
      runtime re-runs the query with a corrected capacity;
    - ``transparent``: the probe composes into the consumer's function;
    - ``general`` (duplicate-key inner/left): the probe emits at a
      speculative static capacity and carries the largest true total, so
      overflow is caught at query end with no host sync per tile.

    Probes over hashed keys (no exact packed key, no analytic build) read
    their longest run of equal hashes on the host, so they cannot be
    captured: they run per operator as barriers, counted eagerly."""

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
                if _runtime_dict(pd) or _runtime_dict(bd):
                    # its hashes fill at the child's finalize: captured
                    # here they are empty and every probe misses
                    raise ValueError(
                        "joining on a string_agg result is not supported "
                        "(its dictionary fills at runtime)")
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
        self._fusable = self.probe_aligned
        self._gen_fusable = (
            not self._fusable and spec.join_type in ("inner", "left")
            and settings.get("sql.distsql.fusion.general_probe"))
        self._emit_mode = (
            "learn" if (self._fusable
                        and settings.get("sql.distsql.join_compact_emit"))
            else ("general" if self._gen_fusable else "transparent"))
        self._emit_cap = None
        self._emit_tilecap = 0
        self._emit_tiles = 0  # tiles emitted this run
        self._emit_max = None  # their largest count, on the device
        self._out_cap = 0  # the per-operator general path's capacity
        self.strategy = None
        self._grace = None
        self._probe_raw = None

        pschema, bschema = probe.output_schema, build.output_schema

        def probe_gen_raw(p, build_b, index, out_cap):
            return join_ops.hash_join_general(
                p, pschema, probe_keys, build_b, bschema, build_keys, spec,
                out_cap, self.probe_hash_tables or None,
                self.build_hash_tables or None,
                self.build_code_remaps or None, index=index,
                exact_layout=self.exact_layout, sync=self.sync_int)

        self._probe_gen_raw = probe_gen_raw
        self._probe_gen_fn = None
        self._probe_gen_capt = None

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
        dense_fn = getattr(table, "dense_key_info", None)
        if not callable(dense_fn):
            return None  # a KV table: rows sit at merged-view positions
        got = dense_fn().get(table.schema.names[op.col_idxs[key]])
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
        # every probe kernel is free of host reads unless keys are hashed
        self._capturable = (self.exact_layout is not None
                            or self._analytic is not None)
        if (self._probe_gen_fn is None
                or self._probe_gen_capt is not self._capturable):
            self._probe_gen_fn = (
                dispatch.jit(self._probe_gen_raw) if self._capturable
                else dispatch.counted(self._probe_gen_raw))
            self._probe_gen_capt = self._capturable
        self._emit_tiles = 0
        self._emit_max = None

    def _close_build(self) -> None:
        if getattr(self, "_build_alloc", None) is not None:
            self._build_alloc.close()
        self._build_alloc = None

    def _set_probe(self, kind: str):
        """Install the probe function of the build strategy. All share the
        (probe, build batch, index) calling convention, so fusion and the
        pull path stay uniform. Cached per kind: a fresh closure per run
        would invalidate every composition keyed on its identity."""
        self.strategy = kind
        if getattr(self, "_probe_kind", None) == kind and (
                kind != "analytic" or self._probe_analytic == self._analytic):
            return
        self._probe_kind = kind
        self._probe_analytic = self._analytic if kind == "analytic" else None
        pschema = self.child.output_schema
        bschema = self.build.output_schema
        pkeys, bkeys = self.probe_keys, self.build_keys
        pht = self.probe_hash_tables or None
        bht = self.build_hash_tables or None
        remaps = self.build_code_remaps or None
        layout = self.exact_layout
        spec = self.spec
        sync = self.sync_int

        if kind == "analytic":
            info = self._analytic

            def probe_raw(p, build, index):
                fi, fo = join_ops.dense_analytic_probe(
                    p, pkeys, build, bkeys, info, remaps)
                return join_ops.emit_unique(p, build, spec, fi, fo)
        elif kind == "lut":

            def probe_raw(p, build, index):
                fi, fo = join_ops.dense_lut_probe(p, pkeys, layout, index)
                return join_ops.emit_unique(p, build, spec, fi, fo)
        elif spec.build_unique:

            def probe_raw(p, build, index):
                return join_ops.hash_join_unique(
                    p, pschema, pkeys, build, bschema, bkeys, spec,
                    pht, bht, remaps, index=index, exact_layout=layout,
                    sync=sync)
        else:  # sorted-index existence probe over duplicate build keys

            def probe_raw(p, build, index):
                out, _ = join_ops.hash_join_general(
                    p, pschema, pkeys, build, bschema, bkeys, spec,
                    out_capacity=1, probe_hash_tables=pht,
                    build_hash_tables=bht, build_code_remaps=remaps,
                    index=index, exact_layout=layout, sync=sync)
                return out

        self._probe_raw = probe_raw
        self._probe_fn = (dispatch.jit(probe_raw) if self._capturable
                          else dispatch.counted(probe_raw))

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
        dense_fn = getattr(table, "dense_key_info", None)
        if not callable(dense_fn):
            return None  # a KV table: rows sit at merged-view positions
        got = dense_fn().get(table.schema.names[op.col_idxs[key]])
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

    def _build_sorted(self, tiles, cap: int):
        big = concat(list(tiles), capacity=cap)
        return big, join_ops.build_index(
            big, self.build.output_schema, self.build_keys,
            self.build_hash_tables or None, exact_layout=self.exact_layout,
            exact_remaps=self.build_code_remaps or None)

    def _build_lut(self, tiles, cap: int):
        big = concat(list(tiles), capacity=cap)
        return big, join_ops.build_dense_lut(
            big, self.build_keys, self.exact_layout,
            self.build_code_remaps or None)

    def _ensure_built(self):
        if self._built:
            return
        self._built = True
        if not hasattr(self, "_build_fn"):
            self._build_fn = dispatch.jit(self._build_sorted)
            self._lut_fn = dispatch.jit(self._build_lut)
            self._store: list = []
        tiles = []
        if self._analytic is not None:
            tiles = [_keep(self, k, b) for k, b in
                     enumerate(_consume_op(self.build, "build_spool"))]
            if tiles:
                # position-preserving concat (NO compaction): row i of the
                # build batch is row i of the table, so key arithmetic
                # addresses it; no live-count sync, no workmem spill
                big = tiles[0] if len(tiles) == 1 else Batch(
                    cols=tuple(
                        Column(data=torch.cat([t.cols[i].data
                                               for t in tiles]),
                               valid=torch.cat([t.cols[i].valid
                                                for t in tiles]))
                        for i in range(len(tiles[0].cols))),
                    mask=torch.cat([t.mask for t in tiles]))
                self._build_batch = dispatch.persist(self._store, big)
                self._index = ()
                self._set_probe("analytic")
                return
        else:
            alloc = self._build_alloc = Allocator("hash join build", self.stats)
            for b in _consume_op(self.build, "build_spool"):
                b = _keep(self, len(tiles), b)
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
        kind = "sorted" if self.probe_aligned else "general"
        if not tiles:
            empty = empty_batch(self.build.output_schema, 1024,
                                _source_device(self.build))
            self._build_batch, self._index = dispatch.persist(
                self._store, (empty, self._build_sorted((empty,), 1024)[1]))
        else:
            if (self.probe_aligned and layout is not None
                    and layout.total_bits
                    <= settings.get("sql.distsql.dense_lut_bits")):
                kind = "lut"
                built = self._lut_fn(tuple(tiles), _spool_cap(self, tiles))
            else:
                built = self._build_fn(tuple(tiles), _spool_cap(self, tiles))
            # a graph's outputs keep their address across runs: the probe
            # graphs read the build by reference
            self._build_batch, self._index = built
        if self.probe_aligned:
            self._set_probe(kind)
        else:
            self.strategy = kind

    def children(self):
        return [self.child, self.build]

    def fused_depth(self) -> int:
        """Join probes sharing ONE composed function below (and including)
        this join. The count stops where composition splits: at a fusion
        pass segment boundary (a barrier source) and at joins that emit as
        sources (learn/compact/general), which drive their own function."""
        d = 1
        op = self.child
        while op is not None:
            if getattr(op, "_chain_split", False):
                break
            if isinstance(op, HashJoinOp):
                if op._emit_mode != "transparent":
                    break
                d += 1
            op = getattr(op, "child", None)
        return d

    def stream_parts(self):
        if not (self._fusable or self._gen_fusable):
            return None
        if self._grace is not None:
            return None  # spilled: the Grace join drives the probe itself
        if not self._initialized:
            self.init()
        if not self._capturable:
            return None  # hashed keys read the host per probe: a barrier
        if self._emit_mode != "transparent":
            # learn/compact/general: this join is a tile SOURCE. It drives
            # the child chain through its own (chain o probe [o compact])
            # function and hands consumers its output tiles
            return self, _identity_fn, ()
        if self.fused_depth() > settings.get("sql.distsql.max_fused_joins"):
            # very deep probe pipelines split at this join, so one fused
            # function never grows without bound
            return None
        parts = self.child.stream_parts()
        if parts is None:
            return None
        self._ensure_built()
        if self._grace is not None:
            return None  # the build spilled while spooling
        src, cfn, cargs = parts
        chain = getattr(self, "_chain_fn", None)
        if (chain is None or getattr(self, "_chain_base", None) is not cfn
                or getattr(self, "_chain_raw", None) is not self._probe_raw):
            nc = len(cargs)
            raw = self._probe_raw

            def chain(t, *a):
                return raw(cfn(t, *a[:nc]), a[nc], a[nc + 1])

            self._chain_fn = chain
            self._chain_base = cfn
            self._chain_raw = raw
        return src, self._chain_fn, cargs + (self._build_batch, self._index)

    def _emit_kernel(self, cfn, nc):
        """The (chain o probe o count [o compact]) function of source-mode
        emission, cached on (chain fn, probe fn, emission cap). It carries
        the largest count seen (the true total for the general emit) as a
        device scalar, so overflow is found at query end."""
        cap = self._emit_cap
        if self._emit_mode == "general":
            graw = self._probe_gen_raw
            key = (cfn, graw, cap)
            if getattr(self, "_emit_kern_key", None) == key:
                return self._emit_kern

            def kern(mx, t, *a):
                p = cfn(t, *a[:nc]) if cfn is not None else t
                out, total = graw(p, a[nc], a[nc + 1], cap)
                return torch.maximum(mx, total), out
        else:
            raw = self._probe_raw
            key = (cfn, raw, cap)
            if getattr(self, "_emit_kern_key", None) == key:
                return self._emit_kern

            def kern(mx, t, *a):
                out = raw(cfn(t, *a[:nc]) if cfn is not None else t,
                          a[nc], a[nc + 1])
                cnt = out.mask.sum(dtype=torch.int64)
                if cap is not None:
                    out = compact(out, cap)
                return torch.maximum(mx, cnt), out

        self._emit_kern = (dispatch.jit(kern, carry=True) if self._capturable
                           else dispatch.counted(kern))
        self._emit_kern_key = key
        return self._emit_kern

    def _emit(self, kern, t, args):
        """One source-mode tile: run the emit function, carry the max."""
        mx = self._emit_max
        if mx is None:
            mx = torch.zeros((), dtype=torch.int64,
                             device=self._build_batch.device)
        self._emit_max, out = kern(mx, t, *args)
        self._emit_tiles += 1
        if self._emit_cap is None:
            self._emit_tilecap = max(self._emit_tilecap, out.capacity)
        return out

    def stream_tiles(self):
        """Source-mode drive loop (learn/compact/general emission)."""
        self._ensure_built()
        if self._grace is not None:
            # build spilled mid-spool: serve grace output as plain tiles
            while True:
                b = self._grace._next()
                if b is None:
                    return
                yield b
            return
        parts = self.child.stream_parts()
        if parts is not None:
            src, cfn, cargs = parts
            args = cargs + (self._build_batch, self._index)
            if self._emit_mode == "general" and self._emit_cap is None:
                # initial speculation: fanout <= 1 per probe row at full
                # scan tiles; post_run_update corrects either way
                self._emit_cap = max(4096, _canonical_cap(
                    settings.get("sql.distsql.tile_size")))
            kern = self._emit_kernel(cfn, len(cargs))
            for t in src.stream_tiles():
                yield self._emit(kern, t, args)
            return
        kern = None
        while True:
            b = self.child.next_batch()
            if b is None:
                return
            if kern is None:
                if self._emit_mode == "general" and self._emit_cap is None:
                    self._emit_cap = max(4096, _canonical_cap(b.capacity))
                kern = self._emit_kernel(None, 0)
            yield self._emit(kern, b, (self._build_batch, self._index))

    def post_run_update(self) -> bool:
        if not self._emit_tiles:
            return False
        # one host sync per query for the whole run's emission
        mx = self.sync_int(self._emit_max)
        self._emit_tiles = 0
        self._emit_max = None
        if self._emit_mode == "general":
            # a total past the emission capacity means that tile's rows
            # were truncated: grow (with headroom) and re-run the query
            if mx > self._emit_cap:
                self._emit_cap = _canonical_cap(2 * mx)
                return True
            if mx * 8 <= self._emit_cap and self._emit_cap > 4096:
                # learned fanout far below speculation: shrink (keeping 2x
                # headroom) so steady tiles stop carrying dead rows
                self._emit_cap = max(4096, _canonical_cap(2 * mx))
            return False
        overflow = (self._emit_mode == "compact"
                    and self._emit_cap is not None and mx > self._emit_cap)
        tile = self._emit_tilecap
        cap = max(1024, _canonical_cap(2 * mx))
        if tile and mx * 4 <= tile and cap < tile:
            # compacting pays only when the learned cap SHRINKS the tile
            self._emit_cap = cap
            self._emit_mode = "compact"
        else:
            self._emit_mode = "transparent"
            self._emit_cap = None
        return overflow

    def _next(self):
        self._ensure_built()
        if self._grace is not None:
            return self._grace._next()
        p = self.child.next_batch()
        if p is None:
            return None
        if self.probe_aligned:
            if self._emit_mode != "transparent":
                return self._emit(self._emit_kernel(None, 0), p,
                                  (self._build_batch, self._index))
            return self._probe_fn(p, self._build_batch, self._index)
        if self._out_cap <= 0:
            # initial capacity: fanout <= 1 per probe row, grown on
            # overflow (each growth is a new signature, so it errs large)
            self._out_cap = max(4096, _canonical_cap(p.capacity))
        while True:
            out, total = self._probe_gen_fn(p, self._build_batch, self._index,
                                            self._out_cap)
            n = self.sync_int(total)
            if n <= self._out_cap:
                return out
            self._out_cap = _canonical_cap(n)

    def close(self):
        super().close()
        self.build.close()
        self._close_build()
        if self._grace is not None:
            self._grace.close()


# ---------------------------------------------------------------------------
# Window, UNION ALL, merge join


class WindowOp(OneInputOperator):
    """Buffering window-function operator (colexecwindow analog): spool
    every tile, then ONE function (one CUDA graph on the card) concats
    the spool at its canonical capacity and appends the window columns
    (ops/window.compute_windows). Like the reference's, it has no
    external variant: the spool and the sorted tile live on the device
    whole."""

    def __init__(self, child: Operator, partition_cols: tuple[int, ...],
                 order_keys, specs):
        from ..ops import window as win_ops

        super().__init__(child)
        self.partition_cols = tuple(partition_cols)
        self.order_keys = tuple(order_keys)
        self.specs = tuple(specs)
        self.output_schema = win_ops.window_output_schema(
            child.output_schema, self.specs)
        # string-valued outputs (lag/lead/min/max/first/last over a STRING
        # column) carry the source column's dictionary
        base_len = len(child.output_schema)
        for i, sp in enumerate(self.specs):
            if (sp.col is not None and sp.col in child.dictionaries
                    and sp.func in ("lag", "lead", "min", "max",
                                    "first_value", "last_value")):
                self.dictionaries[base_len + i] = child.dictionaries[sp.col]
        # rank tables for every STRING column the function sorts or
        # reduces: order keys, partition keys and min/max inputs
        need = {k.col for k in self.order_keys} | set(self.partition_cols)
        need.update(sp.col for sp in self.specs
                    if sp.col is not None and sp.func in ("min", "max"))
        _refuse_runtime_keys(child, sorted(need), "a window over")
        self.rank_tables = {c: child.dictionaries[c].ranks
                            for c in need if c in child.dictionaries}
        self._fn = dispatch.jit(self._windows)

    def _windows(self, tiles, cap: int) -> Batch:
        from ..ops import window as win_ops

        big = concat(list(tiles), capacity=cap)
        return win_ops.compute_windows(
            big, self.child.output_schema, self.partition_cols,
            self.order_keys, self.specs, self.rank_tables)

    def init(self):
        super().init()
        self._emitted = False

    def _next(self):
        if self._emitted:
            return None
        self._emitted = True
        tiles = [_keep(self, k, b) for k, b in
                 enumerate(_consume(self, "spool", _identity_fn))]
        if not tiles:
            return None
        return self._fn(tuple(tiles), _spool_cap(self, tiles))


class UnionOp(Operator):
    """UNION ALL: pull each input to exhaustion in order (the plan-level
    unordered fan-in; the inputs share one output schema)."""

    def __init__(self, children_ops: tuple[Operator, ...]):
        super().__init__()
        if not children_ops:
            raise ValueError("UNION ALL needs at least one input")
        self._children = list(children_ops)
        self.output_schema = children_ops[0].output_schema
        for c in children_ops[1:]:
            if len(c.output_schema) != len(self.output_schema):
                raise ValueError("UNION ALL inputs must have equal arity")
        self.dictionaries = dict(children_ops[0].dictionaries)
        self._cur = 0

    def children(self):
        return list(self._children)

    def init(self):
        for c in self._children:
            c.init()
        super().init()
        self._cur = 0

    def _next(self):
        while self._cur < len(self._children):
            b = self._children[self._cur].next_batch()
            if b is not None:
                return b
            self._cur += 1
        return None

    def close(self):
        for c in self._children:
            c.close()


class OrderedSyncOp(Operator):
    """Merge-ordered fan-in — the OrderedSynchronizer analog (colexec/
    ordered_synchronizer.eg.go): K inputs, each sorted on `keys`, merge
    into one sorted stream, incrementally. Per round one tile is pulled
    from each input that needs one, the buffered rows merge (concat and
    one sort), and the rows at or below the barrier — the smallest of the
    inputs' largest buffered keys — go out (no later row can sort before
    them). Rows past the barrier carry to the next round in one tile.

    It streams when the key list packs into 64-bit words (int, date,
    string and bool keys: barriers compare lexicographically across the
    words); float keys spool every input and sort once — the same
    result, not streamed."""

    def __init__(self, children_ops: tuple[Operator, ...], keys):
        super().__init__()
        assert children_ops, "ordered fan-in needs at least one input"
        self._children = list(children_ops)
        self.keys = tuple(keys)
        self.output_schema = children_ops[0].output_schema
        self.dictionaries = dict(children_ops[0].dictionaries)
        self.col_stats = {}
        self._rank_tables = {
            k.col: children_ops[0].dictionaries[k.col].ranks
            for k in self.keys
            if k.col in children_ops[0].dictionaries
        }

    def children(self):
        return list(self._children)

    def _packed_words(self, b: Batch):
        """Packed sort-key words per row, each as a signed-comparable
        int64 (lexicographic across the list), or None when an operand is
        not a 64-bit word (float keys)."""
        ops = sort_ops.pack_sort_operands(
            b, self.output_schema, self.keys, self._rank_tables,
            include_mask=False)
        if any(o.dtype != torch.int64 for o in ops):
            return None
        return [sort_ops.sortable(o) for o in ops]

    @staticmethod
    def _lex_max(words, live):
        """Lexicographic max of multi-word keys over the live rows, on the
        device: each word fixed greedily, narrowing the candidates."""
        sel = live
        out = []
        lowest = torch.iinfo(torch.int64).min
        for w in words:
            m = torch.where(sel, w, torch.full_like(w, lowest)).max()
            out.append(m)
            sel = sel & (w == m)
        return out

    @staticmethod
    def _lex_le(words, barrier):
        """Rowwise (w0, w1, ...) <= (b0, b1, ...)."""
        lt = torch.zeros(words[0].shape, dtype=torch.bool,
                         device=words[0].device)
        eq = torch.ones_like(lt)
        for w, b in zip(words, barrier):
            lt = lt | (eq & (w < b))
            eq = eq & (w == b)
        return lt | eq

    def init(self):
        for c in self._children:
            c.init()
        self._bufs: list[Batch | None] = [None] * len(self._children)
        self._done = [False] * len(self._children)
        self._carry: Batch | None = None
        self._flushed = False
        probe = empty_batch(self.output_schema, 16, "cpu")
        self._streaming = self._packed_words(probe) is not None
        self._spooled = None
        super().init()

    def _fallback_next(self):
        if self._spooled is None:
            tiles = []
            for c in self._children:
                while True:
                    b = c.next_batch()
                    if b is None:
                        break
                    tiles.append(b)
            if not tiles:
                self._spooled = ()
                return None
            big = concat(tiles, capacity=_spool_cap(self, tiles))
            self._spooled = (sort_ops.sort_batch(
                big, self.output_schema, self.keys, self._rank_tables),)
        if self._spooled:
            out, self._spooled = self._spooled[0], ()
            return out
        return None

    def _round(self):
        """One round: pull the missing tiles, merge, split at the barrier;
        the batch to emit, or None when nothing is left."""
        for i, c in enumerate(self._children):
            if not self._done[i] and self._bufs[i] is None:
                b = c.next_batch()
                if b is None:
                    self._done[i] = True
                else:
                    self._bufs[i] = b
        tiles = [b for b in self._bufs if b is not None]
        parts = ([self._carry] if self._carry is not None else []) + tiles
        if not parts:
            return None
        cap = _spool_cap(self, parts)
        merged = sort_ops.sort_batch(
            concat(parts, capacity=cap), self.output_schema, self.keys,
            self._rank_tables)
        if all(self._done):
            # the final flush: every row is safe
            self._carry = None
            self._bufs = [None] * len(self._children)
            self._flushed = True
            return merged
        words = self._packed_words(merged)
        # the barrier: the lexicographic min, over the inputs not yet
        # exhausted, of their buffered max key
        barrier = None
        for i in range(len(self._children)):
            if self._done[i] or self._bufs[i] is None:
                continue
            bw = self._packed_words(self._bufs[i])
            bar = self._lex_max(bw, self._bufs[i].mask)
            if barrier is None:
                barrier = bar
            else:
                le = self._lex_le([x[None] for x in bar],
                                  [x[None] for x in barrier])[0]
                barrier = [torch.where(le, x, y)
                           for x, y in zip(bar, barrier)]
        safe = self._lex_le(words, barrier)
        out = merged.with_mask(merged.mask & safe)
        # the carry keeps the tail in order (compact keeps row order); it
        # is bounded by the tiles' capacities, so cap always fits
        self._carry = compact(merged.with_mask(merged.mask & ~safe),
                              capacity=cap)
        self._bufs = [None] * len(self._children)
        return out

    def _next(self):
        if not self._streaming:
            return self._fallback_next()
        if self._flushed:
            return None
        return self._round()

    def close(self):
        for c in self._children:
            c.close()


class ParallelUnorderedSyncOp(Operator):
    """Unordered fan-in with one puller thread per input — the
    ParallelUnorderedSynchronizer analog (colexec/parallel_unordered_
    synchronizer.go:66): batches surface in arrival order through a
    bounded queue, so the inputs overlap their waits. Remote inboxes need
    it (draining one after another would serialize the hosts' compute
    and network time). The consumer owns each batch it takes: a puller
    does not pull again until its batch was taken."""

    _QUEUE_DEPTH = 4  # per-input backpressure (bounded buffering)
    _DONE = object()

    def __init__(self, children_ops: tuple[Operator, ...]):
        super().__init__()
        assert children_ops, "fan-in needs at least one input"
        self._children = list(children_ops)
        self.output_schema = children_ops[0].output_schema
        for c in children_ops[1:]:
            assert len(c.output_schema) == len(self.output_schema), \
                "fan-in inputs must have equal arity"
        self.dictionaries = dict(children_ops[0].dictionaries)
        self.col_stats = {}
        self._threads: list = []

    def children(self):
        return list(self._children)

    def init(self):
        import queue
        import threading

        # a re-init (the runtime's capacity retry) must not leave the
        # previous run's pullers racing the new ones on the children
        self._shutdown_pullers()
        for c in self._children:
            c.init()
        self._q = queue.Queue(
            maxsize=self._QUEUE_DEPTH * len(self._children))
        self._stop = threading.Event()
        self._live = len(self._children)
        self._threads = []
        for c in self._children:
            t = threading.Thread(target=self._pull, args=(c,),
                                 name="unordered-sync", daemon=True)
            t.start()
            self._threads.append(t)
        super().init()

    def _pull(self, child: Operator) -> None:
        try:
            while not self._stop.is_set():
                b = child.next_batch()
                if b is None:
                    break
                # a tile a graph's next replay overwrites is copied out
                self._q.put(dispatch.own(b))
        # crlint: allow-broad-except(producer thread forwards the exception to the consumer via the queue)
        except BaseException as e:  # noqa: BLE001 - forwarded to the consumer through the queue
            self._q.put(e)
            return
        self._q.put(self._DONE)

    def _next(self):
        while self._live > 0:
            # waiting on the inputs: the device lock goes to other work
            with dispatch.exec_released():
                item = self._q.get()
            if item is self._DONE:
                self._live -= 1
                continue
            if isinstance(item, BaseException):
                self._stop.set()
                raise item
            return item
        return None

    def _shutdown_pullers(self) -> None:
        """Stop and join the pullers, draining the queue while joining so
        a producer blocked in put() gets room to see the stop."""
        if not self._threads:
            return
        import queue

        self._stop.set()
        for t in self._threads:
            while t.is_alive():
                try:
                    while True:
                        self._q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)
        self._threads = []

    def close(self):
        # children first: closing a remote inbox closes its socket, the
        # one thing that unblocks a puller parked in recv
        if self._threads:
            self._stop.set()
        for c in self._children:
            c.close()
        self._shutdown_pullers()


class MergeJoinOp(OneInputOperator):
    """Merge join (mergejoiner.go analog): spool and sort the build side
    by its exact (possibly composite) key once, then stream probe tiles
    through a vectorised lexicographic binary search (ops/merge_join.py;
    no hash, no collision loop). Each probe is one function at a sticky
    output capacity; a probe whose total passes it runs again at the
    canonical capacity of the total (one counted host sync per tile)."""

    def __init__(self, probe: Operator, build: Operator, probe_key,
                 build_key, spec: join_ops.JoinSpec):
        from ..ops import merge_join as mj_ops

        super().__init__(probe)
        self.build = build
        self.probe_key = mj_ops._norm_keys(probe_key)
        self.build_key = mj_ops._norm_keys(build_key)
        self.spec = spec
        self.output_schema = join_ops.join_output_schema(
            probe.output_schema, build.output_schema, spec)
        if spec.join_type not in ("semi", "anti"):
            off = len(probe.output_schema)
            for i, d in build.dictionaries.items():
                self.dictionaries[off + i] = d
            for i, s in build.col_stats.items():
                self.col_stats[off + i] = s
        # STRING keys share one rank space per key position: build codes
        # remap into the probe dictionary's ranks
        self.probe_rank, self.build_rank = mj_ops.rank_tables_for(
            probe.output_schema, self.probe_key, probe.dictionaries,
            self.build_key, build.dictionaries)
        self._out_cap = 4096
        self._build_fn = dispatch.jit(self._build_index)
        self._probe_fn = dispatch.jit(self._probe)
        self._store: list = []

    def _build_index(self, tiles, cap: int):
        from ..ops import merge_join as mj_ops

        big = concat(list(tiles), capacity=cap)
        return big, mj_ops.build_merge_index(
            big, self.build.output_schema, self.build_key, self.build_rank)

    def _probe(self, p: Batch, build: Batch, index, out_cap: int):
        from ..ops import merge_join as mj_ops

        return mj_ops.merge_join(
            p, self.child.output_schema, self.probe_key, build,
            self.build.output_schema, self.build_key, self.spec, out_cap,
            self.probe_rank, self.build_rank, build_index=index, sync=None)

    def children(self):
        return [self.child, self.build]

    def init(self):
        self.build.init()
        super().init()
        self._built = False

    def _ensure_built(self):
        if self._built:
            return
        self._built = True
        tiles = [_keep(self, k, b) for k, b in
                 enumerate(_consume_op(self.build, "build_spool"))]
        if not tiles:
            empty = empty_batch(self.build.output_schema, 1024,
                                _source_device(self.build))
            self._build_batch, self._index = dispatch.persist(
                self._store, self._build_index((empty,), 1024))
        else:
            self._build_batch, self._index = self._build_fn(
                tuple(tiles), _spool_cap(self, tiles))

    def _next(self):
        self._ensure_built()
        p = self.child.next_batch()
        if p is None:
            return None
        if self.spec.join_type in ("semi", "anti"):
            # probe-aligned: the output is the probe tile, re-masked
            return self._probe_fn(p, self._build_batch, self._index, 0)[0]
        while True:
            out, total = self._probe_fn(p, self._build_batch, self._index,
                                        self._out_cap)
            n = self.sync_int(total)
            if n <= self._out_cap:
                return out
            self._out_cap = _canonical_cap(n)

    def close(self):
        super().close()
        self.build.close()
