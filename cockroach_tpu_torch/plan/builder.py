"""Plan -> operator tree — the colbuilder.NewColOperator analog; the port
of ``cockroach_tpu.plan.builder``: TableScan (whole or one shard),
IndexScan, Filter, Project, Aggregate (complete, partial or final),
ScalarAggregate, Sort, TopK, Limit, Distinct, Window, HashJoin,
MergeJoin, Union, the cross-host nodes HashBucket, RemoteStream and
StreamUnion (flow/disthost.py), and Exchange as the identity (the
in-process shuffle is planned by parallel/). Then, as in the reference,
the fusion pass (flow/fuse.py) collapses stateless per-tile chains.
"""

from __future__ import annotations

import dataclasses

from ..catalog import Catalog
from ..coldata.types import Family
from ..flow import operators as ops
from ..flow.operator import Operator
from ..ops import expr as ex
from ..ops.aggregation import STAT_FUNCS
from ..utils import settings
from . import spec as S


def _plan_dense_agg(child: Operator, group_cols, aggs):
    """(key_sizes, key_lows) for the dense aggregation when every group
    key is bounded — by catalog stats (integer families) or dictionary
    size (strings) — and the packed code space fits
    ``sql.distsql.dense_agg_states``; larger key spaces group by sorting."""
    for spec in aggs:
        if spec.func not in ("sum", "count", "count_rows", "min", "max",
                             "avg", "any_not_null") + STAT_FUNCS:
            return None
    sizes, lows = [], []
    G = 1
    budget = settings.get("sql.distsql.dense_agg_states")
    for gi in group_cols:
        t = child.output_schema.types[gi]
        if t.family is Family.STRING and gi in child.dictionaries:
            if getattr(child.dictionaries[gi], "_runtime", False):
                return None  # fills at runtime: size unknown at plan time
            size, lo = len(child.dictionaries[gi]), 0
        elif t.family in (Family.FLOAT, Family.BYTES, Family.JSON,
                          Family.STRING):
            return None
        else:
            st = child.col_stats.get(gi)
            if st is None:
                return None
            lo, hi = int(st[0]), int(st[1])
            size = hi - lo + 1
            if size <= 0:
                return None
        sizes.append(size)
        lows.append(lo)
        G *= size + 1  # +1: the per-key NULL code (dense_layout)
        if G > budget:
            return None
    return tuple(sizes), tuple(lows)


def _clustered_input(plan: S.PlanNode, group_cols, catalog: Catalog):
    """(ordered, prefix_live) for an Aggregate's input chain: ordered when
    the walk down Project/Filter reaches a TableScan whose Table.ordering
    prefix IS the group key set; prefix_live when no Filter interleaves
    dead rows."""
    cols = list(group_cols)
    prefix_live = True
    node = plan
    while True:
        if isinstance(node, S.Project):
            mapped = []
            for c in cols:
                e = node.exprs[c]
                if not isinstance(e, ex.ColRef):
                    return False, False
                mapped.append(e.idx)
            cols = mapped
            node = node.input
        elif isinstance(node, S.Filter):
            prefix_live = False
            node = node.input
        elif isinstance(node, S.TableScan):
            table = catalog.get(node.table)
            ordering = tuple(getattr(table, "ordering", ()) or ())
            if not ordering or len(cols) > len(ordering):
                return False, False
            names = tuple(node.columns or table.schema.names)
            try:
                keynames = {names[c] for c in cols}
            except IndexError:
                return False, False
            if keynames == set(ordering[: len(cols)]):
                return True, prefix_live
            return False, False
        else:
            return False, False


def build(plan: S.PlanNode, catalog: Catalog, params=None) -> Operator:
    """Instantiate the operator tree for `plan` over `catalog`'s tables,
    then collapse its stateless per-tile chains into FusedPipeline
    segments (flow/fuse.py) unless ``sql.distsql.fusion.enabled`` is
    off. ``params`` (a sql/plancache.ParamStore) reaches the FilterOps
    whose predicates carry ex.Param leaves, so a cached plan rebinds
    literals as arguments instead of capturing again."""
    op = _build(plan, catalog, params)
    if settings.get("sql.distsql.fusion.enabled"):
        from ..flow import fuse

        op = fuse.fuse_operators(op)
    return op


def _has_param(x) -> bool:
    """Whether an expression (or a tuple of them) holds an ex.Param."""
    if isinstance(x, ex.Param):
        return True
    if isinstance(x, tuple):
        return any(_has_param(v) for v in x)
    if isinstance(x, ex.Expr) and dataclasses.is_dataclass(x):
        return any(_has_param(getattr(x, f.name))
                   for f in dataclasses.fields(x))
    return False


def _build(plan: S.PlanNode, catalog: Catalog, params=None) -> Operator:
    if isinstance(plan, S.TableScan):
        return ops.ScanOp(catalog.get(plan.table), plan.columns,
                          tile=settings.get("sql.distsql.tile_size"),
                          shard=plan.shard)
    if isinstance(plan, S.IndexScan):
        return ops.IndexScanOp(catalog.get(plan.table), plan.index, plan.lo,
                               plan.hi, plan.columns)
    if isinstance(plan, S.HashBucket):
        return ops.HashBucketOp(_build(plan.input, catalog, params),
                                plan.keys, plan.n_parts, plan.part)
    if isinstance(plan, S.RemoteStream):
        return ops.RemoteStreamOp(plan.addr, plan.flow_id, plan.stream_id,
                                  plan.schema, device=catalog.device)
    if isinstance(plan, S.StreamUnion):
        return ops.ParallelUnorderedSyncOp(
            tuple(_build(p, catalog, params) for p in plan.inputs))
    if isinstance(plan, S.Filter):
        return ops.FilterOp(_build(plan.input, catalog, params),
                            plan.predicate, params=params)
    if isinstance(plan, S.Project):
        return ops.ProjectOp(
            _build(plan.input, catalog, params), plan.exprs, plan.names,
            plan.dict_overrides,
            params=params if _has_param(plan.exprs) else None)
    if isinstance(plan, S.Aggregate):
        child = _build(plan.input, catalog, params)
        if plan.key_sizes is not None and plan.mode == "complete":
            return ops.SmallGroupAggregateOp(
                child, plan.group_cols, plan.aggs, plan.key_sizes)
        if plan.mode == "complete":
            dense = _plan_dense_agg(child, plan.group_cols, plan.aggs)
            if dense is not None:
                sizes, lows = dense
                return ops.SmallGroupAggregateOp(
                    child, plan.group_cols, plan.aggs, sizes, key_lows=lows)
        ordered, prefix_live = (
            _clustered_input(plan.input, plan.group_cols, catalog)
            if plan.mode in ("complete", "partial") else (False, False))
        return ops.AggregateOp(child, plan.group_cols, plan.aggs, plan.mode,
                               ordered=ordered, prefix_live=prefix_live,
                               input_schema=plan.base_schema)
    if isinstance(plan, S.ScalarAggregate):
        # as in the reference: the planners make complete scalar
        # aggregates only (parallel/ lowers the distributed ones itself)
        return ops.ScalarAggregateOp(_build(plan.input, catalog, params), plan.aggs)
    if isinstance(plan, S.Sort):
        return ops.SortOp(_build(plan.input, catalog, params), plan.keys)
    if isinstance(plan, S.TopK):
        return ops.TopKOp(_build(plan.input, catalog, params), plan.keys, plan.k)
    if isinstance(plan, S.Limit):
        return ops.LimitOp(_build(plan.input, catalog, params), plan.limit,
                           plan.offset)
    if isinstance(plan, S.Distinct):
        return ops.DistinctOp(_build(plan.input, catalog, params), plan.cols)
    if isinstance(plan, S.Window):
        return ops.WindowOp(_build(plan.input, catalog, params), plan.partition_cols,
                            plan.order_keys, plan.specs)
    if isinstance(plan, S.MergeJoin):
        return ops.MergeJoinOp(
            _build(plan.probe, catalog, params), _build(plan.build, catalog, params),
            plan.probe_key, plan.build_key, plan.spec)
    if isinstance(plan, S.HashJoin):
        return ops.HashJoinOp(
            _build(plan.probe, catalog, params), _build(plan.build, catalog, params),
            plan.probe_keys, plan.build_keys, plan.spec)
    if isinstance(plan, S.Union):
        return ops.UnionOp(tuple(_build(p, catalog, params) for p in plan.inputs))
    if isinstance(plan, S.Exchange):
        # single-device build: the shuffle is the identity
        return _build(plan.input, catalog, params)
    raise TypeError(f"unknown plan node {plan}")
