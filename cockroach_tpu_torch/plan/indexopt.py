"""Index selection — rewrite Filter(TableScan) into IndexScan; the port of
``cockroach_tpu.plan.indexopt``.

Reference: the optimizer's GenerateIndexScans / GenerateConstrainedScans
exploration rules turn filtered full scans into constrained index scans
when a filter conjunct constrains an indexed column
(pkg/sql/opt/xform/select_funcs.go); the execbuilder then plans an index
join to fetch unindexed columns (pkg/sql/rowexec/joinreader.go).

Reduction: single-column indexes, conjuncts of the form
``col <cmp> literal`` (and BETWEEN, which the binder lowers to two
conjuncts — possibly as separate stacked Filter nodes, which the rewrite
walks as one chain). The whole original predicate stays as a residual
filter over the fetched rows — re-applying the bound conjunct is one fused mask op,
and it keeps boundary/NULL semantics independent of the span math.

Selectivity gate: the scan flips to the index only when the constrained
value range is estimated under ``sql.opt.index_scan_max_frac`` of the
column's (lo, hi) span from table statistics — a full-table IndexScan
would be strictly worse than the resident columnar scan."""

from __future__ import annotations

import dataclasses

from ..ops import expr as ex
from ..utils import settings
from . import spec as S


def _conjuncts(e: ex.Expr) -> list[ex.Expr]:
    if isinstance(e, ex.BoolOp) and e.op == "and":
        out = []
        for part in e.args:
            out.extend(_conjuncts(part))
        return out
    return [e]


def _col_bound(c: ex.Expr) -> tuple[int, str, int] | None:
    """(scan column index, cmp op, literal) for `col <cmp> int-literal`
    conjuncts, normalized so the column is on the left."""
    if not isinstance(c, ex.Cmp) or c.op == "ne":
        return None
    flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}
    left, right, op = c.left, c.right, c.op
    if isinstance(right, ex.ColRef) and isinstance(left, ex.Const):
        left, right, op = right, left, flip[op]
    if not (isinstance(left, ex.ColRef) and isinstance(right, ex.Const)):
        return None
    v = right.value
    if isinstance(v, bool) or not (
            isinstance(v, int) or hasattr(v, "__index__")):
        return None
    return left.idx, op, int(v)


def _bounds_for(conjs, names, indexed: dict[str, object]):
    """Tightest (index, lo, hi) over the conjuncts, or None."""
    best: dict[str, list] = {}
    for c in conjs:
        m = _col_bound(c)
        if m is None:
            continue
        i, op, v = m
        if i >= len(names) or names[i] not in indexed:
            continue
        if op == "eq":
            nlo, nhi = v, v
        elif op == "lt":
            nlo, nhi = None, v - 1
        elif op == "le":
            nlo, nhi = None, v
        elif op == "gt":
            nlo, nhi = v + 1, None
        else:  # ge
            nlo, nhi = v, None
        b = best.setdefault(names[i], [None, None])
        b[0] = nlo if b[0] is None else (b[0] if nlo is None else max(b[0], nlo))
        b[1] = nhi if b[1] is None else (b[1] if nhi is None else min(b[1], nhi))
    for col, (lo, hi) in best.items():
        if lo is not None or hi is not None:
            return indexed[col], lo, hi
    return None


def _selective_enough(table, ix, lo, hi) -> bool:
    if lo is not None and hi is not None and hi < lo:
        return True  # empty span: the index scan is free
    stats = table.col_stats()
    b = stats.get(ix.col)
    if b is None:
        # no statistics: only a two-sided constraint is trusted
        return lo is not None and hi is not None
    clo, chi = int(b[0]), int(b[1])
    width = max(1, chi - clo + 1)
    elo = clo if lo is None else max(clo, lo)
    ehi = chi if hi is None else min(chi, hi)
    frac = max(0, ehi - elo + 1) / width
    return frac <= settings.get("sql.opt.index_scan.max_frac")


def use_indexes(plan: S.PlanNode, catalog) -> S.PlanNode:
    """Recursively rewrite eligible Filter(TableScan) subtrees."""
    if not settings.get("sql.opt.index_scan.enabled"):
        return plan
    return _rewrite(plan, catalog)


def _rewrite(plan, catalog):
    from ..kv.table import KVTable

    if isinstance(plan, S.Filter):
        # The binder pushes WHERE conjuncts down one at a time, so a
        # two-sided bound (k >= 30 AND k <= 36) arrives as STACKED Filter
        # nodes over the scan. Walk the whole chain and size the span over
        # the union of every level's conjuncts; the residual filters are
        # re-applied unchanged over the IndexScan.
        preds = [plan.predicate]
        inner = plan.input
        while isinstance(inner, S.Filter):
            preds.append(inner.predicate)
            inner = inner.input
        if isinstance(inner, S.TableScan):
            scan = inner
            table = catalog.tables.get(scan.table)
            if (isinstance(table, KVTable) and table.indexes
                    and scan.shard is None):
                names = scan.columns or table.schema.names
                indexed = {ix.col: ix for ix in table.indexes}
                conjs = [c for p in preds for c in _conjuncts(p)]
                got = _bounds_for(conjs, names, indexed)
                if got is not None:
                    ix, lo, hi = got
                    if _selective_enough(table, ix, lo, hi):
                        node: S.PlanNode = S.IndexScan(
                            scan.table, ix.name, lo, hi, scan.columns)
                        for p in reversed(preds):
                            node = S.Filter(node, p)
                        return node
    # generic recursion over PlanNode dataclass fields
    if not dataclasses.is_dataclass(plan):
        return plan
    changes = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, S.PlanNode):
            nv = _rewrite(v, catalog)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, tuple) and v and isinstance(v[0], S.PlanNode):
            nv = tuple(_rewrite(x, catalog) for x in v)
            if any(a is not b for a, b in zip(nv, v)):
                changes[f.name] = nv
    return dataclasses.replace(plan, **changes) if changes else plan
