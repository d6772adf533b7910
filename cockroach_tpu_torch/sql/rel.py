"""Relational plan builder — the optbuilder analog; the port of the
plan-building subset of ``cockroach_tpu.sql.rel`` that the 22 TPC-H
queries use (scan, filter, project, select, groupby, scalar_agg, sort,
limit, distinct, join, and the string predicates and transforms).

``Rel`` is a fluent builder over the plan IR that tracks output schema and
string dictionaries as the plan grows, so string literals resolve to
dictionary codes and string predicates become host-prepared CodeLookup
tables at plan time. ``Rel.run`` executes ``optimized_plan()``: top-k
pushdown over the plan, as the reference's does (its index selection
only rewrites scans of indexed KV tables, which the port has not
brought over).
"""

from __future__ import annotations

import operator
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..catalog import Catalog
from ..coldata.batch import Dictionary
from ..coldata.types import FLOAT64, INT32, STRING, Schema, SQLType
from ..flow.runtime import run_plan
from ..ops import aggregation as agg_ops
from ..ops import expr as ex
from ..ops import join as join_ops
from ..ops import sort as sort_ops
from ..plan import spec as S
from ..plan.topkopt import push_topk


@dataclass
class Rel:
    catalog: Catalog
    plan: S.PlanNode
    schema: Schema
    dicts: dict[int, Dictionary] = field(default_factory=dict)

    # -- name resolution ----------------------------------------------------

    def idx(self, name: str) -> int:
        return self.schema.index(name)

    def c(self, name: str) -> ex.ColRef:
        return ex.ColRef(self.idx(name))

    def type_of(self, name: str) -> SQLType:
        return self.schema.type_of(name)

    def str_lit(self, col: str, value: str) -> ex.Const:
        """Literal of a dictionary-coded string column -> its code."""
        i = self.idx(col)
        code = self.dicts[i].code_of(value)
        return ex.Const(code, INT32)

    def str_eq(self, col: str, value: str) -> ex.Expr:
        return ex.Cmp("eq", self.c(col), self.str_lit(col, value))

    def str_in(self, col: str, values: list[str]) -> ex.Expr:
        i = self.idx(col)
        d = self.dicts[i]
        table = np.zeros(max(1, len(d)), dtype=bool)
        for v in values:
            code = d.code_of(v)
            if code >= 0:
                table[code] = True
        return ex.CodeLookup(col=i, table=table)

    def str_pred(self, col: str, fn: Callable[[str], bool]) -> ex.Expr:
        """Arbitrary string predicate (LIKE etc.) evaluated per dictionary
        entry on the host, becoming a device gather."""
        i = self.idx(col)
        d = self.dicts[i]
        table = np.array([bool(fn(str(v))) for v in d.values])
        if len(table) == 0:
            table = np.zeros(1, dtype=bool)
        return ex.CodeLookup(col=i, table=table)

    def str_cmp(self, col: str, op: str, value: str) -> ex.Expr:
        """Range comparison on strings, per dictionary entry."""
        fns = {"lt": operator.lt, "le": operator.le, "gt": operator.gt,
               "ge": operator.ge}
        return self.str_pred(col, lambda s: fns[op](s, value))

    def str_transform(self, col: str,
                      fn: Callable[[str], str]) -> tuple[ex.Expr, Dictionary]:
        """String-valued function of a STRING column (SUBSTRING etc.),
        evaluated per dictionary entry on the host: returns a STRING
        expression (a code-remap gather on the device) plus the
        transformed values' Dictionary — attach it when projecting (see
        with_dict)."""
        i = self.idx(col)
        d = self.dicts[i]
        mapped = np.array([fn(str(v)) for v in d.values], dtype=object)
        uvals, codes = (np.unique(mapped.astype(str), return_inverse=True)
                        if len(mapped) else (np.array([], dtype=object),
                                             np.zeros(0, np.int32)))
        table = codes.astype(np.int32) if len(codes) else np.zeros(1, np.int32)
        return (ex.CodeLookup(col=i, table=table, out_type=STRING),
                Dictionary(uvals.astype(object)))

    def with_dict(self, col: str, d: Dictionary) -> "Rel":
        """Attach a dictionary to a STRING output column whose dictionary
        the projection cannot infer (e.g. a str_transform output). Must
        directly follow a project(); the override is recorded on the
        Project plan node so the operator layer sees it."""
        i = self.idx(col)
        if not isinstance(self.plan, S.Project):
            raise TypeError("with_dict must follow a project()")
        plan = S.Project(self.plan.input, self.plan.exprs, self.plan.names,
                         self.plan.dict_overrides + ((i, d),))
        out = Rel(self.catalog, plan, self.schema, dict(self.dicts))
        out.dicts[i] = d
        return out

    # -- relational operators ----------------------------------------------

    @staticmethod
    def scan(catalog: Catalog, table: str,
             cols: tuple[str, ...] | None = None) -> "Rel":
        t = catalog.get(table)
        names = cols or t.schema.names
        idxs = tuple(t.schema.index(n) for n in names)
        schema = t.schema.select(idxs)
        full = t.dict_by_index()
        dicts = {i: full[ci] for i, ci in enumerate(idxs) if ci in full}
        return Rel(catalog, S.TableScan(table, tuple(names)), schema, dicts)

    def filter(self, pred: ex.Expr) -> "Rel":
        return Rel(self.catalog, S.Filter(self.plan, pred), self.schema,
                   dict(self.dicts))

    def project(self, items: list[tuple[str, ex.Expr]]) -> "Rel":
        names = tuple(n for n, _ in items)
        exprs = tuple(e for _, e in items)
        types = tuple(ex.expr_type(e, self.schema) for e in exprs)
        dicts = {
            i: self.dicts[e.idx]
            for i, (_, e) in enumerate(items)
            if isinstance(e, ex.ColRef) and e.idx in self.dicts
        }
        return Rel(self.catalog, S.Project(self.plan, exprs, names),
                   Schema(names, types), dicts)

    def select(self, *names: str) -> "Rel":
        return self.project([(n, self.c(n)) for n in names])

    def groupby(self, by: list[str],
                aggs: list[tuple]) -> "Rel":
        """aggs: (output name, func, input col name or None) — string_agg
        takes a 4th element, the separator."""
        gcols = tuple(self.idx(n) for n in by)
        specs = tuple(
            agg_ops.AggSpec(
                a[1], None if a[2] is None else self.idx(a[2]), a[0],
                *((a[3],) if len(a) > 3 else ()),
            )
            for a in aggs
        )
        # dense-state path: all keys dictionary-coded with small product
        key_sizes = None
        if gcols and all(i in self.dicts for i in gcols):
            sizes = tuple(len(self.dicts[i]) for i in gcols)
            prod = 1
            for s in sizes:
                prod *= s + 1  # +1 NULL code per column
            # the one-hot dense path does O(rows*G) work: only worth it for
            # genuinely small G (sort path is O(rows log rows) otherwise)
            if 0 < prod <= 256 and all(
                sp.func in ("sum", "count", "count_rows", "min", "max",
                            "avg", "any_not_null")
                for sp in specs
            ):
                key_sizes = sizes
        node = S.Aggregate(self.plan, gcols, specs, key_sizes=key_sizes)
        names = tuple([self.schema.names[i] for i in gcols] +
                      [s[0] for s in aggs])
        types = []
        for i in gcols:
            types.append(self.schema.types[i])
        for a in aggs:
            name, f, cn = a[0], a[1], a[2]
            spec = agg_ops.AggSpec(f, None if cn is None else self.idx(cn), name)
            if f == "avg":
                types.append(FLOAT64)
            else:
                types.append(agg_ops.agg_output_type(spec, self.schema))
        dicts = {
            by.index(self.schema.names[i]): self.dicts[i]
            for i in gcols
            if i in self.dicts
        }
        return Rel(self.catalog, node, Schema(names, tuple(types)), dicts)

    def scalar_agg(self, aggs: list[tuple[str, str, str | None]]) -> "Rel":
        specs = tuple(
            agg_ops.AggSpec(f, None if cn is None else self.idx(cn), name)
            for name, f, cn in aggs
        )
        node = S.ScalarAggregate(self.plan, specs)
        names = tuple(name for name, _, _ in aggs)
        types = tuple(
            FLOAT64 if spec.func == "avg"
            else agg_ops.agg_output_type(spec, self.schema)
            for spec in specs
        )
        return Rel(self.catalog, node, Schema(names, types), {})

    def sort(self, keys: list[tuple[str, bool]]) -> "Rel":
        sk = tuple(sort_ops.SortKey(self.idx(n), desc=d) for n, d in keys)
        return Rel(self.catalog, S.Sort(self.plan, sk), self.schema,
                   dict(self.dicts))

    def limit(self, n: int, offset: int = 0) -> "Rel":
        return Rel(self.catalog, S.Limit(self.plan, n, offset), self.schema,
                   dict(self.dicts))

    def distinct(self, cols: list[str] | None = None) -> "Rel":
        idxs = (tuple(self.idx(n) for n in cols)
                if cols else tuple(range(len(self.schema))))
        schema = self.schema.select(idxs)
        dicts = {
            idxs.index(i): d for i, d in self.dicts.items() if i in idxs
        }
        return Rel(self.catalog, S.Distinct(self.plan, idxs), schema, dicts)

    def join(self, build: "Rel", on: list[tuple[str | int, str | int]],
             how: str = "inner", build_unique: bool = True) -> "Rel":
        """inner | left | semi | anti. `on` pairs accept column names or
        POSITIONS (positions are the only sound reference once self-joins
        duplicate names). Right and full outer joins compose UNION ALL over
        an anti join in the reference; both wait for a later SQL slice."""
        def _pk(r: "Rel", c) -> int:
            return c if isinstance(c, int) else r.idx(c)

        if how in ("right", "full"):
            raise NotImplementedError(
                f"{how} outer joins wait for a later SQL slice of the port "
                "(ROADMAP Queue 1)")
        pkeys = tuple(_pk(self, l) for l, _ in on)
        bkeys = tuple(_pk(build, r) for _, r in on)
        spec = join_ops.JoinSpec(how, build_unique)
        node = S.HashJoin(self.plan, build.plan, pkeys, bkeys, spec)
        if how in ("semi", "anti"):
            schema, dicts = self.schema, dict(self.dicts)
        else:
            schema = self.schema.concat(build.schema)
            dicts = dict(self.dicts)
            off = len(self.schema)
            for i, d in build.dicts.items():
                dicts[off + i] = d
        return Rel(self.catalog, node, schema, dicts)

    # -- execution ----------------------------------------------------------

    def optimized_plan(self) -> S.PlanNode:
        """The plan after the local optimization passes: top-k pushdown
        (plan/topkopt.py). The reference's index selection rewrites only
        scans of KV tables with secondary indexes; the port raises for
        those until its KV slice brings ``kv/table.py`` over."""
        stack = [self.plan]
        while stack:
            node = stack.pop()
            if isinstance(node, S.TableScan) and getattr(
                    self.catalog.get(node.table), "indexes", None):
                raise NotImplementedError(
                    f"table {node.table} has secondary indexes: index "
                    "selection waits for the port's KV slice (ROADMAP "
                    "Queue 1, kv/table.py)")
            for f in node.__dataclass_fields__:
                v = getattr(node, f)
                if isinstance(v, S.PlanNode):
                    stack.append(v)
                elif isinstance(v, tuple):
                    stack.extend(x for x in v if isinstance(x, S.PlanNode))
        return push_topk(self.plan)

    def run(self) -> dict[str, np.ndarray]:
        return run_plan(self.optimized_plan(), self.catalog)
