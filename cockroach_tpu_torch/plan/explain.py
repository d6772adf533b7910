"""EXPLAIN / EXPLAIN ANALYZE — plan pretty-printing and ComponentStats
folding; the port of ``cockroach_tpu.plan.explain``.

EXPLAIN renders the plan tree, each node tagged with the fused pipeline
it collapses into (flow/fuse.plan_fusion_groups); EXPLAIN ANALYZE runs
the query with per-operator ComponentStats collection
(flow/runtime.run_plan_with_stats) and folds the stats into the rendered
tree. The operator tree mirrors the plan tree one to one once the fusion
wrappers are seen through (flow/fuse.unwrap), so stats attach directly to
plan lines. The text is the reference's, line for line.
"""

from __future__ import annotations

from . import spec as S


def _node_label(n: S.PlanNode) -> str:
    if isinstance(n, S.TableScan):
        cols = f" columns={list(n.columns)}" if n.columns else ""
        return f"scan {n.table}{cols}"
    if isinstance(n, S.IndexScan):
        lo = "-inf" if n.lo is None else n.lo
        hi = "+inf" if n.hi is None else n.hi
        return f"index-scan {n.table}@{n.index} [{lo}, {hi}]"
    if isinstance(n, S.Filter):
        return f"filter {n.predicate}"
    if isinstance(n, S.Project):
        return f"project {list(n.names)}"
    if isinstance(n, S.Aggregate):
        aggs = [f"{a.func}({a.col if a.col is not None else '*'})"
                for a in n.aggs]
        mode = f" mode={n.mode}" if n.mode != "complete" else ""
        dense = " dense" if n.key_sizes else ""
        return f"group-by keys={list(n.group_cols)} aggs={aggs}{mode}{dense}"
    if isinstance(n, S.ScalarAggregate):
        aggs = [f"{a.func}({a.col if a.col is not None else '*'})"
                for a in n.aggs]
        return f"scalar-group-by aggs={aggs}"
    if isinstance(n, S.HashJoin):
        u = " (unique build)" if n.spec.build_unique else ""
        return (f"hash-join ({n.spec.join_type}) "
                f"probe={list(n.probe_keys)} build={list(n.build_keys)}{u}")
    if isinstance(n, S.Sort):
        keys = [f"{k.col}{' desc' if k.desc else ''}" for k in n.keys]
        return f"sort keys={keys}"
    if isinstance(n, S.Limit):
        off = f" offset={n.offset}" if n.offset else ""
        return f"limit {n.limit}{off}"
    if isinstance(n, S.TopK):
        keys = [f"{k.col}{' desc' if k.desc else ''}" for k in n.keys]
        return f"top-k k={n.k} keys={keys}"
    if isinstance(n, S.Distinct):
        return f"distinct on={list(n.cols) if n.cols else 'all'}"
    if isinstance(n, S.Exchange):
        return f"exchange (all-to-all) keys={list(n.keys)}"
    if isinstance(n, S.Union):
        return f"union-all ({len(n.inputs)} inputs)"
    if isinstance(n, S.Broadcast):
        return "broadcast (all-gather)"
    if isinstance(n, S.Gather):
        return "gather (all-gather)"
    if isinstance(n, S.MergeJoin):
        return (f"merge-join ({n.spec.join_type}) "
                f"probe={n.probe_key} build={n.build_key}")
    if isinstance(n, S.Window):
        fns = [s.func for s in n.specs]
        return (f"window {fns} partition={list(n.partition_cols)} "
                f"order={[k.col for k in n.order_keys]}")
    return type(n).__name__


def _children(n: S.PlanNode) -> list[S.PlanNode]:
    if isinstance(n, (S.HashJoin, S.MergeJoin)):
        return [n.probe, n.build]
    if isinstance(n, S.Union):
        return list(n.inputs)
    if hasattr(n, "input"):
        return [n.input]
    return []


def _fusion_groups(plan: S.PlanNode) -> dict[int, int]:
    """id(plan node) -> fused pipeline group (empty when fusion is off).
    Members of one group collapse into a single per-tile kernel at
    execution (flow/fuse.py + the spool fusion in flow/operators.py)."""
    from ..utils import settings

    if not settings.get("sql.distsql.fusion.enabled"):
        return {}
    from ..flow.fuse import plan_fusion_groups

    return plan_fusion_groups(plan)


def _group_tag(groups: dict[int, int], n: S.PlanNode) -> str:
    g = groups.get(id(n))
    return f"  [pipeline {g}]" if g is not None else ""


def explain_plan(plan: S.PlanNode) -> str:
    """Render the plan tree (EXPLAIN)."""
    lines: list[str] = []
    groups = _fusion_groups(plan)

    def walk(n: S.PlanNode, depth: int):
        lines.append(
            "  " * depth + "-> " + _node_label(n) + _group_tag(groups, n))
        for c in _children(n):
            walk(c, depth + 1)

    walk(plan, 0)
    return "\n".join(lines)


def _fmt_bytes(n: int) -> str:
    """Human byte figure for EXPLAIN ANALYZE memory lines (KiB below one
    MiB, else MiB — mirroring the reference's humanizeutil sizes)."""
    n = int(n)
    if n < 1 << 20:
        return f"{n / 1024:.1f} KiB"
    return f"{n / (1 << 20):.1f} MiB"


def explain_analyze(plan: S.PlanNode, root_op) -> str:
    """Render the plan tree with executed ComponentStats (EXPLAIN ANALYZE).
    `root_op` must have been run with collect_stats(True)."""
    from ..flow.fuse import unwrap

    lines: list[str] = []
    groups = _fusion_groups(plan)

    def walk(n: S.PlanNode, op, depth: int):
        if isinstance(n, S.Exchange):
            # single-device builds elide the exchange operator
            walk(n.input, op, depth)
            return
        # fusion-pass wrappers sit between plan nodes; see through them so
        # the plan-node/operator walk stays one-to-one
        op = unwrap(op)
        st = op.stats
        excl = st.exclusive(op.children())
        # memory-account annotations (mon.BoundAccount high-water): only
        # buffering operators open accounts, so most lines carry neither
        mem = (f" max mem={_fmt_bytes(st.max_mem_bytes)}"
               if getattr(st, "max_mem_bytes", 0) else "")
        spill = " spilled" if getattr(st, "spilled", False) else ""
        lines.append(
            "  " * depth + "-> " + _node_label(n)
            + f"  [rows={st.rows} batches={st.batches} "
            f"bytes={st.bytes} "
            f"time={st.time_s*1e3:.1f}ms self={excl*1e3:.1f}ms{mem}{spill}]"
            + _group_tag(groups, n)
        )
        for c, co in zip(_children(n), op.children()):
            walk(c, co, depth + 1)

    walk(plan, root_op, 0)
    # span tree from the traced run (flow/runtime.py attaches it); the
    # plan tree keeps its root on line 1 and the dispatch footer its last
    # two lines (consumers parse both)
    tsp = getattr(root_op, "_trace_span", None)
    if tsp is not None:
        lines.append("trace:")
        lines.append(tsp.tree(indent=1))
    # query peak-memory footer (the query monitor's high water, set by
    # flow/runtime.py) BEFORE the dispatch lines, which stay last
    peak = getattr(root_op, "_query_mem_peak", 0)
    if peak:
        lines.append(f"query peak memory: {_fmt_bytes(peak)}")
    kd = getattr(getattr(root_op, "stats", None), "kernel_dispatches", 0)
    if kd:
        lines.append(f"kernel dispatches: {kd}")
        kc = getattr(root_op.stats, "kernel_compiles", 0)
        lines.append(f"kernel compiles: {kc} (cached: {kd - kc})")
    return "\n".join(lines)
