"""SQL front end: parser (pkg/sql/parser analog), binder (optbuilder
analog), the Rel fluent plan builder and the Session; the port of
``cockroach_tpu.sql``. ``sql(catalog, text)`` parses and binds a SELECT
into an executable Rel."""

from .binder import BindError, UnportedError, sql
from .rel import Rel
from .session import Session


def explain(catalog, text: str, session=None) -> str:
    """EXPLAIN / EXPLAIN ANALYZE [(DEBUG)] / EXPLAIN (DISTSQL) over SQL
    text, with or without the leading EXPLAIN keywords. ANALYZE (DEBUG)
    also captures a statement diagnostics bundle (sql/diagnostics.py)
    and names it on the last line; `session`, when given, lends the
    bundle its fingerprint and memory monitor."""
    import time as _time

    t = text.strip()
    low = t.lower()
    analyze = False
    distsql = False
    debug = False
    if low.startswith("explain"):
        t = t[len("explain"):].lstrip()
        if t.lower().startswith("(distsql)"):
            distsql = True
            t = t[len("(distsql)"):].lstrip()
        if t.lower().startswith("analyze"):
            analyze = True
            t = t[len("analyze"):].lstrip()
            if t.lower().startswith("(debug)"):
                debug = True
                t = t[len("(debug)"):].lstrip()
    rel = sql(catalog, t)
    from . import matview

    note = matview.explain_note(catalog, rel)
    prefix = (note + "\n") if note else ""
    if distsql:
        return prefix + rel.explain_distributed()
    if analyze:
        from . import plancache
        from ..storage import blockcache
        from ..utils import admission

        t0 = _time.perf_counter()
        rendered, _ = rel.explain_analyze()
        elapsed = _time.perf_counter() - t0
        # status a normal execution of this statement would see
        # (analyze itself always runs a fresh instrumented tree)
        out = (prefix + rendered
               + f"\nplan cache: {plancache.probe(rel)}")
        out += f"\nblock cache: {blockcache.node_cache().describe()}"
        aq = admission.sql_queue()
        pri = admission.classify_statement(t)
        lanes = aq.lane_depths()
        out += (f"\nadmission: lane={admission.lane_for(pri)} "
                f"slots={aq.in_use}/{aq.slots} "
                f"queued={lanes[admission.LANE_INTERACTIVE]}i"
                f"+{lanes[admission.LANE_ANALYTICAL]}a "
                f"shed_floor={admission.shed_floor()} "
                f"rejected={aq.rejected}")
        if debug:
            from types import SimpleNamespace

            from . import diagnostics
            from ..flow.runtime import last_trace_span

            bundle = diagnostics.capture(
                session or SimpleNamespace(catalog=catalog), t,
                elapsed_s=elapsed, span=last_trace_span(),
                trigger="explain_analyze_debug")
            out += f"\ndiagnostics bundle: {bundle['id']}"
        return out
    return prefix + rel.explain()


__all__ = ["BindError", "Rel", "Session", "UnportedError", "explain",
           "sql"]
