"""SQL front end: parser (pkg/sql/parser analog), binder (optbuilder
analog), the Rel fluent plan builder and the Session; the port of
``cockroach_tpu.sql``. ``sql(catalog, text)`` parses and binds a SELECT
into an executable Rel."""

from .binder import BindError, sql
from .rel import Rel
from .session import Session, UnportedError


def explain(catalog, text: str) -> str:
    """EXPLAIN / EXPLAIN ANALYZE / EXPLAIN (DISTSQL) over SQL text, with
    or without the leading EXPLAIN keywords. EXPLAIN ANALYZE (DEBUG),
    which captures a statement diagnostics bundle in the reference,
    raises UnportedError: sql/diagnostics.py is not ported."""
    t = text.strip()
    low = t.lower()
    analyze = False
    distsql = False
    if low.startswith("explain"):
        t = t[len("explain"):].lstrip()
        if t.lower().startswith("(distsql)"):
            distsql = True
            t = t[len("(distsql)"):].lstrip()
        if t.lower().startswith("analyze"):
            analyze = True
            t = t[len("analyze"):].lstrip()
            if t.lower().startswith("(debug)"):
                raise UnportedError("EXPLAIN ANALYZE (DEBUG)",
                                    "sql/diagnostics.py")
    rel = sql(catalog, t)
    if distsql:
        return rel.explain_distributed()
    if analyze:
        from . import plancache
        from ..storage import blockcache
        from ..utils import admission

        rendered, _ = rel.explain_analyze()
        # status a normal execution of this statement would see
        # (analyze itself always runs a fresh instrumented tree)
        out = rendered + f"\nplan cache: {plancache.probe(rel)}"
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
        return out
    return rel.explain()


__all__ = ["BindError", "Rel", "Session", "UnportedError", "explain",
           "sql"]
