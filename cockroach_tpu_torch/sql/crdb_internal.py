"""crdb_internal virtual tables — the pkg/sql/crdb_internal.go reduction.

Reference: crdb_internal is a schema of virtual tables materialized on
read (crdb_internal.go:1346 node_statement_statistics, :1588
cluster_queries/cluster_sessions, :1745 node_metrics, :6090 hot_ranges);
every read reflects live registries, nothing is stored.

Here the catalog resolves any unknown ``crdb_internal.<name>`` through
:func:`build`, which materializes a plain :class:`~..catalog.Table` from
the process registries (sqlstats, activity, metric, tracing, range meta).
The binder and the plan builder each resolve the table once per
statement, so materializations are generation-cached: both resolutions
within one statement see the SAME Table object (string dictionary codes
must match between bind-time schema inference and build-time scan).
``begin_statement`` bumps the generation, so every statement gets a fresh
snapshot.

The plan cache never caches plans over these tables (sql/plancache.py
treats the prefix as volatile) — a cached snapshot would freeze time.

The port of ``cockroach_tpu.sql.crdb_internal`` over the registries the
port has: statement statistics, live sessions and queries, the memory
monitor tree, tenant admission, the metric registry, the open trace
spans, the serving load (device figures from ``torch.cuda``), the warm
menu, the changefeed fan-out plane, the materialized views and the range
descriptors with their load (``hot_ranges``: kv/allocator.py's payload,
else the DistSender's Meta). Every reference table is here; a table
listed in ``UNPORTED`` (none now) would raise ``UnportedError`` (a
``BindError``) naming the module it needs.
"""

from __future__ import annotations

import time

import numpy as np

from ..catalog import Table
from ..coldata import types as T

PREFIX = "crdb_internal."

_gen = 0
# (id(catalog), table name) -> (generation, materialized Table)
_cache: dict[tuple[int, str], tuple[int, Table]] = {}


def bump_generation() -> None:
    """New statement: drop cached materializations so the next read sees
    a fresh snapshot (called from binder.begin_statement)."""
    global _gen
    _gen += 1
    _cache.clear()


def _table(name: str, cols: list[tuple[str, object, np.ndarray]]) -> Table:
    names = tuple(c[0] for c in cols)
    types = tuple(c[1] for c in cols)
    raw = {c[0]: c[2] for c in cols}
    return Table.from_strings(name, T.Schema(names, types), raw)


def _strs(vals) -> np.ndarray:
    return np.array([str(v) for v in vals], dtype=object)


def _ints(vals) -> np.ndarray:
    return np.array([int(v) for v in vals], dtype=np.int64)


def _floats(vals) -> np.ndarray:
    return np.array([float(v) for v in vals], dtype=np.float64)


def _stmt_statistics(catalog) -> Table:
    from . import sqlstats

    rows = sqlstats.DEFAULT.all()
    return _table("crdb_internal.node_statement_statistics", [
        ("fingerprint", T.STRING, _strs(r.fingerprint for r in rows)),
        ("count", T.INT64, _ints(r.count for r in rows)),
        ("mean_ms", T.FLOAT64, _floats(r.mean_s * 1e3 for r in rows)),
        ("max_ms", T.FLOAT64, _floats(r.max_s * 1e3 for r in rows)),
        ("p50_ms", T.FLOAT64,
         _floats(r.percentile(0.50) * 1e3 for r in rows)),
        ("p99_ms", T.FLOAT64,
         _floats(r.percentile(0.99) * 1e3 for r in rows)),
        ("rows_returned", T.INT64, _ints(r.rows for r in rows)),
        ("errors", T.INT64, _ints(r.errors for r in rows)),
        ("max_mem_mb", T.FLOAT64,
         _floats(r.max_mem_bytes / (1 << 20) for r in rows)),
        ("mem_p50_mb", T.FLOAT64,
         _floats(r.percentile_mem(0.50) / (1 << 20) for r in rows)),
        ("mem_p99_mb", T.FLOAT64,
         _floats(r.percentile_mem(0.99) / (1 << 20) for r in rows)),
        ("spills", T.INT64, _ints(r.spills for r in rows)),
    ])


def _memory_monitors(catalog) -> Table:
    """The live mon.BytesMonitor tree, depth-first — the reference's
    crdb_internal.node_memory_monitors (crdb_internal.go's monitor walk)."""
    from ..flow import memory

    rows = memory.monitor_rows()
    return _table("crdb_internal.node_memory_monitors", [
        ("name", T.STRING, _strs(r["name"] for r in rows)),
        ("level", T.STRING, _strs(r["level"] for r in rows)),
        ("depth", T.INT64, _ints(r["depth"] for r in rows)),
        ("used_bytes", T.INT64, _ints(r["used"] for r in rows)),
        ("peak_bytes", T.INT64, _ints(r["peak"] for r in rows)),
        ("budget_bytes", T.INT64, _ints(r["budget"] for r in rows)),
        ("spills", T.INT64, _ints(r["spills"] for r in rows)),
    ])


def _cluster_load(catalog) -> Table:
    """One-row serving-load snapshot: sessions and queries in flight, the
    node's SQL memory figures, admission queue state, and the card's
    allocator figures (``flow/memory.device_memory_stats``; 0 off the
    card)."""
    from . import activity
    from ..flow import memory
    from ..storage import blockcache
    from ..utils import admission, metric

    q = admission.sql_queue()
    dev = memory.device_memory_stats()
    cols = {
        "active_sessions": len(activity.sessions()),
        "active_queries": len(activity.queries()),
        "sql_mem_current_bytes": memory.ROOT.used,
        "sql_mem_peak_bytes": memory.ROOT.high_water,
        "sql_mem_budget_bytes": memory.root_budget(),
        "admission_slots": q.slots,
        "admission_slots_in_use": q.in_use,
        "admission_queue_depth": q.queue_depth,
        "admission_admitted": q.admitted,
        "admission_waited": q.waited,
        "admission_timeouts": q.timeouts,
        "device_bytes_in_use": dev.get("bytes_in_use", 0),
        "device_peak_bytes": dev.get("peak_bytes_in_use", 0),
        "queries_total": int(metric.QUERIES.value),
    }
    bc = blockcache.node_cache().stats()
    cols.update({
        "block_cache_hits": bc["hits"],
        "block_cache_misses": bc["misses"],
        "block_cache_evictions": bc["evictions"],
        "block_cache_bytes": bc["bytes"],
        "bloom_skipped_runs": int(metric.BLOOM_SKIPS.value),
        "bulk_ingest_rows": int(metric.INGEST_ROWS.value),
    })
    return _table("crdb_internal.cluster_load", [
        (k, T.INT64, _ints([v])) for k, v in cols.items()
    ])


def _node_tenant_admission(catalog) -> Table:
    """Per-tenant admission state (the tenant rate-limiter / fair-share
    surface): token bucket level + config, stride-scheduler virtual
    time, and admit/reject counters, one row per tenant the queue has
    seen. Shed state and per-lane queue depth ride along so one query
    answers "who is being refused, and why"."""
    from ..utils import admission

    q = admission.sql_queue()
    rows = q.tenant_rows()
    lanes = q.lane_depths()
    floor = admission.shed_floor()
    return _table("crdb_internal.node_tenant_admission", [
        ("tenant_id", T.INT64, _ints(r["tenant_id"] for r in rows)),
        ("tokens", T.FLOAT64, _floats(r["tokens"] for r in rows)),
        ("rate", T.FLOAT64, _floats(r["rate"] for r in rows)),
        ("burst", T.FLOAT64, _floats(r["burst"] for r in rows)),
        ("vtime", T.FLOAT64, _floats(r["vtime"] for r in rows)),
        ("weight", T.FLOAT64, _floats(r["weight"] for r in rows)),
        ("admitted", T.INT64, _ints(r["admitted"] for r in rows)),
        ("rejected", T.INT64, _ints(r["rejected"] for r in rows)),
        ("queue_interactive", T.INT64,
         _ints([lanes.get(admission.LANE_INTERACTIVE, 0)] * len(rows))),
        ("queue_analytical", T.INT64,
         _ints([lanes.get(admission.LANE_ANALYTICAL, 0)] * len(rows))),
        ("shed_floor", T.INT64, _ints([floor] * len(rows))),
    ])


def _cluster_queries(catalog) -> Table:
    from . import activity

    rows = activity.queries()
    return _table("crdb_internal.cluster_queries", [
        ("query_id", T.INT64, _ints(r["id"] for r in rows)),
        ("session_id", T.INT64, _ints(r["session_id"] for r in rows)),
        ("query", T.STRING, _strs(r["query"] for r in rows)),
        ("phase", T.STRING, _strs(r["phase"] for r in rows)),
        ("elapsed_ms", T.FLOAT64,
         _floats(r["elapsed_s"] * 1e3 for r in rows)),
    ])


def _cluster_sessions(catalog) -> Table:
    from . import activity

    rows = activity.sessions()
    return _table("crdb_internal.cluster_sessions", [
        ("session_id", T.INT64, _ints(r["id"] for r in rows)),
        ("application_name", T.STRING,
         _strs(r["application_name"] for r in rows)),
        ("active_queries", T.INT64, _ints(r["active"] for r in rows)),
        ("session_age_s", T.FLOAT64,
         _floats(r["session_age_s"] for r in rows)),
    ])


def _node_metrics(catalog) -> Table:
    from ..utils import metric

    names: list[str] = []
    values: list[float] = []
    for name, m in list(metric.DEFAULT._metrics.items()):
        if isinstance(m, (metric.Counter, metric.Gauge)):
            names.append(name)
            values.append(m.value)
        elif isinstance(m, metric.Histogram):
            names.append(name + "_sum")
            values.append(m.sum)
            names.append(name + "_count")
            values.append(float(m.n))
        elif isinstance(m, metric.LabeledCounter):
            for k, v in m.items():
                names.append(f'{name}{{{m.label}="{k}"}}')
                values.append(v)
    return _table("crdb_internal.node_metrics", [
        ("name", T.STRING, _strs(names)),
        ("value", T.FLOAT64, _floats(values)),
    ])


def _inflight_trace_spans(catalog) -> Table:
    from ..utils import tracing

    spans = tracing.inflight()
    now = time.perf_counter()
    return _table("crdb_internal.node_inflight_trace_spans", [
        ("trace_id", T.INT64, _ints(s.trace_id for s in spans)),
        ("span_id", T.INT64, _ints(s.span_id for s in spans)),
        ("parent_span_id", T.INT64, _ints(s.parent_id for s in spans)),
        ("operation", T.STRING, _strs(s.name for s in spans)),
        ("elapsed_ms", T.FLOAT64,
         _floats((now - s.start) * 1e3 for s in spans)),
    ])


def _hot_ranges_payload(catalog) -> list[dict]:
    """The /_status/hot_ranges row shape, sourced from whatever range
    infrastructure the session's environment carries: a stashed Node's
    RangeLifecycle, else the engine's meta descriptor table, else empty
    (single-range standalone sessions legitimately have no ranges)."""
    node = getattr(catalog, "_crdb_node", None)
    ranger = getattr(node, "ranger", None) if node is not None else None
    if ranger is not None:
        return ranger.hot_ranges().get("hotRanges", [])
    db = getattr(catalog, "_crdb_db", None)
    eng = getattr(db, "engine", None) if db is not None else None
    meta = getattr(eng, "meta", None) if eng is not None else None
    if meta is None:
        return []
    return [{"rangeId": d.range_id,
             "startKey": d.start_key.decode(errors="replace"),
             "endKey": (d.end_key.decode(errors="replace")
                        if d.end_key is not None else None),
             "storeId": d.store_id, "qps": 0.0, "writeBytesRate": 0.0,
             "sizeBytes": None, "leaseholder": None}
            for d in meta.snapshot()]


def _hot_ranges(catalog) -> Table:
    rows = _hot_ranges_payload(catalog)
    return _table("crdb_internal.hot_ranges", [
        ("range_id", T.INT64, _ints(r.get("rangeId", 0) for r in rows)),
        ("start_key", T.STRING, _strs(r.get("startKey", "") for r in rows)),
        ("end_key", T.STRING,
         _strs(r.get("endKey") or "" for r in rows)),
        ("store_id", T.INT64, _ints(r.get("storeId") or 0 for r in rows)),
        ("qps", T.FLOAT64, _floats(r.get("qps") or 0.0 for r in rows)),
        ("write_bytes_rate", T.FLOAT64,
         _floats(r.get("writeBytesRate") or 0.0 for r in rows)),
        ("size_bytes", T.INT64,
         _ints(r.get("sizeBytes") or 0 for r in rows)),
        ("leaseholder", T.INT64,
         _ints(r.get("leaseholder") or 0 for r in rows)),
    ])


def _node_warmup_menu(catalog) -> Table:
    """The warm menu's state (sql/warmmenu.py): one row per item with its
    course (explicit/hot/ladder), outcome (compiled/failed/skipped), new
    signatures, seconds, and serving-path hits."""
    from . import warmmenu

    rows = warmmenu.menu_rows()
    return _table("crdb_internal.node_warmup_menu", [
        ("fingerprint", T.STRING, _strs(r["fingerprint"] for r in rows)),
        ("source", T.STRING, _strs(r["source"] for r in rows)),
        ("status", T.STRING, _strs(r["status"] for r in rows)),
        ("kernels", T.INT64, _ints(r["kernels"] for r in rows)),
        ("seconds", T.FLOAT64, _floats(r["seconds"] for r in rows)),
        ("hits", T.INT64, _ints(r["hits"] for r in rows)),
    ])


def _node_changefeed_subscribers(catalog) -> Table:
    """Per-registration fan-out state (the changefeed observability
    surface): span, resolved frontier, buffered bytes/events, and the
    backpressure-ladder counters (coalesced, sheds), one row per live
    subscriber across every rangefeed hub on this node — so one query
    answers "who is behind, by how much, and what has the ladder already
    done about it"."""
    from ..kv import fanout

    rows = fanout.subscriber_rows()
    return _table("crdb_internal.node_changefeed_subscribers", [
        ("hub", T.STRING, _strs(r["hub"] for r in rows)),
        ("subscriber_id", T.INT64, _ints(r["subscriber_id"] for r in rows)),
        ("state", T.STRING, _strs(r["state"] for r in rows)),
        ("span_start", T.STRING, _strs(r["span_start"] for r in rows)),
        ("span_end", T.STRING, _strs(r["span_end"] for r in rows)),
        ("frontier", T.INT64, _ints(r["frontier"] for r in rows)),
        ("buffered_bytes", T.INT64,
         _ints(r["buffered_bytes"] for r in rows)),
        ("buffered_events", T.INT64,
         _ints(r["buffered_events"] for r in rows)),
        ("sent_events", T.INT64, _ints(r["sent_events"] for r in rows)),
        ("coalesced", T.INT64, _ints(r["coalesced"] for r in rows)),
        ("sheds", T.INT64, _ints(r["sheds"] for r in rows)),
        ("age_s", T.FLOAT64, _floats(r["age_s"] for r in rows)),
    ])


def _node_materialized_views(catalog) -> Table:
    """Per-view standing state (the incremental-matview observability
    surface): group count, resolved frontier, last refresh lag, and the
    two fallback counters — min/max retraction rescans (delta algebra
    couldn't answer) and full rebuilds (group key outgrew the dense
    layout) — one row per registered view on this catalog."""
    from . import matview

    reg = matview.registry_for(catalog)
    rows = reg.rows() if reg is not None else []
    return _table("crdb_internal.node_materialized_views", [
        ("view", T.STRING, _strs(r["view"] for r in rows)),
        ("base_table", T.STRING, _strs(r["base_table"] for r in rows)),
        ("groups", T.INT64, _ints(r["groups"] for r in rows)),
        ("frontier", T.INT64, _ints(r["frontier"] for r in rows)),
        ("refresh_lag_s", T.FLOAT64,
         _floats(r["refresh_lag_s"] for r in rows)),
        ("minmax_rescans", T.INT64,
         _ints(r["minmax_rescans"] for r in rows)),
        ("full_rescans", T.INT64, _ints(r["full_rescans"] for r in rows)),
        ("stale", T.STRING, _strs(r["stale"] for r in rows)),
    ])


_BUILDERS = {
    "crdb_internal.node_statement_statistics": _stmt_statistics,
    "crdb_internal.cluster_queries": _cluster_queries,
    "crdb_internal.cluster_sessions": _cluster_sessions,
    "crdb_internal.node_metrics": _node_metrics,
    "crdb_internal.node_inflight_trace_spans": _inflight_trace_spans,
    "crdb_internal.hot_ranges": _hot_ranges,
    "crdb_internal.node_memory_monitors": _memory_monitors,
    "crdb_internal.cluster_load": _cluster_load,
    "crdb_internal.node_tenant_admission": _node_tenant_admission,
    "crdb_internal.node_warmup_menu": _node_warmup_menu,
    "crdb_internal.node_changefeed_subscribers":
        _node_changefeed_subscribers,
    "crdb_internal.node_materialized_views": _node_materialized_views,
}

# the reference's tables whose registries live in modules not yet ported
# (name -> module); empty since kv/loadstats.py and kv/allocator.py came
UNPORTED: dict[str, str] = {}


def is_virtual(name: str) -> bool:
    return name.startswith(PREFIX)


def build(catalog, name: str) -> Table:
    """Materialize (or return this statement's cached materialization of)
    one virtual table on the catalog's device. Raises KeyError for
    unknown names (the binder's unknown-table error) and BindError for a
    table whose module is not ported."""
    builder = _BUILDERS.get(name)
    if builder is None:
        if name in UNPORTED:
            from .binder import UnportedError

            raise UnportedError(name, UNPORTED[name])
        raise KeyError(name)
    key = (id(catalog), name)
    hit = _cache.get(key)
    if hit is not None and hit[0] == _gen:
        return hit[1]
    t = builder(catalog)
    t.device = catalog.device
    _cache[key] = (_gen, t)
    return t
