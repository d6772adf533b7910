"""Metrics — the counters, gauges and histograms the storage engine, the
memory monitors, the external operators and the SQL front door bump (names as in
``cockroach_tpu.utils.metric``)."""

from __future__ import annotations

import bisect
import threading


class Counter:
    """Monotonically increasing value."""

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, delta: float = 1.0) -> None:
        with self._lock:
            self._value += delta

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Set-to-current value."""

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram."""

    def __init__(self, name: str, buckets: tuple[float, ...]):
        self.name = name
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.n = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.counts[bisect.bisect_left(self.buckets, v)] += 1
            self.n += 1
            self.sum += v

    def observe_many(self, vs: list) -> None:
        """``observe`` of each value, under one acquisition of the lock."""
        with self._lock:
            for v in vs:
                self.counts[bisect.bisect_left(self.buckets, v)] += 1
                self.sum += v
            self.n += len(vs)


class LabeledCounter:
    """Counter family keyed by one label: a child Counter per observed
    label value."""

    def __init__(self, name: str, label: str):
        self.name = name
        self.label = label
        self._children: dict[str, Counter] = {}
        self._lock = threading.Lock()

    def child(self, label_value) -> Counter:
        key = str(label_value)
        with self._lock:
            c = self._children.get(key)
            if c is None:
                c = self._children[key] = Counter(self.name)
            return c

    def inc(self, label_value, delta: float = 1.0) -> None:
        self.child(label_value).inc(delta)

    def value(self, label_value) -> float:
        return self.child(label_value).value

    def items(self) -> list[tuple[str, float]]:
        with self._lock:
            return sorted((k, c.value) for k, c in self._children.items())


class LabeledGauge:
    """Gauge family keyed by one label: a child Gauge per observed label
    value."""

    def __init__(self, name: str, label: str):
        self.name = name
        self.label = label
        self._children: dict[str, Gauge] = {}
        self._lock = threading.Lock()

    def child(self, label_value) -> Gauge:
        key = str(label_value)
        with self._lock:
            g = self._children.get(key)
            if g is None:
                g = self._children[key] = Gauge(self.name)
            return g

    def set(self, label_value, v: float) -> None:
        self.child(label_value).set(v)

    def value(self, label_value) -> float:
        return self.child(label_value).value

    def items(self) -> list[tuple[str, float]]:
        with self._lock:
            return sorted((k, g.value) for k, g in self._children.items())


ENGINE_FLUSHES = Counter("storage_flushes")
ENGINE_COMPACTIONS = Counter("storage_compactions")
ENGINE_INGESTS = Counter("storage_ingests")
ENGINE_WRITES = Counter("storage_writes")
ENGINE_SCANS = Counter("storage_scans")
ENGINE_RUNS = Gauge("storage_runs")
BLOOM_SKIPS = Counter("storage_bloom_skips")
BLOOM_CORRUPTIONS = Counter("storage_bloom_corruptions")
BLOCKCACHE_HITS = Counter("storage_blockcache_hits")
BLOCKCACHE_MISSES = Counter("storage_blockcache_misses")
BLOCKCACHE_EVICTIONS = Counter("storage_blockcache_evictions")
BLOCKCACHE_BYTES = Gauge("storage_blockcache_bytes")
INGEST_ROWS = Counter("storage_ingest_rows")
INGEST_BYTES = Counter("storage_ingest_bytes")
COMPACTION_PACING_DELAY = Histogram(
    "storage_compaction_pacing_delay_seconds",
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0))
FAULTS_INJECTED = Counter("faults_injected")
SQL_MEM_CURRENT = Gauge("sql_mem_current")
SQL_MEM_MAX = Gauge("sql_mem_max")
SQL_MEM_QUERY_PEAK = Histogram(
    "sql_mem_query_peak_bytes",
    buckets=(1 << 12, 1 << 16, 1 << 20, 1 << 22, 1 << 24, 1 << 26,
             1 << 28, 1 << 30, 1 << 32, 1 << 34))
SQL_MEM_QUERY_LEAKS = Counter("sql_mem_query_leaks")
# aggregations spilled to the host-staged Grace partitions
EXTERNAL_AGG_SPILLS = Counter("sql_external_agg_spills")
# sorts past workmem, spilled to the range-partitioned external sort
EXTERNAL_SORT_SPILLS = Counter("sql_external_sort_spills")
# hash joins whose build side passed workmem_bytes (Grace hash join)
GRACE_JOIN_SPILLS = Counter("sql_grace_join_spills")
# Grace partitions whose build side alone passed workmem (merge runs)
GRACE_JOIN_MERGE_PARTS = Counter("sql_grace_join_merge_parts")
# probe rows routed through the resident heavy-hitter build table
GRACE_JOIN_SKEW_ROUTED = Counter("sql_grace_join_skew_rows")
# KV transactions, the contention registry and the disk monitor
TXN_COMMITS = Counter("txn_commits")
TXN_RETRIES = Counter("txn_retries")
CONTENTION_RECORD_ERRORS = Counter("contention_record_errors")
DISK_WRITE_P99 = Gauge("storage_disk_write_p99_ms")
DISK_SLOW = Gauge("storage_disk_slow")
DISK_PROBES = Counter("storage_disk_probes")
# the SQL front door: pgwire, the plan cache and admission
PG_CONNS = Counter("pgwire_conns")
PLAN_CACHE_HITS = Counter("sql_plan_cache_hits")
PLAN_CACHE_MISSES = Counter("sql_plan_cache_misses")
PLAN_CACHE_EVICTIONS = Counter("sql_plan_cache_evictions")
ADMISSION_SQL_SLOTS = Gauge("admission_sql_slots")
ADMISSION_SQL_SLOTS_IN_USE = Gauge("admission_sql_slots_in_use")
ADMISSION_SQL_QUEUE_DEPTH = Gauge("admission_sql_queue_depth")
ADMISSION_WAIT_SECONDS = Histogram(
    "admission_wait_seconds",
    buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5,
             10, 60))
ADMISSION_SQL_TIMEOUTS = Counter("admission_sql_timeouts")
# the wait of each query for the device (flow/dispatch.exec_lock)
EXEC_LOCK_WAIT_SECONDS = Histogram(
    "sql_exec_lock_wait_seconds",
    buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5,
             10, 60))
ADMISSION_LANE_QUEUE_DEPTH = LabeledGauge("admission_lane_queue_depth",
                                          "lane")
ADMISSION_TENANT_TOKENS = LabeledGauge("admission_tenant_tokens", "tenant")
ADMISSION_REJECTIONS = LabeledCounter("admission_rejections", "tenant")
# queries executed by flow/runtime.run_operator
QUERIES = Counter("sql_queries")
# the warm menu (sql/warmmenu.py): signatures its items made (CUDA graph
# captures on the card), and serving-path plan-cache hits on its items
SQL_WARMUP_KERNELS_COMPILED = Counter("sql_warmup_kernels_compiled")
SQL_WARMUP_MENU_HITS = Counter("sql_warmup_menu_hits")
# the changefeed fan-out plane (kv/fanout.py): registrations, frames
# delivered, the backpressure ladder's rungs (coalesced events, sheds to
# a catch-up scan, evictions), buffered bytes and per-event send lag
_LAG_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                10.0, 30.0)
CHANGEFEED_SUBSCRIBERS = Gauge("changefeed_subscribers")
CHANGEFEED_EVENTS_EMITTED = Counter("changefeed_events_emitted")
CHANGEFEED_EVENTS_COALESCED = Counter("changefeed_events_coalesced")
CHANGEFEED_SHEDS = Counter("changefeed_sheds")
CHANGEFEED_EVICTIONS = Counter("changefeed_evictions")
CHANGEFEED_BUFFER_BYTES = Gauge("changefeed_buffer_bytes")
CHANGEFEED_SEND_LAG_SECONDS = Histogram("changefeed_send_lag_seconds",
                                        buckets=_LAG_BUCKETS)
# materialized views (sql/matview.py, flow/viewmaint.py): registered
# views, flushes, delta events applied, rescans (initial population and
# out-of-bounds rebuilds; min/max retractions), rewrite hits and the age
# of the oldest buffered event when its flush lands
MATVIEW_VIEWS = Gauge("matview_views")
MATVIEW_FLUSHES = Counter("matview_flushes")
MATVIEW_DELTA_EVENTS = Counter("matview_delta_events")
MATVIEW_FULL_RESCANS = Counter("matview_full_rescans")
MATVIEW_MINMAX_RESCANS = Counter("matview_minmax_rescans")
MATVIEW_REWRITE_HITS = Counter("matview_rewrite_hits")
MATVIEW_REFRESH_LAG_SECONDS = Histogram("matview_refresh_lag_seconds",
                                        buckets=_LAG_BUCKETS)


class Registry:
    """The named metrics of the process (the reference's metric.Registry,
    reduced to what crdb_internal.node_metrics reads)."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def add(self, m):
        self._metrics[m.name] = m
        return m


DEFAULT = Registry()
for _m in list(globals().values()):
    if isinstance(_m, (Counter, Gauge, Histogram, LabeledCounter,
                       LabeledGauge)):
        DEFAULT.add(_m)
del _m
