"""Metrics — the counters, gauges and histograms the storage engine, the
memory monitors and the external operators bump (names as in
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
