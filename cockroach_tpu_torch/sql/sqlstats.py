"""SQL statement statistics — the pkg/sql/sqlstats reduction.

Reference: every executed statement is fingerprinted (literals stripped),
and per-fingerprint execution counts, latency moments and row counts
accumulate in an in-memory container surfaced through
crdb_internal.statement_statistics and the console's SQL activity page.

Reduction: a per-Session (or shared) registry keyed by statement
fingerprint with count / total / min / max / mean latency and rows
returned, surfaced through ``SHOW STATEMENTS`` in the session and the
``/_status/statements`` admin endpoint. Fingerprinting lowercases
whitespace-normalized SQL and replaces literals with placeholders — the
reference's constants-removed shape.

A copy of ``cockroach_tpu.sql.sqlstats``."""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from ..utils import locks

_NUM = re.compile(r"\b\d+(?:\.\d+)?\b")
_STR = re.compile(r"'(?:[^']|'')*'")
_WS = re.compile(r"\s+")
# collapse IN/VALUES lists so differing row counts share a fingerprint
_TUPLES = re.compile(r"\(\s*_(?:\s*,\s*_)*\s*\)(?:\s*,\s*\(\s*_(?:\s*,\s*_)*\s*\))*")


def fingerprint(sql: str) -> str:
    """Literals -> '_', whitespace-normalized, lowercased (the
    reference's statement fingerprint shape)."""
    s = _STR.sub("_", sql.strip().rstrip(";"))
    s = _NUM.sub("_", s)
    s = _WS.sub(" ", s).lower()
    s = _TUPLES.sub("(_)", s)
    return s


# fixed log-scale latency buckets: 0.1ms doubling to ~52s; observations
# past the last edge land in the overflow slot. Fixed — not adaptive — so
# percentiles from two snapshots are comparable.
_LAT_BUCKETS: tuple[float, ...] = tuple(0.0001 * 2 ** i for i in range(20))

# fixed log-scale peak-memory buckets: 4 KiB doubling to 8 GiB — the
# per-fingerprint resource twin of the latency histogram, so statement
# pages can show p50/p99 peak HBM next to p50/p99 latency
_MEM_BUCKETS: tuple[float, ...] = tuple(float(4096 * 2 ** i)
                                        for i in range(22))


@dataclass
class StmtStats:
    fingerprint: str
    count: int = 0
    total_s: float = 0.0
    min_s: float = field(default=float("inf"))
    max_s: float = 0.0
    rows: int = 0
    errors: int = 0
    hist: list[int] = field(
        default_factory=lambda: [0] * (len(_LAT_BUCKETS) + 1))
    # query peak-memory accounting (monitor-tree high water per execution);
    # mem_count tracks executions that reported a peak (older recordings
    # and error paths may not), so percentiles stay truthful
    max_mem_bytes: int = 0
    spills: int = 0
    mem_count: int = 0
    mem_hist: list[int] = field(
        default_factory=lambda: [0] * (len(_MEM_BUCKETS) + 1))

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def observe(self, elapsed_s: float) -> None:
        import bisect

        self.hist[bisect.bisect_left(_LAT_BUCKETS, elapsed_s)] += 1

    def observe_mem(self, peak_bytes: int) -> None:
        import bisect

        self.mem_count += 1
        self.max_mem_bytes = max(self.max_mem_bytes, int(peak_bytes))
        self.mem_hist[bisect.bisect_left(_MEM_BUCKETS,
                                         float(peak_bytes))] += 1

    def percentile(self, q: float) -> float:
        """Latency quantile in seconds from the bucket counts (upper bucket
        edge — the prometheus histogram_quantile convention, clamped to the
        observed max)."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.hist):
            seen += c
            if seen >= target:
                edge = (_LAT_BUCKETS[i] if i < len(_LAT_BUCKETS)
                        else self.max_s)
                return min(edge, self.max_s)
        return self.max_s

    def percentile_mem(self, q: float) -> float:
        """Peak-memory quantile in bytes (same convention as
        :meth:`percentile`, clamped to the observed max peak)."""
        if not self.mem_count:
            return 0.0
        target = q * self.mem_count
        seen = 0
        for i, c in enumerate(self.mem_hist):
            seen += c
            if seen >= target:
                edge = (_MEM_BUCKETS[i] if i < len(_MEM_BUCKETS)
                        else float(self.max_mem_bytes))
                return min(edge, float(self.max_mem_bytes))
        return float(self.max_mem_bytes)


class StatsRegistry:
    """Thread-safe per-fingerprint accumulation, capped like the
    reference's fingerprint memory budget: past `max_fingerprints`
    distinct entries, the cheapest half (by total time) is evicted —
    unbounded junk SQL over pgwire must not leak memory forever."""

    def __init__(self, max_fingerprints: int = 5000):
        self._lock = locks.lock("sql.stats")
        self._stats: dict[str, StmtStats] = {}
        self.max_fingerprints = max_fingerprints
        self.evicted = 0

    def record(self, sql: str, elapsed_s: float, rows: int,
               error: bool = False, fp: str | None = None,
               mem_bytes: int = 0, spills: int = 0) -> None:
        """Accumulate one execution. ``fp`` lets the plan cache supply the
        structural fingerprint of the entry that served the statement (its
        literal re-parameterization already proved `a=1` and `a=2` the
        same plan), collapsing textual variants the regex would split.
        ``mem_bytes`` is the execution's query-monitor peak (0 = the run
        reported none, e.g. a settings statement); ``spills`` the number
        of in-memory operators that swapped to external variants."""
        if fp is None:
            fp = fingerprint(sql)
        with self._lock:
            st = self._stats.get(fp)
            if st is None:
                if len(self._stats) >= self.max_fingerprints:
                    keep = sorted(self._stats.values(),
                                  key=lambda s: -s.total_s)
                    keep = keep[: self.max_fingerprints // 2]
                    self.evicted += len(self._stats) - len(keep)
                    self._stats = {s.fingerprint: s for s in keep}
                st = self._stats[fp] = StmtStats(fp)
            st.count += 1
            st.total_s += elapsed_s
            st.min_s = min(st.min_s, elapsed_s)
            st.max_s = max(st.max_s, elapsed_s)
            st.rows += rows
            st.observe(elapsed_s)
            if mem_bytes > 0:
                st.observe_mem(mem_bytes)
            st.spills += int(spills)
            if error:
                st.errors += 1

    def all(self) -> list[StmtStats]:
        """Snapshot COPIES (consistent under concurrent record())."""
        import dataclasses

        with self._lock:
            return sorted(
                (dataclasses.replace(s, hist=list(s.hist),
                                     mem_hist=list(s.mem_hist))
                 for s in self._stats.values()),
                key=lambda s: -s.total_s,
            )

    def rows_payload(self) -> list[dict]:
        """The one serialization SHOW STATEMENTS and the admin endpoint
        share (single source for the row shape)."""
        return [
            {"fingerprint": s.fingerprint, "count": s.count,
             "meanMs": round(s.mean_s * 1e3, 3),
             "maxMs": round(s.max_s * 1e3, 3),
             "p50Ms": round(s.percentile(0.50) * 1e3, 3),
             "p99Ms": round(s.percentile(0.99) * 1e3, 3),
             "rows": s.rows, "errors": s.errors,
             "maxMemMb": round(s.max_mem_bytes / (1 << 20), 3),
             "p50MemMb": round(s.percentile_mem(0.50) / (1 << 20), 3),
             "p99MemMb": round(s.percentile_mem(0.99) / (1 << 20), 3),
             "spills": s.spills}
            for s in self.all()
        ]

    def clear(self) -> None:
        with self._lock:
            self._stats.clear()


# process-default registry (Sessions feed it; the admin endpoint reads it —
# the reference similarly aggregates node-wide)
DEFAULT = StatsRegistry()
