"""Table statistics — the pkg/sql/stats reduction.

Reference: CREATE STATISTICS / the automatic stats collector sample tables
into TableStatistic protos (row count, distinct count, null count, and
histograms per column, pkg/sql/stats/new_stat.go); the optimizer's
statistics builder consumes them for cardinality estimates
(pkg/sql/opt/memo/statistics_builder.go). Here ANALYZE computes exact
single-pass statistics (the tables are columnar and resident — sampling
buys nothing at this scale) and three planner consumers read them:

- join ordering starts from the largest estimated source
  (sql/binder.py Source.base_rows);
- the distribute planner's broadcast-join threshold compares estimated
  rows (plan/distribute.py estimated_rows);
- exact packed join keys derive bit widths from (lo, hi) bounds
  (ops/join.plan_exact_key via Table.col_stats).

Statistics are DELIBERATELY stale-able: they snapshot at ANALYZE time and
perturbing them changes plans without changing data — exactly the
reference's contract (and what the stats tests assert).

The port of ``cockroach_tpu.sql.stats``: a KV table's columns are
decoded on its device and read back once; the statistics are numpy.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

import numpy as np


HIST_BUCKETS = 32


@dataclass
class ColumnStat:
    lo: int | None = None  # min over non-NULL rows (int-represented cols)
    hi: int | None = None
    ndv: int = 0  # distinct non-NULL values
    null_count: int = 0
    # equi-depth histogram (statistics_builder.go's histogram role):
    # hist_bounds[i] is the UPPER bound (inclusive) of bucket i, ascending;
    # hist_counts[i] is that bucket's row count
    hist_bounds: list | None = None
    hist_counts: list | None = None

    def frac_le(self, v: int) -> float:
        """Estimated fraction of non-NULL rows with value <= v."""
        if self.lo is None or self.hi is None:
            return 0.5
        if v < self.lo:
            return 0.0
        if v >= self.hi:
            return 1.0
        if self.hist_bounds:
            total = sum(self.hist_counts)
            acc = 0.0
            prev_hi = self.lo - 1
            for b, c in zip(self.hist_bounds, self.hist_counts):
                if v >= b:
                    acc += c
                    prev_hi = b
                else:
                    # linear interpolation inside the bucket
                    width = max(1, b - prev_hi)
                    acc += c * min(1.0, max(0.0, (v - prev_hi) / width))
                    break
            return min(1.0, acc / max(1, total))
        return (v - self.lo + 1) / max(1, self.hi - self.lo + 1)

    def cmp_fraction(self, op: str, v: int) -> float:
        """Estimated selected fraction for `col <op> v` (eq lt le gt ge),
        over non-NULL rows — the statistics_builder selectivity role."""
        if op == "eq":
            if self.lo is not None and not self.lo <= v <= self.hi:
                return 0.0
            return 1.0 / max(1, self.ndv)
        if op == "le":
            return self.frac_le(v)
        if op == "lt":
            return self.frac_le(v - 1)
        if op == "ge":
            return 1.0 - self.frac_le(v - 1)
        if op == "gt":
            return 1.0 - self.frac_le(v)
        return 1.0


@dataclass
class TableStats:
    row_count: int
    cols: dict[str, ColumnStat] = field(default_factory=dict)
    created_unix: float = 0.0

    def to_json(self) -> str:
        return json.dumps({
            "row_count": self.row_count,
            "created_unix": self.created_unix,
            "cols": {
                n: [c.lo, c.hi, c.ndv, c.null_count]
                for n, c in self.cols.items()
            },
            "hists": {
                n: [c.hist_bounds, c.hist_counts]
                for n, c in self.cols.items() if c.hist_bounds
            },
        }, separators=(",", ":"))

    @staticmethod
    def from_json(s: str) -> "TableStats":
        d = json.loads(s)
        st = TableStats(
            row_count=d["row_count"],
            created_unix=d.get("created_unix", 0.0),
            cols={
                n: ColumnStat(lo, hi, ndv, nc)
                for n, (lo, hi, ndv, nc) in d["cols"].items()
            },
        )
        for n, (bounds, counts) in d.get("hists", {}).items():
            st.cols[n].hist_bounds = bounds
            st.cols[n].hist_counts = counts
        return st


def _equi_depth_hist(live: np.ndarray) -> tuple[list, list]:
    """Equi-depth histogram over sorted int values: ~HIST_BUCKETS buckets,
    each holding ~n/HIST_BUCKETS rows; bounds are inclusive upper edges."""
    v = np.sort(live.astype(np.int64))
    n = len(v)
    per = max(1, n // HIST_BUCKETS)
    bounds: list[int] = []
    counts: list[int] = []
    start = 0
    while start < n:
        end = min(n, start + per)
        b = int(v[end - 1])
        # a bucket must end at a value boundary or equal values straddle
        # buckets and frac_le double-counts
        while end < n and int(v[end]) == b:
            end += 1
        bounds.append(b)
        counts.append(end - start)
        start = end
    return bounds, counts


def analyze_table(table) -> TableStats:
    """One exact pass over host columns -> TableStats. Works for both host
    Tables and KVTables (duck-typed on .schema/.columns/.valids)."""
    from ..coldata.types import Family

    n = table.num_rows
    st = TableStats(row_count=int(n), created_unix=time.time())
    if hasattr(table, "columns") and isinstance(table.columns, dict):
        columns = {k: np.asarray(v) for k, v in table.columns.items()}
        valids = {
            k: np.asarray(v) for k, v in table.valids.items()
        } if table.valids else {}
    else:
        # KVTable: statistics live in the RAW storage domain (scaled
        # DECIMALs, dictionary codes) — the same domain col_stats feeds to
        # exact-key planning — so read the columnar batch, not to_host
        # each column is read back once; the histograms are numpy
        b = table.device_batch()
        mask = b.mask.cpu().numpy()
        columns = {
            name: col.data.cpu().numpy()[mask]
            for name, col in zip(table.schema.names, b.cols)
        }
        valids = {
            name: col.valid.cpu().numpy()[mask]
            for name, col in zip(table.schema.names, b.cols)
        }
    for name, t in zip(table.schema.names, table.schema.types):
        a = columns[name]
        cs = ColumnStat()
        v = valids.get(name)
        if v is not None:
            cs.null_count = int((~v).sum())
            live = a[v]
        elif a.dtype == object:
            isnull = np.array([x is None for x in a])
            cs.null_count = int(isnull.sum())
            live = a[~isnull]
        else:
            live = a
        if len(live):
            if live.dtype == object:
                cs.ndv = int(len(set(live.tolist())))
            else:
                cs.ndv = int(len(np.unique(live)))
            # STRING columns keep dictionary-CODE bounds (the pre-ANALYZE
            # catalog stats include them and exact-key/sort packing relies
            # on them; dropping bounds here would make ANALYZE degrade
            # string-key plans)
            if (t.family not in (Family.BYTES, Family.JSON,
                                 Family.FLOAT, Family.BOOL)
                    and live.dtype != object
                    and np.issubdtype(live.dtype, np.integer)):
                cs.lo = int(live.min())
                cs.hi = int(live.max())
                if cs.ndv > 1:
                    cs.hist_bounds, cs.hist_counts = _equi_depth_hist(live)
        st.cols[name] = cs
    return st


# -- persistence for KV-backed tables (system keyspace) ----------------------
# system.table_statistics role: JSON chunked across rows so statistics fit
# any engine value width (the descriptor-chunking discipline)

_STATS_PREFIX = b"\x01stat"


def _stats_key(table_id: int, chunk: int) -> bytes:
    return _STATS_PREFIX + b"%06d.%04d" % (table_id, chunk)


def save_kv_stats(db, table_id: int, st: TableStats) -> None:
    from ..kv.chunked import chunk_blob

    blob = st.to_json().encode("utf-8")
    step = max(16, db.engine.val_width - 1)
    # length-headered chunks (kv/chunked.py): stale tail chunks from a
    # longer previous version are ignored on read — no delete pass needed
    for ci, piece in enumerate(chunk_blob(blob, step)):
        db.put(_stats_key(table_id, ci), piece)


def load_kv_stats(db, table_id: int) -> TableStats | None:
    from ..kv.chunked import unchunk

    rows = db.scan(_stats_key(table_id, 0), _stats_key(table_id, 9999))
    if not rows:
        return None
    return TableStats.from_json(unchunk([v for _, v in rows]).decode("utf-8"))
