"""Internal timeseries DB — the pkg/ts reduction.

The port of ``cockroach_tpu.kv.tsdb``.

Reference: ts/db.go:69 stores 10s-resolution metric samples in the KV
keyspace under per-(name, resolution, slab) keys, downsamples on read, and
feeds the admin UI charts. Here the same store-metrics-in-KV discipline:

- ``record`` snapshots a metric Registry's counters/gauges into one KV row
  per (metric, timestamp-slab);
- ``query`` returns the per-sample series for a metric over a wall-clock
  range, with optional downsampling (avg/max per bucket);
- retention trims slabs older than a cutoff (the ts maintenance queue's
  pruning role).

Keys are NUL-free ASCII: \\x01ts<name>\\x00-free|<slab millis %013d>.
"""

from __future__ import annotations

import struct

from . import hlc
from .txn import DB

_PREFIX = b"\x01ts"
_SAMPLE = struct.Struct("<qd")  # wall_ms, value


def _key(name: str, wall_ms: int) -> bytes:
    safe = name.replace("|", "_").encode("utf-8")
    # clamp to the fixed 13-digit field: a wider timestamp (e.g. the 1<<60
    # open-interval default) would render as more digits and sort BELOW
    # real samples, silently emptying range scans
    wall_ms = min(max(wall_ms, 0), 10 ** 13 - 1)
    return _PREFIX + safe + b"|" + b"%013d" % wall_ms


class TimeSeriesDB:
    """Metric samples in the KV store (one sample per row; slab packing
    arrives with volume)."""

    def __init__(self, db: DB):
        self.db = db

    def record(self, registry, names: list[str] | None = None) -> int:
        """Snapshot counters/gauges (and histogram _count/_sum series —
        enough to chart rates and means) from a metric.Registry at now()."""
        from ..utils import metric as metric_mod

        wall, _ = hlc.unpack(self.db.clock.now())
        n = 0
        for mname, m in registry._metrics.items():
            if names is not None and mname not in names:
                continue
            if isinstance(m, (metric_mod.Counter, metric_mod.Gauge)):
                self.db.put(_key(mname, wall),
                            _SAMPLE.pack(wall, float(m.value)))
                n += 1
            elif isinstance(m, metric_mod.Histogram):
                self.db.put(_key(mname + "_count", wall),
                            _SAMPLE.pack(wall, float(m.n)))
                self.db.put(_key(mname + "_sum", wall),
                            _SAMPLE.pack(wall, float(m.sum)))
                n += 2
            elif isinstance(m, (metric_mod.LabeledCounter,
                                metric_mod.LabeledGauge)):
                # one series per observed label value (per-tenant tokens,
                # per-lane queue depth): name.<label_value>, charted like
                # any scalar series
                for k, v in m.items():
                    self.db.put(_key(f"{mname}.{k}", wall),
                                _SAMPLE.pack(wall, float(v)))
                    n += 1
        return n

    def query(self, name: str, start_ms: int = 0,
              end_ms: int = 1 << 60) -> list[tuple[int, float]]:
        rows = self.db.scan(_key(name, start_ms), _key(name, end_ms))
        out = []
        for _, v in rows:
            wall, val = _SAMPLE.unpack(v[:_SAMPLE.size])
            out.append((wall, val))
        return out

    def downsample(self, name: str, bucket_ms: int, agg: str = "avg",
                   start_ms: int = 0, end_ms: int = 1 << 60
                   ) -> list[tuple[int, float]]:
        """Per-bucket avg/max/last (the read-side downsampler)."""
        buckets: dict[int, list[float]] = {}
        for wall, val in self.query(name, start_ms, end_ms):
            buckets.setdefault(wall // bucket_ms * bucket_ms, []).append(val)
        out = []
        for b in sorted(buckets):
            vals = buckets[b]
            if agg == "avg":
                out.append((b, sum(vals) / len(vals)))
            elif agg == "max":
                out.append((b, max(vals)))
            else:
                out.append((b, vals[-1]))
        return out

    def prune(self, name: str, keep_after_ms: int) -> int:
        """Drop samples older than the cutoff (retention maintenance)."""
        rows = self.db.scan(_key(name, 0), _key(name, keep_after_ms))
        for k, _ in rows:
            self.db.delete(k)
        return len(rows)

    def prune_all(self, keep_after_ms: int) -> int:
        """Retention sweep over EVERY series: drop samples below the
        cutoff. The background scraper (server/node.py _metrics_loop)
        calls this on a paced ticker driven by ``ts.retention_seconds``,
        so the timeseries keyspace stays bounded on long-lived nodes."""
        n = 0
        for k, _ in self.db.scan(_PREFIX, _PREFIX + b"\xff"):
            try:
                wall = int(k[-13:])  # key tail: "|<13-digit millis>"
            except ValueError:
                continue
            if wall < keep_after_ms:
                self.db.delete(k)
                n += 1
        return n
