"""Cluster settings — the subset of ``cockroach_tpu.utils.settings`` the
port reads, with the reference's defaults, bounds and ``set``/``reset``
semantics (a value is coerced to its setting's type and checked against
its bounds; ``reset`` restores the default).

The reference's ``storage.pallas_filter`` / ``storage.pallas_merge``
knobs have no counterpart: in the port, the device of the tensors picks
between a kernel and its plain version, and nothing else does. Nor has
``sql.distsql.dense_agg.accel_max_states``: the port plans dense
aggregation by one budget on every device.
"""

from __future__ import annotations

from typing import Any

_DEFAULTS: dict[str, Any] = {
    # DefaultPebbleOptions L0CompactionThreshold
    "storage.l0_compaction_threshold": 4,
    # route bulk loads through the run builder (storage/ingest.py)
    "storage.bulk_ingest.enabled": True,
    # node-wide block cache budget; 0 disables caching
    "storage.block_cache.size_bytes": 256 << 20,
    # size-tiered compaction pacing (utils/admission.IOGovernor)
    "storage.compaction.pacing.enabled": True,
    "storage.compaction.pacing.min_interval_ms": 0,
    "storage.compaction.pacing.max_debt_runs": 8,
    # write pacing proportional to L0 overload
    "admission.io_pacing.enabled": True,
    # static scan tile capacity; resident tables pad to a tile multiple
    "sql.distsql.tile_size": 1 << 20,
    # tables larger than this stream host->device tile by tile, double
    # buffered (flow/operators.ScanOp)
    "sql.distsql.scan_stream_rows": 1 << 23,
    # pad sub-tile resident tables up the catalog.SHAPE_BUCKETS ladder
    "sql.distsql.shape_buckets.enabled": True,
    # per-operator spool budgets (rows / device bytes); past them the
    # operator swaps in its external variant (flow/external.py)
    "sql.distsql.workmem_rows": 1 << 21,
    "sql.distsql.workmem_bytes": 2 << 30,
    # Grace hash join heavy hitters: build-key hash reservoir size, and
    # the share of it one hash must own to be pinned (0 disables either)
    "sql.distsql.grace_skew_sample": 1024,
    "sql.distsql.grace_skew_frac": 0.05,
    # max packed-key bits for the dense direct-addressed join index
    "sql.distsql.dense_lut_bits": 24,
    # max dense group-code space for the dense aggregation path
    "sql.distsql.dense_agg_states": 1 << 23,
}

# the reference's bounds, (lo, hi), None = unbounded
_BOUNDS: dict[str, tuple] = {
    "storage.l0_compaction_threshold": (1, 64),
    "storage.compaction.pacing.min_interval_ms": (0, 60_000),
    "storage.compaction.pacing.max_debt_runs": (1, 256),
    "sql.distsql.tile_size": (128, 1 << 24),
    "sql.distsql.scan_stream_rows": (1024, None),
    "sql.distsql.workmem_rows": (1024, None),
    "sql.distsql.workmem_bytes": (1 << 16, None),
    "sql.distsql.grace_skew_sample": (0, 1 << 20),
    "sql.distsql.grace_skew_frac": (0.0, 1.0),
    "sql.distsql.dense_lut_bits": (0, 30),
    "sql.distsql.dense_agg_states": (64, 1 << 28),
}

_values: dict[str, Any] = {}


def get(name: str):
    return _values.get(name, _DEFAULTS[name])


def set(name: str, value) -> None:  # noqa: A001 - SQL SET semantics
    default = _DEFAULTS[name]
    if isinstance(default, bool):
        if not isinstance(value, bool):
            raise TypeError(f"{name} wants bool, got {value!r}")
    else:
        value = type(default)(value)
        lo, hi = _BOUNDS.get(name, (None, None))
        if lo is not None and value < lo:
            raise ValueError(f"{name}: {value} < min {lo}")
        if hi is not None and value > hi:
            raise ValueError(f"{name}: {value} > max {hi}")
    _values[name] = value


def reset(name: str | None = None) -> None:
    """Restore one setting's default, or every setting's."""
    if name is None:
        _values.clear()
    else:
        if name not in _DEFAULTS:
            raise KeyError(name)
        _values.pop(name, None)
