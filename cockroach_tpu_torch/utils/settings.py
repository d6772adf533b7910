"""Cluster settings — the subset of ``cockroach_tpu.utils.settings`` the
port reads, with the reference's defaults.

The reference's ``storage.pallas_filter`` / ``storage.pallas_merge``
knobs have no counterpart: in the port, the device of the tensors picks
between a kernel and its plain version, and nothing else does.
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
    # tables larger than this stream tile by tile (not ported: such
    # scans raise)
    "sql.distsql.scan_stream_rows": 1 << 23,
    # pad sub-tile resident tables up the catalog.SHAPE_BUCKETS ladder
    "sql.distsql.shape_buckets.enabled": True,
    # per-operator spool budgets (rows / device bytes); past them the
    # reference swaps in its external operators, which the port has not
    "sql.distsql.workmem_rows": 1 << 21,
    "sql.distsql.workmem_bytes": 2 << 30,
}


def get(name: str):
    return _DEFAULTS[name]
