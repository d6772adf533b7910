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

import contextlib
import threading
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
    # rolling p99 WAL/probe write latency above this flags the disk slow
    "storage.disk.slow_threshold_ms": 100.0,
    # plan index-backed reads for selective filters on indexed columns,
    # and the estimated selected fraction above which a filtered full
    # scan beats an index scan + fetch (plan/indexopt.py)
    "sql.opt.index_scan.enabled": True,
    "sql.opt.index_scan.max_frac": 0.25,
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
    # collapse stateless per-tile chains into one replayed function per
    # tile (flow/fuse.py, the fused pulls of flow/operators.py); off runs
    # the one-function-per-operator pull path
    "sql.distsql.fusion.enabled": True,
    # duplicate-key inner/left probes emit speculatively at a learned
    # capacity, their totals checked once per query
    "sql.distsql.fusion.general_probe": True,
    # join probes composed into one fused segment before it splits
    "sql.distsql.max_fused_joins": 4,
    # selective probe-aligned joins compact their output to a learned,
    # sticky capacity (overflow checked once per query)
    "sql.distsql.join_compact_emit": True,
    # the root pull loop reads tile k back while tile k+1 is issued
    "sql.distsql.readback_overlap": True,
    # multi-way join ordering of the binder: 'heuristic' (largest source
    # first, then the smallest connected build) or 'cost' (left-deep DP)
    "sql.opt.join_order": "heuristic",
    # the prepared-plan cache (sql/plancache.py): repeat statements (same
    # structure, any numeric literals) rebind into a cached operator tree
    "sql.plan_cache.enabled": True,
    "sql.plan_cache.size": 128,
    # background re-execution of hot statements after DDL
    "sql.plan_cache.warmup.enabled": False,
    # the warm menu (sql/warmmenu.py): statements run two to four times
    # each before a server accepts its first connection, within a wall
    # budget and a cap on new signatures (CUDA graph captures on the card)
    "sql.warmup.menu.enabled": False,
    "sql.warmup.menu.budget_s": 30.0,
    "sql.warmup.menu.max_kernels": 512,
    # statements slower than this many seconds are logged and leave a
    # diagnostics bundle (sql/diagnostics.py); 0 disables
    "sql.log.slow_query.latency_threshold": 0.0,
    # the bundles' on-disk ring: its size, and its directory (empty: a
    # per-process temporary directory)
    "sql.diagnostics.ring_size": 16,
    "sql.diagnostics.dir": "",
    # node-level logical-byte budget of the root memory monitor (0 =
    # unlimited; admission sheds by its pressure)
    "sql.mem.root_budget_bytes": 0,
    # SQL admission (utils/admission.py): every statement takes a slot of
    # the shared WorkQueue; past max_queue_depth queued statements admit
    # fails fast (SQLSTATE 53300), and queue_timeout_s bounds a wait
    "admission.sql.enabled": True,
    "admission.sql.slots": 64,
    "admission.sql.max_queue_depth": 512,
    "admission.sql.queue_timeout_s": 30.0,
    # per-tenant token buckets (statements/s; 0 = unlimited) and capacity
    "admission.tenant.rate": 0.0,
    "admission.tenant.burst": 64,
    # memory-pressure fractions past which the analytical lane, then
    # NORMAL priority too, are shed
    "admission.shed.mem_low": 0.90,
    "admission.shed.mem_high": 0.97,
    # deadline on control-plane socket I/O: rangefeed dials, handshakes
    # and per-frame reads on an established stream (a liveness backstop
    # against silent peers, not a latency objective)
    "flow.dcn.io_timeout_s": 30.0,
    # the runtime data-race sanitizer (utils/racesan.py)
    "debug.race_detector.enabled": False,
    # the changefeed fan-out plane (kv/fanout.py): per-subscriber buffer
    # budget, the fraction of it where duplicate-key events coalesce, the
    # send deadline after which a subscriber is evicted, the idle
    # heartbeat, the bound on registrations per hub, and the sheds in a
    # row without a drain that end in eviction
    "changefeed.fanout.buffer_bytes": 1 << 20,
    "changefeed.fanout.highwater_frac": 0.5,
    "changefeed.fanout.send_deadline_s": 5.0,
    "changefeed.fanout.heartbeat_s": 1.0,
    "changefeed.fanout.max_subscribers": 4096,
    "changefeed.fanout.max_consecutive_sheds": 3,
    # materialized views (sql/matview.py, flow/viewmaint.py): the master
    # switch, the planner rewrite, refresh before a statement that reads
    # a view, and the delta-tile staging budget of a maintainer
    "sql.matview.enabled": True,
    "sql.matview.rewrite.enabled": True,
    "sql.matview.refresh_on_read.enabled": True,
    "sql.matview.staging_bytes": 4 << 20,
}

# enumerated string settings: the values each accepts
_CHOICES: dict[str, tuple[str, ...]] = {
    "sql.opt.join_order": ("heuristic", "cost"),
}

# the reference's bounds, (lo, hi), None = unbounded
_BOUNDS: dict[str, tuple] = {
    "storage.l0_compaction_threshold": (1, 64),
    "storage.disk.slow_threshold_ms": (1.0, 60_000.0),
    "sql.opt.index_scan.max_frac": (0.0, 1.0),
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
    "sql.distsql.max_fused_joins": (0, 64),
    "sql.plan_cache.size": (1, 1 << 16),
    "sql.warmup.menu.budget_s": (0.0, None),
    "sql.warmup.menu.max_kernels": (1, None),
    "sql.log.slow_query.latency_threshold": (0.0, None),
    "sql.diagnostics.ring_size": (1, 1 << 12),
    "sql.mem.root_budget_bytes": (0, None),
    "admission.sql.slots": (1, 1 << 16),
    "admission.sql.max_queue_depth": (1, 1 << 20),
    "admission.sql.queue_timeout_s": (0.001, 3600.0),
    "admission.tenant.rate": (0.0, None),
    "admission.tenant.burst": (1, None),
    "admission.shed.mem_low": (0.0, 1.0),
    "admission.shed.mem_high": (0.0, 1.0),
    "flow.dcn.io_timeout_s": (0.1, 600.0),
    "changefeed.fanout.buffer_bytes": (4096, None),
    "changefeed.fanout.highwater_frac": (0.05, 1.0),
    "changefeed.fanout.send_deadline_s": (0.05, None),
    "changefeed.fanout.heartbeat_s": (0.05, None),
    "changefeed.fanout.max_subscribers": (1, None),
    "changefeed.fanout.max_consecutive_sheds": (1, None),
    "sql.matview.staging_bytes": (4096, None),
}

_values: dict[str, Any] = {}

# this thread's values over the process's (``scoped``)
_scoped = threading.local()


def get(name: str):
    own = getattr(_scoped, "values", None)
    if own is not None and name in own:
        return own[name]
    return _values.get(name, _DEFAULTS[name])


def set(name: str, value) -> None:  # noqa: A001 - SQL SET semantics
    _values[name] = _checked(name, value)


@contextlib.contextmanager
def scoped(values: dict):
    """Within the block, this thread reads `values` (coerced and checked
    as ``set`` does) over the process's settings; other threads do not
    see them."""
    own = {n: _checked(n, v) for n, v in values.items()}
    saved = getattr(_scoped, "values", None)
    _scoped.values = {**(saved or {}), **own}
    try:
        yield
    finally:
        _scoped.values = saved


def _checked(name: str, value):
    default = _DEFAULTS[name]
    if isinstance(default, bool):
        if not isinstance(value, bool):
            raise TypeError(f"{name} wants bool, got {value!r}")
    elif isinstance(default, str):
        value = str(value)
        if name in _CHOICES and value not in _CHOICES[name]:
            raise ValueError(f"{name}: {value!r} not in {_CHOICES[name]}")
    else:
        value = type(default)(value)
        lo, hi = _BOUNDS.get(name, (None, None))
        if lo is not None and value < lo:
            raise ValueError(f"{name}: {value} < min {lo}")
        if hi is not None and value > hi:
            raise ValueError(f"{name}: {value} > max {hi}")
    return value


def reset(name: str | None = None) -> None:
    """Restore one setting's default, or every setting's."""
    if name is None:
        _values.clear()
    else:
        if name not in _DEFAULTS:
            raise KeyError(name)
        _values.pop(name, None)


class Setting:
    """One registered setting as ``SET CLUSTER SETTING`` sees it: its
    name, kind (``bool``, ``int``, ``float`` or ``string``) and current
    value."""

    def __init__(self, name: str):
        self.name = name
        d = _DEFAULTS[name]
        self.kind = ("bool" if isinstance(d, bool) else "int"
                     if isinstance(d, int) else "float"
                     if isinstance(d, float) else "string")

    def get(self):
        return get(self.name)


def overrides() -> dict[str, Any]:
    """The settings set away from their defaults, by name."""
    return dict(_values)


def all_settings() -> dict[str, Setting]:
    """Every registered setting by name."""
    return {n: Setting(n) for n in _DEFAULTS}
