"""The Operator contract — the colexecop.Operator analog; the port of
``cockroach_tpu.flow.operator``.

``next_batch() -> Batch | None`` returns device-resident tiles; None means
exhausted. Operators also surface plan-static metadata: ``output_schema``,
per-column string ``dictionaries`` and (lo, hi) ``col_stats``.

Every place an operator waits for the device to hand a value to the host
(a live-row count that sizes a spool, a LIMIT's row count, a tile staged
on the host by a spill) counts one host sync in ``stats.host_syncs``;
``flow.runtime.host_syncs`` sums them over a tree after a query.
"""

from __future__ import annotations

import time

import torch

from ..coldata.batch import Batch, Dictionary
from ..coldata.types import Schema


def _wait_device() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class ComponentStats:
    """Per-operator execution stats (execinfrapb.ComponentStats analog)."""

    __slots__ = ("batches", "rows", "time_s", "bytes", "host_syncs",
                 "spilled", "staged_bytes", "max_mem_bytes",
                 "kernel_dispatches", "kernel_compiles")

    def __init__(self):
        self.batches = 0
        self.rows = 0
        self.time_s = 0.0  # inclusive wall time in next_batch (incl. children)
        self.bytes = 0  # logical device bytes emitted (stats collection)
        self.host_syncs = 0  # device -> host waits this run
        self.spilled = False  # swapped in its external variant
        self.staged_bytes = 0  # bytes staged on the host by a spill
        # peak reserved bytes across this operator's memory accounts
        self.max_mem_bytes = 0
        # dispatches and new signatures of the whole query, on the root
        # (flow/runtime.run_plan_with_stats; dispatches are process-wide)
        self.kernel_dispatches = 0
        self.kernel_compiles = 0

    def exclusive(self, children: list["Operator"]) -> float:
        return self.time_s - sum(c.stats.time_s for c in children)


class Operator:
    """Base pull operator. Subclasses set output_schema / dictionaries /
    col_stats in __init__ and implement _next()."""

    output_schema: Schema
    dictionaries: dict[int, Dictionary]
    col_stats: dict[int, tuple]

    def __init__(self):
        self.dictionaries = {}
        self.col_stats = {}
        self._initialized = False
        self.stats = ComponentStats()
        self._collect = False

    def init(self) -> None:
        """Init(ctx) analog — called once before the first next_batch of
        every run; the run's stats start from zero."""
        self._initialized = True
        self.stats = ComponentStats()

    def sync_int(self, x: torch.Tensor) -> int:
        """A device scalar as a host int: one counted host sync."""
        self.stats.host_syncs += 1
        return int(x)

    def next_batch(self) -> Batch | None:
        if not self._initialized:
            self.init()
        if not self._collect:
            return self._next()
        # device waits on both sides of the call attribute the card's work
        # to the operator that issued it (work still queued from the
        # caller finishes before this timer starts) — an EXPLAIN
        # ANALYZE-only cost, like the row count's sync
        _wait_device()
        t0 = time.perf_counter()
        b = self._next()
        if b is not None:
            from .memory import batch_bytes

            self.stats.rows += int(b.mask.sum())
            self.stats.batches += 1
            self.stats.bytes += batch_bytes(b)
        _wait_device()
        self.stats.time_s += time.perf_counter() - t0
        return b

    def children(self) -> list["Operator"]:
        return []

    def collect_stats(self, enabled: bool = True) -> None:
        self._collect = enabled
        for c in self.children():
            c.collect_stats(enabled)

    def _next(self) -> Batch | None:
        raise NotImplementedError

    def stream_parts(self):
        """Fused-streaming contract: (source, fn, args) when this
        operator's output is a pure per-tile device function of a source's
        tiles, so a consumer composes the whole chain into one function
        replayed per tile (flow/operators.py). None: a pipeline barrier."""
        return None

    def stream_tiles(self):
        """The source side of ``stream_parts``: the raw tiles (or tile
        tokens) that the composed function takes, from the start."""
        raise NotImplementedError

    def post_run_update(self) -> bool:
        """End-of-query hook: adaptive operators read their deferred device
        counters here (one host sync per query, never per tile) and update
        sticky choices. True means this run's output was invalid (a
        speculative capacity overflowed) and the query must re-run."""
        return False

    def close(self) -> None:
        """Closer analog."""


class SourceOperator(Operator):
    """An operator with no inputs (scan)."""


class OneInputOperator(Operator):
    def __init__(self, child: Operator):
        super().__init__()
        self.child = child
        self.dictionaries = dict(child.dictionaries)
        self.col_stats = dict(child.col_stats)

    def init(self) -> None:
        self.child.init()
        super().init()

    def children(self) -> list[Operator]:
        return [self.child]

    def close(self) -> None:
        self.child.close()
