"""Memory accounting — the mon.BytesMonitor tree + colmem.Allocator
analog; the port of ``cockroach_tpu.flow.memory``.

A tree of monitors over LOGICAL device bytes (capacity x dtype width):

- ``ROOT`` is the process (node) monitor feeding the ``sql_mem_current``
  / ``sql_mem_max`` gauges;
- every query opens a QUERY monitor via :func:`query_scope` (a
  contextvar carries it, so operators need no constructor plumbing);
- buffering operators open :class:`Allocator` accounts under the current
  query monitor, budgeted by ``sql.distsql.workmem_bytes``; when
  ``would_exceed`` says a tile does not fit, the operator spills to its
  external variant (flow/external.py), attributed to the owning query by
  :func:`note_spill`;
- long-lived accounts (spill staging on the host, storage run and bloom
  residency, ingest blocks) are children of ROOT
  (:func:`staging_monitor`), outside every query's drain check.

A query monitor that closes with bytes still reserved is a leak: it is
counted in ``sql_mem_query_leaks`` and in :func:`drain_failure_count`.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import weakref

from ..coldata.batch import Batch
from ..utils import metric


class BudgetExceededError(Exception):
    """A reservation would exceed a memory budget."""

    def __init__(self, op: str, want: int, budget: int):
        super().__init__(
            f"{op}: memory budget exceeded "
            f"({want} bytes wanted, budget {budget})")
        self.want = want
        self.budget = budget


def batch_bytes(b: Batch) -> int:
    """Logical device bytes of a tile: data + valid bitmap per column,
    plus the liveness mask (bools are one byte)."""
    total = b.mask.numel()
    for c in b.cols:
        total += c.data.numel() * c.data.element_size()
        total += c.valid.numel() * c.valid.element_size()
    return int(total)


# one lock for the whole tree: reservations are per spool tile, so
# charging up the ancestor chain stays atomic at negligible contention
_TREE_LOCK = threading.RLock()


class BytesMonitor:
    """One node of the monitor tree. ``budget`` 0 means unlimited at this
    level (ancestors may still refuse). Reservations charge every
    ancestor up to ROOT; ``high_water`` is the peak of ``used``."""

    def __init__(self, name: str, parent: "BytesMonitor | None" = None,
                 budget: int = 0, level: str = "operator"):
        self.name = name
        self.parent = parent
        self.budget = int(budget)
        self.level = level
        self.used = 0
        self.high_water = 0
        self.spills = 0
        self.closed = False
        self._children: list[weakref.ref] = []
        if parent is not None:
            with _TREE_LOCK:
                parent._children.append(weakref.ref(self))

    def child(self, name: str, budget: int = 0,
              level: str = "operator") -> "BytesMonitor":
        return BytesMonitor(name, parent=self, budget=budget, level=level)

    def children(self) -> "list[BytesMonitor]":
        """Live (unclosed) child monitors."""
        with _TREE_LOCK:
            out, alive = [], []
            for r in self._children:
                m = r()
                if m is not None and not m.closed:
                    out.append(m)
                    alive.append(r)
            self._children = alive
            return out

    def would_exceed(self, nbytes: int) -> bool:
        n = int(nbytes)
        with _TREE_LOCK:
            m = self
            while m is not None:
                if m.budget and m.used + n > m.budget:
                    return True
                m = m.parent
        return False

    def reserve(self, nbytes: int, force: bool = False) -> None:
        """Charge ``nbytes`` up the ancestor chain. ``force`` skips the
        budget check: the bytes are resident either way, and over-budget
        accounting beats none."""
        n = int(nbytes)
        if n <= 0:
            return
        with _TREE_LOCK:
            if not force:
                m = self
                while m is not None:
                    if m.budget and m.used + n > m.budget:
                        raise BudgetExceededError(
                            m.name, m.used + n, m.budget)
                    m = m.parent
            m = self
            while m is not None:
                m.used += n
                if m.used > m.high_water:
                    m.high_water = m.used
                m = m.parent
            _update_gauges()

    def release(self, nbytes: int | None = None) -> None:
        with _TREE_LOCK:
            n = self.used if nbytes is None else min(int(nbytes), self.used)
            if n <= 0:
                return
            m = self
            while m is not None:
                m.used = max(0, m.used - n)
                m = m.parent
            _update_gauges()

    def note_spill(self) -> None:
        with _TREE_LOCK:
            m = self
            while m is not None:
                m.spills += 1
                m = m.parent

    def close(self) -> int:
        """Release everything and detach; returns the bytes that were
        still reserved (0 = the account drained cleanly)."""
        with _TREE_LOCK:
            if self.closed:
                return 0
            leaked = self.used
            self.release()
            self.closed = True
            return leaked


# the node-level root monitor
ROOT = BytesMonitor("root", level="root")

_STAGING: dict[str, BytesMonitor] = {}


def staging_monitor(name: str, budget: int = 0) -> BytesMonitor:
    """Get-or-create the named long-lived account under ROOT. ``budget``
    (when non-zero) installs or updates a cap on the account."""
    with _TREE_LOCK:
        m = _STAGING.get(name)
        if m is None or m.closed:
            m = _STAGING[name] = BytesMonitor(name, parent=ROOT,
                                              level="staging")
        if budget:
            m.budget = int(budget)
        return m


@contextlib.contextmanager
def staged(name: str, nbytes: int):
    """Scoped charge for a transient staging buffer (host padding
    blocks, quantile key vectors), released on exit."""
    mon = staging_monitor(name)
    n = int(nbytes)
    mon.reserve(n, force=True)
    try:
        yield mon
    finally:
        mon.release(n)


def charge_object(name: str, obj, nbytes: int) -> None:
    """Charge residency for ``obj``'s lifetime, released when the object
    is garbage-collected."""
    mon = staging_monitor(name)
    n = int(nbytes)
    if n <= 0:
        return
    mon.reserve(n, force=True)
    weakref.finalize(obj, mon.release, n)


def _update_gauges() -> None:
    # called under _TREE_LOCK on every root-visible delta
    metric.SQL_MEM_CURRENT.set(ROOT.used)
    metric.SQL_MEM_MAX.set(ROOT.high_water)


_CURRENT_QUERY: contextvars.ContextVar[BytesMonitor | None] = (
    contextvars.ContextVar("ctpu_torch_query_monitor", default=None))
_QUERY_SEQ = itertools.count(1)
_DRAIN_TOTAL = 0


def current_query() -> BytesMonitor | None:
    return _CURRENT_QUERY.get()


def root_budget() -> int:
    from ..utils import settings

    return int(settings.get("sql.mem.root_budget_bytes"))


def mem_pressure() -> float:
    """ROOT used over the configured root budget (0.0 when the budget is
    unlimited): the signal admission sheds by."""
    b = root_budget()
    return (ROOT.used / b) if b > 0 else 0.0


def session_monitor(name: str) -> BytesMonitor:
    """A session's node of the tree, under ROOT: its statements' query
    monitors open under it."""
    return BytesMonitor(name, parent=ROOT, level="session")


@contextlib.contextmanager
def query_scope(parent: BytesMonitor | None = None, name: str | None = None):
    """Enter (or join) the current statement's query monitor, under
    `parent` (a session's monitor) or ROOT. Nested scopes share the outer
    monitor; the outermost exit closes it, records its peak in
    ``sql_mem_query_peak_bytes`` and counts any retained bytes as a
    drain failure."""
    existing = _CURRENT_QUERY.get()
    if existing is not None:
        yield existing
        return
    qm = BytesMonitor(name or f"query-{next(_QUERY_SEQ)}",
                      parent=parent or ROOT, level="query")
    tok = _CURRENT_QUERY.set(qm)
    try:
        yield qm
    finally:
        _CURRENT_QUERY.reset(tok)
        _close_query(qm)


def monitor_rows() -> list[dict]:
    """Depth-first snapshot of the live monitor tree (the
    crdb_internal.node_memory_monitors row shape)."""
    rows: list[dict] = []

    def walk(m: BytesMonitor, depth: int) -> None:
        rows.append({
            "name": m.name, "level": m.level, "depth": depth,
            "used": m.used, "peak": m.high_water,
            "budget": m.budget, "spills": m.spills,
        })
        for c in m.children():
            walk(c, depth + 1)

    with _TREE_LOCK:
        walk(ROOT, 0)
    return rows


def _close_query(qm: BytesMonitor) -> None:
    global _DRAIN_TOTAL
    with _TREE_LOCK:
        # an operator account still open at query end is a leak, but its
        # bytes must not poison the root gauges: close children first
        leaked = 0
        for c in qm.children():
            leaked += c.close()
        leaked += qm.used
        qm.close()
        if leaked:
            _DRAIN_TOTAL += 1
            metric.SQL_MEM_QUERY_LEAKS.inc()
    metric.SQL_MEM_QUERY_PEAK.observe(float(qm.high_water))


def drain_failure_count() -> int:
    """Query monitors that closed with bytes still reserved."""
    return _DRAIN_TOTAL


def note_spill(kind: str) -> None:
    """Attribute one spill to the owning query (and its ancestors), plus
    the per-kind node counter; aggregation spills count where the Grace
    aggregation stages (flow/external.py)."""
    qm = _CURRENT_QUERY.get()
    (qm if qm is not None else ROOT).note_spill()
    if kind == "sort":
        metric.EXTERNAL_SORT_SPILLS.inc()
    elif kind == "join":
        metric.GRACE_JOIN_SPILLS.inc()


def device_memory_stats() -> dict:
    """Physical-side cross-check of the logical accounting: the caching
    allocator's bytes in use and peak, summed over the process's CUDA
    devices, and what it has reserved from the card. Empty dict when no
    card is in use (the CPU), as the reference's is when its backend
    reports nothing."""
    import torch

    if not torch.cuda.is_initialized():
        return {}
    n = torch.cuda.device_count()
    return {
        "bytes_in_use": sum(torch.cuda.memory_allocated(d)
                            for d in range(n)),
        "peak_bytes_in_use": sum(torch.cuda.max_memory_allocated(d)
                                 for d in range(n)),
        "reserved_bytes": sum(torch.cuda.memory_reserved(d)
                              for d in range(n)),
        "devices": n,
    }


class Allocator:
    """Byte account for one operator (colmem.Allocator): a leaf monitor
    under the current query monitor, budgeted by
    ``sql.distsql.workmem_bytes``. The owner closes it when its buffered
    state dies."""

    def __init__(self, op: str, stats=None):
        from ..utils import settings

        self._mon = BytesMonitor(
            f"operator/{op}", parent=_CURRENT_QUERY.get() or ROOT,
            budget=int(settings.get("sql.distsql.workmem_bytes")))
        # the owner's ComponentStats: its max_mem_bytes follows the
        # account's high water (EXPLAIN ANALYZE's "max mem")
        self._stats = stats

    @property
    def used(self) -> int:
        return self._mon.used

    def would_exceed(self, nbytes: int) -> bool:
        return self._mon.would_exceed(nbytes)

    def reserve(self, nbytes: int, force: bool = False) -> None:
        self._mon.reserve(nbytes, force=force)
        if self._stats is not None:
            self._stats.max_mem_bytes = max(self._stats.max_mem_bytes,
                                            self._mon.high_water)

    def release(self, nbytes: int | None = None) -> None:
        self._mon.release(nbytes)

    def close(self) -> None:
        self._mon.close()
