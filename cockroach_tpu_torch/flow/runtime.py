"""Flow execution — the FlowCoordinator/Materializer pull loop; the port
of ``cockroach_tpu.flow.runtime``'s ``run_operator`` and ``run_plan``.

``run_operator`` pulls every tile from the root operator, inside one
query memory monitor (``flow/memory.query_scope``), and materializes
live rows to host numpy columns (decoding string dictionaries).

- **Speculative capacities.** Operators run with sticky learned shapes
  and check their deferred device counters after the pull
  (``_post_run_updates``: one host sync per operator per query, never per
  tile). An overflow re-runs the query with corrected capacities, up to
  four attempts; past that the run raises.
- **Readback overlap** (``sql.distsql.readback_overlap``): on the card,
  tile k's device -> host copy goes ``non_blocking`` into pinned buffers
  with an event recorded behind it, and is materialized while tile k+1 is
  issued, so the copy overlaps the device work of the next tile.
- **Readback shrink** (``_ReadbackShrink``): large output tiles compact
  on the device before they cross to the host, speculatively: the live
  count is read once at query end, and a tile the compaction truncated is
  materialized again from its retained original.

``run_plan_with_stats`` runs with ComponentStats collection inside a
traced ``query`` span, folds the operator tree's stats into child spans
and leaves the query's dispatches, new signatures and peak memory on the
root operator: EXPLAIN ANALYZE (plan/explain.py) renders all of it.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..catalog import Catalog
from ..coldata.batch import Batch, Column, compact, to_host
from ..plan import builder as plan_builder
from ..plan.spec import PlanNode
from ..utils import metric, settings
from . import dispatch
from .memory import query_scope
from .operator import Operator

MAX_ATTEMPTS = 4


class _ReadbackShrink:
    """Device-side output compaction before materialization: a top-10
    result in a 2^20-row padded tile would otherwise cross to the host
    whole, so tiles of at least MIN_CAP rows compact to capacity/64.

    The decision is SPECULATIVE (no host sync in the pull loop): each
    compaction keeps a deferred device live count and retains the original
    tile; finish() reads all counts in one stacked sync at query end and
    re-materializes any tile the compaction truncated from its retained
    original (no recompute, no re-run)."""

    MIN_CAP = 1 << 16

    def __init__(self):
        self._checks = []  # (output index, original tile, cap, count)
        self._n = 0

    def shrink(self, b: Batch) -> Batch:
        i = self._n
        self._n += 1
        if b.capacity < self.MIN_CAP:
            return b
        cap = max(1024, b.capacity >> 6)
        b = dispatch.own(b)  # retained past the next tile's call
        count = b.mask.sum(dtype=torch.int64)  # deferred device scalar
        out = compact(b, capacity=cap)
        dispatch.note()
        self._checks.append((i, b, cap, count))
        return out

    def finish(self, outs, schema, dictionaries,
               root: Operator | None = None) -> None:
        """ONE stacked count read (a host sync, counted on `root`); patch
        truncated tiles from their retained originals. Call only on the
        attempt whose output is kept."""
        if not self._checks:
            return
        if root is not None:
            root.stats.host_syncs += 1
        # crlint: allow-host-sync(deferred shrink counts: ONE stacked sync at query end by design)  # crlint: allow-mem-accounting(one int32 per shrunk tile — bounded by the query's tile count)
        counts = torch.stack([c for *_, c in self._checks]).cpu().numpy()
        for (i, orig, cap, _), n in zip(self._checks, counts):
            if int(n) > cap:
                outs[i] = to_host(orig, schema, dictionaries)
        self._checks = []


def _post_run_updates(op: Operator) -> bool:
    """Every operator's end-of-query adaptive update (the deferred
    counter reads: the one host sync speculative execution pays per
    operator and query). True when any operator invalidated this run's
    output (a speculative capacity overflowed): the query must re-run."""
    rerun = op.post_run_update()
    for c in op.children():
        rerun = _post_run_updates(c) or rerun
    return rerun


class _Readback:
    """Tile k's device -> host copy, started without waiting: pinned host
    buffers, ``non_blocking`` copies and an event behind them; ``host``
    waits for the event and gives the host batch."""

    def __init__(self, b: Batch):
        def start(t):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            return h

        self.batch = Batch(
            cols=tuple(Column(data=start(c.data), valid=start(c.valid))
                       for c in b.cols),
            mask=start(b.mask))
        self.done = torch.cuda.Event()
        self.done.record()

    def host(self) -> Batch:
        # crlint: allow-host-sync(the readback's own wait: the pull loop starts tile k+1 before it waits on tile k's copy, so the wait overlaps device work)
        self.done.synchronize()
        return self.batch


def _pull(root: Operator, shrink: _ReadbackShrink, overlap: bool) -> list:
    """One attempt's output tiles as host columns; each readback counts
    one host sync on the root. With overlap on the card, tile k is
    materialized after tile k+1 has been issued."""
    outs: list[dict[str, np.ndarray]] = []
    pending = None
    while True:
        b = root.next_batch()
        started = None
        if b is not None:
            b = shrink.shrink(b)
            if overlap and b.device.type == "cuda":
                started = _Readback(b)
            else:
                root.stats.host_syncs += 1
                outs.append(to_host(b, root.output_schema,
                                    root.dictionaries))
        if pending is not None:
            root.stats.host_syncs += 1
            outs.append(to_host(pending.host(), root.output_schema,
                                root.dictionaries))
        pending = started
        if b is None:
            return outs


def run_operator(root: Operator) -> dict[str, np.ndarray]:
    """Run the operator tree (re-running while speculative capacities
    overflow); {column name: host array}. The query's dispatches, new
    signatures and memory peak land on the root (EXPLAIN ANALYZE). Holds
    ``dispatch.exec_lock()`` throughout: concurrent sessions' queries
    run on the device one at a time."""
    metric.QUERIES.inc()
    with dispatch.exec_lock():
        return _run_operator(root)


def _run_operator(root: Operator) -> dict[str, np.ndarray]:
    overlap = settings.get("sql.distsql.readback_overlap")
    d0, c0 = dispatch.total(), dispatch.compiles()
    with query_scope() as qmon:
        try:
            for _ in range(MAX_ATTEMPTS):
                root.init()
                shrink = _ReadbackShrink()
                outs = _pull(root, shrink, overlap)
                if not _post_run_updates(root):
                    shrink.finish(outs, root.output_schema,
                                  root.dictionaries, root)
                    break
            else:
                raise RuntimeError(
                    "speculative emission capacities failed to converge in "
                    f"{MAX_ATTEMPTS} attempts")
        finally:
            root.stats.kernel_dispatches += dispatch.total() - d0
            root.stats.kernel_compiles += dispatch.compiles() - c0
            root.close()
            root._query_mem_peak = qmon.high_water
    if not outs:
        return {n: np.array([]) for n in root.output_schema.names}
    return {
        # crlint: allow-mem-accounting(the query's result, already read back to the host tile by tile: one concat at query end)
        n: np.concatenate([o[n] for o in outs])
        for n in root.output_schema.names
    }


def host_syncs(root: Operator) -> dict[str, int]:
    """Host syncs of the last run, per operator (pre-order position and
    class name), nonzero entries only."""
    out: dict[str, int] = {}
    stack = [root]
    pos = 0
    while stack:
        op = stack.pop()
        if op.stats.host_syncs:
            out[f"{pos}:{type(op).__name__}"] = op.stats.host_syncs
        pos += 1
        stack.extend(reversed(op.children()))
    return out


def _walk(root: Operator):
    stack = [root]
    while stack:
        op = stack.pop()
        yield op
        stack.extend(reversed(op.children()))


def io_report(root: Operator) -> dict:
    """What the last run moved past the device: the tables that streamed,
    the operators that spilled and what to, the bytes streaming scans
    uploaded host -> device (with the copies' device seconds, the
    upload-slot waits, and the host seconds the scans waited for a tile's
    fill), the bytes spills staged on the host, and the host syncs in
    all. Call after the device has finished the run."""
    streamed, spills = [], []
    h2d_bytes = h2d_s = fill_wait_s = 0.0
    waits = staged = syncs = 0
    for op in _walk(root):
        syncs += op.stats.host_syncs
        staged += op.stats.staged_bytes
        st = getattr(op, "_stream", None)
        if getattr(op, "streaming", False) and st is not None:
            streamed.append(op.table.name)
            h2d_bytes += st.h2d_bytes
            h2d_s += st.copy_seconds()
            waits += st.host_waits
            fill_wait_s += st.fill_wait_s
        inner = getattr(op, "_inner", None)  # DistinctOp's aggregation
        ext = (getattr(inner or op, "_external", None)
               or getattr(op, "_grace", None))
        if ext is not None:
            spills.append(f"{type(op).__name__}->{type(ext).__name__}")
    return {"streamed": sorted(streamed), "spills": sorted(spills),
            "h2d_bytes": int(h2d_bytes), "h2d_s": h2d_s,
            "upload_waits": waits, "fill_wait_s": fill_wait_s,
            "staged_bytes": staged,
            "host_syncs_total": syncs}


def _fold_operator_spans(parent, op: Operator) -> None:
    """Fold the operator tree's ComponentStats into synthetic child spans
    (the execstats fold): inclusive wall time per operator, nesting as in
    the operator tree."""
    from ..utils import tracing

    st = op.stats
    child = tracing.synthetic_span(parent, f"operator/{type(op).__name__}",
                                   float(st.time_s), rows=int(st.rows),
                                   batches=int(st.batches))
    for c in op.children():
        _fold_operator_spans(child, c)


def run_plan_with_stats(plan: PlanNode, catalog: Catalog):
    """Run with ComponentStats collection -> (results, root operator);
    the stats fold into the ``query`` span left on the root."""
    from ..utils import tracing

    root = plan_builder.build(plan, catalog)
    root.collect_stats(True)
    with tracing.span("query") as sp:
        res = run_operator(root)
        sp.record(root.stats)
        _fold_operator_spans(sp, root)
    root._trace_span = sp  # EXPLAIN ANALYZE renders the tree from here
    _LAST_TRACE.span = sp
    return res, root


_LAST_TRACE = threading.local()


def last_trace_span():
    """This thread's most recent run_plan_with_stats root span: EXPLAIN
    ANALYZE (DEBUG) reads it for its bundle after the rel API has
    discarded the root operator."""
    return getattr(_LAST_TRACE, "span", None)


def run_plan(plan: PlanNode, catalog: Catalog) -> dict[str, np.ndarray]:
    return run_operator(plan_builder.build(plan, catalog))
