"""Flow execution — the FlowCoordinator/Materializer pull loop; the port
of ``cockroach_tpu.flow.runtime``'s ``run_operator`` and ``run_plan``.

``run_operator`` pulls every tile from the root operator, inside one
query memory monitor (``flow/memory.query_scope``), and materializes
live rows to host numpy columns (decoding string dictionaries). It has no
retry loop (the reference's serves speculative capacities, which the
port does not use) and no readback overlap.
"""

from __future__ import annotations

import numpy as np

from ..catalog import Catalog
from ..coldata.batch import to_host
from ..plan import builder as plan_builder
from ..plan.spec import PlanNode
from .memory import query_scope
from .operator import Operator


def run_operator(root: Operator) -> dict[str, np.ndarray]:
    """Run the operator tree once; {column name: host array}. Each output
    tile's readback is one host sync, counted on the root."""
    outs: list[dict[str, np.ndarray]] = []
    with query_scope():
        root.init()
        try:
            while True:
                b = root.next_batch()
                if b is None:
                    break
                root.stats.host_syncs += 1
                outs.append(to_host(b, root.output_schema, root.dictionaries))
        finally:
            root.close()
    if not outs:
        return {n: np.array([]) for n in root.output_schema.names}
    return {
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
    uploaded host -> device (with the copies' device seconds and the
    upload-slot waits), the bytes spills staged on the host, and the host
    syncs in all. Call after the device has finished the run."""
    streamed, spills = [], []
    h2d_bytes = h2d_s = 0.0
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
        inner = getattr(op, "_inner", None)  # DistinctOp's aggregation
        ext = (getattr(inner or op, "_external", None)
               or getattr(op, "_grace", None))
        if ext is not None:
            spills.append(f"{type(op).__name__}->{type(ext).__name__}")
    return {"streamed": sorted(streamed), "spills": sorted(spills),
            "h2d_bytes": int(h2d_bytes), "h2d_s": h2d_s,
            "upload_waits": waits, "staged_bytes": staged,
            "host_syncs_total": syncs}


def run_plan(plan: PlanNode, catalog: Catalog) -> dict[str, np.ndarray]:
    return run_operator(plan_builder.build(plan, catalog))
