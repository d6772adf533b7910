"""Flow execution — the FlowCoordinator/Materializer pull loop; the port
of ``cockroach_tpu.flow.runtime``'s ``run_operator`` and ``run_plan``.

``run_operator`` pulls every tile from the root operator and materializes
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
from .operator import Operator


def run_operator(root: Operator) -> dict[str, np.ndarray]:
    """Run the operator tree once; {column name: host array}. Each output
    tile's readback is one host sync, counted on the root."""
    outs: list[dict[str, np.ndarray]] = []
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


def run_plan(plan: PlanNode, catalog: Catalog) -> dict[str, np.ndarray]:
    return run_operator(plan_builder.build(plan, catalog))
