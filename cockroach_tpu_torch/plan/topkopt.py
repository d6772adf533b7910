"""Top-k pushdown — rewrite Limit(Sort) into Limit(TopK); the port of
``cockroach_tpu.plan.topkopt``.

The rewrite swaps the Sort under a Limit for a TopK node carrying
k = limit + offset; flow/operators.TopKOp folds a per-tile stable
k-selection over the input so the query neither spools nor fully sorts
it. The Limit stays on top and applies the OFFSET over the sorted top-k
tile — bit-identical to the Sort + Limit plan it replaces.

Gate: k must stay at or under ``TOPK_MAX_K`` (the reference's
``sql.opt.topk.max_k`` default) — a huge LIMIT makes the O(k)
accumulator no better than the sort spool it replaces.
"""

from __future__ import annotations

import dataclasses

from . import spec as S

TOPK_MAX_K = 65536


def push_topk(plan: S.PlanNode) -> S.PlanNode:
    """Recursively rewrite eligible Limit(Sort) subtrees."""
    if (isinstance(plan, S.Limit)
            and isinstance(plan.input, S.Sort)
            and plan.limit + plan.offset <= TOPK_MAX_K):
        srt = plan.input
        return S.Limit(
            S.TopK(push_topk(srt.input), srt.keys, plan.limit + plan.offset),
            plan.limit, plan.offset,
        )
    # generic recursion over PlanNode dataclass fields
    if not dataclasses.is_dataclass(plan):
        return plan
    changes = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, S.PlanNode):
            nv = push_topk(v)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, tuple) and v and isinstance(v[0], S.PlanNode):
            nv = tuple(push_topk(x) for x in v)
            if any(a is not b for a, b in zip(nv, v)):
                changes[f.name] = nv
    return dataclasses.replace(plan, **changes) if changes else plan
