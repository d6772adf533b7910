"""Whole-pipeline fusion pass over the built operator tree; the port of
``cockroach_tpu.flow.fuse``.

Buffering consumers (aggregate partials, sort spool, join build spool)
already compose their tile function with the streaming chain below them
into one function (``_consume`` / ``_consume_op`` in flow/operators.py,
over the ``stream_parts`` contract). What that cannot cover is a maximal
chain whose PARENT pulls per operator: the tree root, a limit, a
non-fusable join's probe side. This pass closes the gap at plan-build
time (plan/builder.py, behind ``sql.distsql.fusion.enabled``):

- ``FusedPipeline`` wraps the top of any maximal chain of stateless
  per-tile operators (filter / project / fusable hash-join probes) whose
  parent does not fuse; its pull loop composes the chain into ONE function
  per tile (one CUDA graph replay on the card).
- ``_BarrierSource`` adapts a pipeline barrier (a general join's output,
  a Grace join) into a chain source, so the per-tile operators above it
  still collapse.

``children()`` keeps every member reachable, so the runtime's
``_post_run_updates`` still reaches each member's deferred counters, and
stats collection falls back to per-operator pulls as ``_consume`` does.
``plan_fusion_groups`` mirrors the pass over the PLAN tree for EXPLAIN.
A hash-bucket stream (a cross-host repartition) is a chain link; the
stream synchronizers are barriers whose inputs fuse on their own.
"""

from __future__ import annotations

from . import dispatch
from .operator import Operator
from .operators import (
    AggregateOp,
    DistinctOp,
    FilterOp,
    HashBucketOp,
    HashJoinOp,
    LimitOp,
    MergeJoinOp,
    OrderedSyncOp,
    ParallelUnorderedSyncOp,
    ProjectOp,
    ScalarAggregateOp,
    ScanOp,
    SmallGroupAggregateOp,
    SortOp,
    TopKOp,
    UnionOp,
    WindowOp,
    _identity_fn,
)

# stateless per-tile chain links the pass collapses
_CHAIN = (FilterOp, ProjectOp, HashBucketOp)
# buffering consumers that fuse their own spool chain (_consume); their
# children are never wrapped: the consumer drives the composition
_CONSUMERS = (AggregateOp, ScalarAggregateOp, SortOp, TopKOp, WindowOp,
              SmallGroupAggregateOp)


def _is_chain_link(op) -> bool:
    if isinstance(op, _CHAIN):
        return True
    # general (duplicate-key inner/left) joins are chain members too: they
    # run as sources, driving the chain below through their speculative
    # emit function, and the chain above composes on their output tiles
    return isinstance(op, HashJoinOp) and (op._fusable or op._gen_fusable)


class _BarrierSource(Operator):
    """Adapts a pipeline barrier into a fused-chain source: stream_tiles
    pulls the barrier per batch, so the per-tile chain ABOVE it still
    composes into one function. Pure delegation otherwise."""

    # a segment boundary: joins below it never share the function
    # composed above it (HashJoinOp.fused_depth stops counting here)
    _chain_split = True

    def __init__(self, inner: Operator):
        super().__init__()
        self.inner = inner
        self.child = inner  # chain walks see through it for metadata
        self.output_schema = inner.output_schema
        self.dictionaries = inner.dictionaries
        self.col_stats = inner.col_stats

    def children(self):
        return [self.inner]

    def init(self):
        self.inner.init()
        super().init()

    def stream_parts(self):
        if not self._initialized:
            self.init()
        return self, _identity_fn, ()

    def stream_tiles(self):
        while True:
            b = self.inner.next_batch()
            if b is None:
                return
            yield b

    def _next(self):
        return self.inner.next_batch()

    def close(self):
        self.inner.close()


class FusedPipeline(Operator):
    """Consumer of last resort for a streaming chain: drives the chain
    below ``top`` through one function per tile via the stream_parts
    contract (the role _consume plays for buffering consumers, for parents
    that pull per operator)."""

    def __init__(self, top: Operator, members: list[Operator]):
        super().__init__()
        self.top = top
        self.child = top  # chain walks (fused_depth) see through it
        self.members = members
        self.output_schema = top.output_schema
        # shared references, not copies
        self.dictionaries = top.dictionaries
        self.col_stats = top.col_stats
        self._gen = None

    def children(self):
        return [self.top]

    def init(self):
        self.top.init()
        super().init()
        self._gen = None

    def stream_parts(self):
        # a parent that CAN fuse composes straight through the wrapper
        return self.top.stream_parts()

    def _tiles(self):
        # stats collection forces the per-operator path so every member's
        # batch and row counts stay observable (the _consume rule)
        parts = None if self._collect else self.top.stream_parts()
        if parts is None:
            # a barrier below (Grace spill, stats, the deep-join valve,
            # hashed probes): per-operator pulls
            while True:
                b = self.top.next_batch()
                if b is None:
                    return
                yield b
            return
        src, cfn, args = parts
        if cfn is _identity_fn:
            # the top drives itself (source-mode join emission, streaming
            # scan): composing the identity would add a call per tile
            yield from src.stream_tiles()
            return
        cached = getattr(self, "_pipe_fn", None)
        if cached is None or cached[0] is not cfn:
            # chains with structural keys share one function process-wide
            pkey = getattr(self.top, "_parts_key", None)
            cached = (cfn, dispatch.jit(
                cfn, key=None if pkey is None else ("pipe", pkey)))
            self._pipe_fn = cached
        fn = cached[1]
        for t in src.stream_tiles():
            yield fn(t, *args)

    def _next(self):
        if self._gen is None:
            self._gen = self._tiles()
        return next(self._gen, None)

    def close(self):
        self.top.close()


def _wrap(op: Operator) -> FusedPipeline:
    members: list[Operator] = []
    cur = op
    while _is_chain_link(cur):
        members.append(cur)
        cur = cur.child
    members.append(cur)  # the source (scan / barrier adapter) included
    return FusedPipeline(op, members)


def _chain_child(child: Operator, jrun: int = 0) -> Operator:
    """Rewrite an input that a fusing parent composes through: recurse
    (never wrap: the parent drives the chain), then adapt a barrier child
    into a chain source so composition does not stop there.

    ``jrun`` counts join probes already committed to the function being
    composed above. When one more fusable join would pass
    ``sql.distsql.max_fused_joins``, the chain splits HERE: the deeper
    part becomes its own FusedPipeline behind a barrier source."""
    from ..utils import settings

    if (isinstance(child, HashJoinOp) and child._fusable
            and jrun >= settings.get("sql.distsql.max_fused_joins")):
        return _BarrierSource(_rewrite(child, parent_fuses=False))
    child = _rewrite(child, parent_fuses=True, jrun=jrun)
    if _is_chain_link(child) or isinstance(child, ScanOp):
        return child
    return _BarrierSource(child)


def _rewrite(op: Operator, parent_fuses: bool, jrun: int = 0) -> Operator:
    if isinstance(op, _CHAIN):
        op.child = _chain_child(op.child, jrun)
        return op if parent_fuses else _wrap(op)
    if isinstance(op, HashJoinOp):
        if op._fusable:
            # this probe joins the composed function: one more toward the
            # budget
            op.child = _chain_child(op.child, jrun + 1)
        elif op._gen_fusable:
            # source mode: the chain below composes into THIS join's emit
            # function (its own budget), not the parent's
            op.child = _chain_child(op.child, 1)
        else:
            op.child = _rewrite(op.child, parent_fuses=False)
        # build sides spool through one function already (_consume_op),
        # and _plan_analytic walks their concrete types: never wrap them
        op.build = _rewrite(op.build, parent_fuses=True)
        fusy = op._fusable or op._gen_fusable
        return op if (not fusy or parent_fuses) else _wrap(op)
    if isinstance(op, MergeJoinOp):
        op.child = _rewrite(op.child, parent_fuses=False)
        op.build = _rewrite(op.build, parent_fuses=True)
        return op
    if isinstance(op, DistinctOp):
        # DistinctOp and its inner AggregateOp share ONE child object;
        # rewire both to the same rewritten instance
        child = _rewrite(op._inner.child, parent_fuses=True)
        op._inner.child = child
        op.child = child
        return op
    if isinstance(op, _CONSUMERS):
        # no barrier adapter: a consumer's DIRECT barrier child has no
        # chain to compose with
        op.child = _rewrite(op.child, parent_fuses=True)
        return op
    if isinstance(op, LimitOp):
        op.child = _rewrite(op.child, parent_fuses=False)
        return op
    if isinstance(op, (UnionOp, OrderedSyncOp, ParallelUnorderedSyncOp)):
        op._children = [_rewrite(c, parent_fuses=False)
                        for c in op._children]
        return op
    # sources and external operators: nothing below to fuse here
    return op


def fuse_operators(root: Operator) -> Operator:
    """Apply the fusion pass to a built operator tree; returns the
    (possibly wrapped) root. Mutates child links in place: run it before
    init()."""
    return _rewrite(root, parent_fuses=False)


# ---------------------------------------------------------------------------
# EXPLAIN support: the grouping mirrored over the PLAN tree


def plan_fusion_groups(plan) -> dict[int, int]:
    """id(plan node) -> pipeline group number, mirroring the pass (and the
    consumers' spool fusion) over the plan tree, so EXPLAIN can show which
    operators collapse into one function. Advisory: runtime fallbacks
    (Grace spills, the max_fused_joins valve, stats collection) are not
    modelled. Groups of one are omitted."""
    from ..plan import spec as S
    from ..utils import settings

    links = (S.Filter, S.Project, S.HashBucket)
    heads = (S.Aggregate, S.ScalarAggregate, S.Sort, S.TopK, S.Window,
             S.Distinct)
    groups: dict[int, int] = {}
    next_group = [1]

    def fusable_join(n) -> bool:
        if not isinstance(n, S.HashJoin):
            return False
        if n.spec.build_unique or n.spec.join_type in ("semi", "anti"):
            return True
        return (n.spec.join_type in ("inner", "left")
                and settings.get("sql.distsql.fusion.general_probe"))

    def assign(members) -> None:
        if len(members) < 2:
            return
        g = next_group[0]
        next_group[0] += 1
        for m in members:
            groups[id(m)] = g

    def descend(n):
        """The chain below a group head -> (members, the barrier node
        still to walk, None when the chain ends at a table scan)."""
        members = []
        while True:
            if isinstance(n, S.Exchange):
                n = n.input  # single-device builds elide the exchange
            elif isinstance(n, links):
                members.append(n)
                n = n.input
            elif fusable_join(n):
                members.append(n)
                walk(n.build)  # the build spool fuses its own chain
                n = n.probe
            elif isinstance(n, S.TableScan):
                members.append(n)
                return members, None
            else:
                return members, n

    def walk(n) -> None:
        if isinstance(n, S.Exchange):
            walk(n.input)
            return
        if isinstance(n, heads):
            members, barrier = descend(n.input)
            assign([n] + members)
            if barrier is not None:
                walk(barrier)
            return
        if isinstance(n, links) or fusable_join(n):
            members, barrier = descend(n)
            assign(members)
            if barrier is not None:
                walk(barrier)
            return
        if isinstance(n, (S.HashJoin, S.MergeJoin)):
            walk(n.probe)
            walk(n.build)
            return
        if isinstance(n, (S.Union, S.StreamUnion)):
            for c in n.inputs:
                walk(c)
            return
        if hasattr(n, "input"):
            walk(n.input)

    walk(plan)
    return groups


def unwrap(op):
    """Strip pass-inserted wrappers, so plan-tree walks keep their
    one-to-one plan-node / operator correspondence."""
    while isinstance(op, (FusedPipeline, _BarrierSource)):
        op = op.top if isinstance(op, FusedPipeline) else op.inner
    return op
