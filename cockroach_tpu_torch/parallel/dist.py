"""Distributed query pipelines — the DistSQL physical planner analog; the
port of ``cockroach_tpu.parallel.dist``.

Reference: pkg/sql/distsql_physical_planner.go plans partitioned
TableReaders per node, a local (partial) aggregation, a hash-router
shuffle and a final aggregation; joins shuffle both sides on the join key
so each consumer joins co-located partitions. Each of those multi-node
flow graphs is one program over the mesh here:

    partial sort_groupby (per shard)  ->  all_to_all shuffle by key hash
        ->  merge sort_groupby (per shard)  ->  finalize
"""

from __future__ import annotations

import numpy as np

from ..coldata.types import Schema
from ..ops import aggregation as agg_ops
from ..ops import join as join_ops
from . import mesh as mesh_mod
from .shuffle import gather_counts, send_capacity, shuffle_shards


# a global batch row-sharded across the mesh (the partitioned-scan
# placement; the capacity must divide by the mesh size)
shard_batch = mesh_mod.shard_rows


def make_distributed_groupby(
    mesh,
    schema: Schema,
    group_cols: tuple[int, ...],
    aggs: tuple[agg_ops.AggSpec, ...],
    local_capacity: int,
    hash_tables: dict[int, np.ndarray] | None = None,
    send_factor: float = 2.0,
):
    """-> (program, output schema). program: per-shard batches ->
    (per-shard final batches, [D] shuffle overflow counts). Every group
    lands on exactly one shard, so the union of the shards is the result
    without a gather."""
    D = mesh.size
    partial_specs, state_schema, final_map = agg_ops.partial_layout(
        schema, group_cols, aggs)
    k = len(group_cols)
    merge_specs = agg_ops.merge_specs_for(partial_specs, k)
    state_keys = tuple(range(k))
    key_types = [state_schema.types[i] for i in state_keys]
    final_schema = agg_ops.agg_output_schema(schema, group_cols, aggs,
                                             "final")
    lcap = local_capacity
    send_cap = send_capacity(lcap, D, send_factor)

    def run(shards):
        parts = [agg_ops.sort_groupby(b, schema, group_cols,
                                      partial_specs)[0] for b in shards]
        shuffled, ovfs, _ = shuffle_shards(parts, mesh, state_keys,
                                           key_types, hash_tables, send_cap,
                                           lcap)
        outs = [agg_ops.finalize_states(
            agg_ops.sort_groupby(s, state_schema, state_keys,
                                 merge_specs)[0], final_map, k)
            for s in shuffled]
        return outs, gather_counts(ovfs, mesh)

    return mesh_mod.program(run, mesh), final_schema


def make_distributed_join(
    mesh,
    probe_schema: Schema,
    probe_keys: tuple[int, ...],
    build_schema: Schema,
    build_keys: tuple[int, ...],
    spec: join_ops.JoinSpec,
    probe_capacity: int,
    build_capacity: int,
    probe_hash_tables=None,
    build_hash_tables=None,
    build_code_remaps=None,
    send_factor: float = 2.0,
):
    """Shuffle join: both sides repartition by key hash, then each shard
    joins its co-located partitions (the both-sides-hash-routed hash
    join of a unique build). -> (program, output schema); program maps
    per-shard (probe, build) -> (per-shard joined batches, [D] overflow
    counts)."""
    D = mesh.size
    p_types = [probe_schema.types[i] for i in probe_keys]
    b_types = [build_schema.types[i] for i in build_keys]
    p_send = send_capacity(probe_capacity, D, send_factor)
    b_send = send_capacity(build_capacity, D, send_factor)

    def run(probes, builds):
        ps, povs, _ = shuffle_shards(probes, mesh, probe_keys, p_types,
                                     probe_hash_tables, p_send,
                                     probe_capacity)
        bs, bovs, _ = shuffle_shards(builds, mesh, build_keys, b_types,
                                     build_hash_tables, b_send,
                                     build_capacity)
        outs, ovfs = [], []
        for p, b, pov, bov in zip(ps, bs, povs, bovs):
            out, unresolved = join_ops.hash_join_static(
                p, probe_schema, probe_keys, b, build_schema, build_keys,
                spec, p.capacity, 1, probe_hash_tables, build_hash_tables,
                build_code_remaps)
            outs.append(out)
            ovfs.append(pov + bov + unresolved)
        return outs, gather_counts(ovfs, mesh)

    return mesh_mod.program(run, mesh), join_ops.join_output_schema(
        probe_schema, build_schema, spec)
