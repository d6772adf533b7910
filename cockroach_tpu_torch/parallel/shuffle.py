"""Hash repartition over the mesh — the HashRouter + Outbox/Inbox shuffle;
the port of ``cockroach_tpu.parallel.shuffle``.

Reference: colflow/routers.go:420 (HashRouter) hash-partitions each
producer's batches into one stream per consumer. Here, as in the JAX
package, the mechanism is one collective: each shard buckets its rows by
key hash, scatters them into per-destination send buffers
[D, send_cap], ``mesh.all_to_all`` delivers every bucket to its owner,
and each shard compacts what it received.

Static-shape contract: rows that overflow their destination bucket, and
received rows past the output capacity, are counted per shard so the
host can retry with a larger factor (the join/groupby capacity pattern).
"""

from __future__ import annotations

import numpy as np
import torch

from ..coldata.batch import (Batch, Column, compact_index, device_table,
                             scatter_rows)
from ..coldata.types import Schema
from ..ops.hashing import bucket as hash_bucket
from ..ops.hashing import hash_columns
from ..storage.keys import flip
from . import mesh as mesh_mod


# crlint: allow-mem-accounting(shuffle program: send buffers are [D, send_cap] statics from make_shuffle capacities the planner budgets)
def _send(batch: Batch, keys, types, hash_tables, D: int, send_cap: int,
          hot):
    """One shard's send side -> (send tree [D, send_cap, ...], rows kept
    local (hot keys) or None, bucket overflow, rows sent)."""
    cap = batch.capacity
    dev = batch.device
    h = hash_columns([batch.cols[i] for i in keys], types, hash_tables)
    bucket = hash_bucket(h, D).to(torch.int64)  # the unsigned remainder
    keep = None
    if hot is not None:
        # heavy-hitter keys keep their rows LOCAL (the hash router's skew
        # escape hatch); the caller replicates their build rows
        table = flip(device_table(hot, dev, view=np.int64))
        fh = flip(h)
        pos = torch.clamp(torch.searchsorted(table, fh), 0,
                          table.shape[0] - 1)
        keep = batch.mask & (table[pos] == fh)
        bucket = torch.where(keep, D, bucket)
    bucket = torch.where(batch.mask, bucket, D)  # dead rows sort last

    # slot within the destination bucket: stable rank in bucket
    sb, si = torch.sort(bucket, stable=True)
    first = torch.searchsorted(sb, sb, side="left")
    slot = torch.empty(cap, dtype=torch.int64, device=dev)
    slot.index_copy_(0, si, torch.arange(cap, device=dev) - first)

    send_live = batch.mask if keep is None else (batch.mask & ~keep)
    live = send_live & (slot < send_cap)
    overflow = (send_live & (slot >= send_cap)).sum(dtype=torch.int64)
    n = D * send_cap
    dest = torch.where(live, bucket * send_cap + slot, n)
    send = mesh_mod.tree_map(
        lambda x: scatter_rows(x, dest, n).reshape(
            (D, send_cap) + tuple(x.shape[1:])), batch)
    return send, keep, overflow, live.sum(dtype=torch.int64)


# crlint: allow-mem-accounting(shuffle program: the receive tile is the out_cap static make_shuffle's capacities budget)
def _receive(flat: Batch, batch: Batch, keep, out_cap: int):
    """One shard's receive side: received rows (plus locally kept hot
    rows) compacted into an `out_cap` tile -> (batch, rows dropped)."""
    if keep is None:
        whole = flat
    else:
        whole = mesh_mod.tree_map(lambda a, b: torch.cat([a, b]),
                                  flat, batch.with_mask(keep))
    m = whole.mask
    dest = compact_index(m, out_cap)
    received = m.sum(dtype=torch.int64)
    cols = tuple(Column(data=scatter_rows(c.data, dest, out_cap),
                        valid=scatter_rows(c.valid, dest, out_cap))
                 for c in whole.cols)
    mask = torch.arange(out_cap, device=m.device) < torch.clamp(
        received, max=out_cap)
    return (Batch(cols=cols, mask=mask),
            torch.clamp(received - out_cap, min=0))


def shuffle_shards(shards: list, mesh, keys, types, hash_tables,
                   send_cap: int, out_cap: int, hot=None):
    """Repartition per-shard batches by key hash -> (per-shard output
    batches, per-shard overflow [1] int64: bucket overflow plus dropped
    rows, per-shard rows sent). `hot`: sorted uint64 key hashes whose
    rows stay on their shard."""
    D = mesh.size
    sends, keeps, bucket_ovf, sent = zip(*[
        _send(b, keys, types, hash_tables, D, send_cap, hot)
        for b in shards])
    recv = mesh_mod.all_to_all(list(sends), mesh)
    del sends  # the send buffers die before the receive side allocates
    outs, ovfs = [], []
    for j, (flat, b) in enumerate(zip(recv, shards)):
        flat = mesh_mod.tree_map(
            lambda x: x.reshape((D * send_cap,) + tuple(x.shape[2:])), flat)
        out, dropped = _receive(flat, b, keeps[j], out_cap)
        outs.append(out)
        ovfs.append((bucket_ovf[j] + dropped).reshape(1))
    return outs, ovfs, list(sent)


def send_capacity(local_capacity: int, D: int, send_factor: float) -> int:
    """make_shuffle's per-destination bucket: twice the fair share by
    default, a multiple of 128, at least 128."""
    return max(128, int(local_capacity / D * send_factor) // 128 * 128)


def make_shuffle(
    mesh,
    schema: Schema,
    keys: tuple[int, ...],
    local_capacity: int,
    hash_tables: dict[int, np.ndarray] | None = None,
    send_factor: float = 2.0,
    out_capacity: int | None = None,
    hot_hashes: np.ndarray | None = None,
):
    """A shuffle program: (per-shard batches) -> (per-shard batches
    repartitioned by key hash, [D] overflow counts). After it, every row
    whose keys hash equal lives on one shard.

    ``hot_hashes`` (64-bit key hashes, any order) marks heavy-hitter keys
    whose rows stay on their producing shard instead of moving to
    ``hash % D``; every other row routes normally."""
    D = mesh.size
    types = [schema.types[i] for i in keys]
    send_cap = send_capacity(local_capacity, D, send_factor)
    out_cap = out_capacity or local_capacity
    hot = None
    if hot_hashes is not None and len(hot_hashes) > 0:
        hot = np.sort(np.asarray(hot_hashes, dtype=np.uint64))

    def run(shards):
        outs, ovfs, _ = shuffle_shards(shards, mesh, keys, types,
                                       hash_tables, send_cap, out_cap, hot)
        return outs, gather_counts(ovfs, mesh)

    # one program per shuffle: it counts one dispatch, as the reference's
    # dispatch.jit(shard_map(...)) does
    return mesh_mod.program(run, mesh)


# crlint: allow-mem-accounting(one count per shard)
def gather_counts(per_shard: list, mesh) -> torch.Tensor:
    """Per-shard [1] counts -> one [D] tensor on the first shard's device
    (the reference's P(AXIS) overflow output)."""
    d0 = mesh.devices[0]
    return torch.cat([x.reshape(1).to(d0, non_blocking=True)
                      for x in per_shard])
