"""Sort kernels — the colexec Sorter analog; the port of
``cockroach_tpu.ops.sort``.

Every key column maps to operands whose ascending order equals SQL order
(ops/keys.py); dead rows sort last via a leading ~mask bit, so sorted
output is also compacted. ``jax.lax.sort(operands, num_keys=n)`` with the
row index as the final key becomes successive stable ``torch.sort``
passes from the last operand to the first (``stable_argsort``): the same
permutation, ties kept in row order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..coldata.batch import Batch, Column, device_table, pack_be_words
from ..coldata.types import Family, Schema, SQLType
from ..storage.keys import flip
from . import keys as key_ops


@dataclass(frozen=True)
class SortKey:
    col: int
    desc: bool = False
    # CockroachDB semantics: NULLs order first ascending, last descending.
    nulls_first: bool | None = None

    def effective_nulls_first(self) -> bool:
        return (not self.desc) if self.nulls_first is None else self.nulls_first


def sortable(op: torch.Tensor) -> torch.Tensor:
    """A sort operand as a tensor torch.sort orders correctly: int64
    operands are unsigned words (flip bit 63), bools become int8, the
    rest (int32 ranks, float64) order natively."""
    if op.dtype == torch.int64:
        return flip(op)
    if op.dtype == torch.bool:
        return op.to(torch.int8)
    return op


# crlint: allow-mem-accounting(traced kernel: a permutation lane shaped like the charged input tile)
def stable_argsort(operands: list[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting rows lexicographically by `operands` (first
    most significant), ties in row order: stable passes, last key first."""
    n = operands[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=operands[0].device)
    for op in reversed(operands):
        perm = perm[torch.sort(sortable(op)[perm], stable=True).indices]
    return perm


def order_keys(
    data: torch.Tensor,
    valid: torch.Tensor,
    k: SortKey,
    t: SQLType,
    rank_table: np.ndarray | None = None,
) -> list[torch.Tensor]:
    """Unpacked sort-key operands whose ascending order (``sortable``)
    equals SQL order for this key: a NULL flag, then the value (a NaN
    flag first for floats). Integer families are sign-flipped 64-bit words;
    DESC inverts bits / negates."""
    nf = k.effective_nulls_first()
    null_key = valid if nf else ~valid  # False sorts first
    if t.family is Family.STRING:
        if rank_table is None:
            raise ValueError("STRING sort needs a dictionary rank table")
        table = device_table(rank_table, data.device)
        codes = torch.clamp(data.to(torch.int64), 0, table.shape[0] - 1)
        u = table[codes].to(torch.int32)
        return [null_key, -u if k.desc else u]
    if t.family is Family.FLOAT:
        d = data.to(torch.float64)
        isnan = torch.isnan(d)
        nan_key = isnan if k.desc else ~isnan  # NaN smallest in SQL order
        d = torch.where(isnan, 0.0, d)
        return [null_key, nan_key, -d if k.desc else d]
    if t.family is Family.BOOL:
        return [null_key, data != k.desc]
    if t.family is Family.BYTES:
        words = pack_be_words(data)
        return [null_key] + [
            ~words[:, i] if k.desc else words[:, i]
            for i in range(words.shape[1])
        ]
    u = flip(data.to(torch.int64))
    if k.desc:
        u = ~u
    return [null_key, u]


def pack_sort_operands(
    batch: Batch,
    schema: Schema,
    keys: tuple[SortKey, ...],
    rank_tables: dict[int, np.ndarray] | None = None,
    col_stats: dict[int, tuple] | None = None,
    include_mask: bool = True,
) -> list[torch.Tensor]:
    """Bit-packed sort operands for the key list: dead rows last (leading
    ~mask bit), then per-key [null flag, value] segments packed into as
    few 64-bit words as possible; float keys ride as native float64."""
    rank_tables = rank_tables or {}
    col_stats = col_stats or {}
    segs: list = []
    if include_mask:
        segs.append(key_ops.BitSeg(1, (~batch.mask).to(torch.int64)))
    for k in keys:
        c = batch.cols[k.col]
        segs.extend(key_ops.key_segments(
            c.data, c.valid, schema.types[k.col], k.desc,
            k.effective_nulls_first(),
            rank_table=rank_tables.get(k.col),
            stats=col_stats.get(k.col),
        ))
    return key_ops.pack_operands(segs)


def sort_perm(
    batch: Batch,
    schema: Schema,
    keys: tuple[SortKey, ...],
    rank_tables: dict[int, np.ndarray] | None = None,
    col_stats: dict[int, tuple] | None = None,
) -> torch.Tensor:
    """Stable permutation ordering live rows by keys, dead rows last."""
    return stable_argsort(
        pack_sort_operands(batch, schema, keys, rank_tables, col_stats))


def apply_perm(batch: Batch, perm: torch.Tensor) -> Batch:
    cols = tuple(
        Column(data=c.data[perm], valid=c.valid[perm]) for c in batch.cols
    )
    return Batch(cols=cols, mask=batch.mask[perm])


def sort_batch(
    batch: Batch,
    schema: Schema,
    keys: tuple[SortKey, ...],
    rank_tables: dict[int, np.ndarray] | None = None,
    col_stats: dict[int, tuple] | None = None,
) -> Batch:
    return apply_perm(
        batch, sort_perm(batch, schema, keys, rank_tables, col_stats)
    )


# crlint: allow-mem-accounting(traced kernel: k-selection transients shaped like the charged input tile)
def topk_batch(
    batch: Batch,
    schema: Schema,
    keys: tuple[SortKey, ...],
    k: int,
    capacity: int,
    rank_tables: dict[int, np.ndarray] | None = None,
    col_stats: dict[int, tuple] | None = None,
) -> Batch:
    """Stable k-selection: the first ``k`` live rows of the stable sort
    order, re-materialized at ``capacity`` (>= k). Equal keys at the k
    boundary resolve by original row position — exactly the rows a full
    sort + LIMIT k keeps — so folding per-tile selections through concat
    (earlier tiles first) stays bit-identical with the full sort. Output
    is sorted and compacted (dead rows masked off)."""
    perm = sort_perm(batch, schema, keys, rank_tables, col_stats)
    idx = torch.arange(capacity, device=batch.device)
    take = perm[torch.clamp(idx, max=batch.capacity - 1)]
    out = apply_perm(batch, take)
    keep = out.mask & (idx < batch.capacity) & (idx < k)
    return out.with_mask(keep)


def limit_mask(batch: Batch, limit: int, offset: int = 0) -> Batch:
    """LIMIT/OFFSET over live rows in tile order (apply after sort_batch,
    whose output is compacted)."""
    pos = torch.cumsum(batch.mask.to(torch.int64), 0) - 1
    keep = batch.mask & (pos >= offset) & (pos < offset + limit)
    return batch.with_mask(keep)
