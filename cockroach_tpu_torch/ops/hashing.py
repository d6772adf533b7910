"""Vectorized multi-column hashing — the colexechash analog; the port of
``cockroach_tpu.ops.hashing``.

Each key column is bit-cast to a 64-bit word, mixed with splitmix64 and
folded into the running row hash. The words follow the port's uint64
convention (``storage/keys.py``): int64 bit patterns, so multiplies and
adds wrap exactly as uint64 arithmetic does, logical right shifts are
``(x >> k) & mask``, and the unsigned modulo of ``bucket`` is emulated
over 32-bit halves. The bits equal the reference's uint64 hashes.

STRING columns hash via their dictionary's byte-hash table
(``coldata.Dictionary.hashes``) gathered by code, so equal strings hash
equally across tables with different dictionaries.
"""

from __future__ import annotations

import numpy as np
import torch

from ..coldata.batch import Column, device_table
from ..coldata.types import Family, SQLType


def _i64(u: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


_GOLDEN = _i64(0x9E3779B97F4A7C15)
_MIX1 = _i64(0xBF58476D1CE4E5B9)
_MIX2 = _i64(0x94D049BB133111EB)
_SEED = _i64(0x243F6A8885A308D3)
_NULL_SENTINEL = _GOLDEN


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of 64-bit words."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _splitmix64(x: torch.Tensor) -> torch.Tensor:
    x = x + _GOLDEN
    x = (x ^ _srl(x, 30)) * _MIX1
    x = (x ^ _srl(x, 27)) * _MIX2
    return x ^ _srl(x, 31)


def _to_u64(data: torch.Tensor, t: SQLType) -> torch.Tensor:
    if t.family is Family.FLOAT:
        d = data.to(torch.float64)
        d = torch.where(d == 0.0, 0.0, d)  # canonicalize -0.0
        return d.view(torch.int64)
    return data.to(torch.int64)


def hash_columns(
    cols: list[Column],
    types: list[SQLType],
    hash_tables: dict[int, np.ndarray] | None = None,
) -> torch.Tensor:
    """64-bit hash per row over the given key columns (int64 bit
    patterns). hash_tables: per key POSITION, the dictionary hash table
    (code -> uint64) of a STRING key; required for STRING columns."""
    hash_tables = hash_tables or {}
    dev = cols[0].data.device
    h = torch.full((cols[0].data.shape[0],), _SEED, dtype=torch.int64,
                   device=dev)
    for i, (c, t) in enumerate(zip(cols, types)):
        if t.family is Family.STRING:
            table = device_table(hash_tables[i], dev, view=np.int64)
            codes = torch.clamp(c.data.to(torch.int64), 0,
                                table.shape[0] - 1)
            u = table[codes]
        else:
            u = _to_u64(c.data, t)
        u = torch.where(c.valid, _splitmix64(u), _NULL_SENTINEL)
        h = _splitmix64(h ^ u)
    return h


def bucket(hashes: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Hash -> bucket id in [0, num_buckets): the unsigned remainder,
    from the two 32-bit halves (hi * 2^32 + lo) so no product overflows."""
    if not 0 < num_buckets < 1 << 31:
        raise ValueError(f"num_buckets {num_buckets} out of range")
    hi = _srl(hashes, 32) % num_buckets
    lo = (hashes & 0xFFFFFFFF) % num_buckets
    return ((hi * ((1 << 32) % num_buckets) + lo) % num_buckets).to(
        torch.int32)
