"""Canonical sort-key encoding — bit-packed 64-bit operands; the port of
``cockroach_tpu.ops.keys``.

An ordered key list packs into the minimum number of sort operands: every
key contributes a bit-segment stream ``[null_flag(1), value(bits)]``
packed MSB-first into 64-bit words, so comparing the word tuple
lexicographically (each word unsigned) equals comparing the concatenated
bit string. Float keys ride as native float64 operands.

Words follow the port's uint64 convention (``storage/keys.py``): each is
an int64 holding the reference's uint64 bit pattern; it orders unsigned
after flipping bit 63 (``sort.sortable``). Shifts right are arithmetic
on int64, so every shifted chunk is masked to its width.

Value encodings (order-preserving within the segment's bit width):
- INT/DECIMAL/DATE/TIMESTAMP/INTERVAL: ``x - lo`` when stats give a
  [lo, hi] range, else sign-flip at type width;
- STRING: dictionary rank gather (ORDER BY) or raw code (GROUP BY);
- BOOL: 1 bit; BYTES: big-endian 64-bit word lanes;
- FLOAT: a native float64 operand, with its NaN band as a bit segment.
DESC inverts value bits within the segment (floats: negation); NULLs
order first ascending (CockroachDB's Datum ordering).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..coldata.batch import device_table, pack_be_words
from ..coldata.types import Family, SQLType
from ..storage.keys import flip


@dataclass(frozen=True)
class BitSeg:
    """`bits` wide unsigned values (< 2**bits) in an int64 word lane."""

    bits: int
    arr: torch.Tensor  # int64 bit patterns


@dataclass(frozen=True)
class FloatSeg:
    """A native float64 sort operand."""

    arr: torch.Tensor  # float64


def bits_for_count(n: int) -> int:
    """Bits to distinguish n values (>=1)."""
    return max(1, int(n - 1).bit_length()) if n > 1 else 1


def _low_mask(bits: int) -> int:
    """The int64 value whose bit pattern has the low `bits` bits set."""
    return -1 if bits >= 64 else (1 << bits) - 1


def _int_segment(data, valid, t: SQLType, stats, desc: bool) -> BitSeg:
    """Order-preserving unsigned encoding of an integer-represented column."""
    d = data.to(torch.int64)
    if stats is not None:
        lo, hi = int(stats[0]), int(stats[1])
        bits = bits_for_count(hi - lo + 1)
        v = torch.clamp(d, lo, hi) - lo
    else:
        w = 64
        if t.family is Family.INT:
            w = t.width
        elif t.family in (Family.DATE, Family.STRING):
            w = 32
        bits = w
        # sign-flip maps the signed range onto [0, 2^w)
        v = d + (1 << (w - 1)) if w < 64 else flip(d)
    v = torch.where(valid, v, 0)
    if desc and bits < 64:
        v = ((1 << bits) - 1) - v
    elif desc:
        v = ~v
    return BitSeg(bits, v)


def key_segments(
    data,
    valid,
    t: SQLType,
    desc: bool,
    nulls_first: bool,
    rank_table: np.ndarray | None = None,
    stats: tuple | None = None,
    order_semantics: bool = True,
) -> list:
    """Bit/float segments for one key column, null flag included.

    order_semantics=False (GROUP BY) only needs equality: STRING columns
    use raw dictionary codes instead of requiring a rank table."""
    segs: list = []
    # null flag: rows whose flag bit is 0 sort first
    nf = valid if nulls_first else ~valid
    segs.append(BitSeg(1, nf.to(torch.int64)))

    fam = t.family
    if fam is Family.FLOAT:
        d = data.to(torch.float64)
        # mask by valid: NULL rows carry garbage data, and a garbage NaN
        # would otherwise split the NULL group's packed key bits
        isnan = valid & torch.isnan(d)
        # CockroachDB orders NaN before all other values ascending
        nan_flag = isnan if desc else ~isnan
        segs.append(BitSeg(1, nan_flag.to(torch.int64)))
        d = torch.where(valid & ~isnan, d, 0.0)
        segs.append(FloatSeg(-d if desc else d))
        return segs
    if fam is Family.BYTES:
        words = pack_be_words(data)
        for i in range(words.shape[1]):
            w = torch.where(valid, words[:, i], 0)
            segs.append(BitSeg(64, ~w if desc else w))
        return segs
    if fam is Family.BOOL:
        v = torch.where(valid, data.to(torch.int64) & 1, 0)
        segs.append(BitSeg(1, (1 - v) if desc else v))
        return segs
    if fam is Family.STRING:
        if order_semantics:
            if rank_table is None:
                raise ValueError(
                    "STRING ORDER BY needs a dictionary rank table")
            table = device_table(rank_table, data.device)
            codes = torch.clamp(data.to(torch.int64), 0, table.shape[0] - 1)
            ranked = table[codes].to(torch.int64)
            bits = bits_for_count(int(rank_table.shape[0]) + 1)
            v = torch.where(valid, ranked, 0)
            if desc:
                v = ((1 << bits) - 1) - v
            segs.append(BitSeg(bits, v))
            return segs
        # equality only: raw codes; width from stats or dictionary size
        segs.append(_int_segment(data, valid, t, stats, desc))
        return segs
    # integer-represented families
    segs.append(_int_segment(data, valid, t, stats, desc))
    return segs


def pack_operands(segs: list) -> list[torch.Tensor]:
    """Pack a segment stream into sort operands: int64 word bit patterns
    (bit segments, MSB-first) interleaved with native float64 operands.
    Lexicographic order over the returned operands (words unsigned)
    equals order over the segment stream."""
    ops: list[torch.Tensor] = []
    cur = None
    pos = 0  # bits used in cur, from the MSB
    for s in segs:
        if isinstance(s, FloatSeg):
            if cur is not None:
                ops.append(cur)
                cur, pos = None, 0
            ops.append(s.arr)
            continue
        b = s.bits
        v = s.arr
        if b < 64:
            v = v & _low_mask(b)
        while b > 0:
            if cur is None:
                cur = torch.zeros_like(v)
                pos = 0
            avail = 64 - pos
            take = min(b, avail)
            chunk = v >> (b - take)
            if take < 64:
                chunk = chunk & _low_mask(take)
            cur = cur | (chunk << (avail - take))
            pos += take
            b -= take
            if pos == 64:
                ops.append(cur)
                cur, pos = None, 0
    if cur is not None:
        ops.append(cur)
    return ops
