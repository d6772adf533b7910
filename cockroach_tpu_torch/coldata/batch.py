"""Columnar batch format — the port of ``cockroach_tpu.coldata.batch``.

A Batch is a tuple of typed columns over a static-capacity tile plus a
boolean liveness ``mask`` (the selection vector of the reference's
coldata.Batch); each Column carries an Arrow-convention ``valid`` bitmap
(True = non-NULL). Columns are tensors on one device; schema information
(types, dictionaries) stays plan-side metadata.

Compaction here needs no host sync: live rows scatter to their rank
(``cumsum(mask) - 1``) in an output tile of a capacity the caller knows
fits them; dead rows land in a discarded trailing slot.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .types import Family, Schema, zeros_like_type

DEFAULT_CAPACITY = 4096  # coldata.MaxBatchSize


def pack_be_words(data: torch.Tensor) -> torch.Tensor:
    """[N, W] uint8 -> [N, ceil(W/8)] int64 big-endian word bit patterns.

    Tuple order over the word lanes (each compared unsigned: flip bit 63
    before a signed compare) equals bytewise lexicographic order of the
    rows. Widths not a multiple of 8 are zero-padded on the right (order
    preserving for zero-padded fixed-width rows). Each group of 8 bytes is
    byte-reversed and reinterpreted as a little-endian int64, which is the
    big-endian word's bit pattern."""
    n, w = data.shape
    if w % 8:
        data = torch.nn.functional.pad(data, (0, 8 - w % 8))
        w = data.shape[1]
    groups = data.reshape(n, w // 8, 8).flip(-1).contiguous()
    return groups.view(torch.int64).reshape(n, w // 8)


@dataclass(frozen=True)
class Column:
    """data: [cap] canonical-dtype tensor ([cap, W] uint8 for BYTES);
    valid: [cap] bool, True = non-NULL."""

    data: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.data.shape[0]


@dataclass(frozen=True)
class Batch:
    """cols: one Column per schema field; mask: [cap] bool row liveness."""

    cols: tuple[Column, ...]
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.mask.shape[0]

    @property
    def device(self) -> torch.device:
        return self.mask.device

    def with_mask(self, mask: torch.Tensor) -> "Batch":
        return Batch(cols=self.cols, mask=mask)


class Dictionary:
    """Host-side string dictionary for a STRING column (codes on device).

    - ``hashes``: code -> 64-bit FNV-1a hash of the value's bytes, so
      string keys hash identically across tables with other dictionaries;
    - ``ranks``: code -> rank in sorted byte order, so ORDER BY and range
      predicates on strings become integer comparisons.
    """

    def __init__(self, values: np.ndarray):
        self.values = np.asarray(values, dtype=object)
        order = np.argsort(self.values.astype(str))
        ranks = np.empty(len(self.values), dtype=np.int32)
        ranks[order] = np.arange(len(self.values), dtype=np.int32)
        self.ranks = ranks
        self.hashes = _fnv64_batch(self.values)

    def __len__(self) -> int:
        return len(self.values)

    def code_of(self, value: str) -> int:
        """Code for a literal value, or -1 if absent (predicate is then false)."""
        hits = np.nonzero(self.values.astype(str) == value)[0]
        return int(hits[0]) if len(hits) else -1

    def decode(self, codes: np.ndarray) -> np.ndarray:
        out = np.empty(codes.shape, dtype=object)
        in_range = (codes >= 0) & (codes < len(self.values))
        out[in_range] = self.values[codes[in_range]]
        out[~in_range] = None
        return out


def _fnv64_batch(values: np.ndarray) -> np.ndarray:
    """FNV-1a 64-bit over utf-8 bytes for an array of strings, vectorized:
    one masked pass per byte position over the whole dictionary."""
    encoded = [str(v).encode("utf-8") for v in values]
    n = len(encoded)
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    lens = np.array([len(b) for b in encoded], dtype=np.int64)
    maxlen = max(1, int(lens.max()))
    # Sort by length descending so byte-position i only touches a prefix:
    # total work is O(sum of lengths), immune to one long outlier string.
    order = np.argsort(-lens, kind="stable")
    flat = np.frombuffer(b"".join(encoded[j] for j in order), dtype=np.uint8)
    sorted_lens = lens[order]
    starts = np.concatenate([[0], np.cumsum(sorted_lens[:-1])])
    # rows with len > i form the prefix [0, counts[i])
    asc = sorted_lens[::-1]
    counts = n - np.searchsorted(asc, np.arange(maxlen), side="right")
    h = np.full(n, 0xCBF29CE484222325, dtype=np.uint64)
    prime = np.uint64(0x100000001B3)
    with np.errstate(over="ignore"):
        for i in range(maxlen):
            c = int(counts[i])
            if c == 0:
                break
            h[:c] = (h[:c] ^ flat[starts[:c] + i]) * prime
    out = np.empty_like(h)
    out[order] = h
    return out


def empty_batch(schema: Schema, capacity: int, device) -> Batch:
    cols = tuple(
        Column(data=zeros_like_type(t, capacity, device),
               valid=torch.zeros(capacity, dtype=torch.bool, device=device))
        for t in schema.types
    )
    return Batch(cols=cols,
                 mask=torch.zeros(capacity, dtype=torch.bool, device=device))


def from_host(
    schema: Schema,
    arrays: dict[str, np.ndarray],
    valids: dict[str, np.ndarray] | None = None,
    capacity: int | None = None,
    device="cuda",
) -> Batch:
    """Build a Batch on `device` from host numpy columns, padding to
    capacity. STRING columns must already be dictionary codes."""
    device = resolve_device(device)
    valids = valids or {}
    n = len(next(iter(arrays.values())))
    cap = capacity if capacity is not None else max(DEFAULT_CAPACITY, n)
    cols = []
    # only the n rows cross to the device; the padding is zeroed there
    for name, t in zip(schema.names, schema.types):
        a = np.asarray(arrays[name])
        if len(a) != n:
            raise ValueError(f"column {name} length {len(a)} != {n}")
        data = zeros_like_type(t, cap, device)
        data[:n] = _tensor(a.astype(t.dtype, copy=False), device)
        v = torch.zeros(cap, dtype=torch.bool, device=device)
        if name in valids:
            v[:n] = _tensor(np.asarray(valids[name], dtype=np.bool_), device)
        else:
            v[:n] = True
        cols.append(Column(data=data, valid=v))
    mask = torch.arange(cap, device=device) < n
    return Batch(cols=tuple(cols), mask=mask)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch wraps only writable arrays
        a = a.copy()
    return torch.from_numpy(a).to(device)


def to_host(
    batch: Batch, schema: Schema, dictionaries: dict | None = None
) -> dict[str, np.ndarray]:
    """Materialize live rows to host numpy (the Materializer analog).
    Decodes STRING via dictionaries (column index -> Dictionary); NULLs
    become None in object arrays; DECIMAL becomes float64 value/10^scale."""
    dictionaries = dictionaries or {}
    mask = batch.mask.cpu().numpy()
    out: dict[str, np.ndarray] = {}
    for i, (name, t) in enumerate(zip(schema.names, schema.types)):
        data = batch.cols[i].data.cpu().numpy()[mask]
        valid = batch.cols[i].valid.cpu().numpy()[mask]
        if t.family is Family.STRING and i in dictionaries:
            vals = dictionaries[i].decode(data)
            vals[~valid] = None
            out[name] = vals
        elif t.family is Family.DECIMAL:
            res = data.astype(np.float64) / (10.0**t.scale)
            obj = res.astype(object)
            obj[~valid] = None
            out[name] = obj if not valid.all() else res
        elif valid.all():
            out[name] = data
        else:
            obj = data.astype(object)
            obj[~valid] = None
            out[name] = obj
    return out


def compact_index(mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """Destination slot of every row when live rows pack to the front of a
    `capacity` tile in row order: live row r goes to its rank, dead rows
    (and live rows past the capacity) to the discarded slot `capacity`."""
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    return torch.where(mask & (rank < capacity), rank,
                       torch.full_like(rank, capacity))


def scatter_rows(x: torch.Tensor, dest: torch.Tensor,
                  capacity: int) -> torch.Tensor:
    """Rows of `x` placed at `dest` in a zeroed `capacity` tile; rows
    whose destination is `capacity` are discarded."""
    out = torch.zeros((capacity + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out.index_copy_(0, dest, x)
    return out[:capacity]


def compact(batch: Batch, capacity: int | None = None) -> Batch:
    """Pack live rows to the front of a (possibly smaller) tile, in row
    order; rows past the live count are zero, invalid and dead. The
    caller guarantees the live rows fit `capacity`."""
    cap_out = capacity or batch.capacity
    dest = compact_index(batch.mask, cap_out)
    cols = tuple(
        Column(data=scatter_rows(c.data, dest, cap_out),
               valid=scatter_rows(c.valid, dest, cap_out))
        for c in batch.cols
    )
    n = batch.mask.sum(dtype=torch.int64)
    mask = torch.arange(cap_out, device=batch.device) < n
    return Batch(cols=cols, mask=mask)


def concat(batches: list[Batch], capacity: int) -> Batch:
    """Concatenate batches' LIVE rows into one compacted tile of
    `capacity` (must fit; the caller counts), earlier batches first."""
    if len(batches) == 1:
        return compact(batches[0], capacity)
    cols = tuple(
        Column(data=torch.cat([b.cols[i].data for b in batches]),
               valid=torch.cat([b.cols[i].valid for b in batches]))
        for i in range(len(batches[0].cols))
    )
    whole = Batch(cols=cols, mask=torch.cat([b.mask for b in batches]))
    return compact(whole, capacity)
