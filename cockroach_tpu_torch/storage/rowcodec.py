"""SQL row <-> KV codec — the rowenc/colenc + cFetcher decode analog; the
port of ``cockroach_tpu.storage.rowcodec``.

- keys:   1 prefix byte (0x01+table_id) + the int64 primary key in ten
  7-bit big-endian groups, each byte offset by 0x01: order-preserving and
  NUL-free (the engine's zero-padded fixed-width keys cannot hold 0x00).
- values: a null bitmap (1 bit per column, set = non-NULL) followed by one
  8-byte little-endian slot per column (floats as raw IEEE bits).
- decode: the value column of a KVBlock ([cap, VW] uint8) unpacks into
  typed device columns. Each 8-byte slot sits at an unaligned offset
  behind the null bytes, so a column is one strided ``[cap, 8]`` copy into
  contiguous memory, then a free ``view`` as int64 (the repo's bit-pattern
  convention for little-endian words) or float64. The copy reads one
  8-byte field of every ``VW``-byte row and writes 8 bytes per row.

Host encoders give bytes identical to the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..coldata.batch import Batch, Column
from ..coldata.types import Family, Schema

PK_BYTES = 10  # ceil(64 / 7) groups
KEY_BYTES = 1 + PK_BYTES

MAX_TABLE_ID = 0xFD  # 0xFE would make table_span's end bound overflow a byte


# -- host-side encode (write path) ------------------------------------------


def encode_pk(table_id: int, pk: int) -> bytes:
    """Order-preserving, NUL-free key for (table, int64 primary key)."""
    assert 0 <= table_id <= MAX_TABLE_ID
    u = (int(pk) & 0xFFFFFFFFFFFFFFFF) ^ (1 << 63)  # signed -> unsigned order
    out = bytearray([0x01 + table_id])
    for i in range(PK_BYTES - 1, -1, -1):
        out.append(0x01 + ((u >> (7 * i)) & 0x7F))
    return bytes(out)


def table_span(table_id: int) -> tuple[bytes, bytes]:
    """[start, end) covering every key of the table."""
    assert 0 <= table_id <= MAX_TABLE_ID
    return bytes([0x01 + table_id]), bytes([0x02 + table_id])


def decode_pk(key: bytes) -> int:
    u = 0
    for b in key[1:KEY_BYTES]:
        u = (u << 7) | (b - 0x01)
    u ^= 1 << 63
    return u - (1 << 64) if u >= (1 << 63) else u


def value_width(schema: Schema) -> int:
    nullbytes = (len(schema) + 7) // 8
    return nullbytes + 8 * len(schema)


def _bits(t, v) -> int:
    """One value's 8-byte slot as an unsigned int."""
    if t.family is Family.FLOAT:
        return int(np.float64(v).view(np.uint64))
    if t.family is Family.BOOL:
        return 1 if v else 0
    return int(v) & 0xFFFFFFFFFFFFFFFF


def encode_row(schema: Schema, row: dict) -> bytes:
    """Pack one row into the fixed-width value payload. NULL = missing key
    or None value."""
    ncols = len(schema)
    nullbytes = (ncols + 7) // 8
    out = bytearray(nullbytes + 8 * ncols)
    for i, (name, t) in enumerate(zip(schema.names, schema.types)):
        v = row.get(name)
        if v is None:
            continue
        out[i // 8] |= 1 << (i % 8)  # set = non-NULL
        out[nullbytes + 8 * i: nullbytes + 8 * (i + 1)] = _bits(
            t, v).to_bytes(8, "little")
    return bytes(out)


def decode_row(schema: Schema, value: bytes) -> dict:
    """Host-side single-row decode (point lookups)."""
    nullbytes = (len(schema) + 7) // 8
    out = {}
    for i, (name, t) in enumerate(zip(schema.names, schema.types)):
        if not (value[i // 8] >> (i % 8)) & 1:
            out[name] = None
            continue
        bits = int.from_bytes(value[nullbytes + 8 * i: nullbytes + 8 * (i + 1)],
                              "little")
        if t.family is Family.FLOAT:
            out[name] = float(np.uint64(bits).view(np.float64))
        elif t.family is Family.BOOL:
            out[name] = bool(bits)
        else:
            out[name] = bits - (1 << 64) if bits >= (1 << 63) else bits
    return out


def _groups(u: np.ndarray) -> np.ndarray:
    """[N] uint64 -> [N, PK_BYTES] uint8 NUL-free 7-bit groups."""
    out = np.empty((len(u), PK_BYTES), dtype=np.uint8)
    for i in range(PK_BYTES):
        shift = np.uint64(7 * (PK_BYTES - 1 - i))
        out[:, i] = ((u >> shift) & np.uint64(0x7F)).astype(np.uint8) + 0x01
    return out


def encode_int_groups(vals: np.ndarray) -> np.ndarray:
    """[N] int64 -> [N, PK_BYTES] order-preserving groups (shared by the
    primary and the secondary-index key encoders)."""
    return _groups(np.asarray(vals, dtype=np.int64).astype(np.uint64)
                   ^ np.uint64(1 << 63))


def encode_pk_batch(table_id: int, pks: np.ndarray) -> np.ndarray:
    """Vectorized encode_pk: [N] int64 -> [N, KEY_BYTES] uint8."""
    assert 0 <= table_id <= MAX_TABLE_ID
    out = np.empty((len(pks), KEY_BYTES), dtype=np.uint8)
    out[:, 0] = 0x01 + table_id
    out[:, 1:] = encode_int_groups(pks)
    return out


def encode_rows(schema: Schema, columns: dict[str, np.ndarray],
                valids: dict[str, np.ndarray] | None = None) -> np.ndarray:
    """Vectorized encode_row: typed host columns -> [N, value_width] uint8
    payloads (the colenc analog)."""
    valids = valids or {}
    ncols = len(schema)
    nullbytes = (ncols + 7) // 8
    n = len(next(iter(columns.values())))
    out = np.zeros((n, nullbytes + 8 * ncols), dtype=np.uint8)
    for i, (name, t) in enumerate(zip(schema.names, schema.types)):
        a = np.asarray(columns[name])
        v = valids.get(name)
        if t.family is Family.FLOAT:
            bits = a.astype(np.float64).view(np.uint64)
        elif t.family is Family.BOOL:
            bits = a.astype(np.uint64)
        else:
            bits = a.astype(np.int64).view(np.uint64)
        lanes = bits.astype("<u8").view(np.uint8).reshape(n, 8)
        off = nullbytes + 8 * i
        if v is None:
            out[:, i // 8] |= np.uint8(1 << (i % 8))
            out[:, off:off + 8] = lanes
        else:
            vb = np.asarray(v, dtype=bool)
            out[vb, i // 8] |= np.uint8(1 << (i % 8))
            out[vb, off:off + 8] = lanes[vb]
    return out


# -- device-side columnar decode (read path: the cFetcher kernel) -----------


def _le_words(value: torch.Tensor, off: int) -> torch.Tensor:
    """The little-endian 8-byte field at byte `off` of every row, as int64
    bit patterns: a strided copy into contiguous memory, then a view."""
    return value[:, off:off + 8].contiguous().view(torch.int64).squeeze(1)


def decode_columns(
    value: torch.Tensor,
    sel: torch.Tensor,
    schema: Schema,
    col_idxs: tuple[int, ...] | None = None,
    out: dict[int, Column] | None = None,
) -> Batch:
    """[cap, VW] uint8 value payloads + selection mask -> columnar Batch;
    NULL bits gate `valid`. Each column decodes straight into its
    buffers in `out` ({column index: Column of [cap] buffers}; made and
    added there on first use), so a caller that keeps `out` decodes at
    one address per column from call to call."""
    nullbytes = (len(schema) + 7) // 8
    idxs = col_idxs if col_idxs is not None else tuple(range(len(schema)))
    out = {} if out is None else out
    cap, dev = value.shape[0], value.device
    cols = []
    for i in idxs:
        t = schema.types[i]
        off = nullbytes + 8 * i
        buf = out.get(i)
        if buf is None:
            dtype = (torch.float64 if t.family is Family.FLOAT
                     else t.torch_dtype)  # FLOAT words as they lie
            buf = out[i] = Column(
                data=torch.empty(cap, dtype=dtype, device=dev),
                valid=torch.empty(cap, dtype=torch.bool, device=dev))
        if buf.data.element_size() == 8:
            # INT64 and FLOAT words: the strided bytes land in place
            buf.data.view(torch.uint8).view(cap, 8).copy_(
                value[:, off:off + 8])
        elif t.family is Family.BOOL:
            torch.ne(_le_words(value, off), 0, out=buf.data)
        else:
            buf.data.copy_(_le_words(value, off))
        present = (value[:, i // 8] >> (i % 8)) & 1
        torch.logical_and(present, sel, out=buf.valid)
        cols.append(buf)
    return Batch(cols=tuple(cols), mask=sel)


def decode_pk_column(key: torch.Tensor) -> torch.Tensor:
    """[cap, KW] uint8 engine keys -> [cap] int64 primary keys (the inverse
    of encode_pk; int64 wraparound arithmetic gives the unsigned sum)."""
    groups = (key[:, 1:KEY_BYTES].to(torch.int64) - 1) & 0x7F
    u = torch.zeros(key.shape[0], dtype=torch.int64, device=key.device)
    for j in range(PK_BYTES):
        u = (u << 7) | groups[:, j]
    return u ^ torch.iinfo(torch.int64).min  # flip bit 63
