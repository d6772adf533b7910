"""Apache Arrow interchange — the colserde analog; the port of
``cockroach_tpu.coldata.arrow``.

Reference: pkg/col/colserde serializes coldata.Batch as Arrow record
batches for the wire (arrowbatchconverter.go:126 BatchToArrow / :386
ArrowToBatch); Arrow is also the natural host<->accelerator boundary
format here, since every canonical column representation maps 1:1:

| engine                       | arrow                                 |
|------------------------------|---------------------------------------|
| INT16/32/64                  | int16/32/64 (zero-copy both ways)     |
| FLOAT32/64                   | float32/64 (zero-copy)                |
| BOOL                         | bool_                                 |
| DATE (int32 days)            | date32 (zero-copy)                    |
| TIMESTAMP (int64 us)         | timestamp("us") (zero-copy)           |
| INTERVAL (int64 us)          | duration("us") (zero-copy)            |
| DECIMAL (scaled int64)       | decimal128(38, scale) — the scaled    |
|                              | int IS decimal128's unscaled storage  |
| STRING (codes + Dictionary)  | dictionary(int32, utf8)               |
| BYTES (uint8[N,W] + len)     | fixed_size_binary(W)                  |

NULLs ride Arrow validity bitmaps. Fixed-width columns interchange
zero-copy; decimal widening to 128-bit and dictionary re-encoding are the
only copies.

These converters exchange pyarrow objects with their caller by nature, so
``pyarrow`` is imported inside each function, never by the module: the
port's wire (flow/dcn.py) frames batches with numpy and ``struct`` and
needs no pyarrow, and nothing on a path the card machine runs calls
these. ``batch_from_arrow`` builds its Batch on ``device``.
"""

from __future__ import annotations

import numpy as np

from .batch import Batch, Dictionary
from .types import Family, Schema, SQLType


def type_to_arrow(t: SQLType):
    import pyarrow as pa

    f = t.family
    if f is Family.BOOL:
        return pa.bool_()
    if f is Family.INT:
        return {16: pa.int16(), 32: pa.int32(), 64: pa.int64()}[t.width]
    if f is Family.FLOAT:
        return {32: pa.float32(), 64: pa.float64()}[t.width]
    if f is Family.DECIMAL:
        return pa.decimal128(38, t.scale)
    if f is Family.DATE:
        return pa.date32()
    if f is Family.TIMESTAMP:
        return pa.timestamp("us")
    if f is Family.INTERVAL:
        return pa.duration("us")
    if f is Family.STRING:
        return pa.dictionary(pa.int32(), pa.utf8())
    if f is Family.BYTES:
        return pa.binary(t.width)
    raise TypeError(f"no arrow mapping for {t}")


def type_from_arrow(at) -> SQLType:
    import pyarrow as pa

    from . import types as T

    if pa.types.is_boolean(at):
        return T.BOOL
    if pa.types.is_int16(at):
        return T.INT16
    if pa.types.is_int32(at):
        return T.INT32
    if pa.types.is_int64(at):
        return T.INT64
    if pa.types.is_float32(at):
        return T.FLOAT32
    if pa.types.is_float64(at):
        return T.FLOAT64
    if pa.types.is_decimal(at):
        return T.DECIMAL(precision=at.precision, scale=at.scale)
    if pa.types.is_date32(at):
        return T.DATE
    if pa.types.is_timestamp(at):
        return T.TIMESTAMP
    if pa.types.is_duration(at):
        return T.INTERVAL
    if pa.types.is_dictionary(at) or pa.types.is_string(at):
        return T.STRING
    if pa.types.is_fixed_size_binary(at):
        return T.BYTES(at.byte_width)
    raise TypeError(f"no engine mapping for arrow type {at}")


def _decimal_from_scaled(scaled: np.ndarray, scale: int):
    """Scaled int64 -> decimal128: the int64 IS the low half of
    decimal128's little-endian unscaled storage (sign-extended high half)."""
    import pyarrow as pa

    n = len(scaled)
    buf = np.zeros((n, 2), dtype=np.int64)
    buf[:, 0] = scaled
    buf[:, 1] = np.where(scaled < 0, -1, 0)  # sign extension
    return pa.Array.from_buffers(
        pa.decimal128(38, scale), n,
        [None, pa.py_buffer(buf.tobytes())],
    )


def _decimal_to_scaled(arr, scale: int) -> np.ndarray:
    """decimal128 -> scaled int64 (values must fit 64 bits; TPC-H does —
    the documented divergence from arbitrary-precision apd)."""
    import pyarrow as pa

    arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
    target = pa.decimal128(38, scale)
    if not arr.type.equals(target):
        arr = arr.cast(target)
    buf = np.frombuffer(arr.buffers()[1], dtype=np.int64)
    off = arr.offset
    view = buf.reshape(-1, 2)[off: off + len(arr)]
    lo, hi = view[:, 0], view[:, 1]
    expect_hi = np.where(lo < 0, -1, 0)
    # null slots' storage is unspecified by the Arrow format: only validate
    # valid rows (foreign writers / slice kernels may leave garbage there)
    valid = (np.ones(len(arr), bool) if arr.null_count == 0
             else ~np.asarray(arr.is_null()))
    if not np.array_equal(hi[valid], expect_hi[valid]):
        raise OverflowError("decimal128 value exceeds the scaled-int64 range")
    return np.where(valid, lo, 0)


# -- column-level conversion ------------------------------------------------


def column_to_arrow(data: np.ndarray, valid: np.ndarray, t: SQLType,
                    dictionary: Dictionary | None = None):
    import pyarrow as pa

    mask = None if valid.all() else ~valid
    if t.family is Family.DECIMAL:
        arr = _decimal_from_scaled(np.asarray(data, np.int64), t.scale)
        if mask is not None:
            # rebuild with a validity bitmap (from_buffers path has none)
            arr = pa.Array.from_buffers(
                arr.type, len(arr),
                [pa.py_buffer(np.packbits(valid, bitorder="little")),
                 arr.buffers()[1]],
            )
        return arr
    if t.family is Family.STRING:
        assert dictionary is not None, "STRING needs its Dictionary"
        codes = pa.array(np.asarray(data, np.int32), mask=mask)
        values = pa.array([str(v) for v in dictionary.values],
                          type=pa.utf8())
        return pa.DictionaryArray.from_arrays(codes, values)
    if t.family is Family.BYTES:
        flat = np.ascontiguousarray(np.asarray(data, np.uint8))
        arr = pa.Array.from_buffers(
            pa.binary(t.width), len(flat),
            [pa.py_buffer(np.packbits(valid, bitorder="little")),
             pa.py_buffer(flat.tobytes())],
        )
        return arr
    return pa.array(np.asarray(data), type=type_to_arrow(t), mask=mask)


def column_from_arrow(arr) -> tuple[np.ndarray, np.ndarray,
                                    Dictionary | None]:
    """-> (canonical data, valid bitmap, Dictionary or None). Fixed-width
    numeric columns come back zero-copy when the source has no nulls."""
    import pyarrow as pa

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    t = type_from_arrow(arr.type)
    n = len(arr)
    valid = np.ones(n, dtype=bool) if arr.null_count == 0 else \
        ~np.asarray(arr.is_null())
    if t.family is Family.DECIMAL:
        return _decimal_to_scaled(arr, t.scale), valid, None
    if t.family is Family.STRING:
        if pa.types.is_dictionary(arr.type):
            codes = np.asarray(arr.indices.fill_null(0), dtype=np.int32)
            values = np.asarray(
                [v.as_py() for v in arr.dictionary], dtype=object)
        else:  # plain utf8: dictionary-encode
            enc = arr.dictionary_encode()
            codes = np.asarray(enc.indices.fill_null(0), dtype=np.int32)
            values = np.asarray(
                [v.as_py() for v in enc.dictionary], dtype=object)
        return codes, valid, Dictionary(values)
    if t.family is Family.BYTES:
        w = arr.type.byte_width
        raw = np.frombuffer(arr.buffers()[1], dtype=np.uint8)
        data = raw[arr.offset * w: (arr.offset + n) * w].reshape(n, w)
        return data, valid, None
    if t.family in (Family.DATE, Family.TIMESTAMP, Family.INTERVAL):
        # temporal types: reinterpret as their integer storage (zero-copy
        # view) instead of letting pyarrow build datetime64 objects
        arr = arr.view(pa.int32() if t.family is Family.DATE else pa.int64())
    if arr.null_count == 0:
        data = arr.to_numpy(zero_copy_only=t.family is not Family.BOOL)
    else:
        data = np.asarray(arr.fill_null(0))
    return np.asarray(data).astype(t.dtype, copy=False), valid, None


# -- table / batch level ----------------------------------------------------


def table_to_arrow(table):
    """catalog.Table -> pyarrow Table (host columns, no device touch)."""
    import pyarrow as pa

    arrays, fields = [], []
    for name, t in zip(table.schema.names, table.schema.types):
        data = np.asarray(table.columns[name])
        valid = table.valids.get(name)
        if valid is None:
            valid = np.ones(len(data), dtype=bool)
        arrays.append(column_to_arrow(
            data, np.asarray(valid, bool), t,
            table.dictionaries.get(name)))
        fields.append(pa.field(name, arrays[-1].type))
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))


def table_from_arrow(name: str, at):
    """pyarrow Table -> catalog.Table (the Arrow ingest path the bench and
    any external loader ride)."""
    from ..catalog import Table

    names = tuple(at.column_names)
    types, cols, valids, dicts = [], {}, {}, {}
    for cname in names:
        data, valid, d = column_from_arrow(at.column(cname))
        types.append(type_from_arrow(at.schema.field(cname).type))
        cols[cname] = data
        if not valid.all():
            valids[cname] = valid
        if d is not None:
            dicts[cname] = d
    return Table(
        name=name,
        schema=Schema(names, tuple(types)),
        columns=cols,
        valids=valids,
        dictionaries=dicts,
    )


def batch_to_arrow(batch: Batch, schema: Schema,
                   dictionaries: dict[int, Dictionary] | None = None):
    """Device Batch -> Arrow record batch of the LIVE rows (the Outbox
    serialization direction, outbox.go:280)."""
    import pyarrow as pa

    dictionaries = dictionaries or {}
    mask = batch.mask.cpu().numpy()
    arrays, fields = [], []
    for i, (name, t) in enumerate(zip(schema.names, schema.types)):
        data = batch.cols[i].data.cpu().numpy()[mask]
        valid = batch.cols[i].valid.cpu().numpy()[mask]
        arrays.append(column_to_arrow(data, valid, t, dictionaries.get(i)))
        fields.append(pa.field(name, arrays[-1].type))
    return pa.RecordBatch.from_arrays(arrays, schema=pa.schema(fields))


def batch_from_arrow(rb, device="cuda"
                     ) -> tuple[Batch, Schema, dict[int, Dictionary]]:
    """Arrow record batch -> device Batch (the Inbox direction)."""
    from .batch import from_host

    names = tuple(rb.schema.names)
    types, arrays, valids, dicts = [], {}, {}, {}
    for i, cname in enumerate(names):
        data, valid, d = column_from_arrow(rb.column(i))
        types.append(type_from_arrow(rb.schema.field(cname).type))
        arrays[cname] = data
        if not valid.all():
            valids[cname] = valid
        if d is not None:
            dicts[i] = d
    schema = Schema(names, tuple(types))
    return (from_host(schema, arrays, valids=valids, device=device), schema,
            dicts)
