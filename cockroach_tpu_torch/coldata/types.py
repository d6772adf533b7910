"""SQL type system and canonical device representations — the port of
``cockroach_tpu.coldata.types``.

Every SQL type maps to a canonical type family with a fixed device
representation:

| family    | device dtype | notes                                        |
|-----------|--------------|----------------------------------------------|
| BOOL      | bool         |                                              |
| INT       | int16/32/64  | width from SQL type                          |
| FLOAT     | float64      | SQL DOUBLE; float32 available via width=32   |
| DECIMAL   | int64        | scaled fixed-point, scale in the type        |
| DATE      | int32        | days since epoch                             |
| TIMESTAMP | int64        | microseconds since epoch                     |
| INTERVAL  | int64        | microseconds                                 |
| STRING    | int32        | dictionary code (Dictionary lives host-side) |
| BYTES     | uint8[N,W]   | fixed-width zero-padded buffer               |

``SQLType.dtype`` is the numpy dtype (host columns), ``SQLType.torch_dtype``
the tensor dtype (device columns). Unsigned 64-bit words never appear as
a column type; where the kernels need them (packed sort and join keys)
they ride as int64 bit patterns ordered after flipping bit 63, the
convention of ``storage/keys.py``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch


class Family(enum.Enum):
    BOOL = "bool"
    INT = "int"
    FLOAT = "float"
    DECIMAL = "decimal"
    DATE = "date"
    TIMESTAMP = "timestamp"
    INTERVAL = "interval"
    STRING = "string"
    BYTES = "bytes"
    JSON = "json"  # datum-backed fallback; host-side only


_TORCH_OF_NUMPY = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.uint8): torch.uint8,
}


def torch_dtype_of(dtype) -> torch.dtype:
    """The tensor dtype holding a numpy dtype's values."""
    return _TORCH_OF_NUMPY[np.dtype(dtype)]


@dataclass(frozen=True)
class SQLType:
    """A SQL column type. Hashable and static plan-side metadata."""

    family: Family
    width: int = 64  # bit width for INT/FLOAT; max byte width for BYTES
    precision: int = 0  # DECIMAL precision (informational)
    scale: int = 0  # DECIMAL scale: value = data / 10**scale

    def __repr__(self) -> str:
        if self.family is Family.DECIMAL:
            return f"DECIMAL({self.precision},{self.scale})"
        if self.family is Family.INT:
            return f"INT{self.width}"
        if self.family is Family.FLOAT:
            return f"FLOAT{self.width}"
        return self.family.name

    @property
    def dtype(self) -> np.dtype:
        """Canonical host (numpy) dtype for this SQL type."""
        f = self.family
        if f is Family.BOOL:
            return np.dtype(np.bool_)
        if f is Family.INT:
            return np.dtype({16: np.int16, 32: np.int32, 64: np.int64}[self.width])
        if f is Family.FLOAT:
            return np.dtype({32: np.float32, 64: np.float64}[self.width])
        if f is Family.DECIMAL:
            return np.dtype(np.int64)
        if f is Family.DATE:
            return np.dtype(np.int32)
        if f in (Family.TIMESTAMP, Family.INTERVAL):
            return np.dtype(np.int64)
        if f is Family.STRING:
            return np.dtype(np.int32)  # dictionary code
        if f is Family.BYTES:
            return np.dtype(np.uint8)
        raise TypeError(f"no canonical device dtype for {f}")

    @property
    def torch_dtype(self) -> torch.dtype:
        """Canonical device (tensor) dtype for this SQL type."""
        return torch_dtype_of(self.dtype)

    @property
    def is_numeric(self) -> bool:
        return self.family in (Family.INT, Family.FLOAT, Family.DECIMAL)

    @property
    def comparable_on_device(self) -> bool:
        """Whether < / > on the raw device representation matches SQL
        ordering. Dictionary-coded strings need the host-prepared rank
        table (``Dictionary.ranks``); everything else orders natively."""
        return self.family is not Family.STRING


BOOL = SQLType(Family.BOOL)
INT16 = SQLType(Family.INT, width=16)
INT32 = SQLType(Family.INT, width=32)
INT64 = SQLType(Family.INT, width=64)
FLOAT32 = SQLType(Family.FLOAT, width=32)
FLOAT64 = SQLType(Family.FLOAT, width=64)
DATE = SQLType(Family.DATE)
TIMESTAMP = SQLType(Family.TIMESTAMP)
INTERVAL = SQLType(Family.INTERVAL)
STRING = SQLType(Family.STRING)


def DECIMAL(precision: int = 19, scale: int = 2) -> SQLType:
    return SQLType(Family.DECIMAL, precision=precision, scale=scale)


def BYTES(width: int = 64) -> SQLType:
    return SQLType(Family.BYTES, width=width)


@dataclass(frozen=True)
class Schema:
    """Ordered, named column types."""

    names: tuple[str, ...]
    types: tuple[SQLType, ...]

    def __post_init__(self):
        if len(self.names) != len(self.types):
            raise ValueError("schema names and types differ in length")

    def __len__(self) -> int:
        return len(self.types)

    def index(self, name: str) -> int:
        return self.names.index(name)

    def type_of(self, name: str) -> SQLType:
        return self.types[self.index(name)]

    def select(self, idxs: tuple[int, ...]) -> "Schema":
        return Schema(
            tuple(self.names[i] for i in idxs), tuple(self.types[i] for i in idxs)
        )

    def concat(self, other: "Schema") -> "Schema":
        return Schema(self.names + other.names, self.types + other.types)

    def rename(self, names: tuple[str, ...]) -> "Schema":
        return Schema(tuple(names), self.types)

    @staticmethod
    def of(**cols: SQLType) -> "Schema":
        return Schema(tuple(cols.keys()), tuple(cols.values()))


def zeros_like_type(t: SQLType, capacity: int, device) -> torch.Tensor:
    """`capacity` zero values in t's canonical representation on `device`."""
    if t.family is Family.BYTES:
        return torch.zeros((capacity, t.width), dtype=torch.uint8,
                           device=device)
    return torch.zeros((capacity,), dtype=t.torch_dtype, device=device)
