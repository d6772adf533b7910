"""Table catalog — host-side table storage feeding device scans; the port
of ``cockroach_tpu.catalog``.

A Table holds canonical-typed host columns (strings already dictionary
encoded) plus per-column Dictionaries, and materializes a device-resident
padded Batch once per column (the "table is in device memory" model).
``catalog_from_host`` builds a Catalog from plain numpy arrays — the
state carried across from any other source of the same tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .coldata.batch import Batch, Dictionary, from_host
from .coldata.types import Family, Schema, SQLType
from .device import resolve_device
from .utils import settings

TILE_ALIGN = 1024  # pad device tables to a multiple of this

# canonical tile-shape ladder: sub-tile tables pad UP to the next rung
SHAPE_BUCKETS = (1 << 10, 1 << 13, 1 << 16, 1 << 19, 1 << 21)


def _bucket_cap(n: int) -> int:
    for b in SHAPE_BUCKETS:
        if n <= b:
            return b
    top = SHAPE_BUCKETS[-1]
    return ((n + top - 1) // top) * top


def _pad_cap(n: int, tile: int | None = None) -> int:
    """Padded device capacity: a multiple of the scan tile (so resident
    scans slice evenly), min one tile. With shape bucketing, sub-tile
    tables round up the rung ladder; without it they align to 1024."""
    if settings.get("sql.distsql.shape_buckets.enabled"):
        cap = _bucket_cap(n)
        if tile is None or tile <= 0 or cap <= tile:
            return cap
        return max(tile, ((n + tile - 1) // tile) * tile)
    align = TILE_ALIGN
    if tile is not None and n > tile:
        align = tile
    return max(align, ((n + align - 1) // align) * align)


@dataclass
class Table:
    name: str
    schema: Schema
    columns: dict[str, np.ndarray]
    valids: dict[str, np.ndarray] = field(default_factory=dict)
    dictionaries: dict[str, Dictionary] = field(default_factory=dict)
    # physical clustering: host rows are stored grouped by this prefix
    ordering: tuple[str, ...] = ()
    device: torch.device | None = None  # set by Catalog.add
    _device_cols: dict | None = None
    _stats: dict | None = None
    _dense_keys: dict | None = None

    @property
    def num_rows(self) -> int:
        return len(next(iter(self.columns.values())))

    def dict_by_index(self) -> dict[int, Dictionary]:
        return {
            self.schema.index(name): d for name, d in self.dictionaries.items()
        }

    def set_stats(self, st) -> None:
        """Install ANALYZE statistics (sql/stats.TableStats). Planner
        consumers read the snapshot, which may go stale as the
        reference's optimizer statistics do; the (lo, hi) bounds replace
        the ``col_stats`` view."""
        self.table_stats = st
        self._stats = {
            n: (c.lo, c.hi)
            for n, c in st.cols.items()
            if c.lo is not None and c.hi is not None
        } if st is not None else None

    def estimated_rows(self) -> int:
        """Planner cardinality (the broadcast-join choice of
        plan/distribute.py, the binder's join order): the ANALYZE
        snapshot when present, else the physical count."""
        st = getattr(self, "table_stats", None)
        return st.row_count if st is not None else self.num_rows

    def col_stats(self) -> dict[str, tuple]:
        """Per-column (lo, hi) bounds over valid rows for integer-represented
        columns; computed once on the host and cached."""
        if self._stats is None:
            stats: dict[str, tuple] = {}
            for name, t in zip(self.schema.names, self.schema.types):
                if t.family in (Family.FLOAT, Family.BYTES, Family.BOOL,
                                Family.JSON):
                    continue
                a = np.asarray(self.columns[name])
                if name in self.valids:
                    a = a[np.asarray(self.valids[name])]
                if len(a) == 0:
                    continue
                stats[name] = (int(a.min()), int(a.max()))
            self._stats = stats
        return self._stats

    def dense_key_info(self) -> dict[str, tuple[int, int]]:
        """{column: (lo, fanout)} for integer columns whose value IS an
        affine function of the row index: col == repeat(arange(lo,
        lo+n/f), f). Joins against such a column address the build row
        arithmetically (ops/join.DenseAnalytic). Host-verified once."""
        if self._dense_keys is not None:
            return self._dense_keys
        info: dict[str, tuple[int, int]] = {}
        n = self.num_rows
        for name, t in zip(self.schema.names, self.schema.types):
            if t.family not in (Family.INT, Family.DECIMAL, Family.DATE,
                                Family.TIMESTAMP, Family.INTERVAL):
                continue
            if name in self.valids or n == 0:
                continue  # NULLs break the bijection
            a = np.asarray(self.columns[name])
            if a.ndim != 1 or a.dtype.kind not in ("i", "u"):
                continue
            lo = int(a[0])
            hi = int(a[-1])
            distinct = hi - lo + 1
            if distinct <= 0 or n % distinct != 0:
                continue
            fanout = n // distinct
            if np.array_equal(
                a, np.repeat(np.arange(lo, lo + distinct, dtype=a.dtype),
                             fanout)
            ):
                info[name] = (lo, fanout)
        self._dense_keys = info
        return info

    def device_batch(self, names: tuple[str, ...] | None = None) -> Batch:
        """Device-resident batch of the requested columns, padded to
        ``_pad_cap``. Cached per column, so a query never uploads columns
        it does not scan.

        The cache snapshots the host column and validity dicts when it is
        made: a concurrent re-host that swaps ``columns``/``valids`` whole
        (a materialized view's materialize) leaves an in-flight reader
        uploading from the generation its cache was made over — one
        consistent snapshot, never a mix of old and new columns."""
        names = names or self.schema.names
        dev = self._device_cols
        if dev is None:
            self.device = resolve_device(self.device or "cuda")
            host, valids = self.columns, self.valids
            n = len(next(iter(host.values()))) if host else 0
            cap = _pad_cap(n, settings.get("sql.distsql.tile_size"))
            m = torch.zeros(cap, dtype=torch.bool)
            m[:n] = True
            dev = self._device_cols = {
                "__cap__": cap, "__mask__": m.to(self.device),
                "__host__": host, "__valids__": valids}
        host, valids = dev["__host__"], dev["__valids__"]
        cols = []
        for cname in names:
            if cname not in dev:
                t = self.schema.type_of(cname)
                one = Schema((cname,), (t,))
                v = {cname: valids[cname]} if cname in valids else None
                b = from_host(one, {cname: np.asarray(host[cname])},
                              valids=v, capacity=dev["__cap__"],
                              device=self.device)
                dev[cname] = b.cols[0]
            cols.append(dev[cname])
        return Batch(cols=tuple(cols), mask=dev["__mask__"])

    @staticmethod
    def from_strings(
        name: str,
        schema: Schema,
        raw: dict[str, np.ndarray],
        valids: dict[str, np.ndarray] | None = None,
        ordering: tuple[str, ...] = (),
    ) -> "Table":
        """Build a table from raw host columns, dictionary-encoding STRING
        columns (object/str arrays -> int32 codes + Dictionary)."""
        cols: dict[str, np.ndarray] = {}
        values: dict[str, np.ndarray] = {}
        for cname, t in zip(schema.names, schema.types):
            a = raw[cname]
            if t.family is Family.STRING and a.dtype.kind in ("O", "U", "S"):
                vals, codes = np.unique(a.astype(str), return_inverse=True)
                values[cname] = vals
                cols[cname] = codes.astype(np.int32)
            else:
                cols[cname] = a
        return Table.from_codes(name, schema, cols, values, valids, ordering)

    @staticmethod
    def from_codes(
        name: str,
        schema: Schema,
        columns: dict[str, np.ndarray],
        values: dict[str, np.ndarray],
        valids: dict[str, np.ndarray] | None = None,
        ordering: tuple[str, ...] = (),
    ) -> "Table":
        """Build a table whose STRING columns are already int32 codes:
        ``values[c]`` is column c's dictionary, code i standing for
        ``values[c][i]``."""
        return Table(
            name=name, schema=schema, columns=dict(columns),
            valids=valids or {},
            dictionaries={c: Dictionary(np.asarray(v).astype(object))
                          for c, v in values.items()},
            ordering=ordering)


class Catalog:
    """Table namespace, on one device, plus a schema version. Every DDL
    that can stale a built plan (CREATE TABLE, CREATE/DROP INDEX,
    ANALYZE) bumps ``version``; the prepared-plan cache
    (sql/plancache.py) keys its entries on it."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.tables: dict[str, Table] = {}
        self.version = 0

    def bump_version(self) -> int:
        self.version += 1
        return self.version

    def add(self, table: Table) -> Table:
        table.device = self.device
        self.tables[table.name] = table
        self.bump_version()
        return table

    def get(self, name: str) -> Table:
        t = self.tables.get(name)
        if t is None and name.startswith("crdb_internal."):
            # virtual tables materialize on read from the process
            # registries (sql/crdb_internal.py)
            from .sql import crdb_internal

            return crdb_internal.build(self, name)
        if t is None:
            return self.tables[name]  # the usual KeyError
        return t


def sql_type(spec) -> SQLType:
    """A column type from its plain description (family name, width,
    precision, scale), e.g. ``("decimal", 64, 12, 2)``."""
    if isinstance(spec, SQLType):
        return spec
    fam, width, precision, scale = spec
    return SQLType(Family(fam), width=width, precision=precision, scale=scale)


def catalog_from_host(tables: dict[str, dict], device="cuda") -> Catalog:
    """Build a Catalog on `device` from plain host arrays. Each entry of
    `tables` maps a table name to a dict with:

    - ``"columns"``: ordered {column name: numpy array} (STRING columns as
      int32 dictionary codes);
    - ``"types"``: {column name: (family name, width, precision, scale)};
    - ``"valids"`` (optional): {column name: bool array}, False = NULL;
    - ``"dictionaries"`` (optional): {column name: array of the values};
    - ``"ordering"`` (optional): the clustering column prefix.
    """
    cat = Catalog(device)
    for name, t in tables.items():
        cols = {c: np.asarray(a) for c, a in t["columns"].items()}
        schema = Schema(tuple(cols),
                        tuple(sql_type(t["types"][c]) for c in cols))
        cat.add(Table(
            name=name, schema=schema, columns=cols,
            valids={c: np.asarray(v, dtype=bool)
                    for c, v in t.get("valids", {}).items()},
            dictionaries={c: Dictionary(np.asarray(v, dtype=object))
                          for c, v in t.get("dictionaries", {}).items()},
            ordering=tuple(t.get("ordering", ())),
        ))
    return cat
