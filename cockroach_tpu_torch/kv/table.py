"""KV-backed SQL tables — the TableReader path over the MVCC engine; the
port of ``cockroach_tpu.kv.table``.

KVTable is both:

- the write surface: ``insert``/``insert_rows``/``delete_pk`` run inside a
  kv transaction (intents, refresh validation, retries — kv/txn.py),
  encoding rows through storage/rowcodec.py; ``bulk_load`` is the IMPORT
  path (storage/ingest.RunBuilder);
- the read surface: ``device_batch`` decodes a columnar Batch straight
  from the engine's merged view on the engine's device — the MVCC scan
  filter picks newest-visible versions, rowcodec.decode_columns unpacks
  the values (pkg/storage/col_mvcc.go's direct columnar scan).

KVTable quacks like catalog.Table (schema, num_rows, dict_by_index,
col_stats, device_batch, device), so ScanOp and the flow engine run
unchanged over it. STRING columns are dictionary coded in the value
slots; each dictionary persists in a companion key space of the same
engine. BYTES and JSON columns are refused.
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

from ..coldata.batch import Batch, Column, Dictionary, empty_batch
from ..coldata.types import Family, Schema
from ..storage import keys as K
from ..storage import mvcc, rowcodec
from ..storage.lsm import Engine
from .txn import DB, Txn

_UNSUPPORTED = (Family.BYTES, Family.JSON)

# unscoped table ids come from the system tenant's range; kv/tenant.py
# slices the ids above it among the other tenants
_SYSTEM_RANGE = (1, 127)

# the transaction the running statement reads as (``reading_as``); a
# context variable, so each thread (each pgwire connection, each load
# session) sees only its own statement's snapshot
_READ_AS: contextvars.ContextVar[Txn | None] = contextvars.ContextVar(
    "ctpu_torch_read_as", default=None)


@contextlib.contextmanager
def reading_as(txn: Txn):
    """Within the block, this thread's scans of txn's database's tables
    read AT txn's snapshot AS txn (its own intents visible, foreign ones
    conflict); other threads keep reading at now()."""
    tok = _READ_AS.set(txn)
    try:
        yield
    finally:
        _READ_AS.reset(tok)


class _Snapshot:
    """A read snapshot outside any transaction: ``reading_at``'s stand-in
    for the Txn that ``read_context`` reads (its database, read
    timestamp, and txn id 0: no intent is this reader's own)."""

    __slots__ = ("db", "read_ts", "txn_id")

    def __init__(self, db: DB, read_ts: int):
        self.db = db
        self.read_ts = int(read_ts)
        self.txn_id = 0


@contextlib.contextmanager
def reading_at(db: DB, ts: int):
    """Within the block, this thread's scans of db's tables read AT `ts`
    (the materialized-view rescan); other threads keep their own read
    context, and no table's shared pin is written."""
    tok = _READ_AS.set(_Snapshot(db, ts))
    try:
        yield
    finally:
        _READ_AS.reset(tok)


def unique_strings(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``np.unique(a.astype(str), return_inverse=True)`` through one hash
    pass: the distinct values sorted by code point (numpy's unicode order)
    and each row's rank among them."""
    first: dict[str, int] = {}
    codes = np.fromiter(
        (first.setdefault(x if type(x) is str else str(x), len(first))
         for x in a), dtype=np.int64, count=len(a))
    seen = np.array(list(first), dtype=object)
    order = np.argsort(seen.astype(str), kind="stable")
    remap = np.empty(len(seen), dtype=np.int64)
    remap[order] = np.arange(len(seen))
    return seen[order].astype(str), remap[codes]


class _TableDict:
    """Growable per-column string dictionary; plans take an immutable
    Dictionary snapshot at bind time."""

    def __init__(self, values: list[str] | None = None):
        self.values: list[str] = list(values or [])
        self._code: dict[str, int] = {v: i for i, v in enumerate(self.values)}
        self._snapshot = None

    def code_of(self, v: str) -> int | None:
        return self._code.get(v)

    def add(self, v: str) -> int:
        code = len(self.values)
        self.values.append(v)
        self._code[v] = code
        self._snapshot = None
        return code

    def snapshot(self) -> Dictionary:
        if self._snapshot is None or len(self._snapshot) != len(self.values):
            self._snapshot = Dictionary(np.array(self.values, dtype=object))
        return self._snapshot


def _dict_entry(v: str) -> bytes:
    """A dictionary entry's engine value: 2-byte length + utf-8 bytes."""
    enc = v.encode("utf-8")
    if len(enc) > 0xFFFF:
        raise ValueError(
            f"string of {len(enc)} bytes exceeds the 64KiB dictionary-entry "
            "bound (2-byte length header)")
    return len(enc).to_bytes(2, "little") + enc


class KVTable:
    def __init__(self, db: DB, name: str, schema: Schema, pk: str,
                 table_id: int, dict_table_id: int | None = None,
                 indexes: list | None = None):
        for t in schema.types:
            if t.family in _UNSUPPORTED:
                raise TypeError(
                    f"KV tables support fixed-width columns only, got {t}")
        if not 0 <= table_id <= rowcodec.MAX_TABLE_ID:
            raise ValueError(
                f"table_id must be in [0, {rowcodec.MAX_TABLE_ID}]")
        self.db = db
        self.name = name
        self.schema = schema
        self.pk = pk
        self.pk_idx = schema.index(pk)
        self.table_id = table_id
        self._count_cache = None  # ((engine seq, gen), row count)
        # device_batch(persistent=True)'s buffers: {column index: Column}
        # and the mask, at the merged view's capacity
        self._scan_bufs: dict[int, Column] = {}
        self._scan_mask: torch.Tensor | None = None
        self.decoded_snap = None
        # device -> host reads this table made (intent checks, row counts)
        self.host_syncs = 0
        need = rowcodec.value_width(schema)
        if db.engine.val_width < need:
            raise ValueError(
                f"engine val_width {db.engine.val_width} < row width {need}")
        # a pinned snapshot timestamp for every reader of this table
        # (None = now() at decode time) and the txn whose own intents a
        # columnar scan sees; a statement inside ``reading_as`` reads at
        # its txn's instead (``read_context``)
        self.read_ts: int | None = None
        self.reader_txn: int = 0
        self._string_cols = tuple(
            i for i, t in enumerate(schema.types)
            if t.family is Family.STRING)
        self.dict_table_id = dict_table_id
        # secondary indexes (kv/index.IndexDesc), maintained inside every
        # row write's txn, visible to the planner via plan/indexopt.py
        self.indexes: list = list(indexes or [])
        self._dicts: dict[int, _TableDict] = {}
        if self._string_cols:
            if dict_table_id is None:
                raise ValueError(
                    "STRING columns need a dict_table_id (companion key "
                    "space for the persistent dictionary)")
            self._load_dicts()

    @property
    def device(self) -> torch.device:
        return self.db.engine.device

    # -- persistent dictionaries --------------------------------------------

    @staticmethod
    def _dict_pk(col: int, code: int) -> int:
        return (col << 40) | code

    def _dict_key(self, col: int, code: int) -> bytes:
        return rowcodec.encode_pk(self.dict_table_id,
                                  self._dict_pk(col, code))

    def _load_dicts(self) -> None:
        """Rebuild dictionaries from the companion span (restore path)."""
        start, end = rowcodec.table_span(self.dict_table_id)
        by_col: dict[int, list[tuple[int, str]]] = {}
        for k, v in self.db.scan(start, end):
            pk = rowcodec.decode_pk(k)
            col, code = pk >> 40, pk & ((1 << 40) - 1)
            ln = int.from_bytes(v[:2], "little")
            by_col.setdefault(col, []).append(
                (code, v[2:2 + ln].decode("utf-8")))
        for i in self._string_cols:
            entries = sorted(by_col.get(i, []))
            if [c for c, _ in entries] != list(range(len(entries))):
                raise ValueError(
                    f"corrupt string dictionary for {self.name!r} column "
                    f"{i}: codes {[c for c, _ in entries]} have holes")
            self._dicts[i] = _TableDict([s for _, s in entries])

    def _encode_strings(self, t: Txn, row: dict) -> dict:
        """Replace str values with dictionary codes; new entries persist in
        the same transaction and stay pending on it until commit."""
        if not self._string_cols:
            return row
        out = dict(row)
        slots = self._pending_slots(t)
        for i in self._string_cols:
            name = self.schema.names[i]
            v = out.get(name)
            if v is None or isinstance(v, (int, np.integer)):
                continue  # NULL, or already a code
            out[name] = self._txn_code(t, slots, i, str(v))
        return out

    def _txn_code(self, t: Txn, slots: dict, i: int, v: str) -> int:
        """Dictionary code for one string value, allocating a txn-pending
        code (and its companion-span write) on first sight."""
        d = self._dicts.setdefault(i, _TableDict())
        slot = slots.setdefault(i, {})
        code = d.code_of(v)
        if code is None:
            code = slot.get(v)
        if code is None:
            entry = _dict_entry(v)
            code = len(d.values) + len(slot)
            slot[v] = code
            t.put(self._dict_key(i, code), entry)
        return code

    def _pending_slots(self, t: Txn) -> dict:
        pending = getattr(t, "_dict_pending", None)
        if pending is None:
            pending = t._dict_pending = {}
        slots = pending.get(id(self))
        if slots is None:
            slots = pending[id(self)] = {}
            t.on_commit(lambda: self._commit_pending(slots))
        return slots

    def _commit_pending(self, slots: dict) -> None:
        for i, mapping in slots.items():
            d = self._dicts.setdefault(i, _TableDict())
            for v, code in sorted(mapping.items(), key=lambda x: x[1]):
                got = d.add(v)
                if got != code:
                    raise RuntimeError(
                        f"dictionary code drift: {v!r} got {got}, txn "
                        f"assigned {code}")

    # -- write surface ------------------------------------------------------

    def insert_rows(self, t: Txn, columns: dict[str, np.ndarray],
                    valids: dict[str, np.ndarray] | None = None) -> int:
        """Vectorized transactional INSERT (the colenc role): keys and
        values encode in batched numpy passes, string columns dictionary-
        encode per unique value, the txn takes one put per row."""
        cols = dict(columns)
        valids = dict(valids or {})
        n = len(next(iter(cols.values())))
        if self._string_cols:
            slots = self._pending_slots(t)
            for i in self._string_cols:
                name = self.schema.names[i]
                a = cols.get(name)
                if a is None:
                    continue
                arr = np.asarray(a)
                if arr.dtype.kind in ("i", "u"):
                    continue  # already codes
                vmask = valids.get(name)
                strs = np.array(
                    ["" if (vmask is not None and not vmask[j]) else str(x)
                     for j, x in enumerate(arr)], dtype=str)
                uvals, inverse = np.unique(strs, return_inverse=True)
                codes = np.array([self._txn_code(t, slots, i, str(v))
                                  for v in uvals], dtype=np.int64)
                cols[name] = codes[inverse]
        pks = np.asarray(cols[self.pk], dtype=np.int64)
        keys = rowcodec.encode_pk_batch(self.table_id, pks)
        values = rowcodec.encode_rows(self.schema, cols, valids)
        kb, vb = keys.tobytes(), values.tobytes()
        kw, vw = keys.shape[1], values.shape[1]
        # upsert discipline: old rows are read BEFORE the puts land (after
        # them t.get returns the txn's own intent)
        old_rows: dict[int, dict] = {}
        if self.indexes:
            for r in range(n):
                old_v = t.get(kb[r * kw:(r + 1) * kw])
                if old_v is not None:
                    old_rows[r] = rowcodec.decode_row(self.schema, old_v)
        for r in range(n):
            t.put(kb[r * kw:(r + 1) * kw], vb[r * vw:(r + 1) * vw])
        if self.indexes:
            from . import index as ixm

            for r in range(n):
                new_row = {}
                for name in self.schema.names:
                    a = cols.get(name)
                    vmask = valids.get(name)
                    if a is None or (vmask is not None and not vmask[r]):
                        continue
                    new_row[name] = a[r]
                ixm.maintain_row(t, self.indexes, self.schema, new_row,
                                 old_rows.get(r), int(pks[r]))
        self._count_cache = None
        return n

    def bulk_load(self, columns: dict[str, np.ndarray],
                  valids: dict[str, np.ndarray] | None = None,
                  chunk: int = 1 << 18, timings: dict | None = None) -> int:
        """Bulk-load typed host columns through the AddSSTable path: string
        columns dictionary-encode vectorized (each new entry persisted with
        its own put), values and keys encode in numpy passes, and the rows
        land as sorted engine runs through the RunBuilder (bypassing the
        memtable, the WAL's per-row records and the txn machinery).
        ``timings``, when given, gains the seconds of each part:
        ``dicts``, ``encode`` and ``runs``."""
        import time

        from ..storage import ingest as bulk

        timings = timings if timings is not None else {}

        def took(part, t0):
            timings[part] = timings.get(part, 0.0) + time.perf_counter() - t0

        t0 = time.perf_counter()
        cols = dict(columns)
        n = len(next(iter(cols.values())))
        for i in self._string_cols:
            name = self.schema.names[i]
            a = np.asarray(cols[name])
            if a.dtype.kind not in ("O", "U", "S"):
                continue
            d = self._dicts.setdefault(i, _TableDict())
            uvals, inverse = unique_strings(a)
            remap = np.empty(len(uvals), dtype=np.int32)
            new_entries = []
            for j, v in enumerate(uvals):
                code = d.code_of(str(v))
                if code is None:
                    code = d.add(str(v))
                    new_entries.append((code, str(v)))
                remap[j] = code
            cols[name] = remap[inverse]
            for code, v in new_entries:  # persist the dictionary
                self.db.put(self._dict_key(i, code), _dict_entry(v))
        took("dicts", t0)
        t0 = time.perf_counter()
        ts = self.db.clock.now()
        pks = np.asarray(cols[self.pk], dtype=np.int64)
        keys = rowcodec.encode_pk_batch(self.table_id, pks)
        values = rowcodec.encode_rows(self.schema, cols, valids)
        took("encode", t0)
        t0 = time.perf_counter()
        use_bulk = bulk.enabled()
        if use_bulk:
            rb = bulk.RunBuilder(self.db.engine, ts)
            for lo in range(0, n, chunk):
                rb.add(keys[lo:lo + chunk], values[lo:lo + chunk])
            rb.finish()
        else:
            for lo in range(0, n, chunk):
                self.db.engine.ingest(keys[lo:lo + chunk],
                                      values[lo:lo + chunk], ts=ts)
        if self.indexes:
            # index runs ingest beside the rows (IMPORT assumes fresh pks)
            from . import index as ixm

            valids = valids or {}
            for ix in self.indexes:
                a = cols.get(ix.col)
                if a is None:
                    continue
                vmask = valids.get(ix.col)
                keep = (np.asarray(vmask, dtype=bool) if vmask is not None
                        else np.ones(n, dtype=bool))
                ik = ixm.encode_entries(
                    ix.index_id, np.asarray(a, dtype=np.int64)[keep],
                    pks[keep])
                iv = np.zeros((len(ik), 0), dtype=np.uint8)
                if use_bulk:
                    rb = bulk.RunBuilder(self.db.engine, ts)
                    for lo in range(0, len(ik), chunk):
                        rb.add(ik[lo:lo + chunk], iv[lo:lo + chunk])
                    rb.finish()
                else:
                    # entries land sorted (ingest builds one run)
                    ik = ik[np.lexsort(ik.T[::-1])]
                    for lo in range(0, len(ik), chunk):
                        self.db.engine.ingest(ik[lo:lo + chunk],
                                              iv[lo:lo + chunk], ts=ts)
        took("runs", t0)
        self._count_cache = None
        return n

    def insert(self, t: Txn, row: dict) -> None:
        row = self._encode_strings(t, row)
        pk = int(row[self.pk])
        key = rowcodec.encode_pk(self.table_id, pk)
        if self.indexes:
            # a replaced row's stale index entries tombstone in the txn
            from . import index as ix

            old_v = t.get(key)
            old = (rowcodec.decode_row(self.schema, old_v)
                   if old_v is not None else None)
            ix.maintain_row(t, self.indexes, self.schema, row, old, pk)
        t.put(key, rowcodec.encode_row(self.schema, row))

    def delete_pk(self, t: Txn, pk: int) -> None:
        key = rowcodec.encode_pk(self.table_id, int(pk))
        if self.indexes:
            from . import index as ix

            old_v = t.get(key)
            if old_v is not None:
                ix.maintain_row(t, self.indexes, self.schema, None,
                                rowcodec.decode_row(self.schema, old_v),
                                int(pk))
        t.delete(key)

    def _decode_strings(self, row: dict) -> dict:
        for i in self._string_cols:
            name = self.schema.names[i]
            code = row.get(name)
            if code is not None:
                row[name] = self._dicts[i].values[int(code)]
        return row

    def get_row_txn(self, t: Txn, pk: int) -> dict | None:
        """Transactional row read through Txn.get: lands in the txn's read
        spans and sees its snapshot and own intents."""
        v = t.get(rowcodec.encode_pk(self.table_id, int(pk)))
        if v is None:
            return None
        return self._decode_strings(rowcodec.decode_row(self.schema, v))

    def get_row(self, pk: int, ts: int | None = None) -> dict | None:
        v = self.db.get(rowcodec.encode_pk(self.table_id, int(pk)), ts=ts)
        if v is None:
            return None
        return self._decode_strings(rowcodec.decode_row(self.schema, v))

    # -- Table facade (catalog.Table duck type) ------------------------------

    def _span_filter(self, view, ts: int, txn: int):
        start, end = rowcodec.table_span(self.table_id)
        eng: Engine = self.db.engine
        return mvcc.mvcc_scan_filter(
            view, int(ts), int(txn),
            K.words_tensor(K.encode_bound(start, eng.key_width), eng.device),
            K.words_tensor(K.encode_bound(end, eng.key_width), eng.device))

    @property
    def num_rows(self) -> int:
        """Newest-visible row count at now(), for planning only (intents do
        not fail it); one device count and one host sync, cached per
        engine write sequence and run-set generation."""
        eng: Engine = self.db.engine
        key = (eng._seq, eng._gen)  # _gen catches intent resolutions
        if self._count_cache is not None and self._count_cache[0] == key:
            return self._count_cache[1]
        view = eng._merged_view()
        if view is None:
            n = 0
        else:
            sel, _ = self._span_filter(view, self.db.clock.now(), 0)
            self.host_syncs += 1
            n = int(sel.sum())
        self._count_cache = (key, n)
        return n

    def set_stats(self, st) -> None:
        """Install ANALYZE statistics (sql/stats.TableStats): their
        (lo, hi) bounds feed ``col_stats`` for exact-key planning, their
        row count ``estimated_rows``."""
        self.table_stats = st

    def estimated_rows(self) -> int:
        """Planner cardinality: the ANALYZE snapshot when present, else
        the newest-visible count."""
        st = getattr(self, "table_stats", None)
        return st.row_count if st is not None else self.num_rows

    def col_stats(self) -> dict[str, tuple]:
        """Per-column (lo, hi) bounds from the ANALYZE snapshot; none
        without one, so plans over KV tables never size a dense key range
        from a guess."""
        st = getattr(self, "table_stats", None)
        if st is None:
            return {}
        return {
            n: (c.lo, c.hi)
            for n, c in st.cols.items()
            if c.lo is not None and c.hi is not None
        }

    def read_context(self, now: bool = True) -> tuple[int | None, int]:
        """(read timestamp, reader txn id) of a scan from this thread: the
        ``reading_as`` txn's when it belongs to this table's database,
        else the table's pin; an unpinned timestamp is the clock's now(),
        or None with `now` False."""
        txn = _READ_AS.get()
        if txn is not None and txn.db is self.db:
            return txn.read_ts, txn.txn_id
        ts = self.read_ts
        if ts is None and now:
            ts = self.db.clock.now()
        return ts, self.reader_txn

    def snapshot_live_rows(self) -> int:
        """Live-row count at the current read context (read_ts,
        reader_txn): what a scan of this table sees now."""
        view = self.db.engine._merged_view()
        if view is None:
            return 0
        ts, txn = self.read_context()
        sel, _ = self._span_filter(view, ts, txn)
        self.host_syncs += 1
        return int(sel.sum())

    def dict_by_index(self) -> dict:
        return {i: d.snapshot() for i, d in self._dicts.items()}

    @property
    def dictionaries(self) -> dict:
        return {self.schema.names[i]: d.snapshot()
                for i, d in self._dicts.items()}

    @property
    def valids(self):
        # nullability lives in the engine; host-bitmap consumers must fail
        raise AttributeError(
            "KVTable has no host valid bitmaps; nullability is decoded on "
            "device by device_batch()")

    def snapshot_token(self):
        """Identity of the snapshot ``device_batch`` decodes now: equal
        tokens guarantee bit-identical decodes."""
        eng = self.db.engine
        return (id(eng), eng._seq) + self.read_context(now=False)

    def device_batch(self, names: tuple[str, ...] | None = None,
                     persistent: bool = False) -> Batch:
        """Columnar snapshot of the newest-visible rows, decoded on the
        engine's device: one scan-filter pass over the merged view plus
        the rowcodec decode. Raises WriteIntentError on another txn's
        intent in the span (one host sync for the check, counted in
        ``host_syncs``). With `persistent`, the columns decode into
        buffers this table owns, one per column index, that keep their
        address from decode to decode (graphs read them by reference);
        the next persistent decode overwrites the batch, and
        ``decoded_snap`` says which snapshot the buffers hold (the token
        bracketing the decode; None when a write landed during it)."""
        names = names or self.schema.names
        tok0 = self.snapshot_token() if persistent else None
        idxs = tuple(self.schema.index(n) for n in names)
        ts, txn = self.read_context()
        eng: Engine = self.db.engine
        view = eng._merged_view()
        if view is None:
            if persistent:
                self.decoded_snap = None  # not a decode into the buffers
            return empty_batch(self.schema.select(idxs), 1024, eng.device)
        sel, conflict = self._span_filter(view, ts, txn)
        self.host_syncs += 1
        if bool(conflict.any()):
            raise eng._intent_error(view, conflict)
        out = None
        if persistent:
            if (self._scan_mask is None
                    or self._scan_mask.shape != sel.shape
                    or self._scan_mask.device != sel.device):
                self._scan_bufs = {}
                self._scan_mask = torch.empty_like(sel)
            self._scan_mask.copy_(sel)
            sel, out = self._scan_mask, self._scan_bufs
        batch = rowcodec.decode_columns(view.value, sel, self.schema, idxs,
                                        out=out)
        if self.pk_idx in idxs:
            # the PK also lives in the value payload; decoding it from the
            # key exercises the key codec
            cols = list(batch.cols)
            k = idxs.index(self.pk_idx)
            pk = rowcodec.decode_pk_column(view.key)
            if persistent:
                cols[k].data.copy_(pk)
                cols[k].valid.copy_(sel)
            else:
                cols[k] = Column(data=pk, valid=sel)
            batch = Batch(cols=tuple(cols), mask=batch.mask)
        if persistent:
            self.decoded_snap = (tok0 if tok0 == self.snapshot_token()
                                 else None)
        return batch


_DESC_PREFIX = b"\x01desc"


def _descriptor_key(table_id: int, chunk: int) -> bytes:
    return _DESC_PREFIX + b"%03d|%03d" % (table_id, chunk)


def write_descriptor(db: DB, t: KVTable, writer=None) -> None:
    """Persist the table descriptor in the system keyspace, chunked across
    engine values; `writer`, an open Txn, makes the write atomic with
    others."""
    import json

    from .chunked import chunk_blob

    desc = {
        "name": t.name,
        "names": list(t.schema.names),
        "types": [
            {"family": ty.family.name, "width": ty.width,
             "precision": ty.precision, "scale": ty.scale}
            for ty in t.schema.types
        ],
        "pk": t.pk,
        "table_id": t.table_id,
        "dict_table_id": t.dict_table_id,
        "indexes": [
            {"name": ix.name, "col": ix.col, "index_id": ix.index_id}
            for ix in t.indexes
        ],
    }
    blob = json.dumps(desc).encode("utf-8")
    step = max(16, db.engine.val_width - 1)
    w = writer if writer is not None else db
    for ci, piece in enumerate(chunk_blob(blob, step)):
        w.put(_descriptor_key(t.table_id, ci), piece)


def load_catalog_from_engine(catalog, db: DB,
                             id_range: tuple[int, int] | None = None
                             ) -> list[str]:
    """Rebuild KVTable entries from persisted descriptors (the catalog
    bootstrap path). Returns the table names; id_range scopes discovery
    to a table-id slice."""
    import json

    from ..coldata.types import SQLType
    from .chunked import unchunk
    from .index import IndexDesc

    blobs: dict[bytes, list[tuple[bytes, bytes]]] = {}
    for k, v in db.scan(_DESC_PREFIX, _DESC_PREFIX + b"\xff"):
        tid = k[len(_DESC_PREFIX):].split(b"|")[0]
        blobs.setdefault(tid, []).append((k, v))
    out = []
    for tid in sorted(blobs):
        desc = json.loads(unchunk([v for _, v in sorted(blobs[tid])])
                          .decode("utf-8"))
        if id_range is not None and not (
                id_range[0] <= desc["table_id"] <= id_range[1]):
            continue
        types = tuple(
            SQLType(Family[d["family"]], width=d["width"],
                    precision=d["precision"], scale=d["scale"])
            for d in desc["types"])
        t = KVTable(db, desc["name"], Schema(tuple(desc["names"]), types),
                    desc["pk"], desc["table_id"], desc["dict_table_id"],
                    indexes=[IndexDesc(d["name"], d["col"], d["index_id"])
                             for d in desc.get("indexes", [])])
        catalog.tables[desc["name"]] = t
        out.append(desc["name"])
    return out


def used_ids(catalog) -> set[int]:
    """Every table, dictionary and index id the catalog's KV tables hold."""
    used = set()
    for t in catalog.tables.values():
        if isinstance(t, KVTable):
            used.add(t.table_id)
            if t.dict_table_id is not None:
                used.add(t.dict_table_id)
            used.update(ix.index_id for ix in t.indexes)
    return used


def next_id(used: set[int], id_range: tuple[int, int] | None) -> int | None:
    """The id after the highest used one inside the range, or None when
    the range is exhausted."""
    lo, hi = id_range if id_range is not None else _SYSTEM_RANGE
    nxt = max([i for i in used if lo <= i <= hi], default=lo - 1) + 1
    return nxt if nxt <= hi else None


def create_kv_table(catalog, db: DB, name: str, schema: Schema, pk: str,
                    table_id: int | None = None,
                    id_range: tuple[int, int] | None = None) -> KVTable:
    """Create and register a KV-backed table; ids allocate after the
    highest used one inside id_range (default the system range 1..127).
    Tables with STRING columns get a second id for the dictionary span."""
    used = used_ids(catalog)

    def alloc() -> int:
        nxt = next_id(used, id_range)
        if nxt is None:
            lo, hi = id_range if id_range is not None else _SYSTEM_RANGE
            raise ValueError(f"tenant keyspace [{lo},{hi}] exhausted")
        return nxt

    if table_id is None:
        table_id = alloc()
    elif table_id in used:
        raise ValueError(f"table_id {table_id} already in use")
    used.add(table_id)
    dict_table_id = None
    if any(tt.family is Family.STRING for tt in schema.types):
        dict_table_id = alloc()
    t = KVTable(db, name, schema, pk, table_id, dict_table_id)
    catalog.tables[name] = t
    write_descriptor(db, t)
    return t
