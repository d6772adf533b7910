"""Secondary indexes — key codec, write maintenance, Streamer fetch; the
port of ``cockroach_tpu.kv.index``.

Secondary-index keys are table/index-prefixed, order-preserving encodings
of the indexed column with the primary key as suffix
(pkg/sql/rowenc/index_encoding.go); index joins read the matched primary
rows through one batched fetch (the kvstreamer role); CREATE INDEX
backfills run as chunked, checkpointed jobs.

- The Streamer resolves a request's primary keys as one vectorized
  searchsorted over the engine's merged view on the device, then a
  compacting gather into a batch sized by the request, not the table.
- Index entries are presence-only (empty value); the fetch always goes
  back to the primary.
- One indexed column, fixed-width families; STRING columns index their
  dictionary codes (equality only).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..coldata.types import Family
from ..storage import rowcodec

# index entry: 1 prefix byte + 10 value bytes + 10 pk bytes = 21 bytes; an
# indexed engine needs key_width >= 24
ENTRY_BYTES = 1 + 2 * rowcodec.PK_BYTES

CHUNK_ROWS = 512


class BindError(Exception):
    """A statement refers to something that does not exist or cannot be
    done (the binder's error, raised by the DDL planners here)."""


@dataclass(frozen=True)
class IndexDesc:
    name: str
    col: str
    index_id: int  # its own keyspace prefix, allocated like a table id


@dataclass(frozen=True)
class CreateIndex:
    """CREATE INDEX <name> ON <table> (<col>), as the parser gives it."""

    name: str
    table: str
    col: str


def _enc_val(v: int) -> bytes:
    """Order-preserving, NUL-free 10-byte encoding of one int64."""
    return rowcodec.encode_pk(0, v)[1:]


def encode_entry(index_id: int, val: int, pk: int) -> bytes:
    assert 0 <= index_id <= rowcodec.MAX_TABLE_ID
    return bytes([0x01 + index_id]) + _enc_val(val) + _enc_val(pk)


def decode_entry(key: bytes) -> tuple[int, int]:
    """(value, pk) from an index entry key."""
    n = rowcodec.PK_BYTES
    return (rowcodec.decode_pk(key[:1 + n]),
            rowcodec.decode_pk(key[n:1 + 2 * n]))


def value_span(index_id: int, lo: int | None, hi: int | None
               ) -> tuple[bytes, bytes]:
    """[start, end) covering entries with value in [lo, hi] (inclusive;
    None = unbounded on that side)."""
    assert 0 <= index_id <= rowcodec.MAX_TABLE_ID
    prefix = bytes([0x01 + index_id])
    start = prefix + _enc_val(lo) if lo is not None else prefix
    # entry bytes are in [0x01, 0x80], so 0x81 sorts after every pk suffix
    end = (prefix + _enc_val(hi) + b"\x81" if hi is not None
           else bytes([0x02 + index_id]))
    return start, end


def encode_entries(index_id: int, vals: np.ndarray,
                   pks: np.ndarray) -> np.ndarray:
    """Vectorized entry encode: [N] vals + [N] pks -> [N, ENTRY_BYTES]."""
    out = np.empty((len(vals), ENTRY_BYTES), dtype=np.uint8)
    out[:, 0] = 0x01 + index_id
    out[:, 1:1 + rowcodec.PK_BYTES] = rowcodec.encode_int_groups(vals)
    out[:, 1 + rowcodec.PK_BYTES:] = rowcodec.encode_int_groups(pks)
    return out


# -- write-path maintenance (called from KVTable inside the row's txn) ------


def entries_for_row(indexes, schema, row: dict, pk: int) -> list[bytes]:
    """Index entry keys for one value-encoded row; a NULL indexed value
    gets no entry (index filters are null-rejecting)."""
    out = []
    for ix in indexes:
        v = row.get(ix.col)
        if v is not None:
            out.append(encode_entry(ix.index_id, int(v), pk))
    return out


def maintain_row(t, indexes, schema, new_row: dict | None,
                 old_row: dict | None, pk: int) -> None:
    """Delete stale and write fresh index entries for one primary row
    (None = absent)."""
    old = set(entries_for_row(indexes, schema, old_row, pk)) if old_row else set()
    new = set(entries_for_row(indexes, schema, new_row, pk)) if new_row else set()
    for k in old - new:
        t.delete(k)
    for k in new - old:
        t.put(k, b"")


# -- the Streamer: batched primary-row fetch --------------------------------


class Streamer:
    """Vectorized primary-row fetch (kvstreamer.Streamer / joinreader
    role): all requested primary keys resolve in one device pass over the
    merged view — searchsorted membership plus a compacting gather, the
    output sized by the request."""

    def __init__(self, table):
        self.table = table

    def fetch(self, pks: np.ndarray, names: tuple[str, ...]):
        """Batch of the requested columns for rows whose pk is in `pks`,
        at the table's read context. Capacity: len(pks) padded to a power
        of two (at least 128); missing pks leave masked-off rows."""
        from ..coldata.batch import Batch, Column, empty_batch
        from ..storage import keys as K
        from ..storage import mvcc

        tbl = self.table
        idxs = tuple(tbl.schema.index(n) for n in names)
        schema = tbl.schema.select(idxs)
        eng = tbl.db.engine
        cap_out = max(128, 1 << int(np.ceil(np.log2(max(1, len(pks))))))
        view = eng._merged_view() if len(pks) else None
        if view is None:
            return empty_batch(schema, cap_out, eng.device)
        ts, reader = tbl.read_context()
        spks = np.sort(np.asarray(pks, dtype=np.int64))
        sw = K.encode_bound(rowcodec.encode_pk(tbl.table_id, int(spks[0])),
                            eng.key_width)
        ew = K.encode_bound(
            rowcodec.encode_pk(tbl.table_id, int(spks[-1])) + b"\x01",
            eng.key_width)
        sel, conflict = mvcc.mvcc_scan_filter(
            view, int(ts), int(reader),
            K.words_tensor(sw, eng.device), K.words_tensor(ew, eng.device))
        if bool(conflict.any()):
            raise eng._intent_error(view, conflict)
        # vectorized membership: view pk in the sorted request set
        vpk = rowcodec.decode_pk_column(view.key)
        dpks = torch.from_numpy(spks).to(eng.device)
        posc = torch.searchsorted(dpks, vpk).clamp_(0, len(spks) - 1)
        sel = sel & (dpks[posc] == vpk)
        # compacting gather: hits land in [0, cap_out), the rest point at
        # a zero pad row
        cap = view.capacity
        hits = torch.nonzero(sel).squeeze(1)[:cap_out]
        dest = torch.full((cap_out,), cap, dtype=torch.int64,
                          device=eng.device)
        dest[:hits.shape[0]] = hits
        batch = rowcodec.decode_columns(view.value, sel, tbl.schema, idxs)

        def take(col):
            pad = torch.zeros((1,) + tuple(col.shape[1:]), dtype=col.dtype,
                              device=col.device)
            return torch.cat([col, pad])[dest]

        mask = take(sel)
        cols = []
        for pos_i, i in enumerate(idxs):
            c = batch.cols[pos_i]
            if i == tbl.pk_idx:
                cols.append(Column(data=take(vpk), valid=mask))
            else:
                cols.append(Column(data=take(c.data), valid=take(c.valid)))
        return Batch(cols=tuple(cols), mask=mask)


# -- index scan (host side of the read path) --------------------------------


def scan_pks(table, index: IndexDesc, lo: int | None, hi: int | None,
             max_keys: int | None = None) -> np.ndarray:
    """Primary keys whose indexed value falls in [lo, hi], read from the
    index keyspace at the table's read context (ts and txn visibility)."""
    start, end = value_span(index.index_id, lo, hi)
    ts, reader = table.read_context()
    rows = table.db.engine.scan(start, end, ts=ts, txn=reader,
                                max_keys=max_keys)
    return np.array([decode_entry(k)[1] for k, _ in rows], dtype=np.int64)


# -- CREATE INDEX backfill job ----------------------------------------------


def plan_create_index(catalog, db, stmt,
                      id_range: tuple[int, int] | None = None) -> dict:
    """Validate CREATE INDEX (`stmt`: table, name, col) and build the job
    payload; the index id is allocated now, inside id_range, so a
    crash-resume lands entries in the final span."""
    from .table import KVTable, next_id, used_ids

    tbl = catalog.tables.get(stmt.table)
    if tbl is None:
        raise BindError(f"unknown table {stmt.table!r}")
    if not isinstance(tbl, KVTable):
        raise BindError("CREATE INDEX targets KV-backed tables")
    if db.engine.key_width < ENTRY_BYTES:
        raise BindError(
            f"engine key_width {db.engine.key_width} cannot hold "
            f"{ENTRY_BYTES}-byte index entries (provision the store with "
            f"key_width >= {ENTRY_BYTES})")
    if any(ix.name == stmt.name for ix in tbl.indexes):
        raise BindError(f"index {stmt.name!r} already exists")
    if stmt.col not in tbl.schema.names:
        raise BindError(f"unknown column {stmt.col!r}")
    fam = tbl.schema.type_of(stmt.col).family
    if fam in (Family.FLOAT, Family.BYTES, Family.JSON):
        raise BindError(
            f"indexes on {fam.name} columns are not supported (order-"
            "preserving int encoding only)")
    index_id = next_id(used_ids(catalog), id_range)
    if index_id is None:
        raise BindError(f"tenant keyspace {id_range or (1, 127)} exhausted")
    return {"table": stmt.table, "index": stmt.name, "col": stmt.col,
            "index_id": index_id}


def backfill_index(reg, job, catalog) -> None:
    """The create_index resumer: chunked entry writes, a checkpoint after
    each chunk, then a fenced descriptor swap that makes the index visible.
    With bulk ingest on, each chunk's entries land as one RunBuilder run."""
    from ..sql.schemachange import _fenced_job_read
    from ..storage import ingest as bulk
    from .table import KVTable, write_descriptor

    payload = job.payload
    durable = reg.load(job.job_id)
    if durable is not None:
        job.progress.update(durable.progress)
        if durable.progress.get("swapped"):
            return
    tbl: KVTable = catalog.tables[payload["table"]]
    ix = IndexDesc(payload["index"], payload["col"], payload["index_id"])
    db = reg.db
    use_bulk = bulk.enabled() and db.engine.key_width >= ENTRY_BYTES
    start, end = rowcodec.table_span(tbl.table_id)
    last_pk = job.progress.get("last_pk")

    def entries(rows):
        """(last pk of the chunk, [(value, pk)] of its non-NULL values)."""
        done, out = None, []
        for k, v in rows:
            done = rowcodec.decode_pk(k)
            val = rowcodec.decode_row(tbl.schema, v).get(ix.col)
            if val is not None:
                out.append((int(val), done))
        return done, out

    while True:
        lo = (rowcodec.encode_pk(tbl.table_id, last_pk + 1)
              if last_pk is not None else start)
        rows = db.scan(lo, end, max_keys=CHUNK_ROWS)
        if not rows:
            break
        if use_bulk:
            last_pk, got = entries(rows)
            if got:
                vals, pks = (np.asarray(x, np.int64) for x in zip(*got))
                rb = bulk.RunBuilder(db.engine, db.clock.now())
                rb.add(encode_entries(ix.index_id, vals, pks),
                       np.zeros((len(got), 0), np.uint8))
                rb.finish()
        else:
            def write_chunk(t, rows=rows):
                done, got = entries(rows)
                for val, pk in got:
                    t.put(encode_entry(ix.index_id, val, pk), b"")
                return done

            last_pk = db.txn(write_chunk)
        job.progress["last_pk"] = int(last_pk)
        reg.checkpoint(job)

    def swap(t):
        _fenced_job_read(reg, job, t)
        tbl.indexes.append(ix)
        write_descriptor(db, tbl, writer=t)
        job.progress["swapped"] = True
        reg._write(t, job)

    try:
        db.txn(swap)
    except BaseException:
        if any(i.name == ix.name for i in tbl.indexes):
            tbl.indexes.remove(ix)
        raise


def drop_index(catalog, db, table_name: str, index_name: str) -> None:
    """DROP INDEX: remove it from the descriptor first (readers stop
    routing through it), then delete the entry span in chunks."""
    from .table import write_descriptor

    tbl = catalog.tables[table_name]
    ix = next((i for i in tbl.indexes if i.name == index_name), None)
    if ix is None:
        raise BindError(f"unknown index {index_name!r}")
    tbl.indexes.remove(ix)
    write_descriptor(db, tbl)
    start, end = value_span(ix.index_id, None, None)
    while True:
        rows = db.scan(start, end, max_keys=1024)
        if not rows:
            break

        def rm(t, rows=rows):
            for k, _ in rows:
                t.delete(k)

        db.txn(rm)


def register_create_index_job(registry, catalog) -> None:
    registry.register(
        "create_index", lambda reg, job: backfill_index(reg, job, catalog))
