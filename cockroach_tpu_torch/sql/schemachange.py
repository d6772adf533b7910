"""Schema changer — ALTER TABLE ADD/DROP COLUMN as a backfill job; the port
of ``cockroach_tpu.sql.schemachange``.

Reference: pkg/sql/schemachanger runs declarative schema changes as jobs
with checkpointed backfill progress (legacy path: sql/backfill.go +
rowexec backfillers); the new column becomes visible only when the
backfill completes and the descriptor version swaps.

Reduction: one job type ("schema_change") that rewrites every row of the
target table from the old value layout to the new one in pk-ordered
chunks, checkpointing {last_pk} in the job record after each chunk — a
crash mid-backfill resumes at the checkpoint, and already-rewritten rows
are recognized by their value WIDTH (add/drop always changes the fixed
row width), so re-running a chunk is idempotent. The catalog descriptor
swaps only after the backfill finishes. Concurrent DML during the change
is out of scope (single-session discipline; the reference's online
delete-only/write-only states are the non-reduced version of this).

The backfill decodes and re-encodes each row on the host
(``rowcodec.decode_row``/``encode_row``) with one ``db.scan`` and one txn
per chunk, as the reference's does; the engine it writes lives on the
session's device. ``_fenced_job_read`` is the one fence of every
non-re-runnable schema-change txn, CREATE INDEX's (kv/index.py) included.
"""

from __future__ import annotations

from ..coldata import types as T
from ..storage import rowcodec

CHUNK_ROWS = 512


def _type_of(cdef) -> T.SQLType:
    """ColumnDef -> SQLType (the session's _col_type, importable here)."""
    from .session import _col_type

    return _col_type(cdef)


def plan_alter(catalog, db, stmt) -> dict:
    """Validate an AlterTable statement and build the job payload."""
    from .binder import BindError
    from .session import _col_type

    tbl = catalog.tables.get(stmt.name)
    if tbl is None:
        raise BindError(f"unknown table {stmt.name!r}")
    from ..kv.table import KVTable

    if not isinstance(tbl, KVTable):
        raise BindError("ALTER TABLE targets KV-backed tables")
    if stmt.action == "add":
        c = stmt.column
        if c.name in tbl.schema.names:
            raise BindError(f"column {c.name!r} already exists")
        t = _col_type(c)
        new_names = tbl.schema.names + (c.name,)
        new_types = tbl.schema.types + (t,)
        default = None
        if stmt.default is not None:
            from .session import Session

            default = Session._literal(stmt.default, t)
            if hasattr(default, "item"):
                default = default.item()
        elif c.not_null:
            raise BindError(
                "ADD COLUMN NOT NULL requires a DEFAULT (existing rows "
                "must get a value)"
            )
        payload = {
            "table": stmt.name, "action": "add", "col": c.name,
            "type": str(t), "default": default,
            "coldef": {"name": c.name, "type_name": c.type_name,
                       "precision": c.precision, "scale": c.scale,
                       "not_null": c.not_null},
        }
        if t.family is T.Family.STRING:
            # the companion dictionary id is allocated NOW and carried in
            # the payload (a crash-resume must land entries in the same
            # span the final descriptor will name)
            dict_id = tbl.dict_table_id
            if dict_id is None:
                used = set()
                for other in catalog.tables.values():
                    if isinstance(other, KVTable):
                        used.add(other.table_id)
                        if other.dict_table_id is not None:
                            used.add(other.dict_table_id)
                dict_id = max(used, default=0) + 1
            payload["dict_table_id"] = dict_id
            if default is not None:
                # the default string becomes dictionary code 0 for the
                # new column; backfilled rows store the code
                payload["string_default"] = str(default)
                payload["default"] = 0
    else:
        if stmt.drop_name == tbl.pk:
            raise BindError("cannot drop the PRIMARY KEY column")
        if stmt.drop_name not in tbl.schema.names:
            raise BindError(f"unknown column {stmt.drop_name!r}")
        new_names = tuple(n for n in tbl.schema.names if n != stmt.drop_name)
        new_types = tuple(
            t for n, t in zip(tbl.schema.names, tbl.schema.types)
            if n != stmt.drop_name
        )
        payload = {"table": stmt.name, "action": "drop",
                   "col": stmt.drop_name}
    new_schema = T.Schema(new_names, new_types)
    need = rowcodec.value_width(new_schema)
    if db.engine.val_width < need:
        raise BindError(
            f"new row width {need} exceeds engine value width "
            f"{db.engine.val_width}"
        )
    return payload


def _schemas_for(catalog, payload):
    """(old_schema, new_schema, kvtable) from the payload + the catalog's
    CURRENT (pre-swap) descriptor — stable across crash-resume because the
    descriptor only swaps at completion."""
    from .parser import ColumnDef

    tbl = catalog.tables[payload["table"]]
    old = tbl.schema
    if payload["action"] == "add":
        cd = payload["coldef"]
        c = ColumnDef(cd["name"], cd["type_name"], cd["precision"],
                      cd["scale"], False, cd["not_null"])
        new = T.Schema(old.names + (c.name,), old.types + (_type_of(c),))
    else:
        keep = [i for i, n in enumerate(old.names) if n != payload["col"]]
        new = T.Schema(tuple(old.names[i] for i in keep),
                       tuple(old.types[i] for i in keep))
    return old, new, tbl


def backfill(reg, job, catalog) -> None:
    """The schema_change resumer: chunked rewrite + checkpoint + swap.

    Crash-idempotence: a resume AFTER the descriptor already swapped must
    not derive schemas from the post-swap descriptor (it would re-apply
    the change on top of itself). Completion is a DURABLE progress flag
    committed in the same txn as the descriptor swap — never inferred
    from the catalog's column set, which a later user ALTER could have
    changed back."""
    payload = job.payload
    durable = reg.load(job.job_id)
    if durable is not None and durable.progress.get("swapped"):
        job.progress.update(durable.progress)
        return
    if durable is not None:
        job.progress.update(durable.progress)  # fresh resume state
    old, new, tbl = _schemas_for(catalog, payload)
    old_w = rowcodec.value_width(old)
    db = reg.db
    start, end = rowcodec.table_span(tbl.table_id)
    last_pk = job.progress.get("last_pk")
    default = payload.get("default")
    colname = payload.get("col")
    sdef = payload.get("string_default")
    if sdef is not None:
        # persist the default as dictionary code 0 of the NEW column's
        # position (idempotent put: resume re-writes the same entry)
        new_pos = len(new.names) - 1
        enc = sdef.encode("utf-8")
        db.put(
            rowcodec.encode_pk(payload["dict_table_id"],
                               (new_pos << 40) | 0),
            len(enc).to_bytes(2, "little") + enc,
        )
    while True:
        lo = (rowcodec.encode_pk(tbl.table_id, last_pk + 1)
              if last_pk is not None else start)
        rows = db.scan(lo, end, max_keys=CHUNK_ROWS)
        if not rows:
            break

        def rewrite(t, rows=rows):
            done_pk = None
            for k, v in rows:
                pk = rowcodec.decode_pk(k)
                done_pk = pk
                if len(v) != old_w:
                    continue  # already the new layout (resumed chunk)
                row = rowcodec.decode_row(old, v)
                if payload["action"] == "add":
                    row[colname] = default
                else:
                    row.pop(colname, None)
                t.put(k, rowcodec.encode_row(new, row))
            return done_pk

        last_pk = db.txn(rewrite)
        job.progress["last_pk"] = int(last_pk)
        reg.checkpoint(job)
    _swap_descriptor(catalog, db, tbl, new, payload, reg=reg, job=job)


def _remap_dict_span(db, tbl, new_schema, reg=None, job=None) -> None:
    """The persistent string dictionaries key on COLUMN POSITION
    ((col << 40) | code, kv/table.py): a drop that shifts later STRING
    columns left must rewrite their entries to the new positions, and a
    dropped STRING column's entries are deleted.

    NOT re-runnable (a second pass would treat already-moved entries as
    the dropped column's and delete them), so the job's remapped flag
    commits IN THE SAME TXN as the moves — and that txn re-reads the
    DURABLE job record (not the caller's in-memory copy) plus the
    claimant's liveness epoch, so a fenced-out stale node that wakes
    after its replacement finished cannot run the moves again (the
    Registry.checkpoint fencing discipline)."""
    if tbl.dict_table_id is None:
        return
    if job is not None:
        # durable fast path: a resume after the remap committed skips the
        # full dict-span scan (the in-txn fenced re-check below stays the
        # correctness gate)
        durable = reg.load(job.job_id)
        if durable is not None and durable.progress.get("dict_remapped"):
            job.progress.setdefault("dict_remapped", True)
            return
    old_pos = {n: i for i, n in enumerate(tbl.schema.names)}
    new_pos = {n: i for i, n in enumerate(new_schema.names)}
    moves: dict[int, int | None] = {}
    for n, i in old_pos.items():
        if tbl.schema.types[i].family is not T.Family.STRING:
            continue
        moves[i] = new_pos.get(n)  # None: column dropped
    if all(src == dst for src, dst in moves.items()):
        return
    start, end = rowcodec.table_span(tbl.dict_table_id)
    rows = db.scan(start, end)

    def rewrite(t):
        if job is not None:
            cur = _fenced_job_read(reg, job, t)
            if cur.progress.get("dict_remapped"):
                return
        for k, v in rows:
            pk = rowcodec.decode_pk(k)
            col, code = pk >> 40, pk & ((1 << 40) - 1)
            if col not in moves or moves[col] == col:
                continue
            t.delete(k)
            dst = moves[col]
            if dst is not None:
                t.put(rowcodec.encode_pk(tbl.dict_table_id,
                                         (dst << 40) | code), v)
        if job is not None:
            job.progress["dict_remapped"] = True
            reg._write(t, job)

    db.txn(rewrite)


def _fenced_job_read(reg, job, t):
    """Read the DURABLE job record inside txn `t`, verifying this node
    still owns the claim at its believed epoch (Registry.checkpoint's
    fence, shared by every non-re-runnable schema-change txn)."""
    from ..kv.jobs import _PREFIX

    rows = t.scan(reg._chunk_key(job.job_id, 0),
                  _PREFIX + b"%08d.\xff" % job.job_id)
    cur = (reg._from_chunks(job.job_id, rows) if rows else job)
    if (cur.claim_node, cur.claim_epoch) != (job.claim_node,
                                             job.claim_epoch):
        raise RuntimeError(
            f"job {job.job_id} was re-adopted by node {cur.claim_node} "
            f"(epoch {cur.claim_epoch}); this claimant is stale"
        )
    if reg.liveness is not None and job.claim_node == reg.node_id:
        rec = reg.liveness._read(reg.node_id, t)
        if rec is not None and rec.epoch != job.claim_epoch:
            from ..kv.liveness import EpochFencedError

            raise EpochFencedError(
                f"node {reg.node_id} epoch {rec.epoch} != claim epoch "
                f"{job.claim_epoch}"
            )
    return cur


def _swap_descriptor(catalog, db, tbl, new_schema, payload,
                     reg=None, job=None) -> None:
    """Install the new schema: fresh KVTable over the same spans, persist
    the descriptor, replace the catalog entry (descriptor-version bump)."""
    from ..kv.table import KVTable, write_descriptor

    _remap_dict_span(db, tbl, new_schema, reg=reg, job=job)
    # an added STRING column's dict id was allocated at plan time (the
    # backfill already wrote entries into that span)
    dict_id = payload.get("dict_table_id", tbl.dict_table_id)
    nt = KVTable(db, tbl.name, new_schema, pk=tbl.pk,
                 table_id=tbl.table_id, dict_table_id=dict_id)

    def swap(t):
        if job is not None:
            _fenced_job_read(reg, job, t)
        # descriptor chunks + durable completion marker in ONE txn: a
        # crash leaves either the old schema with no marker (resume
        # re-runs safely) or the new schema with the marker (resume
        # finishes immediately) — never the corrupting in-between
        write_descriptor(db, nt, writer=t)
        if job is not None:
            job.progress["swapped"] = True
            reg._write(t, job)

    db.txn(swap)
    catalog.tables[tbl.name] = nt


def register_schema_change_job(registry, catalog) -> None:
    def resume(reg, job):
        backfill(reg, job, catalog)

    registry.register("schema_change", resume)
