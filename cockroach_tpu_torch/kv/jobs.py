"""Jobs framework — the pkg/jobs analog; the port of
``cockroach_tpu.kv.jobs``.

Job records (id, type, state, payload, progress) persist in a system
keyspace through kv transactions; a resumer registered per job type
drives each job and checkpoints its progress, so a job whose resumer
died resumes from the checkpoint when it is adopted again.

States: pending -> running -> succeeded | failed. The port carries the
IMPORT, CREATE INDEX and changefeed job types (``register_import_job``
here, ``kv.index.register_create_index_job``,
``kv.changefeed.register_changefeed_job``). Node liveness, with its
epoch fencing and orphan adoption, and the backup job type are not
ported: every claim is this registry's own.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass

from .txn import DB

_PREFIX = b"\x01job"
# id-sequence key outside the record prefix: create()'s allocation is a
# point read/write, so concurrent record writes never invalidate it
_SEQ_KEY = b"\x01jbsq"


@dataclass
class Job:
    job_id: int
    job_type: str
    state: str  # pending | running | succeeded | failed
    payload: dict
    progress: dict
    error: str = ""
    # adoption claim: which node runs it, at which liveness epoch
    claim_node: int = 0
    claim_epoch: int = 0


class Registry:
    """Durable job records + resumer dispatch (jobs.Registry reduction)."""

    def __init__(self, db: DB, node_id: int = 1):
        self.db = db
        self.node_id = node_id
        self._mu = threading.Lock()  # guards _resumers and _running
        self._resumers: dict[str, object] = {}
        self._running: set[int] = set()  # in-process, guards self-re-adoption

    # -- resumer registration (RegisterConstructor analog) -------------------

    def register(self, job_type: str, resume_fn) -> None:
        """resume_fn(registry, job) runs/continues the job; it reads
        job.progress for its checkpoint and calls registry.checkpoint(job)
        after each unit of work. Return value = final result payload."""
        with self._mu:
            self._resumers[job_type] = resume_fn

    # -- record persistence --------------------------------------------------
    #
    # Records chunk across engine values (kv/chunked.py). Legacy
    # single-value records (a dot-less key) stay readable.

    @staticmethod
    def _chunk_key(job_id: int, chunk: int) -> bytes:
        assert chunk < 100
        return _PREFIX + b"%08d.%02d" % (job_id, chunk)

    def _write(self, t, job: Job) -> None:
        from .chunked import chunk_blob

        rec = {
            "type": job.job_type, "state": job.state,
            "payload": job.payload, "progress": job.progress,
        }
        if job.error:
            rec["error"] = job.error
        if job.claim_node:
            rec["claim_node"] = job.claim_node
            rec["claim_epoch"] = job.claim_epoch
        blob = json.dumps(rec, separators=(",", ":")).encode("utf-8")
        step = max(16, self.db.engine.val_width)
        for ci, piece in enumerate(chunk_blob(blob, step)):
            t.put(self._chunk_key(job.job_id, ci), piece)

    @staticmethod
    def _parse(job_id: int, blob: bytes) -> Job:
        d = json.loads(blob.decode("utf-8"))
        return Job(job_id, d["type"], d["state"], d["payload"],
                   d["progress"], d.get("error", ""),
                   d.get("claim_node", 0), d.get("claim_epoch", 0))

    @classmethod
    def _from_chunks(cls, job_id: int,
                     chunks: list[tuple[bytes, bytes]]) -> Job:
        from .chunked import unchunk

        return cls._parse(job_id, unchunk([v for _, v in sorted(chunks)]))

    def load(self, job_id: int) -> Job | None:
        lo = self._chunk_key(job_id, 0)
        hi = _PREFIX + b"%08d.\xff" % job_id
        rows = self.db.scan(lo, hi)
        if rows:
            return self._from_chunks(job_id, rows)
        legacy = self.db.get(_PREFIX + b"%08d" % job_id)
        if legacy is not None:
            return self._parse(job_id, legacy)
        return None

    def jobs(self) -> list[Job]:
        by_id: dict[int, list[tuple[bytes, bytes]]] = {}
        legacy: dict[int, bytes] = {}
        for k, v in self.db.scan(_PREFIX, _PREFIX + b"\xff"):
            tail = k[len(_PREFIX):]
            if b"." in tail:
                jid = int(tail.split(b".")[0])
                by_id.setdefault(jid, []).append((k, v))
            else:
                legacy[int(tail)] = v  # pre-chunking single-value record
        out = {jid: self._from_chunks(jid, chunks)
               for jid, chunks in by_id.items()}
        for jid, v in legacy.items():
            # a chunked rewrite of the same job supersedes the legacy row
            out.setdefault(jid, self._parse(jid, v))
        return [out[jid] for jid in sorted(out)]

    # -- lifecycle -----------------------------------------------------------

    def create(self, job_type: str, payload: dict) -> Job:
        """CreateJob: a durable pending record (one txn). The id comes from
        a sequence key read/written INSIDE the txn — a point span, so two
        registries over the same DB cannot allocate the same id (the
        conflicting create retries) and concurrent job-record writes don't
        invalidate the allocation's refresh."""
        def op(t):
            v = t.get(_SEQ_KEY)
            if v is not None:
                top = int(v)
            else:
                # one-time migration from pre-sequence stores: seed from
                # the existing records' max id
                top = 0
                for k, _ in t.scan(_PREFIX, _PREFIX + b"\xff"):
                    top = max(top, int(k[len(_PREFIX):].split(b".")[0]))
            t.put(_SEQ_KEY, b"%d" % (top + 1))
            job = Job(top + 1, job_type, "pending", payload, {})
            self._write(t, job)
            return job

        return self.db.txn(op)

    def checkpoint(self, job: Job) -> None:
        """Persist progress mid-run: a resume after this point starts here,
        not from zero."""
        self.db.txn(lambda t: self._write(t, job))

    def _claim(self, job_id: int, observed: Job) -> Job | None:
        """Transactionally claim a job for this node. The read of the
        record is span-tracked, so two adopters racing on the same orphan
        conflict: the loser's retry re-reads the new claim and backs off
        (returns None) instead of double-running the job."""
        def op(t):
            # read through the txn so the chunk span lands in the read
            # spans (claim races conflict at commit)
            rows = t.scan(self._chunk_key(job_id, 0),
                          _PREFIX + b"%08d.\xff" % job_id)
            if rows:
                cur = self._from_chunks(job_id, rows)
            else:
                legacy = t.get(_PREFIX + b"%08d" % job_id)
                if legacy is None:
                    return None
                cur = self._parse(job_id, legacy)  # rewrite claims chunked
            if cur.state in ("succeeded", "failed"):
                return cur
            if ((cur.claim_node, cur.claim_epoch)
                    != (observed.claim_node, observed.claim_epoch)):
                return None  # someone else claimed since we looked
            cur.state = "running"
            cur.claim_node = self.node_id
            cur.claim_epoch = 0
            self._write(t, cur)
            return cur

        return self.db.txn(op)

    def adopt_and_resume(self, job_id: int) -> Job:
        """Claim a pending/running job and drive its resumer to a terminal
        state. Re-entrant: called again after a crash, the resumer
        continues from the persisted progress."""
        observed = self.load(job_id)
        if observed is None:
            raise KeyError(f"no job {job_id}")
        if observed.state in ("succeeded", "failed"):
            return observed
        with self._mu:
            resume = self._resumers.get(observed.job_type)
        if resume is None:
            raise KeyError(f"no resumer for job type {observed.job_type!r}")
        job = self._claim(job_id, observed)
        if job is None:
            return self.load(job_id)  # lost the claim race: current state
        if job.state in ("succeeded", "failed"):
            return job
        with self._mu:
            self._running.add(job_id)
        try:
            try:
                result = resume(self, job)
            except Exception as e:
                job.state = "failed"
                job.error = f"{type(e).__name__}: {e}"
                self.checkpoint(job)
                raise
            job.state = "succeeded"
            if isinstance(result, dict):
                job.progress.update(result)
            self.checkpoint(job)
            return job
        finally:
            with self._mu:
                self._running.discard(job_id)


def register_import_job(registry: Registry, catalog) -> None:
    """IMPORT INTO <table> CSV DATA (file) as a job: parse the CSV on the
    host, bulk-load through the AddSSTable path (KVTable.bulk_load), record
    row counts in progress — the pkg/sql/importer reduction. The payload's
    ``path`` is a local file (a ``file://`` URI or a plain path)."""
    import csv as _csv

    import numpy as np

    from ..coldata.types import Family

    def import_resume(reg: Registry, job: Job):
        import io

        table = catalog.tables[job.payload["table"]]
        path = job.payload["path"]
        if path.startswith("file://"):
            path = path[len("file://"):]
        with open(path, "rb") as f:
            data = f.read().decode("utf-8")
        rows = list(_csv.DictReader(io.StringIO(data, newline="")))
        cols: dict[str, np.ndarray] = {}
        valids: dict[str, np.ndarray] = {}
        for name, t in zip(table.schema.names, table.schema.types):
            raw = [r.get(name, "") for r in rows]
            missing = np.array([x == "" for x in raw])
            if t.family is Family.STRING:
                cols[name] = np.array(
                    [x if x else "" for x in raw], dtype=object)
            elif t.family is Family.FLOAT:
                cols[name] = np.array(
                    [float(x) if x else 0.0 for x in raw])
            elif t.family is Family.DECIMAL:
                cols[name] = np.array([
                    int(round(float(x) * 10**t.scale)) if x else 0
                    for x in raw], dtype=np.int64)
            elif t.family is Family.BOOL:
                cols[name] = np.array(
                    [x.lower() == "true" for x in raw])
            else:
                cols[name] = np.array(
                    [int(x) if x else 0 for x in raw], dtype=np.int64)
            if missing.any():
                valids[name] = ~missing
        n = table.bulk_load(cols, valids)
        return {"rows": n}

    registry.register("import", import_resume)
