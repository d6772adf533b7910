"""Inter-query KV batching — coalesce concurrent same-range point ops.

The port of ``cockroach_tpu.kv.coalesce``.

Reference: CockroachDB's DistSender merges the batchable requests of ONE
batch; under high session concurrency the per-request costs that
dominate a point op (mutex acquisition, WAL record + flush, admission
pacing) are paid once per SESSION even when eight sessions hammer the
same range with independent point reads/writes. This module adds the
missing cross-session axis: a :class:`BatchCoalescer` sits under the
``kv.DB`` non-transactional surface (the serving path for point DML and
row lookups) and merges concurrent ops from different sessions into one
stamped KV batch.

Design — commit train, not a timing window. The first submitter that
finds no flush in progress becomes the train leader and flushes
IMMEDIATELY (a sequential workload never waits on a timer); ops arriving
while that flush is on the wire queue up and the next leader takes them
all in one batch. Batching emerges exactly when there is concurrency to
batch, and adds zero latency when there is not — the group-commit
discipline WAL implementations converged on.

Exactly-once + atomicity ride the engine's replay cache: a merged
write train applies through ``Engine.apply_rpc_batch`` — ops + (cid,
seq) dedup token + response in ONE atomic WAL record, one fsync, one
``governor.pace_write`` — instead of one WAL record per op. DistSender
backends get the same surface (``DistSender.apply_rpc_batch`` routes the
train by range, one stamped sub-batch per range, so a replay after a
split still dedups range-addressed).

Bit-identity with the solo path is the oracle (bench enforces it): each
rider's timestamp comes from the same ``clock.now()`` under the same
engine mutex, lock conflicts surface as the same per-key typed
``WriteIntentError`` demuxed to exactly the conflicting session, and a
single-op train takes the direct ``engine.put`` path a solo ``DB.put``
takes. Chaos site ``kv.batch.coalesce`` fires at flush start: an
injected fault degrades every rider to its own per-session solo batch —
same results, merging lost.
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid

from ..storage.lsm import WriteIntentError
from ..utils import faults, locks, metric, racesan, settings

__all__ = ["BatchCoalescer", "for_db", "reset_db"]

# a follower whose leader vanishes without completing it can never know
# whether its op applied; surface that the way a severed RPC does
from .rpc import AmbiguousResultError  # noqa: E402

# queue-jump ceiling: a follower bounded-waits on its leader; leaders
# complete trains in milliseconds, so a full minute means the leader
# thread died mid-flush (only a killed thread can cause this)
_ABANDON_S = 60.0

# WAL batch records carry uint16 length fields (~64 KiB payload cap);
# chunk trains well under it so an oversized train degrades to more
# trains, never to a typed overflow error the solo path wouldn't raise
_CHUNK_BYTES = 48_000

# adaptive linger: after a train that actually merged ops, the riders it
# just released are racing back with their next op — pausing one beat
# before the next swap lets them board, roughly doubling train size
# under steady concurrency. A train of one (sequential caller) skips the
# linger entirely, so an uncontended workload never pays it.
_LINGER_S = 0.0002


def _b(x) -> bytes:
    return x.encode() if isinstance(x, str) else bytes(x)


class _Op:
    """One rider: a point op parked on the train with its result slot.
    Completion is signalled per TRAIN, not per op: every rider of one
    train shares its epoch event, so the leader wakes the whole train
    with one ``set()`` instead of one wake per rider — at train sizes in
    the tens the per-op Event allocations and wakes are measurable."""

    __slots__ = ("kind", "key", "value", "ts_arg", "filled", "result",
                 "error", "nbytes")

    def __init__(self, kind: str, key: bytes, value: bytes, ts_arg):
        self.kind = kind  # 'put' | 'delete' | 'get'
        self.key = key
        self.value = value
        self.ts_arg = ts_arg  # explicit read timestamp (get only)
        self.filled = False
        self.result = None
        self.error: BaseException | None = None
        self.nbytes = len(key) + len(value)


class BatchCoalescer:
    """Cross-session commit train over one ``kv.DB``.

    Works against either backend a DB can hold — a plain ``Engine`` or a
    ``DistSender`` — through the exact surface DB itself consumes:
    ``engine.mu``, ``put/delete/get``, and ``apply_rpc_batch``.
    """

    def __init__(self, db):
        self.db = db
        self.mu = locks.lock("kv.coalesce")
        # pending ops for the NEXT train; swapped out atomically by the
        # leader. racesan-annotated: this is the cross-session meeting
        # point, and an unlocked touch here is a lost op.
        self._pending: list[_Op] = []
        # completion event for the train currently FORMING; the leader
        # replaces it at swap, so every rider of one train shares one
        self._epoch = threading.Event()
        self._flushing = False
        # stamp identity for merged batches (the replay cache rides
        # along: the dedup entry makes the train's WAL record atomic)
        self.cid = f"coal-{uuid.uuid4().hex[:12]}"
        self._seq = itertools.count(1)
        # pending-value bytes are buffered server state: account them on
        # the cache-level staging ledger like every other standing buffer
        from ..flow import memory as flowmem

        self._staging = flowmem.staging_monitor("kv.coalesce")

    # -- public surface (mirrors DB's non-txn ops) --------------------------

    def put(self, key, value) -> int:
        return self._submit(_Op("put", _b(key), _b(value), None))

    def delete(self, key) -> int:
        return self._submit(_Op("delete", _b(key), b"", None))

    def get(self, key, ts: int | None = None):
        return self._submit(_Op("get", _b(key), b"", ts))

    # -- train mechanics ----------------------------------------------------

    def _submit(self, op: _Op):
        with self.mu:
            racesan.note_write(self, "_pending")
            self._pending.append(op)
            ev = self._epoch  # this op's train signal, fixed at boarding
            lead = not self._flushing
            if lead:
                self._flushing = True
        if lead:
            try:
                self._drive()
            except BaseException:
                # only a non-Exception escape (thread kill) reaches here:
                # un-wedge the train flag so the next submitter can lead
                with self.mu:
                    self._flushing = False
                raise
        elif not ev.wait(_ABANDON_S):
            raise AmbiguousResultError(
                f"coalesced {op.kind} abandoned by its train leader "
                f"(key={op.key!r})")
        if op.error is not None:
            raise op.error
        return op.result

    def _drive(self) -> None:
        """Leader loop: swap out everything pending, flush it as one
        train, repeat until the queue drains, then hand off leadership.
        The emptiness check and the flag drop are one atomic section so
        an op can never land unled."""
        merged = False
        while True:
            if merged:
                time.sleep(_LINGER_S)
            with self.mu:
                racesan.note_read(self, "_pending")
                ops = self._pending
                if not ops:
                    self._flushing = False
                    return
                self._pending = []
                racesan.note_write(self, "_pending")
                ev = self._epoch
                self._epoch = threading.Event()  # next train's signal
            merged = len(ops) >= 2
            # buffered rider payloads are server state for the train's
            # lifetime: charge the staging ledger once per train (a
            # per-op reserve would take the monitor-tree lock twice per
            # rider — measurable at train sizes in the tens)
            held = sum(op.nbytes for op in ops)
            self._staging.reserve(held, force=True)
            try:
                self._run_train(ops)
            finally:
                self._staging.release(held)
                for op in ops:
                    if not op.filled:
                        op.filled = True
                        if op.error is None and op.result is None:
                            op.error = AmbiguousResultError(
                                f"coalesced {op.kind} dropped by train "
                                f"(key={op.key!r})")
                # ONE wake for the whole train: every rider checks its
                # own slot on wakeup
                ev.set()

    def _run_train(self, ops: list[_Op]) -> None:
        try:
            # chaos site: a mid-coalesce fault degrades every rider to
            # its own per-session solo batch, bit-identically — nothing
            # is applied twice because nothing was applied yet
            faults.fire("kv.batch.coalesce")
        except faults.InjectedFault:
            for op in ops:
                self._finish_solo(op)
            return
        writes = [op for op in ops if op.kind != "get"]
        reads = [op for op in ops if op.kind == "get"]
        if len(ops) > 1:
            metric.KV_BATCH_COALESCED.inc(len(ops))
        for chunk in self._chunks(writes):
            self._flush_writes(chunk)
        if reads:
            self._flush_reads(reads)

    def _chunks(self, writes: list[_Op]):
        max_ops = settings.get("kv.batch.coalesce.max_ops")
        chunk: list[_Op] = []
        size = 0
        for op in writes:
            cost = 2 * op.nbytes + 64  # b64 + JSON framing, conservative
            if chunk and (len(chunk) >= max_ops
                          or size + cost > _CHUNK_BYTES):
                yield chunk
                chunk, size = [], 0
            chunk.append(op)
            size += cost
        if chunk:
            yield chunk

    def _flush_writes(self, chunk: list[_Op]) -> None:
        """One stamped batch for the chunk: per-key lock checks and
        per-op timestamps under the engine mutex exactly as the solo
        path orders them, then ONE atomic WAL record for all survivors.

        Group-commit pipelining: the batch appends its WAL record and
        applies with the fsync DEFERRED, the engine mutex is released,
        and the fsync runs outside it — the next train forms and applies
        while this one's sync is on the disk. Riders are acked only
        after the sync returns, so the durability contract is exactly
        the solo path's; only the mutex hold time shrinks."""
        db = self.db
        eng = db.engine
        solo: list[_Op] = []
        with eng.mu:
            muts, riders = [], []
            for op in chunk:
                try:
                    db._check_lock(op.key)
                except WriteIntentError as e:
                    op.error = e  # typed, demuxed to the one session
                    op.filled = True
                    continue
                if (b"\x00" in op.key or len(op.key) > eng.key_width
                        or (len(op.value) > eng.val_width
                            and eng.val_width < 8)):
                    # width/framing violations raise typed errors from
                    # the engine itself; run those solo so the message
                    # is byte-identical to the uncoalesced path
                    solo.append(op)
                    continue
                ts = db.clock.now()
                op.result = ts
                op.filled = True
                muts.append((op.key, op.value, ts, 0,
                             op.kind == "delete"))
                riders.append(op)
            if len(muts) == 1:
                # a train of one is a solo op: identical WAL shape
                # (engine.put syncs inline, so this rider is durable at
                # ack exactly like a solo DB.put)
                k, v, ts, _txn, tomb = muts[0]
                if tomb:
                    eng.delete(k, ts=ts)
                else:
                    eng.put(k, v, ts=ts)
            elif muts:
                resp = {"ts": [m[2] for m in muts]}
                eng.apply_rpc_batch(self.cid, next(self._seq), muts, resp,
                                    sync=False)
        if len(muts) > 1:
            try:
                eng.wal_sync()
            # per-rider demux: a failed sync (an injected disk fault)
            # reaches every rider the way it reaches a solo caller
            # crlint: allow-broad-except(per-rider demux: a failed sync — injected disk fault — reaches every rider the way it reaches a solo caller)
            except Exception as e:  # noqa: BLE001
                for op in riders:
                    op.result = None
                    op.error = e
        for op in solo:
            self._finish_solo(op)

    def _flush_reads(self, reads: list[_Op]) -> None:
        """All reads of the train under one engine-mutex hold (the locks
        are reentrant; solo reads acquire per call). Intent conflicts
        surface per-key, exactly as solo ``DB.get`` raises them."""
        db = self.db
        with db.engine.mu:
            for op in reads:
                try:
                    ts = (op.ts_arg if op.ts_arg is not None
                          else db.clock.now())
                    op.result = db.engine.get(op.key, ts=ts)
                # per-rider demux: re-raised verbatim in the one session
                # crlint: allow-broad-except(per-rider demux: the error is re-raised verbatim in the one submitting session)
                except Exception as e:  # noqa: BLE001
                    op.error = e
                op.filled = True

    def _finish_solo(self, op: _Op) -> None:
        """Degrade one rider to the uncoalesced per-session path (fault
        fallback and typed-error passthrough)."""
        db = self.db
        try:
            if op.kind == "put":
                op.result = db._put_solo(op.key, op.value)
            elif op.kind == "delete":
                op.result = db._delete_solo(op.key)
            else:
                op.result = db._get_solo(op.key, op.ts_arg)
        # per-rider demux: re-raised verbatim in the one session
        # crlint: allow-broad-except(per-rider demux: the error is re-raised verbatim in the one submitting session)
        except Exception as e:  # noqa: BLE001
            op.error = e
        op.filled = True


# one coalescer per DB, attached lazily the first time the gate is on
_attach_mu = locks.lock("kv.coalesce.attach")


def for_db(db) -> BatchCoalescer:
    co = getattr(db, "_coalescer", None)
    if co is None:
        with _attach_mu:
            co = getattr(db, "_coalescer", None)
            if co is None:
                co = BatchCoalescer(db)
                db._coalescer = co
    return co


def reset_db(db) -> None:
    """Drop a DB's attached coalescer (test isolation)."""
    with _attach_mu:
        if getattr(db, "_coalescer", None) is not None:
            db._coalescer = None
