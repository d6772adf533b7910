"""Transactional KV — the pkg/kv surface (kv.DB / kv.Txn) over the LSM
engine's MVCC intents; the port of ``cockroach_tpu.kv.txn``.

Reference mapping:
- ``DB.txn(fn)``   <- kv.DB.Txn closure-with-retries (pkg/kv/db.go); retries
  on retryable errors with a bumped timestamp, like TxnCoordSender's retry
  loop around serializability failures.
- intents          <- provisional values owned by a txn id; reads of other
  txns' visible intents fail (WriteIntentError), writes check the lock
  before laying an intent (concurrency manager's lock table role).
- commit           <- read-span refresh validation (span refresher
  interceptor semantics) then intent resolution at the commit timestamp
  (MVCCResolveWriteIntent); abort drops the intents.
- WriteTooOld      <- a newer committed version above the txn's read_ts
  forces a retry, as in the reference's WriteTooOldError.

Single-process scope: the engine mutex latches each write. With
``kv.batch.coalesce.enabled`` (off by default, as in the reference),
concurrent non-transactional ops of different sessions ride one commit
train (kv/coalesce.py).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from ..storage.lsm import Engine, WriteIntentError
from ..utils import metric, settings
from . import hlc


class TransactionRetryError(Exception):
    """Retryable: the txn must restart at a higher timestamp."""


class TransactionAbortedError(Exception):
    """Non-retryable inside the closure: the txn was aborted."""


# txn control-flow errors cross the query error boundary unwrapped (the
# colexecerror.ExpectedError discipline)
from ..utils.errors import register_passthrough as _rp  # noqa: E402

_rp(TransactionRetryError)
_rp(TransactionAbortedError)


_txn_ids = itertools.count(1)


@dataclass
class Txn:
    db: "DB"
    txn_id: int
    read_ts: int
    _finished: bool = False
    # read spans for commit-time refresh validation: (start, end, is_point);
    # point spans cover exactly their key, end=None means unbounded
    _read_spans: list[tuple[bytes, bytes | None, bool]] = field(
        default_factory=list)
    _write_keys: list[bytes] = field(default_factory=list)
    # callbacks fired once after a SUCCESSFUL commit (discarded on
    # rollback/retry): side effects that must be atomic with the txn
    # (e.g. KVTable's in-memory dictionary additions)
    _commit_hooks: list = field(default_factory=list)

    def on_commit(self, cb) -> None:
        self._commit_hooks.append(cb)

    def note_read_span(self, start: bytes, end: bytes | None,
                       point: bool = False) -> None:
        """Record an externally-performed read (e.g. a columnar table scan
        executed at this txn's snapshot) so commit-time refresh validation
        covers it — the span-refresher contract for reads that bypass
        Txn.get/scan."""
        self._check_open()
        self._read_spans.append((start, end, point))

    # -- reads --------------------------------------------------------------

    def get(self, key: bytes | str) -> bytes | None:
        self._check_open()
        k = _b(key)
        self._read_spans.append((k, None, True))
        try:
            return self.db.engine.get(k, ts=self.read_ts, txn=self.txn_id)
        except WriteIntentError as e:
            _record_contention(e, self.txn_id)
            raise TransactionRetryError(
                f"conflicting intent on {e.keys}"
            ) from e

    def scan(self, start: bytes | str | None, end: bytes | str | None,
             max_keys: int | None = None) -> list[tuple[bytes, bytes]]:
        self._check_open()
        s = _b(start) if start is not None else None
        e = _b(end) if end is not None else None
        self._read_spans.append((s or b"", e, False))
        try:
            return self.db.engine.scan(
                s, e, ts=self.read_ts, txn=self.txn_id, max_keys=max_keys
            )
        except WriteIntentError as err:
            _record_contention(err, self.txn_id)
            raise TransactionRetryError(
                f"conflicting intent on {err.keys}"
            ) from err

    # -- writes -------------------------------------------------------------

    def put(self, key: bytes | str, value: bytes | str) -> None:
        self._write(_b(key), value, tomb=False)

    def delete(self, key: bytes | str) -> None:
        self._write(_b(key), b"", tomb=True)

    def _write(self, key: bytes, value, tomb: bool) -> None:
        self._check_open()
        # the lock-check + write pair holds the engine mutex so a concurrent
        # txn can't interleave between the check and the intent landing
        # (latch-acquisition atomicity, concurrency_manager.SequenceReq)
        with self.db.engine.mu:
            other = self.db.engine.other_intent(key, self.txn_id)
            if other is not None:
                _record_contention(
                    WriteIntentError([key], [other]), self.txn_id
                )
                raise TransactionRetryError(
                    f"key {key!r} locked by txn {other}"
                )
            if self.db.engine.newest_committed_ts(key) > self.read_ts:
                # WriteTooOld: someone committed above our snapshot
                raise TransactionRetryError(f"write too old on {key!r}")
            if tomb:
                self.db.engine.delete(key, ts=self.read_ts, txn=self.txn_id)
            else:
                self.db.engine.put(key, value, ts=self.read_ts,
                                   txn=self.txn_id)
        self._write_keys.append(key)

    # -- lifecycle ----------------------------------------------------------

    def commit(self) -> int:
        self._check_open()
        commit_ts = self.db.clock.now()
        # refresh + resolve are one atomic section under the engine mutex:
        # a write landing between a validated refresh and the intent
        # resolution would invalidate the just-checked read spans
        with self.db.engine.mu:
            # refresh: reads must still be valid at commit_ts
            for s, e, is_point in self._read_spans:
                if self.db.engine.has_committed_writes_in(
                    s, e, self.read_ts, commit_ts, point=is_point
                ):
                    self.rollback()
                    raise TransactionRetryError(
                        f"read span {s!r} invalidated before commit"
                    )
            self.db.engine.resolve_intents(
                self.txn_id, commit_ts, commit=True
            )
        self._finished = True
        metric.TXN_COMMITS.inc()
        for cb in self._commit_hooks:
            cb()
        return commit_ts

    def rollback(self) -> None:
        if self._finished:
            return
        self.db.engine.resolve_intents(self.txn_id, 0, commit=False)
        self._finished = True

    def _check_open(self):
        if self._finished:
            raise TransactionAbortedError("txn already finished")


def _b(x: bytes | str) -> bytes:
    return x.encode() if isinstance(x, str) else bytes(x)


def _record_contention(e: WriteIntentError, waiting_txn: int) -> None:
    """Feed the contention registry (pkg/sql/contention role); never let
    observability break the conflict path."""
    try:
        from .contention import DEFAULT

        DEFAULT.record(e.keys, e.txns, waiting_txn)
    # crlint: allow-broad-except(conflict path must not fail on observability; logged + counted)
    except Exception as rec_err:  # pragma: no cover - registry must not mask errors
        from ..utils import log

        metric.CONTENTION_RECORD_ERRORS.inc()
        log.warning(log.OPS, "contention record failed",
                    error=f"{type(rec_err).__name__}: {rec_err}")


class DB:
    """kv.DB analog: non-transactional ops commit immediately; ``txn`` runs
    a closure with automatic retries."""

    def __init__(self, engine: Engine | None = None,
                 clock: hlc.Clock | None = None, device="cuda"):
        self.engine = engine or Engine(device=device)
        self.clock = clock or hlc.Clock()

    # non-transactional (auto-committed) ops. Like the reference, non-txn
    # requests still sequence through concurrency control: a write under
    # another txn's intent conflicts (WriteIntentError) instead of silently
    # laying a committed version beneath the intent; non-txn reads surface
    # the same WriteIntentError (callers retry after the owner resolves).
    # When kv.batch.coalesce.enabled, concurrent point ops from different
    # sessions merge into one stamped batch (kv/coalesce.py commit train)
    # — gate checked BEFORE any engine lock so riders park lock-free.
    def put(self, key, value) -> int:
        if settings.get("kv.batch.coalesce.enabled"):
            from .coalesce import for_db

            return for_db(self).put(key, value)
        return self._put_solo(_b(key), value)

    def _put_solo(self, key, value) -> int:
        k = _b(key)
        with self.engine.mu:
            self._check_lock(k)
            ts = self.clock.now()
            self.engine.put(k, value, ts=ts)
        return ts

    def delete(self, key) -> int:
        if settings.get("kv.batch.coalesce.enabled"):
            from .coalesce import for_db

            return for_db(self).delete(key)
        return self._delete_solo(_b(key))

    def _delete_solo(self, key) -> int:
        k = _b(key)
        with self.engine.mu:
            self._check_lock(k)
            ts = self.clock.now()
            self.engine.delete(k, ts=ts)
        return ts

    def _check_lock(self, key: bytes) -> None:
        other = self.engine.other_intent(key, 0)
        if other is not None:
            raise WriteIntentError([key], [other])

    def get(self, key, ts: int | None = None) -> bytes | None:
        if settings.get("kv.batch.coalesce.enabled"):
            from .coalesce import for_db

            return for_db(self).get(key, ts)
        return self._get_solo(_b(key), ts)

    def _get_solo(self, key, ts: int | None = None) -> bytes | None:
        return self.engine.get(_b(key), ts=ts if ts is not None
                               else self.clock.now())

    def scan(self, start, end, ts: int | None = None, max_keys=None):
        return self.engine.scan(
            _b(start) if start is not None else None,
            _b(end) if end is not None else None,
            ts=ts if ts is not None else self.clock.now(),
            max_keys=max_keys,
        )

    def new_txn(self) -> Txn:
        return Txn(self, next(_txn_ids), self.clock.now())

    def txn(self, fn, max_retries: int = 16):
        """Run fn(txn) with commit; retry on TransactionRetryError with a
        fresh timestamp (the kv.DB.Txn closure contract: fn must be
        idempotent across retries). Any other error rolls back and
        surfaces."""
        for _ in range(max_retries):
            t = self.new_txn()
            try:
                out = fn(t)
                t.commit()
                return out
            except TransactionRetryError:
                metric.TXN_RETRIES.inc()
                t.rollback()
                continue
            except BaseException:
                # any other error: roll back so the intents don't wedge the
                # keys forever, then surface the error (kv.DB.Txn contract)
                t.rollback()
                raise
        raise TransactionRetryError(f"txn gave up after {max_retries} retries")
