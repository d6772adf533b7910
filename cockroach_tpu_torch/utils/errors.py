"""Query error boundary — the colexecerror analog; the port of the part of
``cockroach_tpu.utils.errors`` that the distributed runner, SQL
admission, the changefeed fan-out plane and the liveness and tenant
status reads need.

Reference: pkg/sql/colexecerror/error.go:45 CatchVectorizedRuntimeError
converts engine panics into SQL errors at the flow boundary. Here the
boundary wraps the distributed runner: any failure below it surfaces as a
typed QueryError naming the failing stage, while expected errors (an
intent conflict, a transaction retry) pass through untouched.
"""

from __future__ import annotations

import functools


class QueryError(Exception):
    """A query failed inside the execution engine. str() is user-facing;
    __cause__ keeps the original exception."""

    def __init__(self, stage: str, cause: BaseException):
        self.stage = stage
        super().__init__(
            f"query execution failed in {stage}: "
            f"{type(cause).__name__}: {cause}"
        )


# exception types that are not engine failures and cross the boundary
# unwrapped
_PASSTHROUGH: tuple[type, ...] = (QueryError, KeyboardInterrupt, SystemExit)


def register_passthrough(exc_type: type) -> None:
    """Let a domain exception (e.g. storage.lsm.WriteIntentError) cross the
    boundary unwrapped — the analog of colexecerror.ExpectedError."""
    global _PASSTHROUGH
    if exc_type not in _PASSTHROUGH:
        _PASSTHROUGH = _PASSTHROUGH + (exc_type,)


def query_boundary(stage: str):
    """Decorator: wrap engine failures in QueryError (panic -> error)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except _PASSTHROUGH:
                raise
            except Exception as e:
                raise QueryError(stage, e) from e
        return wrapped

    return deco


class AdmissionRejectedError(Exception):
    """A statement was refused admission: the wait queue at
    admission.sql.max_queue_depth, the tenant's token bucket empty, the
    node shedding this priority lane, or the queue-wait deadline run out.
    SQLSTATE 53300 at the pgwire boundary; ``retry_after_s`` is the hint
    clients back off by."""

    def __init__(self, reason: str, retry_after_s: float = 0.0,
                 tenant_id: int | None = None):
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.tenant_id = tenant_id
        msg = f"admission rejected: {reason}"
        if retry_after_s > 0:
            msg += f" (retry after {retry_after_s:.3f}s)"
        super().__init__(msg)


class SlowConsumerError(Exception):
    """A changefeed subscriber fell too far behind and was evicted from
    the fan-out plane (kvserver/rangefeed's BufferedSender eviction: the
    processor never blocks raft apply on one stuck registration). The
    error carries the subscriber's last durably-delivered resolved
    timestamp — ``frontier`` — which is the exact ``since`` a reconnect
    must present to resume without loss; events after the frontier may
    re-deliver and are deduplicated by (ts, key)."""

    def __init__(self, subscriber_id: int, reason: str, frontier: int = 0):
        self.subscriber_id = subscriber_id
        self.reason = reason
        self.frontier = frontier
        super().__init__(
            f"slow consumer {subscriber_id} evicted ({reason}); "
            f"reconnect with since={frontier}")


def retry_past_intents(fn, deadline_s: float = 0.5):
    """Run a status-level read, retrying briefly past WriteIntentError:
    background loops (heartbeats, jobs adoption) commit constantly, and a
    status probe (an is_live check, a tenant listing) must never fail just
    because a txn was mid-commit. Raises the final WriteIntentError if the
    intent outlives the deadline (a wedged writer)."""
    import time

    from ..storage.lsm import WriteIntentError

    deadline = time.time() + deadline_s
    while True:
        try:
            return fn()
        except WriteIntentError:
            if time.time() >= deadline:
                raise
            time.sleep(0.005)
