"""Retry/backoff/deadline discipline — the util/retry.Options analog.

The port of ``cockroach_tpu.utils.retry``.

Reference: CockroachDB wraps every network-facing loop in
pkg/util/retry (retry.go:30 Options{InitialBackoff, MaxBackoff,
Multiplier, MaxRetries} driving an exponential-with-jitter iterator);
DistSender leans on it to re-send batches past transient send errors
(kvcoord/dist_sender.go), and the breaker's cooldown turns a fast-fail
peer back into a retryable target. The discipline here is the same,
reduced:

- ``Backoff``: deterministic-given-rng exponential backoff with jitter
  and an optional overall deadline (monotonic clock).
- ``is_retryable``: the one shared classification of transient vs hard
  errors. WriteIntentError (retry after the writer finishes), socket
  timeouts and connection drops (re-dial and re-send), and
  BreakerOpenError (retryable only AFTER the breaker's cooldown — the
  caller backs off long enough for the half-open probe window) are
  transient; everything else is a hard error and must surface.
- ``call``: run a callable under that policy, re-raising the last error
  when attempts or the deadline run out.
"""

from __future__ import annotations

import random
import socket
import time

from . import locks


class RPCDeadlineError(ConnectionError):
    """A single RPC exceeded its deadline (DeadlineExceeded analog).
    Subclasses ConnectionError: a timed-out send leaves the stream in an
    unknown framing state, so callers must re-dial like a drop."""


class Backoff:
    """Exponential backoff with jitter + optional overall deadline.

    attempts() yields attempt indices, sleeping between them; it stops
    yielding when max_attempts or the deadline is exhausted. Durations
    use the monotonic clock. `rng` makes the jitter deterministic for
    tests (the chaos harness seeds it)."""

    def __init__(self, max_attempts: int = 4, initial_s: float = 0.01,
                 multiplier: float = 2.0, max_backoff_s: float = 1.0,
                 jitter: float = 0.25, deadline_s: float | None = None,
                 rng: random.Random | None = None):
        assert max_attempts >= 1
        self.max_attempts = max_attempts
        self.initial_s = initial_s
        self.multiplier = multiplier
        self.max_backoff_s = max_backoff_s
        self.jitter = jitter
        self.deadline_s = deadline_s
        self.rng = rng if rng is not None else random

    def attempts(self):
        start = time.monotonic()
        pause = self.initial_s
        for i in range(self.max_attempts):
            yield i
            if i == self.max_attempts - 1:
                return
            if self.deadline_s is not None and (
                    time.monotonic() - start + pause > self.deadline_s):
                return
            # jitter spreads synchronized retriers (retry.go's Mult+jitter)
            frac = 1.0 + self.jitter * (2.0 * self.rng.random() - 1.0)
            time.sleep(pause * frac)
            pause = min(pause * self.multiplier, self.max_backoff_s)


def is_retryable(e: BaseException) -> bool:
    """Shared transient-vs-hard classification for the distributed plane."""
    from ..kv.dialer import BreakerOpenError
    from ..storage.lsm import WriteIntentError

    if isinstance(e, WriteIntentError):
        return True  # the writer will commit/abort; wait and re-read
    if isinstance(e, (socket.timeout, TimeoutError, RPCDeadlineError)):
        return True  # deadline: re-dial (stream framing state unknown)
    if isinstance(e, (ConnectionError, BrokenPipeError)):
        return True  # drop: re-dial and re-send
    if isinstance(e, OSError):
        return True  # refused/reset during (re)connect of a restarting peer
    if isinstance(e, BreakerOpenError):
        # retryable-after-cooldown: the backoff must outlast the breaker's
        # cooldown for the half-open probe to be admitted
        return True
    return False


class RetryBudgetExhausted(RuntimeError):
    """A range's retry budget ran dry — the caller must degrade (or
    surface the last transport error) instead of hammering the range.
    Deliberately NOT a ConnectionError: an exhausted budget is a hard
    stop, never itself retried."""

    def __init__(self, range_id: int, spent: int):
        super().__init__(
            f"retry budget exhausted for r{range_id} after {spent} retries")
        self.range_id = range_id
        self.spent = spent


class RangeRetryBudget:
    """Per-range retry accounting (moves the budget off the client).

    Reference: kvcoord tracks send failures per range/replica rather than
    per client, so one hot range cannot starve every other range's
    retries and a single range's flapping is visible in metrics. Each
    range gets `budget` retry tokens refilled at `refill_per_s`; spending
    past zero raises RetryBudgetExhausted and bumps
    `rpc_retry_budget_exhausted`. Every spend is attributed to the range
    in the `rpc_retries_by_range` labeled counter."""

    def __init__(self, budget: float = 16.0, refill_per_s: float = 4.0):
        self.budget = float(budget)
        self.refill_per_s = float(refill_per_s)
        self._tokens: dict[int, float] = {}
        self._stamp: dict[int, float] = {}
        self._lock = locks.lock("retry.budget")

    def _refill(self, range_id: int, now: float) -> float:
        tokens = self._tokens.get(range_id, self.budget)
        last = self._stamp.get(range_id, now)
        tokens = min(self.budget, tokens + (now - last) * self.refill_per_s)
        self._stamp[range_id] = now
        return tokens

    def spend(self, range_id: int) -> None:
        """Account one retry against the range. Raises when dry."""
        from . import metric

        with self._lock:
            now = time.monotonic()
            tokens = self._refill(range_id, now)
            if tokens < 1.0:
                metric.RPC_RETRY_BUDGET_EXHAUSTED.inc()
                spent = int(self.budget)
                self._tokens[range_id] = tokens
                raise RetryBudgetExhausted(range_id, spent)
            self._tokens[range_id] = tokens - 1.0
        metric.RPC_RETRIES_BY_RANGE.inc(range_id)

    def remaining(self, range_id: int) -> float:
        with self._lock:
            return self._refill(range_id, time.monotonic())


def call(fn, policy: Backoff | None = None, retryable=is_retryable,
         on_retry=None):
    """Run fn() under the retry policy. Transient errors (per `retryable`)
    retry with backoff; hard errors and exhaustion re-raise."""
    from . import metric

    policy = policy if policy is not None else Backoff()
    last: BaseException | None = None
    for attempt in policy.attempts():
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - classified below
            if not retryable(e):
                raise
            last = e
            metric.RPC_RETRIES.inc()
            if on_retry is not None:
                on_retry(attempt, e)
    assert last is not None
    raise last
