"""Cross-cluster physical replication — the pkg/crosscluster reduction.

The port of ``cockroach_tpu.kv.replication``.

Reference: physical cluster replication streams one cluster's rangefeed
into another, applying KVs at their ORIGINAL MVCC timestamps so the
standby holds a time-travel-consistent copy; a span frontier tracks the
replicated-up-to timestamp, and cutover finalizes the standby at (or
below) that frontier (pkg/crosscluster/physical).

Reduction: ``ReplicationStream`` subscribes to a source cluster's
RangefeedServer in byte-exact (raw) mode over the DCN socket plane and
applies every committed version into the destination engine verbatim —
keys, values, tombstones and timestamps unchanged — so historical reads
on the standby return exactly what the source returned at the same
timestamp. The frontier advances with the source's resolved checkpoints
(which already respect the closed-timestamp discipline: never past an
unresolved intent). ``cutover()`` stops the stream and returns the
frontier: the standby is consistent as of that timestamp.
"""

from __future__ import annotations

import base64
import threading

from .changefeed import subscribe_rangefeed
from .txn import DB


class ReplicationStream:
    """Reconnect discipline: a severed stream re-subscribes from the
    FRONTIER with exponential backoff through the shared retry policy
    (utils/retry.py) instead of dying on the first transport error — the
    reference's rangefeed restarts the same way. Events between the
    frontier and the cut may re-deliver; applies are byte-exact at their
    original (key, ts), so a re-apply lays an identical version and
    reads are unchanged (MVCC idempotence). Only retry exhaustion or a
    non-transport error parks in ``self.error``."""

    def __init__(self, src_addr, dst_db: DB,
                 start: bytes | None = None, end: bytes | None = None,
                 since: int = 0, reconnect_attempts: int = 6):
        self.src_addr = tuple(src_addr)
        self.start = start
        self.end = end
        self.dst = dst_db
        # single writer: only the stream thread updates the frontier;
        # wait_for_frontier and cutover read an int snapshot (racesan's
        # lockset model has no single-writer case, so it is not tracked)
        self.frontier = int(since)
        self.applied = 0
        self.reconnects = 0
        self.reconnect_attempts = int(reconnect_attempts)
        self._stop = threading.Event()
        self._sock, self._frames = subscribe_rangefeed(
            src_addr, start=start, end=end, since=since, raw=True)
        self._thread: threading.Thread | None = None
        # a failed apply must not vanish with the daemon thread: it parks
        # here and re-raises at the next consumer interaction
        self.error: BaseException | None = None

    # -- apply loop ----------------------------------------------------------

    def _apply(self, ev: dict) -> None:
        key = base64.b64decode(ev["k64"])
        ts = int(ev["ts"])
        eng = self.dst.engine
        if ev["v64"] is None:
            eng.delete(key, ts=ts)
        else:
            eng.put(key, base64.b64decode(ev["v64"]), ts=ts)
        # the destination's clock must not issue timestamps below
        # replicated data (reads at now() must see it)
        self.dst.clock.update(ts)
        self.applied += 1

    def _resubscribe(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock, self._frames = subscribe_rangefeed(
            self.src_addr, start=self.start, end=self.end,
            since=self.frontier, raw=True)

    def run(self) -> None:
        """Consume frames until stopped; reconnect through severed
        streams (see class docstring)."""
        from ..utils import metric, retry

        try:
            while not self._stop.is_set():
                for frame in self._frames:
                    if self._stop.is_set():
                        return
                    if "resolved" in frame:
                        # single writer; a stale read only replays
                        self.frontier = max(self.frontier,
                                            int(frame["resolved"]))
                    else:
                        self._apply(frame)
                # the frame iterator ended: cutover closing our socket
                # (clean stop) or the source died mid-stream. Re-dial
                # from the frontier under backoff; exhaustion parks the
                # last transport error for the consumer to see.
                if self._stop.is_set():
                    return
                retry.call(
                    self._resubscribe,
                    retry.Backoff(max_attempts=self.reconnect_attempts,
                                  initial_s=0.05),
                    retryable=retry.is_retryable,
                )
                self.reconnects += 1
                metric.REPLICATION_RECONNECTS.inc()
        except BaseException as e:
            if not self._stop.is_set():
                self.error = e
                raise
            # stopping raced a reconnect attempt: a transport error here
            # is teardown noise, not a stream failure
        finally:
            if self._stop.is_set():
                # a resubscribe may have raced cutover's socket close and
                # opened a fresh connection — never leak it
                try:
                    self._sock.close()
                except OSError:
                    pass

    def run_background(self) -> "ReplicationStream":
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="replication-stream")
        self._thread.start()
        return self

    def wait_for_frontier(self, ts: int, timeout_s: float = 10.0) -> bool:
        import time

        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if self.error is not None:
                raise RuntimeError("replication stream failed") \
                    from self.error
            if self.frontier >= ts:
                return True
            time.sleep(0.01)
        return False

    def cutover(self) -> int:
        """Stop replicating; the standby is consistent as of the returned
        frontier (writes the source commits after this never arrive).
        Raises if the stream died on an apply error — a silent dead
        stream must not masquerade as a successful cutover."""
        self._stop.set()
        try:
            self._sock.close()  # unblocks the frame reader
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.error is not None:
            raise RuntimeError(
                "replication stream failed before cutover"
            ) from self.error
        return self.frontier
