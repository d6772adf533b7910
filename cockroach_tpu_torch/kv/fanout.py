"""Changefeed fan-out plane — bounded subscriber tree with backpressure;
the port of ``cockroach_tpu.kv.fanout``.

Reference: kvserver/rangefeed's processor + BufferedSender design. One
raft-apply stream (here: one hub poll loop over the engine's MVCC
history) demuxes to N registrations, each with its OWN bounded buffer,
so a slow or dead consumer can never wedge the emit path or starve its
peers. The CockroachDB discipline this module reduces:

- **node→changefeed→subscriber accounting**: every buffered event frame
  is charged to a per-subscriber BytesMonitor under the node's
  ``changefeed`` staging account (flow/memory.py's cache-level tree) —
  fan-out memory is visible and bounded, never ambient;
- **backpressure ladder** (the WeChat-style graceful degradation the
  admission plane applies at the SQL front door, applied per-consumer):
  buffer high-water → coalesce duplicate-key events to
  newest-version-per-key → shed the buffer entirely and re-feed the
  subscriber from a catch-up scan at its frontier → evict with a typed
  :class:`~..utils.errors.SlowConsumerError` carrying the frontier;
- **reconnect-from-frontier**: the per-subscriber resolved frontier only
  advances past events already on the wire, so a dropped client that
  re-dials with ``since=frontier`` resumes without loss; events between
  the frontier and the cut may re-deliver and deduplicate by (ts, key)
  — bit-identical to a direct ``changes_between`` scan after dedup;
- **liveness**: sends carry a deadline and idle connections heartbeat a
  resolved checkpoint, so a dead socket is detected within
  heartbeat + deadline and its sender thread reaped — never leaked.

Eviction never blocks the emit path: the poll loop only flags the
subscriber, drops its buffered (not in-flight) bytes and, for wedged
sockets, shuts the fd down — the sender thread observes the flag,
best-effort delivers a final ``{"error": "slow_consumer", "frontier"}``
frame, and cleans up after itself.

Same-process consumers (the materialized-view maintainer,
flow/viewmaint.py) register a :class:`LocalSubscriber` instead: no
socket and no sender thread, the poll loop buffers RAW ``(ts, key,
value|None)`` tuples under the same monitor accounting and backpressure
ladder, and the consumer drains with a ``peek()``/``ack()`` two-phase
protocol so a consumer that crashes mid-apply re-reads the identical
delta — the reconnect-from-frontier discipline without a wire.

The poll loop's scan (``changefeed._scan``) is device work where the
engine lives; it takes ``flow/dispatch.exec_lock`` and then the engine
mutex, the query path's order, and never the hub's state lock.
"""

from __future__ import annotations

import bisect
import itertools
import json
import threading
import time
import weakref

from ..flow import memory as flowmem
from ..flow.dcn import _LEN, _send_msg
from ..utils import faults, locks, log, metric, racesan, settings
from ..utils.errors import SlowConsumerError

def _send_frames(conn, payloads: list) -> None:
    """Several frames in one send: the bytes of one ``_send_msg`` per
    payload, in order, for one system call (a sender thread delivers a
    whole batch under one deadline)."""
    conn.sendall(b"".join(_LEN.pack(len(p)) + p for p in payloads))


# states of one registration in the tree
LIVE = "live"          # events flow through the bounded buffer
CATCHUP = "catchup"    # buffer was shed; next sender pass rescans the
                       # engine from the frontier instead
EVICTED = "evicted"    # terminal: SlowConsumerError recorded


class Subscriber:
    """One registration in the fan-out tree. All mutable state shared
    between the hub poll loop and this subscriber's sender thread is
    guarded by the hub's ``kv.fanout.state`` lock; the frontier and the
    hub's subscriber map are additionally racesan-instrumented."""

    def __init__(self, hub: "FanoutHub", sub_id: int, conn,
                 start: bytes | None, end: bytes | None, since: int,
                 raw: bool, on_close=None):
        self.hub = hub
        self.id = sub_id
        self.conn = conn
        self.start = start
        self.end = end
        self.raw = raw
        # frontier: the last resolved timestamp CHECKPOINTED to the
        # client — its exact reconnect point. Written by the sender,
        # read by the reaper/vtable, always under the hub state lock.
        self.frontier = int(since)
        # enq_frontier: span-local resolved timestamp up to which events
        # are either in the buffer (live) or recoverable by an engine
        # scan from `frontier` (catchup). Never advances past an
        # unresolved intent in the span.
        self.enq_frontier = int(since)
        self.state = CATCHUP  # first sender pass serves the catch-up scan
        self.evict_error: SlowConsumerError | None = None
        self.buf: list = []       # [(ts, key, payload, nbytes, t_enq)]
        self.queued_bytes = 0     # bytes in self.buf
        self.inflight_bytes = 0   # bytes taken by the sender, not yet sent
        self.sheds_run = 0        # consecutive sheds without a full drain
        self.sent_events = 0
        self.coalesced = 0
        self.sheds = 0
        self.created_s = time.time()
        self.last_send_s = time.time()
        self.wake = threading.Event()
        self.on_close = on_close
        self.thread: threading.Thread | None = None
        self.mon = hub.mon.child(
            f"subscriber-{sub_id}",
            budget=int(settings.get("changefeed.fanout.buffer_bytes")),
            level="cache")

    def _in_span(self, key: bytes) -> bool:
        if self.start is not None and key < self.start:
            return False
        if self.end is not None and key >= self.end:
            return False
        return True

    # -- sender thread --------------------------------------------------

    def _run(self):
        hub = self.hub
        try:
            self.conn.settimeout(
                float(settings.get("changefeed.fanout.send_deadline_s")))
            while True:
                self.wake.wait(timeout=float(
                    settings.get("changefeed.fanout.heartbeat_s")))
                self.wake.clear()
                with hub._mu:
                    if self.state == EVICTED or hub._stop.is_set():
                        break
                    scan_lo = scan_hi = None
                    if self.state == CATCHUP:
                        racesan.note_read(self, "frontier")
                        scan_lo, scan_hi = self.frontier, self.enq_frontier
                        self.state = LIVE
                    batch, self.buf = self.buf, []
                    self.inflight_bytes += self.queued_bytes
                    self.queued_bytes = 0
                    resolved = self.enq_frontier
                if scan_hi is not None and scan_hi > scan_lo:
                    actual = self._send_catchup(scan_lo, scan_hi)
                    if actual < scan_hi:
                        # defensive: the rescan saw an intent below the
                        # watermark — pull the watermark back so the poll
                        # loop re-delivers rather than skips
                        with hub._mu:
                            self.enq_frontier = min(self.enq_frontier,
                                                    actual)
                        resolved = min(resolved, actual)
                self._send_batch(batch)
                self._maybe_checkpoint(resolved)
                with hub._mu:
                    if not self.buf and self.state == LIVE:
                        self.sheds_run = 0  # fully drained: ladder resets
        except OSError as e:
            # covers real socket errors, send-deadline timeouts, and
            # injected ConnectionError faults alike
            with hub._mu:
                hub._evict_locked(self, f"send failed: {e}")
        finally:
            err = self.evict_error
            if err is not None:
                # best-effort typed goodbye: a still-healthy-but-slow
                # consumer learns its exact resume point
                try:
                    self.conn.settimeout(1.0)
                    _send_msg(self.conn, json.dumps({
                        "error": "slow_consumer", "reason": err.reason,
                        "frontier": err.frontier}).encode("utf-8"))
                except OSError:
                    pass  # peer already gone; reconnect resumes anyway
            try:
                self.conn.close()
            except OSError:
                pass  # already severed by the reaper
            self.mon.close()  # releases any straggler bytes up the tree
            hub._remove(self)
            if self.on_close is not None:
                self.on_close()

    def _send_catchup(self, lo: int, hi: int) -> int:
        """Re-feed (lo, hi] from the engine — the shed consumer's path
        back to live. Returns the scan's actual resolved timestamp."""
        from .changefeed import changes_between

        events, resolved = changes_between(
            self.hub.db, lo, hi, self.start, self.end, raw=self.raw)
        if not events:
            return resolved
        payloads = [json.dumps(ev).encode("utf-8") for ev in events]
        total = sum(len(p) for p in payloads)
        # the rescan trades buffer residency for a transiently
        # re-materialized batch: charge it for the send's lifetime
        with flowmem.staged("changefeed", total):
            faults.fire("changefeed.subscriber.send")
            _send_frames(self.conn, payloads)
        metric.CHANGEFEED_EVENTS_EMITTED.inc(len(payloads))
        with self.hub._mu:
            self.sent_events += len(payloads)
            self.last_send_s = time.time()
        return resolved

    def _send_batch(self, batch: list) -> None:
        if not batch:
            return
        total = sum(e[3] for e in batch)
        try:
            faults.fire("changefeed.subscriber.send")
            _send_frames(self.conn, [e[2] for e in batch])
            done = time.monotonic()
            metric.CHANGEFEED_SEND_LAG_SECONDS.observe_many(
                [max(0.0, done - e[4]) for e in batch])
            metric.CHANGEFEED_EVENTS_EMITTED.inc(len(batch))
            with self.hub._mu:
                self.sent_events += len(batch)
                self.last_send_s = time.time()
        finally:
            # exact accounting even when a send dies mid-batch: the
            # in-flight reservation is returned either way
            with self.hub._mu:
                self.inflight_bytes -= total
            self.mon.release(total)

    def _maybe_checkpoint(self, resolved: int) -> None:
        with self.hub._mu:
            racesan.note_read(self, "frontier")
            fr = self.frontier
            last = self.last_send_s
        hb = float(settings.get("changefeed.fanout.heartbeat_s"))
        if resolved <= fr and time.time() - last < hb:
            return
        faults.fire("changefeed.frontier.checkpoint")
        _send_msg(self.conn, json.dumps(
            {"resolved": max(resolved, fr)}).encode("utf-8"))
        with self.hub._mu:
            racesan.note_write(self, "frontier")
            self.frontier = max(resolved, fr)
            self.last_send_s = time.time()


class LocalSubscriber(Subscriber):
    """An in-process registration: no socket, no sender thread. The poll
    loop buffers raw ``(ts, key, value|None, nbytes, t_enq)`` tuples
    (monitor-charged like any frame) and the consumer drains them with
    :meth:`peek` / :meth:`ack` — two-phase so nothing is consumed until
    the consumer has durably applied it. Joins in CATCHUP like a socket
    subscriber: the first drain is the consumer's own engine scan from
    its frontier, after which the buffer takes over."""

    def __init__(self, hub: "FanoutHub", sub_id: int,
                 start: bytes | None, end: bytes | None, since: int):
        super().__init__(hub, sub_id, conn=None, start=start, end=end,
                         since=since, raw=True)

    def peek(self) -> tuple[list | None, int, float | None]:
        """Snapshot the buffered delta WITHOUT consuming it.

        Returns ``(events, resolved, oldest)`` where events is a list of
        ``(ts, key, value|None)`` in (ts, key) order, resolved is the
        span-local watermark they run up to, and oldest is the earliest
        buffered enqueue wall-time (monotonic) — the consumer's freshness
        lag anchor — or None when the buffer is empty. ``events is None``
        means the buffer was shed (or never primed): the engine holds the
        data, scan ``(frontier, resolved]`` yourself, then :meth:`ack`.
        """
        with self.hub._mu:
            racesan.note_read(self, "frontier")
            resolved = int(self.enq_frontier)
            if self.state == LIVE:
                oldest = self.buf[0][4] if self.buf else None
                return ([(e[0], e[1], e[2]) for e in self.buf],
                        resolved, oldest)
            return None, resolved, None

    def ack(self, upto: int) -> None:
        """Consume through ``upto`` after the delta has been applied.
        Buffered events at or below ``upto`` drop (bytes released); a
        shed/evicted registration rejoins LIVE with its watermark pulled
        back to exactly ``upto`` so the poll loop re-delivers everything
        past what was actually applied — never a gap."""
        with self.hub._mu:
            racesan.note_write(self, "frontier")
            self.frontier = max(self.frontier, int(upto))
            if self.state == LIVE:
                keep = [e for e in self.buf if e[0] > upto]
                kept_bytes = sum(e[3] for e in keep)
                released = self.queued_bytes - kept_bytes
                if released > 0:
                    self.mon.release(released)
                self.buf = keep
                self.queued_bytes = kept_bytes
            else:
                self.state = LIVE
                self.evict_error = None
                self.enq_frontier = int(upto)
            self.sheds_run = 0
            self.last_send_s = time.time()

    def close(self) -> None:
        """Deregister: drop buffered bytes, close the monitor, leave the
        tree. The senderless analog of the sender thread's finally."""
        with self.hub._mu:
            self.state = EVICTED
            self.mon.release(self.queued_bytes)
            self.buf = []
            self.queued_bytes = 0
        self.mon.close()
        self.hub._remove(self)


class FanoutHub:
    """The subscriber tree: ONE poll loop over the engine demuxes
    committed versions to every registration; per-subscriber sender
    threads drain the bounded buffers. See the module docstring for the
    backpressure ladder and eviction semantics."""

    def __init__(self, db, poll_interval_s: float = 0.05,
                 name: str = "rangefeed", device="cuda"):
        from .changefeed import check_device

        check_device(db, device)
        self.db = db
        self.name = name
        self.poll_interval_s = poll_interval_s
        self.mon = flowmem.staging_monitor("changefeed")
        # hub frontier: GLOBAL resolved timestamp (below every unresolved
        # intent anywhere) — the join watermark for new subscribers
        self.frontier = 0
        self._subs: dict[int, Subscriber] = {}
        self._ids = itertools.count(1)
        self._mu = locks.lock("kv.fanout.state")
        self._stop = threading.Event()
        with _hubs_mu:
            _HUBS.add(self)
        self._poller = threading.Thread(target=self._poll_loop,
                                        name="fanout-poller", daemon=True)
        self._poller.start()

    # -- registration ----------------------------------------------------

    def add_subscriber(self, conn, start: bytes | None = None,
                       end: bytes | None = None, since: int = 0,
                       raw: bool = False, on_close=None,
                       start_sender: bool = True) -> Subscriber | None:
        """Register a connection in the tree; returns None when the tree
        is at ``changefeed.fanout.max_subscribers`` (bounded: refuse the
        newcomer rather than degrade everyone) or the hub is closing.
        ``start_sender=False`` is a test seam: the registration exists
        but nothing drains it."""
        with self._mu:
            racesan.note_read(self, "_subs")
            limit = int(settings.get("changefeed.fanout.max_subscribers"))
            if self._stop.is_set() or len(self._subs) >= limit:
                return None
            sub = Subscriber(self, next(self._ids), conn, start, end,
                             since, raw, on_close=on_close)
            # join at the hub frontier: the catch-up scan covers
            # (since, frontier]; the poll loop covers everything after
            racesan.note_read(self, "frontier")
            sub.enq_frontier = max(sub.enq_frontier, self.frontier)
            racesan.note_write(self, "_subs")
            self._subs[sub.id] = sub
            metric.CHANGEFEED_SUBSCRIBERS.set(len(self._subs))
        if start_sender:
            t = threading.Thread(target=sub._run, daemon=True,
                                 name=f"fanout-sender-{sub.id}")
            sub.thread = t
            t.start()
        sub.wake.set()  # serve the catch-up scan promptly
        return sub

    def add_local(self, start: bytes | None = None,
                  end: bytes | None = None,
                  since: int = 0) -> LocalSubscriber | None:
        """Register an in-process consumer (no socket, no sender). Same
        admission bound as wire subscribers; None when full/closing."""
        with self._mu:
            racesan.note_read(self, "_subs")
            limit = int(settings.get("changefeed.fanout.max_subscribers"))
            if self._stop.is_set() or len(self._subs) >= limit:
                return None
            sub = LocalSubscriber(self, next(self._ids), start, end, since)
            racesan.note_read(self, "frontier")
            sub.enq_frontier = max(sub.enq_frontier, self.frontier)
            racesan.note_write(self, "_subs")
            self._subs[sub.id] = sub
            metric.CHANGEFEED_SUBSCRIBERS.set(len(self._subs))
        return sub

    def _remove(self, sub: Subscriber) -> None:
        with self._mu:
            racesan.note_write(self, "_subs")
            self._subs.pop(sub.id, None)
            metric.CHANGEFEED_SUBSCRIBERS.set(len(self._subs))

    # -- the emit path ---------------------------------------------------

    def _poll_loop(self):
        while not self._stop.is_set():
            try:
                self._poll_once()
            except Exception as e:
                # one bad poll must not kill every subscriber: logged,
                # and the next poll scans from the same watermarks
                log.warning(log.OPS, "fanout poll failed", error=str(e))
            self._stop.wait(self.poll_interval_s)

    def _poll_once(self):
        from .changefeed import _scan, encode_event

        with self._mu:
            racesan.note_read(self, "_subs")
            subs = [s for s in self._subs.values() if s.state != EVICTED]
            # a live registration takes versions past its own watermark
            # and one in catch-up takes none (its sender rescans), so the
            # scan starts at the lowest live watermark (the reference
            # starts at the hub frontier too, 0 until the first poll: a
            # whole-history scan while a consumer primes itself)
            lo = min((s.enq_frontier for s in subs if s.state == LIVE),
                     default=None)
        if not subs:
            return  # idle hub: don't scan, don't advance the frontier
        now = self.db.clock.now()
        versions, intents = _scan(self.db, now if lo is None else lo, now)
        g_resolved = int(now)
        for its, _ikey in intents:
            g_resolved = min(g_resolved, int(its) - 1)
        ts_order = [v[0] for v in versions]  # sorted by (ts, key)
        enc_cache: dict[tuple[int, bool], bytes] = {}
        t_enq = time.monotonic()
        deadline = float(settings.get("changefeed.fanout.send_deadline_s"))
        tnow = time.time()
        wake: list[Subscriber] = []
        dead: list[Subscriber] = []
        with self._mu:
            racesan.note_write(self, "frontier")
            self.frontier = max(self.frontier, g_resolved)
            for sub in subs:
                if sub.state == EVICTED:
                    continue
                # span-local resolved: only intents INSIDE the span hold
                # this subscriber's frontier back
                sub_resolved = int(now)
                for its, ikey in intents:
                    if sub._in_span(ikey):
                        sub_resolved = min(sub_resolved, int(its) - 1)
                sub_resolved = max(sub_resolved, sub.enq_frontier)
                if sub.state == CATCHUP:
                    # shed subscriber: the engine holds its data — just
                    # advance the watermark the rescan will cover
                    sub.enq_frontier = sub_resolved
                    wake.append(sub)
                    continue
                batch = []
                i = bisect.bisect_right(ts_order, sub.enq_frontier)
                j = bisect.bisect_right(ts_order, sub_resolved)
                spanned = sub.start is not None or sub.end is not None
                for k in range(i, j):
                    ts, key, _val = versions[k]
                    if spanned and not sub._in_span(key):
                        continue
                    if sub.conn is None:
                        # local consumer: raw tuple, no JSON frame; the
                        # charge approximates the buffered tuple footprint
                        val = versions[k][2]
                        nb = (len(key) + (0 if val is None else len(val))
                              + 48)
                        batch.append((ts, key, val, nb, t_enq))
                        continue
                    ck = (k, sub.raw)
                    payload = enc_cache.get(ck)
                    if payload is None:
                        ev = encode_event(ts, key, versions[k][2], sub.raw)
                        payload = json.dumps(ev).encode("utf-8")
                        enc_cache[ck] = payload
                    batch.append((ts, key, payload, len(payload), t_enq))
                advanced = sub_resolved > sub.enq_frontier
                sub.enq_frontier = sub_resolved
                if batch:
                    self._enqueue_locked(sub, batch)
                if batch or advanced:
                    wake.append(sub)
            # liveness reaper: pending-or-idle makes no difference — a
            # healthy sender heartbeats, so a stale last_send means a
            # dead socket or a wedged consumer
            for sub in subs:
                if sub.state == EVICTED or sub.conn is None:
                    # local consumers have no socket to go dead; their
                    # ladder ends at shed->catch-up, never the reaper
                    continue
                racesan.note_read(sub, "frontier")
                if tnow - sub.last_send_s > deadline:
                    self._evict_locked(
                        sub, f"no successful send in {deadline:.1f}s")
                    dead.append(sub)
        for sub in dead:
            # unstick a sender blocked inside send(): shutdown is
            # non-blocking, the blocked call returns with an error
            try:
                import socket as _socket
                sub.conn.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass  # already closed
        for sub in wake:
            sub.wake.set()
        metric.CHANGEFEED_BUFFER_BYTES.set(self.mon.used)

    # the backpressure ladder (all rungs run under self._mu; none of them
    # touches the subscriber's socket — eviction never blocks the emit path)

    def _enqueue_locked(self, sub: Subscriber, batch: list) -> None:
        try:
            faults.fire("changefeed.fanout.enqueue")
        except faults.InjectedFault:
            # the batch never reached the buffer: shed so the rescan
            # re-covers it from the engine — no gap, no leaked bytes
            self._shed_locked(sub)
            return
        budget = int(settings.get("changefeed.fanout.buffer_bytes"))
        high = budget * float(
            settings.get("changefeed.fanout.highwater_frac"))
        incoming = sum(e[3] for e in batch)
        if sub.queued_bytes + sub.inflight_bytes + incoming > high:
            batch = self._coalesce_locked(sub, batch)
            incoming = 0  # batch absorbed into the coalesced queue
        if sub.queued_bytes + sub.inflight_bytes + incoming > budget:
            max_sheds = int(
                settings.get("changefeed.fanout.max_consecutive_sheds"))
            if sub.sheds_run >= max_sheds:
                self._evict_locked(
                    sub, f"{sub.sheds_run} consecutive sheds "
                         "without draining")
            else:
                self._shed_locked(sub)
            return
        if batch:
            sub.buf.extend(batch)
            sub.queued_bytes += incoming
            # force=True: the ladder is the bound; accounting must never
            # raise inside the emit path
            sub.mon.reserve(incoming, force=True)

    def _coalesce_locked(self, sub: Subscriber, batch: list) -> list:
        """Rung one: newest-version-per-key over queue + incoming batch.
        The subscriber still observes the latest value of every key (and
        every checkpoint); superseded intermediate versions drop."""
        combined = sub.buf + batch
        seen: set[bytes] = set()
        kept: list = []
        for e in reversed(combined):
            if e[1] in seen:
                continue
            seen.add(e[1])
            kept.append(e)
        kept.reverse()
        dropped = len(combined) - len(kept)
        if dropped:
            sub.coalesced += dropped
            metric.CHANGEFEED_EVENTS_COALESCED.inc(dropped)
        kept_bytes = sum(e[3] for e in kept)
        delta = kept_bytes - sub.queued_bytes
        if delta > 0:
            sub.mon.reserve(delta, force=True)
        elif delta < 0:
            sub.mon.release(-delta)
        sub.buf = kept
        sub.queued_bytes = kept_bytes
        return []

    def _shed_locked(self, sub: Subscriber) -> None:
        """Rung two: drop the buffer, re-feed from the engine. The
        client re-receives events since its last checkpoint (dedup by
        (ts, key)) — never a gap."""
        sub.mon.release(sub.queued_bytes)
        sub.buf = []
        sub.queued_bytes = 0
        sub.state = CATCHUP
        sub.sheds += 1
        sub.sheds_run += 1
        metric.CHANGEFEED_SHEDS.inc()

    def _evict_locked(self, sub: Subscriber, reason: str) -> None:
        """Terminal rung: typed eviction. Only flags + drops queued
        bytes — the sender thread does the socket goodbye and cleanup."""
        if sub.state == EVICTED:
            return
        racesan.note_read(sub, "frontier")
        sub.evict_error = SlowConsumerError(sub.id, reason,
                                            frontier=sub.frontier)
        sub.state = EVICTED
        sub.mon.release(sub.queued_bytes)
        sub.buf = []
        sub.queued_bytes = 0
        metric.CHANGEFEED_EVICTIONS.inc()
        sub.wake.set()

    # -- introspection / shutdown ---------------------------------------

    def rows(self) -> list[dict]:
        """Snapshot of every registration (vtable / admin endpoint)."""
        out = []
        tnow = time.time()
        with self._mu:
            racesan.note_read(self, "_subs")
            for sub in self._subs.values():
                racesan.note_read(sub, "frontier")
                out.append({
                    "hub": self.name,
                    "subscriber_id": sub.id,
                    "state": sub.state,
                    "span_start": (sub.start or b"").decode("utf-8",
                                                            "replace"),
                    "span_end": (sub.end or b"").decode("utf-8",
                                                        "replace"),
                    "frontier": int(sub.frontier),
                    "buffered_bytes": int(sub.queued_bytes
                                          + sub.inflight_bytes),
                    "buffered_events": len(sub.buf),
                    "sent_events": int(sub.sent_events),
                    "coalesced": int(sub.coalesced),
                    "sheds": int(sub.sheds),
                    "age_s": tnow - sub.created_s,
                })
        return out

    def close(self) -> None:
        """Stop the poll loop, sever every subscriber, join the sender
        threads — after this the no-leak census sees neither threads nor
        sockets nor retained monitor bytes."""
        import socket as _socket

        self._stop.set()
        if self._poller is not threading.current_thread():
            self._poller.join(timeout=5)
        with self._mu:
            racesan.note_read(self, "_subs")
            subs = list(self._subs.values())
        for sub in subs:
            sub.wake.set()
            if sub.conn is None:
                continue  # local registration: no socket to sever
            try:
                sub.conn.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass  # never connected or already gone
        for sub in subs:
            t = sub.thread
            if t is not None and t is not threading.current_thread():
                t.join(timeout=5)
            else:
                # test-seam registration without a sender: clean up here
                sub.mon.close()
                self._remove(sub)
        with _hubs_mu:
            _HUBS.discard(self)


# -- process-global hub registry (vtable / admin endpoint / gauges) ---------

_hubs_mu = locks.lock("kv.fanout.hubs")
_HUBS: "weakref.WeakSet[FanoutHub]" = weakref.WeakSet()


def hubs() -> list[FanoutHub]:
    with _hubs_mu:
        return [h for h in _HUBS if not h._stop.is_set()]


def subscriber_rows() -> list[dict]:
    """All registrations across every live hub on this node."""
    out: list[dict] = []
    for h in hubs():
        out.extend(h.rows())
    return out


def refresh_gauges() -> None:
    """Re-publish fan-out gauges (the background metrics scraper calls
    this so a quiet node still exports truthful values)."""
    total = 0
    for h in hubs():
        with h._mu:
            racesan.note_read(h, "_subs")
            total += len(h._subs)
    metric.CHANGEFEED_SUBSCRIBERS.set(total)
    metric.CHANGEFEED_BUFFER_BYTES.set(
        flowmem.staging_monitor("changefeed").used)
