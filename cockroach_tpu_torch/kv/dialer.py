"""Node dialer — the rpc/nodedialer reduction.

The port of ``cockroach_tpu.kv.dialer``.

Reference: nodedialer resolves a NodeID to an address (via gossip's
node-descriptor entries) and hands out cached gRPC connections; callers
never manage addresses themselves (pkg/rpc/nodedialer).

Reduction: nodes advertise their KV Batch RPC address into gossip under
``node/<id>/kv`` (Node.start does this when both gossip and the kv
endpoint are up); ``NodeDialer.dial(node_id)`` resolves through the
LOCAL infostore and returns a cached BatchClient, re-dialing after a
connection failure or an address change (a restarted node re-advertises
a new port)."""

from __future__ import annotations

import time

from ..utils import locks, racesan
from .rpc import BatchClient

_KEY = "node/%d/kv"


class BreakerOpenError(Exception):
    """Fast-fail: the peer's circuit breaker is open (recent failures);
    callers route around it instead of timing out on every attempt."""


class _Breaker:
    """Per-peer circuit breaker (rpc/peer.go + dist_sender_circuit_
    breaker.go reduction): `trip_threshold` consecutive reported RPC
    failures open the breaker for `cooldown_s`; after the cooldown
    exactly ONE caller is admitted as the half-open probe. ONLY
    report_ok()/report_failure() move the failure state — a successful
    TCP connect proves nothing (a wedged peer can accept connections and
    fail every RPC), so dialing never closes the breaker by itself.
    Durations use the monotonic clock (wall steps must not extend or
    collapse cooldowns)."""

    def __init__(self, trip_threshold: int = 3, cooldown_s: float = 5.0):
        self.trip_threshold = trip_threshold
        self.cooldown_s = cooldown_s
        self.failures = 0
        self.opened_at: float | None = None
        self.probing = False
        self.probe_started = 0.0

    def admit(self) -> None:
        if self.opened_at is None:
            return
        since = time.monotonic() - self.opened_at
        if since < self.cooldown_s:
            raise BreakerOpenError(
                f"breaker open ({self.failures} failures, retry in "
                f"{self.cooldown_s - since:.1f}s)"
            )
        if self.probing:
            # a probe whose caller never reported back must not wedge the
            # breaker forever: after 2x cooldown the slot re-opens
            if time.monotonic() - self.probe_started < 2 * self.cooldown_s:
                raise BreakerOpenError("breaker half-open: probe in flight")
        self.probing = True  # this caller IS the probe
        self.probe_started = time.monotonic()

    def probe_aborted(self) -> None:
        """The admitted probe's dial itself failed: free the half-open
        slot (the caller reports the failure separately)."""
        self.probing = False

    def ok(self) -> None:
        self.failures = 0
        self.opened_at = None
        self.probing = False

    def fail(self) -> None:
        from ..utils import metric

        self.failures += 1
        self.probing = False
        if self.failures >= self.trip_threshold:
            if self.opened_at is None:
                metric.BREAKER_TRIPS.inc()
            self.opened_at = time.monotonic()


def advertise(gossip, node_id: int, addr) -> None:
    """Publish this node's KV endpoint (host, port) into gossip."""
    gossip.add_info(_KEY % node_id, list(addr))


class NodeDialer:
    def __init__(self, gossip, trip_threshold: int | None = None,
                 cooldown_s: float | None = None):
        from ..utils import settings

        if trip_threshold is None:
            trip_threshold = settings.get("rpc.breaker.trip_threshold")
        if cooldown_s is None:
            cooldown_s = settings.get("rpc.breaker.cooldown_s")
        self.gossip = gossip
        self._conns: dict[int, tuple[tuple, BatchClient]] = {}
        self._breakers: dict[int, _Breaker] = {}
        self._trip = trip_threshold
        self._cooldown = cooldown_s
        self._lock = locks.lock("kv.dialer")

    def resolve(self, node_id: int) -> tuple:
        addr = self.gossip.get_info(_KEY % node_id)
        if addr is None:
            raise KeyError(f"no gossiped address for node {node_id}")
        return tuple(addr)

    def _breaker(self, node_id: int) -> _Breaker:
        b = self._breakers.get(node_id)
        if b is None:
            b = self._breakers[node_id] = _Breaker(self._trip,
                                                  self._cooldown)
        return b

    def dial(self, node_id: int) -> BatchClient:
        """Cached connection to node_id; re-dials when the advertised
        address changed (node restart) or the cached conn is gone. An
        OPEN breaker fast-fails with BreakerOpenError; after the cooldown
        one caller gets through as the half-open probe. Callers report
        RPC outcomes via report_ok/report_failure — dialing alone never
        changes breaker state (a gossip-resolution miss says nothing
        about peer health, and a wedged peer can accept connects).

        The blocking TCP connect runs OUTSIDE the dialer lock: one
        black-holed peer must not stall dials or fast-fails to others."""
        # resolution BEFORE breaker admission: an unknown address is not
        # a peer failure and must not consume the half-open probe slot
        addr = self.resolve(node_id)
        with self._lock:
            self._breaker(node_id).admit()
            racesan.note_read(self, "_conns")
            cached = self._conns.get(node_id)
            if cached is not None and cached[0] == addr:
                self._breaker(node_id).probe_aborted()  # no probe needed
                return cached[1]
        try:
            from ..utils import faults

            faults.fire("kv.dialer.dial")
            client = BatchClient(addr)
        except Exception:
            with self._lock:
                self._breaker(node_id).probe_aborted()
            raise
        with self._lock:
            cached = self._conns.get(node_id)
            if cached is not None and cached[0] == addr:
                # another dial won the publish race
                try:
                    client.close()
                except OSError:
                    pass
                return cached[1]
            if cached is not None:
                try:
                    cached[1].close()
                except OSError:
                    pass
            racesan.note_write(self, "_conns")
            self._conns[node_id] = (addr, client)
            return client

    def report_ok(self, node_id: int) -> None:
        """Callers report a successful RPC: closes/resets the breaker."""
        with self._lock:
            self._breaker(node_id).ok()

    def report_failure(self, node_id: int) -> None:
        """Callers report an RPC failure: counts toward the trip
        threshold and drops the cached conn so the next dial reconnects."""
        with self._lock:
            self._breaker(node_id).fail()
        self.forget(node_id)

    def breaker_open(self, node_id: int) -> bool:
        with self._lock:
            b = self._breakers.get(node_id)
            return bool(b and b.opened_at is not None
                        and time.monotonic() - b.opened_at < b.cooldown_s)

    def forget(self, node_id: int) -> None:
        """Drop a cached conn (callers do this on a connection error so
        the next dial reconnects)."""
        with self._lock:
            racesan.note_write(self, "_conns")
            cached = self._conns.pop(node_id, None)
        if cached is not None:
            try:
                cached[1].close()
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            racesan.note_write(self, "_conns")
            conns = list(self._conns.values())
            self._conns.clear()
        for _, c in conns:
            try:
                c.close()
            except OSError:
                pass
