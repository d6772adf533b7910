"""Fault-injection hooks at the storage engine's, the external
operators', SQL admission's, the warm menu's, the changefeed's and the
materialized views' sites, with the reference's site names. Every hook
is a no-op until ``arm`` is called."""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

SITES: dict[str, str] = {
    "storage.wal.append": "WAL write error/stall/torn append",
    "storage.wal.fsync": "fsync stall or failure",
    "storage.ingest.link": "bulk-ingest side file durable, link lost",
    "storage.compaction.swap": "crash between run swap and bookkeeping",
    "storage.bloom.build": "bloom build crash or silent bit corruption",
    "flow.spill.partition_write": "host spill-partition write failure",
    "flow.spill.merge_probe": "oversized-partition merge-probe run failure",
    "admission.bucket.refill": "tenant token-bucket refill failure",
    "admission.grant.stall": "a queued admission grant stalls or is lost",
    "sql.warmup.compile": "ahead-of-time menu compile failure at server "
                          "start",
    "kv.rangefeed.subscribe": "rangefeed (re)subscription failure",
    "changefeed.fanout.enqueue": "fan-out buffer enqueue failure: the "
                                 "subscriber sheds to a catch-up scan",
    "changefeed.subscriber.send": "subscriber socket send failure: the "
                                  "consumer is evicted and reconnects "
                                  "from its frontier",
    "changefeed.frontier.checkpoint": "resolved-frontier checkpoint "
                                      "failure: resume re-delivers past "
                                      "the stale frontier, never skips",
    "matview.flush": "materialized-view flush failure before any apply",
    "matview.delta.apply": "materialized-view delta kernel failure "
                           "mid-flush: no state swapped",
    "matview.frontier.checkpoint": "materialized-view frontier checkpoint "
                                   "failure after compute, before swap",
}


class InjectedFault(ConnectionError):
    def __init__(self, site: str, kind: str):
        super().__init__(f"injected {kind} at {site}")
        self.site = site
        self.kind = kind


@dataclass
class FaultSpec:
    """kind: 'error' | 'drop' | 'delay' | 'partial'; p: firing probability;
    max_fires: stop after this many hits (None = unlimited)."""

    kind: str = "error"
    p: float = 1.0
    delay_s: float = 0.01
    max_fires: int | None = None
    fires: int = field(default=0, compare=False)


_lock = threading.Lock()
_armed = False
_rng = random.Random(0)
_specs: dict[str, FaultSpec] = {}


def arm(seed: int, specs: dict[str, FaultSpec]) -> None:
    global _armed, _rng
    for site in specs:
        if site not in SITES:
            raise KeyError(f"unknown fault site {site!r}")
    with _lock:
        _rng = random.Random(seed)
        _specs.clear()
        _specs.update(specs)
        _armed = True


def disarm() -> None:
    global _armed
    with _lock:
        _armed = False
        _specs.clear()


def fire(site: str) -> None:
    """Raise InjectedFault for error/drop faults, sleep for delay faults,
    no-op when disarmed or the die-roll misses."""
    if not _armed:
        return
    spec = _roll(site, ("error", "drop", "delay"))
    if spec is None:
        return
    if spec.kind == "delay":
        time.sleep(spec.delay_s)
        return
    raise InjectedFault(site, spec.kind)


def partial_fraction(site: str) -> float | None:
    """Fraction of a write to persist before the site raises as if the
    disk died mid-append, or None when no partial fault fires."""
    if not _armed:
        return None
    return None if _roll(site, ("partial",)) is None else 0.5


def _roll(site: str, kinds: tuple[str, ...]):
    from . import metric

    with _lock:
        spec = _specs.get(site) if _armed else None
        if spec is None or spec.kind not in kinds:
            return None
        if spec.max_fires is not None and spec.fires >= spec.max_fires:
            return None
        if _rng.random() >= spec.p:
            return None
        spec.fires += 1
    metric.FAULTS_INJECTED.inc()
    return spec
