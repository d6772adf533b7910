"""Hybrid logical clock — the pkg/util/hlc analog; the port of
``cockroach_tpu.kv.hlc``.

Reference: hlc.Clock issues timestamps (walltime, logical) that are totally
ordered, monotone per node, and close to wall time; readings advance on
message receipt (clock.Update). Here the pair packs into one int64
(wall millis << 20 | logical), matching the storage layer's single-int64
version timestamps. Milliseconds (not the reference's nanos) so the packed
value stays inside int64 until ~year 2248 with 2^20 logical ticks per ms.
"""

from __future__ import annotations

import time

LOGICAL_BITS = 20
LOGICAL_MASK = (1 << LOGICAL_BITS) - 1


def pack(wall_ms: int, logical: int) -> int:
    if not 0 <= logical <= LOGICAL_MASK:
        raise OverflowError(f"hlc logical component out of range: {logical}")
    ts = (wall_ms << LOGICAL_BITS) | logical
    if ts >= (1 << 63):
        raise OverflowError(f"hlc wall component overflows int64: {wall_ms}")
    return ts


def unpack(ts: int) -> tuple[int, int]:
    return ts >> LOGICAL_BITS, ts & LOGICAL_MASK


class Clock:
    """Monotone hybrid clock. now() never returns the same or a smaller
    timestamp twice; update(ts) ratchets past a remote observation."""

    def __init__(self, wall_fn=None):
        self._wall_fn = wall_fn or (lambda: int(time.time() * 1e3))
        self._last = 0
        self._ticks = 0  # local increments since the wall last advanced

    def now(self) -> int:
        wall = self._wall_fn()
        ts = pack(wall, 0)
        if ts <= self._last:
            # count LOCAL saturation only: a remote timestamp ingested by
            # update() may legitimately carry a large logical component (the
            # clock absorbs skew by running ahead), so the overflow signal is
            # "2^20 local ticks without wall progress", not a carry bit
            self._ticks += 1
            if self._ticks > LOGICAL_MASK:
                raise OverflowError(
                    "hlc logical counter saturated: 2^20 local ticks "
                    "without wall-clock progress"
                )
            ts = self._last + 1
        else:
            self._ticks = 0
        self._last = ts
        return ts

    def update(self, observed: int) -> int:
        """Advance past an observed remote timestamp (clock.Update)."""
        if observed > self._last:
            self._last = observed
        return self.now()


class ManualClock(Clock):
    """Deterministic clock for tests (the reference's timeutil manual time)."""

    def __init__(self, start: int = 1):
        super().__init__(wall_fn=lambda: self._manual)
        self._manual = start

    def advance(self, ticks: int = 1) -> None:
        self._manual += ticks
