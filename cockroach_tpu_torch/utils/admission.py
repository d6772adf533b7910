"""IOGovernor — write pacing and compaction pacing for the engine
(``cockroach_tpu.utils.admission.IOGovernor``, the io_load_listener
reduction): writes pay a delay proportional to L0 overload, and
size-tiered compactions are paced by ``storage.compaction.pacing.*``.

The reference also adds delay for memory pressure against
``sql.mem.root_budget_bytes``; the port's storage slice has no root
memory monitor, so that term (0 under the reference's default unlimited
budget) is absent.
"""

from __future__ import annotations

import time

from . import metric, settings


class IOGovernor:
    def __init__(self, engine, healthy_runs: int | None = None,
                 delay_per_run_s: float = 0.001):
        self.engine = engine
        # below the compaction trigger: pacing engages while the LSM is
        # catching up, not only after
        self.healthy_runs = (healthy_runs if healthy_runs is not None
                             else max(1, engine.l0_trigger // 2))
        self.delay_per_run_s = delay_per_run_s
        self.throttled = 0
        self.compactions_deferred = 0
        self._last_compaction_t = 0.0
        self._pacing_wait_start: float | None = None

    def write_delay_s(self) -> float:
        over = len(self.engine.runs) - self.healthy_runs
        return max(0, over) * self.delay_per_run_s

    def pace_write(self) -> float:
        """The single admission gate for engine write paths."""
        if not settings.get("admission.io_pacing.enabled"):
            return 0.0
        d = self.write_delay_s()
        if d > 0:
            self.throttled += 1
            time.sleep(d)
        return d

    def compaction_debt(self) -> int:
        return max(0, len(self.engine.runs) - self.engine.l0_trigger)

    def pace_compaction(self) -> bool:
        """Should the pending size-tiered compaction run now? Under
        max_debt_runs, compactions respect a minimum interval; past it the
        pacer steps aside."""
        if not settings.get("storage.compaction.pacing.enabled"):
            return True
        debt = self.compaction_debt()
        if debt <= 0:
            return False
        if debt > settings.get("storage.compaction.pacing.max_debt_runs"):
            return True
        min_iv = settings.get(
            "storage.compaction.pacing.min_interval_ms") / 1e3
        if min_iv <= 0:
            return True
        if time.monotonic() - self._last_compaction_t >= min_iv:
            return True
        self.compactions_deferred += 1
        if self._pacing_wait_start is None:
            self._pacing_wait_start = time.monotonic()
        return False

    def note_compaction(self) -> None:
        """A compaction just ran: reset the pacing clock and record how
        long pacing held it back."""
        now = time.monotonic()
        if self._pacing_wait_start is not None:
            metric.COMPACTION_PACING_DELAY.observe(
                now - self._pacing_wait_start)
            self._pacing_wait_start = None
        self._last_compaction_t = now
