"""Admission control — the pkg/util/admission reduction; the port of
``cockroach_tpu.utils.admission``.

- ``WorkQueue``: bounded concurrency slots granted by (priority lane,
  tenant fair share, arrival) order. A waiter that times out while a
  grant races in hands the slot back; a timed-out admit holds no slot.
- Per-tenant token buckets (``admission.tenant.{rate,burst}``), priority
  lanes (interactive point/DML work, analytical scans and aggregations,
  ``classify_statement``), stride-scheduled fair share across tenants,
  queue-depth backpressure (``admission.sql.max_queue_depth``) and
  shedding under memory pressure, each refusal a typed
  ``AdmissionRejectedError`` (SQLSTATE 53300 at pgwire).
- ``sql_queue()`` / ``sql_slot()``: the process SQL queue every session
  statement takes a slot of (sql/session.py).
- ``IOGovernor``: write pacing and compaction pacing for the engine (the
  io_load_listener reduction): writes pay a delay proportional to L0
  overload, and size-tiered compactions are paced by
  ``storage.compaction.pacing.*``.

The reference also adds delay for memory pressure against
``sql.mem.root_budget_bytes`` in the IOGovernor; the port's governor has
no such term (0 under the default unlimited budget). Its tenant
registry's capability hook (``configure_tenant``) is here, but nothing
in the port calls it until ``kv/tenant.py`` is ported; the chaos sites
``admission.bucket.refill`` and ``admission.grant.stall`` are registered
in utils/faults.py.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

from . import faults, locks, metric, settings
from .errors import AdmissionRejectedError

# work priorities (admissionpb ordering)
LOW = 0
NORMAL = 10
HIGH = 20

# priority lanes: interactive serves point/DML traffic (NORMAL and the
# txn-control HIGH), analytical serves the scan/aggregate tail (LOW).
# Shedding rejects analytical first — see shed_floor().
LANE_INTERACTIVE = "interactive"
LANE_ANALYTICAL = "analytical"


def lane_for(priority: int) -> str:
    return LANE_ANALYTICAL if priority < NORMAL else LANE_INTERACTIVE


# analytical-lane shape: scan/aggregate/join statements — the work shed
# first under overload. Point reads, DML and DDL stay interactive.
_ANALYTIC_RE = None
_TXN_CTL_RE = None


def classify_statement(text: str) -> int:
    """Admission priority for a SQL statement (the lane classifier):

    - txn control (COMMIT/ROLLBACK/END) -> HIGH: shed dead last, so
      in-flight transactions can always wind down and release intents
      (session.py short-circuits these before admission anyway; HIGH
      covers internal callers);
    - SELECTs carrying joins or aggregation -> LOW (analytical lane);
    - everything else (point SELECT, DML, DDL, SET/SHOW) -> NORMAL.
    """
    global _ANALYTIC_RE, _TXN_CTL_RE
    if _ANALYTIC_RE is None:
        import re

        _ANALYTIC_RE = re.compile(
            r"(?is)\b(group\s+by|join|sum\s*\(|count\s*\(|avg\s*\("
            r"|min\s*\(|max\s*\()")
        _TXN_CTL_RE = re.compile(r"(?is)^\s*(commit|rollback|abort|end)\b")
    if _TXN_CTL_RE.match(text):
        return HIGH
    t = text.lstrip()[:8].lower()
    if (t.startswith("select") or t.startswith("explain")) \
            and _ANALYTIC_RE.search(text):
        return LOW
    return NORMAL


# kv/tenant.py's SYSTEM_TENANT_ID — hardcoded (not imported) so the utils
# layer does not depend on kv; kv/tenant.py asserts the two stay equal.
SYSTEM_TENANT_ID = 1


class TokenBucket:
    """Per-tenant refillable token bucket (tenant rate limiter shape).
    rate <= 0 means unlimited (the default: operators opt tenants into
    rate limits via admission.tenant.rate). All methods are called under
    the owning WorkQueue's lock."""

    __slots__ = ("rate", "burst", "tokens", "_t_last")

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self._t_last = time.monotonic()

    def take(self, now: float) -> float:
        """Consume one token. Returns 0.0 on success, else the seconds
        until one refills (the rejection's retry-after hint)."""
        if self.rate <= 0:
            return 0.0
        elapsed = now - self._t_last
        if elapsed > 0:
            self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
            self._t_last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return max(1e-3, (1.0 - self.tokens) / self.rate)

    def retry_after_s(self) -> float:
        """Seconds until the next token refills (no consumption)."""
        if self.rate <= 0:
            return 0.0
        return max(1e-3, (1.0 - min(self.tokens, 1.0)) / self.rate)


class _TenantState:
    """Per-tenant admission state: token bucket + stride-scheduler
    virtual time + counters. Lives in WorkQueue._tenants, guarded by the
    queue lock."""

    __slots__ = ("tenant_id", "bucket", "weight", "vtime",
                 "admitted", "rejected")

    def __init__(self, tenant_id: int, bucket: TokenBucket,
                 weight: float = 1.0, vtime: float = 0.0):
        self.tenant_id = tenant_id
        self.bucket = bucket
        self.weight = max(1e-6, weight)
        self.vtime = vtime
        self.admitted = 0
        self.rejected = 0


class _Waiter:
    """Queue entry. ``granted``/``withdrawn`` transitions happen only
    under the WorkQueue lock, so exactly one of the two ever wins."""

    __slots__ = ("event", "granted", "withdrawn", "tenant", "lane")

    def __init__(self, tenant: _TenantState | None = None,
                 lane: str = LANE_INTERACTIVE):
        self.event = threading.Event()
        self.granted = False
        self.withdrawn = False
        self.tenant = tenant
        self.lane = lane


def shed_floor() -> int:
    """The minimum priority currently admitted (the graceful-degradation
    ladder). Healthy -> LOW (everything admitted). Memory pressure past
    admission.shed.mem_low sheds the analytical lane (floor NORMAL);
    past admission.shed.mem_high only HIGH (txn control) still lands.
    The reference also sheds by the serving node's L0 health
    (``set_io_health_provider``, set by server/node.py, not ported)."""
    from ..flow import memory as flowmem

    p = flowmem.mem_pressure()
    if p >= settings.get("admission.shed.mem_high"):
        return HIGH
    if p >= settings.get("admission.shed.mem_low"):
        return NORMAL
    return LOW


class WorkQueue:
    """Priority/fair-share admission with bounded slots and a bounded
    wait queue (WorkQueue + slot-based GrantCoordinator).
    ``instrument=True`` exports the shared admission gauges/histogram
    (only the process SQL queue sets it, so test-local queues don't fight
    over the node metrics). ``max_queue_depth=0`` leaves the wait queue
    unbounded (standalone/test queues); the process SQL queue takes it
    from admission.sql.max_queue_depth."""

    def __init__(self, slots: int = 4, instrument: bool = False,
                 max_queue_depth: int = 0):
        self._slots = slots
        self._used = 0
        self._max_queue_depth = max_queue_depth
        self._lock = locks.lock("admission")
        # list of (-priority, seq, _Waiter); granted/withdrawn entries are
        # skipped (and periodically compacted) at grant time instead of
        # O(n) surgery on every timeout. Grant order is decided by a scan
        # — highest live priority, then least tenant virtual time, then
        # arrival — so fairness reflects vtime AT GRANT TIME, not at
        # enqueue (a tenant hammering the queue advances its vtime with
        # every grant and loses the next tie).
        self._waiters: list = []
        self._nwaiting = 0
        self._lane_waiting = {LANE_INTERACTIVE: 0, LANE_ANALYTICAL: 0}
        self._seq = itertools.count()
        self._instrument = instrument
        # per-tenant buckets/vtime/counters; mutated only under _lock
        self._tenants: dict[int, _TenantState] = {}
        self._vtime_floor = 0.0
        self.admitted = 0
        self.waited = 0
        self.timeouts = 0
        self.rejected = 0
        self.rejections_by_reason: dict[str, int] = {}
        if instrument:
            metric.ADMISSION_SQL_SLOTS.set(slots)
            self._publish()

    @property
    def slots(self) -> int:
        return self._slots

    @property
    def in_use(self) -> int:
        return self._used

    @property
    def queue_depth(self) -> int:
        return self._nwaiting

    @property
    def max_queue_depth(self) -> int:
        return self._max_queue_depth

    def lane_depths(self) -> dict[str, int]:
        with self._lock:
            return dict(self._lane_waiting)

    def _publish(self) -> None:
        # called under self._lock
        if self._instrument:
            metric.ADMISSION_SQL_SLOTS_IN_USE.set(self._used)
            metric.ADMISSION_SQL_QUEUE_DEPTH.set(self._nwaiting)
            for lane, n in self._lane_waiting.items():
                metric.ADMISSION_LANE_QUEUE_DEPTH.set(lane, n)

    def _publish_tenant(self, st: _TenantState) -> None:
        # called under self._lock
        if self._instrument:
            metric.ADMISSION_TENANT_TOKENS.set(
                st.tenant_id,
                st.bucket.tokens if st.bucket.rate > 0 else -1.0)

    # -- tenant state -------------------------------------------------------

    def _tenant_locked(self, tenant_id: int) -> _TenantState:
        """The tenant's admission state, created on first sight with the
        cluster-default bucket and its vtime clamped to the scheduler's
        floor (an idle tenant re-entering must not replay banked lag)."""
        st = self._tenants.get(tenant_id)
        if st is None:
            st = _TenantState(
                tenant_id,
                TokenBucket(settings.get("admission.tenant.rate"),
                            settings.get("admission.tenant.burst")),
                vtime=self._vtime_floor)
            self._tenants[tenant_id] = st
        else:
            st.vtime = max(st.vtime, self._vtime_floor)
        return st

    def configure_tenant(self, tenant_id: int, rate: float | None = None,
                         burst: float | None = None,
                         weight: float | None = None) -> None:
        """Override one tenant's bucket/weight past the cluster defaults
        (the tenant-capability hook: sql/session.py applies a tenant's
        admission_rate / admission_burst / admission_weight caps here at
        bind time; benches and tests call it directly)."""
        with self._lock:
            st = self._tenant_locked(tenant_id)
            if rate is not None:
                st.bucket.rate = float(rate)
            if burst is not None:
                st.bucket.burst = max(1.0, float(burst))
                st.bucket.tokens = min(st.bucket.tokens, st.bucket.burst)
            if weight is not None:
                st.weight = max(1e-6, float(weight))
            self._publish_tenant(st)

    def tenant_rows(self) -> list[dict]:
        """Per-tenant admission snapshot (crdb_internal / /_status/load)."""
        with self._lock:
            rows = []
            for tid in sorted(self._tenants):
                st = self._tenants[tid]
                rows.append({
                    "tenant_id": tid,
                    "tokens": round(st.bucket.tokens, 3),
                    "rate": st.bucket.rate,
                    "burst": st.bucket.burst,
                    "vtime": round(st.vtime, 6),
                    "weight": st.weight,
                    "admitted": st.admitted,
                    "rejected": st.rejected,
                })
            return rows

    def _reject_locked(self, reason: str, tenant: _TenantState | None,
                       retry_after_s: float) -> AdmissionRejectedError:
        self.rejected += 1
        self.rejections_by_reason[reason] = (
            self.rejections_by_reason.get(reason, 0) + 1)
        tid = None
        if tenant is not None:
            tenant.rejected += 1
            tid = tenant.tenant_id
        if self._instrument:
            metric.ADMISSION_REJECTIONS.inc(
                tid if tid is not None else "untenanted")
        return AdmissionRejectedError(reason, retry_after_s=retry_after_s,
                                      tenant_id=tid)

    def suggest_retry_after(self, tenant_id: int | None = None) -> float:
        """Retry-after hint for a rejection: the tenant's bucket refill
        time when it is rate-limited, else a queue-drain guess (waiters
        ahead / slot turnover — bounded to stay a hint, not a promise)."""
        with self._lock:
            if tenant_id is not None:
                st = self._tenants.get(tenant_id)
                if st is not None and st.bucket.rate > 0:
                    return round(st.bucket.retry_after_s(), 4)
            return round(min(5.0, 0.05 * (1 + self._nwaiting)), 4)

    # -- grant path ---------------------------------------------------------

    def _grant_locked(self) -> bool:
        """Hand the freed slot to the best live waiter — highest priority
        first, least tenant virtual time within it (stride fair share),
        arrival order within a tenant; False when no live waiter remains
        (caller frees the slot instead)."""
        best = None
        best_key = None
        for entry in self._waiters:
            negp, seq, w = entry
            if w.withdrawn or w.granted:
                continue
            vt = w.tenant.vtime if w.tenant is not None else 0.0
            key = (negp, vt, seq)
            if best_key is None or key < best_key:
                best, best_key = w, key
        if best is None:
            self._waiters.clear()
            return False
        best.granted = True
        best.event.set()
        self._nwaiting -= 1
        self._lane_waiting[best.lane] -= 1
        if best.tenant is not None:
            self._charge_locked(best.tenant)
        # compact once dead entries dominate (lazy-withdrawal bound)
        if len(self._waiters) > 2 * self._nwaiting + 16:
            self._waiters = [e for e in self._waiters
                             if not (e[2].withdrawn or e[2].granted)]
        return True

    def _charge_locked(self, st: _TenantState) -> None:
        """Advance the granted tenant's virtual time by 1/weight and drag
        the scheduler floor along so newly-arriving tenants start level."""
        self._vtime_floor = max(self._vtime_floor, st.vtime)
        st.vtime += 1.0 / st.weight
        st.admitted += 1

    def admit(self, priority: int = NORMAL, timeout: float | None = None,
              tenant_id: int | None = None) -> bool:
        """Block until a slot is granted (higher priority first, tenant
        fair share within a priority). Returns False only on timeout, in
        which case NO slot is held — a grant racing the timeout is handed
        back under the lock. Raises :class:`AdmissionRejectedError`
        without blocking when the node is shedding this priority, the
        tenant's token bucket is empty, or the wait queue is at
        max_queue_depth (tenant-aware callers only: ``tenant_id=None``
        keeps the raw slots-and-priorities behavior)."""
        t0 = time.perf_counter()
        tenant_aware = tenant_id is not None
        if tenant_aware:
            # overload shed: the cheapest refusal, before any queue state
            floor = shed_floor()
            if priority < floor:
                with self._lock:
                    st = self._tenant_locked(tenant_id)
                    raise self._reject_locked(
                        f"overloaded: shedding {lane_for(priority)}-lane "
                        "work (mem pressure / L0 health past threshold)",
                        st, self.suggest_retry_after_locked(st))
            # tenant token bucket (admission.bucket.refill chaos site:
            # fired outside the lock so a delay-kind stall cannot wedge
            # the grant path for everyone else)
            try:
                faults.fire("admission.bucket.refill")
            except faults.InjectedFault as e:
                with self._lock:
                    st = self._tenant_locked(tenant_id)
                    raise self._reject_locked(
                        "tenant token-bucket refill failed",
                        st, st.bucket.retry_after_s()) from e
        with self._lock:
            st = self._tenant_locked(tenant_id) if tenant_aware else None
            if st is not None:
                retry = st.bucket.take(time.monotonic())
                self._publish_tenant(st)
                if retry > 0:
                    raise self._reject_locked(
                        "tenant rate limit: token bucket empty", st, retry)
            if self._used < self._slots and not self._nwaiting:
                self._used += 1
                self.admitted += 1
                if st is not None:
                    self._charge_locked(st)
                if self._instrument:
                    # fast-path admissions observe too: the wait histogram
                    # must count EVERY admission so queue-wait percentiles
                    # reflect the workload, not just its queued tail
                    metric.ADMISSION_WAIT_SECONDS.observe(
                        time.perf_counter() - t0)
                self._publish()
                return True
            # queue-depth backpressure: past the bound, fail fast with a
            # typed busy instead of queuing toward collapse
            if (self._max_queue_depth
                    and self._nwaiting >= self._max_queue_depth):
                raise self._reject_locked(
                    f"admission queue full "
                    f"(depth {self._nwaiting} >= "
                    f"admission.sql.max_queue_depth)",
                    st, self.suggest_retry_after_locked(st))
            w = _Waiter(st, lane_for(priority))
            self._waiters.append((-priority, next(self._seq), w))
            self._nwaiting += 1
            self._lane_waiting[w.lane] += 1
            self.waited += 1
            self._publish()
        # admission.grant.stall chaos site: a stall (delay kind) just
        # holds this waiter — the grant still lands; a lost grant (error
        # kind) withdraws the waiter cleanly and surfaces the typed busy
        try:
            faults.fire("admission.grant.stall")
        except faults.InjectedFault as e:
            with self._lock:
                if w.granted:
                    # the grant raced in: hand the slot back, exactly the
                    # timeout-race discipline (never leak it)
                    if not self._grant_locked():
                        self._used = max(0, self._used - 1)
                else:
                    w.withdrawn = True
                    self._nwaiting -= 1
                    self._lane_waiting[w.lane] -= 1
                err = self._reject_locked(
                    "admission grant stalled/lost while queued", st,
                    self.suggest_retry_after_locked(st))
                self._publish()
            raise err from e
        granted = w.event.wait(timeout)
        with self._lock:
            if not w.granted:
                # pure timeout: withdraw (lazily — the entry is skipped
                # at the next grant) and hold nothing
                w.withdrawn = True
                self._nwaiting -= 1
                self._lane_waiting[w.lane] -= 1
                self.timeouts += 1
                if self._instrument:
                    metric.ADMISSION_SQL_TIMEOUTS.inc()
                self._publish()
                return False
            if not granted and timeout is not None:
                # the race: our event was set concurrently with the
                # timeout expiring. The grant is definitive (flag set
                # under this lock), but the caller asked for a deadline —
                # hand the slot to the next waiter (or free it) and
                # report the timeout instead of silently keeping it
                if not self._grant_locked():
                    self._used = max(0, self._used - 1)
                self.timeouts += 1
                if self._instrument:
                    metric.ADMISSION_SQL_TIMEOUTS.inc()
                self._publish()
                return False
            self.admitted += 1
            if self._instrument:
                metric.ADMISSION_WAIT_SECONDS.observe(
                    time.perf_counter() - t0)
            self._publish()
        return True

    def suggest_retry_after_locked(self, st: _TenantState | None) -> float:
        # under self._lock
        if st is not None and st.bucket.rate > 0:
            return round(st.bucket.retry_after_s(), 4)
        return round(min(5.0, 0.05 * (1 + self._nwaiting)), 4)

    def release(self) -> None:
        with self._lock:
            if not self._grant_locked():
                self._used = max(0, self._used - 1)
            self._publish()

    def __enter__(self):
        self.admit()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


# -- the process SQL admission queue (session statements) -------------------

_SQL_QUEUE: WorkQueue | None = None
_SQL_QUEUE_LOCK = threading.Lock()
_TLS = threading.local()


def sql_queue() -> WorkQueue:
    """The node's shared statement-admission queue, sized by
    admission.sql.slots / admission.sql.max_queue_depth at first use."""
    global _SQL_QUEUE
    with _SQL_QUEUE_LOCK:
        if _SQL_QUEUE is None:
            _SQL_QUEUE = WorkQueue(
                slots=int(settings.get("admission.sql.slots")),
                instrument=True,
                max_queue_depth=int(
                    settings.get("admission.sql.max_queue_depth")))
        return _SQL_QUEUE


@contextlib.contextmanager
def sql_slot(priority: int = NORMAL, tenant_id: int | None = None,
             deadline: float | None = None):
    """Hold one SQL admission slot for the duration (Session.execute wraps
    every statement in this). Yields the seconds spent queued. No-op when
    admission.sql.enabled is off, and re-entrant per thread so a nested
    statement (diagnostics re-run, internal executor) never deadlocks on
    its own session's slot.

    ``deadline`` is a time.monotonic() instant (the statement deadline:
    queue-wait counts against statement_timeout); without one the wait is
    bounded by admission.sql.queue_timeout_s. Either way a wait that runs
    out raises :class:`AdmissionRejectedError` (SQLSTATE 53300 at the
    wire) — the old behavior of discarding admit()'s verdict and running
    WITHOUT a slot on a full queue is gone."""
    if not settings.get("admission.sql.enabled"):
        yield 0.0
        return
    depth = getattr(_TLS, "depth", 0)
    if depth > 0:
        _TLS.depth = depth + 1
        try:
            yield 0.0
        finally:
            _TLS.depth = depth
        return
    q = sql_queue()
    if tenant_id is None:
        tenant_id = SYSTEM_TENANT_ID
    if deadline is not None:
        timeout = deadline - time.monotonic()
        if timeout <= 0:
            raise AdmissionRejectedError(
                "statement deadline expired before admission",
                retry_after_s=q.suggest_retry_after(tenant_id),
                tenant_id=tenant_id)
    else:
        backstop = float(settings.get("admission.sql.queue_timeout_s"))
        timeout = backstop if backstop > 0 else None
    t0 = time.perf_counter()
    if not q.admit(priority, timeout=timeout, tenant_id=tenant_id):
        raise AdmissionRejectedError(
            "queue-wait deadline exceeded"
            + (" (statement deadline)" if deadline is not None else ""),
            retry_after_s=q.suggest_retry_after(tenant_id),
            tenant_id=tenant_id)
    wait = time.perf_counter() - t0
    _TLS.depth = 1
    try:
        yield wait
    finally:
        _TLS.depth = 0
        q.release()


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
