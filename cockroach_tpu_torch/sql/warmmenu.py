"""The warm menu: statements run ahead of time, before a server accepts
its first connection; the port of ``cockroach_tpu.sql.warmmenu``.

Reference: a fresh CockroachDB node serves its first query at full speed
because its execution engine is interpreted. The port's first execution
of a statement instead builds its operator tree, captures a CUDA graph
per new signature (flow/dispatch.py) and, in a second run, re-captures
what its learned capacities re-specialize. This module moves that cost
off the serving path: ``server/pgwire.PgServer`` calls :func:`build_menu`
before it accepts a connection, and a bounded background pool runs a
*menu* of statements into the same plan cache (sql/plancache.py) and
process-global graph cache the serving path reads.

The menu has three courses, warmed in value order:

1. **explicit**: statements handed in by the operator or the harness,
   each a text or a (text, settings) pair: a pair's settings hold for
   its runs alone, on its worker's thread (``settings.scoped``), as for
   a statement that its clients run under a session setting of its own;
2. **hot**: the plan cache's recorded texts of the hottest statement
   fingerprints (``PlanCache.hot_texts``, ranked by sqlstats);
3. **ladder**: synthesized per-table statements covering the shape
   ladder (``catalog.SHAPE_BUCKETS``) times the fused-pipeline templates
   (filter/project chain, scalar aggregate, grouped aggregate, top-k):
   every table pads to a ladder rung and kernels key on (template,
   rung), so warming one table per rung warms every query of its shape.

Each item runs twice on a private background session: the first run
builds and captures, the second settles adaptive capacities. Where the
second run still made new signatures, the item runs again until a run
makes none, at most ``_MAX_RUNS`` times: a capacity learned from run 2
can re-specialize once more, and each such recapture would otherwise
land on the serving path. Signatures are counted by the worker's share
of ``dispatch.compiles()`` (CUDA graph captures on the card, new
signatures on the CPU); on the card each row also records its captures.

Bounded: ``sql.warmup.menu.budget_s`` caps wall time,
``sql.warmup.menu.max_kernels`` caps new signatures, and the plan
cache's byte budget (``PlanCache.budget``, half the card) caps what the
warmed entries hold: items past any bound are recorded as ``skipped``.
The menu runs its statements under ``plancache.keep_cached``, so it never
evicts an entry it warmed: an entry that would push the cache past its
budget is not kept, and its item is recorded as ``skipped`` too.
Best-effort: a failed item (fault site ``sql.warmup.compile``) is
recorded as ``failed`` and its statement compiles on first use. A CUDA
graph has no persistent form, so every server start pays for its menu.

Accounting: the ``sql_warmup_kernels_compiled`` and
``sql_warmup_menu_hits`` metrics and the ``crdb_internal.node_warmup_menu``
vtable (one row per item: source, status, kernels, seconds, and
serving-path hits).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..coldata.types import Family
from ..utils import faults, locks, log, metric, settings

__all__ = ["build_menu", "menu_rows", "note_serving_hit", "reset",
           "MenuRun"]

# bounded background pool: the statements' device work runs one at a
# time (flow/dispatch.exec_lock), so a second worker only overlaps the
# other's parse, bind and build
_POOL_SIZE = 2

# runs of one item at most: twice, then again while a run still makes
# new signatures
_MAX_RUNS = 4

# fused-pipeline operator templates: scan->filter->project, the scalar
# aggregate, the grouped aggregate and the top-k consumer. {t}/{c} bind
# per table below.
_TEMPLATES = (
    ("filter", "select {c} from {t} where {c} >= 0"),
    ("scalar_agg", "select sum({c}) from {t}"),
    ("group_agg", "select {c}, sum({c}) from {t} group by {c}"),
    ("topk", "select {c} from {t} order by {c} limit 16"),
)

# menu registry (vtable and hit accounting): fingerprint -> row dict.
# The serving path touches it once per plan-cache hit (note_serving_hit).
_mu = locks.lock("sql.warmmenu")
_MENU: dict[str, dict] = {}


@dataclass
class _Item:
    text: str
    source: str  # 'explicit' | 'hot' | 'ladder'
    settings: dict = field(default_factory=dict)  # held for its runs


class MenuRun:
    """Handle on one menu build: join it, or stop it early (a server
    closing while a budget-bound item still runs)."""

    def __init__(self):
        self.stop = threading.Event()
        self.threads: list[threading.Thread] = []

    def join(self, timeout: float | None = None) -> None:
        for t in self.threads:
            if t is not threading.current_thread():
                t.join(timeout)

    def stop_join(self, timeout: float = 5.0) -> None:
        self.stop.set()
        self.join(timeout)


def reset() -> None:
    """Drop menu state (test isolation)."""
    with _mu:
        _MENU.clear()


def menu_rows() -> list[dict]:
    """Snapshot of the menu registry for crdb_internal.node_warmup_menu
    (insertion order = warm order)."""
    with _mu:
        return [dict(r) for r in _MENU.values()]


def note_serving_hit(fingerprint: str) -> None:
    """Called by the plan cache on a serving-path hit: if the menu
    compiled this fingerprint, its cold run was paid before the server
    started serving; count it. Warm-up threads' own runs never count."""
    if threading.current_thread().name.startswith(
            ("warm-menu", "plan-warmup")):
        return
    with _mu:
        row = _MENU.get(fingerprint)
        if row is None or row["status"] != "compiled":
            return
        row["hits"] += 1
    metric.SQL_WARMUP_MENU_HITS.inc()


def _record(item: _Item, status: str, kernels: int, seconds: float,
            captures: int = 0, runs: int = 0) -> None:
    from . import sqlstats

    fp = sqlstats.fingerprint(item.text)
    with _mu:
        row = _MENU.get(fp)
        if row is None:
            _MENU[fp] = {
                "fingerprint": fp, "source": item.source, "status": status,
                "kernels": int(kernels), "seconds": float(seconds),
                "hits": 0, "captures": int(captures), "runs": int(runs),
            }
        elif status == "compiled" and row["status"] != "compiled":
            # a retry or duplicate that compiled upgrades the row
            row.update(status=status, kernels=int(kernels),
                       seconds=float(seconds), captures=int(captures),
                       runs=int(runs))


def _ladder_statements(catalog) -> list[str]:
    """One table per ladder rung x every operator template. Kernels key
    on (template, rung), so warming the first table padded to a rung
    warms every same-rung table; skipping the rest keeps the menu
    O(|SHAPE_BUCKETS| x |templates|) however wide the catalog is."""
    from ..catalog import _bucket_cap

    out: list[str] = []
    rung_done: set[int] = set()
    for name in sorted(catalog.tables):
        if name.startswith("__") or name.startswith("crdb_internal."):
            continue
        t = catalog.tables[name]
        try:
            rows = t.num_rows
        except (StopIteration, KeyError, ValueError):
            continue  # descriptor-only or torn table: nothing to warm
        rung = _bucket_cap(rows)
        if rung in rung_done:
            continue
        ints = [c for c, ty in zip(t.schema.names, t.schema.types)
                if ty.family is Family.INT]
        if not ints:
            continue
        rung_done.add(rung)
        c = ints[0]
        for _, tmpl in _TEMPLATES:
            out.append(tmpl.format(t=name, c=c))
    return out


def _over_bytes(cache) -> bool:
    budget = cache.budget()
    return budget is not None and cache.bytes >= budget


def build_menu(catalog, db, statements=None, block: bool = True
               ) -> MenuRun | None:
    """Warm the menu for ``catalog``/``db`` on a bounded background pool.
    Returns the :class:`MenuRun` handle (already joined when ``block``,
    the server-start mode) or None when disabled or the menu is empty.
    Each of `statements` is a text or a (text, settings) pair. Never
    raises: warming is best-effort."""
    if not settings.get("sql.warmup.menu.enabled"):
        return None
    from ..flow import dispatch
    from . import plancache
    from .session import Session

    items: list[_Item] = []
    seen: set[str] = set()

    def add(text: str, source: str, own: dict | None = None) -> None:
        if text and text not in seen:
            seen.add(text)
            items.append(_Item(text, source, dict(own or {})))

    cache = plancache.cache_for(catalog)
    for t in (statements or ()):
        add(*((t, "explicit") if isinstance(t, str)
              else (t[0], "explicit", t[1])))
    for t in cache.hot_texts():
        add(t, "hot")
    for t in _ladder_statements(catalog):
        add(t, "ladder")
    if not items:
        return None

    budget_s = settings.get("sql.warmup.menu.budget_s")
    max_kernels = settings.get("sql.warmup.menu.max_kernels")
    deadline = (time.monotonic() + budget_s) if budget_s > 0 else None
    run = MenuRun()
    pending = list(items)
    plock = locks.lock("sql.warmmenu.pending")
    k0 = dispatch.compiles()
    t_start = time.monotonic()

    def _worker(sess) -> None:
        try:
            while not run.stop.is_set():
                with plock:
                    if not pending:
                        return
                    item = pending.pop(0)
                over_budget = (
                    (deadline is not None and time.monotonic() >= deadline)
                    or dispatch.compiles() - k0 >= max_kernels
                    or _over_bytes(cache))
                if over_budget:
                    _record(item, "skipped", 0, 0.0)
                    continue
                c0 = dispatch.thread_compiles()
                g0 = dispatch.thread_captures()
                t0 = time.perf_counter()
                runs = 0
                try:
                    # fault site: a compile failing at startup degrades to
                    # compile-on-first-use, never blocks readiness
                    faults.fire("sql.warmup.compile")
                    with plancache.keep_cached() as kept, \
                            settings.scoped(item.settings):
                        while runs < _MAX_RUNS:
                            r0 = dispatch.thread_compiles()
                            sess.execute(item.text)
                            runs += 1
                            if run.stop.is_set() or kept.refused:
                                break
                            if (runs >= 2
                                    and dispatch.thread_compiles() == r0):
                                break
                        refused = kept.refused
                except Exception as e:  # noqa: BLE001 - warming is best-effort: the item is recorded and served cold
                    log.warning(log.SQL_EXEC, "warm menu item failed",
                                stmt=item.text.strip()[:60],
                                error=f"{type(e).__name__}: {e}"[:300])
                    _record(item, "failed", dispatch.thread_compiles() - c0,
                            time.perf_counter() - t0,
                            dispatch.thread_captures() - g0, runs)
                    continue
                kn = dispatch.thread_compiles() - c0
                caps = dispatch.thread_captures() - g0
                secs = time.perf_counter() - t0
                if refused or run.stop.is_set():
                    # not kept within the cache's budget, or stopped
                    # mid-item: what it captured is served cold
                    _record(item, "skipped", kn, secs, caps, runs)
                    if run.stop.is_set():
                        return
                    continue
                if kn > 0:
                    metric.SQL_WARMUP_KERNELS_COMPILED.inc(kn)
                _record(item, "compiled", kn, secs, caps, runs)
        finally:
            sess.close()

    n = min(_POOL_SIZE, len(items))
    for i in range(n):
        # private per-worker sessions over the shared catalog and store,
        # made here, not in the thread
        sess = Session(catalog=catalog, db=db, bootstrap=False,
                       device=catalog.device)
        th = threading.Thread(target=_worker, args=(sess,),
                              name=f"warm-menu-{i}", daemon=True)
        run.threads.append(th)
        th.start()
    if block:
        # readiness gate: wait out the budget (plus a statement-boundary
        # grace), then tell stragglers to stop at their next boundary
        remain = (None if deadline is None
                  else max(0.0, deadline - time.monotonic()) + 5.0)
        run.join(remain)
        run.stop.set()
        rows = menu_rows()
        compiled = sum(1 for r in rows if r["status"] == "compiled")
        log.info(log.SQL_EXEC, "warm menu built",
                 items=len(rows), compiled=compiled,
                 kernels=dispatch.compiles() - k0,
                 seconds=round(time.monotonic() - t_start, 3))
    return run
