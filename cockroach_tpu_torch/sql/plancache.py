"""Prepared-plan cache — the zero-recapture serving path (the level of the
cache hierarchy above flow/dispatch.py's per-signature CUDA graphs).

Reference shape: pkg/sql's query cache (plan_opt.go / querycache) keys
memoized plans on statement + placeholder types + catalog descriptor
versions, so the conn executor skips optbuild on repeat statements. Here
the expensive phase is not optimization but the build->fuse->capture
pipeline, so the cache holds the BUILT operator tree:

- ``parameterize`` rewrites numeric literals in Filter predicates into
  ``ex.Param`` slots, so a repeat statement with different literals maps
  to the same structural plan; the values are rebound per execution as
  function ARGUMENTS (ops/expr.param_scope), never captured anew.
- ``plan_key`` derives a stable structural key from the parameterized
  plan (frozen dataclasses all the way down). Anything it cannot key
  byte-stably (runtime-filled dictionaries, unknown objects) raises
  ``_Unkeyable`` and the statement simply is not cached — conservative
  misses, never wrong hits.
- Entries are LRU-bounded, by count (``sql.plan_cache.size``) and by
  the device bytes they hold (``MAX_DEVICE_FRACTION`` of the card's
  memory), and keyed on the catalog schema version + the settings
  signature, so DDL (CREATE/DROP INDEX, ALTER) and tuning changes can
  never serve a stale plan; the session's DDL handlers additionally
  sweep dead-version entries out eagerly (``invalidate``). A dropped
  entry's graphs leave the shared wrappers with it. Entries the warm
  menu (sql/warmmenu.py) kept are evicted after every other one: a
  serving miss that does not fit beside them runs but is not kept.
- A per-entry lock serializes concurrent sessions through one entry:
  operator trees hold mutable pull state, so two sessions never drive
  the same tree at once (they queue; distinct statements run in
  parallel).

Execution-stats collection (EXPLAIN ANALYZE / the cluster setting)
bypasses the cache: stats need a fresh per-operator tree, and cached
trees deliberately skip the instrumented path.

The port of ``cockroach_tpu.sql.plancache``. On the card a built tree's
per-tile functions replay CUDA graphs (flow/dispatch.py), so the
parameter values are 0-d tensors on the catalog's device, passed to
those functions as arguments: each replay copies them into the graph's
input buffers, and a rebind captures nothing new. The reference's
on-disk compilation cache (``maybe_enable_compile_cache``, the
``sql.compile_cache.*`` settings) has no counterpart: a CUDA graph has
no persistent form. Serving-path hits are counted by the warm menu
(``sql/warmmenu.note_serving_hit``), as in the reference.

An entry's bytes are what it holds, not what the allocator handed out
while it ran: the distinct storages its operator tree keeps between
runs (spools, ``ParamStore`` tensors, persisted state) and the static
inputs and outputs of the graphs its runs captured, less what the
catalog's tables own. A storage two entries share is counted once in the
cache's total. So an allocation another thread makes meanwhile is never
charged, and the count is the same on the CPU, where the allocator says
nothing. The temporaries of the shared graph pool are not counted.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import gc
import threading
import types
import weakref
from collections import OrderedDict, deque

import numpy as np
import torch

from ..coldata.batch import Dictionary
from ..coldata.types import Family
from ..ops import expr as ex
from ..plan import builder as plan_builder
from ..plan import spec as S
from ..utils import metric, settings, tracing

# literal families rewritten into Param slots: everything whose device
# representation is a plain numeric scalar. STRING stays literal (string
# predicates lower to host-built CodeLookup tables — content-keyed), BOOL
# stays literal (structural TRUE/FALSE branches), NULL stays literal (its
# valid-mask shape differs from any bound value)
_PARAM_FAMILIES = (Family.INT, Family.FLOAT, Family.DECIMAL, Family.DATE,
                   Family.TIMESTAMP, Family.INTERVAL)


class _Unkeyable(Exception):
    """The plan holds an object with no stable structural key; the
    statement runs uncached (conservative — a miss is always correct)."""


class ParamStore:
    """Positional parameter values for one cached plan, shared by every
    operator the plan's builder created with ``params=``.

    ``args()`` is re-read at each run's ``stream_parts`` fetch, so
    rebinding values between runs flows into the replayed functions as
    fresh arguments: 0-d tensors on `device`, whose dtypes are pinned per
    slot at parameterize time, so no value change can make a new
    signature (a new capture)."""

    def __init__(self, types, device="cpu"):
        self._types = tuple(types)
        self._device = torch.device(device)
        self._values: tuple | None = None

    def set_values(self, values) -> None:
        if len(values) != len(self._types):
            raise ValueError(
                f"expected {len(self._types)} parameter values, "
                f"got {len(values)}")
        out = []
        for v, t in zip(values, self._types):
            if t.family is Family.DECIMAL:
                # the same host-side fixed-point scaling Const evaluation
                # applies (ops/expr.py) — device kernels see scaled ints
                v = int(round(float(v) * 10 ** t.scale))
            v = np.asarray(v, dtype=t.dtype).item()
            # a fill on the device, not a host-to-device copy
            out.append(torch.full((), v, dtype=t.torch_dtype,
                                  device=self._device))
        self._values = tuple(out)

    def args(self) -> tuple:
        if self._values is None:
            raise RuntimeError("ParamStore.args() before set_values()")
        return self._values


def parameterize(plan, projections: bool = False):
    """Rewrite numeric Filter-predicate literals into Param slots, and
    with `projections` those of Project expressions too (a DML
    statement's SET literals, whose scan-and-project plan sql/session.py
    runs through the cache).

    Returns ``(pplan, values, types)``: the parameterized plan (shared
    across every statement with the same shape), the extracted literal
    values in slot order, and their SQL types. Runs AFTER index
    selection (plan/indexopt.py), so IndexScan lo/hi bounds stay
    literal — different index bounds are different plans by design."""
    values: list = []
    types: list = []

    def walk_expr(e):
        if isinstance(e, ex.Const):
            if (e.value is not None
                    and e.type.family in _PARAM_FAMILIES
                    and not isinstance(e.value, (tuple, list, np.ndarray))):
                p = ex.Param(len(values), e.type)
                values.append(e.value)
                types.append(e.type)
                return p
            return e
        if isinstance(e, ex.CodeLookup) or not isinstance(e, ex.Expr):
            return e
        if isinstance(e, ex.Func2) and e.func == "round2":
            # round2's digit count is read with .value at build time
            # ("binder guarantees a literal") — it must stay a Const
            left = walk_expr(e.left)
            return (e if left is e.left
                    else dataclasses.replace(e, left=left))
        changes = {}
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            nv = walk_field(v)
            if nv is not v:
                changes[f.name] = nv
        return dataclasses.replace(e, **changes) if changes else e

    def walk_field(v):
        if isinstance(v, ex.Expr):
            return walk_expr(v)
        if isinstance(v, tuple):
            nv = tuple(walk_field(i) for i in v)
            return nv if any(a is not b for a, b in zip(nv, v)) else v
        return v

    def walk_plan(n):
        if not dataclasses.is_dataclass(n):
            return n
        changes = {}
        for f in dataclasses.fields(n):
            v = getattr(n, f.name)
            if isinstance(n, S.Filter) and f.name == "predicate":
                nv = walk_expr(v)
            elif (projections and isinstance(n, S.Project)
                    and f.name == "exprs"):
                nv = walk_field(v)
            elif isinstance(v, S.PlanNode):
                nv = walk_plan(v)
            elif (isinstance(v, tuple) and v
                    and isinstance(v[0], S.PlanNode)):
                nv = tuple(walk_plan(i) for i in v)
                if not any(a is not b for a, b in zip(nv, v)):
                    nv = v
            else:
                nv = v
            if nv is not v:
                changes[f.name] = nv
        return dataclasses.replace(n, **changes) if changes else n

    return walk_plan(plan), tuple(values), tuple(types)


def plan_key(pplan):
    """Stable structural key of a (parameterized) plan tree. Raises
    ``_Unkeyable`` for objects without byte-stable content."""
    return _key_of(pplan)


def _key_of(x):
    if x is None or isinstance(x, (bool, int, float, str, bytes)):
        return x
    if isinstance(x, enum.Enum):
        return ("enum", type(x).__name__, x.name)
    if isinstance(x, np.generic):
        return ("np", str(x.dtype), x.item())
    if isinstance(x, np.ndarray):
        return ("nd", str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, ex.CodeLookup):
        # eq=False dataclass (identity semantics for kernel keys); the plan
        # key compares the host table's CONTENT so two binds of the same
        # string predicate share an entry
        t = np.asarray(x.table)
        return ("codelookup", x.col, _key_of(x.out_type), str(t.dtype),
                t.shape, t.tobytes())
    if isinstance(x, Dictionary):
        if getattr(x, "_runtime", False):
            raise _Unkeyable("runtime-filled dictionary")
        return ("dict", tuple(str(v) for v in x.values))
    if isinstance(x, (tuple, list)):
        return ("seq", tuple(_key_of(i) for i in x))
    if dataclasses.is_dataclass(x):
        return ((type(x).__name__,)
                + tuple(_key_of(getattr(x, f.name))
                        for f in dataclasses.fields(x)))
    raise _Unkeyable(type(x).__name__)


def _table_names(plan) -> list[str]:
    names: set[str] = set()

    def walk(n):
        if isinstance(n, (S.TableScan, S.IndexScan)):
            names.add(n.table)
        for f in ("input", "probe", "build"):
            c = getattr(n, f, None)
            if c is not None:
                walk(c)
        for c in getattr(n, "inputs", ()) or ():
            walk(c)

    walk(plan)
    return sorted(names)


def _dict_gen(catalog, plan) -> tuple:
    """Per-table string-dictionary generations (column -> value count).
    Built operators capture dictionary SNAPSHOTS (flow/operators.py
    _wire_source_metadata), so an INSERT that mints a new string value
    must re-key the plan — decoding through the stale snapshot would
    mislabel the new codes. Row-count changes alone keep hitting."""
    return _dict_gen_for(catalog, _table_names(plan))


def _dict_gen_for(catalog, names) -> tuple:
    out = []
    for name in names:
        t = catalog.tables.get(name)
        if t is None:
            continue
        d = t.dictionaries  # KVTable property returns fresh snapshots
        out.append((name, tuple(sorted(
            (c, len(dd.values)) for c, dd in d.items()))))
    return tuple(out)


def _settings_sig() -> tuple:
    """Current values of every registered setting. Conservative: ANY
    settings change re-keys the cache (a stale tile size or fusion mode
    must never serve), at the cost of misses on unrelated toggles."""
    reg = settings.all_settings()
    return tuple((n, str(reg[n].get())) for n in sorted(reg))


# the share of the card's memory the cached plans may hold (each entry's
# spools, graph buffers and build-side tables): the rest is the working
# memory of the query that runs
MAX_DEVICE_FRACTION = 0.5


_PKG = __name__.split(".")[0]


def _boundary_types() -> tuple:
    """Objects an entry's walk does not enter: what the catalog, the
    store, the memory monitors and the shared kernel wrappers own (a
    wrapper keeps the graphs of every entry that shares it; an entry's
    own graphs are counted from ``_Entry.graphs``)."""
    from ..catalog import Catalog, Table
    from ..flow import dispatch
    from ..flow.memory import BytesMonitor
    from ..kv import DB
    from ..kv.table import KVTable, _TableDict
    from ..storage.lsm import Engine

    # a KV table's string dictionaries hold no tensor, and millions of
    # host strings at TPC-H scale: the walk of the catalog skips them
    return (Catalog, Table, KVTable, _TableDict, Engine, DB, BytesMonitor,
            dispatch._Kernel, PlanCache, _Entry)


def _storages(roots, boundary: tuple, out: dict) -> dict:
    """Add to `out` (storage address -> bytes) every tensor reachable from
    `roots` through containers and the port's own objects, not entering
    `boundary` instances below the roots; functions, modules and foreign
    objects are not entered either."""
    seen: set[int] = set()
    stack = list(roots)
    top = {id(r) for r in roots}
    while stack:
        x = stack.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            n = st.nbytes()
            if n:
                out[st.data_ptr()] = n
            continue
        if isinstance(x, (list, tuple, set, frozenset, deque)):
            stack.extend(x)
            continue
        if isinstance(x, dict):
            stack.extend(x.values())
            continue
        if (isinstance(x, (type, types.ModuleType, types.FunctionType,
                           types.MethodType, weakref.ReferenceType))
                or not type(x).__module__.startswith(_PKG)
                or (isinstance(x, boundary) and id(x) not in top)):
            continue
        d = getattr(x, "__dict__", None)
        if d is not None:
            stack.extend(d.values())
        for cls in type(x).__mro__:
            for name in getattr(cls, "__slots__", ()):
                v = getattr(x, name, None)
                if v is not None:
                    stack.append(v)
    return out


def _held_storages(entry, catalog) -> dict:
    """Storage address -> bytes of what `entry` keeps between runs: its
    tree and parameters, and its graphs' static inputs and outputs, less
    the storages of the catalog's tables."""
    boundary = _boundary_types()
    held: dict = {}
    roots = [entry.root, entry.store]
    for _, _, gref in entry.graphs:
        g = gref()
        if g is not None:
            roots += [g.static_in, g.outs]
    _storages(roots, boundary, held)
    if catalog is not None and held:
        owned = _storages(list(catalog.tables.values()), boundary, {})
        for ptr in owned:
            held.pop(ptr, None)
    return held


def _device_capacity(device) -> int | None:
    """The card's memory in bytes; None off the card (no byte bound)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory


class _Entry:
    __slots__ = ("root", "store", "version", "fingerprint", "lock", "hits",
                 "bytes", "storages", "key", "graphs", "pinned")

    # the lock serializes the sessions that run this entry's tree, whose
    # operators hold pull state; runs of different trees on one device
    # are serialized below it, by flow/dispatch.exec_lock

    def __init__(self, root, store, version, fingerprint, key=None):
        self.root = root
        self.store = store
        self.version = version
        self.fingerprint = fingerprint
        self.key = key
        self.lock = threading.Lock()
        self.hits = 0
        # what the tree holds between runs (``_held_storages``, counted
        # under flow/dispatch.exec_lock after its first run and after any
        # run that made a new signature): storage address -> bytes, and
        # their sum
        self.storages: dict = {}
        self.bytes = 0
        # the graphs its runs captured (dispatch.recording_graphs):
        # released with the entry, since shared wrappers keep them
        self.graphs: list = []
        # kept by the warm menu (``keep_cached``): evicted last
        self.pinned = False


class PlanCache:
    """Size-capped LRU of built plans, one per Catalog (``cache_for``).
    ``hits``/``misses`` counters are per-cache (tests); the process
    metrics (sql_plan_cache_*) aggregate across catalogs."""

    def __init__(self, device="cpu", catalog=None):
        self.device = torch.device(device)
        self._catalog = (None if catalog is None
                         else weakref.ref(catalog))
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self._texts: OrderedDict = OrderedDict()  # fingerprint -> last text
        self._memo: OrderedDict = OrderedDict()   # exact text -> (key, values)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # storage address -> [bytes, entries holding it], over the cached
        # entries; ``bytes`` sums each storage once
        self._refs: dict = {}
        self.bytes = 0

    def catalog(self):
        return None if self._catalog is None else self._catalog()

    def lookup(self, key):
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                metric.PLAN_CACHE_MISSES.inc()
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            e.hits += 1
            metric.PLAN_CACHE_HITS.inc()
            return e

    def peek(self, key):
        with self._lock:
            return self._entries.get(key)

    def budget(self) -> int | None:
        """Device bytes the entries may hold; None off the card."""
        cap = _device_capacity(self.device)
        if cap is None:
            return None
        return int(cap * MAX_DEVICE_FRACTION)

    def insert(self, key, entry) -> "_Entry":
        """Publish `entry`, then drop least recently used entries while the
        cache is over its count or its byte budget (an entry over the
        budget alone is dropped too: it ran, but is not kept). A session
        that lost the race to publish has its own entry released. Under
        ``keep_cached`` no other entry is dropped: an entry that does not
        fit is not kept."""
        with self._lock:
            cur = self._entries.get(key)
            if cur is not None:
                dropped = [entry]  # concurrent first executions: first wins
            elif _keeping.active and not self._fits(entry, 1):
                _keeping.refused = True
                dropped = [entry]
                cur = entry
            else:
                entry.key = key
                entry.pinned = _keeping.active
                self._entries[key] = entry
                self._hold(entry.storages)
                dropped = self._trim()
                cur = entry
        _release(dropped)
        return cur

    def account(self, entry, held: dict) -> None:
        """A run of `entry` left it holding the storages `held` (address
        -> bytes). An entry dropped while it was looked up and run is
        released again (its run may have captured graphs); one not yet
        published only takes the count."""
        with self._lock:
            cached = (entry.key is not None
                      and self._entries.get(entry.key) is entry)
            if cached:
                self._unhold(entry.storages)
            entry.storages = held
            entry.bytes = sum(held.values())
            if cached:
                self._hold(held)
                self._entries.move_to_end(entry.key)
                if _keeping.active and not self._fits(None, 0):
                    _keeping.refused = True
                    dropped = [self._drop(entry.key)]
                else:
                    dropped = self._trim()
            elif entry.key is None:
                dropped = []
            else:
                dropped = [entry]
        _release(dropped)

    def _hold(self, storages: dict) -> None:
        for ptr, n in storages.items():
            r = self._refs.get(ptr)
            if r is None:
                self._refs[ptr] = [n, 1]
                self.bytes += n
            else:
                r[1] += 1

    def _unhold(self, storages: dict) -> None:
        for ptr in storages:
            r = self._refs.get(ptr)
            if r is None:
                continue
            r[1] -= 1
            if r[1] == 0:
                del self._refs[ptr]
                self.bytes -= r[0]

    def _fits(self, entry, extra: int) -> bool:
        """Whether the cache, with `entry` added (its storages not yet
        held) and `extra` more entries, stays within its count and byte
        budget (caller holds the lock)."""
        if len(self._entries) + extra > int(
                settings.get("sql.plan_cache.size")):
            return False
        budget = self.budget()
        if budget is None:
            return True
        new = 0 if entry is None else sum(
            n for p, n in entry.storages.items() if p not in self._refs)
        return self.bytes + new <= budget

    def _trim(self) -> list:
        """Drop least recently used entries past the count or the byte
        budget, the warm menu's last (caller holds the lock); returns
        them for ``_release``."""
        cap = int(settings.get("sql.plan_cache.size"))
        budget = self.budget()

        def over() -> bool:
            return len(self._entries) > cap or (
                budget is not None and self.bytes > budget)

        out = []
        for key in [k for k, e in self._entries.items() if not e.pinned]:
            if not over():
                break
            out.append(self._drop(key))
        while self._entries and over():
            out.append(self._drop(next(iter(self._entries))))
        return out

    def _drop(self, key) -> "_Entry":
        e = self._entries.pop(key)
        self._unhold(e.storages)
        self.evictions += 1
        metric.PLAN_CACHE_EVICTIONS.inc()
        return e

    def invalidate(self, version: int) -> int:
        """Eagerly drop entries built against a dead catalog version
        (DDL). Version is part of the key, so stale entries could never
        HIT again — this sweep just frees them immediately."""
        with self._lock:
            dead = [self._drop(k) for k, e in list(self._entries.items())
                    if e.version != version]
            self._memo.clear()
        _release(dead)
        return len(dead)

    def clear(self) -> None:
        with self._lock:
            dropped = list(self._entries.values())
            self._entries.clear()
            self._memo.clear()
            self._refs.clear()
            self.bytes = 0
        _release(dropped)

    def entries(self) -> list:
        """The cached entries, least recently used first."""
        with self._lock:
            return list(self._entries.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- exact-text memo (skips parse/bind/optimize on verbatim repeats) --

    _MEMO_CAP = 512

    def memo_get(self, text):
        with self._lock:
            v = self._memo.get(text)
            if v is not None:
                self._memo.move_to_end(text)
            return v

    def memo_put(self, text, key, values, tables) -> None:
        with self._lock:
            self._memo[text] = (key, values, tables)
            self._memo.move_to_end(text)
            while len(self._memo) > self._MEMO_CAP:
                self._memo.popitem(last=False)

    # -- warmup bookkeeping ----------------------------------------------

    _TEXT_CAP = 256

    def note_text(self, fingerprint: str, text: str) -> None:
        with self._lock:
            self._texts[fingerprint] = text
            self._texts.move_to_end(fingerprint)
            while len(self._texts) > self._TEXT_CAP:
                self._texts.popitem(last=False)

    def hot_texts(self, limit: int = 32) -> list[str]:
        """Recorded statement texts for the hottest fingerprints, by the
        sqlstats execution counts (sql/sqlstats.py)."""
        from . import sqlstats

        with self._lock:
            texts = dict(self._texts)
        counts = {s.fingerprint: s.count for s in sqlstats.DEFAULT.all()}
        order = sorted(texts, key=lambda fp: -counts.get(fp, 0))
        return [texts[fp] for fp in order[:limit]]


def cache_for(catalog) -> PlanCache:
    pc = getattr(catalog, "_plan_cache", None)
    if pc is None:
        pc = catalog._plan_cache = PlanCache(catalog.device, catalog)
    return pc


class _Keeping(threading.local):
    active = False
    refused = False


_keeping = _Keeping()


@contextlib.contextmanager
def keep_cached():
    """Within the block, this thread's statements evict no cached entry:
    an entry that would push the cache past its count or byte budget is
    not kept (the warm menu's bound: it never evicts what it warmed).
    Yields the thread's record; ``refused`` is set when an entry was not
    kept."""
    saved = (_keeping.active, _keeping.refused)
    _keeping.active, _keeping.refused = True, False
    try:
        yield _keeping
    finally:
        _keeping.active, _keeping.refused = saved


def _release(entries) -> None:
    """Free what dropped entries hold on the device: their graphs leave
    the shared wrappers, and a collection frees their trees (operator
    trees hold reference cycles), both while no query runs."""
    entries = [e for e in entries if e.graphs or e.bytes]
    if not entries:
        return
    from ..flow import dispatch

    with dispatch.exec_lock():
        for e in entries:
            dispatch.release_graphs(e.graphs)
        gc.collect()


def _run_entry(cache, entry, values, label: str):
    """Run a built entry with `values` bound: its lock, then the device
    (flow/dispatch.exec_lock) for the run and the count of what the entry
    holds after it (``_held_storages``), which `cache` is charged. A run
    that made no new signature left its tree's buffers as they were, so
    its entry keeps its count."""
    from ..flow import dispatch, runtime

    with entry.lock, dispatch.exec_lock(), \
            dispatch.recording_graphs(entry.graphs):
        c0 = dispatch.thread_compiles()
        entry.store.set_values(values)
        with tracing.leaf_span("query", cache=label):
            res = runtime.run_operator(entry.root)
        if entry.storages and dispatch.thread_compiles() == c0:
            return res
        held = _held_storages(entry, cache.catalog())
    cache.account(entry, held)
    return res


# -- the serving path --------------------------------------------------------


def _cacheable() -> bool:
    return settings.get("sql.plan_cache.enabled")


_VOLATILE = ("now(", "current_date", "current_timestamp")


def _is_virtual_plan(plan) -> bool:
    from . import crdb_internal

    return any(crdb_internal.is_virtual(n) for n in _table_names(plan))


def run_cached_ex(rel, text: str | None = None, projections: bool = False):
    """Execute a bound Rel through the plan cache (with `projections`,
    Project literals become parameters too: see ``parameterize``).

    Returns ``(results, status, fingerprint)`` with status one of ``hit``
    (literals rebound into a cached tree, zero new builds), ``miss``
    (built fresh and cached), ``uncacheable`` (no stable key), ``bypass``
    (cache off, stats collection on, or crdb_internal virtual tables —
    those materialize fresh per statement, so a cached plan would freeze
    a snapshot). ``fingerprint`` is the serving entry's structural
    fingerprint (the first text that built it — sqlstats uses it so
    literal variants collapse to one row), or '' when no entry served."""
    from ..flow import dispatch, runtime

    if not _cacheable():
        return rel.run(), "bypass", ""
    cache = cache_for(rel.catalog)
    plan = rel.optimized_plan()
    if _is_virtual_plan(plan):
        return runtime.run_plan(plan, rel.catalog), "bypass", ""
    try:
        with tracing.leaf_span("sql.plancache.lookup"):
            pplan, values, types = parameterize(plan, projections)
            key = (plan_key(pplan), rel.catalog.version, _settings_sig(),
                   _dict_gen(rel.catalog, pplan))
            entry = cache.lookup(key)
    except _Unkeyable:
        return runtime.run_plan(plan, rel.catalog), "uncacheable", ""
    status = "hit"
    if entry is None:
        status = "miss"
        # run BEFORE publishing: a plan whose first execution fails never
        # enters the cache (concurrent first executions may both build;
        # insert keeps whichever published first)
        with dispatch.exec_lock():
            store = ParamStore(types, rel.catalog.device)
            root = plan_builder.build(pplan, rel.catalog, params=store)
            entry = _Entry(root, store, rel.catalog.version,
                           _fingerprint(text))
            try:
                res = _run_entry(cache, entry, values, "miss")
            except BaseException:
                _release([entry])
                raise
        entry = cache.insert(key, entry)
    else:
        res = _run_entry(cache, entry, values, "hit")
        if entry.fingerprint:
            from . import warmmenu

            warmmenu.note_serving_hit(entry.fingerprint)
    if text is not None:
        if entry.fingerprint:
            cache.note_text(entry.fingerprint, text)
        low = text.lower()
        if not any(tok in low for tok in _VOLATILE):
            # verbatim repeats can skip parse/bind next time; statements
            # with per-bind folded volatiles (now()) must re-bind
            cache.memo_put(text, key, values, tuple(_table_names(pplan)))
    return res, status, entry.fingerprint


def run_memoized_ex(catalog, text: str):
    """Exact-text fast path: if this verbatim statement ran before and
    its entry is still live (same catalog version + settings), execute it
    without parsing or binding. Returns (results, entry fingerprint) or
    None (fall through to the normal path)."""
    if not _cacheable():
        return None
    cache = cache_for(catalog)
    m = cache.memo_get(text)
    if m is None:
        return None
    key, values, tables = m
    # key embeds (version, settings sig, dict gens); ALL must still hold
    # — the entry itself may still live under the old key, so a stale
    # dictionary generation has to be rejected here, not left to lookup
    if (key[1] != catalog.version or key[2] != _settings_sig()
            or key[3] != _dict_gen_for(catalog, tables)):
        return None
    entry = cache.lookup(key)
    if entry is None:
        return None
    if entry.fingerprint:
        # the memo path is a plan-cache hit too
        from . import warmmenu

        warmmenu.note_serving_hit(entry.fingerprint)
    return _run_entry(cache, entry, values, "memo"), entry.fingerprint


def probe(rel) -> str:
    """Cache status a statement WOULD see, without executing — the
    EXPLAIN ANALYZE "plan cache:" line (stats collection itself always
    runs the instrumented fresh tree)."""
    if not settings.get("sql.plan_cache.enabled"):
        return "disabled"
    if _is_virtual_plan(rel.optimized_plan()):
        return "uncacheable"
    try:
        pplan, _, _ = parameterize(rel.optimized_plan())
        key = (plan_key(pplan), rel.catalog.version, _settings_sig(),
               _dict_gen(rel.catalog, pplan))
    except _Unkeyable:
        return "uncacheable"
    hit = cache_for(rel.catalog).peek(key) is not None
    return "hit" if hit else "miss"


def _fingerprint(text: str | None) -> str:
    if text is None:
        return ""
    from . import sqlstats

    return sqlstats.fingerprint(text)


# -- background pre-warming --------------------------------------------------


def start_warmup(session, statements=None) -> threading.Thread | None:
    """Re-execute hot statements on a background session so their plans
    and kernel specializations are compiled OFF the serving path (after
    process start or a DDL invalidation). Gated on
    ``sql.plan_cache.warmup.enabled``; returns the daemon thread (join it
    in tests) or None when disabled / nothing to warm.

    Replaying the hottest recorded statement texts warms every level at
    once: the plan cache entry and each function's CUDA graph at its
    current canonical tile shape (catalog.SHAPE_BUCKETS keeps that menu
    small). On the card the warmup's runs take flow/dispatch.exec_lock
    like any session's, so they never share a graph's buffers.

    Lifecycle: the thread checks a stop event between statements and the
    owning session joins it in ``close()`` (via :func:`stop_warmup`), so
    a warmup racing server shutdown stops at the next statement boundary
    instead of executing against a torn-down store — the no-leak census
    asserts no ``plan-warmup`` thread survives teardown. Re-invalidation
    (back-to-back DDL) stops the previous warmup before starting the
    next, so at most one warmup thread exists per session."""
    if not settings.get("sql.plan_cache.warmup.enabled"):
        return None
    texts = (list(statements) if statements is not None
             else cache_for(session.catalog).hot_texts())
    if not texts:
        return None
    from .session import Session

    # one warmup per session: a DDL burst must not stack threads
    stop_warmup(session)
    # a PRIVATE session over the shared catalog/store: the warmup thread
    # must never touch the serving session's transaction state
    bg = Session(catalog=session.catalog, db=session.db, bootstrap=False,
                 device=session.catalog.device)
    stop = threading.Event()

    def _run():
        try:
            for t in texts:
                if stop.is_set():
                    return
                try:
                    # twice: the first execution compiles; the second
                    # settles adaptive capacities (join emission caps learn
                    # from run 1 and re-specialize once), so the SERVING
                    # repeat is pure dispatch — scripts/check_recompiles.py
                    # holds it to zero
                    bg.execute(t)
                    if stop.is_set():
                        return
                    bg.execute(t)
                except Exception:  # noqa: BLE001 — warmup is best-effort
                    continue
        finally:
            bg.close()

    th = threading.Thread(target=_run, name="plan-warmup", daemon=True)
    session._warmup_stop = stop
    session._warmup_thread = th
    th.start()
    return th


def stop_warmup(session, timeout: float = 5.0) -> None:
    """Signal and join the session's warmup thread (idempotent; no-op
    when none is running). Called from Session.close() and before a new
    warmup replaces a running one."""
    th = getattr(session, "_warmup_thread", None)
    if th is None:
        return
    stop = getattr(session, "_warmup_stop", None)
    if stop is not None:
        stop.set()
    if th is not threading.current_thread():
        th.join(timeout=timeout)
    session._warmup_thread = None
    session._warmup_stop = None
