"""shared-state pass: whole-program race detection for the control plane.

The threaded control plane (RPC accept/conn loops, lease/liveness loops,
gossip, changefeed handshakes, the metrics scraper, the plan-cache warmup
thread, per-consumer spool pulls) shares mutable state with the serving
path. Go-side CockroachDB runs every test under TSan; this pass is the
static half of our analogue (utils/racesan.py is the runtime half):

1. enumerate **thread entry points**: ``threading.Thread(target=f)`` /
   ``Timer`` / ``executor.submit(f)`` targets, including nested ``def``
   closures handed to Thread and one level of *spawn brokers* (a function
   that passes its own parameter as a Thread target — ``Node._spawn`` —
   makes every resolvable argument at its call sites an entry);
2. build the cross-module call graph (same resolution as the lock-order
   pass: ``self.m()``, module functions, package imports — plus
   attribute-type inference: ``self.liveness = NodeLiveness(...)`` in
   ``__init__`` lets ``self.liveness.heartbeat()`` resolve), and close
   reachability from every entry;
3. record every **mutable-state access** — ``self.attr`` writes (rebind,
   augmented, subscript store/del, known mutator-method calls) and reads,
   plus module-global rebinds/mutations — with the lock set held at the
   site (with-stack locks plus *always-held* locks inferred over the
   call graph: a method only ever called under ``self.mu`` is guarded);
4. flag state with a write/write or write/read pair reachable from two
   DIFFERENT entry points (the main thread counts as one) whose locksets
   are disjoint.

Not flagged (the documented-safe patterns):

- construction: accesses inside ``__init__``/``__post_init__``/``__new__``
  happen before the object is published to any thread;
- **GIL-atomic publish**: state whose every non-init write is a plain
  ``self.x = value`` rebind where ``value`` never reads ``self.x`` (no
  read-modify-write, no container mutation anywhere). A single STORE_ATTR
  is atomic under the GIL; stale reads of a flag/socket/thread handle are
  the pattern's contract (``self._srv``, ``self._thread = None``);
- lock/event objects themselves (they synchronize; they are not data);
- anything under a common recognized lock at every conflicting site.

Suppression: ``# crlint: allow-shared-state(<why>)`` on the flagged write
line, on the enclosing ``def`` line, or on ANY access site of the state —
including its ``__init__`` assignment, which is the ergonomic place to
document a deliberately lock-free structure once.

Scope: ``cockroach_tpu_torch/`` only. Test trees spawn scenario-local threads
constantly; the invariant guarded here is the production control plane.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .core import Finding, SourceFile
from .lockorder import (FuncKey, _is_lock_ctor, _ModuleIndex,
                        _resolve_imports, attr_chain)

RULE = "shared-state"

# mutating container/collection methods: a call self.x.m(...) with m here
# is a WRITE to x. Deliberately excludes queue.Queue's put/get/task_done
# (thread-safe by contract) and threading.Event's set/clear/wait.
_MUTATORS = {
    "append", "appendleft", "add", "update", "pop", "popleft", "popitem",
    "clear", "extend", "extendleft", "remove", "discard", "insert",
    "setdefault", "sort", "reverse", "rotate",
}
# constructors whose instances synchronize internally — attributes holding
# them are not data races even when poked from several threads
_THREADSAFE_CTORS = {
    ("threading", "Event"), ("threading", "Semaphore"),
    ("threading", "BoundedSemaphore"), ("threading", "Barrier"),
    ("threading", "local"), ("queue", "Queue"), ("queue", "SimpleQueue"),
    ("queue", "LifoQueue"), ("queue", "PriorityQueue"),
    ("collections", "Counter"),
}
_INIT_FUNCS = {"__init__", "__post_init__", "__new__", "__init_subclass__"}
_MAIN = "<main>"


@dataclass(frozen=True)
class Access:
    state: str          # <module>.<Class>.<attr> or <module>.<global>
    kind: str           # 'w' | 'r'
    wkind: str          # 'rebind' | 'aug' | 'store' | 'mut' | '' (reads)
    func: FuncKey
    lockset: tuple[str, ...]
    rel: str
    line: int
    rmw: bool = False   # write whose value expression reads the state
    in_init: bool = False


@dataclass
class _FnRec:
    key: FuncKey
    # callee -> list of (held locks, line, positional arg resolutions)
    calls: list = field(default_factory=list)
    accesses: list = field(default_factory=list)
    spawns: list = field(default_factory=list)  # resolved FuncKey targets
    # Thread target was one of our own parameters: (param index, name)
    broker_params: list = field(default_factory=list)
    # the function's AST (consumed by passes that re-walk reachable
    # bodies — lint/blocking.py scans these for blocking primitives)
    node: ast.AST | None = None


def _threadsafe_attr(value: ast.AST) -> bool:
    for n in ast.walk(value):
        if isinstance(n, ast.Call):
            chain = attr_chain(n.func)
            if chain and chain[-2:] in _THREADSAFE_CTORS:
                return True
    return False


class _Collector(ast.NodeVisitor):
    """One pass over a function body: accesses + calls + spawns, with the
    lock-held stack maintained exactly like lockorder._FuncWalker."""

    def __init__(self, idx: _ModuleIndex, cls: str | None,
                 imports: dict[str, str],
                 class_imports: dict[str, tuple[str, str]],
                 attr_types: dict[str, tuple[str, str]],
                 rec: _FnRec, params: list[str],
                 nested: dict[str, FuncKey],
                 out_nested: list,
                 safe_attrs: frozenset = frozenset()):
        self.idx = idx
        self.cls = cls
        self.imports = imports
        self.class_imports = class_imports
        self.attr_types = attr_types  # self-attr -> (module rel, Class)
        self.rec = rec
        self.params = params
        self.nested = nested          # local def name -> pseudo FuncKey
        self.out_nested = out_nested  # (name, node) nested defs to walk
        self.safe_attrs = safe_attrs  # attrs holding Event/Queue/... objects
        self.held: list[str] = []
        self.mod = idx.src.modname
        self.in_init = rec.key[2].split(".")[-1] in _INIT_FUNCS

    # -- naming ---------------------------------------------------------------

    def _state_of(self, expr: ast.AST) -> str | None:
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and self.cls):
            if expr.attr in self.idx.class_locks.get(self.cls, {}):
                return None  # the lock itself is not data
            if expr.attr in self.safe_attrs:
                return None  # Event/Queue/...: synchronizes internally
            return f"{self.mod}.{self.cls}.{expr.attr}"
        if isinstance(expr, ast.Name) and expr.id in self.idx.mod_globals:
            return f"{self.mod}.{expr.id}"
        return None

    def _lock_of(self, expr: ast.AST) -> str | None:
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and self.cls):
            return self.idx.class_locks.get(self.cls, {}).get(expr.attr)
        if isinstance(expr, ast.Name):
            return self.idx.mod_locks.get(expr.id)
        return None

    def _note(self, state: str, kind: str, wkind: str, node: ast.AST,
              rmw: bool = False) -> None:
        self.rec.accesses.append(Access(
            state, kind, wkind, self.rec.key, tuple(self.held),
            self.idx.src.rel, node.lineno, rmw=rmw, in_init=self.in_init))

    def _reads_state(self, state: str, expr: ast.AST) -> bool:
        for n in ast.walk(expr):
            if self._state_of(n) == state:
                return True
        return False

    # -- function references (spawn targets, broker args) ---------------------

    def _func_ref(self, expr: ast.AST) -> FuncKey | None:
        rel = self.idx.src.rel
        if isinstance(expr, ast.Name):
            if expr.id in self.nested:
                return self.nested[expr.id]
            if expr.id in self.idx.functions:
                return (rel, None, expr.id)
            return None
        if isinstance(expr, ast.Attribute) and isinstance(expr.value,
                                                          ast.Name):
            if (expr.value.id == "self" and self.cls
                    and expr.attr in self.idx.methods.get(self.cls, {})):
                return (rel, self.cls, expr.attr)
            target = self.imports.get(expr.value.id)
            if target is not None:
                return (target, None, expr.attr)
        return None

    def _callee_of(self, call: ast.Call) -> FuncKey | None:
        f = call.func
        rel = self.idx.src.rel
        direct = self._func_ref(f)
        if direct is not None:
            return direct
        # self.<attr>.<m>() through __init__-inferred attribute types
        if (isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Attribute)
                and isinstance(f.value.value, ast.Name)
                and f.value.value.id == "self"):
            typed = self.attr_types.get(f.value.attr)
            if typed is not None:
                return (typed[0], typed[1], f.attr)
        # ClassName(...) / mod.ClassName(...) constructor -> __init__
        if isinstance(f, ast.Name) and f.id in self.class_imports:
            mod_rel, cname = self.class_imports[f.id]
            return (mod_rel, cname, "__init__")
        if isinstance(f, ast.Name) and f.id in self.idx.methods:
            return (rel, f.id, "__init__")
        return None

    # -- visitors -------------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        acquired: list[str] = []
        for item in node.items:
            lock = self._lock_of(item.context_expr)
            if lock is not None:
                self.held.append(lock)
                acquired.append(lock)
            else:
                self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()

    visit_AsyncWith = visit_With

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._write_target(t, node.value)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._write_target(node.target, node.value)
            self.visit(node.value)

    def _write_target(self, t: ast.AST, value: ast.AST) -> None:
        state = self._state_of(t)
        if state is not None:
            if _is_lock_ctor(value) or _threadsafe_attr(value):
                # assigning a synchronizer: structural, not data
                self._note(state, "w", "rebind", t, rmw=False)
                return
            self._note(state, "w", "rebind", t,
                       rmw=self._reads_state(state, value))
            return
        if isinstance(t, ast.Subscript):
            st = self._state_of(t.value)
            if st is not None:
                self._note(st, "w", "store", t)
                return
        if isinstance(t, (ast.Tuple, ast.List)):
            for elt in t.elts:
                self._write_target(elt, value)
            return
        self.visit(t)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        state = self._state_of(node.target)
        if state is not None:
            self._note(state, "w", "aug", node, rmw=True)
        elif isinstance(node.target, ast.Subscript):
            st = self._state_of(node.target.value)
            if st is not None:
                self._note(st, "w", "store", node, rmw=True)
        self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                st = self._state_of(t.value)
                if st is not None:
                    self._note(st, "w", "store", t)
                    continue
            st = self._state_of(t)
            if st is not None:
                self._note(st, "w", "rebind", t)
                continue
            self.visit(t)

    def visit_Call(self, node: ast.Call) -> None:
        # spawn sites: Thread/Timer(target=...) and executor.submit(f, ...)
        chain = attr_chain(node.func)
        target_expr = None
        if (chain and chain[-1] in ("Thread", "Timer")) or (
                isinstance(node.func, ast.Name)
                and node.func.id in ("Thread", "Timer")):
            for kw in node.keywords:
                if kw.arg == "target":
                    target_expr = kw.value
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr == "submit" and node.args:
            target_expr = node.args[0]
        if target_expr is not None:
            ref = self._func_ref(target_expr)
            if ref is not None:
                self.rec.spawns.append(ref)
            elif (isinstance(target_expr, ast.Name)
                    and target_expr.id in self.params):
                self.rec.broker_params.append(
                    self.params.index(target_expr.id))

        # mutator-method write: self.x.append(...)
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
            st = self._state_of(f.value)
            if st is not None:
                self._note(st, "w", "mut", node)
                for a in node.args:
                    self.visit(a)
                for kw in node.keywords:
                    self.visit(kw.value)
                return

        callee = self._callee_of(node)
        if callee is not None:
            arg_refs = [self._func_ref(a) for a in node.args]
            self.rec.calls.append(
                (callee, tuple(self.held), node.lineno, arg_refs))
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.ctx, ast.Load):
            st = self._state_of(node)
            if st is not None:
                self._note(st, "r", "", node)
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load):
            st = self._state_of(node)
            if st is not None:
                self._note(st, "r", "", node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # nested defs are separate pseudo-functions (thread closures!):
        # queue them for their own Collector run under the same class
        self.out_nested.append((node.name, node))

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass  # runs later under unknown held state


def _safe_attrs(src: SourceFile) -> dict[str, frozenset]:
    """class -> self-attrs assigned a thread-safe synchronizer ctor
    (Event, Queue, Semaphore ...) anywhere in the class body. Like locks,
    these coordinate threads; their method calls are not data accesses."""
    out: dict[str, frozenset] = {}
    for node in src.tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        attrs: set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and _threadsafe_attr(sub.value):
                for t in sub.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        attrs.add(t.attr)
        out[node.name] = frozenset(attrs)
    return out


def _mod_globals(src: SourceFile, idx: _ModuleIndex) -> set[str]:
    """Module-level names that some function-scope code REBINDs (via
    ``global``) or that hold a module-level mutable literal mutated
    in functions. Names bound to locks are excluded (they guard)."""
    declared: set[str] = set()
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Global):
            declared.update(node.names)
    # module-level mutable containers (dict/list/set literals)
    for node in src.tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
            value = node.value
        else:
            continue
        if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                              ast.DictComp, ast.SetComp)) or (
                isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)
                and value.func.id in ("dict", "list", "set", "deque")):
            for t in targets:
                if isinstance(t, ast.Name):
                    declared.add(t.id)
    declared -= set(idx.mod_locks)
    return declared


def _class_imports(src: SourceFile, files_by_rel: dict[str, SourceFile],
                   indexes: dict[str, "_ModuleIndex"],
                   ) -> dict[str, tuple[str, str]]:
    """alias -> (module rel, ClassName) for package-internal class
    imports (``from .lsm import Engine``)."""
    out: dict[str, tuple[str, str]] = {}
    pkg_dir = "/".join(src.rel.split("/")[:-1])
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.ImportFrom):
            continue
        base_parts = pkg_dir.split("/")
        if node.level:
            base_parts = base_parts[:len(base_parts) - (node.level - 1)]
            base = "/".join(base_parts)
            mod = (base + "/" + node.module.replace(".", "/")
                   if node.module else base)
        else:
            mod = (node.module or "").replace(".", "/")
        cand = f"{mod}.py"
        idx = indexes.get(cand)
        if idx is None:
            continue
        for a in node.names:
            if a.name in idx.methods:
                out[a.asname or a.name] = (cand, a.name)
    return out


def _attr_types(cls_node_methods: dict[str, ast.FunctionDef],
                idx: _ModuleIndex,
                class_imports: dict[str, tuple[str, str]],
                rel: str) -> dict[str, tuple[str, str]]:
    """self.attr -> (module rel, Class) inferred from ``self.x = C(...)``
    assignments anywhere in the class (``__init__`` dominates)."""
    out: dict[str, tuple[str, str]] = {}
    for meth in cls_node_methods.values():
        for node in ast.walk(meth):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            f = node.value.func
            typed = None
            if isinstance(f, ast.Name):
                if f.id in class_imports:
                    typed = class_imports[f.id]
                elif f.id in idx.methods:
                    typed = (rel, f.id)
            if typed is None:
                continue
            for t in node.targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    out.setdefault(t.attr, typed)
    return out


def _analyze(files: list[SourceFile], cache=None):
    """Whole-program collection: returns (funcs, entries)."""
    known = {f.rel for f in files}
    files_by_rel = {f.rel: f for f in files}
    indexes: dict[str, _ModuleIndex] = {}
    for f in files:
        if cache is not None:
            idx = cache.index(f)
        else:
            idx = _ModuleIndex(f)
            idx.mod_globals = _mod_globals(f, idx)
        indexes[f.rel] = idx

    funcs: dict[FuncKey, _FnRec] = {}

    def walk_fn(idx: _ModuleIndex, cls: str | None, name: str,
                node: ast.FunctionDef, imports, class_imports, attr_types,
                safe):
        rec = _FnRec((idx.src.rel, cls, name), node=node)
        params = [a.arg for a in node.args.args
                  if a.arg not in ("self", "cls")]
        nested_defs: list = []
        # pre-scan direct children so references resolve forward too
        nested_names = {n.name: (idx.src.rel, cls, f"{name}.{n.name}")
                        for n in ast.walk(node)
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and n is not node}
        col = _Collector(idx, cls, imports, class_imports, attr_types,
                         rec, params, nested_names, nested_defs, safe)
        col.generic_visit(node)
        funcs[rec.key] = rec
        for sub_name, sub_node in nested_defs:
            walk_fn(idx, cls, f"{name}.{sub_name}", sub_node,
                    imports, class_imports, attr_types, safe)

    for f in files:
        idx = indexes[f.rel]
        imports = _resolve_imports(f, known)
        class_imports = _class_imports(f, files_by_rel, indexes)
        safe_by_cls = _safe_attrs(f)
        for name, node in idx.functions.items():
            walk_fn(idx, None, name, node, imports, class_imports, {},
                    frozenset())
        for cls, meths in idx.methods.items():
            atypes = _attr_types(meths, idx, class_imports, f.rel)
            for name, node in meths.items():
                walk_fn(idx, cls, name, node, imports, class_imports,
                        atypes, safe_by_cls.get(cls, frozenset()))

    # spawn entries: direct targets + one level of broker indirection
    entries: set[FuncKey] = set()
    brokers: dict[FuncKey, list[int]] = {}
    for key, rec in funcs.items():
        entries.update(rec.spawns)
        if rec.broker_params:
            brokers[key] = rec.broker_params
    for rec in funcs.values():
        for callee, _held, _line, arg_refs in rec.calls:
            for pidx in brokers.get(callee, ()):
                if pidx < len(arg_refs) and arg_refs[pidx] is not None:
                    entries.add(arg_refs[pidx])
    entries &= set(funcs)  # only entries we can see the body of
    return funcs, entries


def _reach(funcs: dict[FuncKey, _FnRec],
           roots: set[FuncKey]) -> dict[FuncKey, set[FuncKey]]:
    """root -> set of functions transitively callable from it."""
    adj: dict[FuncKey, list[FuncKey]] = {
        k: [c for c, _h, _l, _a in rec.calls if c in funcs]
        for k, rec in funcs.items()}
    out: dict[FuncKey, set[FuncKey]] = {}
    for root in roots:
        seen = {root}
        frontier = [root]
        while frontier:
            cur = frontier.pop()
            for nxt in adj.get(cur, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        out[root] = seen
    return out


def _always_held(funcs: dict[FuncKey, _FnRec],
                 entries: set[FuncKey]) -> dict[FuncKey, frozenset]:
    """Locks held at EVERY call site of a function (interprocedural guard
    inference, decreasing fixpoint). Entries and uncalled functions hold
    nothing on entry."""
    callers: dict[FuncKey, list[tuple[FuncKey, tuple[str, ...]]]] = {}
    for key, rec in funcs.items():
        for callee, held, _line, _args in rec.calls:
            if callee in funcs:
                callers.setdefault(callee, []).append((key, held))
    universe = frozenset(
        lock for rec in funcs.values()
        for a in rec.accesses for lock in a.lockset) | frozenset(
        lock for rec in funcs.values()
        for _c, held, _l, _a in rec.calls for lock in held)
    ah: dict[FuncKey, frozenset] = {}
    for key in funcs:
        if key in entries or key not in callers:
            ah[key] = frozenset()
        else:
            ah[key] = universe
    changed = True
    while changed:
        changed = False
        for key, sites in callers.items():
            if key in entries:
                continue
            new = None
            for caller, held in sites:
                locks_here = frozenset(held) | ah[caller]
                new = locks_here if new is None else (new & locks_here)
            if new is not None and new != ah[key]:
                ah[key] = new
                changed = True
    return ah


@dataclass
class Program:
    """The whole-program thread analysis, computed once per lint run and
    shared (via ``core.TreeCache``) by every graph pass: shared-state,
    untimed-wait (lint/blocking.py) and race-coverage
    (lint/racecoverage.py)."""

    funcs: dict          # FuncKey -> _FnRec
    entries: set         # thread entry points (spawn targets + brokers)
    reach: dict          # entry -> transitively reachable FuncKeys
    ah: dict             # FuncKey -> locks held at every call site
    main_reach: set      # reachable from uncalled non-entry roots
    _ent_memo: dict = field(default_factory=dict)

    def entries_of(self, func: FuncKey) -> frozenset:
        """Entry points (thread roots + ``<main>``) this function runs
        under."""
        hit = self._ent_memo.get(func)
        if hit is None:
            e = {root for root in self.entries if func in self.reach[root]}
            if func in self.main_reach:
                e.add(_MAIN)
            hit = self._ent_memo[func] = frozenset(e)
        return hit

    def thread_funcs(self) -> set:
        """Every function reachable from some thread entry point."""
        out: set = set()
        for seen in self.reach.values():
            out |= seen
        return out

    def lockset(self, a: Access) -> frozenset:
        return frozenset(a.lockset) | self.ah.get(a.func, frozenset())


def program(files: list[SourceFile], cache=None) -> Program | None:
    """Whole-program analysis over the ``cockroach_tpu_torch/`` subset of
    ``files`` (None when it is empty). Memoized on ``cache`` so the
    three graph passes pay for one analysis, not three."""
    def build():
        scoped = [f for f in files if f.rel.startswith("cockroach_tpu_torch/")]
        if not scoped:
            return None
        funcs, entries = _analyze(scoped, cache)
        reach = _reach(funcs, entries)
        ah = _always_held(funcs, entries)
        # main-reachable: functions nobody in-package calls (public API /
        # test surface) that are not thread targets, plus all they reach
        called: set[FuncKey] = set()
        for rec in funcs.values():
            for callee, _h, _l, _a in rec.calls:
                called.add(callee)
        main_roots = {k for k in funcs
                      if k not in called and k not in entries}
        main_reach: set[FuncKey] = set()
        for _root, seen in _reach(funcs, main_roots).items():
            main_reach |= seen
        return Program(funcs, entries, reach, ah, main_reach)
    if cache is not None:
        return cache.memo("sharedstate.program", build)
    return build()


def analyze_shared_state(files: list[SourceFile], cache=None):
    """Returns (conflicts, entries) where conflicts maps a state id to the
    offending (write_access, other_access, entry_a, entry_b) tuple plus
    all access sites — consumed by check() and by tooling that wants the
    objects the pass names (utils/racesan.py's instrumentation list)."""
    prog = program(files, cache)
    if prog is None:
        return {}, set()
    funcs, entries, ah = prog.funcs, prog.entries, prog.ah

    def entries_of(func: FuncKey) -> frozenset:
        return prog.entries_of(func)

    # group accesses by state
    by_state: dict[str, list[Access]] = {}
    for rec in funcs.values():
        for a in rec.accesses:
            by_state.setdefault(a.state, []).append(a)

    conflicts: dict[str, dict] = {}
    for state, accesses in sorted(by_state.items()):
        live = [a for a in accesses if not a.in_init]
        writes = [a for a in live if a.kind == "w"]
        if not writes:
            continue
        # GIL-atomic publish: plain rebinds only, never read-modify-write
        if all(w.wkind == "rebind" and not w.rmw for w in writes):
            continue
        ent_cache: dict[FuncKey, frozenset] = {}

        def ent(a: Access) -> frozenset:
            if a.func not in ent_cache:
                ent_cache[a.func] = entries_of(a.func)
            return ent_cache[a.func]

        def lockset(a: Access) -> frozenset:
            return frozenset(a.lockset) | ah.get(a.func, frozenset())

        hit = None
        for w in writes:
            ew = ent(w)
            if not ew:
                continue
            for a in live:
                if a.kind == "r" and a is w:
                    continue
                ea = ent(a)
                cross = {(x, y) for x in ew for y in ea if x != y}
                if not cross:
                    continue
                if lockset(w) & lockset(a):
                    continue
                if w.kind == "r" and a.kind == "r":
                    continue
                pair = min(cross, key=lambda p: (str(p[0]), str(p[1])))
                hit = (w, a, *sorted(pair, key=str))
                break
            if hit:
                break
        if hit:
            conflicts[state] = {
                "pair": hit, "accesses": accesses,
                "locksets": (lockset(hit[0]), lockset(hit[1])),
            }
    return conflicts, entries


def _fmt_entry(e) -> str:
    if e == _MAIN:
        return "main"
    rel, cls, name = e
    return f"thread:{rel.rsplit('/', 1)[-1]}:{(cls + '.') if cls else ''}" \
           f"{name}"


def check(files: list[SourceFile], cache=None) -> list[Finding]:
    conflicts, _entries = analyze_shared_state(files, cache)
    by_rel = {f.rel: f for f in files}
    out: list[Finding] = []
    for state, info in sorted(conflicts.items()):
        w, a, e1, e2 = info["pair"]
        ls_w, ls_a = info["locksets"]
        # state-wide pragma: a waiver on ANY access site (incl. the
        # __init__ assignment) documents the whole structure once
        waived = False
        for acc in info["accesses"]:
            src = by_rel.get(acc.rel)
            if src is not None and src.allows(RULE, acc.line):
                waived = True
                break
        if waived:
            continue
        def _ls(ls: frozenset) -> str:
            return "{" + ", ".join(sorted(ls)) + "}" if ls else "no locks"
        out.append(Finding(
            RULE, w.rel, w.line,
            f"{state} is written here ({w.wkind}, {_ls(ls_w)}) on "
            f"[{_fmt_entry(e1)}] and "
            f"{'written' if a.kind == 'w' else 'read'} at "
            f"{a.rel}:{a.line} ({_ls(ls_a)}) on [{_fmt_entry(e2)}] with "
            "no common lock — guard both sites with one utils/locks "
            "OrderedLock, restructure to a GIL-atomic publish, or "
            "pragma-waive the documented pattern"))
    return out
