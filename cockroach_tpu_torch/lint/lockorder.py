"""lock-order pass: the cross-module lock acquisition graph must be acyclic.

The distributed plane holds locks across module boundaries — DistSender's
``mu`` wraps lease checks that read liveness records, queue processing
takes range locks while the allocator scans — and the lease-guard work
already hit one real near-deadlock (the sender-lock/intent-wait cycle
a lease-guard lock held across an intent wait). This pass makes the discipline structural:

1. extract every lock **definition**: ``self.x = threading.Lock()`` /
   ``RLock()`` / ``Condition()`` (incl. dataclass
   ``field(default_factory=threading.Lock)``) and the ordered wrappers
   ``locks.lock/rlock/condition(...)`` / ``OrderedLock(...)`` — named
   ``<module>.<Class>.<attr>`` or ``<module>.<name>``;
2. build the per-function **lock-held call graph**: ``with self.x:``
   bodies record which locks are acquired and which functions are called
   while x is held (``self.m()``, same-module ``f()``, and
   ``alias.f()`` through package-relative imports are resolved);
3. close acquisitions over the call graph and emit edge A->B whenever B
   is (transitively) acquired while A is held;
4. fail on any cycle — a cycle is a thread-interleaving away from
   deadlock.

Re-entrant self-edges are excluded (RLock's business, mirrored by the
runtime OrderedLock in utils/locks.py, which enforces the same invariant
dynamically under ``debug.lock_order.enabled``).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .core import Finding, SourceFile, attr_chain

RULE = "lock-order"

_LOCK_CTORS = {
    ("threading", "Lock"), ("threading", "RLock"), ("threading", "Condition"),
    ("locks", "lock"), ("locks", "rlock"), ("locks", "condition"),
}
_LOCK_CTOR_NAMES = {"OrderedLock", "OrderedRLock", "OrderedCondition"}

FuncKey = tuple[str, str | None, str]  # (module rel, class | None, func)


@dataclass
class FuncInfo:
    key: FuncKey
    # (lock id, locks held at that acquire, line)
    acquires: list[tuple[str, tuple[str, ...], int]] = field(
        default_factory=list)
    # (callee key, locks held at that call, line)
    calls: list[tuple[FuncKey, tuple[str, ...], int]] = field(
        default_factory=list)


def _is_lock_ctor(value: ast.AST) -> bool:
    for n in ast.walk(value):
        if isinstance(n, ast.Call):
            chain = attr_chain(n.func)
            if chain and chain[-2:] in _LOCK_CTORS:
                return True
            if (isinstance(n.func, ast.Name)
                    and n.func.id in _LOCK_CTOR_NAMES):
                return True
    return False


def _resolve_imports(src: SourceFile,
                     known: set[str]) -> dict[str, str]:
    """alias -> module rel for package-internal module imports."""
    out: dict[str, str] = {}
    pkg_dir = "/".join(src.rel.split("/")[:-1])
    for node in ast.walk(src.tree):
        if isinstance(node, ast.ImportFrom):
            base_parts = pkg_dir.split("/")
            if node.level:
                base_parts = base_parts[:len(base_parts) - (node.level - 1)]
                base = "/".join(base_parts)
                mod = (base + "/" + node.module.replace(".", "/")
                       if node.module else base)
            else:
                mod = (node.module or "").replace(".", "/")
            for a in node.names:
                cand = f"{mod}/{a.name}.py"
                if cand in known:
                    out[a.asname or a.name] = cand
        elif isinstance(node, ast.Import):
            for a in node.names:
                cand = a.name.replace(".", "/") + ".py"
                if cand in known:
                    out[a.asname or a.name] = cand
    return out


class _ModuleIndex:
    """Per-module symbol tables the function walker resolves against."""

    def __init__(self, src: SourceFile):
        self.src = src
        self.mod_locks: dict[str, str] = {}    # name -> lock id
        self.class_locks: dict[str, dict[str, str]] = {}  # cls -> attr -> id
        self.functions: dict[str, ast.FunctionDef] = {}
        self.methods: dict[str, dict[str, ast.FunctionDef]] = {}
        mod = src.modname
        for node in src.tree.body:
            if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.mod_locks[t.id] = f"{mod}.{t.id}"
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                attrs: dict[str, str] = {}
                meths: dict[str, ast.FunctionDef] = {}
                for sub in ast.walk(node):
                    if (isinstance(sub, ast.Assign)
                            and _is_lock_ctor(sub.value)):
                        for t in sub.targets:
                            if (isinstance(t, ast.Attribute)
                                    and isinstance(t.value, ast.Name)
                                    and t.value.id == "self"):
                                attrs[t.attr] = \
                                    f"{mod}.{node.name}.{t.attr}"
                    elif (isinstance(sub, ast.AnnAssign)
                            and sub.value is not None
                            and _is_lock_ctor(sub.value)
                            and isinstance(sub.target, ast.Name)):
                        attrs[sub.target.id] = \
                            f"{mod}.{node.name}.{sub.target.id}"
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        meths[sub.name] = sub
                self.class_locks[node.name] = attrs
                self.methods[node.name] = meths


class _FuncWalker(ast.NodeVisitor):
    def __init__(self, idx: _ModuleIndex, cls: str | None,
                 imports: dict[str, str], info: FuncInfo):
        self.idx = idx
        self.cls = cls
        self.imports = imports
        self.info = info
        self.held: list[str] = []

    def _lock_of(self, expr: ast.AST) -> str | None:
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and self.cls):
            return self.idx.class_locks.get(self.cls, {}).get(expr.attr)
        if isinstance(expr, ast.Name):
            return self.idx.mod_locks.get(expr.id)
        return None

    def _callee_of(self, call: ast.Call) -> FuncKey | None:
        f = call.func
        rel = self.idx.src.rel
        if isinstance(f, ast.Name):
            if f.id in self.idx.functions:
                return (rel, None, f.id)
            return None
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            if (f.value.id == "self" and self.cls
                    and f.attr in self.idx.methods.get(self.cls, {})):
                return (rel, self.cls, f.attr)
            target = self.imports.get(f.value.id)
            if target is not None:
                return (target, None, f.attr)
        return None

    def visit_With(self, node: ast.With) -> None:
        acquired: list[str] = []
        for item in node.items:
            lock = self._lock_of(item.context_expr)
            if lock is not None:
                self.info.acquires.append(
                    (lock, tuple(self.held), item.context_expr.lineno))
                self.held.append(lock)
                acquired.append(lock)
            else:
                self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for lock in reversed(acquired):
            self.held.pop()

    visit_AsyncWith = visit_With

    def visit_Call(self, node: ast.Call) -> None:
        # explicit lock.acquire() — an acquisition without with-scoping
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "acquire"):
            lock = self._lock_of(node.func.value)
            if lock is not None:
                self.info.acquires.append(
                    (lock, tuple(self.held), node.lineno))
        callee = self._callee_of(node)
        if callee is not None:
            self.info.calls.append((callee, tuple(self.held), node.lineno))
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # nested defs run later, under unknown held state — skip bodies
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


def build_lock_graph(files: list[SourceFile], cache=None):
    """Returns (lock ids, edges) where edges maps (held, acquired) ->
    (file rel, line) of the first site implying that ordering. ``cache``
    (a ``core.TreeCache``) shares the per-module indexes with the other
    graph passes instead of rebuilding them."""
    known = {f.rel for f in files}
    indexes = {f.rel: (cache.index(f) if cache is not None
                       else _ModuleIndex(f)) for f in files}
    funcs: dict[FuncKey, FuncInfo] = {}
    for f in files:
        idx = indexes[f.rel]
        imports = _resolve_imports(f, known)
        for name, node in idx.functions.items():
            info = FuncInfo((f.rel, None, name))
            _FuncWalker(idx, None, imports, info).generic_visit(node)
            funcs[info.key] = info
        for cls, meths in idx.methods.items():
            for name, node in meths.items():
                info = FuncInfo((f.rel, cls, name))
                _FuncWalker(idx, cls, imports, info).generic_visit(node)
                funcs[info.key] = info

    # close "locks acquired by this function, transitively" over calls
    closure: dict[FuncKey, set[str]] = {
        k: {l for l, _, _ in fi.acquires} for k, fi in funcs.items()}
    changed = True
    while changed:
        changed = False
        for k, fi in funcs.items():
            for callee, _, _ in fi.calls:
                extra = closure.get(callee)
                if extra and not extra <= closure[k]:
                    closure[k] |= extra
                    changed = True

    locks: set[str] = set()
    for idx in indexes.values():
        locks.update(idx.mod_locks.values())
        for attrs in idx.class_locks.values():
            locks.update(attrs.values())
    edges: dict[tuple[str, str], tuple[str, int]] = {}

    def add_edge(a: str, b: str, rel: str, line: int) -> None:
        if a != b:  # re-entrancy is not an ordering edge
            edges.setdefault((a, b), (rel, line))

    for k, fi in funcs.items():
        rel = k[0]
        for lock, held, line in fi.acquires:
            for h in held:
                add_edge(h, lock, rel, line)
        for callee, held, line in fi.calls:
            if not held:
                continue
            for lock in closure.get(callee, ()):
                for h in held:
                    add_edge(h, lock, rel, line)
    return locks, edges


def find_cycles(edges: dict[tuple[str, str], tuple[str, int]]):
    """Minimal deterministic cycle enumeration: one cycle per strongly
    connected component with >1 node."""
    adj: dict[str, list[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, [])
    for k in adj:
        adj[k].sort()

    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    sccs: list[list[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        # iterative Tarjan (the call graph is small but recursion depth
        # is not worth betting on)
        work = [(v, iter(adj[v]))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(adj[w])))
                    advanced = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1:
                    sccs.append(sorted(scc))

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)
    return sccs


def check(files: list[SourceFile], cache=None) -> list[Finding]:
    _, edges = build_lock_graph(files, cache=cache)
    out: list[Finding] = []
    for scc in find_cycles(edges):
        members = set(scc)
        sites = sorted(
            f"{a} -> {b} at {rel}:{line}"
            for (a, b), (rel, line) in edges.items()
            if a in members and b in members)
        anchor = min(
            ((rel, line) for (a, b), (rel, line) in edges.items()
             if a in members and b in members),
            key=lambda x: (x[0], x[1]))
        out.append(Finding(
            RULE, anchor[0], anchor[1],
            "lock acquisition cycle (deadlock-capable interleaving): "
            + "; ".join(sites)))
    return out
