"""untimed-wait pass: blocking calls on serving threads carry deadlines.

The recurring liveness bug of a threaded plane is an untimed blocking
call that holds a control-plane or serving thread forever (a dead-socket
tail loop, an admission timeout racing its grant). Go-side CockroachDB leans on contexts — every RPC, every
condition wait sits under a ``context.Context`` deadline; this pass is
the static analog for our threaded plane:

1. reuse the whole-program thread analysis ``lint/sharedstate.py``
   builds (entry points, call graph, reachability — shared through
   ``core.TreeCache``, so the graph is computed once per lint run);
2. in every function reachable from a thread entry point, flag each
   **potentially-unbounded blocking primitive**:

   - ``x.wait()`` / ``x.wait_for(pred)`` with no timeout (Condition,
     Event);
   - ``q.get()`` / ``q.get(True)`` on a queue-typed receiver with no
     timeout;
   - ``t.join()`` with no timeout;
   - ``sock.recv(...)`` / ``sock.accept()`` with no deadline evidence —
     a ``settimeout(...)`` in the same function or class, or a
     ``utils/retry`` wrapper (``retry.call`` / ``Backoff``) driving it;
   - ``socket.create_connection(addr)`` without a ``timeout`` (the
     connect itself blocks long before any settimeout can apply);
   - bare ``lock.acquire()`` on a recognized lock with neither a
     timeout nor ``blocking=False``.

The contract mirrors the runtime one: a blocking call on a thread the
serving plane depends on must have a bound, after which the caller
either retries (utils/retry), reaps the peer, or surfaces a typed
error. Sites that legitimately block forever — a persistent-protocol
server loop parked on an idle client whose teardown story is "close()
severs the socket" — carry a reasoned
``# crlint: allow-untimed-wait(<why + who unblocks it>)`` pragma.

Scope: ``cockroach_tpu_torch/`` except ``bench/`` (load generators are
clients of the system under test; a stuck bench worker fails the bench
run loudly and holds no serving thread hostage).
"""

from __future__ import annotations

import ast

from .core import Finding, SourceFile, attr_chain
from .lockorder import FuncKey
from .sharedstate import program

RULE = "untimed-wait"

_SKIP_PREFIXES = ("cockroach_tpu_torch/bench/",)

# queue constructors whose .get() blocks (Counter etc. stay out: their
# .get() is dict.get)
_QUEUE_CTORS = {
    ("queue", "Queue"), ("queue", "SimpleQueue"), ("queue", "LifoQueue"),
    ("queue", "PriorityQueue"),
}

# receivers whose .wait()/.recv() are not thread blocking primitives
_NON_BLOCKING_BASES = {"os", "signal", "subprocess"}


def _kw(call: ast.Call, name: str) -> ast.AST | None:
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _own_nodes(fn: ast.AST) -> list[ast.AST]:
    """The function's body nodes, EXCLUDING nested def/lambda bodies —
    those are separate functions with their own reachability."""
    out: list[ast.AST] = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        out.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return out


def _queue_ctor(value: ast.AST) -> bool:
    for n in ast.walk(value):
        if isinstance(n, ast.Call):
            chain = attr_chain(n.func)
            if chain and chain[-2:] in _QUEUE_CTORS:
                return True
    return False


def _queue_names(nodes: list[ast.AST]) -> set[str]:
    """Local names bound to a queue constructor within these nodes."""
    out: set[str] = set()
    for n in nodes:
        if isinstance(n, ast.Assign) and _queue_ctor(n.value):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _class_queue_attrs(src: SourceFile, cls: str) -> set[str]:
    """self-attrs of ``cls`` assigned a queue constructor anywhere in the
    class body."""
    out: set[str] = set()
    for node in src.tree.body:
        if not (isinstance(node, ast.ClassDef) and node.name == cls):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and _queue_ctor(sub.value):
                for t in sub.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        out.add(t.attr)
    return out


def _deadline_evidence(nodes: list[ast.AST]) -> bool:
    """A socket deadline or retry-wrapper reference: ``settimeout(x)``
    with a non-None bound, ``create_connection(..., timeout=...)``, or a
    ``utils/retry`` policy (``retry.call`` / ``Backoff``)."""
    for n in nodes:
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        if isinstance(f, ast.Attribute) and f.attr == "settimeout":
            if n.args and not (isinstance(n.args[0], ast.Constant)
                               and n.args[0].value is None):
                return True
        chain = attr_chain(f)
        if chain and chain[-2:] == ("retry", "call"):
            return True
        if chain and chain[-1] == "Backoff":
            return True
        if chain and chain[-1] == "create_connection" \
                and _kw(n, "timeout") is not None:
            return True
    return False


def _receiver_base(f: ast.Attribute) -> str | None:
    node = f.value
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _fn_sites(fn_key: FuncKey, fn: ast.AST, src: SourceFile,
              idx, class_evidence: bool,
              class_queues: set[str]) -> list[tuple[int, str]]:
    """(line, message) blocking findings inside one function body."""
    nodes = _own_nodes(fn)
    fn_evidence = _deadline_evidence(nodes)
    local_queues = _queue_names(nodes)
    rel, cls, name = fn_key
    where = f"{src.modname}.{(cls + '.') if cls else ''}{name}"
    out: list[tuple[int, str]] = []
    for n in nodes:
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        chain = attr_chain(f)
        # socket.create_connection(addr) with no timeout: the CONNECT
        # blocks on the kernel's own (minutes-long) timeout
        if chain and chain[-1] == "create_connection":
            if _kw(n, "timeout") is None and len(n.args) < 2:
                out.append((n.lineno,
                            f"{where} dials with create_connection() and "
                            "no timeout on a serving thread — a black-"
                            "holed peer blocks the connect for the "
                            "kernel's own timeout (minutes); pass "
                            "timeout=, or waive with "
                            "allow-untimed-wait(reason)"))
            continue
        if not isinstance(f, ast.Attribute):
            continue
        base = _receiver_base(f)
        if base in _NON_BLOCKING_BASES:
            continue
        attr = f.attr
        if attr == "wait":
            if not n.args and _kw(n, "timeout") is None:
                out.append((n.lineno,
                            f"{where} calls .wait() with no timeout on a "
                            "serving thread — a lost wakeup parks the "
                            "thread forever; pass a timeout and loop, or "
                            "waive with allow-untimed-wait(reason)"))
        elif attr == "wait_for":
            if len(n.args) < 2 and _kw(n, "timeout") is None:
                out.append((n.lineno,
                            f"{where} calls .wait_for() with no timeout "
                            "on a serving thread — pass timeout= (the "
                            "predicate re-check loop already handles "
                            "spurious wakeups), or waive with "
                            "allow-untimed-wait(reason)"))
        elif attr == "get":
            recv_is_queue = False
            if (isinstance(f.value, ast.Attribute)
                    and isinstance(f.value.value, ast.Name)
                    and f.value.value.id == "self"):
                recv_is_queue = f.value.attr in class_queues
            elif isinstance(f.value, ast.Name):
                recv_is_queue = (f.value.id in local_queues
                                 or f.value.id in _module_queue_names(src))
            if not recv_is_queue:
                continue
            block_arg = n.args[0] if n.args else None
            nonblocking = (isinstance(block_arg, ast.Constant)
                           and block_arg.value is False) or (
                isinstance(_kw(n, "block"), ast.Constant)
                and _kw(n, "block").value is False)
            timed = _kw(n, "timeout") is not None or len(n.args) >= 2
            if not nonblocking and not timed:
                out.append((n.lineno,
                            f"{where} calls Queue.get() with no timeout "
                            "on a serving thread — if every producer "
                            "dies the consumer hangs forever; pass "
                            "timeout= and re-check liveness per tick, or "
                            "waive with allow-untimed-wait(reason)"))
        elif attr == "join":
            if not n.args and not n.keywords:
                out.append((n.lineno,
                            f"{where} calls .join() with no timeout on a "
                            "serving thread — a wedged child holds this "
                            "thread with it; pass timeout= and surface "
                            "the straggler, or waive with "
                            "allow-untimed-wait(reason)"))
        elif attr in ("recv", "recv_into", "recvfrom", "accept"):
            if not fn_evidence and not class_evidence:
                out.append((n.lineno,
                            f"{where} blocks in socket .{attr}() with no "
                            "deadline evidence (no settimeout/"
                            "create_connection(timeout=)/utils-retry in "
                            "the function or its class) on a serving "
                            "thread — a silent peer parks the thread "
                            "forever; set a socket timeout, or waive "
                            "with allow-untimed-wait(reason)"))
        elif attr == "acquire":
            lock = None
            if (isinstance(f.value, ast.Attribute)
                    and isinstance(f.value.value, ast.Name)
                    and f.value.value.id == "self" and cls):
                lock = idx.class_locks.get(cls, {}).get(f.value.attr)
            elif isinstance(f.value, ast.Name):
                lock = idx.mod_locks.get(f.value.id)
            if lock is None:
                continue
            first = n.args[0] if n.args else None
            nonblocking = isinstance(first, ast.Constant) \
                and first.value is False
            blocking_kw = _kw(n, "blocking")
            if isinstance(blocking_kw, ast.Constant) \
                    and blocking_kw.value is False:
                nonblocking = True
            timed = _kw(n, "timeout") is not None or len(n.args) >= 2
            if not nonblocking and not timed:
                out.append((n.lineno,
                            f"{where} bare-acquires {lock} with no "
                            "timeout on a serving thread — use a with "
                            "block where possible, or acquire(timeout=) "
                            "and handle the miss, or waive with "
                            "allow-untimed-wait(reason)"))
    return out


def _module_queue_names(src: SourceFile) -> set[str]:
    out: set[str] = set()
    for node in src.tree.body:
        if isinstance(node, ast.Assign) and _queue_ctor(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def check(files: list[SourceFile], cache=None) -> list[Finding]:
    prog = program(files, cache)
    if prog is None:
        return []
    by_rel = {f.rel: f for f in files}
    thread_funcs = prog.thread_funcs() | prog.entries

    # class-level deadline evidence, computed lazily per (rel, cls)
    evid_memo: dict[tuple[str, str | None], bool] = {}
    queue_memo: dict[tuple[str, str | None], set] = {}

    def class_evidence(src: SourceFile, cls: str | None) -> bool:
        key = (src.rel, cls)
        if key not in evid_memo:
            found = False
            if cls is not None:
                for node in src.tree.body:
                    if isinstance(node, ast.ClassDef) and node.name == cls:
                        found = _deadline_evidence(list(ast.walk(node)))
            evid_memo[key] = found
        return evid_memo[key]

    def class_queues(src: SourceFile, cls: str | None) -> set:
        key = (src.rel, cls)
        if key not in queue_memo:
            queue_memo[key] = (_class_queue_attrs(src, cls)
                               if cls is not None else set())
        return queue_memo[key]

    out: list[Finding] = []
    for fk in sorted(thread_funcs, key=str):
        rec = prog.funcs.get(fk)
        if rec is None or rec.node is None:
            continue
        rel, cls, _name = fk
        if rel.startswith(_SKIP_PREFIXES):
            continue
        src = by_rel.get(rel)
        if src is None:
            continue
        idx = cache.index(src) if cache is not None else None
        if idx is None:
            from .lockorder import _ModuleIndex
            idx = _ModuleIndex(src)
        for line, msg in _fn_sites(fk, rec.node, src, idx,
                                   class_evidence(src, cls),
                                   class_queues(src, cls)):
            out.append(Finding(RULE, rel, line, msg))
    # one finding per site even when a function is reachable from many
    # entries (FuncKeys are unique, but nested defs can alias lines)
    seen: set = set()
    uniq: list[Finding] = []
    for fd in sorted(out, key=lambda f: (f.path, f.line, f.message)):
        k = (fd.path, fd.line, fd.message)
        if k not in seen:
            seen.add(k)
            uniq.append(fd)
    return uniq
