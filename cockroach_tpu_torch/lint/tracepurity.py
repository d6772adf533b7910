"""recompile-hazard pass: static guard on the zero-recompile guarantee.

The serving path's contract is that a repeat query captures ZERO new
CUDA graphs: ``dispatch.jit`` captures one graph per new signature, so a
new key is the port's recompile. The runtime checks hold it only for
the query shapes they happen to run. This pass catches the hazard
classes statically, at every call site:

1. **kernel-key impurity** — arguments to ``dispatch.kernel_key(...)``
   whose value is not a stable function of the traced computation:
   f-strings and ``repr``/``id``/``hash`` of runtime objects (two
   structurally identical kernels get different keys → cache miss →
   retrace), and unsorted dict iteration (``.keys()``/``.values()``/
   ``.items()`` outside ``sorted(...)`` — two equal schemas built in
   different insertion orders key differently);
2. **keyless jit of a closure on a per-call path** — ``dispatch.jit``
   applied to a lambda/nested def OUTSIDE construction-time methods
   (``__init__``/``__post_init__``/``open``) with neither a ``key=``
   (process-global kernel cache) nor memoization evidence in the
   enclosing function (``setdefault``/``lru_cache``/a ``*cache*``
   name): every call builds a fresh wrapper and re-captures;
3. **non-bucketed shapes feeding jit** (hot modules only) — a value
   bound to a ``cap``/``capacity`` name (the static-argname shape
   convention) derived directly from data sizes (``len(...)``,
   ``.shape``, ``.size``, ``.num_rows``) with no canonical-bucketing
   evidence (``_canonical_cap``/``_bucket_cap``/``SHAPE_BUCKETS``/a
   power-of-two ladder): per-row-count shapes capture one graph per
   cardinality instead of one per rung.

Waive with ``# crlint: allow-recompile-hazard(<why stable>)`` on the
line or the def line. Scope: ``cockroach_tpu_torch/`` (check 3 further
scoped to the flow/ops/parallel hot modules, where shapes reach jit).
"""

from __future__ import annotations

import ast
import re

from .core import Finding, SourceFile, attr_chain

RULE = "recompile-hazard"

# modules whose capacities parameterize jitted kernels (static argnames
# / padded buffer shapes) — the canonical-bucketing discipline applies
SHAPE_HOT = (
    "cockroach_tpu_torch/flow/operators.py",
    "cockroach_tpu_torch/flow/external.py",
    "cockroach_tpu_torch/flow/fuse.py",
    "cockroach_tpu_torch/flow/viewmaint.py",
    "cockroach_tpu_torch/flow/sharedscan.py",
    "cockroach_tpu_torch/ops/merge_join.py",
    "cockroach_tpu_torch/ops/sort.py",
    "cockroach_tpu_torch/parallel/shuffle.py",
    "cockroach_tpu_torch/parallel/dist.py",
)

_CAP_NAME = re.compile(r"(^|_)(cap|capacity)$")
# construction-time lifecycle methods: run once per operator INSTANCE,
# and instances outlive queries (the plan cache shares operator trees
# across repeats — that reuse is exactly why check_recompiles holds
# zero). A keyless closure jit here compiles once per instance, not per
# call; the hazard this pass hunts is the same jit on a per-CALL path.
_CONSTRUCTION_FUNCS = {"__init__", "__post_init__", "__new__", "open",
                       "init"}
_BUCKET_EVIDENCE = {"_canonical_cap", "_bucket_cap", "bucket_cap",
                    "_bucket", "next_pow2", "SHAPE_BUCKETS"}
_IMPURE_CALLS = {"repr", "id", "hash"}
_DICT_ITERS = {"keys", "values", "items"}


def _is_kernel_key_call(node: ast.Call) -> bool:
    chain = attr_chain(node.func)
    if chain and chain[-1] == "kernel_key":
        return len(chain) == 1 or chain[-2] == "dispatch"
    return False


def _is_dispatch_jit(node: ast.AST) -> bool:
    chain = attr_chain(node)
    return bool(chain) and chain[-2:] == ("dispatch", "jit")


def _key_hazards(arg: ast.AST, in_sorted: bool = False):
    """(node, description) impurities inside one kernel-key argument."""
    if isinstance(arg, ast.JoinedStr):
        yield (arg, "an f-string (formatting mixes runtime values and "
                    "object reprs into the key)")
        return
    if isinstance(arg, ast.Call):
        f = arg.func
        name = None
        if isinstance(f, ast.Name):
            name = f.id
        elif isinstance(f, ast.Attribute):
            name = f.attr
        if name in _IMPURE_CALLS:
            yield (arg, f"{name}() of a runtime object (identity/"
                        "address-dependent: two equal kernels key "
                        "differently)")
            return
        if (name in _DICT_ITERS and isinstance(f, ast.Attribute)
                and not in_sorted and not arg.args):
            yield (arg, f".{name}() iteration order (two structurally "
                        "equal dicts built in different orders key "
                        "differently — wrap in sorted(...))")
            return
        if name == "sorted":
            in_sorted = True
    for child in ast.iter_child_nodes(arg):
        yield from _key_hazards(child, in_sorted)


def _own_calls(fn: ast.AST) -> list[ast.Call]:
    """Calls in the function body excluding nested def/lambda bodies."""
    out: list[ast.Call] = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        if isinstance(n, ast.Call):
            out.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return out


def _memo_evidence(fn: ast.AST) -> bool:
    """The enclosing function already memoizes its jit wrappers: a cache
    lookup/insert (setdefault), functools.lru_cache, kernel_key use, or
    any *cache* name."""
    for n in ast.walk(fn):
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Attribute) and f.attr == "setdefault":
                return True
            if _is_kernel_key_call(n):
                return True
        if isinstance(n, ast.Name) and "cache" in n.id.lower():
            return True
        if isinstance(n, ast.Attribute) and "cache" in n.attr.lower():
            return True
        chain = attr_chain(n) if isinstance(n, ast.Attribute) else None
        if chain and chain[-1] == "lru_cache":
            return True
    return False


def _dynamic_size(expr: ast.AST) -> bool:
    """The expression derives directly from data cardinality."""
    for n in ast.walk(expr):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id == "len":
            return True
        if isinstance(n, ast.Attribute) \
                and n.attr in ("shape", "size", "num_rows", "nbytes"):
            return True
    return False


def _bucket_evidence(expr: ast.AST) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Name) and n.id in _BUCKET_EVIDENCE:
            return True
        if isinstance(n, ast.Attribute) and n.attr in _BUCKET_EVIDENCE:
            return True
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.LShift):
            return True
    return False


def _cap_target_name(t: ast.AST) -> str | None:
    if isinstance(t, ast.Name):
        return t.id
    if isinstance(t, ast.Attribute):
        return t.attr
    return None


def check(file: SourceFile) -> list[Finding]:
    if not file.rel.startswith("cockroach_tpu_torch/"):
        return []
    # textual prefilter: hazard 1 needs a kernel_key call, hazard 2 a
    # dispatch.jit reference, hazard 3 a shape-hot module — files with
    # none of those cannot trip, so skip their AST walks entirely
    has_key = "kernel_key" in file.text
    has_jit = "jit" in file.text
    if not has_key and not has_jit and file.rel not in SHAPE_HOT:
        return []
    findings: list[Finding] = []
    tree = file.tree

    # 1. kernel-key impurity — anywhere in the package
    for node in ast.walk(tree) if has_key else ():
        if isinstance(node, ast.Call) and _is_kernel_key_call(node):
            args = list(node.args) + [kw.value for kw in node.keywords]
            for arg in args:
                for bad, why in _key_hazards(arg):
                    findings.append(Finding(
                        RULE, file.rel, bad.lineno,
                        f"kernel_key argument uses {why}; kernel keys "
                        "must be pure structural functions of the "
                        "traced computation — fix the key, or waive "
                        "with allow-recompile-hazard(reason)"))

    # 2. keyless jit of a closure outside construction
    def scan_fn(fn: ast.AST, where: str):
        if fn.name.split(".")[-1] in _CONSTRUCTION_FUNCS:
            return
        nested = {n.name for n in ast.iter_child_nodes(fn)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        # also: nested defs decorated with a keyless dispatch.jit
        for n in ast.iter_child_nodes(fn):
            if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for dec in n.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if _is_dispatch_jit(target) or (
                        isinstance(dec, ast.Call) and dec.args
                        and _is_dispatch_jit(dec.args[0])):
                    keyed = isinstance(dec, ast.Call) and any(
                        kw.arg == "key" for kw in dec.keywords)
                    if not keyed and not _memo_evidence(fn):
                        findings.append(Finding(
                            RULE, file.rel, dec.lineno,
                            f"{where} jits the nested def {n.name!r} "
                            "with no key= on a per-call path — every "
                            "invocation builds a fresh wrapper and "
                            "re-traces; key it through "
                            "dispatch.kernel_key, hoist to "
                            "construction, or waive with "
                            "allow-recompile-hazard(reason)"))
        for call in _own_calls(fn):
            if not _is_dispatch_jit(call.func):
                continue
            if any(kw.arg == "key" for kw in call.keywords):
                continue
            if not call.args:
                continue
            arg0 = call.args[0]
            closure = isinstance(arg0, ast.Lambda) or (
                isinstance(arg0, ast.Name) and arg0.id in nested)
            if closure and not _memo_evidence(fn):
                findings.append(Finding(
                    RULE, file.rel, call.lineno,
                    f"{where} calls dispatch.jit on a closure with no "
                    "key= on a per-call path — every invocation builds "
                    "a fresh wrapper and re-traces; key it through "
                    "dispatch.kernel_key, hoist to construction, or "
                    "waive with allow-recompile-hazard(reason)"))

    def walk_scope(body, cls: str | None):
        for node in body:
            if isinstance(node, ast.ClassDef):
                walk_scope(node.body, node.name)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                where = (f"{file.modname}."
                         f"{(cls + '.') if cls else ''}{node.name}")
                scan_fn(node, where)

    if has_jit:
        walk_scope(tree.body, None)

    # 3. non-bucketed capacities in the shape-hot modules
    if file.rel in SHAPE_HOT:
        for node in ast.walk(tree):
            targets: list[tuple[str, ast.AST, int]] = []
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    name = _cap_target_name(t)
                    if name and _CAP_NAME.search(name):
                        targets.append((name, node.value, node.lineno))
            elif isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg and _CAP_NAME.search(kw.arg):
                        targets.append((kw.arg, kw.value, kw.value.lineno))
            for name, value, line in targets:
                if _dynamic_size(value) and not _bucket_evidence(value):
                    findings.append(Finding(
                        RULE, file.rel, line,
                        f"{name!r} is derived from a data size "
                        "(len/.shape/.size) with no canonical-bucketing "
                        "evidence (_canonical_cap/_bucket_cap/"
                        "SHAPE_BUCKETS) in a shape-hot module — "
                        "per-cardinality shapes capture one graph per "
                        "row count; bucket the capacity, or waive with "
                        "allow-recompile-hazard(reason)"))
    return findings
