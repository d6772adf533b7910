"""mem-accounting pass: hot-path materializations must hit the monitor tree.

The memory-monitor tree (flow/memory.py) and the block-cache budget only
deliver their guarantees if large allocations actually route through
them. This pass walks the flow/storage hot-path modules and flags any
``np.*``/``torch.*`` materializing constructor whose size cannot be shown small at
lint time, unless the enclosing function — or another method of the same
class (operators reserve in open()/spool and materialize in next()) —
shows accounting evidence: a ``reserve``/``reserve_batch``/``release``/
``note_spill``/``would_exceed`` call, an ``Allocator(...)`` construction,
or a ``flowmem``/``memory`` module reference.

Statically exempt (below the threshold, or already accounted by the
source array's own charge):

- literal shapes whose element product is <= ``SMALL_ELEMS`` (a fixed
  small header/mask buffer is not a budget event);
- literal element lists (``np.array([...])``) — their length is visible;
- allocations inside a function captured by ``dispatch.jit`` — they are
  graph-pool temporaries, charged at the operator boundary;
- shapes taken from an existing array (``x.shape``, ``x.size``,
  ``len(x)``, ``x.capacity``? no — only ``.shape``/``.size``): an
  alloc-like-existing transient duplicates a batch the monitor already
  charged when that batch was reserved.

Everything else is a finding at the call line; waive with
``# crlint: allow-mem-accounting(reason)`` on the line or the def line.
"""

from __future__ import annotations

import ast

from .core import Finding, SourceFile

RULE = "mem-accounting"

# flow/storage hot paths: the modules whose allocations move query- or
# ingest-sized data. Cold paths (planner, catalog, pgwire) stay out of
# scope — their arrays are row-count-of-metadata sized. utils/admission
# stays out too: the serving plane queues WAITERS (events + per-tenant
# scalars, a bounded float list of wait samples), never batches/tiles —
# there is nothing monitor-sized to account.
HOT_PATHS = (
    "cockroach_tpu_torch/flow/operators.py",
    "cockroach_tpu_torch/flow/runtime.py",
    "cockroach_tpu_torch/flow/fuse.py",
    "cockroach_tpu_torch/flow/external.py",
    "cockroach_tpu_torch/ops/merge_join.py",
    "cockroach_tpu_torch/ops/sort.py",
    "cockroach_tpu_torch/parallel/shuffle.py",
    "cockroach_tpu_torch/storage/ingest.py",
    "cockroach_tpu_torch/storage/blockcache.py",
    "cockroach_tpu_torch/storage/lsm.py",
    # the changefeed fan-out plane buffers and coalesces event frames
    # sized by the write stream — its scans and per-subscriber queues
    # must charge the node's changefeed staging account
    "cockroach_tpu_torch/kv/changefeed.py",
    "cockroach_tpu_torch/kv/fanout.py",
    # the matview plane stages delta tiles and rebuilds standing [V, G]
    # state arrays sized by the write stream and the view population —
    # both must charge the matview staging account
    "cockroach_tpu_torch/flow/viewmaint.py",
    "cockroach_tpu_torch/sql/matview.py",
    # the serving-path coalescing planes buffer cross-session state —
    # pending write payloads and shared tile windows — sized by load;
    # both must charge their staging accounts
    "cockroach_tpu_torch/kv/coalesce.py",
    "cockroach_tpu_torch/flow/sharedscan.py",
    # warm-menu compilation workers materialize exemplar batches (one
    # per menu rung) to drive AOT lowering — rung capacities are
    # bucketed but still monitor-sized, so warming must account them
    "cockroach_tpu_torch/sql/warmmenu.py",
    # the streaming scan's double-buffered pinned host tiles and their
    # device copies are sized by the stream tile
    "cockroach_tpu_torch/flow/upload.py",
)

# materializing constructors: allocate fresh host/device buffers sized by
# their arguments. Views/wrappers (asarray on an ndarray, reshape) and
# elementwise math are not listed — they don't create unaccounted bytes.
_CTORS = {
    "zeros", "empty", "ones", "full", "arange", "concatenate", "stack",
    "vstack", "hstack", "tile", "repeat", "fromiter", "array", "cat",
    "concat",
}
_CTOR_ROOTS = ("np", "numpy", "torch")
# NOT listed: frombuffer/from_numpy (zero-copy views over an existing
# buffer), asarray/as_tensor (no copy when the input already is one) and
# the *_like constructors (sized like a tensor already charged)

_EVIDENCE_CALLS = {
    "reserve", "reserve_batch", "release", "note_spill", "would_exceed",
    "staged", "staging_monitor", "charge_object",
}

SMALL_ELEMS = 4096  # literal shapes up to this many elements are exempt


def _literal_elems(node: ast.AST) -> int | None:
    """Element count if the shape/content argument is fully literal."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return max(node.value, 0)
    if isinstance(node, (ast.Tuple, ast.List)):
        if not node.elts:
            return 0
        total = 1
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, int):
                total *= max(e.value, 0)
            elif isinstance(e, ast.Constant):
                # literal element list: np.array([1.0, "x"]) — count is
                # the list length, already folded in via the loop count
                return len(node.elts)
            else:
                return None
        return total
    return None


def _shape_of_existing(node: ast.AST) -> bool:
    """True for ``x.shape`` / ``x.shape[0]`` / ``x.size`` / ``len(x)`` —
    an allocation sized like an array that already exists (and was
    charged when its batch was reserved)."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and node.attr in ("shape", "size"):
        return True
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "len" and node.args):
        return True
    if isinstance(node, (ast.Tuple, ast.List)):
        return bool(node.elts) and all(
            _shape_of_existing(e) or _literal_elems(e) is not None
            for e in node.elts)
    return False


def _is_exempt(call: ast.Call) -> bool:
    if not call.args:
        return True  # np.array() etc. — degenerate, empty
    first = call.args[0]
    n = _literal_elems(first)
    if n is not None and n <= SMALL_ELEMS:
        return True
    if _shape_of_existing(first):
        return True
    # np.full(shape, fill): shape is the size-bearing arg — handled above;
    # np.arange(stop) literal:
    if (isinstance(first, ast.Constant) and isinstance(first.value, int)
            and first.value <= SMALL_ELEMS):
        return True
    return False


def _is_jitted(fn: ast.AST) -> bool:
    """torch ctors inside a ``@dispatch.jit`` function are temporaries of
    its captured graph (the graph pool holds them) — the monitor charges
    the function's output batch at the operator boundary, not each
    intermediate."""
    from .core import attr_chain

    for dec in getattr(fn, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        chain = attr_chain(target)
        if chain and chain[-2:] == ("dispatch", "jit"):
            return True
        if (chain and chain[-1] == "partial" and isinstance(dec, ast.Call)
                and dec.args):
            inner = attr_chain(dec.args[0])
            if inner and inner[-2:] == ("dispatch", "jit"):
                return True
    return False


def _materializations(fn: ast.AST) -> list[ast.Call]:
    out = []
    for sub in ast.walk(fn):
        if (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and isinstance(sub.func.value, ast.Name)
                and sub.func.value.id in _CTOR_ROOTS
                and sub.func.attr in _CTORS
                and not _is_exempt(sub)):
            out.append(sub)
    return out


def _has_evidence(fn: ast.AST) -> bool:
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Call):
            f = sub.func
            if isinstance(f, ast.Attribute) and f.attr in _EVIDENCE_CALLS:
                return True
            if isinstance(f, ast.Name) and f.id == "Allocator":
                return True
        if isinstance(sub, ast.Name) and sub.id in ("flowmem", "memory"):
            return True
        if (isinstance(sub, ast.Attribute) and isinstance(sub.value, ast.Name)
                and sub.value.id in ("flowmem",)):
            return True
    return False


def check(file: SourceFile) -> list[Finding]:
    if file.rel not in HOT_PATHS:
        return []
    findings: list[Finding] = []

    def walk(body, cls: str | None, class_evidence: bool):
        for node in body:
            if isinstance(node, ast.ClassDef):
                evid = any(_has_evidence(m) for m in node.body
                           if isinstance(m, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)))
                walk(node.body, node.name, evid)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if _is_jitted(node):
                    continue
                mats = _materializations(node)
                if not mats:
                    continue
                if _has_evidence(node) or class_evidence:
                    continue
                where = f"{cls}.{node.name}" if cls else node.name
                for call in mats:
                    findings.append(Finding(
                        RULE, file.rel, call.lineno,
                        f"{file.modname}.{where} materializes "
                        f"{call.func.value.id}.{call.func.attr} with a "
                        "non-small shape on a flow/storage hot path with "
                        "no accounting evidence (reserve/Allocator/"
                        "flowmem) in the function or its class; charge it "
                        "to the monitor tree or waive with "
                        "allow-mem-accounting(reason)",
                    ))
    walk(file.tree.body, None, False)
    return findings
