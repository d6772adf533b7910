"""Kernel-dispatch accounting, the process-global kernel cache, and the
capture-once, replay-per-call wrapper; the port of
``cockroach_tpu.flow.dispatch``.

The reference wraps ``jax.jit``: every call of a compiled function is one
dispatch, and every trace is one compile. The port's ``jit`` keeps that
accounting with CUDA graphs in the place of XLA executables:

- **CPU tensors**: ``fn`` runs eagerly; each call counts one dispatch,
  and each new *signature* counts one compile. A signature is the key (or
  the wrapper), the structure of the arguments, the shape, dtype, stride
  and device of every tensor leaf and the value of every other leaf.
- **CUDA tensors**: the first call of a signature runs ``fn`` once on a
  side stream (the warm-up), then captures it as one
  ``torch.cuda.CUDAGraph``: that capture is the compile. Every call
  replays the graph (one dispatch): the whole per-tile chain costs one
  graph launch plus the copies of its changing inputs.

Graph memory. Every graph captures into one memory pool per device
(``torch.cuda.graph_pool_handle``), which holds only the temporaries of
the graphs: their outputs are copied, inside the graph, into static
buffers allocated outside the pool. The graphs run one at a time on one
stream, so temporaries may share memory, and no graph's replay can
overwrite another's outputs. A graph's outputs are overwritten by its own
next replay: a caller that keeps a tile past that takes a copy (``own``,
or ``persist`` for a spool). ``own_pool=True`` is for a large one-off
program (a distributed query's attempt, whose temporaries run to tens of
GB): each of its graphs captures into a pool of its own, released when
the graph dies, and the cache its warm-up leaves is emptied before the
capture, whose pool cannot take the default pool's cached blocks.

Graph inputs. A tensor argument that is a *static* buffer (another
graph's output, a buffer marked with ``mark_static`` such as a resident
table, or one made by ``persist``) is captured by reference, and a later call must pass the same
address, else another variant of the graph is captured (the
``MAX_VARIANTS`` most recently used are kept). Every other tensor
argument is copied into a buffer the graph owns, one copy per tensor per
call, skipped when the caller passes that buffer itself.

``carry=True`` marks a carried state: ``fn(carry, *args)`` returns
``(new_carry, out)`` and the graph writes ``new_carry`` back into the
carry's buffer, so a fold's accumulator stays in place from tile to tile
(the reference's ``donate_argnums=0``).

Spools. A spool keeps its tiles in buffers that keep their address from
run to run (``persist``), so the graphs of its once-per-spool functions
(a merge, a sort, a join build) read it by reference and hold no copy.

Threads. A graph's input buffers and outputs, and a chain shared by key,
are shared by every caller, and a capture uses the side stream, the
shared pool and ``gc.disable`` of the whole process. A graph's outputs
are read by the next function or the readback after its replay returns,
so no lock narrower than the query keeps another session's replay of
the same graph from overwriting them: every call of a ``jit`` wrapper is
made under ``exec_lock()``, which the runtime (``run_operator``) and the
distributed runner (parallel/planner.py) hold for the whole of one
query's execution, captures included. Sessions (sql/session.py,
server/pgwire.py) parse, bind, plan and write to KV concurrently; their
queries run on the device one at a time, and each query's wait for the
lock lands in the ``sql_exec_lock_wait_seconds`` histogram.

No fallback: a capture that fails raises ``GraphCaptureError`` naming the
function. A function that cannot be captured (it reads a device value on
the host) is not wrapped by ``jit``; ``counted`` runs it eagerly and
counts its dispatches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import threading
import time
import weakref

import torch

from ..coldata import batch as batch_mod
from ..utils import metric

_lock = threading.Lock()
# one query's execution at a time (see the module docstring), and how
# deep this thread holds it
_exec_lock = threading.RLock()
_exec_depth = threading.local()
_total = 0
_compiles = 0
_captures = 0
_replays = 0
_eager = 0
_cache_hits = 0
_kernel_cache: dict = {}

MAX_VARIANTS = 8  # graphs kept per signature (one per by-reference set)


class GraphCaptureError(RuntimeError):
    """A CUDA graph capture failed; names the function."""


@contextlib.contextmanager
def exec_lock():
    """Held by one query's execution from its first pull to its readback
    (flow/runtime.run_operator); re-entrant, so a query run inside
    another (a scalar subquery at bind time) joins it. The outermost
    acquire's wait is observed in ``sql_exec_lock_wait_seconds``."""
    depth = getattr(_exec_depth, "n", 0)
    t0 = time.perf_counter()
    _exec_lock.acquire()
    if depth == 0:
        metric.EXEC_LOCK_WAIT_SECONDS.observe(time.perf_counter() - t0)
    _exec_depth.n = depth + 1
    try:
        yield
    finally:
        _exec_depth.n = depth
        _exec_lock.release()


def note(n: int = 1) -> None:
    """Record n dispatches issued outside a ``jit`` wrapper."""
    global _total
    with _lock:
        _total += n


def total() -> int:
    """Process-lifetime dispatch count (snapshot around a query)."""
    return _total


# this thread's share of the counts (the warm menu's per-item figures,
# while another worker runs beside it)
_mine = threading.local()


def note_compile(n: int = 1) -> None:
    """Record n new signatures (a CUDA graph capture on the card)."""
    global _compiles
    with _lock:
        _compiles += n
    _mine.compiles = getattr(_mine, "compiles", 0) + n


def thread_compiles() -> int:
    """New signatures this thread made (``compiles``' share)."""
    return getattr(_mine, "compiles", 0)


def thread_captures() -> int:
    """CUDA graph captures this thread made (``captures``' share)."""
    return getattr(_mine, "captures", 0)


def compiles() -> int:
    """Process-lifetime compile count (snapshot around a query)."""
    with _lock:
        return _compiles


def captures() -> int:
    """Process-lifetime CUDA graph captures."""
    return _captures


def replays() -> int:
    """Process-lifetime CUDA graph replays."""
    return _replays


def eager() -> int:
    """Process-lifetime calls of ``counted`` functions: per-tile device
    work that ran outside a graph."""
    return _eager


def kernel_cache_hits() -> int:
    """Lookups of ``jit(key=...)`` answered by an existing wrapper."""
    return _cache_hits


def kernel_cache_size() -> int:
    return len(_kernel_cache)


def clear_kernel_cache() -> None:
    """Drop all shared wrappers, and with them their graphs once operator
    trees release their references."""
    with _lock:
        _kernel_cache.clear()


def kernel_key(*parts):
    """A kernel-cache key from hashable parts, or None (no sharing) when
    any part is unhashable. The key must fully determine the computation:
    op kind, schema and expression tree in, runtime values out."""
    try:
        hash(parts)
    except TypeError:
        return None
    return parts


# ---------------------------------------------------------------------------
# static buffers: graph outputs and marked resident tensors

_static: dict[int, tuple] = {}  # storage address -> (weakref, kind)


def _storage_ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _register(t: torch.Tensor, kind: str) -> None:
    with _lock:
        if len(_static) > 4096:  # drop the entries of freed buffers
            for k in [k for k, (r, _) in _static.items() if r() is None]:
                del _static[k]
        _static[_storage_ptr(t)] = (weakref.ref(t), kind)


def _static_kind(t: torch.Tensor):
    got = _static.get(_storage_ptr(t))
    if got is None or got[0]() is None:
        return None
    return got[1]


def mark_static(tree) -> None:
    """Mark the CUDA tensors of `tree` as buffers that stay at their
    address and are never rewritten while referenced (a resident table):
    graphs read them by reference instead of copying them per call."""
    for leaf in _flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            _register(leaf, "stable")


def own(tree):
    """`tree` with every tensor that a graph's next replay overwrites
    replaced by a copy; anything else passes through. Callers that keep a
    tile past the next call of the function that made it (spools) own it."""
    leaves, spec = _flatten(tree)
    if not any(isinstance(x, torch.Tensor) and x.is_cuda
               and _static_kind(x) == "graph" for x in leaves):
        return tree
    return _unflatten(spec, [
        x.clone() if (isinstance(x, torch.Tensor) and x.is_cuda
                      and _static_kind(x) == "graph") else x
        for x in leaves])


def persist(store: list, tree):
    """On the card, `tree` copied into buffers that keep one address from
    run to run (made on the first call, remade when shapes change), so
    graphs that read it by reference stay valid across runs; `tree`
    itself on the CPU or when it already lies in such buffers (a resident
    table). `store` is the caller's list that holds the buffers."""
    leaves, spec = _flatten(tree)
    tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
    if not any(x.is_cuda for x in tensors) or all(
            _static_kind(x) == "stable" for x in tensors):
        return tree  # on the CPU, or already at a lasting address
    sig = tuple(_leaf_sig(x) for x in leaves)
    if store and store[0] == sig:
        bufs = store[1]
        for b, x in zip(bufs, leaves):
            if isinstance(x, torch.Tensor) and not _same_view(b, x):
                b.copy_(x)
    else:
        bufs = [x.clone() if isinstance(x, torch.Tensor) else x
                for x in leaves]
        for b in bufs:
            if isinstance(b, torch.Tensor):
                _register(b, "stable")
        store[:] = [sig, bufs]
    return _unflatten(spec, bufs)


# ---------------------------------------------------------------------------
# pytrees: tuples, lists, dicts and the coldata dataclasses


def _flatten(tree):
    leaves: list = []

    def go(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return None
        if isinstance(x, (tuple, list)):
            return (type(x), tuple(go(v) for v in x))
        if isinstance(x, dict):
            keys = tuple(x)
            return (dict, keys, tuple(go(x[k]) for k in keys))
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            names = tuple(f.name for f in dataclasses.fields(x))
            return (type(x), names, tuple(go(getattr(x, n)) for n in names))
        leaves.append(x)
        return None

    return leaves, go(tree)


def _unflatten(spec, leaves):
    it = iter(leaves)

    def go(s):
        if s is None:
            return next(it)
        if s[0] is dict:
            return {k: go(v) for k, v in zip(s[1], s[2])}
        if s[0] in (tuple, list):
            return s[0](go(v) for v in s[1])
        return s[0](**{n: go(v) for n, v in zip(s[1], s[2])})

    return go(spec)


def _leaf_sig(x):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.dtype, tuple(x.stride()), x.device)
    try:
        hash(x)
    except TypeError:
        return ("id", id(x))
    return ("V", type(x), x)


# ---------------------------------------------------------------------------
# CPU stand-in for capture: the operations a capture forbids raise


class _CaptureGuard:
    """Raises on what a CUDA graph capture cannot hold: a device value
    read on the host (``item``, ``nonzero``, boolean-mask indexing,
    ``unique``, ``repeat_interleave`` without ``output_size``) and a host
    array turned into a tensor inside the function."""

    _SYNC_OPS = ("aten::_local_scalar_dense", "aten::nonzero",
                 "aten::masked_select", "aten::_unique2", "aten::unique_dim",
                 "aten::unique_consecutive", "aten::nonzero_static")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        guard = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = func._schema.name
                if name in _CaptureGuard._SYNC_OPS:
                    guard.fail(name)
                if (name == "aten::repeat_interleave"
                        and kwargs.get("output_size") is None):
                    guard.fail("repeat_interleave without output_size")
                if name in ("aten::index", "aten::index_put",
                            "aten::index_put_", "aten::_index_put_impl_"):
                    idx = args[1] if len(args) > 1 else ()
                    for t in idx or ():
                        if (isinstance(t, torch.Tensor)
                                and t.dtype in (torch.bool, torch.uint8)):
                            guard.fail("boolean-mask indexing")
                return func(*args, **kwargs)

        self._mode = Mode()
        self._saved = (torch.from_numpy, torch.as_tensor, torch.tensor)

        def refuse(*a, **k):
            guard.fail("a host array turned into a tensor")

        torch.from_numpy = torch.as_tensor = torch.tensor = refuse
        self._mode.__enter__()
        return self

    def fail(self, what: str):
        raise GraphCaptureError(
            f"{self.name} cannot be captured as a CUDA graph: {what}")

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        torch.from_numpy, torch.as_tensor, torch.tensor = self._saved
        return False


# When set (capture_checks), the first call of each CPU signature also
# runs the function under _CaptureGuard: the CPU's proof that it can be
# captured.
_check_capture = False


# ---------------------------------------------------------------------------
# CUDA graphs

_pools: dict = {}
_side: dict = {}
_anchors: list = []


def _pool(dev: torch.device):
    """The device's one graph memory pool. torch's pinned-host allocator
    counts the live graphs of each pool and asserts when a capture
    reuses a pool whose count fell to 0 (every graph gone, as after
    ``clear_kernel_cache``), so the pool's first capture is a one-op
    anchor graph kept for the process's life."""
    p = _pools.get(dev)
    if p is None:
        p = _pools[dev] = torch.cuda.graph_pool_handle()
        x = torch.zeros(1, device=dev)
        g = torch.cuda.CUDAGraph()
        side = _side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            g.capture_begin(pool=p, capture_error_mode="thread_local")
            x.add_(1)
            g.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        _anchors.append((g, x))
    return p


def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    """The warm-up and capture stream. torch hands out streams round-robin
    from a small pool per priority, so a default-priority stream could be
    the same CUDA stream as another user's (the upload's copy stream),
    whose work would then land in the capture: take a high-priority one,
    which nothing else in the port asks for."""
    s = _side.get(dev)
    if s is None:
        s = _side[dev] = torch.cuda.Stream(dev, priority=-1)
    return s


def _same_view(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


class _Graph:
    """One captured variant: its input buffers (by-reference leaves are
    the caller's tensors, the rest owned), the graph, and its outputs."""

    def __init__(self, kern: "_Kernel", leaves: list, spec, byref: set):
        self.byref = byref
        self.static_in = []
        for i, x in enumerate(leaves):
            if isinstance(x, torch.Tensor) and i not in byref:
                x = x.clone()
            self.static_in.append(x)
        dev = next(x for x in leaves if isinstance(x, torch.Tensor)).device
        args = _unflatten(spec, self.static_in)
        # a function with a pool of its own releases its temporaries when
        # its graphs die (empty_cache frees only pools without live graphs)
        pool = (torch.cuda.graph_pool_handle() if kern.own_pool
                else _pool(dev))
        cur = torch.cuda.current_stream(dev)
        side = _side_stream(dev)
        side.wait_stream(cur)
        fn = kern.fn
        # a collection during the capture could destroy an unreachable
        # graph, which the capture does not permit
        gc_was = gc.isenabled()
        gc.disable()
        # the host tables the function reads stay alive with the graph
        self.tables: list = []
        batch_mod._held.append(self.tables)
        try:
            with torch.cuda.stream(side):
                warm = fn(*args)  # lazy initialisation happens off-capture
            cur.wait_stream(side)
            warm_leaves, _ = _flatten(warm)
            carry_n = 0
            if kern.carry:
                carry_n = len(_flatten(args[0])[0])
            torch.cuda.synchronize(dev)
            self.graph = torch.cuda.CUDAGraph()
            # outputs land in buffers allocated outside the shared pool
            outs = [torch.empty_like(w) if isinstance(w, torch.Tensor)
                    else w for w in warm_leaves]
            del warm, warm_leaves
            if kern.own_pool:
                # the warm-up's cached blocks go back to the card: the
                # capture's pool cannot take them, and the allocator
                # frees none while capturing
                torch.cuda.empty_cache()
            with torch.cuda.stream(side):
                self.graph.capture_begin(pool=pool,
                                         capture_error_mode="thread_local")
                try:
                    res = fn(*args)
                    res_leaves, self.out_spec = _flatten(res)
                    in_tensors = [x for x in self.static_in
                                  if isinstance(x, torch.Tensor)]
                    for j, r in enumerate(res_leaves):
                        if not isinstance(r, torch.Tensor):
                            outs[j] = r
                            continue
                        if j < carry_n:
                            # the new carry goes back into the carry buffer
                            outs[j] = self.static_in[j]
                            if not _same_view(r, outs[j]):
                                outs[j].copy_(r)
                            continue
                        alias = next((x for x in in_tensors
                                      if _same_view(r, x)), None)
                        if alias is not None:
                            outs[j] = alias  # a pass-through input
                        else:
                            outs[j].copy_(r)
                    del res, res_leaves
                finally:
                    self.graph.capture_end()
            cur.wait_stream(side)
        except GraphCaptureError:
            raise
        except Exception as e:
            raise GraphCaptureError(
                f"CUDA graph capture of {kern.name} failed: "
                f"{type(e).__name__}: {e}") from e
        finally:
            batch_mod._held[:] = [h for h in batch_mod._held
                                  if h is not self.tables]
            if gc_was:
                gc.enable()
        self.outs = outs
        # outputs and owned inputs are rewritten by the next call
        for i, x in enumerate(self.static_in):
            if isinstance(x, torch.Tensor) and i not in byref:
                _register(x, "graph")
        for o in outs:
            if isinstance(o, torch.Tensor):
                if not any(o is x for x in self.static_in):
                    _register(o, "graph")

    def matches(self, leaves) -> bool:
        return all(leaves[i].data_ptr() == self.static_in[i].data_ptr()
                   for i in self.byref)

    def run(self, leaves):
        global _replays
        for i, (x, s) in enumerate(zip(leaves, self.static_in)):
            if (isinstance(x, torch.Tensor) and i not in self.byref
                    and not _same_view(x, s)):
                s.copy_(x, non_blocking=True)
        self.graph.replay()
        with _lock:
            _replays += 1
        return _unflatten(self.out_spec, self.outs)


class _Kernel:
    """The callable ``jit`` returns."""

    def __init__(self, fn, key, carry: bool, own_pool: bool = False):
        self.fn = fn
        self.key = key
        self.carry = carry
        self.own_pool = own_pool
        self.name = getattr(fn, "__qualname__", repr(fn))
        self._seen: set = set()
        self._graphs: dict = {}
        functools.update_wrapper(self, fn)

    def __call__(self, *args):
        note()
        leaves, spec = _flatten(args)
        dev = next((x.device for x in leaves if isinstance(x, torch.Tensor)),
                   None)
        sig = (spec, tuple(_leaf_sig(x) for x in leaves))
        if dev is None or dev.type != "cuda":
            new = sig not in self._seen
            self._seen.add(sig)
            if new:
                note_compile()
                if _check_capture:
                    self.fn(*args)  # the warm-up, as on the card
                    with _CaptureGuard(self.name):
                        return self.fn(*args)
            return self.fn(*args)
        carry_n = len(_flatten(args[0])[0]) if self.carry else 0
        return self._call_cuda(sig, leaves, spec, carry_n)

    def _call_cuda(self, sig, leaves, spec, carry_n):
        global _captures
        variants = self._graphs.setdefault(sig, [])
        for j, g in enumerate(variants):
            if g.matches(leaves):
                if j:  # most recently used first
                    variants.insert(0, variants.pop(j))
                return g.run(leaves)
        byref = {i for i, x in enumerate(leaves)
                 if i >= carry_n and isinstance(x, torch.Tensor)
                 and _static_kind(x) is not None}
        g = _Graph(self, leaves, spec, byref)
        variants.insert(0, g)
        if len(variants) > MAX_VARIANTS:
            variants.pop()  # the least recently used
        sink = getattr(_recording, "sink", None)
        if sink is not None:
            sink.append((weakref.ref(self), sig, weakref.ref(g)))
        note_compile()
        with _lock:
            _captures += 1
        _mine.captures = getattr(_mine, "captures", 0) + 1
        return g.run(leaves)


_recording = threading.local()


@contextlib.contextmanager
def recording_graphs(sink: list):
    """Within the block, each graph this thread captures is noted in
    `sink` (weakly), so ``release_graphs`` can drop them later: a cached
    plan's graphs, which shared wrappers would otherwise keep, with the
    buffers they read by reference, after the plan itself is gone."""
    saved = getattr(_recording, "sink", None)
    _recording.sink = sink
    try:
        yield
    finally:
        _recording.sink = saved


def release_graphs(sink: list) -> int:
    """Drop the graphs `sink` noted from their wrappers (a later call
    captures anew); returns how many were still held. Takes
    ``exec_lock``: no replay runs meanwhile."""
    n = 0
    with exec_lock():
        for kref, sig, gref in sink:
            k, g = kref(), gref()
            variants = None if k is None else k._graphs.get(sig)
            if g is None or not variants:
                continue
            kept = [v for v in variants if v is not g]
            n += len(variants) - len(kept)
            variants[:] = kept
        sink.clear()
    return n


def jit(fn=None, key=None, carry: bool = False, own_pool: bool = False):
    """Wrap `fn` for counted, capture-once replay-per-call execution (see
    the module docstring). With `key`, structurally identical kernels
    share one wrapper process-wide (and with it their graphs); with
    `own_pool`, each of its graphs captures into a pool of its own."""
    if fn is None:
        return functools.partial(jit, key=key, carry=carry,
                                 own_pool=own_pool)
    global _cache_hits
    if key is not None:
        with _lock:
            cached = cache_get(_kernel_cache, key)
            if cached is not None:
                _cache_hits += 1
                return cached
    k = _Kernel(fn, key, carry, own_pool)
    if key is not None:
        with _lock:
            try:  # racing builders: the first insert wins
                k = _kernel_cache.setdefault(key, k)
            except (ValueError, TypeError):
                pass
    return k


def cache_get(cache: dict, key):
    """cache[key] or None. Expression keys hold host tables that compare
    elementwise; a key whose comparison is ambiguous counts as a miss."""
    try:
        return cache.get(key)
    except (ValueError, TypeError):
        return None


def counted(fn):
    """`fn` run eagerly on every device, one dispatch per call: for
    per-tile device functions that read a device value on the host and so
    cannot be captured (counted in ``eager()`` too)."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        global _eager
        note()
        with _lock:
            _eager += 1
        return fn(*args, **kwargs)

    return run


@contextlib.contextmanager
def capture_checks():
    """Run every new CPU signature under the capture guard (tests)."""
    global _check_capture
    saved = _check_capture
    _check_capture = True
    try:
        yield
    finally:
        _check_capture = saved
