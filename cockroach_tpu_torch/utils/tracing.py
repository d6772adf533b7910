"""Tracing — the port of the parts of ``cockroach_tpu.utils.tracing``
that EXPLAIN ANALYZE, the statement diagnostics bundles and
``crdb_internal.node_inflight_trace_spans`` read: a span tree per
operation, and the registry of open spans.

- ``span(name)`` opens a span under the current one (a new root when
  nothing is traced); the current span lives in a ContextVar, so
  concurrent threads keep disjoint trees. Every open span is listed in
  its tracer's inflight registry (``inflight()``) until it closes.
- ``synthetic_span`` attaches an already-measured child (the runtime folds
  each operator's ComponentStats into one after the pull loop).
- ``leaf_span`` exists only while an operation is already being traced.
  The storage slice starts no trace of its own, so its leaf spans record
  nothing; the call sites stay where the reference has them.
- ``Span.to_dict`` is the recording a diagnostics bundle keeps.

The reference's cross-node propagation (``remote_span``, ``graft``,
``context``) and its ring of finished roots serve modules the port has
not got (flow/disthost.py, kv/rpc.py); they are not copied.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field, is_dataclass
from typing import Any

_ids = itertools.count(1)
_id_lock = threading.Lock()


def _next_id() -> int:
    with _id_lock:
        return next(_ids)


def _jsonable(v: Any):
    """Best-effort JSON projection for tags and records (ComponentStats
    carries __slots__; unknown objects degrade to repr)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(i) for i in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    slots = getattr(type(v), "__slots__", None)
    if slots:
        return {s: _jsonable(getattr(v, s, None)) for s in slots}
    if is_dataclass(v) and not isinstance(v, type):
        import dataclasses

        return {f.name: _jsonable(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    return repr(v)


@dataclass
class Span:
    name: str
    trace_id: int = 0
    span_id: int = 0
    parent_id: int = 0
    start: float = 0.0       # perf_counter seconds (durations)
    start_wall: float = 0.0  # epoch seconds
    duration: float = 0.0    # seconds
    tags: dict[str, Any] = field(default_factory=dict)
    records: list[Any] = field(default_factory=list)
    children: list["Span"] = field(default_factory=list)
    error: str | None = None

    def record(self, payload: Any) -> None:
        """Attach a structured payload (ComponentStats and the like)."""
        self.records.append(payload)

    def tree(self, indent: int = 0) -> str:
        out = [f"{'  ' * indent}{self.name}: {self.duration * 1e3:.2f}ms"
               + (f" {self.tags}" if self.tags else "")]
        for c in self.children:
            out.append(c.tree(indent + 1))
        return "\n".join(out)

    def to_dict(self) -> dict:
        """JSON-serializable recording (the bundle shape)."""
        d = {
            "name": self.name,
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "startWallMs": round(self.start_wall * 1e3, 3),
            "durationMs": round(self.duration * 1e3, 4),
            "tags": _jsonable(self.tags),
            "children": [c.to_dict() for c in self.children],
        }
        if self.records:
            d["records"] = _jsonable(self.records)
        if self.error:
            d["error"] = self.error
        return d


MAX_CHILDREN = 128  # per-span child cap (the reference's)


class Tracer:
    """Per-process tracer: the current span rides a ContextVar, so every
    thread (a pgwire connection, a warm-menu worker) nests its own tree;
    open spans are visible through ``inflight()`` for crdb_internal."""

    def __init__(self):
        self._current: ContextVar[Span | None] = ContextVar(
            f"crdb_tpu_trace_{id(self)}", default=None)
        self._inflight: dict[int, Span] = {}
        self._if_lock = threading.Lock()

    @contextmanager
    def span(self, name: str, **tags):
        yield from self._run_span(Span(name=name, tags=dict(tags)))

    def _run_span(self, s: Span):
        parent = self._current.get()
        s.span_id = _next_id()
        s.start = time.perf_counter()
        s.start_wall = time.time()
        if parent is not None:
            s.trace_id = parent.trace_id
            s.parent_id = parent.span_id
            if len(parent.children) < MAX_CHILDREN:
                parent.children.append(s)
            else:
                parent.tags["dropped_children"] = (
                    parent.tags.get("dropped_children", 0) + 1)
        else:
            s.trace_id = s.span_id
        with self._if_lock:
            self._inflight[s.span_id] = s
        token = self._current.set(s)
        try:
            yield s
        except BaseException as e:
            if s.error is None:
                s.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            s.duration = time.perf_counter() - s.start
            self._current.reset(token)
            with self._if_lock:
                self._inflight.pop(s.span_id, None)

    def synthetic_span(self, parent: Span, name: str, duration_s: float,
                       **tags) -> Span:
        """Attach an already-measured child span (execstats folding)."""
        s = Span(name=name, trace_id=parent.trace_id,
                 span_id=_next_id(), parent_id=parent.span_id,
                 start_wall=parent.start_wall, duration=duration_s,
                 tags=dict(tags))
        parent.children.append(s)
        return s

    def inflight(self) -> list[Span]:
        """Open spans, oldest first (node_inflight_trace_spans). The
        returned Span objects are live: readers must not mutate them."""
        with self._if_lock:
            return sorted(self._inflight.values(), key=lambda s: s.start)


# process-global default tracer
DEFAULT = Tracer()


def span(name: str, **tags):
    """A span timed over the block, a child of the current span."""
    return DEFAULT.span(name, **tags)


def synthetic_span(parent: Span, name: str, duration_s: float,
                   **tags) -> Span:
    """Attach an already-measured child span to `parent`."""
    return DEFAULT.synthetic_span(parent, name, duration_s, **tags)


def inflight() -> list[Span]:
    return DEFAULT.inflight()


@contextmanager
def leaf_span(name: str, **tags):
    del name, tags
    yield None
