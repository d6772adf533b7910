"""Tracing — the port of the parts of ``cockroach_tpu.utils.tracing``
that EXPLAIN ANALYZE reads: a span tree per traced query.

- ``span(name)`` opens a span under the current one (a new root when
  nothing is traced); the current span lives in a ContextVar, so
  concurrent threads keep disjoint trees.
- ``synthetic_span`` attaches an already-measured child (the runtime folds
  each operator's ComponentStats into one after the pull loop).
- ``leaf_span`` exists only while an operation is already being traced.
  The storage slice starts no trace of its own, so its leaf spans record
  nothing; the call sites stay where the reference has them.
"""

from __future__ import annotations

import contextlib
import time
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any


@dataclass
class Span:
    name: str
    duration: float = 0.0  # seconds
    tags: dict[str, Any] = field(default_factory=dict)
    records: list[Any] = field(default_factory=list)
    children: list["Span"] = field(default_factory=list)

    def record(self, payload: Any) -> None:
        """Attach a structured payload (ComponentStats and the like)."""
        self.records.append(payload)

    def tree(self, indent: int = 0) -> str:
        out = [f"{'  ' * indent}{self.name}: {self.duration * 1e3:.2f}ms"
               + (f" {self.tags}" if self.tags else "")]
        for c in self.children:
            out.append(c.tree(indent + 1))
        return "\n".join(out)


_current: ContextVar[Span | None] = ContextVar("span", default=None)


@contextlib.contextmanager
def span(name: str, **tags):
    """A span timed over the block, a child of the current span."""
    s = Span(name=name, tags=dict(tags))
    parent = _current.get()
    if parent is not None:
        parent.children.append(s)
    tok = _current.set(s)
    t0 = time.perf_counter()
    try:
        yield s
    finally:
        s.duration = time.perf_counter() - t0
        _current.reset(tok)


def synthetic_span(parent: Span, name: str, duration_s: float,
                   **tags) -> Span:
    """Attach an already-measured child span to `parent`."""
    s = Span(name=name, duration=duration_s, tags=dict(tags))
    parent.children.append(s)
    return s


@contextlib.contextmanager
def leaf_span(name: str, **tags):
    del name, tags
    yield None
