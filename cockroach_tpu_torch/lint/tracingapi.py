"""tracing-api pass: spans come only through the contextvar API.

utils/tracing.py's Tracer owns span lifecycle: ``span``/``remote_span``/
``leaf_span`` set ids, register the span in the in-flight table, bind the
contextvar, and on exit compute duration and move roots into the finished
ring. A ``Span(...)`` constructed anywhere else produces a span that is
invisible to crdb_internal.node_inflight_trace_spans, never closes, and —
if appended to a live tree — double-counts in EXPLAIN ANALYZE. Likewise,
poking the tracer's contextvar or span stack directly breaks the
disjoint-per-session-tree invariant the concurrency tests pin down.

Flagged: any call of a ``Span`` name imported from utils.tracing, any
``tracing.Span(...)`` / ``*.Span(...)`` attribute call, and any attribute
access of ``_current``/``_stack``/``_run_span`` on a tracer object.

Exempt: cockroach_tpu_torch/utils/tracing.py itself (the API being guarded —
``from_dict`` and ``synthetic_span`` are its sanctioned constructors).
"""

from __future__ import annotations

import ast

from .core import Finding, SourceFile, attr_chain

RULE = "tracing-api"

EXEMPT = ("cockroach_tpu_torch/lint/", "cockroach_tpu_torch/utils/tracing.py")
_PRIVATE = {"_current", "_stack", "_run_span"}


def check(src: SourceFile) -> list[Finding]:
    if src.rel.startswith(EXEMPT[0]) or src.rel == EXEMPT[1]:
        return []
    # names bound off the tracing module: `from ..utils.tracing import Span`
    span_names: set[str] = set()
    for node in ast.walk(src.tree):
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module == "tracing"
                or node.module.endswith(".tracing")):
            for a in node.names:
                if a.name == "Span":
                    span_names.add(a.asname or a.name)
    out: list[Finding] = []
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id in span_names:
                out.append(Finding(
                    RULE, src.rel, node.lineno,
                    "direct Span() construction bypasses the contextvar "
                    "tracer — use tracing.span/leaf_span/remote_span (or "
                    "synthetic_span for post-hoc stats folding)"))
            elif isinstance(fn, ast.Attribute) and fn.attr == "Span":
                chain = attr_chain(fn)
                label = ".".join(chain) if chain else "<expr>.Span"
                out.append(Finding(
                    RULE, src.rel, node.lineno,
                    f"direct {label}() construction bypasses the "
                    "contextvar tracer — use tracing.span/leaf_span/"
                    "remote_span (or synthetic_span)"))
        elif isinstance(node, ast.Attribute) and node.attr in _PRIVATE:
            out.append(Finding(
                RULE, src.rel, node.lineno,
                f"direct access to tracer internals (.{node.attr}) breaks "
                "the per-session span-tree invariant — go through the "
                "tracing module API"))
    return out
