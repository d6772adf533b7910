"""raw-jit pass: every graph capture routes through flow/dispatch.jit.

flow/dispatch.py wraps the engine's compile step — one CUDA graph capture
per signature, replayed after — so every call of a composed function
bumps ``sql_kernel_dispatches`` and every capture is counted, which is
what EXPLAIN ANALYZE's ``kernel dispatches:`` line and the capture
checks are built on. A raw ``torch.cuda.graph`` / ``torch.cuda.CUDAGraph``
capture or a ``torch.compile`` anywhere else creates device programs
invisible to that accounting: the counts keep passing while the real
dispatch and capture counts regress.

Flagged: any reference (call, ``functools.partial`` argument, assignment)
to ``torch.cuda.graph``, ``torch.cuda.CUDAGraph``,
``torch.cuda.make_graphed_callables`` or ``torch.compile``, or those names
imported from ``torch``/``torch.cuda`` directly.

Exempt: cockroach_tpu_torch/flow/dispatch.py (the wrapper itself). A
program that deliberately stays outside flow accounting carries
``# crlint: allow-raw-jit(<why>)``.
"""

from __future__ import annotations

import ast

from .core import Finding, SourceFile, attr_chain

RULE = "raw-jit"

EXEMPT = ("cockroach_tpu_torch/lint/", "cockroach_tpu_torch/flow/dispatch.py")
_ENTRY = {("torch", "cuda", "graph"), ("torch", "cuda", "CUDAGraph"),
          ("torch", "cuda", "make_graphed_callables"), ("torch", "compile")}
_FROM = {"torch": {"compile"},
         "torch.cuda": {"graph", "CUDAGraph", "make_graphed_callables"}}


def check(src: SourceFile) -> list[Finding]:
    if src.rel.startswith(EXEMPT[0]) or src.rel == EXEMPT[1]:
        return []
    # names imported straight off torch: `from torch.cuda import graph as G`
    direct: set[str] = set()
    for node in ast.walk(src.tree):
        if isinstance(node, ast.ImportFrom) and node.module in _FROM:
            for a in node.names:
                if a.name in _FROM[node.module]:
                    direct.add(a.asname or a.name)
    out: list[Finding] = []
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Attribute):
            chain = attr_chain(node)
            if chain in _ENTRY:
                out.append(Finding(
                    RULE, src.rel, node.lineno,
                    f"raw {'.'.join(chain)} bypasses flow/dispatch "
                    "accounting — route through dispatch.jit so "
                    "sql_kernel_dispatches and the capture count see it"))
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if node.func.id in direct:
                out.append(Finding(
                    RULE, src.rel, node.lineno,
                    f"raw torch {node.func.id}() bypasses flow/dispatch "
                    "accounting — route through dispatch.jit"))
    return out
