"""unused-import pass: imported names must be referenced.

Dead imports are how dead code starts: a refactor drops the last use, the
import survives, and the module keeps paying (and advertising) a
dependency it no longer has — worse here, where importing torch-adjacent
modules is expensive. AST-accurate: a binding counts as used if its name
appears as a ``Name`` node anywhere else in the module or in an
``__all__`` string list (re-export). ``__init__.py`` files are exempt
wholesale (their imports ARE the public surface); deliberate shim
re-exports elsewhere carry ``# crlint: allow-unused-import(<why>)``.
"""

from __future__ import annotations

import ast

from .core import Finding, SourceFile

RULE = "unused-import"


def _bindings(tree: ast.AST) -> list[tuple[str, int, str]]:
    """(bound name, line, display) for every import binding."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                name = a.asname or a.name.split(".")[0]
                out.append((name, node.lineno, a.name))
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                out.append((a.asname or a.name, node.lineno, a.name))
    return out


def check(src: SourceFile) -> list[Finding]:
    if src.rel.endswith("__init__.py"):
        return []
    used: set[str] = set()
    exported: set[str] = set()
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets
                       if isinstance(t, ast.Name)]
            if "__all__" in targets and isinstance(
                    node.value, (ast.List, ast.Tuple)):
                for elt in node.value.elts:
                    if isinstance(elt, ast.Constant) and isinstance(
                            elt.value, str):
                        exported.add(elt.value)
    out: list[Finding] = []
    for name, line, display in _bindings(src.tree):
        if name in used or name in exported:
            continue
        out.append(Finding(
            RULE, src.rel, line,
            f"import {display!r} (bound as {name!r}) is never used"))
    return out
