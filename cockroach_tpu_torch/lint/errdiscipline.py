"""broad-except pass: error discipline for the distributed plane.

The KV retry work made swallowed exceptions a correctness bug class: a
``WriteIntentError`` or ``AmbiguousResultError`` silently eaten inside
``kv/`` turns exactly-once semantics into maybe-twice, and a flow-layer
swallow turns a failed fragment into a wrong answer instead of a degraded
query. So inside ``kv/``, ``flow/``, ``server/``:

- every ``except Exception`` / ``except BaseException`` handler must
  contain a ``raise`` (bare re-raise or a typed error), or carry a
  ``# crlint: allow-broad-except(<why>)`` pragma on the except line —
  background loops that log-and-continue by design document it there;
- a handler whose entire body is ``pass`` (or ``...``) is a HARD error:
  no pragma suppresses it. Swallowing with zero trace is never a policy —
  at minimum the handler names a narrower exception type or logs.
"""

from __future__ import annotations

import ast

from .core import Finding, SourceFile

RULE = "broad-except"

SCOPE = ("cockroach_tpu_torch/kv/", "cockroach_tpu_torch/flow/", "cockroach_tpu_torch/server/")
_BROAD = {"Exception", "BaseException"}


def _broad_names(type_node: ast.AST | None) -> bool:
    if type_node is None:  # bare `except:` is BaseException
        return True
    nodes = type_node.elts if isinstance(type_node, ast.Tuple) else [type_node]
    for n in nodes:
        if isinstance(n, ast.Name) and n.id in _BROAD:
            return True
    return False


def _is_silent(body: list[ast.stmt]) -> bool:
    for stmt in body:
        if isinstance(stmt, ast.Pass):
            continue
        if (isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Constant)):
            continue  # docstring / `...`
        return False
    return True


def check(src: SourceFile) -> list[Finding]:
    if not src.rel.startswith(SCOPE):
        return []
    out: list[Finding] = []
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _broad_names(node.type):
            continue
        if _is_silent(node.body):
            out.append(Finding(
                RULE, src.rel, node.lineno,
                "silent `except Exception: pass` swallow — catch a typed "
                "exception, or raise/log; no pragma excuses a zero-trace "
                "swallow", suppressible=False))
        elif not any(isinstance(n, ast.Raise) for n in ast.walk(node)):
            out.append(Finding(
                RULE, src.rel, node.lineno,
                "broad `except Exception` without re-raise — re-raise, "
                "raise a typed error, or pragma the deliberate "
                "log-and-continue"))
    return out
