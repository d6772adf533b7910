"""fault-coverage pass: fault sites, registry, and chaos tests stay closed.

CockroachDB's testing knobs only earn their keep while some test actually
drives each failure path. This tree rule closes the loop over three sets:

1. every ``faults.fire(...)``/``fire_scoped``/``partial_fraction`` call in
   product code must name a site registered in ``utils/faults.py``'s
   ``SITES`` literal (an unregistered site is invisible to the chaos
   matrix — nothing will ever test it);
2. every registered site must have at least one product fire call (a dead
   registration documents a failure mode nothing can inject);
3. when test files are in the linted set, every registered site must be
   exercised by at least one chaos-marked test — a test that names the
   site (or a node-scoped ``<site>.n<id>`` variant) in a string literal.

:func:`site_matrix` exposes the site↔test mapping;
a chaos matrix runner consumes it and refuses to run a matrix with
uncovered sites. Waive a finding with
``# crlint: allow-fault-coverage(reason)`` on the offending line (for
registry findings: the site's ``SITES`` entry line).
"""

from __future__ import annotations

import ast
import re

from .core import Finding, SourceFile, attr_chain

RULE = "fault-coverage"

_FIRE_FUNCS = {"fire", "fire_scoped", "partial_fraction"}
_SCOPED_SUFFIX = re.compile(r"\.n\d+$")


def _registry(files: list[SourceFile]):
    """(sites dict, entry-line dict, faults.py rel) from the SITES literal;
    (None, None, None) when utils/faults.py is not in the linted set."""
    for f in files:
        if f.rel != "cockroach_tpu_torch/utils/faults.py":
            continue
        for node in f.tree.body:
            tgt = None
            if isinstance(node, ast.AnnAssign):
                tgt, value = node.target, node.value
            elif isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt, value = node.targets[0], node.value
            if (isinstance(tgt, ast.Name) and tgt.id == "SITES"
                    and isinstance(value, ast.Dict)):
                sites, lines = {}, {}
                for k, v in zip(value.keys, value.values):
                    if isinstance(k, ast.Constant):
                        sites[k.value] = (v.value
                                          if isinstance(v, ast.Constant)
                                          else "")
                        lines[k.value] = k.lineno
                return sites, lines, f.rel
    return None, None, None


def _fire_calls(files: list[SourceFile]):
    """(rel, line, site-literal-or-None) for every fire-family call in
    product code (tests drive sites through arm(), not through fire)."""
    out = []
    for f in files:
        if not f.rel.startswith("cockroach_tpu_torch/"):
            continue
        if f.rel == "cockroach_tpu_torch/utils/faults.py":
            continue
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if not chain or chain[-1] not in _FIRE_FUNCS:
                continue
            # faults.fire(...) / fire(...) — either spelling
            if len(chain) > 1 and chain[-2] not in ("faults",):
                continue
            site = None
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                site = node.args[0].value
            out.append((f.rel, node.lineno, site))
    return out


def _is_chaos_marked(tree: ast.Module) -> bool:
    """Module-level ``pytestmark = pytest.mark.chaos`` (or a list holding
    it)."""
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        t = node.targets[0]
        if not (isinstance(t, ast.Name) and t.id == "pytestmark"):
            continue
        marks = (node.value.elts
                 if isinstance(node.value, (ast.List, ast.Tuple))
                 else [node.value])
        for m in marks:
            chain = attr_chain(m)
            if chain and chain[-1] == "chaos":
                return True
    return False


def _has_chaos_decorator(fn: ast.AST) -> bool:
    for dec in getattr(fn, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        chain = attr_chain(target)
        if chain and "chaos" in chain:
            return True
    return False


def _chaos_tests(files: list[SourceFile]):
    """test-id -> set of string literals appearing in its body. Literals
    in a module-level helper are attributed to every chaos test in that
    module that calls the helper (tests routinely factor arm() specs into
    helpers)."""
    out: dict[str, set] = {}
    for f in files:
        if not f.rel.startswith("tests/"):
            continue
        module_chaos = _is_chaos_marked(f.tree)
        helper_literals: dict[str, set] = {}
        for node in f.tree.body:
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not node.name.startswith("test_")):
                helper_literals[node.name] = {
                    s.value for s in ast.walk(node)
                    if isinstance(s, ast.Constant)
                    and isinstance(s.value, str)
                }
        for node in f.tree.body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not node.name.startswith("test_"):
                continue
            if not (module_chaos or _has_chaos_decorator(node)):
                continue
            lits: set = set()
            called: set = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Constant) \
                        and isinstance(sub.value, str):
                    lits.add(sub.value)
                if isinstance(sub, ast.Call):
                    chain = attr_chain(sub.func)
                    if chain:
                        called.add(chain[-1])
            for h in called & set(helper_literals):
                lits |= helper_literals[h]
            out[f"{f.rel}::{node.name}"] = lits
    return out


def site_matrix(files: list[SourceFile]) -> dict[str, list[str]]:
    """site -> sorted chaos tests naming it (directly or node-scoped)."""
    sites, _, _ = _registry(files)
    if not sites:
        return {}
    tests = _chaos_tests(files)
    matrix: dict[str, list[str]] = {s: [] for s in sites}
    for test_id, lits in tests.items():
        hit = {_SCOPED_SUFFIX.sub("", s) for s in lits}
        for s in sites:
            if s in hit:
                matrix[s].append(test_id)
    return {s: sorted(ts) for s, ts in matrix.items()}


def check(files: list[SourceFile], cache=None) -> list[Finding]:
    sites, entry_lines, faults_rel = _registry(files)
    if sites is None:
        return []  # fixture trees without the registry: nothing to close
    findings: list[Finding] = []
    fired: set = set()
    for rel, line, site in _fire_calls(files):
        if site is None:
            findings.append(Finding(
                RULE, rel, line,
                "fault site is not a string literal — the chaos matrix "
                "cannot map a computed site name to tests",
            ))
            continue
        base = _SCOPED_SUFFIX.sub("", site)
        fired.add(base)
        if base not in sites:
            findings.append(Finding(
                RULE, rel, line,
                f"fault site {site!r} is not registered in "
                "utils/faults.py SITES — register it (with a one-line "
                "description) so the chaos matrix can see it",
            ))
    for site, line in entry_lines.items():
        if site not in fired:
            findings.append(Finding(
                RULE, faults_rel, line,
                f"registered fault site {site!r} has no fire call in "
                "product code — a dead registration documents a failure "
                "mode nothing can inject",
            ))
    has_tests = any(f.rel.startswith("tests/") for f in files)
    if has_tests:
        matrix = site_matrix(files)
        for site, tests in matrix.items():
            if not tests:
                findings.append(Finding(
                    RULE, faults_rel, entry_lines[site],
                    f"registered fault site {site!r} is not exercised by "
                    "any chaos-marked test — add one (or waive with a "
                    "reason) so run_chaos_matrix.py covers it",
                ))
    return findings
