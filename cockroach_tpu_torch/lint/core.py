"""crlint framework: file loading, pragma handling, rule registry, reporters.

A rule is a function ``check(file: SourceFile) -> list[Finding]`` (per-file
rules) or ``check(files: list[SourceFile]) -> list[Finding]`` (tree rules —
the lock-order pass needs the whole cross-module graph). Findings are
suppressed by an inline pragma on the finding line or the line directly
above it::

    x = int(count)  # crlint: allow-host-sync(one sync at query end, by design)

The reason is mandatory: a bare ``allow-<rule>()`` does not suppress (the
pragma exists to document WHY the invariant is waived, not to mute it).
Findings with ``suppressible=False`` (silent ``except: pass`` swallows)
ignore pragmas entirely.
"""

from __future__ import annotations

import ast
import json
import pathlib
import re
import time
import tokenize
from dataclasses import dataclass, field

_PRAGMA = re.compile(r"#\s*crlint:\s*allow-([a-z0-9_-]+)\(([^()]*)\)")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # canonical package-relative posix path
    line: int
    message: str
    suppressible: bool = True

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class SourceFile:
    path: pathlib.Path      # on-disk location
    rel: str                # canonical key rules match on (posix)
    text: str
    tree: ast.AST
    # line -> {rule: reason} pragmas (comments only — string literals that
    # happen to contain the pattern don't suppress)
    pragmas: dict[int, dict[str, str]] = field(default_factory=dict)
    # (start, end, rule) ranges from def/class-line pragmas: a pragma on a
    # function's `def` line (or the line above it) waives the rule for the
    # whole body — for functions that are host-side by design, one
    # documented waiver instead of one per statement
    scoped: list[tuple[int, int, str]] = field(default_factory=list)

    def __post_init__(self):
        import ast as _ast
        for node in _ast.walk(self.tree):
            if not isinstance(node, (_ast.FunctionDef,
                                     _ast.AsyncFunctionDef, _ast.ClassDef)):
                continue
            for ln in (node.lineno, node.lineno - 1):
                for rule, reason in self.pragmas.get(ln, {}).items():
                    if reason:
                        self.scoped.append(
                            (node.lineno, node.end_lineno or node.lineno,
                             rule))

    @property
    def modname(self) -> str:
        return self.rel[:-3].replace("/", ".") if self.rel.endswith(".py") \
            else self.rel.replace("/", ".")

    def allows(self, rule: str, line: int) -> bool:
        for ln in (line, line - 1):
            reason = self.pragmas.get(ln, {}).get(rule)
            if reason:  # empty reason does not suppress
                return True
        return any(start <= line <= end and rule == r
                   for start, end, r in self.scoped)


def _canonical_rel(path: pathlib.Path, root: pathlib.Path) -> str:
    """Path key rules match on: anchored at the last ``cockroach_tpu_torch``
    or ``tests`` component so fixture trees under tmp dirs scope exactly
    like the real tree."""
    parts = path.resolve().parts
    for anchor in ("cockroach_tpu_torch", "tests"):
        if anchor in parts[:-1]:
            i = len(parts) - 2 - parts[:-1][::-1].index(anchor)
            return "/".join(parts[i:])
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.name


def _collect_pragmas(text: str) -> dict[int, dict[str, str]]:
    pragmas: dict[int, dict[str, str]] = {}
    try:
        tokens = tokenize.generate_tokens(iter(text.splitlines(True)).__next__)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            for m in _PRAGMA.finditer(tok.string):
                pragmas.setdefault(tok.start[0], {})[m.group(1)] = \
                    m.group(2).strip()
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return pragmas


def load_files(paths: list[str | pathlib.Path]) -> list[SourceFile]:
    """Expand files/directories into parsed SourceFiles (sorted, deduped;
    __pycache__ skipped). Unparseable files raise — a syntax error in the
    tree is itself a finding-worthy failure, loudly."""
    roots = [pathlib.Path(p) for p in paths]
    seen: dict[pathlib.Path, SourceFile] = {}
    for root in roots:
        files = [root] if root.is_file() else sorted(root.rglob("*.py"))
        base = root if root.is_dir() else root.parent
        for path in files:
            rp = path.resolve()
            if rp in seen or "__pycache__" in path.parts:
                continue
            text = path.read_text()
            seen[rp] = SourceFile(
                path=path,
                rel=_canonical_rel(path, base),
                text=text,
                tree=ast.parse(text, filename=str(path)),
                pragmas=_collect_pragmas(text),
            )
    return sorted(seen.values(), key=lambda f: f.rel)


class TreeCache:
    """Single-parse whole-program cache shared by the tree passes.

    The tree is parsed exactly once per ``run_lint`` (``load_files``);
    this cache extends that sharing to the DERIVED structures the graph
    passes each need: per-module symbol indexes (lock tables, function
    tables — ``lockorder._ModuleIndex``) and the whole-program
    thread-entry/call-graph analysis (``sharedstate.program``). Before
    it existed, lock-order and shared-state each rebuilt every module
    index, and the three graph passes (shared-state, untimed-wait,
    race-coverage) would each have re-run the ~same multi-second escape
    analysis — the cache is what keeps the 13-pass suite inside the
    10-pass wall-time budget.

    Keys are arbitrary hashables; ``memo`` runs ``build`` once and
    returns the cached value thereafter. A cache instance is only valid
    for the one file list it was built with (``run_lint`` constructs a
    fresh one per invocation).
    """

    def __init__(self, files: list[SourceFile]):
        self.files = files
        self.by_rel = {f.rel: f for f in files}
        self._memo: dict = {}

    def memo(self, key, build):
        if key not in self._memo:
            self._memo[key] = build()
        return self._memo[key]

    def index(self, f: SourceFile):
        """Memoized ``lockorder._ModuleIndex`` for one file, with
        ``mod_globals`` populated (the shared-state extension)."""
        def build():
            from .lockorder import _ModuleIndex
            from .sharedstate import _mod_globals

            idx = _ModuleIndex(f)
            idx.mod_globals = _mod_globals(f, idx)
            return idx
        return self.memo(("idx", f.rel), build)


def attr_chain(node: ast.AST) -> tuple[str, ...] | None:
    """('torch','compile') for ``torch.compile``; None when the base isn't a
    Name."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _rules():
    # late import: the rule modules import core for helpers
    from . import (blocking, errdiscipline, faultcoverage, hostsync,
                   lockorder, memaccounting, racecoverage, rawjit,
                   sharedstate, tracepurity, tracingapi, unusedimport)
    per_file = {
        "host-sync": hostsync.check,
        "raw-jit": rawjit.check,
        "broad-except": errdiscipline.check,
        "unused-import": unusedimport.check,
        "tracing-api": tracingapi.check,
        "mem-accounting": memaccounting.check,
        "recompile-hazard": tracepurity.check,
    }
    tree = {
        "lock-order": lockorder.check,
        "shared-state": sharedstate.check,
        "fault-coverage": faultcoverage.check,
        "untimed-wait": blocking.check,
        "race-coverage": racecoverage.check,
    }
    return per_file, tree


ALL_RULES = ("host-sync", "raw-jit", "broad-except", "unused-import",
             "lock-order", "tracing-api", "shared-state", "mem-accounting",
             "fault-coverage", "untimed-wait", "recompile-hazard",
             "race-coverage", "unknown-pragma")


def _unknown_pragmas(files: list[SourceFile]) -> list[Finding]:
    """A pragma naming a rule crlint doesn't know suppresses NOTHING —
    usually a typo ('alow-host-sync', 'mem-acounting') silently leaving
    the author convinced a finding is waived. That near-miss is itself a
    finding."""
    known = set(ALL_RULES)
    out = []
    for f in files:
        for ln in sorted(f.pragmas):
            for rule in f.pragmas[ln]:
                if rule not in known:
                    out.append(Finding(
                        "unknown-pragma", f.rel, ln,
                        f"pragma waives unknown rule {rule!r} — no such "
                        "pass exists, so this suppresses nothing "
                        f"(known rules: {', '.join(sorted(known))})",
                    ))
    return out


def run_lint(paths: list[str | pathlib.Path],
             rules: tuple[str, ...] | None = None,
             timings: dict[str, float] | None = None) -> list[Finding]:
    """Run the selected passes; returns unsuppressed findings sorted by
    location. When ``timings`` is a dict it is filled with per-pass wall
    seconds (plus the one-time ``load/parse`` cost) so regressions in
    any single pass are attributable."""
    t0 = time.perf_counter()
    files = load_files(paths)
    cache = TreeCache(files)
    if timings is not None:
        timings["load/parse"] = time.perf_counter() - t0
    per_file, tree = _rules()
    wanted = set(rules or ALL_RULES)
    findings: list[Finding] = []
    by_rel = cache.by_rel

    def timed(name, run):
        t = time.perf_counter()
        out = run()
        if timings is not None:
            timings[name] = time.perf_counter() - t
        return out

    for name, check in per_file.items():
        if name not in wanted:
            continue
        findings.extend(timed(
            name, lambda c=check: [fd for f in files for fd in c(f)]))
    for name, check in tree.items():
        if name in wanted:
            findings.extend(timed(
                name, lambda c=check: c(files, cache=cache)))
    if "unknown-pragma" in wanted:
        findings.extend(timed(
            "unknown-pragma", lambda: _unknown_pragmas(files)))
    live = []
    for fd in findings:
        src = by_rel.get(fd.path)
        if fd.suppressible and src is not None and src.allows(fd.rule, fd.line):
            continue
        live.append(fd)
    # fully deterministic order (message included: two findings of one
    # rule can share a line) — reporters and CI diffs rely on stability
    return sorted(live, key=lambda f: (f.path, f.line, f.rule, f.message))


def report_text(findings: list[Finding]) -> str:
    return "\n".join(f.render() for f in findings)


def report_json(findings: list[Finding]) -> str:
    return json.dumps(
        [{"rule": f.rule, "path": f.path, "line": f.line,
          "message": f.message} for f in findings],
        indent=2,
    )
