"""race-coverage pass: multi-thread state is locked or racesan-sees it.

The Eraser-style runtime sanitizer (``utils/racesan.py``) only catches
races on state it is TOLD about — each ``note_read``/``note_write``
call is hand-placed, and "extend racesan as control-plane state grows"
is a chore nothing enforces; this pass turns it into a gate by joining
the shared-state escape analysis with the sanitizer's instrumentation
map:

- every state the whole-program analysis proves **multi-thread-
  reachable** (accessed under two or more entry points, with at least
  one non-init, non-GIL-atomic write) must be either

  1. **consistently lock-guarded** — one recognized lock common to the
     lockset of EVERY live access site (stricter than the shared-state
     pass, which only requires pairwise overlap on conflicting pairs),
     or
  2. **sanitizer-instrumented** — a ``racesan.note_read``/``note_write``
     call in the defining module naming the field as a string literal,
     so ``debug.race_detector.enabled`` runs actually check it.

New subsystems (coalesce trains, sharedscan subscriber maps, warm-menu
registries) therefore cannot land shared state the sanitizer never
sees: the lint gate trips until the state is either provably guarded or
instrumented. Deliberately lock-free structures that neither hold nor
want instrumentation carry
``# crlint: allow-race-coverage(<why safe>)`` on any access site (the
``__init__`` assignment is the ergonomic spot), same as shared-state.

``coverage_map`` exposes the full field↔site map — every analyzed
state with its status, guard and access sites — printed by the CLI via
``python -m cockroach_tpu_torch.lint --race-map``.
"""

from __future__ import annotations

import ast

from .core import Finding, SourceFile, attr_chain
from .sharedstate import Access, program

RULE = "race-coverage"

_NOTE_FUNCS = {"note_read", "note_write"}


def _instrumented_fields(files: list[SourceFile]) -> dict[str, set[str]]:
    """rel -> field names carrying a racesan note_* call with a string-
    literal field name in that module."""
    out: dict[str, set[str]] = {}
    for f in files:
        fields: set[str] = set()
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            name = chain[-1] if chain else None
            if name not in _NOTE_FUNCS:
                continue
            if chain and len(chain) > 1 and chain[-2] != "racesan":
                continue
            if len(node.args) >= 2 \
                    and isinstance(node.args[1], ast.Constant) \
                    and isinstance(node.args[1].value, str):
                fields.add(node.args[1].value)
        if fields:
            out[f.rel] = fields
    return out


def coverage_map(files: list[SourceFile], cache=None) -> list[dict]:
    """The field↔site map: one row per shared state the whole-program
    analysis sees, with its coverage status.

    status is one of:

    - ``locked`` — a common lock guards every live access (``guard``
      names it);
    - ``instrumented`` — racesan note_read/note_write calls name the
      field in its module;
    - ``atomic-publish`` — every non-init write is a plain GIL-atomic
      rebind (the documented lock-free pattern);
    - ``init-only`` — written only during construction;
    - ``single-entry`` — never reachable from two entry points;
    - ``read-only`` — no writes at all;
    - ``waived`` — would be UNCOVERED but an access site carries a
      reasoned ``allow-race-coverage`` pragma;
    - ``UNCOVERED`` — multi-thread-reachable writes with neither a
      common lock nor instrumentation: the race-coverage finding.
    """
    prog = program(files, cache)
    if prog is None:
        return []
    noted = _instrumented_fields(files)
    by_rel = {f.rel: f for f in files}

    by_state: dict[str, list[Access]] = {}
    for rec in prog.funcs.values():
        for a in rec.accesses:
            by_state.setdefault(a.state, []).append(a)

    rows: list[dict] = []
    for state, accesses in sorted(by_state.items()):
        live = [a for a in accesses if not a.in_init]
        writes = [a for a in live if a.kind == "w"]
        rel = accesses[0].rel
        field = state.rsplit(".", 1)[-1]
        entries: set = set()
        for a in live:
            entries |= prog.entries_of(a.func)
        guard: str | None = None
        if not writes:
            status = "read-only"
        elif len(entries) < 2:
            status = "single-entry"
        elif all(w.wkind == "rebind" and not w.rmw for w in writes):
            status = "atomic-publish"
        else:
            common = None
            for a in live:
                ls = prog.lockset(a)
                common = ls if common is None else (common & ls)
            if common:
                status = "locked"
                guard = sorted(common)[0]
            elif field in noted.get(rel, ()):
                status = "instrumented"
            else:
                status = "UNCOVERED"
        if not live and any(a.in_init for a in accesses):
            status = "init-only"
        sites = sorted({(a.rel, a.line, a.kind) for a in accesses},
                       key=lambda s: (s[0], s[1], s[2]))
        if status == "UNCOVERED":
            # state-wide pragma on ANY access site (incl. __init__),
            # same ergonomics as shared-state
            for srel, sline, _kind in sites:
                src = by_rel.get(srel)
                if src is not None and src.allows(RULE, sline):
                    status = "waived"
                    break
        rows.append({
            "state": state, "status": status, "guard": guard,
            "field": field, "rel": rel,
            "entries": sorted(str(e) for e in entries),
            "sites": sites,
        })
    return rows


def render_map(rows: list[dict]) -> str:
    """Human-readable field↔site map (the CLI's --race-map output)."""
    out = []
    for r in rows:
        guard = f" guard={r['guard']}" if r["guard"] else ""
        sites = ", ".join(f"{rel}:{line}({kind})"
                          for rel, line, kind in r["sites"])
        out.append(f"{r['state']}: {r['status']}{guard} — {sites}")
    return "\n".join(out)


def check(files: list[SourceFile], cache=None) -> list[Finding]:
    rows = coverage_map(files, cache)
    out: list[Finding] = []
    for r in rows:
        if r["status"] != "UNCOVERED":
            continue
        wsites = [s for s in r["sites"] if s[2] == "w"]
        anchor = wsites[0] if wsites else r["sites"][0]
        sites = ", ".join(f"{rel}:{line}" for rel, line, _k in r["sites"])
        out.append(Finding(
            RULE, anchor[0], anchor[1],
            f"{r['state']} is written from multiple thread entry points "
            "with no common lock across all access sites and no racesan "
            f"note_read/note_write instrumentation (sites: {sites}) — "
            "guard every access with one utils/locks lock, or add "
            f"racesan.note_* calls naming {r['field']!r} so the runtime "
            "race detector sees it, or waive with "
            "allow-race-coverage(reason)"))
    return sorted(out, key=lambda f: (f.path, f.line, f.message))
