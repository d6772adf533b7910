"""CLI: ``python -m cockroach_tpu_torch.lint [--json] [--rule R ...] paths...``

Exit codes (the contract CI and editors key on):

* **0** — clean: every selected pass ran, no unsuppressed finding.
* **1** — findings: the tree violates an invariant (or waives one
  without a reason).
* **2** — internal error: the linter itself failed to run (unparseable
  file, unreadable path, bad arguments) — distinct from 1 so a wrapper
  can tell "the gate failed" from "the gate is broken".

``--changed-only FILE`` reads a newline-separated path list (typically
``git diff --name-only``) and reports only findings landing in those
files. The WHOLE path set is still linted — tree rules (lock-order,
shared-state, fault-coverage, untimed-wait, race-coverage) need the
full cross-module graph to be sound — only the report is filtered, so a
pre-commit hook gets correct findings fast without a pass silently
reasoning over half a program. ``--changed-only --git`` skips the file:
the changed set is computed directly from ``git diff --name-only HEAD``
(staged + unstaged) in the current repo.

``--timings`` prints per-pass wall seconds (plus the shared load/parse
step) to stderr — the budget the shared TreeCache defends.

``--race-map`` prints the race-coverage field↔site map — every shared
state the whole-program analysis sees with its coverage status
(locked / instrumented / atomic-publish / UNCOVERED / ...) — and exits
0; findings still come from the normal pass.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

from .core import ALL_RULES, report_json, report_text, run_lint


def _changed_set(list_path: str) -> set[str]:
    """Posix-normalized path suffixes from a git-diff-style file list
    (blank lines and non-.py entries dropped)."""
    out = set()
    for line in pathlib.Path(list_path).read_text().splitlines():
        line = line.strip()
        if line and line.endswith(".py"):
            out.add(pathlib.PurePath(line).as_posix())
    return out


def _git_changed_set() -> set[str]:
    """Changed .py files straight from git: staged + unstaged vs HEAD,
    plus untracked — the exact set a pre-commit hook cares about."""
    out: set[str] = set()
    has_head = subprocess.run(
        ["git", "rev-parse", "--verify", "-q", "HEAD"],
        capture_output=True, timeout=30).returncode == 0
    # unborn branch (no commits yet): everything tracked is new
    diff_cmd = (["git", "diff", "--name-only", "HEAD"] if has_head
                else ["git", "ls-files"])
    for cmd in (diff_cmd,
                ["git", "ls-files", "--others", "--exclude-standard"]):
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=30)
        if res.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd)} failed: {res.stderr.strip()}")
        for line in res.stdout.splitlines():
            line = line.strip()
            if line and line.endswith(".py"):
                out.add(pathlib.PurePath(line).as_posix())
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cockroach_tpu_torch.lint",
        description="crlint: repo-specific AST static analysis")
    ap.add_argument("paths", nargs="+",
                    help="files or directories to lint")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings (stable file:line "
                         "order)")
    ap.add_argument("--rule", action="append", choices=ALL_RULES,
                    help="run only this rule (repeatable)")
    ap.add_argument("--changed-only", metavar="FILE", nargs="?",
                    const="", default=None,
                    help="newline-separated path list; lint everything "
                         "but report only findings in these files "
                         "(with --git the list comes from git itself)")
    ap.add_argument("--git", action="store_true",
                    help="with --changed-only: take the changed set "
                         "from 'git diff --name-only HEAD' + untracked "
                         "files instead of a list file")
    ap.add_argument("--timings", action="store_true",
                    help="print per-pass wall seconds to stderr")
    ap.add_argument("--race-map", action="store_true", dest="race_map",
                    help="print the race-coverage field↔site map and "
                         "exit 0 (no findings report)")
    args = ap.parse_args(argv)
    if args.changed_only == "" and not args.git:
        print("crlint: --changed-only needs a FILE (or --git)",
              file=sys.stderr)
        return 2
    try:
        if args.race_map:
            from .core import TreeCache, load_files
            from .racecoverage import coverage_map, render_map

            files = load_files(args.paths)
            print(render_map(coverage_map(files, TreeCache(files))))
            return 0
        timings: dict[str, float] = {}
        findings = run_lint(args.paths,
                            tuple(args.rule) if args.rule else None,
                            timings=timings)
        if args.changed_only is not None:
            changed = (_git_changed_set() if args.git
                       else _changed_set(args.changed_only))
            findings = [f for f in findings
                        if f.path in changed
                        or any(c.endswith("/" + f.path) for c in changed)]
    except Exception as e:
        # the linter failing to run is NOT a finding — exit 2 so CI can
        # distinguish a broken gate from a dirty tree
        print(f"crlint: internal error: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2
    if args.timings:
        width = max((len(k) for k in timings), default=0)
        for name, secs in sorted(timings.items(),
                                 key=lambda kv: -kv[1]):
            print(f"  {name:<{width}}  {secs:7.3f}s", file=sys.stderr)
        print(f"  {'total':<{width}}  {sum(timings.values()):7.3f}s",
              file=sys.stderr)
    if args.as_json:
        print(report_json(findings))
    elif findings:
        print(report_text(findings), file=sys.stderr)
    else:
        rules = ", ".join(args.rule) if args.rule else "all rules"
        print(f"crlint clean ({rules}) over {', '.join(args.paths)}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
