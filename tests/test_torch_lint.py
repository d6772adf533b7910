"""The port's crlint (cockroach_tpu_torch/lint/) against the reference's
(cockroach_tpu/lint/), and the port's tree held at zero findings.

- The nine language-neutral passes (broad-except, unused-import,
  tracing-api, lock-order, shared-state, untimed-wait, race-coverage,
  fault-coverage, unknown-pragma) and recompile-hazard, whose snippets
  name only ``dispatch``: each fixture tree is written twice, under each
  package's anchor in ``tmp_path``, and both linters must give the same
  set of (rule, package-relative path, line). Each case then makes the
  reference test's own assertion on the port's findings.
- The torch passes (host-sync, raw-jit, mem-accounting): torch-flavoured
  snippets, each flagged and each quiet case mirroring the reference's.
- The real tree: ``python -m cockroach_tpu_torch.lint cockroach_tpu_torch
  tests/test_torch_*.py chip_smoke.py`` exits 0 with no finding (linted
  once per module), and its lock graph is acyclic and non-empty.
- The CLI: exit codes 0/1/2, ``--changed-only`` and a stable ``--json``.
- The faults the port's lint found, each with a test that fails without
  its repair: TileStream.reset racing its fill thread, and an untimed
  socket read in flow/dcn.py.
"""

import contextlib
import io
import json
import os
import pathlib
import socket
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cockroach_tpu.lint import run_lint as jrun
from cockroach_tpu_torch.lint import lockorder
from cockroach_tpu_torch.lint import run_lint as trun
from cockroach_tpu_torch.lint.__main__ import main
from cockroach_tpu_torch.lint.core import ALL_RULES, TreeCache, load_files
from cockroach_tpu_torch.utils import settings

REPO = pathlib.Path(__file__).resolve().parent.parent
ANCHOR = {"jax": "cockroach_tpu", "torch": "cockroach_tpu_torch"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------- fixtures

def _write(base: pathlib.Path, files: dict[str, str], anchor: str) -> None:
    """Materialize {relpath: source} under base, with a leading "PKG/"
    replaced by the package anchor the passes scope on."""
    for rel, src in files.items():
        if rel.startswith("PKG/"):
            rel = anchor + rel[3:]
        p = base / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)


def _tree(tmp_path, files: dict[str, str]) -> pathlib.Path:
    """The port-only fixture tree; returns its package root."""
    _write(tmp_path, files, ANCHOR["torch"])
    return tmp_path / ANCHOR["torch"]


def _both(tmp_path, files: dict[str, str], rules=None, roots=("PKG",)):
    """Lint one fixture through both packages: (reference findings, port
    findings), the trees written side by side under tmp_path."""
    out = {}
    for name, run in (("jax", jrun), ("torch", trun)):
        base = tmp_path / name
        _write(base, files, ANCHOR[name])
        paths = [base / (ANCHOR[name] if r == "PKG" else r) for r in roots]
        out[name] = run(paths, rules=rules)
    return out["jax"], out["torch"]


def _keys(found) -> set:
    """(rule, package-relative path, line, suppressible) per finding."""
    out = set()
    for f in found:
        head, _, tail = f.path.partition("/")
        rel = "PKG/" + tail if head in ANCHOR.values() else f.path
        out.add((f.rule, rel, f.line, f.suppressible))
    return out


def _parity(tmp_path, files, rules=None, roots=("PKG",)):
    """The port's findings, after asserting they equal the reference's."""
    jf, tf = _both(tmp_path, files, rules, roots)
    assert _keys(tf) == _keys(jf), (
        [f.render() for f in jf], [f.render() for f in tf])
    return tf


def _rules(findings):
    return sorted({f.rule for f in findings})


# ------------------------------------------------------------- real tree

_REAL_PATHS = [str(REPO / "cockroach_tpu_torch"),
               *sorted(str(p) for p in (REPO / "tests").glob("test_torch_*.py")),
               str(REPO / "chip_smoke.py")]


@pytest.fixture(scope="module")
def real_tree():
    """One CLI run over the port's tree: its exit code and findings."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(_REAL_PATHS + ["--json"])
    return rc, json.loads(buf.getvalue())


def test_real_tree_is_clean(real_tree):
    rc, findings = real_tree
    assert rc == 0, "\n".join(
        f"{f['path']}:{f['line']}: [{f['rule']}] {f['message']}"
        for f in findings)
    assert findings == []


@pytest.mark.parametrize("rule", ALL_RULES)
def test_real_tree_passes_are_clean_individually(real_tree, rule):
    _, findings = real_tree
    assert not [f for f in findings if f["rule"] == rule]


def test_real_tree_lock_graph_acyclic():
    files = load_files([REPO / "cockroach_tpu_torch"])
    lock_names, edges = lockorder.build_lock_graph(files)
    assert lock_names, "lock indexing broke: no locks found in the tree"
    assert edges, "no lock-held call edges found in the tree"
    assert not lockorder.check(files)


def test_every_port_pragma_names_a_rule_and_a_reason():
    """Every waiver in the port's tree carries a non-empty reason (an
    empty one suppresses nothing) and a rule the reference also knows,
    so the reference's gate over tests/ accepts the port's test files."""
    from cockroach_tpu.lint.core import ALL_RULES as REF_RULES

    assert set(ALL_RULES) == set(REF_RULES)
    files = load_files(_REAL_PATHS)
    n = 0
    for f in files:
        for ln, rules in f.pragmas.items():
            for rule, reason in rules.items():
                n += 1
                assert rule in REF_RULES, f"{f.rel}:{ln}: {rule}"
                assert reason.strip(), f"{f.rel}:{ln}: empty reason"
    assert n > 0


# ------------------------------------------------------------- host-sync

_HOT = "PKG/flow/runtime.py"


def test_host_sync_flags_implicit_transfers(tmp_path):
    root = _tree(tmp_path, {_HOT: (
        "import numpy as np\n"
        "import torch\n"
        "def f(x, ev):\n"
        "    n = int(torch.sum(x))\n"        # int() on a device value
        "    v = x.item()\n"                 # .item()
        "    h = np.asarray(torch.abs(x))\n" # device -> host copy
        "    if torch.any(x):\n"             # truth test forces a sync
        "        pass\n"
        "    l = x.tolist()\n"
        "    c = x.cpu()\n"
        "    a = x.numpy()\n"
        "    torch.cuda.synchronize()\n"
        "    ev.synchronize()\n"
        "    return n, v, h, l, c, a\n")})
    found = trun([root], rules=("host-sync",))
    assert len(found) == 9, [f.render() for f in found]
    assert _rules(found) == ["host-sync"]


@pytest.mark.parametrize("rel", [
    "PKG/bench/baseline.py", "PKG/flow/wire.py", "PKG/flow/dcn.py",
    "PKG/flow/upload.py", "PKG/flow/external.py"])
def test_host_sync_scoped_to_hot_modules(tmp_path, rel):
    # the same code outside the hot path, or in a host-boundary module,
    # is not a finding
    src = "import torch\ndef f(x):\n    return int(torch.sum(x)), x.item()\n"
    assert not trun([_tree(tmp_path, {rel: src})], rules=("host-sync",))


def test_host_sync_pragma_and_host_literals(tmp_path):
    root = _tree(tmp_path, {_HOT: (
        "import numpy as np\n"
        "import torch\n"
        "def f(x, rows):\n"
        "    # crlint: allow-host-sync(one sync per query by design)\n"
        "    n = int(torch.sum(x))\n"
        "    a = np.asarray([1, 2, 3])\n"     # host literal: no readback
        "    if torch.is_floating_point(x):\n"  # host predicate
        "        pass\n"
        "    t = torch.as_tensor(rows)\n"     # host -> device is fine
        "    return n, a, t\n")})
    assert not trun([root], rules=("host-sync",))


# --------------------------------------------------------------- raw-jit

def test_raw_jit_flagged_outside_dispatch(tmp_path):
    root = _tree(tmp_path, {
        "PKG/ops/thing.py": (
            "import functools\n"
            "import torch\n"
            "from torch.cuda import graph as G\n"
            "f = torch.compile(lambda x: x)\n"
            "g = functools.partial(torch.cuda.graph, pool=None)\n"
            "h = torch.cuda.CUDAGraph()\n"
            "def cap(gr):\n"
            "    return G(gr)\n"),
        "PKG/flow/dispatch.py": (
            "import torch\n"
            "def jit(fn, **kw):\n"
            "    g = torch.cuda.CUDAGraph()\n"
            "    with torch.cuda.graph(g):\n"
            "        fn()\n"
            "    return g\n"),
    })
    found = trun([root], rules=("raw-jit",))
    # four sites in ops/thing.py (incl. the partial arg), none in dispatch
    assert len(found) == 4, [f.render() for f in found]
    assert all(f.path == "cockroach_tpu_torch/ops/thing.py" for f in found)


# ----------------------------------------------------------- broad-except

def test_silent_swallow_is_unsuppressible(tmp_path):
    found = _parity(tmp_path, {"PKG/kv/thing.py": (
        "def f():\n"
        "    try:\n"
        "        g()\n"
        "    # crlint: allow-broad-except(pragma must NOT mute this)\n"
        "    except Exception:\n"
        "        pass\n")}, rules=("broad-except",))
    assert len(found) == 1
    assert not found[0].suppressible


def test_broad_except_pragma_and_reraise(tmp_path):
    found = _parity(tmp_path, {"PKG/flow/thing.py": (
        "def ok_reraise():\n"
        "    try:\n"
        "        g()\n"
        "    except Exception:\n"
        "        raise\n"
        "def ok_pragma():\n"
        "    try:\n"
        "        g()\n"
        "    except Exception as e:  # crlint: allow-broad-except(logged)\n"
        "        log(e)\n"
        "def bad():\n"
        "    try:\n"
        "        g()\n"
        "    except Exception as e:\n"
        "        log(e)\n")}, rules=("broad-except",))
    assert len(found) == 1
    assert found[0].line > 10  # the finding is in bad()


def test_broad_except_scoped_outside_kv_flow_server(tmp_path):
    assert not _parity(tmp_path, {"PKG/bench/thing.py": (
        "def f():\n"
        "    try:\n"
        "        g()\n"
        "    except Exception:\n"
        "        pass\n")}, rules=("broad-except",))


# ------------------------------------------------------------ tracing-api

def test_tracing_api_flags_direct_span_construction(tmp_path):
    found = _parity(tmp_path, {
        "PKG/flow/thing.py": (
            "from ..utils import tracing\n"
            "from ..utils.tracing import Span\n"
            "def f(tr):\n"
            "    a = Span('x')\n"
            "    b = tracing.Span('y')\n"
            "    tr._current.set(a)\n"
            "    return a, b\n"),
        "PKG/utils/tracing.py": (
            "class Span:\n"
            "    pass\n"
            "def span(name):\n"
            "    return Span(name)\n"),
    }, rules=("tracing-api",))
    assert len(found) == 3, [f.render() for f in found]
    assert all(f.path == "cockroach_tpu_torch/flow/thing.py" for f in found)


def test_tracing_api_pragma_suppresses(tmp_path):
    assert not _parity(tmp_path, {"PKG/plan/thing.py": (
        "from ..utils import tracing\n"
        "def f():\n"
        "    # crlint: allow-tracing-api(test fixture builds a detached tree)\n"
        "    return tracing.Span('x')\n")}, rules=("tracing-api",))


def test_tracing_api_ignores_entered_spans(tmp_path):
    assert not _parity(tmp_path, {"PKG/kv/thing.py": (
        "from ..utils import tracing\n"
        "def f():\n"
        "    with tracing.span('a') as sp:\n"
        "        with tracing.leaf_span('b'):\n"
        "            pass\n"
        "    return tracing.synthetic_span(sp, 'c', 0.1)\n")},
        rules=("tracing-api",))


# ---------------------------------------------------------- unused-import

def test_unused_import_flagged_and_pragma(tmp_path):
    found = _parity(tmp_path, {"PKG/util.py": (
        "import os\n"
        "import sys  # crlint: allow-unused-import(re-export shim)\n"
        "import json\n"
        "print(json.dumps({}))\n")}, rules=("unused-import",))
    assert len(found) == 1
    assert "'os'" in found[0].message


def test_empty_pragma_reason_does_not_suppress(tmp_path):
    assert len(_parity(tmp_path, {"PKG/util.py": (
        "import os  # crlint: allow-unused-import()\n")},
        rules=("unused-import",))) == 1


# ------------------------------------------------------------- lock-order

def test_lock_order_cycle_through_call_graph(tmp_path):
    found = _parity(tmp_path, {"PKG/mod.py": (
        "import threading\n"
        "LOCK_A = threading.Lock()\n"
        "LOCK_B = threading.Lock()\n"
        "def path_one():\n"
        "    with LOCK_A:\n"
        "        with LOCK_B:\n"
        "            pass\n"
        "def path_two():\n"
        "    with LOCK_B:\n"
        "        helper()\n"
        "def helper():\n"
        "    with LOCK_A:\n"
        "        pass\n")}, rules=("lock-order",))
    assert len(found) == 1
    assert "cycle" in found[0].message


def test_lock_order_consistent_nesting_is_clean(tmp_path):
    assert not _parity(tmp_path, {"PKG/mod.py": (
        "import threading\n"
        "LOCK_A = threading.Lock()\n"
        "LOCK_B = threading.Lock()\n"
        "def one():\n"
        "    with LOCK_A:\n"
        "        with LOCK_B:\n"
        "            pass\n"
        "def two():\n"
        "    with LOCK_A:\n"
        "        with LOCK_B:\n"
        "            pass\n")}, rules=("lock-order",))


# ----------------------------------------------------------- shared-state

_RACY = (
    "import threading\n"
    "class W:\n"
    "    def __init__(self):\n"
    "        self.counter = 0\n"
    "        self._t = threading.Thread(target=self._loop, daemon=True)\n"
    "        self._t.start()\n"
    "    def _loop(self):\n"
    "        for _ in range(10):\n"
    "            self.counter += 1\n"
    "    def bump(self):\n"
    "        self.counter += 1\n"
)
_GUARDED = (
    "import threading\n"
    "from ..utils import locks\n"
    "class W:\n"
    "    def __init__(self):\n"
    "        self._mu = locks.lock('kv.widget')\n"
    "        self.counter = 0\n"
    "        self._t = threading.Thread(target=self._loop)\n"
    "        self._t.start()\n"
    "    def _loop(self):\n"
    "        with self._mu:\n"
    "            self.counter += 1\n"
    "    def bump(self):\n"
    "        with self._mu:\n"
    "            self.counter += 1\n")


def test_shared_state_flags_multi_entry_unlocked_rmw(tmp_path):
    found = _parity(tmp_path, {"PKG/kv/widget.py": _RACY},
                    rules=("shared-state",))
    assert len(found) == 1, [f.render() for f in found]
    assert found[0].rule == "shared-state"
    assert "counter" in found[0].message
    assert "no common lock" in found[0].message


def test_shared_state_lock_guard_is_quiet(tmp_path):
    assert not _parity(tmp_path, {"PKG/kv/widget.py": _GUARDED},
                       rules=("shared-state",))


@pytest.mark.parametrize("old,new", [
    ("    def bump(self):\n",
     "    def bump(self):\n"
     "        # crlint: allow-shared-state(single writer by protocol)\n"),
    ("    def bump(self):\n",
     "    # crlint: allow-shared-state(test-only mutator, documented)\n"
     "    def bump(self):\n"),
], ids=["inline", "def-line"])
def test_shared_state_pragma_suppresses(tmp_path, old, new):
    """An inline waiver, and a def-line waiver covering the body."""
    assert not _parity(tmp_path, {"PKG/kv/widget.py": _RACY.replace(
        old, new)}, rules=("shared-state",))


# --------------------------------------------------------- mem-accounting

_HOT_ALLOC = (
    "import numpy as np\n"
    "import torch\n"
    "def f(n, a, b):\n"
    "    x = np.zeros((n, 1024))\n"
    "    y = torch.zeros((n, 1024))\n"
    "    z = torch.cat([a, b])\n"
    "    return x, y, z\n"
)


def test_mem_accounting_flags_uncharged_hot_path_alloc(tmp_path):
    found = trun([_tree(tmp_path, {_HOT: _HOT_ALLOC})],
                 rules=("mem-accounting",))
    assert len(found) == 3, [f.render() for f in found]
    assert _rules(found) == ["mem-accounting"]
    msgs = " ".join(f.message for f in found)
    assert "np.zeros" in msgs and "torch.zeros" in msgs \
        and "torch.cat" in msgs


def test_mem_accounting_evidence_and_scope(tmp_path):
    # reserve() in the function is evidence; a dispatch.jit function's
    # allocations are its graph's temporaries; the same allocation in a
    # module off the hot path is out of scope
    root = _tree(tmp_path, {
        _HOT: ("import torch\n"
               "from . import dispatch\n"
               "def g(mon, n):\n"
               "    mon.reserve(n * 8192)\n"
               "    return torch.zeros((n, 1024))\n"
               "@dispatch.jit\n"
               "def h(n):\n"
               "    return torch.empty((n, 1024))\n"),
        "PKG/bench/gen.py": _HOT_ALLOC,
    })
    assert not trun([root], rules=("mem-accounting",))


def test_mem_accounting_small_literal_shape_is_quiet(tmp_path):
    root = _tree(tmp_path, {_HOT: (
        "import torch\n"
        "def f(x):\n"
        "    return torch.zeros((4, 8)), torch.empty(x.shape)\n")})
    assert not trun([root], rules=("mem-accounting",))


def test_mem_accounting_inline_pragma_suppresses(tmp_path):
    root = _tree(tmp_path, {_HOT: (
        "import torch\n"
        "def f(n):\n"
        "    # crlint: allow-mem-accounting(bounded by tile count)\n"
        "    return torch.zeros((n, 1024))\n")})
    assert not trun([root], rules=("mem-accounting",))


# --------------------------------------------------------- fault-coverage

_FAULTS_FIXTURE = {
    "PKG/utils/faults.py": (
        "SITES: dict[str, str] = {\n"
        "    'a.b': 'site one',\n"
        "    'c.d': 'site two',\n"
        "}\n"
        "def fire(site):\n"
        "    pass\n"),
    "PKG/kv/thing.py": (
        "from ..utils import faults\n"
        "def f(name):\n"
        "    faults.fire('a.b')\n"),
    "tests/test_foo.py": (
        "import pytest\n"
        "pytestmark = pytest.mark.chaos\n"
        "def test_x():\n"
        "    assert 'a.b'\n"),
}
_ONE_SITE = (
    "SITES: dict[str, str] = {\n"
    "    'a.b': 'site one',\n"
    "}\n"
    "def fire(site):\n"
    "    pass\n")


def _faults(tmp_path, **over):
    files = dict(_FAULTS_FIXTURE)
    files.update({k.replace("__", "/"): v for k, v in over.items()})
    return _parity(tmp_path, files, rules=("fault-coverage",),
                   roots=("PKG", "tests"))


def test_fault_coverage_flags_all_three_gaps(tmp_path):
    found = _faults(tmp_path, **{"PKG__kv__thing.py": (
        "from ..utils import faults\n"
        "def f(name):\n"
        "    faults.fire('a.b')\n"
        "    faults.fire(name)\n")})
    msgs = [f.message for f in found]
    assert len(found) == 3, [f.render() for f in found]
    assert any("not a string literal" in m for m in msgs)
    assert any("no fire call in product code" in m for m in msgs)
    assert any("not exercised by any chaos-marked test" in m for m in msgs)


def test_fault_coverage_closed_loop_is_quiet(tmp_path):
    assert not _faults(tmp_path, **{"PKG__utils__faults.py": _ONE_SITE})


def test_fault_coverage_scoped_site_names_count(tmp_path):
    assert not _faults(tmp_path, **{
        "PKG__utils__faults.py": _ONE_SITE,
        "tests__test_foo.py": (
            "import pytest\n"
            "pytestmark = pytest.mark.chaos\n"
            "def test_x():\n"
            "    assert 'a.b.n3'\n")})


def test_fault_coverage_registry_pragma_suppresses(tmp_path):
    assert not _faults(tmp_path, **{
        "PKG__utils__faults.py": (
            "SITES: dict[str, str] = {\n"
            "    'a.b': 'site one',\n"
            "    # crlint: allow-fault-coverage(planned site, test in flight)\n"
            "    'c.d': 'site two',\n"
            "}\n"
            "def fire(site):\n"
            "    pass\n"),
        "PKG__kv__thing.py": (
            "from ..utils import faults\n"
            "def f():\n"
            "    faults.fire('a.b')\n"
            "    faults.fire('c.d')\n")})


# --------------------------------------------------------- unknown-pragma

def test_unknown_rule_pragma_is_a_finding(tmp_path):
    found = _parity(tmp_path, {"PKG/kv/widget.py": (
        "def f():\n"
        "    # crlint: allow-mem-acounting(typo never suppresses)\n"
        "    return 1\n")})
    assert [f.rule for f in found] == ["unknown-pragma"]
    assert "mem-acounting" in found[0].message


def test_unknown_pragma_covers_new_rules(tmp_path):
    found = _parity(tmp_path, {"PKG/kv/widget.py": (
        "def f():\n"
        "    # crlint: allow-untimed-waits(typo)\n"
        "    # crlint: allow-recompile-hazzard(typo)\n"
        "    # crlint: allow-race-coverge(typo)\n"
        "    return 1\n")})
    assert sorted(f.rule for f in found) == ["unknown-pragma"] * 3


# ------------------------------------------------------------------- CLI

_DIRTY = "import torch\nf = torch.compile(lambda x: x)\n"


def test_cli_exit_codes_clean_findings_internal(tmp_path):
    pkg = tmp_path / "cockroach_tpu_torch"
    pkg.mkdir()
    clean = pkg / "ok.py"
    clean.write_text("X = 1\n")
    assert main([str(clean)]) == 0
    dirty = pkg / "dirty.py"
    dirty.write_text(_DIRTY)
    assert main([str(dirty)]) == 1
    broken = pkg / "broken.py"
    broken.write_text("def f(:\n")
    assert main([str(broken)]) == 2  # a linter failure, not a finding


def test_cli_changed_only_filters_report(tmp_path):
    root = _tree(tmp_path, {"PKG/kv/a.py": _DIRTY, "PKG/kv/b.py": _DIRTY})
    lst = tmp_path / "changed.txt"
    lst.write_text("cockroach_tpu_torch/kv/a.py\n")
    assert main([str(root), "--changed-only", str(lst)]) == 1
    lst.write_text("cockroach_tpu_torch/kv/other.py\n")
    assert main([str(root), "--changed-only", str(lst)]) == 0


def test_cli_json_is_stable_and_location_sorted(tmp_path):
    root = _tree(tmp_path, {"PKG/kv/b.py": _DIRTY, "PKG/kv/a.py": _DIRTY})
    bufs = []
    for _ in range(2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([str(root), "--json"]) == 1
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1]  # byte-stable across runs
    recs = json.loads(bufs[0])
    locs = [(r["path"], r["line"]) for r in recs]
    assert locs == sorted(locs)
    assert locs[0][0].endswith("a.py")


def test_cli_changed_only_git_mode(tmp_path, monkeypatch):
    root = _tree(tmp_path, {"PKG/kv/a.py": _DIRTY})
    monkeypatch.chdir(tmp_path)
    env = {**os.environ, "GIT_CONFIG_GLOBAL": "/dev/null",
           "GIT_CONFIG_SYSTEM": "/dev/null"}
    subprocess.run(["git", "init", "-q"], check=True, env=env, timeout=60)
    assert main([str(root), "--changed-only", "--git"]) == 1  # untracked
    subprocess.run(["git", "add", "-A"], check=True, env=env, timeout=60)
    subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t",
                    "commit", "-qm", "x"], check=True, env=env, timeout=60)
    # committed and unmodified: filtered out of the report
    assert main([str(root), "--changed-only", "--git"]) == 0


def test_cli_race_map_exits_zero(tmp_path):
    root = _tree(tmp_path, {"PKG/kv/widget.py": _RACY})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main([str(root), "--race-map"]) == 0
    assert "counter" in buf.getvalue()


# ----------------------------------------------------------- untimed-wait

_UNTIMED = (
    "import queue\n"
    "import threading\n"
    "class W:\n"
    "    def __init__(self):\n"
    "        self.ev = threading.Event()\n"
    "        self.q = queue.Queue()\n"
    "        self._t = threading.Thread(target=self._loop, daemon=True)\n"
    "        self._t.start()\n"
    "    def _loop(self):\n"
    "        self.ev.wait()\n"
    "        return self.q.get()\n"
)


def _untimed(tmp_path, src):
    return _parity(tmp_path, {"PKG/kv/widget.py": src},
                   rules=("untimed-wait",))


def test_untimed_wait_flags_thread_reachable_waits(tmp_path):
    found = _untimed(tmp_path, _UNTIMED)
    assert len(found) == 2, [f.render() for f in found]
    msgs = " ".join(f.message for f in found)
    assert ".wait()" in msgs and ".get()" in msgs


def test_untimed_wait_bounded_is_quiet(tmp_path):
    assert not _untimed(tmp_path, _UNTIMED.replace(
        "self.ev.wait()", "self.ev.wait(1.0)").replace(
        "self.q.get()", "self.q.get(timeout=1.0)"))


def test_untimed_wait_unreachable_helper_is_quiet(tmp_path):
    assert not _untimed(tmp_path, (
        "import threading\n"
        "def helper(ev):\n"
        "    ev.wait()\n"))


def test_untimed_wait_inline_pragma_suppresses(tmp_path):
    found = _untimed(tmp_path, _UNTIMED.replace(
        "        self.ev.wait()\n",
        "        # crlint: allow-untimed-wait(shutdown path, reaped by "
        "close)\n"
        "        self.ev.wait()\n"))
    assert len(found) == 1  # the queue.get() is still a finding
    assert ".get()" in found[0].message


def test_untimed_wait_def_line_waiver_covers_body(tmp_path):
    assert not _untimed(tmp_path, _UNTIMED.replace(
        "    def _loop(self):\n",
        "    # crlint: allow-untimed-wait(owner arms deadlines before "
        "start)\n"
        "    def _loop(self):\n"))


def test_untimed_wait_empty_reason_does_not_suppress(tmp_path):
    assert len(_untimed(tmp_path, _UNTIMED.replace(
        "        self.ev.wait()\n",
        "        self.ev.wait()  # crlint: allow-untimed-wait()\n"))) == 2


def test_untimed_wait_socket_recv_needs_deadline_evidence(tmp_path):
    """The shape the port's flow/dcn._recv_exact had: a recv on a
    thread-reachable path with no settimeout in sight; a settimeout in
    the function is the evidence that quiets it."""
    src = (
        "import threading\n"
        "def _recv(sock, n):\n"
        "    return sock.recv(n)\n"
        "class S:\n"
        "    def __init__(self, sock):\n"
        "        self.sock = sock\n"
        "        threading.Thread(target=self._loop, daemon=True).start()\n"
        "    def _loop(self):\n"
        "        _recv(self.sock, 4)\n")
    found = _untimed(tmp_path / "a", src)
    assert len(found) == 1 and ".recv()" in found[0].message
    assert not _untimed(tmp_path / "b", src.replace(
        "    return sock.recv(n)\n",
        "    sock.settimeout(30.0)\n    return sock.recv(n)\n"))


# ------------------------------------------------------- recompile-hazard

_SHAPE_HOT = "PKG/flow/operators.py"


def _recompile(tmp_path, files):
    return _parity(tmp_path, files, rules=("recompile-hazard",))


def test_recompile_hazard_flags_unbucketed_cap(tmp_path):
    found = _recompile(tmp_path, {_SHAPE_HOT: (
        "def plan(rows):\n"
        "    cap = len(rows)\n"
        "    return cap\n")})
    assert len(found) == 1, [f.render() for f in found]
    assert "canonical-bucketing" in found[0].message


def test_recompile_hazard_bucketed_cap_is_quiet(tmp_path):
    assert not _recompile(tmp_path, {_SHAPE_HOT: (
        "from .fuse import _canonical_cap\n"
        "def plan(rows):\n"
        "    cap = _canonical_cap(len(rows))\n"
        "    return cap\n")})


def test_recompile_hazard_flags_impure_kernel_key(tmp_path):
    found = _recompile(tmp_path, {"PKG/ops/thing.py": (
        "from ..flow import dispatch\n"
        "def f(schema, n):\n"
        "    return dispatch.kernel_key('agg', f'{schema}', repr(n))\n")})
    assert len(found) == 2, [f.render() for f in found]
    msgs = " ".join(f.message for f in found)
    assert "f-string" in msgs and "repr()" in msgs


def test_recompile_hazard_flags_keyless_closure_jit(tmp_path):
    found = _recompile(tmp_path, {"PKG/ops/thing.py": (
        "from ..flow import dispatch\n"
        "def f(x):\n"
        "    g = dispatch.jit(lambda v: v + 1)\n"
        "    return g(x)\n")})
    assert len(found) == 1
    assert "fresh wrapper" in found[0].message


def test_recompile_hazard_construction_and_keyed_are_quiet(tmp_path):
    assert not _recompile(tmp_path, {"PKG/ops/thing.py": (
        "from ..flow import dispatch\n"
        "class Op:\n"
        "    def init(self):\n"
        "        self.g = dispatch.jit(lambda v: v + 1)\n"
        "def f(x):\n"
        "    h = dispatch.jit(lambda v: v - 1, key=('dec', 'i64'))\n"
        "    return h(x)\n")})


def test_recompile_hazard_def_line_waiver_covers_body(tmp_path):
    assert not _recompile(tmp_path, {"PKG/ops/thing.py": (
        "from ..flow import dispatch\n"
        "# crlint: allow-recompile-hazard(cold path, captured once by "
        "contract)\n"
        "def f(x):\n"
        "    g = dispatch.jit(lambda v: v + 1)\n"
        "    return g(x)\n")})


# --------------------------------------------------------- race-coverage

def _race(tmp_path, src):
    return _parity(tmp_path, {"PKG/kv/widget.py": src},
                   rules=("race-coverage",))


def test_race_coverage_flags_uninstrumented_shared_field(tmp_path):
    found = _race(tmp_path, _RACY)
    assert len(found) == 1, [f.render() for f in found]
    assert found[0].rule == "race-coverage"
    assert "note_read/note_write" in found[0].message


@pytest.mark.parametrize("src", [
    _RACY.replace("import threading\n",
                  "import threading\nfrom ..utils import racesan\n")
         .replace("            self.counter += 1\n",
                  "            racesan.note_write(self, 'counter')\n"
                  "            self.counter += 1\n"),
    _GUARDED,
    _RACY.replace("        self.counter = 0\n",
                  "        # crlint: allow-race-coverage(single-writer by "
                  "protocol; instrumenting would false-positive under "
                  "racesan)\n"
                  "        self.counter = 0\n"),
], ids=["instrumented", "lock-guarded", "init-site-pragma"])
def test_race_coverage_covered_is_quiet(tmp_path, src):
    """racesan note_* calls naming the field, one lock at every site, or
    a reasoned pragma on the __init__ assignment (state-wide)."""
    assert not _race(tmp_path, src)


def test_race_coverage_map_statuses(tmp_path):
    from cockroach_tpu_torch.lint.racecoverage import (coverage_map,
                                                       render_map)

    src = _RACY.replace(
        "        self.counter = 0\n",
        "        # crlint: allow-race-coverage(documented lock-free "
        "single-writer)\n"
        "        self.counter = 0\n")
    _tree(tmp_path, {"PKG/kv/widget.py": src})
    files = load_files([tmp_path / "cockroach_tpu_torch"])
    rows = coverage_map(files, TreeCache(files))
    by_state = {r["state"].rsplit(".", 1)[-1]: r for r in rows}
    assert by_state["counter"]["status"] == "waived"
    assert by_state["counter"]["sites"]
    assert "counter: waived" in render_map(rows)


def test_run_lint_fills_per_pass_timings():
    timings = {}
    found = trun([REPO / "cockroach_tpu_torch" / "lint"], timings=timings)
    assert "load/parse" in timings
    for rule in ALL_RULES:
        assert rule in timings, rule
        assert timings[rule] >= 0.0
    assert not found


def test_lint_package_is_stdlib_only():
    """The package imports neither torch nor jax nor the reference."""
    import ast

    for p in sorted((REPO / "cockroach_tpu_torch" / "lint").glob("*.py")):
        for node in ast.walk(ast.parse(p.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "torch", "jax", "numpy", "cockroach_tpu",
                    "cockroach_tpu_torch"), f"{p.name}: {n}"


# ------------------------------------------------- faults the lint found

def test_tilestream_reset_waits_for_an_abandoned_fill(monkeypatch):
    """TileStream.reset ran while the fill thread still counted a
    prefetch the last run abandoned: the stale fill's host wait, bytes
    and copy timing landed in the new run. Reset now waits for the last
    fill and zeroes after it. The CUDA path runs here on CPU tensors,
    with the fill's copy-out event held open by a gate."""
    from cockroach_tpu_torch.coldata.types import INT64, Schema
    from cockroach_tpu_torch.flow import upload

    gate = threading.Event()

    class Ev:
        def __init__(self, enable_timing=False, held=False):
            self.held = held

        def query(self):
            return not self.held

        def synchronize(self):
            assert gate.wait(10)

        def record(self, stream=None):
            pass

        def elapsed_time(self, other):
            return 1.0

    monkeypatch.setattr(torch.cuda, "Event", Ev)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    st = upload.TileStream(Schema(("a",), (INT64,)),
                           {"a": np.arange(8, dtype=np.int64)}, {}, 8, 4,
                           torch.device("cpu"))
    st.cuda = True
    st._copy = None
    st._worker = ThreadPoolExecutor(1)
    st._slots = [{"a": (torch.zeros(4, dtype=torch.int64), None)}
                 for _ in range(2)]
    st._done = [Ev(held=True), None]  # slot 0's last copy still running
    try:
        fill = st.upload(0)  # the prefetch a consumer abandons
        t = threading.Thread(target=st.reset, daemon=True)
        t.start()
        time.sleep(0.05)
        gate.set()  # the copy finishes: the stale fill completes
        t.join(10)
        assert not t.is_alive()
        fill.result(10)
        assert (st.host_waits, st.h2d_bytes, st._timing) == (0, 0, [])
    finally:
        gate.set()
        st._worker.shutdown(wait=True)


def test_recv_exact_bounds_an_untimed_socket():
    """flow/dcn._recv_exact trusted every caller to have set a socket
    timeout; an accepted connection inherits none (HostFlowServer's
    handler, the batch RPC server). A peer that stops mid-frame now
    raises socket.timeout within flow.dcn.io_timeout_s."""
    from cockroach_tpu_torch.flow import dcn

    a, b = socket.socketpair()
    settings.set("flow.dcn.io_timeout_s", 0.2)
    out = []

    def read():
        try:
            dcn._recv_msg(b)
        except Exception as e:  # noqa: BLE001 - inspected below
            out.append(e)

    try:
        a.sendall(dcn._LEN.pack(100) + b"x" * 10)  # stops mid-frame
        assert b.gettimeout() is None
        t0 = time.monotonic()
        t = threading.Thread(target=read, daemon=True)
        t.start()
        t.join(5)
        assert not t.is_alive(), "a peer stopped mid-frame parked the reader"
        assert isinstance(out[0], socket.timeout)
        assert time.monotonic() - t0 < 2.0
    finally:
        settings.reset("flow.dcn.io_timeout_s")
        a.close()
        b.close()
