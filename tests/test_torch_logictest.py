"""The datadriven SQL logic tests (tests/logictest/testdata, the
pkg/sql/logictest reduction) through the port's Session on the CPU: every
file runs its statements through ``Session(device="cpu")`` and every
query single-device and, where the plan distributes, over the port's
8-shard CPU mesh — the local/fakedist pairing of
tests/logictest/runner.py. The file format, rendering and comparison are
the runner's own (``parse_file``, ``_cells``, ``_compare``); only the
executor is the port's, since the runner's imports the reference."""

import importlib.util
import os
import sys

import pytest
import torch

from cockroach_tpu_torch.parallel import mesh as mesh_mod
from cockroach_tpu_torch.sql import BindError, Session
from cockroach_tpu_torch.sql import sql as sql_bind
from cockroach_tpu_torch.utils.errors import QueryError


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These small tables gain nothing from intra-op threads, and several
    test workers' thread pools on shared cores slow each other down."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


_spec = importlib.util.spec_from_file_location(
    "logictest_runner",
    os.path.join(os.path.dirname(__file__), "logictest", "runner.py"),
)
runner = sys.modules.get("logictest_runner")
if runner is None:
    runner = importlib.util.module_from_spec(_spec)
    sys.modules["logictest_runner"] = runner
    _spec.loader.exec_module(runner)


@pytest.fixture(scope="module")
def mesh():
    return mesh_mod.make_mesh(8, device="cpu")


def run_logic_file(path: str, session, mesh=None) -> int:
    """runner.run_logic_file with the port's session, binder and errors."""
    n = 0
    for case in runner.parse_file(path):
        n += 1
        if case.error is not None:
            try:
                session.execute(case.sql)
            except (BindError, QueryError, ValueError, SyntaxError) as e:
                assert case.error.lower() in str(e).lower(), (
                    f"line {case.line}: error {e!r} missing "
                    f"{case.error!r}")
            else:
                raise AssertionError(
                    f"line {case.line}: expected error {case.error!r}")
            continue
        res = session.execute(case.sql)
        if case.kind == "statement":
            continue
        got = runner._cells(res, case.types, case.sort)
        runner._compare(got, case.expected, case.types, case.line, "local")
        in_txn = getattr(session, "_txn", None) is not None
        if mesh is not None and not in_txn:
            try:
                rel = sql_bind(session.catalog, case.sql)
                dres = rel.run_distributed(mesh)
            except (BindError, TypeError, QueryError):
                continue  # KV-backed scans do not distribute
            dgot = runner._cells(dres, case.types, case.sort)
            runner._compare(dgot, case.expected, case.types, case.line,
                            "fakedist")
    return n


def _logic_id(p: str) -> str:
    return p.rsplit("/", 1)[-1].removesuffix(".test")


@pytest.mark.parametrize("path", runner.logic_files(), ids=_logic_id)
def test_logic_file(path, mesh):
    s = Session(device="cpu")
    try:
        n = run_logic_file(path, s, mesh=mesh)
    finally:
        s.close()
    assert n > 0, "file had no directives"
