"""The port's CLI and debug zip (cockroach_tpu_torch/cli.py, server/
debugzip.py) against the reference's on the CPU: ``render_table`` and
``execute_and_render`` give the reference's text over TPC-H sf=0.01
(seed 19920101: q1 and q6's texts, a join, EXPLAIN, DDL, DML, NULLs and
an error), ``main([... "-e", ...])`` prints the reference's stdout, an
in-process debug zip holds the reference's file names, and
``--start --cpu`` in a child process prints the reference's readiness
line, serves pgwire and HTTP, and exits 0 on SIGINT with no node thread
left. Torch runs on one thread."""

import json
import re
import select
import signal
import socket
import struct
import subprocess
import sys
import urllib.request
import zipfile

import pytest
import torch

from cockroach_tpu import cli as jcli
from cockroach_tpu.server import debugzip as jzip
from cockroach_tpu.sql import Session as jSession
from cockroach_tpu_torch import cli as tcli
from cockroach_tpu_torch.bench.tpch_sql import TPCH_SQL
from cockroach_tpu_torch.server import debugzip as tzip
from cockroach_tpu_torch.sql import Session as tSession

SF = 0.01

STATEMENTS = [
    TPCH_SQL["q1"],
    TPCH_SQL["q6"],
    "select n_name, r_name from nation join region on n_regionkey = "
    "r_regionkey where r_name = 'ASIA' order by n_name",
    "explain select n_name from nation where n_regionkey = 2",
    "create table kv (k int primary key, v int)",
    "insert into kv values (1, 10), (2, null), (3, 30)",
    "select k, v from kv order by k",
    "select count(*) as n, sum(v) as s from kv",
    "select no_such_col from nation",
    "selec 1",
]


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def sessions():
    js, ts = jSession(), tSession(device="cpu")
    jcli._load_demo_tpch(js, SF)
    tcli._load_demo_tpch(ts, SF)
    yield js, ts
    js.close()
    ts.close()


def test_execute_and_render_equals_reference(sessions):
    """Each statement's rendered text (tables, row counts, EXPLAIN, DDL
    and DML acknowledgements, the error) equals the reference's."""
    js, ts = sessions
    for stmt in STATEMENTS:
        want = jcli.execute_and_render(js, stmt)
        got = tcli.execute_and_render(ts, stmt)
        assert got == want, stmt
    assert "(4 rows)" in tcli.execute_and_render(ts, TPCH_SQL["q1"])
    res = {"a": [1, None, 2.5], "b": ["x", "y", None]}
    assert tcli.render_table(res) == jcli.render_table(res)
    assert tcli.render_table({}) == jcli.render_table({})
    timed = tcli.execute_and_render(ts, "select 1 + 1 as two from region",
                                    timing=True)
    assert re.search(r"\n\nTime: [0-9.]+ ms$", timed)


def test_main_stdout_equals_reference(capsys):
    """``main(["--cpu", "--demo-tpch", ..., "-e", ...])`` prints what the
    reference's prints."""
    argv = ["--cpu", "--demo-tpch", str(SF), "-e", TPCH_SQL["q1"], "-e",
            "select count(*) as n from orders"]
    out = {}
    for name, mod in (("jax", jcli), ("torch", tcli)):
        assert mod.main(list(argv)) == 0
        out[name] = capsys.readouterr().out
    assert out["torch"] == out["jax"]
    assert "count_order" in out["torch"]


def test_debug_zip_holds_the_reference_files(tmp_path, sessions):
    """An in-process debug zip (``collect()``) holds the reference's
    members, and the archive's names equal the reference's."""
    js, ts = sessions
    tcli.execute_and_render(ts, "select count(*) from nation")
    jcli.execute_and_render(js, "select count(*) from nation")
    tfiles, jfiles = tzip.collect(), jzip.collect()
    assert sorted(k for k in tfiles if "/" not in k) == \
        sorted(k for k in jfiles if "/" not in k)
    paths = {}
    for name, mod, files in (("jax", jzip, jfiles), ("torch", tzip, tfiles)):
        p = mod.write_zip(str(tmp_path / f"{name}.zip"), files)
        with zipfile.ZipFile(p) as z:
            paths[name] = sorted(n for n in z.namelist()
                                 if "/diagnostics/" not in n)
    assert paths["torch"] == paths["jax"]
    assert json.loads(tfiles["statements.json"])["statements"]
    assert tfiles["metrics.txt"].startswith("# TYPE")


def _pg_query(sock, sql: str | None) -> tuple[list, str | None]:
    """One simple query (None: only read up to ReadyForQuery, as after
    the startup message): (rows as text lists, error text or None)."""
    if sql is not None:
        body = sql.encode() + b"\x00"
        sock.sendall(b"Q" + struct.pack("!I", len(body) + 4) + body)
    rows, err = [], None
    buf = b""
    while True:
        while len(buf) < 5 or len(buf) < 1 + struct.unpack(
                "!I", buf[1:5])[0]:
            c = sock.recv(65536)
            assert c, "server closed"
            buf += c
        tag = buf[:1]
        n = struct.unpack("!I", buf[1:5])[0]
        msg, buf = buf[5:1 + n], buf[1 + n:]
        if tag == b"E":
            err = msg.decode(errors="replace")
        elif tag == b"D":
            off, row = 2, []
            for _ in range(struct.unpack("!H", msg[:2])[0]):
                ln = struct.unpack("!i", msg[off:off + 4])[0]
                off += 4
                row.append(None if ln < 0 else msg[off:off + ln].decode())
                off += max(ln, 0)
            rows.append(row)
        elif tag == b"Z":
            return rows, err


def test_start_serves_pgwire_and_http_then_exits_on_sigint():
    """``--start --cpu --pg-port 0 --http-port 0`` in a child process
    prints the reference's readiness line, serves CREATE/INSERT/SELECT
    over pgwire (every insert reads back) and the admin API, and exits 0
    on SIGINT."""
    p = subprocess.Popen(
        [sys.executable, "-m", "cockroach_tpu_torch.cli", "--start",
         "--cpu", "--pg-port", "0", "--http-port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # bounded: a child that never gets ready fails the test, not the run
        ready, _, _ = select.select([p.stdout], [], [], 300)
        assert ready, "no readiness line in 300 s"
        line = p.stdout.readline()
        m = re.fullmatch(r"node 1 serving: pgwire 127\.0\.0\.1:(\d+) "
                         r"http 127\.0\.0\.1:(\d+)\n", line)
        assert m, line
        pg, http = int(m.group(1)), int(m.group(2))
        sock = socket.create_connection(("127.0.0.1", pg), timeout=60)
        body = struct.pack("!I", 196608) + b"user\x00t\x00\x00"
        sock.sendall(struct.pack("!I", len(body) + 4) + body)
        _pg_query(sock, None)
        for stmt in ("create table t (a int primary key, b int)",
                     "insert into t values (1, 2), (3, 4), (5, 6)"):
            assert _pg_query(sock, stmt)[1] is None, stmt
        rows, err = _pg_query(sock, "select a, b from t order by a")
        assert err is None and rows == [["1", "2"], ["3", "4"], ["5", "6"]]
        sock.sendall(b"X" + struct.pack("!I", 4))
        sock.close()
        with urllib.request.urlopen(f"http://127.0.0.1:{http}/health",
                                    timeout=10) as r:
            assert json.loads(r.read()) == {"nodeId": 1, "isLive": True}
        with urllib.request.urlopen(f"http://127.0.0.1:{http}/hot_ranges",
                                    timeout=10) as r:
            assert json.loads(r.read()) == {"hotRanges": []}
        out = subprocess.run(
            [sys.executable, "-m", "cockroach_tpu_torch.cli", "hot-ranges",
             "--url", f"http://127.0.0.1:{http}"],
            capture_output=True, text=True, timeout=120)
        assert out.returncode == 0 and "(0 rows)" in out.stdout
        p.send_signal(signal.SIGINT)
        assert p.wait(timeout=60) == 0
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()


def test_start_defaults_to_the_card(monkeypatch):
    """``--start`` asks the node for the card; ``--cpu`` for the CPU."""
    from cockroach_tpu_torch.server import node as node_mod

    asked = []

    class _Stop(Exception):
        pass

    def fake_node(**kw):
        asked.append(kw.get("device"))
        raise _Stop

    monkeypatch.setattr(node_mod, "Node", fake_node)
    for argv in (["--start"], ["--start", "--cpu"]):
        with pytest.raises(_Stop):
            tcli.main(argv + ["--pg-port", "0", "--http-port", "0"])
    assert asked == ["cuda", "cpu"]


def test_debug_zip_command_in_process(tmp_path, capsys):
    """``debug zip <out>`` without --url writes the archive of the
    current process."""
    out = str(tmp_path / "d.zip")
    assert tcli.main(["debug", "zip", out]) == 0
    assert "wrote " + out in capsys.readouterr().out
    with zipfile.ZipFile(out) as z:
        names = z.namelist()
    assert "debug/metrics.txt" in names and "debug/load.json" in names
