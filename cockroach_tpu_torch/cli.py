"""Interactive SQL shell and node entry point — the `cockroach sql` /
`cockroach demo` / `cockroach start` analog; the port of
``cockroach_tpu.cli``.

Reference: pkg/cli wires cobra commands over a server connection
(`cockroach sql`, `cockroach demo` boots an in-memory cluster). Here the
shell runs an in-process Session over the KV engine — the demo shape:

    python -m cockroach_tpu_torch.cli                  # REPL
    python -m cockroach_tpu_torch.cli -e "select 1"    # one-shot
    python -m cockroach_tpu_torch.cli -f script.sql    # file
    python -m cockroach_tpu_torch.cli --demo-tpch 0.01 # preload TPC-H
    python -m cockroach_tpu_torch.cli --start --pg-port 0 --http-port 0
    python -m cockroach_tpu_torch.cli hot-ranges --url http://127.0.0.1:8080
    python -m cockroach_tpu_torch.cli debug zip out.zip --url ...

Everything runs on the card; ``--cpu`` runs on the CPU instead
(``device="cpu"``). Meta commands: \\d (tables), \\timing, \\q.
Statements end with ';'.
"""

from __future__ import annotations

import argparse
import sys
import time


def _fmt_value(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def render_table(res: dict) -> str:
    """psql-style table of a result dict."""
    if not isinstance(res, dict):
        return str(res)
    if not res:
        return "(no columns)"
    first = next(iter(res.values()))
    if not hasattr(first, "__len__"):
        return str(res)
    names = list(res.keys())
    nrows = len(first)
    cells = [[_fmt_value(res[n][r]) for n in names] for r in range(nrows)]
    widths = [
        max(len(n), *(len(row[i]) for row in cells)) if cells else len(n)
        for i, n in enumerate(names)
    ]
    sep = "-+-".join("-" * w for w in widths)
    out = [" | ".join(n.ljust(w) for n, w in zip(names, widths)), sep]
    for row in cells:
        out.append(" | ".join(c.ljust(w) for c, w in zip(row, widths)))
    out.append(f"({nrows} row{'s' if nrows != 1 else ''})")
    return "\n".join(out)


def execute_and_render(sess, stmt: str, timing: bool = False) -> str:
    from .sql import BindError
    from .utils.errors import QueryError

    t0 = time.time()
    try:
        if stmt.strip().lower().startswith("explain"):
            from .sql import explain

            out = explain(sess.catalog, stmt)
        else:
            res = sess.execute(stmt)
            if isinstance(res, dict) and ("rows_affected" in res
                                          or "created" in res):
                if "created" in res:
                    out = f"CREATE TABLE {res['created']}"
                else:
                    out = f"OK, {res['rows_affected']} row(s) affected"
            else:
                out = render_table(res)
    except (BindError, QueryError, SyntaxError, ValueError) as e:
        return f"ERROR: {e}"
    if timing:
        out += f"\n\nTime: {(time.time() - t0) * 1e3:.1f} ms"
    return out


def _load_demo_tpch(sess, sf: float) -> None:
    from .bench import tpch

    cat = tpch.gen_tpch(sf=sf, device=sess.catalog.device)
    for name, table in cat.tables.items():
        sess.catalog.tables[name] = table
    print(f"-- TPC-H sf={sf:g} loaded: "
          f"{', '.join(sorted(cat.tables))}", file=sys.stderr)


def repl(sess) -> None:
    timing = False
    buf: list[str] = []
    prompt = "tpu-sql> "
    while True:
        try:
            line = input(prompt if not buf else "    ...> ")
        except (EOFError, KeyboardInterrupt):
            print()
            return
        stripped = line.strip()
        if not buf and stripped.startswith("\\"):
            if stripped in ("\\q", "\\quit"):
                return
            if stripped == "\\timing":
                timing = not timing
                print(f"Timing is {'on' if timing else 'off'}.")
            elif stripped == "\\d":
                for name in sorted(sess.catalog.tables):
                    t = sess.catalog.tables[name]
                    cols = ", ".join(
                        f"{n} {ty}" for n, ty in
                        zip(t.schema.names, t.schema.types)
                    )
                    print(f"  {name}({cols})")
            else:
                print(f"unknown meta command {stripped!r}")
            continue
        buf.append(line)
        joined = "\n".join(buf)
        if joined.rstrip().endswith(";"):
            buf = []
            stmt = joined.rstrip().rstrip(";")
            if stmt.strip():
                print(execute_and_render(sess, stmt, timing))


def hot_ranges_cmd(argv) -> int:
    """`cockroach_tpu_torch.cli hot-ranges [--url]` — the `cockroach node
    status --ranges`-flavored verb: fetch /hot_ranges from a running
    node's admin API and render it psql-style, hottest range first."""
    import json as _json
    from urllib.request import urlopen

    ap = argparse.ArgumentParser(prog="cockroach_tpu_torch.cli hot-ranges")
    ap.add_argument("--url", default="http://127.0.0.1:8080",
                    help="admin API base URL of a running node")
    args = ap.parse_args(argv)
    with urlopen(args.url.rstrip("/") + "/hot_ranges", timeout=5) as r:
        payload = _json.load(r)
    rows = payload.get("hotRanges", [])
    cols = ["rangeId", "startKey", "endKey", "storeId", "qps",
            "writeBytesRate", "sizeBytes", "leaseholder"]
    print(render_table({c: [row.get(c) for row in rows] for c in cols}))
    return 0


def debug_zip_cmd(argv) -> int:
    """`cockroach_tpu_torch.cli debug zip [out.zip] [--url]` — the `cockroach
    debug zip` verb: pack metrics, settings, statement stats, hot ranges,
    in-flight spans, and statement diagnostics bundles into one archive.
    With --url the endpoints of a running node are pulled over HTTP;
    without it the current process's registries are snapshotted."""
    ap = argparse.ArgumentParser(prog="cockroach_tpu_torch.cli debug zip")
    ap.add_argument("output", nargs="?", default="debug.zip",
                    help="archive path (default debug.zip)")
    ap.add_argument("--url", default=None,
                    help="admin API base URL of a running node; omitted "
                         "collects from the current process")
    args = ap.parse_args(argv)
    from .server import debugzip

    files = debugzip.collect(url=args.url)
    path = debugzip.write_zip(args.output, files)
    print(f"wrote {path} ({len(files)} files)")
    return 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "hot-ranges":
        return hot_ranges_cmd(argv[1:])
    if argv[:2] == ["debug", "zip"]:
        return debug_zip_cmd(argv[2:])
    ap = argparse.ArgumentParser(prog="cockroach_tpu_torch.cli",
                                 description=__doc__)
    ap.add_argument("-e", "--execute", action="append", default=[],
                    help="run a statement and exit (repeatable)")
    ap.add_argument("-f", "--file", help="run statements from a file")
    ap.add_argument("--demo-tpch", type=float, metavar="SF",
                    help="preload TPC-H tables at this scale factor")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--start", action="store_true",
                    help="server mode (the `cockroach start` analog): run a "
                         "Node serving pgwire + the HTTP admin API until "
                         "interrupted")
    ap.add_argument("--pg-port", type=int, default=26257,
                    help="pgwire listen port for --start (0 = ephemeral)")
    ap.add_argument("--http-port", type=int, default=8080,
                    help="HTTP admin port for --start (0 = ephemeral)")
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"

    if args.start:
        import time as _time

        from .server.node import Node

        node = Node(device=device).start(pg_port=args.pg_port,
                                         http_port=args.http_port)
        print(f"node {node.node_id} serving: "
              f"pgwire 127.0.0.1:{node.pg.addr[1]} "
              f"http 127.0.0.1:{node.admin.port}", flush=True)
        try:
            while True:
                _time.sleep(1)
        except KeyboardInterrupt:
            node.stop()
            print(f"node {node.node_id} stopped", flush=True)
        return 0

    from .sql import Session

    sess = Session(device=device)
    if args.demo_tpch:
        _load_demo_tpch(sess, args.demo_tpch)

    stmts: list[str] = list(args.execute)
    if args.file:
        with open(args.file) as f:
            stmts.extend(s for s in f.read().split(";") if s.strip())
    if stmts:
        for s in stmts:
            print(execute_and_render(sess, s))
        return 0
    repl(sess)
    return 0


if __name__ == "__main__":
    sys.exit(main())
