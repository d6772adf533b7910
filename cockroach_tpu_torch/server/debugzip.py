"""debug zip — the `cockroach debug zip` reduction; the port of
``cockroach_tpu.server.debugzip``.

Reference: pkg/cli/zip.go walks every status endpoint of a cluster and
packs the responses into one archive a support engineer can read offline.
Here the same shape over this node's surfaces: metrics, settings,
statement statistics, hot ranges, in-flight spans, and every statement
diagnostics bundle still in the ring (sql/diagnostics.py).

Two collection modes:

- ``collect(url=...)`` pulls the /_status endpoints of a RUNNING node over
  HTTP (the normal operator path: ``python -m cockroach_tpu_torch.cli
  debug zip --url ...``);
- ``collect()`` snapshots the current process's registries directly, so an
  in-process session (tests, the demo shell) can produce the same archive
  without a server.

Per-endpoint failures degrade to an error stub inside the archive instead
of aborting it — a half-broken node is exactly when you want the zip.
"""

from __future__ import annotations

import json
import zipfile

_ENDPOINTS = {
    "metrics.txt": "/_status/vars",
    "nodes.json": "/_status/nodes",
    "jobs.json": "/_status/jobs",
    "settings.json": "/_status/settings",
    "statements.json": "/_status/statements",
    "hot_ranges.json": "/hot_ranges",
    "contention.json": "/_status/contention",
    "spans.json": "/_status/spans",
    "diagnostics.json": "/_status/diagnostics",
    "load.json": "/_status/load",
}


def _url_files(base: str) -> dict[str, str]:
    from urllib.request import urlopen

    base = base.rstrip("/")
    files: dict[str, str] = {}
    for fname, path in _ENDPOINTS.items():
        try:
            with urlopen(base + path, timeout=5) as r:
                files[fname] = r.read().decode("utf-8")
        except (OSError, ValueError) as e:
            files[fname] = json.dumps({"error": str(e)})
    try:
        listing = json.loads(files.get("diagnostics.json", "{}"))
        for b in listing.get("bundles", []):
            bid = int(b["id"])
            with urlopen(base + f"/_status/diagnostics?id={bid}",
                         timeout=5) as r:
                files[f"diagnostics/bundle_{bid:06d}.json"] = (
                    r.read().decode("utf-8"))
    except (OSError, ValueError, KeyError):
        pass  # the ring listing is already in the archive; bundles degrade
    return files


def _process_files() -> dict[str, str]:
    from ..kv.contention import DEFAULT as _cont
    from ..sql import diagnostics as diag
    from ..sql import sqlstats
    from ..utils import metric, settings, tracing
    from .http import load_payload

    files = {
        "metrics.txt": metric.DEFAULT.scrape(),
        "settings.json": json.dumps({"settings": {
            name: s.get() for name, s in settings.all_settings().items()
        }}, indent=1, default=str),
        "statements.json": json.dumps(
            {"statements": sqlstats.DEFAULT.rows_payload()}, indent=1),
        "contention.json": json.dumps({"events": _cont.rows_payload()},
                                      indent=1, default=str),
        "spans.json": json.dumps({"spans": [
            {"traceId": s.trace_id, "spanId": s.span_id,
             "operation": s.name} for s in tracing.inflight()
        ]}, indent=1),
        "diagnostics.json": json.dumps({"bundles": diag.bundles()},
                                       indent=1),
        "load.json": json.dumps(load_payload(), indent=1, default=str),
    }
    for b in diag.bundles():
        full = diag.get(b["id"])
        if full is not None:
            files[f"diagnostics/bundle_{b['id']:06d}.json"] = json.dumps(
                full, indent=1, default=str)
    return files


def collect(url: str | None = None) -> dict[str, str]:
    """Archive contents as {member name: text}; url=None snapshots the
    current process instead of a remote node."""
    return _url_files(url) if url else _process_files()


def write_zip(path: str, files: dict[str, str]) -> str:
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        for name in sorted(files):
            z.writestr("debug/" + name, files[name])
    return path
