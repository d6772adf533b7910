"""Structured logging on the reference's channels, as JSON lines on
stderr at or above a minimum severity (WARNING unless changed)."""

from __future__ import annotations

import json
import sys
import time

STORAGE = "STORAGE"
SQL_EXEC = "SQL_EXEC"

_SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR")
min_severity = "WARNING"


def _log(sev: str, channel: str, msg: str, kw: dict) -> None:
    if _SEVERITIES.index(sev) < _SEVERITIES.index(min_severity):
        return
    rec = {"t": time.time(), "sev": sev, "ch": channel, "msg": msg, **kw}
    print(json.dumps(rec, default=str), file=sys.stderr, flush=True)


def debug(channel: str, msg: str, **kw) -> None:
    _log("DEBUG", channel, msg, kw)


def info(channel: str, msg: str, **kw) -> None:
    _log("INFO", channel, msg, kw)


def warning(channel: str, msg: str, **kw) -> None:
    _log("WARNING", channel, msg, kw)
