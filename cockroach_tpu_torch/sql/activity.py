"""Live session/query registries — the sessionRegistry role
(pkg/sql/conn_executor.go:2193 registerSession / ps.queries): every
Session registers itself at construction, every statement registers while
it runs with a phase that advances parse -> bind -> execute, and
crdb_internal.cluster_sessions / cluster_queries read the snapshots so
plain SQL can see what the process is doing right now.

Process-global on purpose: one pgwire server hosts many Sessions across
threads, and the registries are the cross-session view. Bounded — a leaked
session (a client that never closes) eventually falls off the oldest end
instead of growing the dict forever.

A copy of ``cockroach_tpu.sql.activity``.
"""

from __future__ import annotations

import itertools
import threading
import time

_lock = threading.Lock()
_ids = itertools.count(1)
_sessions: dict[int, dict] = {}
_queries: dict[int, dict] = {}

MAX_SESSIONS = 512
MAX_QUERY_TEXT = 512


def register_session(application_name: str = "") -> int:
    sid = next(_ids)
    with _lock:
        while len(_sessions) >= MAX_SESSIONS:
            _sessions.pop(next(iter(_sessions)))
        _sessions[sid] = {"id": sid,
                          "application_name": str(application_name),
                          "start": time.time(), "active": 0}
    return sid


def set_application_name(sid: int, name: str) -> None:
    with _lock:
        s = _sessions.get(sid)
        if s is not None:
            s["application_name"] = str(name)


def deregister_session(sid: int) -> None:
    with _lock:
        _sessions.pop(sid, None)
        orphans = [q for q, info in _queries.items()
                   if info["session_id"] == sid]
        for q in orphans:
            _queries.pop(q, None)


def begin_query(sid: int, text: str) -> int:
    qid = next(_ids)
    with _lock:
        s = _sessions.get(sid)
        if s is not None:
            s["active"] += 1
        _queries[qid] = {"id": qid, "session_id": sid,
                         "query": str(text)[:MAX_QUERY_TEXT],
                         "phase": "parsing", "start": time.time()}
    return qid


def set_phase(qid: int, phase: str) -> None:
    with _lock:
        q = _queries.get(qid)
        if q is not None:
            q["phase"] = phase


def end_query(qid: int) -> None:
    with _lock:
        q = _queries.pop(qid, None)
        if q is not None:
            s = _sessions.get(q["session_id"])
            if s is not None:
                s["active"] = max(0, s["active"] - 1)


def sessions() -> list[dict]:
    """Snapshot, oldest first, with session_age_s computed at read time."""
    now = time.time()
    with _lock:
        return [{**s, "session_age_s": now - s["start"]}
                for s in _sessions.values()]


def queries() -> list[dict]:
    """Snapshot of in-flight statements with elapsed_s at read time."""
    now = time.time()
    with _lock:
        return [{**q, "elapsed_s": now - q["start"]}
                for q in _queries.values()]


def reset() -> None:
    """Tests only: drop all registrations."""
    with _lock:
        _sessions.clear()
        _queries.clear()
