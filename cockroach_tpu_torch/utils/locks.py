"""Named locks (``cockroach_tpu.utils.locks.rlock`` and ``lock`` without
the runtime lock-order detector, which the port does not exercise).

While ``debug.race_detector.enabled`` is on, each thread keeps the
stack of the named locks it holds (``_held_stack``): the lockset the
data-race sanitizer (utils/racesan.py) reads at every tracked access.
Off, an acquisition pays one settings lookup."""

from __future__ import annotations

import threading

from . import settings

_held = threading.local()


def _tracking() -> bool:
    return settings.get("debug.race_detector.enabled")


def _stack() -> list:
    st = getattr(_held, "stack", None)
    if st is None:
        st = _held.stack = []
    return st


def _held_stack() -> list[str]:
    """Names of the locks this thread holds, outermost first (a
    re-entered lock appears once per acquisition)."""
    return list(_stack())


def _release_name(name: str) -> None:
    st = getattr(_held, "stack", None)
    if not st:
        return  # taken while the sanitizer was off
    # locks need not be released in the order they were taken
    for i in range(len(st) - 1, -1, -1):
        if st[i] == name:
            del st[i]
            return


class NamedRLock:
    def __init__(self, name: str):
        self.name = name
        self._lock = threading.RLock()

    def __enter__(self):
        self._lock.acquire()
        if _tracking():
            _stack().append(self.name)
        return self

    def __exit__(self, *exc) -> None:
        _release_name(self.name)
        self._lock.release()


def rlock(name: str) -> NamedRLock:
    return NamedRLock(name)


class NamedLock:
    """Named plain (non-reentrant) lock."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()

    def __enter__(self):
        self._lock.acquire()
        if _tracking():
            _stack().append(self.name)
        return self

    def __exit__(self, *exc) -> None:
        _release_name(self.name)
        self._lock.release()


def lock(name: str) -> NamedLock:
    return NamedLock(name)
