"""Named locks (``cockroach_tpu.utils.locks.rlock`` and ``lock`` without
the runtime lock-order detector, which the port does not exercise)."""

from __future__ import annotations

import threading


class NamedRLock:
    def __init__(self, name: str):
        self.name = name
        self._lock = threading.RLock()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc) -> None:
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
        return self

    def __exit__(self, *exc) -> None:
        self._lock.release()


def lock(name: str) -> NamedLock:
    return NamedLock(name)
