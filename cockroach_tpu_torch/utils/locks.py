"""Named reentrant lock (``cockroach_tpu.utils.locks.rlock`` without the
runtime lock-order detector, which the storage slice does not exercise)."""

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
