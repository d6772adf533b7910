"""Byte accounting for storage residency and staging buffers — the
``charge_object`` / ``staged`` half of ``cockroach_tpu.flow.memory``,
reduced to named byte counters (the storage slice has no query-level
monitor tree to charge)."""

from __future__ import annotations

import contextlib
import threading
import weakref


class Account:
    """A named byte counter."""

    def __init__(self, name: str):
        self.name = name
        self.used = 0
        self._lock = threading.Lock()

    def reserve(self, n: int) -> None:
        with self._lock:
            self.used += n

    def release(self, n: int) -> None:
        with self._lock:
            self.used -= n


_lock = threading.Lock()
_accounts: dict[str, Account] = {}


def account(name: str) -> Account:
    with _lock:
        a = _accounts.get(name)
        if a is None:
            a = _accounts[name] = Account(name)
        return a


@contextlib.contextmanager
def staged(name: str, nbytes: int):
    """Charge a transient staging buffer for the block's lifetime."""
    acct = account(name)
    n = int(nbytes)
    acct.reserve(n)
    try:
        yield acct
    finally:
        acct.release(n)


def charge_object(name: str, obj, nbytes: int) -> None:
    """Charge residency for ``obj``'s lifetime, released when the object
    is garbage-collected."""
    n = int(nbytes)
    if n <= 0:
        return
    acct = account(name)
    acct.reserve(n)
    weakref.finalize(obj, acct.release, n)
