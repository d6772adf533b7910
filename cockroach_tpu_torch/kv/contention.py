"""Contention event registry — the pkg/sql/contention reduction; the port
of ``cockroach_tpu.kv.contention``.

Reference: every time a request waits on (or aborts against) another
transaction's lock, a contention event (key, waiting txn, holding txn,
duration) lands in a per-node registry surfaced through
crdb_internal.cluster_contention_events and the console's insights page.

Reduction: the txn layer reports each WriteIntentError conflict here;
the registry aggregates per KEY (count, last holding txn, waiting txns
seen), bounded by evicting the least-hit half when full."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class ContentionEvent:
    key: bytes
    count: int = 0
    last_holder: int = 0
    last_wall: float = 0.0
    waiters: set = field(default_factory=set)


class ContentionRegistry:
    def __init__(self, max_keys: int = 2000):
        self._lock = threading.Lock()
        self._by_key: dict[bytes, ContentionEvent] = {}
        self.max_keys = max_keys
        self.evicted = 0

    def record(self, keys, holders, waiting_txn: int = 0) -> None:
        with self._lock:
            for k, h in zip(keys, holders):
                ev = self._by_key.get(k)
                if ev is None:
                    if len(self._by_key) >= self.max_keys:
                        keep = sorted(self._by_key.values(),
                                      key=lambda e: -e.count)
                        keep = keep[: self.max_keys // 2]
                        self.evicted += len(self._by_key) - len(keep)
                        self._by_key = {e.key: e for e in keep}
                    ev = self._by_key[k] = ContentionEvent(k)
                ev.count += 1
                ev.last_holder = int(h)
                ev.last_wall = time.time()
                if waiting_txn:
                    ev.waiters.add(int(waiting_txn))

    def rows_payload(self) -> list[dict]:
        with self._lock:
            evs = sorted(self._by_key.values(), key=lambda e: -e.count)
            return [
                {"key": e.key.decode("utf-8", "replace"),
                 "count": e.count, "lastHolderTxn": e.last_holder,
                 "numWaiters": len(e.waiters)}
                for e in evs
            ]

    def clear(self) -> None:
        with self._lock:
            self._by_key.clear()


DEFAULT = ContentionRegistry()
