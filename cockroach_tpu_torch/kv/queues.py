"""Background replica queues — the kvserver baseQueue/purgatory analog.

The port of ``cockroach_tpu.kv.queues``.

Reference: pkg/kv/kvserver/queue.go runs each maintenance concern
(splitQueue, mergeQueue, replicateQueue, ...) as a baseQueue: a priority
heap of replicas fed by scanners, a paced processing loop, and a
*purgatory* for replicas whose processing failed with an error the queue
recognizes as temporary (purgatoryError) — those retry on a slow timer
instead of hot-looping or being dropped.

`ReplicaQueue` here is the generic engine: callers hand it a `process`
callable and which exception types are purgatory-worthy. Everything is
also drivable synchronously (`drain`) so tests exercise queue semantics
without threads; `start`/`stop` add the paced background loop, joined by
`Node.close()`.
"""

from __future__ import annotations

import heapq
import threading
import time

from ..utils import locks, log, metric


class ReplicaQueue:
    """Priority queue of work items with typed-error purgatory.

    - `maybe_add(item, priority)` dedups by item (highest priority wins).
    - `process_one()` pops the top item and runs `process(item)`. A
      purgatory-typed failure parks the item for retry with exponential
      backoff; any other exception counts a failure and drops the item
      (the queue must never die to one bad range).
    - `drain()` processes everything currently queued; with
      `force_purgatory=True` it also retries parked items regardless of
      their backoff deadline (deterministic tests).
    """

    def __init__(self, name: str, process, interval_s: float = 1.0,
                 purgatory_errors: tuple = (),
                 purgatory_interval_s: float = 5.0,
                 max_backoff_s: float = 60.0,
                 registry: metric.Registry = metric.DEFAULT,
                 clock=time.monotonic):
        self.name = name
        self.process = process
        self.interval_s = float(interval_s)
        self.purgatory_errors = tuple(purgatory_errors)
        self.purgatory_interval_s = float(purgatory_interval_s)
        self.max_backoff_s = float(max_backoff_s)
        self._clock = clock
        self._mu = locks.lock(f"kv.queue.{name}")
        self._heap: list[tuple[float, int, object]] = []  # (-prio, seq, item)
        self._queued: dict[object, float] = {}            # item -> priority
        self._purgatory: dict[object, tuple[int, float]] = {}  # (tries, due)
        self._seq = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.processed = registry.counter(
            f"queue_{name}_processed", f"{name} queue items processed")
        self.failures = registry.counter(
            f"queue_{name}_failures", f"{name} queue items failed and dropped")
        self.purgatory_size = registry.gauge(
            f"queue_{name}_purgatory", f"{name} queue items parked for retry")
        self.pending = registry.gauge(
            f"queue_{name}_pending", f"{name} queue items awaiting processing")

    # -- enqueue ------------------------------------------------------------

    def maybe_add(self, item, priority: float = 0.0) -> bool:
        """Queue item unless already queued at >= priority or in purgatory
        (purgatory owns retries; re-adding would double-process)."""
        with self._mu:
            if item in self._purgatory:
                return False
            prev = self._queued.get(item)
            if prev is not None and prev >= priority:
                return False
            self._queued[item] = priority
            self._seq += 1
            heapq.heappush(self._heap, (-priority, self._seq, item))
            self.pending.set(len(self._queued))
            return True

    def __len__(self) -> int:
        with self._mu:
            return len(self._queued)

    def purgatory_len(self) -> int:
        with self._mu:
            return len(self._purgatory)

    # -- processing ---------------------------------------------------------

    def _pop(self):
        with self._mu:
            while self._heap:
                neg_prio, _, item = heapq.heappop(self._heap)
                # stale heap entry: item was re-added at a higher priority
                if self._queued.get(item) == -neg_prio:
                    del self._queued[item]
                    self.pending.set(len(self._queued))
                    return item
            return None

    def _run(self, item) -> None:
        try:
            self.process(item)
        except self.purgatory_errors as e:
            with self._mu:
                tries = self._purgatory.get(item, (0, 0.0))[0] + 1
                backoff = min(self.purgatory_interval_s * (2 ** (tries - 1)),
                              self.max_backoff_s)
                self._purgatory[item] = (tries, self._clock() + backoff)
                self.purgatory_size.set(len(self._purgatory))
            log.warning(log.OPS, "queue item sent to purgatory",
                        queue=self.name, item=str(item), tries=tries,
                        error=str(e))
        except Exception as e:  # noqa: BLE001 - dropped with a metric and a log
            self.failures.inc()
            log.warning(log.OPS, "queue item dropped", queue=self.name,
                        item=str(item), error=str(e))
        else:
            self.processed.inc()
            with self._mu:
                self._purgatory.pop(item, None)
                self.purgatory_size.set(len(self._purgatory))

    def process_one(self) -> bool:
        item = self._pop()
        if item is None:
            return False
        self._run(item)
        return True

    def _retry_purgatory(self, force: bool = False) -> int:
        now = self._clock()
        with self._mu:
            due = [i for i, (_, when) in self._purgatory.items()
                   if force or when <= now]
        for item in due:
            self._run(item)
        return len(due)

    def drain(self, force_purgatory: bool = False) -> int:
        """Synchronously process everything queued (and, optionally, all
        of purgatory). Returns how many items were attempted."""
        n = 0
        while self.process_one():
            n += 1
        n += self._retry_purgatory(force=force_purgatory)
        return n

    # -- background loop ----------------------------------------------------

    def _loop(self) -> None:
        next_purgatory = self._clock() + self.purgatory_interval_s
        while not self._stop.is_set():
            if not self.process_one():
                self._stop.wait(self.interval_s)
            if self._clock() >= next_purgatory:
                self._retry_purgatory()
                next_purgatory = self._clock() + self.purgatory_interval_s

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"queue-{self.name}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
