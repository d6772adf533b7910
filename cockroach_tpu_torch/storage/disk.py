"""Disk health monitoring — the pkg/storage/disk + ballast reduction; the
port of ``cockroach_tpu.storage.disk``.

Reference: every store tracks device-level write stats and flags slow
disks (pkg/storage/disk/monitor.go); a preallocated ballast file
(pkg/storage/ballast.go) reserves headroom so an out-of-disk condition
can be relieved by deleting it instead of crashing unrecoverably.

Here the monitor samples the engine's OWN WAL appends (the latency that
actually gates writes) plus a periodic probe write, keeps a rolling
window, and trips a slow-disk flag when the p99 exceeds
``storage.disk.slow_threshold_ms``. Two gauges carry the worst store's
p99 and whether any disk is slow.
"""

from __future__ import annotations

import collections
import os
import threading
import time
import weakref

from ..utils import log, settings
from ..utils.metric import DISK_PROBES, DISK_SLOW, DISK_WRITE_P99

# process-wide gauges reflect the WORST store (max p99 / any slow): "any
# disk slow" is the signal an operator pages on

_MONITORS: weakref.WeakSet = weakref.WeakSet()  # every live DiskMonitor


class DiskMonitor:
    """Rolling-window write-latency tracker + optional background prober.

    ``observe(seconds)`` is called by the WAL append path; ``probe()``
    writes+fsyncs a small marker file to detect stalls even when the
    workload is idle (the reference's periodic stat sampling role)."""

    _PUBLISH_EVERY = 32  # amortize the O(window log window) p99 sort

    def __init__(self, dir_path: str, window: int = 256):
        self.dir = dir_path
        self.samples: collections.deque[float] = collections.deque(
            maxlen=window)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._since_publish = 0
        self._slow = False
        _MONITORS.add(self)

    # -- sampling ------------------------------------------------------------

    def observe(self, seconds: float) -> None:
        with self._lock:
            self.samples.append(seconds * 1e3)
            self._since_publish += 1
            publish = self._since_publish >= self._PUBLISH_EVERY
            if publish:
                self._since_publish = 0
        # publishing sorts the window — amortized off the write hot path
        # (the prober loop publishes too, covering idle stores)
        if publish:
            self._publish()

    def probe(self) -> float:
        """One marker write+fsync; returns elapsed ms (also recorded)."""
        path = os.path.join(self.dir, ".disk_probe")
        t0 = time.time()
        with open(path, "wb") as f:
            f.write(b"x" * 512)
            f.flush()
            os.fsync(f.fileno())
        el = time.time() - t0
        DISK_PROBES.inc()
        self.observe(el)
        self._publish()  # the prober publishes even on idle stores
        return el * 1e3

    def p99_ms(self) -> float:
        with self._lock:
            if not self.samples:
                return 0.0
            s = sorted(self.samples)
            return s[min(len(s) - 1, int(len(s) * 0.99))]

    def is_slow(self) -> bool:
        # computed fresh (not the cached _slow flag): /health must see a
        # stall immediately, not at the next publish boundary
        return self.p99_ms() > settings.get("storage.disk.slow_threshold_ms")

    def _publish(self) -> None:
        p99 = self.p99_ms()
        slow = p99 > settings.get("storage.disk.slow_threshold_ms")
        if slow and not self._slow:
            log.warning(log.STORAGE, "disk flagged SLOW", dir=self.dir,
                        p99_ms=round(p99, 1))
        elif self._slow and not slow:
            log.info(log.STORAGE, "disk recovered", dir=self.dir,
                     p99_ms=round(p99, 1))
        self._slow = slow
        # gauges max-merge across every live monitor (worst store wins)
        worst = 0.0
        any_slow = False
        for m in list(_MONITORS):
            worst = max(worst, m.p99_ms())
            any_slow = any_slow or m._slow
        DISK_WRITE_P99.set(worst)
        DISK_SLOW.set(1.0 if any_slow else 0.0)

    # -- background prober ---------------------------------------------------

    def start(self, interval_s: float = 5.0) -> "DiskMonitor":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, args=(interval_s,), name="disk-monitor",
            daemon=True)
        self._thread.start()
        return self

    def _loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.probe()
            except OSError as e:  # a failing probe IS the signal
                log.error(log.STORAGE, "disk probe failed", error=str(e))
                self.observe(settings.get(
                    "storage.disk.slow_threshold_ms") / 1e3 * 10)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ---------------------------------------------------------------------------
# ballast


def create_ballast(dir_path: str, size_bytes: int = 16 << 20) -> str:
    """Preallocate the emergency-headroom file (ballast.go role). Returns
    its path; no-op if it already exists at (>=) the requested size."""
    path = os.path.join(dir_path, "EMERGENCY_BALLAST")
    try:
        if os.path.getsize(path) >= size_bytes:
            return path
    except OSError:
        pass
    with open(path, "wb") as f:
        # sparse-unfriendly fill so the space is genuinely reserved
        chunk = b"\0" * (1 << 20)
        left = size_bytes
        while left > 0:
            f.write(chunk[:min(len(chunk), left)])
            left -= len(chunk)
        f.flush()
        os.fsync(f.fileno())
    return path


def release_ballast(dir_path: str) -> bool:
    """Delete the ballast to relieve an out-of-disk condition. Returns
    True if space was freed."""
    path = os.path.join(dir_path, "EMERGENCY_BALLAST")
    try:
        os.unlink(path)
        log.warning(log.STORAGE, "ballast released", path=path)
        return True
    except OSError:
        return False
