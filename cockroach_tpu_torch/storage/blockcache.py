"""Block cache and split-block bloom filters — the Pebble read-path stack
(counterpart of ``cockroach_tpu.storage.blockcache``; host/numpy code).

- ``SplitBloom``: split-block bloom filter (every key maps to one 512-bit
  block); a CRC taken at build time is verified lazily on the first
  negative answer, so a corrupt filter disables itself and answers
  "maybe" from then on (chaos site ``storage.bloom.build``).
- ``RunMeta``: per-run read-path metadata (sorted key column for seek
  binary search, live-row count, bloom) with a process-unique ``token``
  namespacing the run's block-cache entries.
- ``BlockCache``: node-wide clock (second-chance) cache of ``KVBlock``
  windows keyed ``(run token, window position, window size)``. Its budget
  is the ``storage.block_cache.size_bytes`` setting; the port keeps its
  own byte count instead of a monitor tree.
"""

from __future__ import annotations

import itertools
import threading
import zlib
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from ..utils import faults, locks, metric

BLOOM_BITS_PER_KEY = 10
BLOOM_K = 6  # near-optimal probe count at 10 bits/key (ln2 * 10 ≈ 6.9)
_BLOCK_BITS = 512  # one cache line in the reference full-filter layout

_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)
_H2_OFFSET = np.uint64(0x9E3779B97F4A7C15)
_H2_MULT = np.uint64(0xC2B2AE3D27D4EB4F)
_MASK64 = 0xFFFFFFFFFFFFFFFF


def bloom_hashes(void_keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized double hash over a void-dtype key column: FNV-1a as h1
    plus an independent mix as h2 (forced odd so the probe sequence
    ``h1 + i*h2`` walks every residue). One pass per key byte, all keys
    at once — building a filter for a whole run is a few numpy sweeps."""
    raw = void_keys.view(np.uint8).reshape(len(void_keys), -1)
    h1 = np.full(len(void_keys), _FNV_OFFSET, dtype=np.uint64)
    h2 = np.full(len(void_keys), _H2_OFFSET, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for j in range(raw.shape[1]):
            col = raw[:, j].astype(np.uint64)
            h1 = (h1 ^ col) * _FNV_PRIME
            h2 = (h2 + col) * _H2_MULT ^ (h2 >> np.uint64(29))
    return h1, h2 | np.uint64(1)


class SplitBloom:
    """Split-block bloom filter over one run's live keys.

    The block index comes from the HIGH half of h1 and the probe bits
    from the low halves of h1/h2, so block choice and in-block probes are
    decorrelated — reusing the same bits for both collapses the filter's
    effective k. At 10 bits/key the theoretical false-positive rate is
    ~1.2%; the property test holds the line at <3%.
    """

    __slots__ = ("bits", "nblocks", "crc", "disabled", "_verified",
                 "__weakref__")

    def __init__(self, bits: np.ndarray, nblocks: int, crc: int):
        self.bits = bits
        self.nblocks = nblocks
        self.crc = crc
        self.disabled = False
        self._verified = False

    @classmethod
    def build(cls, void_keys: np.ndarray) -> "SplitBloom":
        faults.fire("storage.bloom.build")
        n = len(void_keys)
        nblocks = max(1, -(-n * BLOOM_BITS_PER_KEY // _BLOCK_BITS))
        bits = np.zeros(nblocks * _BLOCK_BITS, dtype=bool)
        if n:
            h1, h2 = bloom_hashes(void_keys)
            base = ((h1 >> np.uint64(32)) % np.uint64(nblocks)).astype(
                np.int64) * _BLOCK_BITS
            with np.errstate(over="ignore"):
                for i in range(BLOOM_K):
                    bit = ((h1 + np.uint64(i) * h2)
                           % np.uint64(_BLOCK_BITS)).astype(np.int64)
                    bits[base + bit] = True
        crc = zlib.crc32(np.packbits(bits).tobytes())
        filt = cls(bits, nblocks, crc)
        from ..flow import memory as flowmem

        # filter residency (~BLOOM_BITS_PER_KEY bytes/key as host bools)
        # charges the node budget until compaction drops the run's meta
        flowmem.charge_object("storage/bloom-residency", filt,
                              int(bits.nbytes))
        frac = faults.partial_fraction("storage.bloom.build")
        if frac is not None:
            # chaos: silent bit corruption AFTER the checksum was taken —
            # the lazy CRC verify must catch it on the first negative
            bits[:: max(1, int(round(1 / frac)))] ^= True
        return filt

    def might_contain(self, h1: int, h2: int) -> bool:
        """Probe with a precomputed (h1, h2) pair. True means "maybe
        present"; False is a proof of absence (CRC-checked)."""
        if self.disabled:
            return True
        base = ((h1 >> 32) % self.nblocks) * _BLOCK_BITS
        for i in range(BLOOM_K):
            if not self.bits[base + ((h1 + i * h2) & _MASK64) % _BLOCK_BITS]:
                # a negative is only trustworthy from an intact filter:
                # _verify is True exactly when corruption was detected
                # (the filter then answers maybe, here and forever)
                return self._verify()
        return True

    def _verify(self) -> bool:
        """First-negative CRC check. Positives never need verification
        (a flipped-ON bit only costs a wasted scan); a negative from a
        corrupt filter would LOSE a row, so the first one pays one CRC
        pass. Returns True when the filter is corrupt (and disables it)."""
        if self._verified:
            return False
        if zlib.crc32(np.packbits(self.bits).tobytes()) != self.crc:
            self.disabled = True
            metric.BLOOM_CORRUPTIONS.inc()
            return True
        self._verified = True
        return False


# Tokens are process-global and monotonic: a compacted-away run's cache
# entries can never alias a newly built run's.
_TOKENS = itertools.count(1)


@dataclass
class RunMeta:
    """Read-path metadata for one immutable sorted run."""

    token: int
    void_keys: np.ndarray  # full sorted key column, void dtype (memcmp order)
    n_live: int
    _bloom: SplitBloom | None = None
    _bloom_built: bool = False

    def bloom(self) -> SplitBloom | None:
        """The run's filter, built on first demand. Engine's run
        constructors (ingest/flush/compaction) force the build eagerly;
        rewrite paths (intent resolution, span clears) leave it lazy so
        commit-heavy workloads don't pay filter builds per txn. None
        means "no filter" — every point read scans the run (correct,
        just slower)."""
        if not self._bloom_built:
            self._bloom_built = True
            try:
                self._bloom = SplitBloom.build(self.void_keys[: self.n_live])
            except faults.InjectedFault:
                self._bloom = None
        return self._bloom


def build_meta(void_keys: np.ndarray, n_live: int) -> RunMeta:
    return RunMeta(next(_TOKENS), void_keys, int(n_live))


class BlockCache:
    """Node-wide clock cache of KVBlock windows.

    Lock order: callers (Engine) hold ``storage.engine`` before
    ``storage.blockcache``; the cache never calls back into the engine.
    """

    def __init__(self, name: str = "storage/block-cache"):
        self._mu = locks.rlock("storage.blockcache")
        self._name = name
        # key -> [block, nbytes, ref_bit]; dict order is clock order
        self._entries: OrderedDict[tuple, list] = OrderedDict()
        self._used = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _budget(self) -> int:
        from ..utils import settings

        return int(settings.get("storage.block_cache.size_bytes"))

    def get(self, token: int, pos: int, size: int):
        with self._mu:
            e = self._entries.get((token, pos, size))
            if e is None:
                self.misses += 1
                metric.BLOCKCACHE_MISSES.inc()
                return None
            e[2] = True  # second chance
            self.hits += 1
            metric.BLOCKCACHE_HITS.inc()
            return e[0]

    def put(self, token: int, pos: int, size: int, block) -> None:
        budget = self._budget()
        if budget <= 0:
            return  # cache disabled
        nbytes = block.nbytes()
        if nbytes > budget:
            return  # a window larger than the whole budget never caches
        with self._mu:
            key = (token, pos, size)
            if key in self._entries:
                return
            # clock sweep: referenced entries get a second chance (ref
            # cleared, rotated to the back), unreferenced ones evict
            while self._used + nbytes > budget and self._entries:
                k, e = next(iter(self._entries.items()))
                if e[2]:
                    e[2] = False
                    self._entries.move_to_end(k)
                else:
                    del self._entries[k]
                    self._used -= e[1]
                    self.evictions += 1
                    metric.BLOCKCACHE_EVICTIONS.inc()
            self._entries[key] = [block, nbytes, False]
            self._used += nbytes
            metric.BLOCKCACHE_BYTES.set(self._used)

    def invalidate_run(self, token: int) -> None:
        """Drop every cached window of one run, and only that run's."""
        with self._mu:
            dead = [k for k in self._entries if k[0] == token]
            for k in dead:
                self._used -= self._entries.pop(k)[1]
            if dead:
                metric.BLOCKCACHE_BYTES.set(self._used)

    def clear(self) -> None:
        with self._mu:
            self._entries.clear()
            self._used = 0
            metric.BLOCKCACHE_BYTES.set(0)

    def used_bytes(self) -> int:
        with self._mu:
            return self._used

    def stats(self) -> dict:
        with self._mu:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "bytes": self._used,
                "entries": len(self._entries),
            }

    def describe(self) -> str:
        """One-line summary for EXPLAIN ANALYZE."""
        s = self.stats()
        total = s["hits"] + s["misses"]
        if total == 0:
            return "cold (no lookups)"
        return (f"{100.0 * s['hits'] / total:.1f}% hit rate "
                f"({s['hits']}/{total} lookups), {s['entries']} windows, "
                f"{s['bytes']} bytes")


_NODE_CACHE: BlockCache | None = None
_NODE_LOCK = threading.Lock()


def node_cache() -> BlockCache:
    """The node-wide cache every Engine of the process shares."""
    global _NODE_CACHE
    c = _NODE_CACHE
    if c is None:
        with _NODE_LOCK:
            if _NODE_CACHE is None:
                _NODE_CACHE = BlockCache()
            c = _NODE_CACHE
    return c


def refresh_gauges() -> None:
    """Re-publish the node cache's byte gauge (the node's metrics
    scraper)."""
    c = _NODE_CACHE
    if c is not None:
        metric.BLOCKCACHE_BYTES.set(c._used)
