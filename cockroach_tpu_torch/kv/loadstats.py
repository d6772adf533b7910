"""Per-range load stats — the replicastats/split.Decider analog.

The port of ``cockroach_tpu.kv.loadstats``.

Reference: pkg/kv/kvserver/replicastats tracks per-replica QPS with
exponentially decaying counters; split.(*Decider) additionally records a
reservoir of request keys (split/finder.go) so that when the decider
declares the range hot, a split key balancing the observed load is already
at hand. Here a `RangeLoadStats` lives on the DistSender (the single place
every routed request passes through in-process) and keeps, per range:

- decayed queries/sec and write-bytes/sec (half-life decay, no timer
  thread: decay is applied lazily at record/read time), and
- a seeded reservoir sample of request keys, from which `split_key`
  proposes the median — the key that puts ~half the observed load on
  each side.

The clock is injectable so tests can step time deterministically.
"""

from __future__ import annotations

import random
import time

from ..utils import locks


class DecayingCounter:
    """Exponentially decaying rate estimator.

    `record(n)` adds n events "now"; `rate()` returns events/sec with
    past events discounted by half every `half_life_s`. Lazy decay: the
    running total is folded forward on every touch, so an idle range's
    rate falls toward zero without any background work.
    """

    def __init__(self, half_life_s: float = 30.0, clock=time.monotonic):
        self.half_life_s = float(half_life_s)
        self._clock = clock
        self._value = 0.0          # decayed event count
        self._last = self._clock()

    def _decay(self) -> None:
        now = self._clock()
        dt = now - self._last
        if dt > 0:
            self._value *= 0.5 ** (dt / self.half_life_s)
            self._last = now

    def record(self, n: float = 1.0) -> None:
        self._decay()
        self._value += n

    def rate(self) -> float:
        """Decayed events/sec: the decayed count spread over the window
        that contributed it (~1.44 half-lives, the decay's mean age)."""
        self._decay()
        return self._value / (1.4427 * self.half_life_s)


class _RangeLoad:
    __slots__ = ("qps", "wbps", "samples", "seen")

    def __init__(self, half_life_s: float, clock):
        self.qps = DecayingCounter(half_life_s, clock)
        self.wbps = DecayingCounter(half_life_s, clock)
        self.samples: list[bytes] = []   # reservoir of request keys
        self.seen = 0                    # requests offered to the reservoir


class RangeLoadStats:
    """Per-range decayed load + split-key reservoir, keyed by range id."""

    def __init__(self, half_life_s: float = 30.0, sample_size: int = 16,
                 seed: int = 0, clock=time.monotonic):
        self.half_life_s = float(half_life_s)
        self.sample_size = int(sample_size)
        self._rng = random.Random(seed)
        self._clock = clock
        self._mu = locks.lock("kv.loadstats")
        self._ranges: dict[int, _RangeLoad] = {}

    def _load(self, range_id: int) -> _RangeLoad:
        rl = self._ranges.get(range_id)
        if rl is None:
            rl = self._ranges[range_id] = _RangeLoad(
                self.half_life_s, self._clock)
        return rl

    def _sample(self, rl: _RangeLoad, key: bytes) -> None:
        rl.seen += 1
        if len(rl.samples) < self.sample_size:
            rl.samples.append(bytes(key))
        else:
            j = self._rng.randrange(rl.seen)
            if j < self.sample_size:
                rl.samples[j] = bytes(key)

    def record_read(self, range_id: int, key: bytes) -> None:
        with self._mu:
            rl = self._load(range_id)
            rl.qps.record(1.0)
            self._sample(rl, key)

    def record_write(self, range_id: int, key: bytes, nbytes: int) -> None:
        with self._mu:
            rl = self._load(range_id)
            rl.qps.record(1.0)
            rl.wbps.record(float(nbytes))
            self._sample(rl, key)

    def qps(self, range_id: int) -> float:
        with self._mu:
            rl = self._ranges.get(range_id)
            return rl.qps.rate() if rl else 0.0

    def write_bytes_rate(self, range_id: int) -> float:
        with self._mu:
            rl = self._ranges.get(range_id)
            return rl.wbps.rate() if rl else 0.0

    def split_key(self, range_id: int, start_key: bytes,
                  end_key: bytes | None) -> bytes | None:
        """Median sampled key strictly inside (start_key, end_key) — the
        split.Finder reduction: cut where ~half the observed requests land
        on each side. None when the samples can't name an interior point
        (single hot key, or everything at the range start)."""
        with self._mu:
            rl = self._ranges.get(range_id)
            if rl is None or not rl.samples:
                return None
            inside = sorted(
                k for k in rl.samples
                if k > start_key and (end_key is None or k < end_key))
            if not inside:
                return None
            return inside[len(inside) // 2]

    def note_split(self, parent_id: int, child_id: int,
                   split_key: bytes) -> None:
        """Hand the child its share of the parent's history so the fresh
        range doesn't look cold (and immediately merge-eligible): samples
        partition by the split key; rates halve on both sides."""
        with self._mu:
            rl = self._ranges.get(parent_id)
            if rl is None:
                return
            child = self._load(child_id)
            child_samples = [k for k in rl.samples if k >= split_key]
            rl.samples = [k for k in rl.samples if k < split_key]
            child.samples = child_samples[-self.sample_size:]
            child.seen = len(child.samples)
            rl.seen = max(rl.seen // 2, len(rl.samples))
            for src, dst in ((rl.qps, child.qps), (rl.wbps, child.wbps)):
                src._decay()
                dst._decay()
                dst._value += src._value / 2.0
                src._value /= 2.0

    def note_merge(self, keep_id: int, gone_id: int) -> None:
        """Fold the absorbed range's remaining load into the survivor."""
        with self._mu:
            gone = self._ranges.pop(gone_id, None)
            if gone is None:
                return
            keep = self._load(keep_id)
            for src, dst in ((gone.qps, keep.qps), (gone.wbps, keep.wbps)):
                src._decay()
                dst._decay()
                dst._value += src._value
            room = self.sample_size - len(keep.samples)
            if room > 0:
                keep.samples.extend(gone.samples[:room])
            keep.seen += gone.seen

    def stranded_beyond(self, range_id: int, end_key: bytes) -> bool:
        """True when the range still holds samples at/after `end_key` —
        the signature of a torn split: the meta boundary landed but the
        load handoff (note_split) never ran. A healthy split partitions
        samples at the boundary, and post-split requests route per-range,
        so out-of-bounds samples only survive a crashed apply."""
        with self._mu:
            rl = self._ranges.get(range_id)
            return bool(rl and any(k >= end_key for k in rl.samples))

    def forget(self, range_id: int) -> None:
        with self._mu:
            self._ranges.pop(range_id, None)

    def report(self) -> dict[int, dict]:
        """Snapshot for /hot_ranges: {rid: {qps, writeBytesRate}}."""
        with self._mu:
            return {
                rid: {"qps": rl.qps.rate(),
                      "writeBytesRate": rl.wbps.rate()}
                for rid, rl in self._ranges.items()
            }
