"""Range lifecycle allocator — StorePool + split/merge/rebalance queues.

The port of ``cockroach_tpu.kv.allocator``.

Reference: pkg/kv/kvserver keeps ranges healthy with background queues —
splitQueue (load/size splits via split.Decider), mergeQueue (cold adjacent
ranges), and the storeRebalancer moving leases/replicas off overloaded
stores using a gossip-fed StorePool (allocator/storepool/store_pool.go)
with mean-based overfull/underfull thresholds.

Reduction here: `RangeLifecycle` owns three `ReplicaQueue`s and a scanner
that walks the meta descriptor table each tick, consulting

- `RangeLoadStats` (kv/loadstats.py) sampled on the DistSender routing
  path for decayed per-range QPS + a split-key reservoir, and
- `Engine.span_stats` for authoritative logical size,

then enqueues decisions. Applications go through the EXISTING admin
machinery — `Meta.split_at` / `Meta.merge_at` / `DistSender.move_range` /
`LeaseManager.carry`/`transfer` — so RangeCache staleness detection and
LeaseRouter rerouting keep working unchanged. Every apply step is
idempotent across the `ranger.*` fault sites: a crash between the meta
write and the bookkeeping retries from purgatory and converges.

Everything is drivable synchronously (`scan_once` + queue `drain`) for
deterministic tests; `start`/`stop` add the paced background loops that
`Node.close()` joins.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from ..storage.lsm import WriteIntentError
from ..utils import faults, locks, log, metric, settings
from .loadstats import RangeLoadStats
from .queues import ReplicaQueue
from .txn import TransactionRetryError


@dataclass
class StoreCapacity:
    """One store's gossiped capacity advertisement (StoreDescriptor's
    Capacity reduced to what the thresholds read)."""

    store_id: int
    node_id: int
    ranges: int
    qps: float
    logical_bytes: int

    def to_info(self) -> dict:
        return {"storeId": self.store_id, "nodeId": self.node_id,
                "ranges": self.ranges, "qps": self.qps,
                "logicalBytes": self.logical_bytes}

    @classmethod
    def from_info(cls, v: dict) -> "StoreCapacity":
        return cls(int(v["storeId"]), int(v["nodeId"]), int(v["ranges"]),
                   float(v["qps"]), int(v["logicalBytes"]))


class StorePool:
    """Cluster-wide store capacity view (storepool reduction): local
    advertisements publish into gossip as ``capacity/<sid>`` infos;
    `refresh` folds in what peers gossiped. Thresholds are mean-based,
    exactly the reference's overfull/underfull discipline."""

    OVERFULL = 1.15   # qps > mean * OVERFULL  -> shed load
    UNDERFULL = 0.85  # qps < mean * UNDERFULL -> take load

    def __init__(self, gossip=None):
        self.gossip = gossip
        self._mu = locks.lock("kv.allocator")
        self._caps: dict[int, StoreCapacity] = {}

    def note(self, cap: StoreCapacity) -> None:
        with self._mu:
            self._caps[cap.store_id] = cap

    def advertise(self, cap: StoreCapacity) -> None:
        self.note(cap)
        if self.gossip is not None:
            self.gossip.add_info(f"capacity/{cap.store_id}", cap.to_info())

    def refresh(self) -> None:
        if self.gossip is None:
            return
        for k in list(self.gossip.keys()):
            if not k.startswith("capacity/"):
                continue
            v = self.gossip.get_info(k)
            if isinstance(v, dict):
                try:
                    self.note(StoreCapacity.from_info(v))
                except (KeyError, TypeError, ValueError):
                    continue

    def capacities(self) -> list[StoreCapacity]:
        with self._mu:
            return sorted(self._caps.values(), key=lambda c: c.store_id)

    def get(self, store_id: int) -> StoreCapacity | None:
        with self._mu:
            return self._caps.get(store_id)

    def mean_qps(self) -> float:
        caps = self.capacities()
        return sum(c.qps for c in caps) / len(caps) if caps else 0.0

    def overfull(self) -> list[StoreCapacity]:
        mean = self.mean_qps()
        return [c for c in self.capacities() if c.qps > mean * self.OVERFULL]

    def least_loaded(self, exclude_store: int | None = None
                     ) -> StoreCapacity | None:
        cands = [c for c in self.capacities()
                 if c.store_id != exclude_store]
        return min(cands, key=lambda c: c.qps) if cands else None


# failures that mean "the world will get better": transport-ish errors
# (InjectedFault subclasses ConnectionError), a txn that lost a race, or
# an intent in the way — these park in purgatory and retry with backoff
_PURGATORY = (ConnectionError, OSError, TimeoutError,
              WriteIntentError, TransactionRetryError)


class RangeLifecycle:
    """The queues + scanner, wired over a DistSender.

    `leases` (a LeaseManager) and `gossip` are optional: without them the
    lifecycle still splits/merges/moves ranges (store-level rebalance);
    with them, splits carry the parent's (holder, epoch) to the child and
    rebalance transfers the lease to the target's node. `store_nodes`
    maps store_id -> node_id for transfer targets (in-process clusters
    pin each store to the node that serves it)."""

    def __init__(self, sender, load: RangeLoadStats | None = None,
                 leases=None, gossip=None, node_id: int = 0,
                 store_nodes: dict[int, int] | None = None,
                 interval_s: float = 1.0,
                 registry: metric.Registry = metric.DEFAULT,
                 clock=time.monotonic):
        self.sender = sender
        self.meta = sender.meta
        if load is None:
            load = getattr(sender, "load", None) or RangeLoadStats()
        self.load = load
        if getattr(sender, "load", None) is None:
            sender.load = load  # start sampling the routing path
        self.leases = leases
        self.node_id = node_id
        self.store_nodes = dict(store_nodes or {})
        self.pool = StorePool(gossip)
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._scanner: threading.Thread | None = None
        self.split_queue = ReplicaQueue(
            "split", self._apply_split, interval_s,
            purgatory_errors=_PURGATORY, registry=registry, clock=clock)
        self.merge_queue = ReplicaQueue(
            "merge", self._apply_merge, interval_s,
            purgatory_errors=_PURGATORY, registry=registry, clock=clock)
        self.rebalance_queue = ReplicaQueue(
            "rebalance", self._apply_transfer, interval_s,
            purgatory_errors=_PURGATORY, registry=registry, clock=clock)

    # -- decisions (the scanner) --------------------------------------------

    def _desc(self, range_id: int):
        for d in self.meta.snapshot():
            if d.range_id == range_id:
                return d
        return None

    def _span_bytes(self, d) -> int:
        eng = self.sender.stores[d.store_id].engine
        return int(eng.span_stats(d.start_key, d.end_key)["logical_bytes"])

    def scan_once(self) -> None:
        """One decision pass over every range: enqueue splits for hot or
        oversized ranges, merges for cold adjacent pairs, and a rebalance
        for the hottest range of an overfull store. Pure decision — all
        mutation happens in queue processing."""
        descs = self.meta.snapshot()
        split_qps = settings.get("kv.range.split_qps_threshold")
        max_bytes = settings.get("kv.range.max_bytes")
        sizes = {d.range_id: self._span_bytes(d) for d in descs}
        # read each range's decayed rate ONCE and reuse it for every
        # decision below — per-decision re-reads decay in between, and
        # the epsilon lets a single-range store slip past the
        # improvement guard (hot_qps < its own advertised sum)
        qps_by_range = {d.range_id: self.load.qps(d.range_id)
                        for d in descs}
        for d in descs:
            qps = qps_by_range[d.range_id]
            ratio = max(qps / split_qps, sizes[d.range_id] / max_bytes)
            if ratio >= 1.0:
                self.split_queue.maybe_add(d.range_id, ratio)
        if settings.get("kv.range.merge_enabled"):
            # a pair is merge-worthy when BOTH the combined load and the
            # combined size sit far below the split thresholds (hysteresis
            # so a merge never immediately re-splits)
            for left, right in zip(descs, descs[1:]):
                qps = (qps_by_range[left.range_id]
                       + qps_by_range[right.range_id])
                size = sizes[left.range_id] + sizes[right.range_id]
                if qps < 0.25 * split_qps and size < max_bytes // 2:
                    self.merge_queue.maybe_add(right.start_key, 1.0)
        self._advertise(descs, sizes, qps_by_range)
        caps = self.pool.capacities()
        mean = self.pool.mean_qps()
        if len(caps) >= 2 and mean > 0:
            for oc in self.pool.overfull():
                target = self.pool.least_loaded(exclude_store=oc.store_id)
                if target is None or target.qps >= mean * self.pool.UNDERFULL:
                    continue
                hot = max(
                    (d for d in descs if d.store_id == oc.store_id),
                    key=lambda d: qps_by_range[d.range_id], default=None)
                if hot is None:
                    continue
                hot_qps = qps_by_range[hot.range_id]
                # the move must IMPROVE balance: shipping the range can't
                # leave the target hotter than the source was, or a
                # store's only range ping-pongs between stores forever
                if hot_qps > 0 and target.qps + hot_qps < oc.qps:
                    self.rebalance_queue.maybe_add(hot.range_id, hot_qps)

    def _advertise(self, descs, sizes, qps_by_range) -> None:
        # every LOCAL store advertises, including empty ones — a store
        # with no ranges is exactly the underfull rebalance target
        per: dict[int, list] = {sid: [0, 0.0, 0]
                                for sid in self.sender.stores}
        for d in descs:
            c = per.setdefault(d.store_id, [0, 0.0, 0])
            c[0] += 1
            c[1] += qps_by_range.get(d.range_id, 0.0)
            c[2] += sizes.get(d.range_id, 0)
        for sid, (ranges, qps, size) in per.items():
            self.pool.advertise(StoreCapacity(
                sid, self.store_nodes.get(sid, self.node_id),
                ranges, qps, size))
        self.pool.refresh()  # fold in peers' advertisements

    # -- applications (queue processors) ------------------------------------

    def _apply_split(self, range_id: int) -> None:
        d = self._desc(range_id)
        if d is None:
            return  # merged away since the decision
        # torn-split recovery: a crashed prior attempt got the meta write
        # in (our descriptor already shrank) but never ran the lease
        # carry / load handoff — visible as samples stranded beyond our
        # end_key. Finish THAT split's bookkeeping; recomputing a fresh
        # split key against the shrunk bounds would cut a second,
        # different boundary instead of converging.
        if (d.end_key is not None
                and self.load.stranded_beyond(range_id, d.end_key)):
            right = next((x for x in self.meta.snapshot()
                          if x.start_key == d.end_key), None)
            if right is not None:
                self._finish_split(d, right, d.end_key, range_id)
                return
        key = self.load.split_key(range_id, d.start_key, d.end_key)
        if key is None:
            return  # samples can't name an interior point (single hot key)
        left, right = self.meta.split_at(key)
        if left.range_id == right.range_id:
            # boundary already present (e.g. a concurrent admin split at
            # the same key): recover both sides, redo the bookkeeping
            right = left
            left = next((x for x in self.meta.snapshot()
                         if x.end_key == key), None)
            if left is None:
                return
        # crash window the chaos suite targets: meta is split, but the
        # lease carry / cache repair / load handoff below hasn't happened
        faults.fire("ranger.split.apply")
        self._finish_split(left, right, key, range_id)

    def _finish_split(self, left, right, key: bytes, range_id: int) -> None:
        if self.leases is not None:
            self.leases.carry(left.range_id, right.range_id)
        self.load.note_split(left.range_id, right.range_id, key)
        self.sender.cache.insert(left)
        self.sender.cache.insert(right)
        metric.KV_RANGE_SPLITS.inc()
        log.info(log.OPS, "load/size split applied",
                 range=range_id, at=key.decode(errors="replace"),
                 child=right.range_id)

    def _apply_merge(self, boundary: bytes) -> None:
        descs = self.meta.snapshot()
        right = next((d for d in descs if d.start_key == boundary), None)
        if right is None:
            # boundary already gone (crashed retry or concurrent merge):
            # repair the cache with the current owner and converge
            self.sender.cache.insert(self.meta.lookup(boundary))
            return
        i = descs.index(right)
        if i == 0:
            return
        left = descs[i - 1]
        # re-validate at apply time — load may have returned since the scan
        split_qps = settings.get("kv.range.split_qps_threshold")
        if not settings.get("kv.range.merge_enabled"):
            return
        if (self.load.qps(left.range_id)
                + self.load.qps(right.range_id)) >= 0.25 * split_qps:
            return
        if left.store_id != right.store_id:
            # metadata-only merge needs colocation; move the cold right
            # side over first (idempotent: re-moving is a no-op)
            self.sender.move_range(right.range_id, left.store_id)
        merged = self.meta.merge_at(boundary)
        if merged is None:
            return
        faults.fire("ranger.merge.apply")
        self.load.note_merge(merged.range_id, right.range_id)
        if self.leases is not None:
            self.leases.release(right.range_id)
        self.sender.cache.evict(right)
        self.sender.cache.insert(merged)
        metric.KV_RANGE_MERGES.inc()

    def _apply_transfer(self, range_id: int) -> None:
        d = self._desc(range_id)
        if d is None:
            return
        # crashed-retry convergence: the data move landed but the lease
        # write was lost. The range's home store names the intended
        # holder, so finish the handoff before any fresh balance
        # decision (a completed transfer makes this a no-op).
        dest_node = self.store_nodes.get(d.store_id, 0)
        if self.leases is not None and dest_node:
            cur = self.leases.holder(range_id)
            if cur is not None and cur.node_id != dest_node:
                self.leases.transfer(range_id, dest_node)
                metric.KV_LEASE_TRANSFERS.inc()
                log.info(log.OPS, "lease transfer completed on retry",
                         range=range_id, to_node=dest_node)
                return
        # re-advertise from CURRENT state before re-checking the balance:
        # the scan-time capacities are stale once any earlier drained item
        # moved a range, and refresh() alone can't see local moves
        descs = self.meta.snapshot()
        sizes = {x.range_id: self._span_bytes(x) for x in descs}
        qps_by_range = {x.range_id: self.load.qps(x.range_id)
                        for x in descs}
        self._advertise(descs, sizes, qps_by_range)
        src = self.pool.get(d.store_id)
        target = self.pool.least_loaded(exclude_store=d.store_id)
        r_qps = qps_by_range.get(range_id, 0.0)
        if target is None or (
                src is not None and target.qps + r_qps >= src.qps):
            return  # imbalance resolved itself since the decision
        self.sender.move_range(range_id, target.store_id)
        # the in-flight window the chaos suite targets: data moved, lease
        # transfer write lost — retry re-enters with a no-op move
        faults.fire("ranger.lease.transfer")
        if self.leases is not None and target.node_id:
            self.leases.transfer(range_id, target.node_id)
        metric.KV_LEASE_TRANSFERS.inc()
        log.info(log.OPS, "lease rebalanced", range=range_id,
                 to_store=target.store_id, to_node=target.node_id)

    # -- driving ------------------------------------------------------------

    def tick(self, force_purgatory: bool = False) -> int:
        """Synchronous scan + drain of every queue (deterministic tests
        and the CLI's one-shot mode). Returns items attempted."""
        self.scan_once()
        n = self.split_queue.drain(force_purgatory)
        n += self.merge_queue.drain(force_purgatory)
        n += self.rebalance_queue.drain(force_purgatory)
        return n

    def hot_ranges(self) -> dict:
        """The /hot_ranges payload: every range with its decayed load,
        authoritative size, home store, and leaseholder node."""
        rows = []
        for d in self.meta.snapshot():
            rec = self.leases.holder(d.range_id) if self.leases else None
            rows.append({
                "rangeId": d.range_id,
                "startKey": d.start_key.decode(errors="replace"),
                "endKey": (d.end_key.decode(errors="replace")
                           if d.end_key is not None else None),
                "storeId": d.store_id,
                "qps": round(self.load.qps(d.range_id), 3),
                "writeBytesRate": round(
                    self.load.write_bytes_rate(d.range_id), 3),
                "sizeBytes": self._span_bytes(d),
                "leaseholder": rec.node_id if rec is not None else None,
            })
        rows.sort(key=lambda r: -r["qps"])
        return {"hotRanges": rows}

    def _scan_loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scan_once()
            # crlint: allow-broad-except(background scan loop must survive; logged)
            except Exception as e:  # noqa: BLE001 - the loop survives; logged
                log.warning(log.OPS, "range lifecycle scan failed",
                            error=str(e))

    def start(self) -> None:
        if not settings.get("kv.allocator.enabled"):
            return
        for q in (self.split_queue, self.merge_queue, self.rebalance_queue):
            q.start()
        if self._scanner is None:
            self._stop.clear()
            self._scanner = threading.Thread(
                target=self._scan_loop, name="range-lifecycle-scan",
                daemon=True)
            self._scanner.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._scanner = self._scanner, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        for q in (self.split_queue, self.merge_queue, self.rebalance_queue):
            q.stop()
