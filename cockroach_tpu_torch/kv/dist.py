"""DistSender / RangeCache / multi-Store — the kvclient routing reduction.

The port of ``cockroach_tpu.kv.dist``.

Reference: the keyspace is split into ranges; range descriptors live in
meta ranges; DistSender (kvcoord/dist_sender.go:663) splits every batch by
range using the RangeDescriptorCache, routes each piece to the range's
leaseholder store, and retries with a fresh descriptor on
RangeKeyMismatchError when its cache was stale. Store.Send
(kvserver/store_send.go:41) verifies the request lies within a range it
owns.

The reduction, single process, N stores (one Engine each, on the card
unless ``device="cpu"`` is given to every Store):

- ``Meta``: the authoritative descriptor table (the meta-range role) —
  sorted host list, copy-on-write snapshots so concurrent readers never
  see a half-applied split.
- ``RangeCache``: per-DistSender cached descriptors; binary search by key,
  evicted on RangeKeyMismatchError (stale routing), refilled from Meta.
- ``Store``: an Engine + the set of range ids it owns; every request
  verifies its span against the CURRENT descriptor before touching the
  engine (the bounds check that makes stale caches detectable).
- ``DistSender``: implements the Engine surface DB/Txn and the SQL scan
  path consume (put/get/scan/scan_batch/ingest/resolve_intents/
  checkpoint/_merged_view/...), so ``DB(DistSender(...), clock)`` drops
  in with the txn layer unchanged. Cross-range scans split by range
  boundary and concatenate per-store results in key order. NOT forwarded:
  the admission governor and LSM tuning knobs — those stay per-store
  (consult ``stores[i].engine`` directly).
- admin ops: ``split_at`` (metadata-only, like the reference's AdminSplit
  — both halves stay on the store), ``move_range`` (scan + ingest into
  the target store — the snapshot-rebalance role).

Replication (multiple replicas per range, raft) stays out of scope per
SURVEY §7; each range has exactly one home store.

The SQL columnar fast path (kv/table.py KVTable.device_batch) reads
``_merged_view()`` — here a cross-store merged device view — so SQL
tables work over a split keyspace (see test_sql_over_multi_range_
keyspace). Every store's engine must sit on one device (``device``);
``scan_batch`` runs one ``Engine.scan_batch`` pass per store, so each
store's scan filter (K1 on 16-byte keys) and compaction merges (K2) run
on the card through this layer.

``open_cluster_checkpoint`` opens a ``DistSender.checkpoint`` directory
(one ``store<id>`` subdirectory per store) with its descriptors into a
new cluster: how a cluster's state moves between processes or packages.
``make_cluster`` builds n stores over one Meta; ``spread`` splits the
keyspace and puts each range on a store of its own.
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass

import numpy as np

from ..device import resolve_device
from ..storage.lsm import Engine
from ..utils import locks, log, metric


class RangeKeyMismatchError(Exception):
    """The routed store does not own the request's span (stale cache)."""


@dataclass(frozen=True)
class RangeDescriptor:
    range_id: int
    start_key: bytes  # inclusive
    end_key: bytes | None  # exclusive; None = +inf
    store_id: int
    generation: int = 0

    def contains(self, key: bytes) -> bool:
        return key >= self.start_key and (
            self.end_key is None or key < self.end_key
        )


class Meta:
    """Authoritative descriptor table. Descriptors tile the keyspace:
    [b"", split1), [split1, split2), ... [splitN, None)."""

    def __init__(self, first_store: int = 1):
        self._lock = locks.rlock("kv.rangecache")
        self._next_id = 2
        self._descs: list[RangeDescriptor] = [
            RangeDescriptor(1, b"", None, first_store)
        ]
        self.lookups = 0  # authoritative reads (the meta-range's QPS)

    def snapshot(self) -> list[RangeDescriptor]:
        with self._lock:
            return list(self._descs)

    def lookup(self, key: bytes) -> RangeDescriptor:
        with self._lock:
            self.lookups += 1
            i = self._find(key)
            return self._descs[i]

    def issued_ids(self) -> range:
        """Every range id this table has handed out, live or merged
        away."""
        with self._lock:
            return range(1, self._next_id)

    def _find(self, key: bytes) -> int:
        starts = [d.start_key for d in self._descs]
        return max(0, bisect.bisect_right(starts, key) - 1)

    def split_at(self, key: bytes) -> tuple[RangeDescriptor, RangeDescriptor]:
        """AdminSplit: [s, e) -> [s, key) + [key, e), both on the same
        store. Metadata-only, like the reference (data does not move)."""
        if not key:
            raise ValueError("cannot split at the minimum key")
        with self._lock:
            i = self._find(key)
            d = self._descs[i]
            if d.start_key == key:
                return d, d  # already a boundary
            left = RangeDescriptor(d.range_id, d.start_key, key, d.store_id,
                                   d.generation + 1)
            right = RangeDescriptor(self._next_id, key, d.end_key,
                                    d.store_id, 0)
            self._next_id += 1
            self._descs = (
                self._descs[:i] + [left, right] + self._descs[i + 1:]
            )
            metric.RANGE_SPLITS.inc()
            log.info(log.OPS, "range split", at=key.decode(errors="replace"),
                     left=left.range_id, right=right.range_id)
            return left, right

    def merge_at(self, key: bytes) -> RangeDescriptor | None:
        """AdminMerge reduction: remove the boundary at `key` — the range
        starting at key is absorbed into its left neighbor, which keeps
        its range id (generation bumped so caches notice the wider
        bounds). Metadata-only, so both sides must already be colocated.
        Idempotent: no descriptor starts at key -> None (a crashed retry
        already merged)."""
        if not key:
            raise ValueError("cannot merge at the minimum key")
        with self._lock:
            starts = [d.start_key for d in self._descs]
            i = bisect.bisect_left(starts, key)
            if i == 0 or i >= len(self._descs) or starts[i] != key:
                return None  # boundary already gone
            left, right = self._descs[i - 1], self._descs[i]
            if left.store_id != right.store_id:
                raise ValueError(
                    f"merge at {key!r}: r{left.range_id}@s{left.store_id} "
                    f"and r{right.range_id}@s{right.store_id} not colocated"
                )
            merged = RangeDescriptor(left.range_id, left.start_key,
                                     right.end_key, left.store_id,
                                     left.generation + 1)
            self._descs = self._descs[:i - 1] + [merged] + self._descs[i + 1:]
            metric.RANGE_MERGES.inc()
            log.info(log.OPS, "range merged",
                     at=key.decode(errors="replace"),
                     keep=merged.range_id, gone=right.range_id)
            return merged

    def reassign(self, range_id: int, to_store: int) -> RangeDescriptor:
        with self._lock:
            for i, d in enumerate(self._descs):
                if d.range_id == range_id:
                    nd = RangeDescriptor(d.range_id, d.start_key, d.end_key,
                                         to_store, d.generation + 1)
                    self._descs = (
                        self._descs[:i] + [nd] + self._descs[i + 1:]
                    )
                    return nd
            raise KeyError(f"no range {range_id}")


class RangeCache:
    """Per-sender descriptor cache (kvclient/rangecache role): lookups hit
    the cache; a RangeKeyMismatch evicts the stale entry and refills from
    Meta. Deliberately NOT invalidated by Meta writes — staleness is
    detected at the store, exactly like the reference.

    Authoritative refills are single-flight (rangecache's
    singleflight.Group over lookup requests): when a split storm evicts a
    hot descriptor, the first miss becomes the lookup leader and every
    concurrent miss for the same key parks on its Event instead of
    stampeding the meta range; followers re-check the cache once the
    leader publishes."""

    def __init__(self, meta: Meta):
        self.meta = meta
        self._mu = locks.lock("kv.singleflight")
        self._by_start: dict[bytes, RangeDescriptor] = {}
        self._inflight: dict[bytes, threading.Event] = {}
        self.misses = 0
        self.evictions = 0
        self.coalesced = 0

    def _cached_locked(self, key: bytes) -> RangeDescriptor | None:
        for d in self._by_start.values():
            if d.contains(key):
                return d
        return None

    def lookup(self, key: bytes) -> RangeDescriptor:
        while True:
            with self._mu:
                d = self._cached_locked(key)
                if d is not None:
                    return d
                ev = self._inflight.get(key)
                if ev is None:
                    ev = self._inflight[key] = threading.Event()
                    leader = True
                else:
                    leader = False
            if not leader:
                self.coalesced += 1
                metric.RANGE_CACHE_COALESCED.inc()
                ev.wait(timeout=5.0)
                continue  # re-check cache; leader failure -> become leader
            try:
                self.misses += 1
                d = self.meta.lookup(key)
                with self._mu:
                    self._by_start[d.start_key] = d
                return d
            finally:
                with self._mu:
                    self._inflight.pop(key, None)
                ev.set()

    def insert(self, d: RangeDescriptor) -> None:
        """Install a descriptor learned out-of-band (a store's
        RangeKeyMismatch repair carries the current one)."""
        with self._mu:
            self._by_start[d.start_key] = d

    def evict(self, d: RangeDescriptor) -> None:
        from ..utils import metric

        with self._mu:
            self.evictions += 1
            metric.RANGE_CACHE_EVICTIONS.inc()
            self._by_start.pop(d.start_key, None)


class Store:
    """One Engine + ownership verification (Store.Send's bounds check)."""

    def __init__(self, store_id: int, meta: Meta, **engine_kw):
        self.store_id = store_id
        self.meta = meta
        self.engine = Engine(**engine_kw)

    def check(self, desc: RangeDescriptor, start: bytes,
              end: bytes | None) -> RangeDescriptor:
        """Verify this store currently owns `desc`'s range and the span
        [start, end) (or point [start]) lies within it. Returns the
        CURRENT descriptor — like the reference's RangeKeyMismatchError
        carrying fresher descriptors, so the sender can repair its cache
        even when a narrowed range still answers the request."""
        cur = self.meta.lookup(start)
        if cur.store_id != self.store_id or cur.range_id != desc.range_id:
            raise RangeKeyMismatchError(
                f"store {self.store_id} does not own r{desc.range_id} "
                f"for key {start!r} (now r{cur.range_id}@s{cur.store_id})"
            )
        hi = end if end is not None else start
        if cur.end_key is not None and hi is not None and (
            hi > cur.end_key or (end is None and start >= cur.end_key)
        ):
            raise RangeKeyMismatchError(
                f"span [{start!r}, {end!r}) exceeds r{cur.range_id} "
                f"bounds [{cur.start_key!r}, {cur.end_key!r})"
            )
        return cur


def _sender_locked(fn):
    """Serialize a DistSender request under the sender mutex — restores the
    whole-keyspace atomicity the single-Engine @_locked surface provides
    (Txn.commit's refresh+resolve section and move_range's export->clear
    window must exclude concurrent writes on EVERY store)."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *a, **kw):
        with self.mu:
            return fn(self, *a, **kw)
    return wrapper


def _b(x) -> bytes:
    return x.encode() if isinstance(x, str) else bytes(x)


class DistSender:
    """Routes Engine-surface requests by range. Implements everything
    kv.DB/kv.Txn consume from an Engine, so it substitutes transparently.

    Concurrency: one reentrant mutex spanning all stores (`mu`) — the
    same latch reduction Engine.mu provides single-store. Individual
    engines keep their own mutexes for direct access."""

    def __init__(self, stores: list[Store], meta: Meta, lease_check=None,
                 load=None):
        assert stores, "need at least one store"
        self.meta = meta
        self.stores = {s.store_id: s for s in stores}
        self.cache = RangeCache(meta)
        self.mu = locks.rlock("kv.distsender")
        first = stores[0].engine
        self.key_width = first.key_width
        self.val_width = first.val_width
        # lease_check(range_id) raises NotLeaseHolderError/EpochFencedError
        # when this process may not serve the range — the (holder, epoch)
        # guard applied to EVERY routed piece, so range-addressed stamping
        # survives an auto-split mid-batch (ROADMAP open item)
        self.lease_check = lease_check
        # RangeLoadStats sampled on the routing path (split.Decider feed)
        self.load = load

    def _record_read(self, d, key: bytes) -> None:
        # system keyspace (\x01: liveness/lease/tsdb records) never feeds
        # the split decider — bookkeeping traffic must not look hot
        if self.load is not None and not key.startswith(b"\x01"):
            self.load.record_read(d.range_id, key)

    def _record_write(self, d, key: bytes, nbytes: int) -> None:
        if self.load is not None and not key.startswith(b"\x01"):
            self.load.record_write(d.range_id, key, nbytes)

    # -- routing core --------------------------------------------------------

    def _route_point(self, key: bytes):
        """(store, descriptor) for one key, retrying past stale cache.
        The returned descriptor is the store's CURRENT one — a cached
        entry that routed correctly but had stale bounds (a split kept
        this half in place) is repaired in the cache on the way out."""
        for _ in range(4):
            d = self.cache.lookup(key)
            store = self.stores[d.store_id]
            try:
                cur = store.check(d, key, None)
            except RangeKeyMismatchError:
                # retry accounting is per-RANGE, not per-client: one hot
                # range's churn shows up in its own counter
                metric.RPC_RETRIES_BY_RANGE.inc(d.range_id)
                self.cache.evict(d)
                continue
            if cur.generation != d.generation or cur.end_key != d.end_key:
                self.cache.evict(d)
                self.cache.insert(cur)
            if self.lease_check is not None:
                self.lease_check(cur.range_id)
            return store, cur
        # cache kept going stale (concurrent splits): go authoritative
        d = self.meta.lookup(key)
        if self.lease_check is not None:
            self.lease_check(d.range_id)
        return self.stores[d.store_id], d

    def _route_span(self, start: bytes | None, end: bytes | None):
        """Split [start, end) into per-range pieces (DistSender's batch
        truncation, dist_sender.go:1191): yields (store, piece_start,
        piece_end) in key order."""
        cursor = start if start is not None else b""
        while True:
            store, d = self._route_point(cursor)
            self._record_read(d, cursor)
            piece_end = d.end_key
            if end is not None and (piece_end is None or end <= piece_end):
                yield store, cursor, end
                return
            if piece_end is None:
                yield store, cursor, end
                return
            yield store, cursor, piece_end
            cursor = piece_end

    # -- Engine surface ------------------------------------------------------

    @_sender_locked
    def put(self, key, value, ts: int, txn: int = 0):
        k = _b(key)
        store, d = self._route_point(k)
        self._record_write(d, k, len(_b(value)))
        return store.engine.put(k, value, ts=ts, txn=txn)

    @_sender_locked
    def delete(self, key, ts: int, txn: int = 0):
        k = _b(key)
        store, d = self._route_point(k)
        self._record_write(d, k, 0)
        return store.engine.delete(k, ts=ts, txn=txn)

    @_sender_locked
    def get(self, key, ts: int, txn: int = 0):
        k = _b(key)
        store, d = self._route_point(k)
        self._record_read(d, k)
        return store.engine.get(k, ts=ts, txn=txn)

    @_sender_locked
    def apply_rpc_batch(self, cid: str, seq: int, muts, resp,
                        sync: bool = True) -> None:
        """Stamped-batch surface for the cross-session coalescer
        (kv/coalesce.py): truncate the train by range — DistSender's
        batch truncation applied to a mutation batch — and apply one
        range-addressed stamped sub-batch per range, so the atomic
        WAL-record + dedup discipline survives splits (a replay after a
        split dedups against the range that actually applied it).
        ``sync=False`` defers every store's WAL fsync to wal_sync()."""
        by_range: dict[int, list] = {}
        stores: dict[int, Store] = {}
        for m in muts:
            k = m[0]
            store, d = self._route_point(k)
            self._record_write(d, k, len(m[1]))
            by_range.setdefault(d.range_id, []).append(m)
            stores[d.range_id] = store
        for rid, ms in by_range.items():
            sub = {"ts": [m[2] for m in ms]}
            stores[rid].engine.apply_rpc_batch(f"{cid}.r{rid}", seq, ms,
                                               sub, sync=sync)

    @_sender_locked
    def replay_cache_get(self, cid: str, seq: int, n_ops: int):
        """BatchServer's dedup read (kv/rpc.py) over a cluster. A stamped
        batch of ``n_ops`` ops lands as one stamped sub-batch per range
        (``apply_rpc_batch``), each in its own store's WAL, so a crash or
        a WAL fault between two stores can leave it applied in some
        ranges only. Each range id the Meta has issued is looked up by
        key in each store (the range may have moved or merged since).
        The batch is applied when the entries found hold a timestamp for
        each of its ops: the response lists them in request order, which
        the clock made increasing. Found in part, the batch is neither
        applied nor not, and AmbiguousResultError says so: applying again
        would write the found ranges twice, answering would acknowledge
        writes that were never made. The reference's DistSender has no
        such method, so its BatchServer over a cluster fails every
        stamped batch."""
        from .rpc import AmbiguousResultError

        ts: list[int] = []
        for s in self.stores.values():
            for rid in self.meta.issued_ids():
                got = s.engine.replay_cache_get(f"{cid}.r{rid}", seq)
                if got is not None:
                    ts.extend(got["ts"])
        if not ts:
            return None
        if len(ts) != n_ops:
            raise AmbiguousResultError(
                f"stamped batch (cid={cid}, seq={seq}) applied in part: "
                f"{len(ts)} of its {n_ops} ops found", cid=cid, seq=seq)
        return {"responses": [{"ts": t} for t in sorted(ts)]}

    def wal_sync(self) -> None:
        """Sync every store's WAL (the coalescer cannot know which ranges
        a train touched once apply returns; syncing an untouched store's
        WAL is a no-op fsync). Unlocked like Engine.wal_sync."""
        for s in self.stores.values():
            s.engine.wal_sync()

    @_sender_locked
    def scan(self, start, end, ts: int, txn: int = 0, max_keys=None):
        out: list[tuple[bytes, bytes]] = []
        s = _b(start) if start is not None else None
        e = _b(end) if end is not None else None
        for store, ps, pe in self._route_span(s, e):
            left = None if max_keys is None else max_keys - len(out)
            if left is not None and left <= 0:
                break
            out.extend(store.engine.scan(ps, pe, ts=ts, txn=txn,
                                         max_keys=left))
        return out

    @_sender_locked
    def scan_batch(self, starts, ts: int, txn: int = 0, max_keys: int = 64):
        """Batched scans grouped BY STORE so each store runs one device
        pass (the Streamer's per-range request grouping,
        kvstreamer/streamer.go:517). Results reassemble in request order;
        a scan whose window crosses its range's end is truncated at the
        boundary and continued on the next range host-side."""
        encs = [_b(s) for s in starts]
        by_store: dict[int, list[int]] = {}
        descs = []
        for i, k in enumerate(encs):
            store, d = self._route_point(k)
            self._record_read(d, k)
            by_store.setdefault(store.store_id, []).append(i)
            descs.append(d)
        results: list[list[tuple[bytes, bytes]]] = [None] * len(encs)
        for sid, idxs in by_store.items():
            eng = self.stores[sid].engine
            got = eng.scan_batch([encs[i] for i in idxs], ts=ts, txn=txn,
                                 max_keys=max_keys)
            for i, rows in zip(idxs, got):
                d = descs[i]
                if d.end_key is not None:
                    rows = [(k, v) for k, v in rows if k < d.end_key]
                results[i] = rows
        # continue truncated scans past their range boundary (self.scan
        # walks ALL remaining ranges, so one continuation suffices)
        for i, rows in enumerate(results):
            d = descs[i]
            if d.end_key is not None and len(rows) < max_keys:
                rows = rows + self.scan(d.end_key, None, ts=ts, txn=txn,
                                        max_keys=max_keys - len(rows))
            results[i] = rows[:max_keys]
        return results

    @_sender_locked
    def ingest(self, keys: np.ndarray, values: np.ndarray, ts: int,
               vlens=None, seq=None) -> None:
        """Bulk ingest split by range boundary (AddSSTable routing). One
        meta snapshot + one vectorized searchsorted routes the whole batch
        — never a per-key routing round trip. Per-row vlens split with
        the same selection; an explicit seq only makes sense against one
        store's sequence space and is rejected on a split keyspace."""
        n = len(keys)
        if n == 0:
            return
        descs = self.meta.snapshot()  # sorted by start_key, tiles keyspace
        ka = np.asarray(keys)
        if len(descs) == 1:
            if self.lease_check is not None:
                self.lease_check(descs[0].range_id)
            self.stores[descs[0].store_id].engine.ingest(
                ka, np.asarray(values), ts, vlens=vlens, seq=seq)
            return
        if seq is not None:
            raise ValueError(
                "explicit ingest seq is per-store; unsupported on a "
                "split keyspace"
            )
        width = ka.shape[1]
        starts = np.zeros((len(descs), width), np.uint8)
        for i, d in enumerate(descs):
            s = d.start_key[:width]
            starts[i, :len(s)] = np.frombuffer(s, np.uint8)
        kv = np.ascontiguousarray(ka).view(f"V{width}").reshape(-1)
        sv = np.ascontiguousarray(starts).view(f"V{width}").reshape(-1)
        piece_of = np.searchsorted(sv, kv, side="right") - 1
        va = np.asarray(values)
        vl = None if vlens is None else np.asarray(vlens)
        for di in np.unique(piece_of):
            sel = piece_of == di
            if self.lease_check is not None:
                self.lease_check(descs[int(di)].range_id)
            self.stores[descs[int(di)].store_id].engine.ingest(
                ka[sel], va[sel], ts,
                vlens=None if vl is None else vl[sel],
            )

    # engine-wide ops forward to every store
    @_sender_locked
    def resolve_intents(self, txn: int, commit_ts: int, commit: bool):
        for s in self.stores.values():
            s.engine.resolve_intents(txn, commit_ts, commit)

    @_sender_locked
    def has_committed_writes_in(self, start, end, ts_lo, ts_hi,
                                point: bool = False) -> bool:
        if point:
            store, _ = self._route_point(_b(start) if start else b"")
            return store.engine.has_committed_writes_in(
                start, end, ts_lo, ts_hi, point=True)
        # span refresh — open-ended spans (end=None) walk EVERY range the
        # span covers; routing them as a point would skip all other stores
        # and let an invalidated read commit
        for store, ps, pe in self._route_span(
            _b(start) if start is not None else None,
            _b(end) if end is not None else None,
        ):
            if store.engine.has_committed_writes_in(ps, pe, ts_lo, ts_hi):
                return True
        return False

    @_sender_locked
    def other_intent(self, key: bytes, txn: int):
        store, _ = self._route_point(_b(key))
        return store.engine.other_intent(key, txn)

    @_sender_locked
    def newest_committed_ts(self, key: bytes) -> int:
        store, _ = self._route_point(_b(key))
        return store.engine.newest_committed_ts(key)

    @_sender_locked
    def intent_keys(self, txn: int) -> list[bytes]:
        out: list[bytes] = []
        for s in self.stores.values():
            out.extend(s.engine.intent_keys(txn))
        return sorted(out)

    @property
    def device(self):
        """The one device every store's engine sits on (the SQL layer,
        the changefeed and the views read ``db.engine.device``)."""
        devs = {s.engine.device for s in self.stores.values()}
        if len(devs) != 1:
            raise ValueError(f"stores on several devices: {sorted(map(str, devs))}")
        return devs.pop()

    # -- columnar read surface (SQL fast path) -------------------------------

    @property
    def _seq(self):
        """Hashable write-sequence fingerprint across stores — KVTable's
        per-engine caches key on (engine._seq, engine._gen)."""
        return tuple(s.engine._seq for s in self.stores.values())

    @property
    def _gen(self):
        return tuple(s.engine._gen for s in self.stores.values())

    @_sender_locked
    def _merged_view(self):
        """One sorted device view over EVERY store — the cross-range
        columnar scan (KVTable.device_batch reads this exactly like a
        single engine's merged view). Cached per store-generation vector;
        stores' own caches make the per-store halves incremental."""
        from ..storage import mvcc
        from ..storage.lsm import _pad

        key = (self._seq, self._gen)
        cached = getattr(self, "_view_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        views = []
        for s in self.stores.values():
            with s.engine.mu:
                v = s.engine._merged_view()  # overlays memtable, cached
            if v is not None:
                views.append(v)
        if not views:
            view = None
        elif len(views) == 1:
            view = views[0]
        else:
            total = sum(v.capacity for v in views)
            view = mvcc.merge_blocks(tuple(views), cap=_pad(total))
        self._view_cache = (key, view)
        return view

    @_sender_locked
    def flush(self):
        for s in self.stores.values():
            s.engine.flush()

    @_sender_locked
    def compact(self, bottom: bool = True):
        for s in self.stores.values():
            s.engine.compact(bottom=bottom)

    @_sender_locked
    def checkpoint(self, path: str):
        """Checkpoint every store into a per-store subdirectory (the jobs
        framework's backup resumer calls db.engine.checkpoint)."""
        import os

        for sid, s in self.stores.items():
            s.engine.checkpoint(os.path.join(path, f"store{sid}"))

    # -- admin ---------------------------------------------------------------

    def split_at(self, key) -> None:
        self.meta.split_at(_b(key))

    def move_range(self, range_id: int, to_store: int) -> int:
        """Relocate a range's data: scan every version in-span from the
        old store, ingest into the new one, clear the old span, then flip
        the descriptor. The snapshot-rebalance reduction (the reference
        streams a raft snapshot then deletes the old replica). Runs under
        the sender mutex: a metadata flip mid-copy would lose writes."""
        with self.mu:
            src_desc = None
            for d in self.meta.snapshot():
                if d.range_id == range_id:
                    src_desc = d
                    break
            if src_desc is None:
                raise KeyError(f"no range {range_id}")
            if src_desc.store_id == to_store:
                return 0
            src = self.stores[src_desc.store_id].engine
            dst = self.stores[to_store].engine
            moved = src.export_span(src_desc.start_key, src_desc.end_key)
            dst.import_rows(moved)
            src.clear_span(src_desc.start_key, src_desc.end_key)
            self.meta.reassign(range_id, to_store)
            metric.RANGE_MOVES.inc()
            n = len(moved["ts"]) if moved else 0
            log.info(log.OPS, "range moved", range=range_id,
                     to_store=to_store, rows=n)
            return n


def open_cluster_checkpoint(path: str, descriptors,
                            device="cuda") -> DistSender:
    """Open a ``DistSender.checkpoint`` directory into a new cluster on
    ``device``: one Store per ``store<id>`` subdirectory, each engine
    opened from its checkpoint (``Engine.open_checkpoint``), and a Meta
    holding ``descriptors`` — plain ``(range_id, start_key, end_key,
    store_id, generation)`` tuples in key order, tiling the keyspace (a
    ``Meta.snapshot()`` of the checkpointed cluster)."""
    import os

    descs = [RangeDescriptor(int(r), bytes(s), None if e is None
                             else bytes(e), int(sid), int(g))
             for r, s, e, sid, g in descriptors]
    if not descs or descs[0].start_key != b"" or descs[-1].end_key \
            is not None or any(a.end_key != b.start_key
                               for a, b in zip(descs, descs[1:])):
        raise ValueError("descriptors must tile the keyspace in key order")
    meta = Meta(first_store=descs[0].store_id)
    meta._descs = descs
    meta._next_id = max(d.range_id for d in descs) + 1
    store_ids = sorted(int(n[len("store"):]) for n in os.listdir(path)
                       if n.startswith("store") and n[len("store"):].isdigit())
    missing = {d.store_id for d in descs} - set(store_ids)
    if missing:
        raise ValueError(f"no checkpoint for stores {sorted(missing)}")
    stores = []
    for sid in store_ids:
        st = Store.__new__(Store)
        st.store_id = sid
        st.meta = meta
        st.engine = Engine.open_checkpoint(
            os.path.join(path, f"store{sid}"), device=device)
        stores.append(st)
    return DistSender(stores, meta)


def make_cluster(n_stores: int, device="cuda", wal_dir: str | None = None,
                 **engine_kw) -> DistSender:
    """``n_stores`` stores (store ids 1..n, one ``Engine`` each on
    ``device``; with ``wal_dir``, each logs to ``s<id>.wal`` there) over
    one Meta whose single range starts on store 1."""
    resolve_device(device)
    meta = Meta(first_store=1)
    stores = [Store(i + 1, meta, device=device,
                    wal_path=(None if wal_dir is None
                              else f"{wal_dir}/s{i + 1}.wal"), **engine_kw)
              for i in range(n_stores)]
    return DistSender(stores, meta)


def spread(ds: DistSender, bounds: list[bytes]) -> list[int]:
    """Split the keyspace at ``bounds`` and move the i-th range onto
    store i + 1 (wrapping over the stores). Returns the rows each move
    carried."""
    for b in bounds:
        ds.split_at(b)
    ids = sorted(ds.stores)
    return [ds.move_range(d.range_id, ids[i % len(ids)])
            for i, d in enumerate(ds.meta.snapshot())]


class LeaseRouter:
    """Leaseholder-aware RPC routing (the networked half of DistSender's
    per-range transport, dist_sender.go's sendToReplicas + the
    NotLeaseHolderError redirect loop).

    Resolves a range's current leaseholder from gossip (`lease/<rid>`
    infos the lease loop publishes), dials it through the NodeDialer,
    and sends the batch range-addressed so the server's lease guard
    fences stale holders. Reroute triggers — EpochFencedError /
    NotLeaseHolderError (failover finished; re-resolve), transport
    errors on read batches (reads are idempotent), breaker fast-fails —
    spend the per-RANGE retry budget; when it runs dry the caller gets
    RetryBudgetExhausted and must degrade. AmbiguousResultError
    propagates untouched: re-sending a mutation under a fresh stamp is
    the double apply the stamps exist to prevent."""

    def __init__(self, gossip, dialer, budget=None,
                 resolve_timeout_s: float = 5.0):
        from ..utils import retry

        self.gossip = gossip
        self.dialer = dialer
        self.budget = budget if budget is not None \
            else retry.RangeRetryBudget()
        self.resolve_timeout_s = resolve_timeout_s

    def leaseholder(self, range_id: int) -> int | None:
        """Gossip's view of the range's holder node id (None = unknown)."""
        v = self.gossip.get_info(f"lease/{range_id}")
        if v is None:
            return None
        nid, _, _epoch = str(v).partition(":")
        try:
            return int(nid)
        except ValueError:
            return None

    def batch(self, range_id: int, requests: list[dict]) -> list[dict]:
        import time as _time

        from ..kv.liveness import EpochFencedError, NotLeaseHolderError
        from ..kv.rpc import AmbiguousResultError
        from .dialer import BreakerOpenError

        deadline = _time.monotonic() + self.resolve_timeout_s
        hint: int | None = None
        last: Exception = KeyError(
            f"no leaseholder known for r{range_id}")
        while True:
            nid = hint if hint is not None else self.leaseholder(range_id)
            hint = None
            if nid is not None:
                try:
                    client = self.dialer.dial(nid)
                    out = client.batch(requests, range_id=range_id)
                    self.dialer.report_ok(nid)
                    return out
                except AmbiguousResultError:
                    raise  # typed ambiguity: never silently re-sent
                except NotLeaseHolderError as e:
                    last = e
                    hint = e.holder  # redirect straight to the holder
                except EpochFencedError as e:
                    last = e  # stale route: wait out the failover
                except BreakerOpenError as e:
                    last = e
                except (ConnectionError, OSError) as e:
                    self.dialer.report_failure(nid)
                    last = e
            # a reroute costs one per-range retry token
            # (RetryBudgetExhausted propagates: budget dry = degrade)
            self.budget.spend(range_id)
            if _time.monotonic() > deadline:
                raise last
            _time.sleep(0.05)  # let gossip/failover converge
