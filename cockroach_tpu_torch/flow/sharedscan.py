"""Shared tile streams — concurrent scans of one table ride one cursor.

When several sessions run reporting queries over the same resident
table, each session's ScanOp slices the SAME device buffer into the SAME
tiles. This module lets concurrent resident scans attach to a
per-(table, columns, tile) shared stream: whichever subscriber needs a
tile first produces it, every other subscriber consumes the buffered
result (``sql_shared_scan_dispatches_saved``). A resident tile here is a
view of the table's device buffer (``operators._tile_view``), so a
shared tile saves the view's construction, not a kernel launch; the
fused path slices inside its graph and never comes here.

Design — produce-on-demand, never block. A subscriber asking for tile
``i`` either (a) finds it in the stream's bounded buffer window
(``sql.distsql.sharedscan.window`` tiles) and takes it, (b) finds the
window already trimmed past ``i`` — it fell behind — and slices that
tile solo (catch-up; the stream never waits for laggards and never
holds tiles for them), or (c) produces it into the window for everyone
behind it. No subscriber ever parks on another's progress, so the
stream cannot deadlock and a slow consumer degrades only itself.

Which batches may share:

- a host table's batch is the catalog's device cache: attach joins a
  stream only when the subscriber's batch is the SAME tensors (column
  data, valid bitmaps and mask all ``is``-identical) as the stream's;
- a KV table decodes into buffers the table owns, at one address per
  column (``KVTable.device_batch(persistent=True)``), so identity proves
  nothing: two decodes at different snapshots give identical tensors.
  Attach compares snapshot tokens instead (the token bracketing the
  decode, ``KVTable.decoded_snap``), and a stream whose buffers a later
  decode at another snapshot overwrote is stale: it hands out no tile
  after that (its subscribers slice their own), and the next attach
  retires it from the registry.

Chaos site ``flow.sharedscan.attach``: an injected fault at attach
degrades that scan to slicing its own tiles — identical results, the
saving lost. Buffered tiles are charged to the ``flow.sharedscan``
staging account; each subscriber carries its attach-time mask bytes
until detach.
"""

from __future__ import annotations

from ..utils import faults, locks, metric, racesan, settings
from . import memory as flowmem

__all__ = ["attach", "detach", "reset", "SharedStream"]


def _same_batch(a, b) -> bool:
    """True when two Batch views are the SAME device tensors (catalog
    device-cache hits), so slicing either yields bit-identical tiles."""
    if a is b:
        return True
    if a.capacity != b.capacity or len(a.cols) != len(b.cols):
        return False
    if a.mask is not b.mask:
        return False
    return all(ca.data is cb.data and ca.valid is cb.valid
               for ca, cb in zip(a.cols, b.cols))


class SharedStream:
    """One shared cursor over one resident table's tile sequence."""

    def __init__(self, key, batch, res_tile: int, slice_fn, snap=None,
                 table=None):
        self.key = key
        self.batch = batch
        # snapshot token of the decode that produced `batch` (KV tables
        # only; None for a host table): equal tokens mean a later decode
        # is bit-identical, so a subscriber may adopt ours
        self.snap = snap
        self.table = table
        self.res_tile = int(res_tile)
        self.n_tiles = batch.capacity // self.res_tile
        self.slice_fn = slice_fn
        self.mu = locks.lock("flow.sharedscan")
        # bounded tile window: idx -> (tile, producer). Trimmed from the
        # bottom; an idx below `base` is gone for good (solo catch-up).
        self._tiles: dict[int, tuple] = {}
        self.base = 0
        self.stale = False
        # attached subscribers (ScanOp identity -> bytes charged at
        # attach). racesan-annotated: attach/detach from different
        # sessions meet here.
        self._subs: dict[int, int] = {}
        self._staging = flowmem.staging_monitor("flow.sharedscan")

    def overwritten(self) -> bool:
        """True when a KV table's buffers no longer hold this stream's
        snapshot: a persistent decode at another snapshot rewrote them."""
        if self.snap is None:
            return False
        return getattr(self.table, "decoded_snap", None) != self.snap

    # caller holds _reg_mu for attach/detach bookkeeping --------------------

    def _attach(self, op) -> None:
        # a subscriber's standing cost is its view of the liveness mask
        # (one byte a row)
        n = int(self.batch.capacity)
        self._staging.reserve(n, force=True)
        with self.mu:
            racesan.note_write(self, "_subs")
            self._subs[id(op)] = n

    def _detach(self, op) -> bool:
        """Drop one subscriber; True when the stream is now empty."""
        with self.mu:
            racesan.note_write(self, "_subs")
            n = self._subs.pop(id(op), 0)
        if n:
            self._staging.release(n)
        with self.mu:
            racesan.note_read(self, "_subs")
            return not self._subs

    def _close(self) -> None:
        with self.mu:
            dropped = [t for t, _ in self._tiles.values()]
            self._tiles.clear()
        for t in dropped:
            self._staging.release(flowmem.batch_bytes(t))

    def next_tile(self, op, idx: int):
        """('tile', batch) — shared tile for idx; ('solo', None) — the
        window moved past idx, or the stream went stale: the caller
        slices its own tile."""
        window = settings.get("sql.distsql.sharedscan.window")
        dropped = []
        with self.mu:
            if not self.stale and self.overwritten():
                self.stale = True
            if self.stale:
                dropped = [t for t, _ in self._tiles.values()]
                self._tiles.clear()
                out = ("solo", None)
            elif idx < self.base:
                out = ("solo", None)
            else:
                ent = self._tiles.get(idx)
                if ent is None:
                    t = self.slice_fn(self.batch, idx * self.res_tile)
                    self._tiles[idx] = ent = (t, id(op))
                    self._staging.reserve(flowmem.batch_bytes(t),
                                          force=True)
                    while len(self._tiles) > window:
                        m = min(self._tiles)
                        old, _ = self._tiles.pop(m)
                        self.base = max(self.base, m + 1)
                        self._staging.release(flowmem.batch_bytes(old))
                t, producer = ent
                if producer != id(op):
                    # this tile was someone else's; we ride for free
                    metric.SQL_SHARED_SCAN_DISPATCHES_SAVED.inc()
                out = ("tile", t)
        for t in dropped:
            self._staging.release(flowmem.batch_bytes(t))
        return out


# stream registry: (table id, columns, tile) -> live SharedStream.
# Guarded by one control-plane lock; streams die with their last
# subscriber (or retire when stale), so the registry only ever holds
# streams someone is reading.
_reg_mu = locks.lock("flow.sharedscan.registry")
_streams: dict[tuple, SharedStream] = {}


def reset() -> None:
    """Drop all streams (test isolation)."""
    with _reg_mu:
        for s in _streams.values():
            s._close()
        _streams.clear()


def attach(op) -> SharedStream | None:
    """Attach a resident tiled ScanOp to the shared stream for its
    (table, columns, tile) — or None for solo: sharding, a batch that
    is not the stream's (another snapshot, not the device cache's
    tensors), or an injected attach fault."""
    if not settings.get("sql.distsql.sharedscan.enabled"):
        return None
    if op.shard is not None or op.streaming:
        return None
    try:
        # chaos site: attach failure degrades to slicing our own tiles
        faults.fire("flow.sharedscan.attach")
    except faults.InjectedFault:
        return None
    kv = op._persistent
    snap = op._snap
    if kv and snap is None:
        return None  # a write landed mid-decode: no token to share by
    key = (id(op.table), tuple(op.output_schema.names), op._res_tile)
    with _reg_mu:
        s = _streams.get(key)
        if s is not None and s.overwritten():
            # our own decode rewrote the buffers this stream slices:
            # retire it (its subscribers fall back to their own tiles)
            s.stale = True
            del _streams[key]
            s._close()
            s = None
        if s is not None:
            if kv:
                if snap != s.snap or s.batch.capacity != op._batch.capacity:
                    return None  # different snapshot: run solo
                # equal tokens: the decodes are bit-identical
                op._batch = s.batch
            elif not _same_batch(s.batch, op._batch):
                return None
            s._attach(op)
            metric.SQL_SHARED_SCAN_ATTACHED.inc()
            return s
        s = SharedStream(key, op._batch, op._res_tile, op._slice,
                         snap=snap if kv else None,
                         table=op.table if kv else None)
        s._attach(op)
        _streams[key] = s
        return s


def detach(op, stream: SharedStream | None) -> None:
    if stream is None:
        return
    with _reg_mu:
        if stream._detach(op) and _streams.get(stream.key) is stream:
            del _streams[stream.key]
            stream._close()
