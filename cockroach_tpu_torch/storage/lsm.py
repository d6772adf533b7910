"""LSM storage engine — the Pebble-wrapper analog (counterpart of
``cockroach_tpu.storage.lsm``), over sorted runs held as torch tensors on
the engine's device.

- writes append to an on-disk WAL and a host memtable;
- ``flush`` sorts the memtable into an immutable run (an "SST");
- past ``l0_trigger`` runs, a size-tiered compaction merges the smallest
  runs (the merge-path kernel when eligible, else concat + sort) and
  applies the MVCC GC filter; ``compact(bottom=True)`` merges everything;
- reads never mutate the run set: bounded reads gather the in-range rows
  of each source into small candidate tiles and merge those; batched
  scans seek each source, gather per-scan windows, merge them window-
  locally and run the scan-filter kernel over them.

The WAL format is the reference's, byte for byte (``_WAL_MAGIC``,
``_WAL_REC``, every record kind, the ``.ingest*.npz`` and ``.import*.npz``
side files), and so is the checkpoint directory (``run%04d.npz``,
``blob.bin``, ``replay_cache.json``, ``MANIFEST``): either package opens
the other's store.
"""

from __future__ import annotations

import base64
import dataclasses
import functools
import glob
import json
import os
import struct
import time
import zipfile
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..utils import locks
from . import blockcache
from . import keys as K
from . import mvcc

_RUN_ALIGN = 1024
_CAND_ALIGN = 128  # candidate tiles for bounded reads start smaller

_WAL_MAGIC = b"CTWL"
# kind, ts, seq, txn, tomb/commit, klen, vlen
_WAL_REC = struct.Struct("<BqqqBHH")
_REC_WRITE = 0
_REC_RESOLVE = 1
# ingest records name the side file of a durably written run in the key
# field (AddSSTable's link-don't-copy durability)
_REC_INGEST = 2
# import records name a side file of full per-row MVCC fields (the
# snapshot-apply half of a range relocation); clear records carry the
# cleared span's [start, end) in key/value (flag False: open-ended end)
_REC_IMPORT = 3
_REC_CLEAR = 4
# batch records carry a whole stamped RPC mutation batch (ops, the
# (client id, sequence) dedup token and the wire response) in one record,
# so a crash keeps both the ops and the replay-cache entry or neither
_REC_BATCH = 5

_SIDE_ERRORS = (FileNotFoundError, ValueError, OSError, KeyError, EOFError,
                zipfile.BadZipFile)


def _words_to_bytes(words) -> bytes:
    """Packed big-endian uint64 key words -> the zero-padded key bytes."""
    return b"".join(int(w).to_bytes(8, "big") for w in np.asarray(words))


def _pad(n: int, align: int = _RUN_ALIGN) -> int:
    """Next power-of-2 capacity >= n (min `align`)."""
    p = align
    while p < n:
        p *= 2
    return p


def _charge_run(run: mvcc.KVBlock) -> None:
    """Run residency is charged until the run is garbage-collected."""
    from ..flow import memory as flowmem

    flowmem.charge_object("storage/run-residency", run, run.nbytes())


def _shrink(block: mvcc.KVBlock) -> mvcc.KVBlock:
    """Slice a sorted block (dead rows last) down to a power-of-2 capacity
    covering its live rows."""
    live = int(block.mask.sum())
    cap = _pad(live)
    if cap >= block.capacity:
        return block
    return block.map(lambda x: x[:cap])


def _range_mask(block: mvcc.KVBlock, sw, ew):
    """In-range liveness mask and its count."""
    words = K.key_words(block.key)
    m = block.mask & K.words_in_range(words, sw, ew)
    return m, int(m.sum())


def _slice_window(block: mvcc.KVBlock, pos: int, size: int) -> mvcc.KVBlock:
    """[pos, pos+size) window of a run — the iterator-seek read."""
    p = min(max(pos, 0), max(0, block.capacity - size))
    return block.map(lambda x: x[p:p + size])


def _gather_rows(block: mvcc.KVBlock, m: torch.Tensor, cap: int
                 ) -> mvcc.KVBlock:
    """Compact the rows where `m` into a tile of `cap` (row order kept, so
    a sorted source yields a sorted candidate tile)."""
    idx = torch.nonzero(m).squeeze(1)
    n = idx.shape[0]

    def take(x):
        out = torch.zeros((cap,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        out[:n] = x[idx]
        return out

    return dataclasses.replace(
        block.map(take),
        mask=torch.arange(cap, device=block.device) < n)


class WriteIntentError(Exception):
    def __init__(self, keys: list[bytes], txns: list[int]):
        super().__init__(f"conflicting intents on {keys} (txns {txns})")
        self.keys = keys
        self.txns = txns


from ..utils.errors import register_passthrough as _rp  # noqa: E402

_rp(WriteIntentError)  # expected error: crosses the query boundary unwrapped


@dataclass
class MVCCStats:
    """Coarse engine stats (enginepb.MVCCStats analog)."""

    live_count: int = 0
    key_count: int = 0
    val_count: int = 0
    intent_count: int = 0
    runs: int = 0
    compactions: int = 0
    flushes: int = 0


@dataclass
class _Memtable:
    keys: list[bytes] = field(default_factory=list)
    ts: list[int] = field(default_factory=list)
    seq: list[int] = field(default_factory=list)
    txn: list[int] = field(default_factory=list)
    tomb: list[bool] = field(default_factory=list)
    value: list[bytes] = field(default_factory=list)  # inline slot bytes
    vlen: list[int] = field(default_factory=list)  # logical value length

    def __len__(self) -> int:
        return len(self.ts)


class _TsCache:
    """Newest committed write timestamp per key (the tscache role behind
    the WriteTooOld check): bulk ingests land as sorted numpy key batches
    (void dtype, memcmp order), single writes overlay a dict, lookups take
    max(overlay, binary search per batch); batches fold together once the
    list grows."""

    _MAX_BATCHES = 8

    def __init__(self, key_width: int):
        self.kw = key_width
        self.over: dict[bytes, int] = {}
        self.batches: list[tuple[np.ndarray, np.ndarray]] = []

    def _void(self, keys_u8: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(keys_u8).view(f"V{self.kw}").reshape(-1)

    def bulk(self, keys_u8: np.ndarray, ts) -> None:
        """[N, kw] uint8 keys committed at ts (scalar or [N] array)."""
        if len(keys_u8) == 0:
            return
        v = self._void(keys_u8)
        t = (np.full(len(v), int(ts), np.int64) if np.isscalar(ts)
             else np.asarray(ts, np.int64))
        order = np.argsort(v, kind="stable")
        self.batches.append((v[order], t[order]))
        if len(self.batches) > self._MAX_BATCHES:
            self._fold()

    def _fold(self) -> None:
        ks = np.concatenate([k for k, _ in self.batches])
        ts = np.concatenate([t for _, t in self.batches])
        order = np.argsort(ks, kind="stable")
        k, t = ks[order], ts[order]
        new = np.concatenate([[True], k[1:] != k[:-1]])
        gid = np.cumsum(new) - 1
        mx = np.zeros(int(gid[-1]) + 1, np.int64)
        np.maximum.at(mx, gid, t)
        self.batches = [(k[new], mx)]

    def get(self, b: bytes, _default: int = 0) -> int:
        t = self.over.get(b, 0)
        if self.batches and len(b) <= self.kw:
            q = np.frombuffer(b.ljust(self.kw, b"\x00"),
                              dtype=f"V{self.kw}")[0]
            for keys, ts in self.batches:
                i = int(np.searchsorted(keys, q))
                if i < len(keys) and keys[i] == q:
                    t = max(t, int(ts[i]))
        return t

    def put(self, b: bytes, ts: int) -> None:
        if ts > self.over.get(b, 0):
            self.over[b] = ts


def _locked(fn):
    """Serialize a public Engine method under the engine mutex."""
    @functools.wraps(fn)
    def wrapper(self, *a, **kw):
        with self.mu:
            return fn(self, *a, **kw)
    return wrapper


class Engine:
    """MVCC LSM engine over sorted runs on ``device`` (default ``"cuda"``;
    raises without a card unless ``device="cpu"``).

    With the default ``wal_fsync=False`` the WAL is written through the OS
    page cache only: acknowledged writes survive process crashes, not
    machine crashes. ``wal_fsync=True`` fsyncs every record."""

    def __init__(
        self,
        key_width: int = K.DEFAULT_KEY_WIDTH,
        val_width: int = 16,
        l0_trigger: int | None = None,
        memtable_size: int = 4096,
        gc_ts: int = 0,
        wal_path: str | None = None,
        wal_fsync: bool = False,
        compact_width: int = 4,
        device: str | torch.device = "cuda",
    ):
        if key_width % 8:
            raise ValueError("key_width must be a multiple of 8")
        self.device = resolve_device(device)
        self.mu = locks.rlock("storage.engine")
        from ..utils import settings
        from ..utils.admission import IOGovernor

        self.key_width = key_width
        self.val_width = val_width
        # DefaultPebbleOptions L0CompactionThreshold
        self.l0_trigger = (
            l0_trigger if l0_trigger is not None
            else settings.get("storage.l0_compaction_threshold")
        )
        self.memtable_size = memtable_size
        self.gc_ts = gc_ts
        self.compact_width = compact_width
        self.governor = IOGovernor(self)
        self.mem = _Memtable()
        self.runs: list[mvcc.KVBlock] = []  # sorted runs, newest first
        self.stats = MVCCStats()
        self._seq = 0  # global write sequence (newest-sequence-wins)
        # host lock table: key -> txn id holding an intent
        self._locks: dict[bytes, int] = {}
        self._newest_committed = _TsCache(key_width)
        self._gen = 0  # bumps whenever the run set changes
        # per-run read metadata (seek keys, bloom, block-cache token),
        # keyed by id with a strong run ref so ids can't be reused
        self._run_meta: dict[int, tuple[mvcc.KVBlock, blockcache.RunMeta]] = {}
        self._runs_view_cache: tuple[int, mvcc.KVBlock] | None = None
        self._scan_windows: dict[int, int] = {}  # max_keys -> window
        self._mem_cache: tuple[int, mvcc.KVBlock] | None = None
        self._overlay_cache = None  # ((gen, mem len), merged view)
        # value overflow heap: values longer than the inline slot live
        # here; the slot holds an 8-byte offset and vlen > val_width marks
        # the pointer
        self._blob = bytearray()
        # RPC replay cache (exactly-once writes): client id -> (last seq,
        # wire response), one entry per client, oldest client evicted
        self._replay_cache: dict[str, tuple[int, object]] = {}
        self.wal_path = wal_path
        self.wal_fsync = wal_fsync
        self._wal = None
        self._replaying = False
        # optional storage/disk.DiskMonitor fed by every WAL append
        self.disk_monitor = None
        if wal_path is not None:
            self._arm_wal(wal_path)

    # -- WAL ----------------------------------------------------------------

    def _arm_wal(self, path: str) -> None:
        """Replay any existing records, truncate torn bytes past the last
        complete record, then open the WAL for appending."""
        valid_off = 0
        if os.path.exists(path) and os.path.getsize(path) > 0:
            valid_off = self._replay_wal(path)
            if valid_off < os.path.getsize(path):
                with open(path, "r+b") as f:
                    f.truncate(valid_off)
        self.wal_path = path
        self._wal = open(path, "ab")
        if os.path.getsize(path) < len(_WAL_MAGIC):
            self._wal.truncate(0)
            self._wal.write(_WAL_MAGIC)
            self._wal.flush()

    def _wal_record(self, kind: int, key: bytes, value: bytes, ts: int,
                    seq: int, txn: int, flag: bool,
                    sync: bool = True) -> None:
        from ..utils import faults, tracing

        rec = _WAL_REC.pack(kind, ts, seq, txn, 1 if flag else 0,
                            len(key), len(value))
        mon = self.disk_monitor
        t0 = time.time() if mon is not None else 0.0
        payload = rec + key + value
        # chaos sites: `delay` a stalling disk, `error` EIO before any byte
        # lands, `partial` a torn append; replay's torn-tail truncation
        # recovers all three
        with tracing.leaf_span("storage/wal.append", bytes=len(payload)):
            faults.fire("storage.wal.append")
            frac = faults.partial_fraction("storage.wal.append")
            if frac is not None:
                self._wal.write(payload[:max(1, int(len(payload) * frac))])
                self._wal.flush()
                raise faults.InjectedFault("storage.wal.append", "partial")
            self._wal.write(payload)
            self._wal.flush()
            # sync=False defers the fsync to an explicit wal_sync()
            if self.wal_fsync and sync:
                with tracing.leaf_span("storage/wal.fsync"):
                    faults.fire("storage.wal.fsync")
                    os.fsync(self._wal.fileno())
        if mon is not None:
            mon.observe(time.time() - t0)

    def _replay_wal(self, path: str) -> int:
        """Re-apply writes above the sequence high-water mark and all
        intent resolutions and span clears, in log order. Returns the
        offset just past the last complete record."""
        with open(path, "rb") as f:
            data = f.read()
        if len(data) < len(_WAL_MAGIC):
            return 0  # torn header: nothing recoverable was logged
        if data[:4] != _WAL_MAGIC:
            raise ValueError(f"corrupt WAL header in {path!r}")
        off = 4
        valid_off = off
        self._replaying = True
        try:
            while off + _WAL_REC.size <= len(data):
                kind, ts, seq, txn, flag, klen, vlen = _WAL_REC.unpack_from(
                    data, off)
                off += _WAL_REC.size
                if off + klen + vlen > len(data):
                    break  # torn tail record: drop
                key = data[off: off + klen]
                value = data[off + klen: off + klen + vlen]
                off += klen + vlen
                valid_off = off
                if kind == _REC_RESOLVE:
                    self.resolve_intents(txn, ts, commit=bool(flag))
                elif kind == _REC_INGEST:
                    if seq > self._seq:
                        self._replay_ingest(path, key.decode(), ts, seq)
                elif kind == _REC_IMPORT:
                    if seq > self._seq:
                        self._replay_import(path, key.decode(), seq)
                elif kind == _REC_CLEAR:
                    self.clear_span(key or None, value if flag else None)
                elif kind == _REC_BATCH:
                    self._replay_batch_record(seq, value)
                elif kind == _REC_WRITE:
                    if seq > self._seq:
                        self._raw_append(key, value, ts, seq, txn,
                                         bool(flag))
                else:
                    raise ValueError(f"unknown WAL record kind {kind} in "
                                     f"{path!r}")
        finally:
            self._replaying = False
        self.flush_mem_only()
        return valid_off

    def _replay_ingest(self, wal_path: str, name: str, ts: int,
                       seq: int) -> None:
        side = os.path.join(os.path.dirname(wal_path) or ".", name)
        try:
            z = np.load(side)
            n = int(z["n"])
            kb, vb, vl = z["key"][:n], z["value"][:n], z["vlen"][:n]
        except _SIDE_ERRORS as e:
            # missing or torn side file: reachable only after a machine
            # crash with wal_fsync=False; keep the store openable
            from ..utils import log

            log.warning(log.STORAGE,
                        "ingest side file missing/torn on replay; run "
                        "dropped", file=side, error=str(e))
            return
        # _replaying suppresses the re-log, so the run lands exactly once
        self.ingest(kb, vb, ts, seq=seq, vlens=vl)

    def _replay_import(self, wal_path: str, name: str, seq: int) -> None:
        side = os.path.join(os.path.dirname(wal_path) or ".", name)
        try:
            z = np.load(side)
            rows = {f: z[f] for f in ("key", "ts", "seq", "txn", "tomb",
                                      "value", "vlen")}
            if "blob" in z.files:
                rows["blob"] = z["blob"]
        except _SIDE_ERRORS as e:
            from ..utils import log

            log.warning(log.STORAGE,
                        "import side file missing/torn on replay; run "
                        "dropped", file=side, error=str(e))
            return
        self.import_rows(rows)
        # restore the marker allocated at emit time (the imported rows'
        # own max seq may be lower)
        self._seq = max(self._seq, seq)

    def _truncate_wal(self) -> None:
        if self._wal is None:
            return
        self._wal.close()
        self._wal = open(self.wal_path, "wb")
        self._wal.write(_WAL_MAGIC)
        self._wal.flush()
        if self.wal_fsync:
            os.fsync(self._wal.fileno())
        self._wal.close()
        self._wal = open(self.wal_path, "ab")

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    # -- writes -------------------------------------------------------------

    @_locked
    def put(self, key: bytes | str, value: bytes | str, ts: int, txn: int = 0):
        self._append(key, value, ts, txn, tomb=False)

    @_locked
    def delete(self, key: bytes | str, ts: int, txn: int = 0):
        self._append(key, b"", ts, txn, tomb=True)

    def _append(self, key, value, ts: int, txn: int, tomb: bool):
        b = key.encode() if isinstance(key, str) else bytes(key)
        v = value.encode() if isinstance(value, str) else bytes(value)
        self._check_write(b, v)
        from ..utils import metric

        metric.ENGINE_WRITES.inc()
        self.governor.pace_write()
        seq = self._seq + 1
        if self._wal is not None:  # write-ahead: durable before visible
            self._wal_record(_REC_WRITE, b, v, int(ts), seq, int(txn), tomb)
        self._raw_append(b, v, int(ts), seq, int(txn), tomb)
        if len(self.mem) >= self.memtable_size:
            self.flush()

    def _raw_append(self, b: bytes, v: bytes, ts: int, seq: int, txn: int,
                    tomb: bool) -> None:
        self._seq = max(self._seq, seq)
        if txn != 0:
            self._locks[b] = int(txn)
        else:
            self._newest_committed.put(b, ts)
        n = len(v)
        if n > self.val_width:
            # overflow: payload to the heap, an offset pointer inline (here
            # so that WAL replay rebuilds the heap too)
            off = len(self._blob)
            self._blob += v
            v = off.to_bytes(8, "little")
        self.mem.keys.append(b)
        self.mem.ts.append(ts)
        self.mem.seq.append(seq)
        self.mem.txn.append(txn)
        self.mem.tomb.append(tomb)
        self.mem.value.append(v)
        self.mem.vlen.append(n)

    # -- exactly-once RPC batches -------------------------------------------

    _REPLAY_CACHE_MAX_CLIENTS = 1024

    def _check_write(self, b: bytes, v: bytes) -> None:
        if b"\x00" in b:
            # zero padding makes b"a" and b"a\x00" indistinguishable
            raise ValueError(f"key must not contain 0x00 bytes: {b!r}")
        if len(b) > self.key_width:
            raise ValueError(f"key too long ({len(b)} > {self.key_width})")
        if len(v) > self.val_width and self.val_width < 8:
            raise ValueError(
                f"value of {len(v)} bytes needs the overflow heap, which "
                f"requires val_width >= 8 (have {self.val_width})"
            )

    @_locked
    def replay_cache_get(self, cid: str, seq: int):
        """The cached wire response if (cid, seq) already applied, else
        None."""
        ent = self._replay_cache.get(cid)
        if ent is not None and ent[0] == seq:
            return ent[1]
        return None

    def _set_replay_entry(self, cid: str, seq: int, resp) -> None:
        self._replay_cache.pop(cid, None)  # reinsert = refresh LRU order
        while len(self._replay_cache) >= self._REPLAY_CACHE_MAX_CLIENTS:
            self._replay_cache.pop(next(iter(self._replay_cache)))
        self._replay_cache[cid] = (int(seq), resp)

    def wal_sync(self) -> None:
        """fsync the WAL, covering every record appended with
        ``sync=False`` (group commit: append under the mutex, sync
        outside it)."""
        from ..utils import faults, tracing

        w = self._wal
        if w is None or not self.wal_fsync:
            return
        with tracing.leaf_span("storage/wal.fsync"):
            faults.fire("storage.wal.fsync")
            os.fsync(w.fileno())

    @_locked
    def apply_rpc_batch(self, cid: str, seq: int, muts, resp,
                        sync: bool = True) -> None:
        """Apply a stamped mutation batch exactly once. muts: [(key, value,
        ts, txn, tomb), ...]; resp: the JSON-serializable response a dedup
        hit replays. One _REC_BATCH record covers ops, dedup entry and
        response."""
        from ..utils import metric

        for k, v, _ts, _txn, _tomb in muts:
            self._check_write(k, v)
        self.governor.pace_write()
        base = self._seq + 1
        if self._wal is not None:
            payload = json.dumps({
                "cid": cid, "seq": int(seq),
                "muts": [[base64.b64encode(k).decode(),
                          base64.b64encode(v).decode(),
                          int(ts), int(txn), bool(tomb)]
                         for k, v, ts, txn, tomb in muts],
                "resp": resp,
            }).encode()
            # vlen is a uint16: a payload past 64 KiB fails in pack,
            # before any WAL or memtable state changes
            self._wal_record(_REC_BATCH, b"", payload, 0, base, 0, False,
                             sync=sync)
        for i, (k, v, ts, txn, tomb) in enumerate(muts):
            metric.ENGINE_WRITES.inc()
            self._raw_append(k, v, int(ts), base + i, int(txn), bool(tomb))
        self._set_replay_entry(cid, seq, resp)
        if len(self.mem) >= self.memtable_size:
            self.flush()

    def _replay_batch_record(self, seq: int, value: bytes) -> None:
        """Replay half of apply_rpc_batch: re-apply ops above the seq
        high-water mark, and always restore the dedup entry."""
        ent = json.loads(value.decode())
        if seq > self._seq:
            for i, (k64, v64, ts, txn, tomb) in enumerate(ent["muts"]):
                self._raw_append(
                    base64.b64decode(k64), base64.b64decode(v64),
                    int(ts), seq + i, int(txn), bool(tomb))
        self._set_replay_entry(ent["cid"], int(ent["seq"]), ent["resp"])

    def _resolve_value(self, row: np.ndarray, n: int) -> bytes:
        """Inline slot bytes + logical length -> the stored value."""
        if n <= self.val_width:
            return bytes(row[:n])
        off = int.from_bytes(bytes(row[:8]), "little")
        return bytes(self._blob[off:off + n])

    # -- flush / compaction -------------------------------------------------

    @_locked
    def _mem_block(self) -> mvcc.KVBlock | None:
        # under the mutex: a scan on another thread must not cache a block
        # of a memtable that a flush is replacing, which the next flush
        # would then land in place of the new memtable's writes
        if not len(self.mem):
            return None
        if self._mem_cache is not None and self._mem_cache[0] == len(self.mem):
            return self._mem_cache[1]
        n = len(self.mem)
        keys = K.encode_keys(self.mem.keys, self.key_width)
        vals = np.zeros((n, self.val_width), dtype=np.uint8)
        vlen = np.asarray(self.mem.vlen, dtype=np.int32)
        for i, v in enumerate(self.mem.value):
            if len(v):
                vals[i, : len(v)] = np.frombuffer(v, dtype=np.uint8)
        # sort on the host in the canonical MVCC order (key asc, ts desc,
        # seq desc): a memtable is small
        ts_arr = np.asarray(self.mem.ts, np.int64)
        seq_arr = np.asarray(self.mem.seq, np.int64)
        void_keys = np.ascontiguousarray(keys).view(
            f"V{self.key_width}").reshape(-1)
        order = np.lexsort((-seq_arr, -ts_arr, void_keys))
        blk = mvcc.block_from_host(
            keys[order],
            ts_arr[order],
            np.asarray(self.mem.txn, np.int64)[order],
            np.asarray(self.mem.tomb, np.bool_)[order],
            vals[order],
            vlen[order],
            cap=_pad(n),
            seq=seq_arr[order],
            device=self.device,
        )
        _charge_run(blk)
        self._mem_cache = (n, blk)
        return blk

    @_locked
    def ingest(self, keys: np.ndarray, values: np.ndarray, ts: int,
               seq: int | None = None,
               vlens: np.ndarray | None = None,
               presorted: bool = False) -> None:
        """Bulk ingest: land pre-built KV arrays as one sorted run (the
        AddSSTable path). keys: [N, <=key_width] uint8 zero-padded;
        values: [N, <=val_width] uint8; all entries committed at `ts`.
        ``presorted=True`` promises unique keys already in canonical run
        order, so the landing sort is skipped."""
        n = len(keys)
        if n == 0:
            return
        self.governor.pace_write()
        if keys.shape[1] > self.key_width:
            raise ValueError("ingest keys wider than engine key width")
        if values.shape[1] > self.val_width:
            raise ValueError("ingest values wider than engine val width")
        if seq is None:
            seq = self._seq + 1
        self._seq = max(self._seq, seq)
        cap = _pad(n)
        kb = np.zeros((cap, self.key_width), dtype=np.uint8)
        kb[:n, : keys.shape[1]] = keys
        vb = np.zeros((cap, self.val_width), dtype=np.uint8)
        vb[:n, : values.shape[1]] = values
        vl = np.concatenate([
            (np.asarray(vlens, dtype=np.int32) if vlens is not None
             else np.full(n, values.shape[1], np.int32)),
            np.zeros(cap - n, np.int32),
        ])
        if self._wal is not None and not self._replaying:
            # durable before visible: the run's host arrays go to a side
            # file, then the WAL record naming it
            side = f"{self.wal_path}.ingest{int(seq):012d}.npz"
            with open(side, "wb") as f:
                np.savez(f, key=kb[:n], value=vb[:n], vlen=vl[:n],
                         n=np.int64(n), ts=np.int64(ts), seq=np.int64(seq))
                f.flush()
                if self.wal_fsync:
                    os.fsync(f.fileno())
            if self.wal_fsync:
                dfd = os.open(os.path.dirname(side) or ".", os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            from ..utils import faults

            # chaos: crash between the durable side file and the WAL link
            faults.fire("storage.ingest.link")
            self._wal_record(_REC_INGEST, os.path.basename(side).encode(),
                             b"", int(ts), int(seq), 0, False)
        dev = self.device
        blk = mvcc.KVBlock(
            key=torch.from_numpy(kb).to(dev),
            ts=torch.full((cap,), int(ts), dtype=torch.int64, device=dev),
            seq=torch.full((cap,), int(seq), dtype=torch.int64, device=dev),
            txn=torch.zeros(cap, dtype=torch.int64, device=dev),
            tomb=torch.zeros(cap, dtype=torch.bool, device=dev),
            value=torch.from_numpy(vb).to(dev),
            vlen=torch.from_numpy(vl).to(dev),
            mask=torch.arange(cap, device=dev) < n,
        )
        run = blk if presorted else mvcc.sort_block(blk)
        _charge_run(run)
        self.runs.insert(0, run)
        self._gen += 1
        self.stats.flushes += 1
        self.stats.runs = len(self.runs)
        from ..utils import metric

        metric.ENGINE_INGESTS.inc()
        metric.INGEST_ROWS.inc(n)
        metric.INGEST_BYTES.inc(int(n * self.key_width + int(vl[:n].sum())))
        metric.ENGINE_RUNS.set(len(self.runs))
        self._register_run(run)
        self._newest_committed.bulk(kb[:n], int(ts))
        self._maybe_compact()

    @_locked
    def flush(self):
        """Memtable -> sorted immutable run (Pebble memtable flush)."""
        self.flush_mem_only()
        self._maybe_compact()

    @_locked
    def flush_mem_only(self):
        blk = self._mem_block()
        if blk is None:
            return
        self.runs.insert(0, blk)
        self.mem = _Memtable()
        self._mem_cache = None
        self._gen += 1
        self.stats.flushes += 1
        self.stats.runs = len(self.runs)
        from ..utils import metric

        metric.ENGINE_FLUSHES.inc()
        metric.ENGINE_RUNS.set(len(self.runs))
        self._register_run(blk)

    def _maybe_compact(self) -> None:
        """Size-tiered compaction trigger behind the IOGovernor's pacing."""
        if (len(self.runs) > self.l0_trigger
                and self.governor.pace_compaction()):
            self.compact(bottom=False)

    @_locked
    def compact(self, bottom: bool = True):
        """bottom=True merges everything and elides bottom-level
        tombstones; bottom=False merges the `compact_width` smallest runs."""
        from ..utils import tracing

        self.flush_mem_only()
        if len(self.runs) < 2:
            return
        with tracing.leaf_span("storage/compaction", bottom=bottom,
                               runs=len(self.runs)):
            if bottom:
                picked = list(range(len(self.runs)))
            else:
                by_size = sorted(
                    range(len(self.runs)),
                    key=lambda i: self.runs[i].capacity
                )
                picked = sorted(by_size[: max(2, self.compact_width)])
            blocks = tuple(self.runs[i] for i in picked)
            total = sum(r.capacity for r in blocks)
            merged = self._merge_for_compaction(blocks, total)
            keep = mvcc.mvcc_gc_filter(merged, self.gc_ts, bottom)
            merged = dataclasses.replace(merged, mask=merged.mask & keep)
            merged = _shrink(mvcc.sort_block(merged))
            picked_set = set(picked)
            kept = [r for i, r in enumerate(self.runs) if i not in picked_set]
            # the merged run replaces its sources at the oldest picked slot
            kept.insert(min(len(kept), picked[0]), merged)
            self.runs = kept
            self._gen += 1
            from ..utils import faults

            try:
                # chaos: the swap is visible but the cache/bloom
                # bookkeeping hasn't happened yet — it must still run
                faults.fire("storage.compaction.swap")
            finally:
                for b in blocks:
                    self._drop_run_meta(b)
                self._register_run(merged)
            self.stats.compactions += 1
            from ..utils import log, metric

            metric.ENGINE_COMPACTIONS.inc()
            log.debug(log.STORAGE, "compaction", runs=len(self.runs),
                      bottom=bottom)
            self.stats.runs = len(self.runs)
            self.governor.note_compaction()

    def _merge_for_compaction(self, blocks, total: int) -> mvcc.KVBlock:
        """The merge-path kernel (storage/cuda_merge.py) when the key width
        and size allow it, else concat + sort. The post-GC sort + _shrink
        in compact() trims the kernel's padded capacity either way."""
        from . import cuda_merge

        if self.key_width == 16 and cuda_merge.eligible(blocks):
            return cuda_merge.merge_runs(blocks)
        return mvcc.merge_blocks(blocks, cap=_pad(total))

    # -- read views ---------------------------------------------------------

    @_locked
    def _runs_view(self) -> mvcc.KVBlock | None:
        """One sorted view over all runs, cached per generation."""
        if not self.runs:
            return None
        if (self._runs_view_cache is not None
                and self._runs_view_cache[0] == self._gen):
            return self._runs_view_cache[1]
        if len(self.runs) == 1:
            view = self.runs[0]
        else:
            total = sum(r.capacity for r in self.runs)
            view = _shrink(
                mvcc.merge_blocks(tuple(self.runs), cap=_pad(total)))
        self._runs_view_cache = (self._gen, view)
        return view

    @_locked
    def _merged_view(self) -> mvcc.KVBlock | None:
        """Sorted view over memtable + runs, cached per (generation,
        memtable length). Held under the engine mutex, as the columnar
        scans of concurrent sessions call it (the reference's is not;
        ROADMAP Queue 3)."""
        rv = self._runs_view()
        mb = self._mem_block()
        if mb is None:
            return rv
        if rv is None:
            return mb
        key = (self._gen, len(self.mem))
        if (self._overlay_cache is not None
                and self._overlay_cache[0] == key):
            return self._overlay_cache[1]
        view = mvcc.merge_blocks(
            (mb, rv), cap=_pad(mb.capacity + rv.capacity))
        self._overlay_cache = (key, view)
        return view

    def _bounded_view(self, sw, ew, limit_rows: int | None = None,
                      point: bytes | None = None):
        """Candidate view for a bounded read: gather only in-range rows of
        each source into small tiles and merge those.

        limit_rows clamps each sorted run to its first limit_rows in-range
        entries (pebbleMVCCScanner pagination). Returns (view, boundary):
        rows at or past `boundary` (the smallest truncation point across
        runs) may miss versions and must not be emitted; None means
        nothing was truncated."""
        sources = []
        mb = self._mem_block()
        if mb is not None:
            sources.append((mb, False))  # memtable: never seek
        sources.extend((r, True) for r in self.runs)
        swj = K.words_tensor(sw, self.device)
        ewj = K.words_tensor(ew, self.device)
        parts = []
        boundary: bytes | None = None
        for src, sorted_run in sources:
            if (point is not None and sorted_run
                    and not self._bloom_might_contain(src, point)):
                # the key is definitely absent from this run
                from ..utils import metric

                metric.BLOOM_SKIPS.inc()
                continue
            if limit_rows is not None and sorted_run and sw is not None:
                # iterator seek: host binary search over the run's key
                # bytes, one device slice of the window
                meta = self._meta_for(src)
                vkeys, n_live = meta.void_keys, meta.n_live
                if n_live == 0:
                    continue
                sw_raw = _words_to_bytes(sw)
                pos = int(np.searchsorted(
                    vkeys[:n_live],
                    np.frombuffer(sw_raw, dtype=vkeys.dtype)[0],
                    side="left",
                ))
                if pos >= n_live:
                    continue
                size = min(_pad(limit_rows, _CAND_ALIGN), src.capacity)
                cpos = min(pos, max(0, src.capacity - size))
                # runs are immutable, so a (token, pos, size) window never
                # changes: consult the node cache before slicing
                cache = blockcache.node_cache()
                win = cache.get(meta.token, cpos, size)
                if win is None:
                    win = _slice_window(src, cpos, size)
                    cache.put(meta.token, cpos, size, win)
                end_pos = cpos + size
                if end_pos < n_live:
                    cut = bytes(vkeys[end_pos - 1].tobytes())
                    if ew is None or cut < _words_to_bytes(ew):
                        if boundary is None or cut < boundary:
                            boundary = cut
                m, cnt = _range_mask(win, swj, ewj)
                if cnt == 0:
                    continue
                parts.append(_gather_rows(win, m, _pad(cnt, _CAND_ALIGN)))
                continue
            m, cnt = _range_mask(src, swj, ewj)
            if cnt == 0:
                continue
            parts.append(_gather_rows(src, m, _pad(cnt, _CAND_ALIGN)))
        if not parts:
            return None, None
        if len(parts) == 1:
            return parts[0], boundary
        total = sum(p.capacity for p in parts)
        view = mvcc.merge_blocks(tuple(parts), cap=_pad(total, _CAND_ALIGN))
        return view, boundary

    # -- per-run read metadata (blockcache.RunMeta: seek keys + bloom) ------

    def _meta_for(self, run: mvcc.KVBlock) -> blockcache.RunMeta:
        """Read-path metadata for a run: built eagerly by _register_run,
        lazily here for runs rewritten by intent resolution. Stale entries
        prune as the run set turns over, with their block-cache
        entries."""
        c = self._run_meta.get(id(run))
        if c is None or c[0] is not run:
            kb = run.key.cpu().numpy()
            void = np.ascontiguousarray(kb).view(
                f"V{kb.shape[1]}").reshape(-1)
            n_live = int(run.mask.sum())
            if len(self._run_meta) > 4 * max(1, len(self.runs)):
                live_ids = {id(r) for r in self.runs}
                cache = blockcache.node_cache()
                for k in [k for k in self._run_meta if k not in live_ids]:
                    cache.invalidate_run(self._run_meta[k][1].token)
                    del self._run_meta[k]
            c = self._run_meta[id(run)] = (
                run, blockcache.build_meta(void, n_live))
        return c[1]

    def _register_run(self, run: mvcc.KVBlock) -> None:
        """Eager metadata build for a newly constructed run."""
        self._meta_for(run).bloom()

    def _drop_run_meta(self, run: mvcc.KVBlock) -> None:
        c = self._run_meta.pop(id(run), None)
        if c is not None:
            blockcache.node_cache().invalidate_run(c[1].token)

    def _bloom_might_contain(self, run: mvcc.KVBlock, key: bytes) -> bool:
        """Per-run split-block bloom probe: False is a CRC-backed proof of
        absence; a filterless or corrupt run always answers maybe."""
        bloom = self._meta_for(run).bloom()
        if bloom is None:
            return True
        kb = np.zeros((1, self.key_width), np.uint8)
        raw = np.frombuffer(key, np.uint8)
        kb[0, :len(raw)] = raw
        h1, h2 = blockcache.bloom_hashes(
            np.ascontiguousarray(kb).view(f"V{self.key_width}").reshape(-1)
        )
        return bloom.might_contain(int(h1[0]), int(h2[0]))

    def _view_for(self, sw, ew) -> mvcc.KVBlock | None:
        if sw is None and ew is None:
            return self._merged_view()
        return self._bounded_view(sw, ew)[0]

    def _intent_error(self, view: mvcc.KVBlock, conflict: torch.Tensor):
        idx = torch.nonzero(conflict).squeeze(1)
        return WriteIntentError(
            K.decode_keys(view.key[idx].cpu().numpy()),
            [int(t) for t in view.txn[idx].cpu().numpy()],
        )

    # -- reads --------------------------------------------------------------

    @_locked
    def scan(
        self,
        start: bytes | str | None,
        end: bytes | str | None,
        ts: int,
        txn: int = 0,
        max_keys: int | None = None,
    ) -> list[tuple[bytes, bytes]]:
        """[start, end) snapshot scan at `ts` -> [(key, value)].

        With max_keys, candidate gathering is clamped per sorted run; rows
        at or past the smallest truncation boundary are withheld and the
        clamp grows geometrically until max_keys complete rows emerge."""
        from ..utils import metric

        metric.ENGINE_SCANS.inc()
        sw = K.encode_bound(start, self.key_width)
        ew = K.encode_bound(end, self.key_width)
        limit = None
        if max_keys is not None and (sw is not None or ew is not None):
            limit = max(16, 4 * max_keys)
        while True:
            if limit is not None:
                view, boundary = self._bounded_view(sw, ew, limit)
            else:
                view, boundary = self._view_for(sw, ew), None
            if view is None:
                return []
            sel, conflict = mvcc.mvcc_scan_filter(
                view, int(ts), int(txn),
                K.words_tensor(sw, self.device),
                K.words_tensor(ew, self.device),
            )
            if bool(conflict.any()):
                raise self._intent_error(view, conflict)
            idx = torch.nonzero(sel).squeeze(1).cpu().numpy()
            keys_np = view.key.cpu().numpy()
            if boundary is not None:
                # emit only rows strictly below the truncation point
                below = np.array(
                    [bytes(k) < boundary for k in keys_np[idx]], dtype=bool
                )
                kept = idx[below]
                if max_keys is not None and len(kept) < max_keys:
                    # complete rows don't cover the limit: more keys may
                    # hide past the boundary
                    limit *= 4
                    continue
                idx = kept
            if max_keys is not None:
                idx = idx[:max_keys]
            ks = K.decode_keys(keys_np[idx])
            vals = view.value.cpu().numpy()[idx]
            vls = view.vlen.cpu().numpy()[idx]
            return [(k, self._resolve_value(v, int(n)))
                    for k, v, n in zip(ks, vals, vls)]

    @_locked
    def scan_batch(
        self,
        starts: list[bytes | str],
        ts: int,
        txn: int = 0,
        max_keys: int = 64,
    ) -> list[list[tuple[bytes, bytes]]]:
        """B forward scans of up to max_keys rows each in one device pass
        (the kv Streamer analog): sorted sources merged lazily per window,
        one scan-filter launch over all windows."""
        from ..utils import metric

        if not starts:
            return []
        metric.ENGINE_SCANS.inc(len(starts))
        sources = []
        mb = self._mem_block()
        if mb is not None:
            sources.append(mb)
        sources.extend(self.runs)
        if not sources:
            return [[] for _ in starts]
        enc = [
            (s.encode() if isinstance(s, str) else bytes(s)) for s in starts
        ]
        starts_words = K.words_tensor(K.encode_bounds(enc, self.key_width),
                                      self.device)
        B = len(enc)
        max_cap = max(s.capacity for s in sources)
        # sticky converged window per max_keys: version-dense ranges grow
        # the window past the initial 2*max_keys once, not every batch
        window = self._scan_windows.get(
            max_keys, _pad(max(16, 2 * max_keys), _CAND_ALIGN)
        )
        while True:
            win, sel, conflict, complete, truncated = (
                mvcc.multi_scan_sources(
                    tuple(sources), starts_words, int(ts), int(txn),
                    window=window,
                )
            )
            # compact selected rows to [B, max_keys] on the device before
            # anything reaches the host
            keys_d, vals_d, vlen_d, counts_d = mvcc._emit_stage(
                win, sel & complete, B, max_keys
            )
            if bool(conflict.any()):
                raise self._intent_error(win, conflict)
            counts = counts_d.cpu().numpy()
            # a truncated window with a short result pages forward even if
            # nothing in it was selected (e.g. a run of tombstones)
            truncated_np = truncated.cpu().numpy()
            if (truncated_np & (counts < max_keys)).any() and (
                window < max_cap
            ):
                window = min(_pad(window * 4, _CAND_ALIGN), _pad(max_cap))
                self._scan_windows[max_keys] = window
                continue
            keys_np = keys_d.cpu().numpy()
            vals_np = vals_d.cpu().numpy()
            vlen_np = vlen_d.cpu().numpy()
            out: list[list[tuple[bytes, bytes]]] = []
            for b in range(B):
                k = min(int(counts[b]), max_keys)
                ks = K.decode_keys(keys_np[b][:k])
                out.append([
                    (key, self._resolve_value(v, int(n)))
                    for key, v, n in zip(ks, vals_np[b][:k], vlen_np[b][:k])
                ])
            return out

    @_locked
    def get(self, key: bytes | str, ts: int, txn: int = 0) -> bytes | None:
        """Point read: bloom -> block cache -> device window per surviving
        run; a window cut inside the key's version set grows
        geometrically."""
        b = key.encode() if isinstance(key, str) else bytes(key)
        sw = K.encode_bound(b, self.key_width)
        ew = K.bound_next(sw)
        limit = 8
        while True:
            view, boundary = self._bounded_view(sw, ew, limit_rows=limit,
                                                point=b)
            if boundary is None:
                break
            limit *= 4
        if view is None:
            return None
        sel, conflict = mvcc.mvcc_scan_filter(
            view, int(ts), int(txn),
            K.words_tensor(sw, self.device), K.words_tensor(ew, self.device),
        )
        if bool(conflict.any()):
            raise self._intent_error(view, conflict)
        idx = torch.nonzero(sel).squeeze(1)
        if not len(idx):
            return None
        i = int(idx[0])
        n = int(view.vlen[i])
        return self._resolve_value(view.value[i].cpu().numpy(), n)

    # -- intents ------------------------------------------------------------

    @_locked
    def resolve_intents(self, txn: int, commit_ts: int, commit: bool):
        """Commit or abort all of txn's intents across memtable + runs.
        WAL-logged, or crash replay would resurrect them."""
        if self._wal is not None and not self._replaying:
            self._wal_record(_REC_RESOLVE, b"", b"", int(commit_ts), 0,
                             int(txn), commit)
        if commit:
            for k, t in self._locks.items():
                if t == txn:
                    self._newest_committed.put(k, int(commit_ts))
        self._locks = {k: t for k, t in self._locks.items() if t != txn}
        self.flush_mem_only()
        old_runs = self.runs
        self.runs = [
            mvcc.sort_block(
                mvcc.resolve_intents(r, int(txn), int(commit_ts), commit))
            for r in old_runs
        ]
        # every run object was replaced: retire their read metadata
        for r in old_runs:
            self._drop_run_meta(r)
        self._gen += 1
        self._maybe_compact()

    @_locked
    def has_committed_writes_in(
        self, start: bytes | None, end: bytes | None, ts_lo: int, ts_hi: int,
        point: bool = False,
    ) -> bool:
        """Any committed version in (ts_lo, ts_hi] within [start, end)?
        The read-refresh check. ``point=True`` checks exactly `start`."""
        sw = K.encode_bound(start, self.key_width)
        ew = K.bound_next(sw) if point else K.encode_bound(end,
                                                            self.key_width)
        view = self._view_for(sw, ew)
        if view is None:
            return False
        m, _ = _range_mask(view, K.words_tensor(sw, self.device),
                           K.words_tensor(ew, self.device))
        hit = m & (view.txn == 0) & (view.ts > ts_lo) & (view.ts <= ts_hi)
        return bool(hit.any())

    @_locked
    def other_intent(self, key: bytes, txn: int) -> int | None:
        """Txn id of another transaction's intent on `key`, if any (a host
        lock-table lookup)."""
        b = key.encode() if isinstance(key, str) else bytes(key)
        holder = self._locks.get(b)
        return holder if holder is not None and holder != txn else None

    @_locked
    def newest_committed_ts(self, key: bytes) -> int:
        """Timestamp of the newest committed version of `key` (0 if none),
        from the host tscache: the WriteTooOld check."""
        b = key.encode() if isinstance(key, str) else bytes(key)
        return self._newest_committed.get(b, 0)

    @_locked
    def intent_keys(self, txn: int) -> list[bytes]:
        return sorted(k for k, t in self._locks.items() if t == txn)

    # -- range relocation (snapshot-rebalance primitives) -------------------

    def _span_rows(self, start, end):
        """(merged view, indices of its rows in [start, end)) on the host."""
        view = self._merged_view()
        if view is None:
            return None, None
        sw = K.encode_bound(start, self.key_width)
        ew = K.encode_bound(end, self.key_width)
        m, _ = _range_mask(view, K.words_tensor(sw, self.device),
                           K.words_tensor(ew, self.device))
        return view, torch.nonzero(m).squeeze(1)

    @_locked
    def span_stats(self, start: bytes | None, end: bytes | None) -> dict:
        """Size accounting for [start, end): every version's key width plus
        its stored value length."""
        view, idx = self._span_rows(start, end)
        if view is None:
            return {"versions": 0, "logical_bytes": 0}
        n = int(idx.shape[0])
        vbytes = int(view.vlen[idx].to(torch.int64).sum()) if n else 0
        return {"versions": n, "logical_bytes": n * self.key_width + vbytes}

    @_locked
    def export_span(self, start: bytes | None, end: bytes | None) -> dict:
        """Every version in [start, end) (history, tombstones and intents)
        as host arrays: the raft-snapshot payload. Overflow payloads
        materialize into ``blob`` in row order."""
        view, idx = self._span_rows(start, end)
        if view is None or not len(idx):
            return {
                "key": np.zeros((0, self.key_width), np.uint8),
                "ts": np.zeros((0,), np.int64),
                "seq": np.zeros((0,), np.int64),
                "txn": np.zeros((0,), np.int64),
                "tomb": np.zeros((0,), np.bool_),
                "value": np.zeros((0, self.val_width), np.uint8),
                "vlen": np.zeros((0,), np.int32),
                "blob": np.zeros((0,), np.uint8),
            }
        out = {f: getattr(view, f)[idx].cpu().numpy()
               for f in ("key", "ts", "seq", "txn", "tomb", "value", "vlen")}
        vals, vlen = out["value"], out["vlen"]
        out["blob"] = np.frombuffer(b"".join(
            self._resolve_value(vals[i], int(vlen[i]))
            for i in np.nonzero(vlen > self.val_width)[0]
        ), dtype=np.uint8)
        from ..flow import memory as flowmem

        # the payload lives until the transport drops it
        flowmem.charge_object(
            "storage/export-staging", out["key"],
            int(sum(a.nbytes for a in out.values())))
        return out

    @_locked
    def import_rows(self, rows: dict) -> None:
        """Land exported versions as one sorted run, keeping their ts, seq
        and txn; raise the sequence high-water mark past them, refresh the
        tscache from committed rows and the lock table from intents.
        WAL-logged through a side file, as ingest is."""
        n = len(rows["ts"])
        if n == 0:
            return
        if rows["key"].shape[1] != self.key_width:
            raise ValueError("imported keys do not match engine key width")
        src_w = rows["value"].shape[1]
        if src_w > self.val_width:
            raise ValueError("imported values wider than engine val width")
        cap = _pad(n)
        vb = np.zeros((cap, self.val_width), np.uint8)
        vb[:n, :src_w] = rows["value"]
        # re-home overflow payloads: inline where they fit this engine's
        # slot, else into this engine's heap
        vlen_in = np.asarray(rows["vlen"], np.int64)
        if (vlen_in > src_w).any():
            blob_b = bytes(np.asarray(rows["blob"], np.uint8).tobytes())
            off = 0
            for i in np.nonzero(vlen_in > src_w)[0]:
                ln = int(vlen_in[i])
                payload = blob_b[off:off + ln]
                off += ln
                vb[i] = 0
                if ln <= self.val_width:
                    vb[i, :ln] = np.frombuffer(payload, np.uint8)
                else:
                    ptr = len(self._blob)
                    self._blob += payload
                    vb[i, :8] = np.frombuffer(ptr.to_bytes(8, "little"),
                                              np.uint8)
        seq = rows["seq"].astype(np.int64)
        self._seq = max(self._seq, int(seq.max()))
        if self._wal is not None and not self._replaying:
            # side file first, then the record naming it; the marker seq
            # sits above the high-water mark so replay's gate passes
            marker = self._seq + 1
            self._seq = marker
            side = f"{self.wal_path}.import{int(marker):012d}.npz"
            with open(side, "wb") as f:
                np.savez(f, key=rows["key"], ts=rows["ts"], seq=seq,
                         txn=rows["txn"], tomb=rows["tomb"],
                         value=rows["value"], vlen=rows["vlen"],
                         blob=np.asarray(rows.get(
                             "blob", np.zeros(0, np.uint8)), np.uint8))
                f.flush()
                if self.wal_fsync:
                    os.fsync(f.fileno())
            if self.wal_fsync:
                dfd = os.open(os.path.dirname(side) or ".", os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            self._wal_record(_REC_IMPORT, os.path.basename(side).encode(),
                             b"", 0, int(marker), 0, False)
        blk = mvcc.block_from_host(
            rows["key"], rows["ts"], rows["txn"], rows["tomb"], vb[:n],
            rows["vlen"], cap=cap, seq=seq, device=self.device)
        run = mvcc.sort_block(blk)
        _charge_run(run)
        self.runs.insert(0, run)
        self._gen += 1
        self.stats.runs = len(self.runs)
        self._register_run(run)
        committed = rows["txn"] == 0
        if committed.any():
            self._newest_committed.bulk(rows["key"][committed],
                                        rows["ts"][committed])
        for i in np.nonzero(~committed)[0]:
            k = bytes(rows["key"][i]).rstrip(b"\x00")
            self._locks[k] = int(rows["txn"][i])
        self._maybe_compact()

    @_locked
    def clear_span(self, start: bytes | None, end: bytes | None) -> None:
        """Physically drop every version in [start, end) (replica removal,
        not an MVCC delete). WAL-logged; replays in log order."""
        if self._wal is not None and not self._replaying:
            self._wal_record(_REC_CLEAR, start or b"", end or b"", 0, 0, 0,
                             end is not None)
        sw = K.words_tensor(K.encode_bound(start, self.key_width),
                            self.device)
        ew = K.words_tensor(K.encode_bound(end, self.key_width), self.device)
        self.flush_mem_only()
        new_runs = []
        for r in self.runs:
            m, cnt = _range_mask(r, sw, ew)
            if cnt == 0:
                new_runs.append(r)
                continue
            # rewritten or dropped: retire its read metadata
            self._drop_run_meta(r)
            keep = r.mask & ~m
            if not bool(keep.any()):
                continue
            new_runs.append(_shrink(mvcc.sort_block(
                dataclasses.replace(r, mask=keep))))
        self.runs = new_runs

        def _in(k: bytes) -> bool:
            if start is not None and k < start:
                return False
            return end is None or k < end

        self._locks = {k: t for k, t in self._locks.items() if not _in(k)}
        self._gen += 1
        self.stats.runs = len(self.runs)

    # -- stats / checkpoint -------------------------------------------------

    @_locked
    def compute_stats(self) -> MVCCStats:
        view = self._merged_view()
        s = self.stats
        if view is None:
            s.live_count = s.key_count = s.val_count = s.intent_count = 0
            return s
        mask = view.mask
        s.val_count = int(mask.sum())
        s.intent_count = int((mask & (view.txn != 0)).sum())
        # the view is sorted with dead rows last: distinct keys are the
        # key-run boundaries among live rows
        s.key_count = int((mvcc._key_boundaries(view) & mask).sum())
        sel, _ = mvcc.mvcc_scan_filter(view, np.iinfo(np.int64).max, 0)
        s.live_count = int(sel.sum())
        return s

    @_locked
    def checkpoint(self, path: str):
        """Persist the engine (CreateCheckpoint analog) in the reference's
        layout; the WAL truncates afterwards."""
        self.flush_mem_only()
        os.makedirs(path, exist_ok=True)
        for i, r in enumerate(self.runs):
            with open(os.path.join(path, f"run{i:04d}.npz"), "wb") as f:
                np.savez(f, **{fld: getattr(r, fld).cpu().numpy()
                               for fld in mvcc.FIELDS})
                f.flush()
                os.fsync(f.fileno())
        if self._blob:
            # runs reference the overflow heap by offset
            with open(os.path.join(path, "blob.bin"), "wb") as f:
                f.write(bytes(self._blob))
                f.flush()
                os.fsync(f.fileno())
        if self._replay_cache:
            # the truncated WAL held the only durable copy of the dedup
            # entries
            with open(os.path.join(path, "replay_cache.json"), "w") as f:
                json.dump({cid: [s, r] for cid, (s, r)
                           in self._replay_cache.items()}, f)
                f.flush()
                os.fsync(f.fileno())
        with open(os.path.join(path, "MANIFEST"), "w") as f:
            f.write(f"{len(self.runs)} {self.key_width} {self.val_width}\n")
            f.flush()
            os.fsync(f.fileno())
        # durable before the WAL truncates
        dfd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self._truncate_wal()
        if self.wal_path is not None:
            # side files were reachable only through the truncated WAL
            for pat in ("ingest", "import"):
                for side in glob.glob(f"{self.wal_path}.{pat}*.npz"):
                    try:
                        os.unlink(side)
                    except OSError:  # pragma: no cover - best-effort
                        pass

    @classmethod
    def open_checkpoint(cls, path: str, **kwargs) -> "Engine":
        """Open a checkpoint (either package's) on ``device`` (a keyword,
        default ``"cuda"``); with ``wal_path``, replay the records that
        postdate it."""
        with open(os.path.join(path, "MANIFEST")) as f:
            nruns, kw, vw = (int(x) for x in f.read().split())
        wal_path = kwargs.pop("wal_path", None)
        eng = cls(key_width=kw, val_width=vw, **kwargs)
        blob_path = os.path.join(path, "blob.bin")
        if os.path.exists(blob_path):
            with open(blob_path, "rb") as f:
                eng._blob = bytearray(f.read())
        rc_path = os.path.join(path, "replay_cache.json")
        if os.path.exists(rc_path):
            with open(rc_path) as f:
                eng._replay_cache = {
                    cid: (int(s), r) for cid, (s, r) in json.load(f).items()}
        for i in range(nruns):
            z = np.load(os.path.join(path, f"run{i:04d}.npz"))
            run = mvcc.kvblock_from_numpy({f: z[f] for f in mvcc.FIELDS},
                                          eng.device)
            eng.runs.append(run)
            # the sequence high-water mark, the per-key newest-committed
            # index and the lock table come back from the runs
            m = z["mask"]
            if m.any():
                eng._seq = max(eng._seq, int(z["seq"][m].max()))
                cm = m & (z["txn"] == 0)
                if cm.any():
                    eng._newest_committed.bulk(z["key"][cm], z["ts"][cm])
            im = m & (z["txn"] != 0)
            if im.any():
                for kk, tt in zip(K.decode_keys(z["key"][im]), z["txn"][im]):
                    eng._locks[kk] = int(tt)
        eng.stats.runs = len(eng.runs)
        eng._gen += 1
        if wal_path is not None:
            eng._arm_wal(wal_path)
        return eng
