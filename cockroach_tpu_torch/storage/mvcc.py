"""MVCC block operations — the pebbleMVCCScanner hot loop and the LSM
merge, as PyTorch tensor code (counterpart of
``cockroach_tpu.storage.mvcc``).

Reference semantics (pkg/storage/pebble_mvcc_scanner.go:381): entries
sorted by (key asc, ts desc); per key the newest version with ts <=
read_ts is visible; deletion tombstones are skipped; another txn's intent
at ts <= read_ts is a WriteIntentError, while the reader's own intent is
visible regardless of its timestamp.

The reference's ``lax.sort(operands, num_keys=n, is_stable=True)`` becomes
successive stable ``torch.sort`` passes from the last key to the first
(``_stable_argsort``), which yields the same permutation. Key words follow
the int64 convention of ``keys.py``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import segscan
from .keys import (flip, key_words, words_cmp_eq, words_cmp_lt,
                   words_in_range)

_BIG = 2**31 - 1
FIELDS = ("key", "ts", "seq", "txn", "tomb", "value", "vlen", "mask")
_DTYPES = {
    "key": torch.uint8, "ts": torch.int64, "seq": torch.int64,
    "txn": torch.int64, "tomb": torch.bool, "value": torch.uint8,
    "vlen": torch.int32, "mask": torch.bool,
}


@dataclass(frozen=True)
class KVBlock:
    """Columnar MVCC entries over a fixed-capacity tile.

    key   : [cap, KW] uint8 zero-padded key bytes
    ts    : [cap] int64 version timestamp
    seq   : [cap] int64 write sequence (newest-sequence-wins among
            same-(key, ts) writes)
    txn   : [cap] int64 intent owner txn id; 0 = committed
    tomb  : [cap] bool deletion tombstone
    value : [cap, VW] uint8 fixed-width value payload
    vlen  : [cap] int32 logical value length
    mask  : [cap] bool row liveness
    """

    key: torch.Tensor
    ts: torch.Tensor
    seq: torch.Tensor
    txn: torch.Tensor
    tomb: torch.Tensor
    value: torch.Tensor
    vlen: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.mask.shape[0]

    @property
    def device(self) -> torch.device:
        return self.mask.device

    def map(self, fn) -> "KVBlock":
        """Apply ``fn`` to every field (the row-wise tree_map)."""
        return KVBlock(**{f: fn(getattr(self, f)) for f in FIELDS})

    def nbytes(self) -> int:
        return int(sum(getattr(self, f).numel()
                       * getattr(self, f).element_size() for f in FIELDS))


def concat_blocks(blocks) -> KVBlock:
    """Row-concatenation of blocks."""
    return KVBlock(**{f: torch.cat([getattr(b, f) for b in blocks], 0)
                      for f in FIELDS})


def empty_block(cap: int, key_width: int, val_width: int,
                device) -> KVBlock:
    return KVBlock(
        key=torch.zeros((cap, key_width), dtype=torch.uint8, device=device),
        ts=torch.zeros(cap, dtype=torch.int64, device=device),
        seq=torch.zeros(cap, dtype=torch.int64, device=device),
        txn=torch.zeros(cap, dtype=torch.int64, device=device),
        tomb=torch.zeros(cap, dtype=torch.bool, device=device),
        value=torch.zeros((cap, val_width), dtype=torch.uint8,
                          device=device),
        vlen=torch.zeros(cap, dtype=torch.int32, device=device),
        mask=torch.zeros(cap, dtype=torch.bool, device=device),
    )


def kvblock_from_numpy(fields: dict[str, np.ndarray], device) -> KVBlock:
    """The reference's KVBlock fields as numpy arrays -> a port KVBlock on
    `device` (same field names, dtypes and shapes)."""
    out = {}
    for f in FIELDS:
        a = np.ascontiguousarray(fields[f])
        t = torch.from_numpy(a.copy())
        if t.dtype != _DTYPES[f]:
            raise TypeError(f"KVBlock field {f!r}: dtype {a.dtype}, "
                            f"expected {_DTYPES[f]}")
        out[f] = t.to(device)
    cap = out["mask"].shape[0]
    for f, t in out.items():
        if t.shape[0] != cap or t.dim() != (2 if f in ("key", "value")
                                            else 1):
            raise ValueError(f"KVBlock field {f!r}: shape {tuple(t.shape)}")
    return KVBlock(**out)


def block_from_host(
    keys: np.ndarray,
    ts: np.ndarray,
    txn: np.ndarray,
    tomb: np.ndarray,
    value: np.ndarray,
    vlen: np.ndarray,
    cap: int | None = None,
    seq: np.ndarray | None = None,
    *,
    device,
) -> KVBlock:
    """Pad on the host, then one upload per field."""
    n = len(ts)
    cap = cap or max(1, n)
    if seq is None:
        seq = np.zeros(n, dtype=np.int64)

    def pad(a, dtype) -> torch.Tensor:
        a = np.asarray(a, dtype=dtype)
        out = np.zeros((cap,) + a.shape[1:], dtype=dtype)
        out[:n] = a
        return torch.from_numpy(out).to(device)

    mask = np.zeros(cap, np.bool_)
    mask[:n] = True
    return KVBlock(
        key=pad(keys, np.uint8),
        ts=pad(ts, np.int64),
        seq=pad(seq, np.int64),
        txn=pad(txn, np.int64),
        tomb=pad(tomb, np.bool_),
        value=pad(value, np.uint8),
        vlen=pad(vlen, np.int32),
        mask=torch.from_numpy(mask).to(device),
    )


# ---------------------------------------------------------------------------
# Sorting / merging


def _stable_argsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting rows by the int64 `keys`, first key most
    significant, ties kept in row order — ``lax.sort(..., is_stable=True)``
    as stable passes from the last key to the first."""
    n = keys[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def _mvcc_sort_operands(block: KVBlock) -> list[torch.Tensor]:
    """THE canonical MVCC sort key, as int64 operands whose signed
    ascending order is the reference operands' unsigned order: dead rows
    last, key words ascending, ts descending (``~ts``), seq descending."""
    words = key_words(block.key)
    operands = [(~block.mask).to(torch.int64)]
    operands += [flip(words[:, i]) for i in range(words.shape[1])]
    operands.append(~block.ts)
    operands.append(~block.seq)
    return operands


def sort_block(block: KVBlock) -> KVBlock:
    """Sort by (key asc, ts desc, seq desc), dead rows last."""
    p = _stable_argsort(_mvcc_sort_operands(block))
    return block.map(lambda x: x[p])


def merge_blocks(blocks: tuple[KVBlock, ...], cap: int) -> KVBlock:
    """K-way merge of sorted runs into one sorted tile of `cap` rows: one
    stable sort of the concatenation."""
    big = concat_blocks(blocks)
    total = big.capacity
    if total < cap:
        pad = empty_block(cap - total, big.key.shape[1], big.value.shape[1],
                          big.device)
        big = concat_blocks((big, pad))
    return sort_block(big)


# ---------------------------------------------------------------------------
# The scan filter


def _key_boundaries(block: KVBlock, window: int | None = None
                    ) -> torch.Tensor:
    """True on the first row of each key run. With `window`, every
    multiple-of-window position also starts a segment."""
    words = key_words(block.key)
    same = (words_cmp_eq(words[1:], words[:-1])
            & block.mask[1:] & block.mask[:-1])
    boundary = torch.cat([
        torch.ones(1, dtype=torch.bool, device=block.device), ~same])
    if window:
        pos = torch.arange(block.capacity, device=block.device)
        boundary = boundary | (pos % window == 0)
    return boundary


def mvcc_scan_filter(
    block: KVBlock,
    read_ts: int,
    reader_txn: int,
    start_words: torch.Tensor | None = None,
    end_words: torch.Tensor | None = None,
    window: int | None = None,
):
    """Newest-visible-version selection over a sorted block.

    Returns (selected, conflict) [cap] bool: the rows the scan returns, and
    other txns' intents at ts <= read_ts at or above the newest visible
    version of their key (WriteIntentError rows). `window` segments the
    block into independent scan windows."""
    cap = block.capacity
    words = key_words(block.key)
    in_range = block.mask & words_in_range(words, start_words, end_words)
    boundary = _key_boundaries(block, window)

    own = block.txn == reader_txn
    committed = block.txn == 0
    visible = in_range & ((committed & (block.ts <= read_ts))
                          | (own & (block.txn != 0)))

    pos = torch.arange(cap, dtype=torch.int32, device=block.device)
    cand_pos = torch.where(visible, pos, _BIG)
    first = segscan.seg_bcast("amin", cand_pos, boundary)
    newest = visible & (pos == first)

    conflict = (in_range & (block.txn != 0) & ~own
                & (block.ts <= read_ts) & (pos <= first))
    selected = newest & ~block.tomb
    return selected, conflict


def mvcc_gc_filter(block: KVBlock, gc_ts: int, bottom: bool) -> torch.Tensor:
    """Compaction GC: keep intents, versions with ts > gc_ts, and the
    newest version at or below gc_ts per key — unless `bottom` and it is a
    tombstone with nothing below it (tombstone elision at the last
    level)."""
    cap = block.capacity
    boundary = _key_boundaries(block)
    pos = torch.arange(cap, dtype=torch.int32, device=block.device)

    old = block.mask & (block.txn == 0) & (block.ts <= gc_ts)
    cand_pos = torch.where(old, pos, _BIG)
    first_old = segscan.seg_bcast("amin", cand_pos, boundary)
    newest_old = old & (pos == first_old)

    keep = block.mask & ((block.txn != 0) | (block.ts > gc_ts) | newest_old)
    if bottom:
        keep_pos = torch.where(keep, pos, -1)
        last_keep = segscan.seg_bcast("amax", keep_pos, boundary)
        elide = keep & block.tomb & newest_old & (pos == last_keep)
        keep = keep & ~elide
    return keep


# ---------------------------------------------------------------------------
# Batched multi-scan (the kv Streamer analog)


def seek_positions(view_words: torch.Tensor, query_words: torch.Tensor,
                   n_live) -> torch.Tensor:
    """First live row position with key >= query, per query — SeekGE over
    the sorted view as a branchless binary search clamped to n_live (dead
    rows sort past the live prefix but hold zero key bytes)."""
    n = view_words.shape[0]
    bits = max(1, int(n).bit_length())
    pos = torch.zeros(query_words.shape[:-1], dtype=torch.int32,
                      device=query_words.device)
    for sb in range(bits - 1, -1, -1):
        cand = pos + (1 << sb)
        rows = view_words[torch.clamp(cand - 1, 0, n - 1).long()]
        ok = (cand <= n_live) & words_cmp_lt(rows, query_words)
        pos = torch.where(ok, cand, pos)
    return pos


def _gather_stage(view: KVBlock, lo, n_live, window: int) -> KVBlock:
    n = view.capacity
    c = torch.arange(window, dtype=torch.int32, device=view.device)
    idx = lo[:, None] + c[None, :]  # [B, window]
    valid = idx < n_live
    idxc = torch.clamp(idx, 0, n - 1).reshape(-1).long()
    out = view.map(lambda x: x[idxc])
    return dataclasses.replace(out, mask=out.mask & valid.reshape(-1))


def _window_merge_stage(wins: tuple[KVBlock, ...], cuts, truncs,
                        window: int):
    """Merge S per-source windows per scan: concatenate along the window
    axis, then one stable sort keyed (scan id, canonical MVCC order).

    cuts: [S, B, W] per-source truncation cut keys; truncs: [S, B] bool.
    Returns (flat merged KVBlock of capacity B*(S*window), complete flags,
    truncated-per-scan)."""
    S = len(wins)
    B = truncs.shape[1]
    CW = S * window

    def cat(field):
        parts = [getattr(w, field).reshape((B, window)
                                           + getattr(w, field).shape[1:])
                 for w in wins]
        merged = torch.cat(parts, dim=1)
        return merged.reshape((B * CW,) + merged.shape[2:])

    blk = KVBlock(**{f: cat(f) for f in FIELDS})
    wid = torch.arange(B, dtype=torch.int64,
                       device=blk.device).repeat_interleave(CW)
    p = _stable_argsort([wid] + _mvcc_sort_operands(blk))
    blk = blk.map(lambda x: x[p])

    # a scan is truncated if ANY source cut it; rows at or past the
    # smallest cut key among truncated sources are withheld
    truncated = truncs.any(dim=0)  # [B]
    maxw = torch.full(cuts.shape[1:], -1, dtype=torch.int64,
                      device=blk.device)  # all-ones words
    cut = maxw
    for s in range(S):
        s_cut = torch.where(truncs[s][:, None], cuts[s], maxw)
        take = words_cmp_lt(s_cut, cut)
        cut = torch.where(take[:, None], s_cut, cut)
    wwords = key_words(blk.key).reshape(B, CW, -1)
    below = words_cmp_lt(wwords, cut[:, None, :])
    complete = (~truncated[:, None]) | below
    return blk, complete.reshape(-1), truncated


def _seek_cut_stage(src: KVBlock, starts_words, window: int):
    """Seek + cut-key extraction for one source."""
    vwords = key_words(src.key)
    n_live = torch.sum(src.mask, dtype=torch.int32)
    lo = seek_positions(vwords, starts_words, n_live)
    cut_idx = torch.clamp(lo + window - 1, 0, src.capacity - 1).long()
    return lo, n_live, vwords[cut_idx], (lo + window) < n_live


def _source_stage(src: KVBlock, starts_words, window: int):
    lo, n_live, cut, trunc = _seek_cut_stage(src, starts_words, window)
    return _gather_stage(src, lo, n_live, window), cut, trunc


def _filter_stage_flat(win: KVBlock, read_ts: int, reader_txn: int,
                       window: int):
    """Window filter through the scan-filter kernel wrapper when the shape
    passes the reference's gate (16-byte keys, window a multiple of 128,
    capacity a multiple of window); other shapes take mvcc_scan_filter,
    as in the reference."""
    if (win.key.shape[1] == 16 and window % 128 == 0
            and win.capacity % window == 0):
        from . import cuda_scan

        return cuda_scan.scan_filter(win, read_ts, reader_txn, window)
    return mvcc_scan_filter(win, read_ts, reader_txn, window=window)


def _emit_stage(blk: KVBlock, flags, B: int, max_keys: int):
    """Compact each window's selected rows to its first max_keys slots on
    the device: one sort by (window, ~selected, position)."""
    N = blk.capacity
    CW = N // B
    dev = blk.device
    wid = torch.arange(B, dtype=torch.int64, device=dev).repeat_interleave(CW)
    pos = torch.arange(N, dtype=torch.int64, device=dev)
    packed = (wid << 32) | ((~flags).to(torch.int64) << 31) | pos
    order = torch.sort(packed, stable=True).indices
    take = (torch.arange(B, dtype=torch.int64, device=dev)[:, None] * CW
            + torch.arange(max_keys, dtype=torch.int64,
                           device=dev)[None, :]).reshape(-1)
    idx = order[take]
    counts = torch.sum(flags.reshape(B, CW), dim=1, dtype=torch.int32)
    return (blk.key[idx].reshape(B, max_keys, -1),
            blk.value[idx].reshape(B, max_keys, -1),
            blk.vlen[idx].reshape(B, max_keys),
            counts)


def multi_scan_sources(
    sources: tuple[KVBlock, ...],
    starts_words: torch.Tensor,  # [B, W] int64
    read_ts: int,
    reader_txn: int,
    window: int,
):
    """B scans against S sorted sources (memtable block + runs) with no
    up-front store-wide merge: per-source seeks + window gathers, one
    window-local merge sort, one filter pass."""
    wins, cuts, truncs = [], [], []
    for src in sources:
        win, cut, trunc = _source_stage(src, starts_words, window)
        wins.append(win)
        cuts.append(cut)
        truncs.append(trunc)
    blk, complete, truncated = _window_merge_stage(
        tuple(wins), torch.stack(cuts), torch.stack(truncs), window)
    sel, conflict = _filter_stage_flat(blk, read_ts, reader_txn,
                                       len(sources) * window)
    return blk, sel, conflict, complete, truncated


# ---------------------------------------------------------------------------
# Intent resolution


def resolve_intents(block: KVBlock, txn_id: int, commit_ts: int,
                    commit: bool) -> KVBlock:
    """Commit (rewrite to committed at commit_ts) or abort (drop) all
    intents of one txn (MVCCResolveWriteIntent), blockwise."""
    is_intent = block.mask & (block.txn == txn_id) & (block.txn != 0)
    if commit:
        return dataclasses.replace(
            block,
            ts=torch.where(is_intent, commit_ts, block.ts),
            txn=torch.where(is_intent, 0, block.txn),
        )
    return dataclasses.replace(block, mask=block.mask & ~is_intent)

