"""Bulk ingest — device-built sorted runs (the AddSSTable client half;
counterpart of ``cockroach_tpu.storage.ingest``).

``RunBuilder`` buffers host column batches; at ``target_rows`` they
upload once, sort per batch with ``mvcc.sort_block``, merge with the
merge-path kernel (``cuda_merge``) when eligible (concat + sort otherwise),
dedup in one pass, and land in the LSM as one run through
``Engine.ingest(presorted=True)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import cuda_merge
from . import keys as K
from . import mvcc
from .lsm import _pad


def enabled() -> bool:
    """Route bulk loads through the run builder?"""
    from ..utils import settings

    return bool(settings.get("storage.bulk_ingest.enabled"))


# crlint: allow-mem-accounting(storage-plane kernel: one bool lane shaped like the sorted block already resident)
def _dedup_sorted(block: mvcc.KVBlock) -> mvcc.KVBlock:
    """Mask away same-key duplicates in a canonically sorted block,
    keeping the first row of each key group (the latest-added batch's:
    rows carry their batch index as seq, sorted seq-desc within a key)."""
    words = K.key_words(block.key)
    same = (K.words_cmp_eq(words[1:], words[:-1])
            & block.mask[1:] & block.mask[:-1])
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=block.device),
                     same])
    return dataclasses.replace(block, mask=block.mask & ~dup)


class RunBuilder:
    """Accumulate host column batches into device-built sorted runs.
    Later-added batches win duplicate keys."""

    def __init__(self, engine, ts: int, target_rows: int = 1 << 18):
        self.engine = engine
        self.ts = int(ts)
        self.target_rows = int(target_rows)
        self._batches: list[tuple[np.ndarray, np.ndarray,
                                  np.ndarray | None]] = []
        self._pending = 0
        self.rows = 0
        self.runs = 0

    def add(self, keys, values, vlens=None) -> None:
        keys = np.asarray(keys, dtype=np.uint8)
        values = np.asarray(values, dtype=np.uint8)
        if len(keys) == 0:
            return
        if keys.shape[1] > self.engine.key_width:
            raise ValueError(
                f"key width {keys.shape[1]} > engine {self.engine.key_width}")
        if values.shape[1] > self.engine.val_width:
            raise ValueError(
                f"val width {values.shape[1]} > engine {self.engine.val_width}")
        vl = None if vlens is None else np.asarray(vlens, dtype=np.int32)
        self._batches.append((keys, values, vl))
        self._pending += len(keys)
        if self._pending >= self.target_rows:
            self._flush()

    def _block_for(self, kb_in, vb_in, vl_in, seq: int) -> mvcc.KVBlock:
        eng = self.engine
        dev = eng.device
        n = len(kb_in)
        cap = _pad(n)
        from ..flow import memory as flowmem

        # host padding buffers live until the upload; the merged run's
        # residency is charged by Engine.ingest
        est = cap * (eng.key_width + eng.val_width + 4)
        with flowmem.staged("storage/ingest-staging", est):
            kb = np.zeros((cap, eng.key_width), np.uint8)
            kb[:n, : kb_in.shape[1]] = kb_in
            vb = np.zeros((cap, eng.val_width), np.uint8)
            vb[:n, : vb_in.shape[1]] = vb_in
            vl = np.zeros(cap, np.int32)
            vl[:n] = vb_in.shape[1] if vl_in is None else vl_in
            return mvcc.KVBlock(
                key=torch.from_numpy(kb).to(dev),
                ts=torch.full((cap,), self.ts, dtype=torch.int64, device=dev),
                seq=torch.full((cap,), seq, dtype=torch.int64, device=dev),
                txn=torch.zeros(cap, dtype=torch.int64, device=dev),
                tomb=torch.zeros(cap, dtype=torch.bool, device=dev),
                value=torch.from_numpy(vb).to(dev),
                vlen=torch.from_numpy(vl).to(dev),
                mask=torch.arange(cap, device=dev) < n,
            )

    def _merge(self, blocks: tuple) -> mvcc.KVBlock:
        if len(blocks) == 1:
            return blocks[0]
        # the compaction merge picker's rule: the merge-path kernel when
        # eligible, concat + sort otherwise
        if self.engine.key_width == 16 and cuda_merge.eligible(blocks):
            return cuda_merge.merge_runs(blocks)
        total = sum(b.capacity for b in blocks)
        return mvcc.merge_blocks(blocks, cap=_pad(total))

    def _flush(self) -> None:
        if not self._batches:
            return
        blocks = tuple(
            mvcc.sort_block(self._block_for(kb, vb, vl, seq=i + 1))
            for i, (kb, vb, vl) in enumerate(self._batches))
        self._batches.clear()
        self._pending = 0
        merged = _dedup_sorted(self._merge(blocks))
        # live rows to the host in canonical order: the engine needs host
        # arrays for the WAL side file anyway
        m = merged.mask
        keys = merged.key[m].cpu().numpy()
        if len(keys) == 0:
            return
        vals = merged.value[m].cpu().numpy()
        vlens = merged.vlen[m].cpu().numpy()
        self.engine.ingest(keys, vals, self.ts, vlens=vlens, presorted=True)
        self.rows += len(keys)
        self.runs += 1

    def finish(self) -> dict:
        """Flush the tail batch and report {rows, runs} landed."""
        self._flush()
        return {"rows": self.rows, "runs": self.runs}
