"""Storage layer — MVCC kernels + LSM engine on PyTorch/CUDA.

Counterparts in ``cockroach_tpu.storage``:
- ``mvcc.mvcc_scan_filter``  <- the pebbleMVCCScanner hot loop, vectorized;
  the batched-scan window filter runs as the CUDA kernel in
  ``cuda_scan`` (counterpart of ``pallas_scan``).
- ``mvcc.merge_blocks``      <- the k-way merge as one stable sort; the
  compaction and bulk-ingest merges run as the CUDA merge-path merge in
  ``cuda_merge`` (counterpart of ``pallas_merge``).
- ``lsm.Engine``             <- the Pebble wrapper: WAL, memtable, sorted
  runs, compaction, reads.
"""

from .keys import DEFAULT_KEY_WIDTH, decode_keys, encode_keys
from .lsm import Engine, MVCCStats, WriteIntentError
from .mvcc import KVBlock, merge_blocks, mvcc_scan_filter, sort_block

__all__ = [
    "DEFAULT_KEY_WIDTH", "decode_keys", "encode_keys",
    "Engine", "MVCCStats", "WriteIntentError",
    "KVBlock", "merge_blocks", "mvcc_scan_filter", "sort_block",
]
