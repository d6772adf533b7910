"""cockroach_tpu_torch — the PyTorch/CUDA port of cockroach_tpu.

The JAX package (``cockroach_tpu``) is the reference; this package is its
port to PyTorch with hand-written CUDA kernels for an NVIDIA Hopper card
(H100, ``sm_90a``). It imports nothing from ``cockroach_tpu`` and nothing
of JAX: what it needs of the reference's device-free modules it carries as
its own copies.

Slice 1 covers the MVCC LSM storage engine under the YCSB-E workload:

- ``storage.lsm.Engine``: WAL, memtable, bulk ingest, flush, size-tiered
  compaction, bounded and batched scans, point gets, intent resolution;
- ``storage.cuda_scan``: the MVCC window scan filter (CUDA kernel
  ``csrc/scan_filter.cu``);
- ``storage.cuda_merge``: the LSM run merge (CUDA merge-path kernel
  ``csrc/merge_path.cu``);
- ``bench.ycsb.run_ycsb_e``: the YCSB-E workload.

The SQL slice runs the vectorized executor as far as TPC-H Q1 and Q3:

- ``coldata``, ``catalog``: columnar tiles and the resident table catalog
  (``catalog.catalog_from_host`` loads tables given as numpy arrays);
- ``ops``: expressions, sort keys and sorts, sort-based and dense
  aggregation, unique-build joins;
- ``flow``, ``plan``, ``sql.rel``: the operators, the runtime
  (``flow.runtime.run_operator``), the plan builder and ``Rel``;
- ``bench.tpch``, ``bench.queries``, ``bench.tpch_run.run_tpch``: the
  seeded TPC-H generator, q1 and q3, and their timed, oracle-checked
  runs (``bench.tpch_oracle``).

Every entry point takes ``device=`` and defaults to ``"cuda"``; without a
card it raises unless the caller passes ``device="cpu"``. On CPU tensors
each kernel wrapper runs its plain PyTorch version; on CUDA tensors it
launches its kernel or raises.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
