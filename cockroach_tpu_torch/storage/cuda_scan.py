"""MVCC window scan filter — the CUDA kernel ``csrc/scan_filter.cu`` and
its wrapper (counterpart of ``cockroach_tpu.storage.pallas_scan``).

``scan_filter`` runs the whole pebbleMVCCScanner decision over the
batched-scan window layout (B windows of `window` lanes, one scan per
window, a key run never crossing a window edge) in one launch. On CPU
tensors it runs the plain version, ``mvcc.mvcc_scan_filter(...,
window=window)``; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import mvcc

_lib = None


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("scan_filter")
        p = ctypes.c_void_p
        i64 = ctypes.c_longlong
        lib.ct_scan_filter.argtypes = [p, p, p, p, p, i64, i64, i64, i64,
                                       p, p, p]
        lib.ct_scan_filter.restype = ctypes.c_int
        lib.ct_scan_filter_error.argtypes = [ctypes.c_int]
        lib.ct_scan_filter_error.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def scan_filter_plain(block: mvcc.KVBlock, read_ts: int, reader_txn: int,
                      window: int):
    return mvcc.mvcc_scan_filter(block, read_ts, reader_txn, window=window)


def _check(block: mvcc.KVBlock, window: int) -> None:
    n = block.capacity
    want = {"key": (torch.uint8, (n, 16)), "ts": (torch.int64, (n,)),
            "txn": (torch.int64, (n,)), "tomb": (torch.bool, (n,)),
            "mask": (torch.bool, (n,))}
    for f, (dtype, shape) in want.items():
        t = getattr(block, f)
        if t.device.type != "cuda" or t.device != block.key.device:
            raise ValueError(f"scan_filter: {f} on {t.device}, expected "
                             f"the key's CUDA device")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"scan_filter: {f} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"scan_filter: {f} is not contiguous")
    if block.key.data_ptr() % 16:
        raise ValueError("scan_filter: key rows must be 16-byte aligned")
    if window <= 0 or window % 128 or n % window:
        raise ValueError(f"scan_filter: capacity {n} and window {window} "
                         f"need window % 128 == 0 and capacity % window == 0")
    if window >= 2**31:
        raise ValueError("scan_filter: window must fit in int32")


def scan_filter(block: mvcc.KVBlock, read_ts: int, reader_txn: int,
                window: int):
    """(selected, conflict) [cap] bool for a window-packed block: capacity
    B*window, window % 128 == 0, 16-byte keys."""
    if block.key.device.type == "cpu":
        return scan_filter_plain(block, read_ts, reader_txn, window)
    _check(block, window)
    n = block.capacity
    sel = torch.empty(n, dtype=torch.bool, device=block.key.device)
    conf = torch.empty(n, dtype=torch.bool, device=block.key.device)
    if n == 0:
        return sel, conf
    lib = _kernel()
    stream = torch.cuda.current_stream(block.key.device).cuda_stream
    rc = lib.ct_scan_filter(
        block.key.data_ptr(), block.ts.data_ptr(), block.txn.data_ptr(),
        block.tomb.data_ptr(), block.mask.data_ptr(), int(read_ts),
        int(reader_txn), n // window, window, sel.data_ptr(),
        conf.data_ptr(), stream)
    if rc:
        raise RuntimeError("scan_filter kernel launch failed: "
                           + lib.ct_scan_filter_error(rc).decode())
    scan_filter.launches += 1
    return sel, conf


scan_filter.launches = 0
