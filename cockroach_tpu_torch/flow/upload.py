"""Double-buffered host -> device tile upload for streaming scans (the
host half of SURVEY §7's pipelining: a tile's copy overlaps the device
work of the tile before it).

On a CUDA device each column has two reused pinned host slots. A
single worker thread fills the next tile's slot (numpy copies release
the GIL) and issues its ``non_blocking`` copy on a dedicated copy stream,
recording an event; the consumer's stream waits on that event before it
uses the tile, and the tile's tensors are marked used on the consumer's
stream (``record_stream``) so the caching allocator does not hand their
memory back to the copy stream early. A slot is refilled only after the
copy out of it has completed: each time the worker must wait for that,
it counts one host wait. The consumer's own waits for a tile whose fill
has not finished are timed on the host clock (``fill_wait_s``). Copy
time is read back from timing events after the query. On the CPU the
tile is built in place (``from_host``).

The worker's counters (``h2d_bytes``, ``host_waits``, the copy timings)
are written under the stream's lock, and ``reset`` first waits for the
last fill it submitted: a prefetch a consumer abandoned (a LIMIT that
stopped the scan) is counted in the run that started it, never in the
next one.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..coldata.batch import Batch, Column, from_host
from ..coldata.types import Family, Schema


_copy_streams: dict = {}


def _copy_stream(device: torch.device) -> torch.cuda.Stream:
    """One copy stream per device, shared by every tile stream (a new
    stream per scan would cycle through torch's stream pool)."""
    s = _copy_streams.get(device)
    if s is None:
        s = _copy_streams[device] = torch.cuda.Stream(device)
    return s


# crlint: allow-mem-accounting(double-buffered stream tiles: two pinned host slots per column, their device copies and the padded tile's mask, bounded by the stream tile — at most 2^20 rows — and fixed for the stream's life)
class TileStream:
    """Tiles [off, off + tile) of host columns as device batches of
    capacity `tile` (the last one padded: zero data, invalid, dead)."""

    def __init__(self, schema: Schema, cols: dict, valids: dict,
                 nrows: int, tile: int, device: torch.device):
        self.schema = schema
        self.cols = cols
        self.valids = valids
        self.nrows = nrows
        self.tile = tile
        self.device = device
        self.cuda = device.type == "cuda"
        self.h2d_bytes = 0
        self.host_waits = 0
        self.fill_wait_s = 0.0
        self._timing: list = []
        self._mu = threading.Lock()
        self._last = None  # the worker's last submitted fill
        if self.cuda:
            self._copy = _copy_stream(device)
            self._worker = ThreadPoolExecutor(1)
            self._slots = [self._pinned_slot() for _ in range(2)]
            self._done = [None, None]  # each slot's last copy-out event
            self._full_mask = torch.ones(tile, dtype=torch.bool,
                                         device=device)

    def _pinned_slot(self) -> dict:
        slot = {}
        for name, t in zip(self.schema.names, self.schema.types):
            shape = ((self.tile, t.width) if t.family is Family.BYTES
                     else (self.tile,))
            data = torch.from_numpy(np.zeros(shape, dtype=t.dtype)).pin_memory()
            valid = (torch.zeros(self.tile, dtype=torch.bool).pin_memory()
                     if name in self.valids else None)
            slot[name] = (data, valid)
        return slot

    def reset(self) -> None:
        """Start of a run: wait for the last run's fills to finish (the
        worker runs them in order), then drop its counts and timings."""
        if self._last is not None:
            # an abandoned prefetch's failure belongs to the run that
            # abandoned it: wait, do not raise
            self._last.exception()
            self._last = None
        with self._mu:
            self._timing = []
            self.h2d_bytes = 0
            self.host_waits = 0
        self.fill_wait_s = 0.0

    def upload(self, off: int):
        """Start the upload of the tile at row `off`; returns a handle
        for ``get``."""
        n = min(self.tile, self.nrows - off)
        if not self.cuda:
            hi = off + n
            with self._mu:
                self.h2d_bytes += self._tile_bytes()
            return from_host(
                self.schema, {c: a[off:hi] for c, a in self.cols.items()},
                {c: v[off:hi] for c, v in self.valids.items()},
                capacity=self.tile, device=self.device)
        k = (off // self.tile) % 2
        self._last = self._worker.submit(self._fill_and_copy, k, off, n)
        return self._last

    def _tile_bytes(self) -> int:
        nb = 0
        for t in self.schema.types:
            nb += self.tile * (t.width if t.family is Family.BYTES
                               else np.dtype(t.dtype).itemsize)
        return nb + self.tile * len(self.valids)

    def _fill_and_copy(self, k: int, off: int, n: int):
        done = self._done[k]
        if done is not None and not done.query():
            with self._mu:
                self.host_waits += 1
            done.synchronize()
        slot = self._slots[k]
        hi = off + n
        for name in self.schema.names:
            data, valid = slot[name]
            buf = data.numpy()
            buf[:n] = self.cols[name][off:hi]
            if n < self.tile:
                buf[n:] = 0
            if valid is not None:
                vb = valid.numpy()
                vb[:n] = self.valids[name][off:hi]
                vb[n:] = False
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._copy):
            start.record(self._copy)
            out = {name: (d.to(self.device, non_blocking=True),
                          None if v is None
                          else v.to(self.device, non_blocking=True))
                   for name, (d, v) in slot.items()}
            end.record(self._copy)
        self._done[k] = end
        with self._mu:
            self._timing.append((start, end))
            self.h2d_bytes += self._tile_bytes()
        return out, end, n

    def get(self, handle) -> Batch:
        """The uploaded tile, usable on the current stream."""
        if not self.cuda:
            return handle
        t0 = time.perf_counter()
        out, end, n = handle.result()
        self.fill_wait_s += time.perf_counter() - t0
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(end)
        mask = (self._full_mask if n == self.tile
                else torch.arange(self.tile, device=self.device) < n)
        cols = []
        for name in self.schema.names:
            data, valid = out[name]
            data.record_stream(cur)
            if valid is None:
                valid = mask
            else:
                valid.record_stream(cur)
            cols.append(Column(data=data, valid=valid))
        return Batch(cols=tuple(cols), mask=mask)

    def copy_seconds(self) -> float:
        """Device time of this run's copies (call after a device sync)."""
        with self._mu:
            timing = list(self._timing)
        return sum(s.elapsed_time(e) for s, e in timing) / 1e3
