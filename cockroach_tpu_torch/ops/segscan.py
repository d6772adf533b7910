"""Segmented per-group reductions over sorted tiles — ``seg_bcast`` of
``cockroach_tpu.ops.segscan``.

The reference picks segmented associative scans on the TPU and
``segment_min/max`` scatters on the CPU; both give the same result, so
the port takes the scatter form (``scatter_reduce`` over segment ids) on
every device.
"""

from __future__ import annotations

import torch


def seg_bcast(reduce: str, vals: torch.Tensor, boundary: torch.Tensor
              ) -> torch.Tensor:
    """Per-segment total of `vals` under `reduce` ("amin" or "amax"),
    broadcast to every row of its segment. ``boundary`` is True on the
    first row of each contiguous segment (and must be True at row 0)."""
    seg = torch.cumsum(boundary.to(torch.int64), 0) - 1
    info = torch.iinfo(vals.dtype)
    init = info.max if reduce == "amin" else info.min
    tot = torch.full_like(vals, init)
    tot = tot.scatter_reduce(0, seg, vals, reduce, include_self=True)
    return tot[seg]
