"""Segmented per-group reductions over sorted tiles — the port of
``cockroach_tpu.ops.segscan``.

Layout contract: rows are sorted so each segment is contiguous;
``boundary`` is True on the first row of every segment. Scans are
inclusive; a segment's total lives at its END row.

The reference picks segmented associative scans on the TPU and
``segment_*`` scatters on the CPU. The port's aggregation takes the
scatter form on every device (``scatter_reduce`` / ``index_add_`` over
segment ids); the scans here are the same functions for callers that
need per-row prefixes, computed by a log-step (Hillis-Steele) scan with
the reference's segmented combine, exact for integer operators.
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


def seg_scan_multi(ops, vals_list, boundary: torch.Tensor,
                   reverse: bool = False) -> list[torch.Tensor]:
    """Inclusive segmented scans of several value tensors sharing one
    segment structure. ``ops`` are elementwise associative combiners
    (torch.add, torch.minimum, ...), each called as op(earlier, later).

    boundary[i]=True starts a new segment at i in scan direction (with
    reverse=True, boundaries mark segment starts of the REVERSED order)."""
    if reverse:
        boundary = boundary.flip(0)
        vals_list = [v.flip(0) for v in vals_list]
    flags = boundary.clone()
    vals = [v.clone() for v in vals_list]
    n = boundary.shape[0]
    d = 1
    while d < n:
        f_hi = flags[d:]
        vals = [
            torch.cat([v[:d], torch.where(f_hi, v[d:], op(v[:-d], v[d:]))])
            for op, v in zip(ops, vals)
        ]
        flags = torch.cat([flags[:d], f_hi | flags[:-d]])
        d *= 2
    if reverse:
        vals = [v.flip(0) for v in vals]
    return vals


def seg_scan(op, vals: torch.Tensor, boundary: torch.Tensor,
             reverse: bool = False) -> torch.Tensor:
    """Inclusive segmented scan of `vals` with associative `op`."""
    return seg_scan_multi([op], [vals], boundary, reverse=reverse)[0]


def seg_ends(boundary: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """True on the LAST live row of each segment. Dead rows must be sorted
    after live rows (the engine's canonical groupby sort order)."""
    nxt_boundary = torch.cat(
        [boundary[1:], torch.ones(1, dtype=torch.bool, device=boundary.device)])
    nxt_live = torch.cat(
        [live[1:], torch.zeros(1, dtype=torch.bool, device=live.device)])
    return live & (nxt_boundary | ~nxt_live)


def totals_everywhere(scanned: torch.Tensor, boundary: torch.Tensor,
                      live: torch.Tensor) -> torch.Tensor:
    """Broadcast each segment's inclusive-scan END value over the whole
    segment: a reverse copy-scan seeded at segment ends."""
    ends = seg_ends(boundary, live)
    seeded = torch.where(ends, scanned, torch.zeros_like(scanned))
    return seg_scan(lambda acc, cur: acc, seeded, ends, reverse=True)


def compact_to_slots(is_wanted: torch.Tensor, cap_out: int) -> torch.Tensor:
    """Positions of the wanted rows, compacted to the front in row order
    (garbage past the wanted count). A stable sort by ~is_wanted."""
    cap = is_wanted.shape[0]
    order = torch.sort((~is_wanted).to(torch.int8), stable=True).indices
    if cap_out <= cap:
        return order[:cap_out]
    return torch.cat([order, torch.zeros(cap_out - cap, dtype=order.dtype,
                                         device=order.device)])
