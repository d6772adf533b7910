"""Join kernels — the colexecjoin analog; the port of the unique-build
half of ``cockroach_tpu.ops.join``.

A unique-build join finds, for every probe row, the one build row with an
equal key, by one of three strategies (all exact, all probe-aligned):

- dense analytic: the build table's first key column IS an affine
  function of the row index (TPC-H primary keys), so the build row index
  is arithmetic: no index at all;
- dense LUT: the exact packed key (``plan_exact_key``) fits in
  ``sql.distsql.dense_lut_bits``; a direct-addressed table of build positions is
  scattered once per build side and each probe is one gather;
- sorted index: the packed keys sorted once per build side
  (``build_index``), each probe a binary search (``bsearch``).

When a key column is unbounded (FLOAT, or no catalog stats) there is no
exact packed key: the sorted index holds 64-bit row hashes
(``ops/hashing``) and every candidate in a probe's run of equal hashes
is verified column by column (``_keys_equal``).

Duplicate build keys go through ``hash_join_general``: each probe row's
matches are its run ``[lo, hi)`` in the sorted index (filtered by key
equality under hashed keys), emitted probe row first, then sorted build
position, into an output tile sized from the total after a host sync.

Packed keys and hashes follow the port's uint64 convention (int64 bit
patterns, unsigned order after flipping bit 63); NULL-key and dead rows
carry the all-ones sentinel, which no packed key (at most 63 bits) can
equal.

SQL semantics: NULL join keys never match; anti-join keeps NULL-key
probe rows (NOT EXISTS semantics).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..coldata.batch import Batch, Column, device_table, scatter_rows
from ..coldata.types import Family, Schema
from ..storage.keys import flip
from .hashing import hash_columns
from .keys import bits_for_count

_SENTINEL = -1  # the uint64 all-ones word as an int64 bit pattern


@dataclass(frozen=True)
class JoinSpec:
    join_type: str = "inner"  # inner | left | semi | anti
    build_unique: bool = True


# ---------------------------------------------------------------------------
# Exact packed join keys


@dataclass(frozen=True)
class ExactKeyLayout:
    """Per key position: (kind, lo, bits). kind 'int' encodes (x - lo);
    kind 'str' uses probe dictionary codes (build codes remapped host-side,
    absent values -> the never-matching code 2**bits - 1)."""

    segs: tuple[tuple[str, int, int], ...]
    total_bits: int


def plan_exact_key(
    probe_schema: Schema,
    probe_keys: tuple[int, ...],
    build_schema: Schema,
    build_keys: tuple[int, ...],
    probe_stats: dict | None,
    build_stats: dict | None,
    probe_dict_sizes: dict | None,
    have_remaps: bool,
) -> ExactKeyLayout | None:
    """Try to plan an exact packed key; None when any column is unbounded."""
    probe_stats = probe_stats or {}
    build_stats = build_stats or {}
    probe_dict_sizes = probe_dict_sizes or {}
    segs = []
    total = 0
    for pk, bk in zip(probe_keys, build_keys):
        t = probe_schema.types[pk]
        if t.family is Family.STRING:
            if not have_remaps or pk not in probe_dict_sizes:
                return None
            n = probe_dict_sizes[pk]
            segs.append(("str", 0, bits_for_count(n + 2)))
        elif t.family in (Family.FLOAT, Family.BYTES, Family.JSON):
            return None
        elif t.family is Family.BOOL:
            segs.append(("int", 0, 1))
        else:
            ps = probe_stats.get(pk)
            bs = build_stats.get(bk)
            if ps is None or bs is None:
                return None
            lo = min(int(ps[0]), int(bs[0]))
            hi = max(int(ps[1]), int(bs[1]))
            segs.append(("int", lo, bits_for_count(hi - lo + 1)))
        total += segs[-1][2]
    if total > 63:
        return None
    return ExactKeyLayout(tuple(segs), total)


def exact_keys(
    batch: Batch,
    keys: tuple[int, ...],
    layout: ExactKeyLayout,
    code_remaps: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(packed key, active) — NULL-key and dead rows get the sentinel."""
    dev = batch.device
    k = torch.zeros(batch.capacity, dtype=torch.int64, device=dev)
    active = batch.mask
    for pos, (ki, (kind, lo, bits)) in enumerate(zip(keys, layout.segs)):
        c = batch.cols[ki]
        active = active & c.valid
        if kind == "str":
            v = c.data.to(torch.int64)
            if code_remaps is not None and pos in code_remaps:
                remap = device_table(code_remaps[pos], dev).to(torch.int64)
                v = remap[torch.clamp(v, 0, remap.shape[0] - 1)]
            # absent-in-probe-dict (-1) -> the never-matching top code
            v = torch.where(v < 0, (1 << bits) - 1, v)
        else:
            v = c.data.to(torch.int64) - lo
        k = (k << bits) | (v & ((1 << bits) - 1))
    return torch.where(active, k, _SENTINEL), active


# ---------------------------------------------------------------------------
# Dense direct addressing


@dataclass(frozen=True)
class DenseAnalytic:
    """Build row index = (first_key - key_lo) * fanout + j, j in [0, fanout);
    the remaining key positions are checked for equality."""

    key_lo: int
    fanout: int
    build_rows: int  # fanout * number-of-distinct-first-keys (live prefix)


def _keys_equal(probe: Batch, pkeys, build: Batch, bkeys, bidx,
                build_remaps=None, pidx=None):
    """Exact key equality probe[i] == build[bidx[i]] per row (per pair
    probe[pidx[j]] == build[bidx[j]] when `pidx` is given); build_remaps
    maps build dictionary codes into the probe column's code space."""
    build_remaps = build_remaps or {}
    eq = torch.ones(bidx.shape[0], dtype=torch.bool, device=probe.device)
    for pos, (pk, bk) in enumerate(zip(pkeys, bkeys)):
        pc = probe.cols[pk]
        bc = build.cols[bk]
        pdata, pvalid = pc.data, pc.valid
        if pidx is not None:
            pdata, pvalid = pdata[pidx], pvalid[pidx]
        bdata = bc.data[bidx]
        if pos in build_remaps:
            remap = device_table(build_remaps[pos], probe.device)
            bdata = remap[torch.clamp(bdata.to(torch.int64), 0,
                                      remap.shape[0] - 1)]
        eq = eq & (pdata == bdata) & pvalid & bc.valid[bidx]
    return eq


def dense_analytic_probe(
    probe: Batch,
    probe_keys: tuple[int, ...],
    build: Batch,
    build_keys: tuple[int, ...],
    info: DenseAnalytic,
    build_code_remaps=None,
):
    """(found_idx, found) for unique-build joins via direct addressing."""
    k0 = probe.cols[probe_keys[0]]
    base = (k0.data.to(torch.int64) - info.key_lo) * info.fanout
    active = probe.mask & k0.valid
    in_range = active & (base >= 0) & (base < info.build_rows)
    base_c = torch.clamp(base, 0, build.capacity - 1)
    rest_p = probe_keys[1:]
    rest_b = build_keys[1:]
    rest_remaps = None
    if build_code_remaps:
        rest_remaps = {
            pos - 1: r for pos, r in build_code_remaps.items() if pos >= 1
        }
    found = torch.zeros(probe.capacity, dtype=torch.bool, device=probe.device)
    found_idx = torch.zeros(probe.capacity, dtype=torch.int64,
                            device=probe.device)
    for j in range(info.fanout):
        idx = torch.clamp(base_c + j, max=build.capacity - 1)
        ok = in_range & build.mask[idx]
        if rest_p:
            ok = ok & _keys_equal(probe, rest_p, build, rest_b, idx,
                                  rest_remaps)
        found_idx = torch.where(ok & ~found, idx, found_idx)
        found = found | ok
    return found_idx, found


def build_dense_lut(
    build: Batch,
    build_keys: tuple[int, ...],
    layout: ExactKeyLayout,
    exact_remaps=None,
) -> torch.Tensor:
    """[2**total_bits] int32 build positions (-1 absent). Dead/NULL rows
    carry the sentinel key and drop out of the scatter."""
    bk, _ = exact_keys(build, build_keys, layout, exact_remaps)
    size = 1 << layout.total_bits
    dest = torch.where((bk >= 0) & (bk < size), bk, size)
    lut = torch.full((size + 1,), -1, dtype=torch.int32, device=build.device)
    pos = torch.arange(build.capacity, dtype=torch.int32, device=build.device)
    lut.index_copy_(0, dest, pos)
    return lut[:size]


def dense_lut_probe(
    probe: Batch,
    probe_keys: tuple[int, ...],
    layout: ExactKeyLayout,
    lut: torch.Tensor,
):
    """(found_idx, found): one gather; packed-key equality IS key equality."""
    ph, p_active = exact_keys(probe, probe_keys, layout)
    size = lut.shape[0]
    in_lut = (ph >= 0) & (ph < size)
    idx = lut[torch.where(in_lut, ph, 0)].to(torch.int64)
    found = p_active & in_lut & (idx >= 0)
    return torch.clamp(idx, min=0), found


def emit_unique(probe: Batch, build: Batch, spec: JoinSpec,
                found_idx, found) -> Batch:
    """Probe-aligned emission shared by every unique-build strategy."""
    if spec.join_type == "semi":
        return probe.with_mask(probe.mask & found)
    if spec.join_type == "anti":
        return probe.with_mask(probe.mask & ~found)
    bcols = tuple(
        Column(data=c.data[found_idx], valid=c.valid[found_idx] & found)
        for c in build.cols
    )
    if spec.join_type == "inner":
        mask = probe.mask & found
    elif spec.join_type == "left":
        mask = probe.mask
    else:
        raise ValueError(f"unsupported join type {spec.join_type}")
    return Batch(cols=probe.cols + bcols, mask=mask)


def bsearch(sorted_keys: torch.Tensor, queries: torch.Tensor,
            side: str = "left") -> torch.Tensor:
    """Insertion points of `queries` in the ascending (unsigned) word array
    `sorted_keys`, in [0, n]."""
    return torch.searchsorted(flip(sorted_keys), flip(queries), side=side)


def _key_hashes(batch: Batch, keys: tuple[int, ...], schema: Schema,
                hash_tables):
    """(row hash, active): dead and NULL-key rows, which can never match,
    get the sentinel."""
    cols = [batch.cols[i] for i in keys]
    types = [schema.types[i] for i in keys]
    h = hash_columns(cols, types, hash_tables)
    all_valid = batch.mask
    for c in cols:
        all_valid = all_valid & c.valid
    return torch.where(all_valid, h, _SENTINEL), all_valid


def build_index(
    build: Batch, schema: Schema, keys: tuple[int, ...], hash_tables=None,
    exact_layout: ExactKeyLayout | None = None, exact_remaps=None,
):
    """Sort build rows by key (the exact packed key when the layout
    allows, else the 64-bit row hash) -> (sorted_keys, orig_index).
    NULL-key and dead rows carry the max sentinel and sort to the end."""
    if exact_layout is not None:
        if (exact_remaps is None
                and any(k == "str" for k, _, _ in exact_layout.segs)):
            raise ValueError(
                "exact STRING join keys need build-code remaps (pass "
                "exact_remaps or a precomputed index)")
        bh, _ = exact_keys(build, keys, exact_layout, exact_remaps)
    else:
        bh, _ = _key_hashes(build, keys, schema, hash_tables)
    order = torch.sort(flip(bh), stable=True).indices
    return bh[order], order


def _probe_runs(probe, probe_schema, probe_keys, sh, exact_layout,
                probe_hash_tables):
    """(lo, run, active): each probe row's run [lo, lo + run) of equal
    keys (or hashes) in the sorted index; inactive rows have run 0."""
    if exact_layout is not None:
        ph, p_active = exact_keys(probe, probe_keys, exact_layout)
    else:
        ph, p_active = _key_hashes(probe, probe_keys, probe_schema,
                                   probe_hash_tables)
    lo = bsearch(sh, ph, side="left")
    hi = bsearch(sh, ph, side="right")
    return lo, torch.where(p_active, hi - lo, 0), p_active


def hash_join_unique(
    probe: Batch,
    probe_schema: Schema,
    probe_keys: tuple[int, ...],
    build: Batch,
    build_schema: Schema,
    build_keys: tuple[int, ...],
    spec: JoinSpec,
    probe_hash_tables=None,
    build_hash_tables=None,
    build_code_remaps=None,
    index=None,
    exact_layout: ExactKeyLayout | None = None,
    exact_remaps=None,
    sync=int,
) -> Batch:
    """Join with unique build keys through the sorted index. Output tile
    is probe-capacity: probe columns followed by build columns (semi/anti:
    probe columns only). `index` is an optional precomputed build_index()
    result so the build sort runs once per build side.

    With an exact layout the probe is one binary search and one compare.
    With hashed keys every candidate of the probe's run of equal hashes
    is verified column by column and the first equal one wins; the
    longest run bounds the steps, read through `sync` (one host sync)."""
    bcap = build.capacity
    sh, order = index if index is not None else build_index(
        build, build_schema, build_keys, build_hash_tables,
        exact_layout=exact_layout, exact_remaps=exact_remaps,
    )
    if exact_layout is not None:
        ph, p_active = exact_keys(probe, probe_keys, exact_layout)
        pos = bsearch(sh, ph, side="left")
        posc = torch.clamp(pos, 0, bcap - 1)
        found_idx = order[posc]
        found = (pos < bcap) & (sh[posc] == ph) & p_active
        found = found & build.mask[found_idx]
        return emit_unique(probe, build, spec, found_idx, found)
    lo, run, p_active = _probe_runs(probe, probe_schema, probe_keys, sh,
                                    None, probe_hash_tables)
    found = torch.zeros(probe.capacity, dtype=torch.bool,
                        device=probe.device)
    found_idx = torch.zeros(probe.capacity, dtype=torch.int64,
                            device=probe.device)
    for k in range(sync(run.max())):
        bidx = order[torch.clamp(lo + k, 0, bcap - 1)]
        hit = (k < run) & ~found & _keys_equal(
            probe, probe_keys, build, build_keys, bidx, build_code_remaps)
        found_idx = torch.where(hit, bidx, found_idx)
        found = found | hit
    found = found & p_active & build.mask[found_idx]
    return emit_unique(probe, build, spec, found_idx, found)


def hash_join_general(
    probe: Batch,
    probe_schema: Schema,
    probe_keys: tuple[int, ...],
    build: Batch,
    build_schema: Schema,
    build_keys: tuple[int, ...],
    spec: JoinSpec,
    out_capacity,
    probe_hash_tables=None,
    build_hash_tables=None,
    build_code_remaps=None,
    index=None,
    exact_layout: ExactKeyLayout | None = None,
    exact_remaps=None,
    sync=int,
):
    """General join (duplicate build keys) -> (out_batch, total_rows).

    Semi and anti joins are probe-aligned (total: the rows kept). Inner
    and left joins emit the m-th match of probe row i at slot
    base[i] + m (base: the exclusive prefix sum of the rows each probe
    row emits; a left join's unmatched live row emits one null-extended
    row at its base slot), so output is ordered by probe row, then sorted
    build position. `out_capacity` is the output tile's capacity, or a
    function of the total that gives it; rows past it are dropped (the
    caller compares total to it). Device scalars become host ints
    through `sync`: the total, when `out_capacity` is a function (with
    a static capacity the total is returned as a device scalar, and an
    exact-key join then reads nothing on the host), and under hashed
    keys the candidate pairs, which are verified column by column."""
    cap = probe.capacity
    bcap = build.capacity
    dev = probe.device
    sh, order = index if index is not None else build_index(
        build, build_schema, build_keys, build_hash_tables,
        exact_layout=exact_layout, exact_remaps=exact_remaps,
    )
    lo, run, p_active = _probe_runs(probe, probe_schema, probe_keys, sh,
                                    exact_layout, probe_hash_tables)
    rows = torch.arange(cap, device=dev)
    if exact_layout is not None:
        # packed-key equality is exact: the [lo, hi) run IS the match set
        cnt = run

        def match_b(p, m):
            return order[torch.clamp(lo[p] + m, 0, bcap - 1)]
    else:
        # expand every candidate pair (probe row, run position), keep the
        # pairs whose key columns are equal, in pair order
        n = sync(run.sum())
        pair_p = torch.repeat_interleave(rows, run, output_size=n)
        cbase = torch.cumsum(run, 0) - run
        pair_b = order[torch.clamp(
            lo[pair_p] + torch.arange(n, device=dev) - cbase[pair_p],
            0, bcap - 1)]
        eq = _keys_equal(probe, probe_keys, build, build_keys, pair_b,
                         build_code_remaps, pidx=pair_p) & build.mask[pair_b]
        eq64 = eq.to(torch.int64)
        cnt = torch.zeros(cap, dtype=torch.int64, device=dev).index_add_(
            0, pair_p, eq64)
        dest = torch.where(eq, torch.cumsum(eq64, 0) - eq64, n)
        matched = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        matched.index_copy_(0, dest, pair_b)
        mbase = torch.cumsum(cnt, 0) - cnt

        def match_b(p, m):
            return matched[torch.clamp(mbase[p] + m, 0, n)]

    if spec.join_type == "semi":
        keep = probe.mask & (cnt > 0)
        return probe.with_mask(keep), keep.sum(dtype=torch.int64)
    if spec.join_type == "anti":
        keep = probe.mask & (cnt == 0)
        return probe.with_mask(keep), keep.sum(dtype=torch.int64)
    if spec.join_type not in ("inner", "left"):
        raise ValueError(f"unsupported join type {spec.join_type}")
    out_rows = cnt
    if spec.join_type == "left":
        out_rows = torch.where(probe.mask, torch.clamp(cnt, min=1), cnt)
    incl = torch.cumsum(out_rows, 0)
    base = incl - out_rows
    if callable(out_capacity):
        total = sync(out_rows.sum())
        oc = out_capacity(total)
        keep = min(total, oc)
        out_p = torch.zeros(oc, dtype=torch.int64, device=dev)
        out_p[:keep] = torch.repeat_interleave(rows, out_rows,
                                               output_size=total)[:keep]
        slot = torch.arange(oc, device=dev)
        out_live = slot < keep
    else:
        # a static capacity: no host sync. Output slot s belongs to the
        # probe row whose [base, incl) range holds it (what
        # repeat_interleave gives), found by binary search; the true
        # total stays a device scalar, for the caller to check later
        oc = out_capacity
        total = out_rows.sum()
        slot = torch.arange(oc, device=dev)
        out_p = torch.clamp(torch.searchsorted(incl, slot, right=True),
                            max=cap - 1)
        out_live = slot < total
    m = slot - base[out_p]
    out_found = out_live & (m < cnt[out_p])
    out_b = match_b(out_p, m)
    pcols = tuple(
        Column(data=c.data[out_p], valid=c.valid[out_p] & out_live)
        for c in probe.cols
    )
    bcols = tuple(
        Column(data=c.data[out_b], valid=c.valid[out_b] & out_found)
        for c in build.cols
    )
    return Batch(cols=pcols + bcols, mask=out_live), total


def hash_join_static(
    probe: Batch,
    probe_schema: Schema,
    probe_keys: tuple[int, ...],
    build: Batch,
    build_schema: Schema,
    build_keys: tuple[int, ...],
    spec: JoinSpec,
    out_capacity: int,
    steps: int,
    probe_hash_tables=None,
    build_hash_tables=None,
    build_code_remaps=None,
):
    """A hashed-key join that reads nothing on the host, for a program
    captured whole (the distributed lowering) -> (batch, excess), with
    `excess` a device count that is 0 when the output is exact.

    - Unique builds, semi and anti joins are probe-aligned: each probe
      row verifies at most `steps` candidates of its run of equal hashes
      (the first key-equal one wins). Absent a 64-bit hash collision the
      first candidate has the probe's key, so one step is exact; probes
      whose run outlasts `steps` unresolved count into `excess`.
    - Inner and left joins over duplicate keys verify their candidate
      pairs in a pair tile of `out_capacity` slots and emit into an
      output tile of `out_capacity`; `excess` is the rows past it
      (``max(total - out_capacity, 0)``), the total taken from the runs
      when the candidates overflow the pair tile (absent collisions the
      runs are the matches)."""
    cap = probe.capacity
    bcap = build.capacity
    dev = probe.device
    sh, order = build_index(build, build_schema, build_keys,
                            build_hash_tables)
    lo, run, p_active = _probe_runs(probe, probe_schema, probe_keys, sh,
                                    None, probe_hash_tables)
    if spec.build_unique or spec.join_type in ("semi", "anti"):
        found = torch.zeros(cap, dtype=torch.bool, device=dev)
        found_idx = torch.zeros(cap, dtype=torch.int64, device=dev)
        for k in range(steps):
            bidx = order[torch.clamp(lo + k, 0, bcap - 1)]
            hit = (k < run) & ~found & _keys_equal(
                probe, probe_keys, build, build_keys, bidx,
                build_code_remaps)
            found_idx = torch.where(hit, bidx, found_idx)
            found = found | hit
        unresolved = (p_active & ~found & (run > steps)).sum(
            dtype=torch.int64)
        found = found & p_active & build.mask[found_idx]
        return emit_unique(probe, build, spec, found_idx, found), unresolved
    if spec.join_type not in ("inner", "left"):
        raise ValueError(f"unsupported join type {spec.join_type}")
    oc = out_capacity
    slot = torch.arange(oc, device=dev)
    # candidate pair s: probe row pair_p[s], position s - cbase in its run
    cends = torch.cumsum(run, 0)
    pair_p = torch.clamp(torch.searchsorted(cends, slot, right=True),
                         max=cap - 1)
    pair_live = slot < cends[-1]
    pair_b = order[torch.clamp(lo[pair_p] + slot - (cends - run)[pair_p],
                               0, bcap - 1)]
    eq = pair_live & _keys_equal(probe, probe_keys, build, build_keys,
                                 pair_b, build_code_remaps,
                                 pidx=pair_p) & build.mask[pair_b]
    eq64 = eq.to(torch.int64)
    cnt = torch.zeros(cap, dtype=torch.int64, device=dev).index_add_(
        0, pair_p, eq64)
    matched = scatter_rows(pair_b, torch.where(
        eq, torch.cumsum(eq64, 0) - eq64, oc), oc)
    mbase = torch.cumsum(cnt, 0) - cnt
    left = spec.join_type == "left"

    def emitted(c):
        return torch.where(probe.mask, torch.clamp(c, min=1), c) if left \
            else c

    out_rows = emitted(cnt)
    total = torch.where(cends[-1] <= oc, out_rows.sum(),
                        emitted(run).sum())
    incl = torch.cumsum(out_rows, 0)
    out_p = torch.clamp(torch.searchsorted(incl, slot, right=True),
                        max=cap - 1)
    out_live = slot < incl[-1]
    m = slot - (incl - out_rows)[out_p]
    out_found = out_live & (m < cnt[out_p])
    out_b = matched[torch.clamp(mbase[out_p] + m, 0, oc - 1)]
    pcols = tuple(
        Column(data=c.data[out_p], valid=c.valid[out_p] & out_live)
        for c in probe.cols)
    bcols = tuple(
        Column(data=c.data[out_b], valid=c.valid[out_b] & out_found)
        for c in build.cols)
    return (Batch(cols=pcols + bcols, mask=out_live),
            torch.clamp(total - oc, min=0))


def join_output_schema(
    probe_schema: Schema, build_schema: Schema, spec: JoinSpec
) -> Schema:
    if spec.join_type in ("semi", "anti"):
        return probe_schema
    return probe_schema.concat(build_schema)
