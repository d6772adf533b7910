"""External (partitioned) operators — the colexecdisk analog; the port of
``cockroach_tpu.flow.external``.

An in-memory operator swaps in its external variant when its spool
exceeds the budget (disk_spiller.go). Oversized inputs stage on the HOST
as compacted numpy partitions (the host-RAM tier standing in for
colcontainer's disk queues; an optional ``spill_dir`` keeps them as
``.npz`` files), partitioned on the device:

- Grace hash join: both sides bucket by the same key hash
  (``make_bucket_fn``), so partition i of the probe joins only partition
  i of the build, in memory, with the join kernels of ``ops/join``;
- external sort: rows bucket by range of an order-preserving 64-bit word
  of the primary sort key (quantile boundaries over the staged words);
  bucket i's rows all precede bucket j's (i < j) and ties stay in one
  bucket, so sorting each bucket by the full key list and emitting the
  buckets in order is the total order;
- Grace aggregation: partial-state tiles bucket by group-key hash, so
  partitions are group-disjoint and each merges and finalizes alone.

Device -> host staging moves each column of a tile once (one counted
host sync per tile) and splits the rows by partition on the host, in
row order. 64-bit words ride as int64 bit patterns on the device and are
viewed as uint64 on the host, so quantiles, boundaries and hash routing
equal the reference's.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import random
import weakref

import numpy as np
import torch

from ..coldata.batch import Batch, empty_batch, from_host
from ..coldata.types import Family, Schema
from ..ops import join as join_ops
from ..ops import merge_join as mj
from ..ops import sort as sort_ops
from ..ops.hashing import _srl, bucket, hash_columns
from ..utils import faults, log, metric, settings
from . import memory as flowmem
from .operator import OneInputOperator, Operator


def _pow2(n: int) -> int:
    """Reload and output capacities on the canonical shape ladder."""
    from .operators import _canonical_cap

    return _canonical_cap(max(1, n))


def host_arrays(op: Operator, tensors: list[torch.Tensor]) -> list:
    """Device tensors as host numpy arrays, one transfer each: one
    counted host sync for the lot."""
    if tensors[0].device.type == "cuda":
        # non_blocking device->host copies land in pinned memory; one
        # stream sync covers them all
        outs = [t.to("cpu", non_blocking=True) for t in tensors]
        torch.cuda.current_stream(tensors[0].device).synchronize()
    else:
        outs = tensors
    op.stats.host_syncs += 1
    return [o.numpy() for o in outs]


def fetch_batch(op: Operator, batch: Batch, extra=()):
    """(mask, [(data, valid)] per column, [extra arrays]) on the host."""
    ts = [batch.mask]
    for c in batch.cols:
        ts += [c.data, c.valid]
    host = host_arrays(op, ts + list(extra))
    k = len(batch.cols)
    cols = [(host[1 + 2 * i], host[2 + 2 * i]) for i in range(k)]
    return host[0], cols, host[1 + 2 * k:]


_SPILL_FILES = itertools.count()


class HostPartitions:
    """Host-staged row partitions (colcontainer partitioned queue
    analog). Each partition accumulates compacted numpy chunks, charged
    to the node-level spill-staging account until freed; ``reload``
    returns a device Batch per partition. With ``spill_dir`` every chunk
    goes to an ``.npz`` file there instead of host memory."""

    def __init__(self, schema: Schema, nparts: int,
                 spill_dir: str | None = None):
        self.schema = schema
        self.nparts = nparts
        self.spill_dir = spill_dir
        self.device = None  # the device of the first staged tile
        self.parts: list[list[dict]] = [[] for _ in range(nparts)]
        self.rows = [0] * nparts
        self.staged_bytes = 0  # cumulative, for the query's report
        self._mon = flowmem.staging_monitor("flow/spill-staging")
        self._charged = [0] * nparts
        # a finalizer releases whatever free() was never called for; the
        # holder dict keeps it from retaining self
        hold, mon = {"n": 0}, self._mon
        self._hold = hold
        weakref.finalize(self, lambda: mon.release(hold["n"]))

    def append_host(self, pid: int, arrays: dict, valids: dict, n: int):
        if n == 0:
            return
        # a failed partition write fires BEFORE the reservation, so the
        # staging account never holds bytes for rows never staged
        faults.fire("flow.spill.partition_write")
        nb = int(sum(a.nbytes for a in arrays.values())
                 + sum(v.nbytes for v in valids.values()))
        self._mon.reserve(nb, force=True)
        self._charged[pid] += nb
        self._hold["n"] += nb
        self.staged_bytes += nb
        chunk = {"arrays": arrays, "valids": valids, "n": n}
        if self.spill_dir is not None:
            path = os.path.join(
                self.spill_dir,
                f"spill-{os.getpid()}-{next(_SPILL_FILES)}-p{pid}.npz")
            np.savez(path, **{f"a{i}": arrays[c]
                              for i, c in enumerate(self.schema.names)},
                     **{f"v{i}": valids[c]
                        for i, c in enumerate(self.schema.names)})
            chunk = {"path": path, "n": n}
        self.parts[pid].append(chunk)
        self.rows[pid] += n

    def _load(self, chunk: dict) -> dict:
        if "path" not in chunk:
            return chunk
        with np.load(chunk["path"]) as z:
            names = self.schema.names
            return {"arrays": {c: z[f"a{i}"] for i, c in enumerate(names)},
                    "valids": {c: z[f"v{i}"] for i, c in enumerate(names)},
                    "n": chunk["n"]}

    def _drop_files(self, chunks) -> None:
        for c in chunks:
            if "path" in c and os.path.exists(c["path"]):
                os.remove(c["path"])

    def free(self, pid: int) -> None:
        """Drop a partition's staged rows and release their charge."""
        self._mon.release(self._charged[pid])
        self._hold["n"] -= self._charged[pid]
        self._charged[pid] = 0
        self._drop_files(self.parts[pid])
        self.parts[pid] = []
        self.rows[pid] = 0

    def charged(self, pid: int) -> int:
        """Staged bytes of one partition: an estimate of the device bytes
        its reload pins (from_host pads only to the next capacity rung)."""
        return self._charged[pid]

    def _host_columns(self, pid: int):
        """The partition's rows as contiguous host columns (the chunk list
        compacts in place on first use)."""
        chunks = [self._load(c) for c in self.parts[pid]]
        if len(chunks) > 1:
            arrays = {name: np.concatenate([c["arrays"][name] for c in chunks])
                      for name in self.schema.names}
            valids = {name: np.concatenate([c["valids"][name] for c in chunks])
                      for name in self.schema.names}
            self._drop_files(self.parts[pid])
            chunks = [{"arrays": arrays, "valids": valids,
                       "n": self.rows[pid]}]
            self.parts[pid] = chunks
        c = chunks[0]
        return c["arrays"], c["valids"]

    def reload(self, pid: int) -> Batch | None:
        if not self.parts[pid]:
            return None
        arrays, valids = self._host_columns(pid)
        return from_host(self.schema, arrays, valids,
                         capacity=_pow2(self.rows[pid]), device=self.device)

    def reload_runs(self, pid: int, rows_per: int):
        """The partition's rows as device batches of at most ``rows_per``
        rows, capacities on the shape ladder; the chunk boundaries are the
        same on every pass."""
        n = self.rows[pid]
        if n == 0:
            return
        if rows_per >= n:
            yield self.reload(pid)
            return
        arrays, valids = self._host_columns(pid)
        cap = _pow2(rows_per)
        for s in range(0, n, rows_per):
            e = min(n, s + rows_per)
            yield from_host(self.schema,
                            {k: v[s:e] for k, v in arrays.items()},
                            {k: v[s:e] for k, v in valids.items()},
                            capacity=cap, device=self.device)

    def extract(self, pid: int, sels) -> list[dict]:
        """Remove the selected rows from a partition's staged chunks
        (``sels``: one bool array per chunk, in staging order) and return
        them as chunks; the charge follows the surviving rows."""
        chunks = [self._load(c) for c in self.parts[pid]]
        removed, kept = [], []
        for c, sel in zip(chunks, sels):
            nr = int(sel.sum())
            if nr == 0:
                kept.append(c)
                continue
            keep = ~sel
            removed.append({
                "arrays": {k: v[sel] for k, v in c["arrays"].items()},
                "valids": {k: v[sel] for k, v in c["valids"].items()},
                "n": nr})
            nk = int(keep.sum())
            if nk:
                kept.append({
                    "arrays": {k: v[keep] for k, v in c["arrays"].items()},
                    "valids": {k: v[keep] for k, v in c["valids"].items()},
                    "n": nk})
        if removed:
            self._drop_files(self.parts[pid])
            self.parts[pid] = kept
            freed = self._charged[pid]
            nb = int(sum(
                sum(a.nbytes for a in c["arrays"].values())
                + sum(v.nbytes for v in c["valids"].values())
                for c in kept))
            self.rows[pid] = sum(c["n"] for c in kept)
            self._mon.release(freed - nb)
            self._hold["n"] -= freed - nb
            self._charged[pid] = nb
        return removed


def stage_host(parts: HostPartitions, mask: np.ndarray, cols, pids,
               device) -> None:
    """Split one tile's live host rows into partitions by `pids`, row
    order kept inside each (the external sort's staging: its boundaries
    are known only after every tile is on the host)."""
    if parts.device is None:
        parts.device = device
    live = np.flatnonzero(mask)
    # 16-bit ids: numpy's stable sort is a radix sort at that width
    p = np.asarray(pids)[live].astype(np.int16)
    order = live[np.argsort(p, kind="stable")]
    # crlint: allow-mem-accounting(partition bounds: nparts + 1 ints; the staged rows are charged to the spill-staging account by HostPartitions)
    bounds = np.concatenate(
        [[0], np.cumsum(np.bincount(p, minlength=parts.nparts))])
    _append_parts(parts, [(d[order], v[order]) for d, v in cols], bounds)


def _append_parts(parts: HostPartitions, cols, bounds) -> None:
    """Append partition p's rows, cols[i][bounds[p]:bounds[p+1]], as
    arrays of their own (not views of the tile's transfer buffers)."""
    names = parts.schema.names
    for pid in range(parts.nparts):
        s, e = int(bounds[pid]), int(bounds[pid + 1])
        if e > s:
            parts.append_host(
                pid, {n: d[s:e].copy() for n, (d, _) in zip(names, cols)},
                {n: v[s:e].copy() for n, (_, v) in zip(names, cols)}, e - s)


def stage_batch(op: Operator, batch: Batch, pids: torch.Tensor,
                parts: HostPartitions, extra=(), raw=()):
    """Move a device batch's live rows to host partitions by the per-row
    partition id `pids` (a device tensor; dead rows ignored). The rows
    group by partition on the device (a stable sort, so row order holds
    inside each partition), each column crosses to the host once, in one
    counted host sync, and the host slices the partitions off.

    Returns (each of `extra` on the host in the staged order, live rows
    only; the partition bounds; each of `raw` on the host as it is)."""
    if parts.device is None:
        parts.device = batch.device
    n = parts.nparts
    key = torch.where(batch.mask, pids.to(torch.int64), n)
    order = torch.sort(key, stable=True).indices
    moved = [t[order] for c in batch.cols for t in (c.data, c.valid)]
    moved += [e[order] for e in extra]
    host = host_arrays(op, [torch.bincount(key, minlength=n + 1)] + moved
                       + list(raw))
    # crlint: allow-mem-accounting(partition bounds: nparts + 1 ints; the staged rows are charged to the spill-staging account by HostPartitions)
    bounds = np.concatenate([[0], np.cumsum(host[0][:n])])
    k = len(batch.cols)
    _append_parts(parts, [(host[1 + 2 * i], host[2 + 2 * i])
                          for i in range(k)], bounds)
    live = int(bounds[-1])
    ex = [h[:live].copy() for h in host[1 + 2 * k:1 + 2 * k + len(extra)]]
    return ex, bounds, host[1 + 2 * k + len(extra):]


class ReplayOp(Operator):
    """Re-emits already-spooled device tiles: hands an in-memory
    operator's buffered input to the external variant it spills into."""

    def __init__(self, tiles, schema: Schema, dictionaries):
        super().__init__()
        self.tiles = list(tiles)
        self.output_schema = schema
        self.dictionaries = dict(dictionaries)
        self._i = 0

    def init(self):
        super().init()
        self._i = 0

    def _next(self):
        if self._i >= len(self.tiles):
            return None
        b = self.tiles[self._i]
        self._i += 1
        return b


class ChainOp(ReplayOp):
    """Replays spooled tiles, then goes on pulling from the live input,
    which it does NOT re-init (it is mid-stream)."""

    def __init__(self, tiles, schema: Schema, dictionaries, rest):
        super().__init__(tiles, schema, dictionaries)
        self.rest = rest

    def _next(self):
        b = super()._next()
        return self.rest.next_batch() if b is None else b


def make_bucket_fn(schema: Schema, keys, tables, nparts: int,
                   with_hash: bool = False):
    """Per-row partition id from the key columns' 64-bit hash: THE Grace
    partition function, shared by the external join and aggregation.
    `tables`: STRING keys' dictionary hash tables by key position. With
    ``with_hash`` the hash rides along (int64 bit patterns)."""
    keys = tuple(keys)
    types = [schema.types[i] for i in keys]

    def fn(b: Batch):
        h = hash_columns([b.cols[i] for i in keys], types, tables or None)
        pid = bucket(h, nparts)
        return (pid, h) if with_hash else pid

    return fn


def _growing_cap(out_cap: int):
    """An output capacity that grows to the ladder rung past a total it
    cannot hold: ([the current capacity], the function of the total the
    join kernels take as ``out_capacity``)."""
    caps = [out_cap]

    def cap_for(total: int) -> int:
        if total > caps[0]:
            caps[0] = _pow2(total + 1)
        return caps[0]

    return caps, cap_for


# ---------------------------------------------------------------------------
# Grace hash join


class GraceHashJoinOp(OneInputOperator):
    """External hash join: both sides hash-partition into P buckets
    staged on the host; partition pairs join in memory, with two escape
    hatches:

    - heavy hitters: build-key hashes are reservoir-sampled while
      staging; keys owning more than ``sql.distsql.grace_skew_frac`` of
      the sample keep their build rows resident on the device, and probe
      rows with those hashes take a hot lane against that table;
    - hybrid degrade: a partition whose build side alone exceeds workmem
      reloads its build as budget-sized sorted runs and merge-probes each
      (``ops/merge_join``).

    Probe sides reload in budget-sized chunks either way. STRING keys'
    hash tables go by key position (as in the port's HashJoinOp)."""

    def __init__(self, probe: Operator, build: Operator,
                 probe_keys, build_keys, spec, nparts: int = 8):
        super().__init__(probe)
        self.build = build
        self.probe_keys = tuple(probe_keys)
        self.build_keys = tuple(build_keys)
        self.spec = spec
        self.nparts = nparts
        self.output_schema = join_ops.join_output_schema(
            probe.output_schema, build.output_schema, spec)
        self.dictionaries = dict(probe.dictionaries)
        if spec.join_type not in ("semi", "anti"):
            off = len(probe.output_schema)
            for i, d in build.dictionaries.items():
                self.dictionaries[off + i] = d
        self.probe_hash_tables = {}
        self.build_hash_tables = {}
        self.build_code_remaps = {}
        for pos, (pk, bk) in enumerate(zip(self.probe_keys, self.build_keys)):
            if probe.output_schema.types[pk].family is Family.STRING:
                pd_ = probe.dictionaries[pk]
                bd = build.dictionaries[bk]
                self.probe_hash_tables[pos] = pd_.hashes
                self.build_hash_tables[pos] = bd.hashes
                self.build_code_remaps[pos] = np.array(
                    [pd_.code_of(str(v)) for v in bd.values], dtype=np.int32)
        self._bucket_probe = make_bucket_fn(
            probe.output_schema, self.probe_keys, self.probe_hash_tables,
            nparts, with_hash=True)
        self._bucket_build = make_bucket_fn(
            build.output_schema, self.build_keys, self.build_hash_tables,
            nparts, with_hash=True)
        # oversized partitions merge-probe runs ordered by the exact key
        self._pranks, self._branks = mj.rank_tables_for(
            probe.output_schema, self.probe_keys, probe.dictionaries,
            self.build_keys, build.dictionaries)

    def children(self):
        return [self.child, self.build]

    def init(self):
        self.build.init()
        super().init()
        self._gen = None
        self._alloc = None
        self._hot_build = None
        self._hot_index = None
        self._hot_bytes = 0

    # the in-memory join functions of one partition

    def _hj(self, p: Batch, build: Batch, index, out_cap: int, jt: str):
        """Hash probe of a complete build; -> (out, output capacity)."""
        sp = dataclasses.replace(self.spec, join_type=jt)
        caps, cap_for = _growing_cap(out_cap)
        out, _ = join_ops.hash_join_general(
            p, self.child.output_schema, self.probe_keys, build,
            self.build.output_schema, self.build_keys, sp, cap_for,
            self.probe_hash_tables or None, self.build_hash_tables or None,
            self.build_code_remaps or None, index=index, sync=self.sync_int)
        return out, caps[0]

    def _hindex(self, b: Batch):
        return join_ops.build_index(b, self.build.output_schema,
                                    self.build_keys,
                                    self.build_hash_tables or None)

    def _mindex(self, b: Batch):
        return mj.build_merge_index(b, self.build.output_schema,
                                    self.build_keys, self._branks)

    def _mj(self, p: Batch, run: Batch, index, out_cap: int, jt: str):
        sp = dataclasses.replace(self.spec, join_type=jt)
        caps, cap_for = _growing_cap(out_cap)
        out, _ = mj.merge_join(
            p, self.child.output_schema, self.probe_keys, run,
            self.build.output_schema, self.build_keys, sp, cap_for,
            self._pranks, self._branks, build_index=index,
            sync=self.sync_int)
        return out, caps[0]

    def _partition_all(self):
        pschema = self.child.output_schema
        bschema = self.build.output_schema
        # the probe side has one extra lane (index nparts): rows carrying
        # a heavy-hitter hash detected from the build sample
        pparts = HostPartitions(pschema, self.nparts + 1)
        bparts = HostPartitions(bschema, self.nparts)
        size = int(settings.get("sql.distsql.grace_skew_sample"))
        frac = float(settings.get("sql.distsql.grace_skew_frac"))
        # fixed seed: a re-run of the same query samples identically
        rng = random.Random(0x5CE7A11)
        samples: list[int] = []
        seen = 0
        bhashes: list[list[np.ndarray]] = [[] for _ in range(self.nparts)]
        while True:
            b = self.build.next_batch()
            if b is None:
                break
            pids, h = self._bucket_build(b)
            (hs,), bounds, (mask, hr) = stage_batch(
                self, b, pids, bparts, extra=(h,), raw=(b.mask, h))
            if size > 0 and frac > 0:
                # reservoir-sample live build key hashes (algorithm R)
                for hv in hr.view(np.uint64)[mask].tolist():
                    seen += 1
                    if len(samples) < size:
                        samples.append(hv)
                    else:
                        j = rng.randrange(seen)
                        if j < size:
                            samples[j] = hv
            hs = hs.view(np.uint64)
            for pid in range(self.nparts):
                s, e = bounds[pid], bounds[pid + 1]
                if e > s:
                    bhashes[pid].append(hs[s:e])
        hot = self._detect_hot(samples, frac, bparts, bhashes)
        hot_t = None
        while True:
            p = self.child.next_batch()
            if p is None:
                break
            pids, h = self._bucket_probe(p)
            if hot is None:
                stage_batch(self, p, pids, pparts)
                continue
            if hot_t is None:
                hot_t = torch.from_numpy(hot.view(np.int64)).to(p.device)
            routed = torch.isin(h, hot_t)
            _, _, (n_hot,) = stage_batch(
                self, p, torch.where(routed, self.nparts, pids), pparts,
                raw=((routed & p.mask).sum(),))
            if int(n_hot):
                metric.GRACE_JOIN_SKEW_ROUTED.inc(int(n_hot))
        self._pparts = pparts
        self._bparts = bparts
        self.stats.staged_bytes += pparts.staged_bytes + bparts.staged_bytes

    def _detect_hot(self, samples, frac, bparts, bhashes):
        """Heavy-hitter hashes of the build reservoir -> a resident device
        build table extracted from the staged partitions. Returns the
        sorted hot hashes for probe routing, or None."""
        if not samples or frac <= 0:
            return None
        thr = max(2, int(frac * len(samples)))
        counts: dict[int, int] = {}
        for hv in samples:
            counts[hv] = counts.get(hv, 0) + 1
        hot_list = sorted(h for h, c in counts.items() if c >= thr)
        if not hot_list:
            return None
        hot = np.array(hot_list, dtype=np.uint64)
        sels = {pid: [np.isin(ch, hot) for ch in bhashes[pid]]
                for pid in range(self.nparts)}
        hot_rows = sum(int(s.sum()) for ss in sels.values() for s in ss)
        if hot_rows == 0:
            return None
        # the hot table must fit well inside workmem, or routing would
        # only move the oversize onto the device
        budget = int(settings.get("sql.distsql.workmem_bytes"))
        total_rows = sum(bparts.rows) or 1
        total_bytes = sum(bparts.charged(pid) for pid in range(self.nparts))
        est = int(total_bytes * hot_rows / total_rows)
        if est > budget // 4:
            log.info(log.SQL_EXEC,
                     "grace join skew: hot build side too large to pin",
                     hot_keys=len(hot_list), est_bytes=est)
            return None
        chunks = []
        for pid in range(self.nparts):
            chunks.extend(bparts.extract(pid, sels[pid]))
        bschema = self.build.output_schema
        arrays = {name: np.concatenate([c["arrays"][name] for c in chunks])
                  for name in bschema.names}
        valids = {name: np.concatenate([c["valids"][name] for c in chunks])
                  for name in bschema.names}
        n = sum(c["n"] for c in chunks)
        self._hot_build = from_host(bschema, arrays, valids,
                                    capacity=_pow2(n), device=bparts.device)
        self._hot_index = self._hindex(self._hot_build)
        self._hot_bytes = flowmem.batch_bytes(self._hot_build)
        self._alloc.reserve(self._hot_bytes, force=True)
        log.info(log.SQL_EXEC, "grace join skew: heavy hitters pinned",
                 hot_keys=len(hot_list), rows=n)
        return hot

    @staticmethod
    def _rows_per(nbytes: int, rows: int, budget: int) -> int:
        """Rows per bounded reload so one run or chunk stays inside the
        budget (floored, so tiny budgets still make progress)."""
        if rows == 0:
            return 1
        per_row = max(1, nbytes // rows)
        return max(1024, int(budget // per_row))

    def _probe_stream(self, pid, rows_per, build, index):
        """Probe one partition in bounded chunks against a COMPLETE build
        (resident partition or the hot table): each chunk's match set is
        all there, so every join type is exact per chunk."""
        jt = self.spec.join_type
        out_cap = 0
        for chunk in self._pparts.reload_runs(pid, rows_per):
            nb = flowmem.batch_bytes(chunk)
            self._alloc.reserve(nb, force=True)
            try:
                out_cap = max(out_cap, _pow2(chunk.capacity))
                out, out_cap = self._hj(chunk, build, index, out_cap, jt)
                yield out
            finally:
                self._alloc.release(nb)

    def _probe_hot(self, budget):
        hot_pid = self.nparts
        try:
            rows_per = self._rows_per(self._pparts.charged(hot_pid),
                                      self._pparts.rows[hot_pid], budget)
            yield from self._probe_stream(hot_pid, rows_per,
                                          self._hot_build, self._hot_index)
        finally:
            self._pparts.free(hot_pid)
            self._alloc.release(self._hot_bytes)
            self._hot_bytes = 0
            self._hot_build = self._hot_index = None

    def _probe_resident(self, pid, budget):
        build = self._bparts.reload(pid)
        if build is None:
            build = empty_batch(self.build.output_schema, 1024,
                                self._pparts.device)
        nb = flowmem.batch_bytes(build)
        self._alloc.reserve(nb, force=True)
        try:
            index = self._hindex(build)
            rows_per = self._rows_per(self._pparts.charged(pid),
                                      self._pparts.rows[pid], budget)
            yield from self._probe_stream(pid, rows_per, build, index)
        finally:
            self._alloc.release(nb)

    def _probe_runs(self, pid, budget):
        """Oversized partition: the build side reloads as budget-sized
        sorted runs and each probe chunk binary-searches every run. Inner
        and left matches emit per run (runs are disjoint build rows);
        semi, anti and a left join's unmatched rows OR a per-chunk found
        mask across runs and resolve in a final pass."""
        metric.GRACE_JOIN_MERGE_PARTS.inc()
        jt = self.spec.join_type
        rows_run = self._rows_per(self._bparts.charged(pid),
                                  self._bparts.rows[pid], budget)
        rows_chunk = self._rows_per(self._pparts.charged(pid),
                                    self._pparts.rows[pid], budget)
        log.info(log.SQL_EXEC,
                 "grace join partition exceeds workmem; merge-probing runs",
                 partition=pid, build_rows=self._bparts.rows[pid],
                 run_rows=rows_run)
        found: dict[int, torch.Tensor] = {}
        out_cap = 0
        for run in self._bparts.reload_runs(pid, rows_run):
            faults.fire("flow.spill.merge_probe")
            rb = flowmem.batch_bytes(run)
            self._alloc.reserve(rb, force=True)
            try:
                index = self._mindex(run)
                for ci, chunk in enumerate(
                        self._pparts.reload_runs(pid, rows_chunk)):
                    cb = flowmem.batch_bytes(chunk)
                    self._alloc.reserve(cb, force=True)
                    try:
                        if jt in ("inner", "left"):
                            out_cap = max(out_cap, _pow2(chunk.capacity))
                            out, out_cap = self._mj(chunk, run, index,
                                                    out_cap, "inner")
                            yield out
                        if jt != "inner":
                            m, _ = self._mj(chunk, run, index,
                                            chunk.capacity, "semi")
                            f = m.mask
                            found[ci] = f if ci not in found else found[ci] | f
                    finally:
                        self._alloc.release(cb)
            finally:
                self._alloc.release(rb)
        if jt == "inner":
            return
        # final probe-aligned pass over the same chunking
        for ci, chunk in enumerate(self._pparts.reload_runs(pid, rows_chunk)):
            cb = flowmem.batch_bytes(chunk)
            self._alloc.reserve(cb, force=True)
            try:
                f = found.get(ci)
                if f is None:
                    f = torch.zeros(chunk.capacity, dtype=torch.bool,
                                    device=chunk.device)
                if jt == "semi":
                    yield chunk.with_mask(f)
                elif jt == "anti":
                    yield chunk.with_mask(chunk.mask & ~f)
                else:  # left: unmatched rows null-extend via an empty run
                    unm = chunk.mask & ~f
                    empty = empty_batch(self.build.output_schema, 1024,
                                        chunk.device)
                    out, _ = self._mj(chunk.with_mask(unm), empty,
                                      self._mindex(empty),
                                      _pow2(chunk.capacity), "left")
                    yield out
            finally:
                self._alloc.release(cb)

    def _emit(self):
        if self._alloc is not None:
            self._alloc.release()
            self._alloc.close()
        self._alloc = flowmem.Allocator("grace join partition")
        self._partition_all()
        budget = int(settings.get("sql.distsql.workmem_bytes"))
        if self._hot_build is not None:
            yield from self._probe_hot(budget)
        for pid in range(self.nparts):
            try:
                if self._pparts.rows[pid] == 0:
                    continue
                if self._bparts.charged(pid) <= budget:
                    yield from self._probe_resident(pid, budget)
                else:
                    yield from self._probe_runs(pid, budget)
            finally:
                # free as we go: peak staging tracks the live partitions
                self._pparts.free(pid)
                self._bparts.free(pid)

    def _next(self):
        if self._gen is None:
            self._gen = self._emit()
        return next(self._gen, None)

    def close(self):
        super().close()
        self.build.close()
        self._gen = None
        self._hot_build = self._hot_index = None
        if self._alloc is not None:
            self._alloc.release()
            self._alloc.close()
            self._alloc = None


# ---------------------------------------------------------------------------
# External sort

_TOP = -(1 << 63)  # bit 63 alone, as an int64


# crlint: allow-mem-accounting(tile-width device temp for order-preserving key packing; the owning batch is charged by its operator account)
def _primary_u64(batch: Batch, schema: Schema, key: sort_ops.SortKey,
                 rank_table=None) -> torch.Tensor:
    """Order-preserving 64-bit word of the primary sort key, as an int64
    bit pattern: the NULL (and NaN) ordering bands in the top bits below
    bit 63, then the leading payload word shifted down to make room.
    Only partition granularity loses bits; the bucket sort uses the full
    key list."""
    c = batch.cols[key.col]
    ops = sort_ops.order_keys(c.data, c.valid, key, schema.types[key.col],
                              rank_table)
    bands, payload = [], None
    for op in ops:
        if op.dtype == torch.bool:
            bands.append(op)
        else:
            payload = op
            break
    if payload is None:  # BOOL key: its value band IS the payload, at bit 63
        payload = bands.pop().to(torch.int64) << 63
    u = torch.zeros(batch.capacity, dtype=torch.int64, device=batch.device)
    shift = 62
    for op in bands:
        u = u | (op.to(torch.int64) << shift)
        shift -= 1
    if payload.dtype in (torch.float64, torch.float32):
        p = payload.to(torch.float64).view(torch.int64)
        p = torch.where(p < 0, ~p, p | _TOP)
    elif payload.dtype != torch.int64:  # int32 dictionary ranks
        p = payload.to(torch.int64) ^ _TOP
    else:  # already the unsigned word's bit pattern
        p = payload
    return u | _srl(p, 64 - shift - 1)


class ExternalSortOp(OneInputOperator):
    """External sort: range-partition rows by the primary key's 64-bit
    word (quantile boundaries over the staged words), sort each bucket
    by the full key list and emit the buckets in order."""

    def __init__(self, child: Operator, keys, budget_rows: int = 1 << 20,
                 nparts: int = 8):
        super().__init__(child)
        self.output_schema = child.output_schema
        self.keys = tuple(keys)
        self.budget_rows = budget_rows
        self.nparts = nparts
        self.rank_tables = {
            k.col: child.dictionaries[k.col].ranks
            for k in self.keys if k.col in child.dictionaries}

    def init(self):
        super().init()
        self._parts = None
        self._staged = False
        self._pid = 0
        self.bounds = None  # the range boundaries of the last run

    def _stage_all(self):
        # pass 1: stage all live rows and their primary words on the host
        key = self.keys[0]
        chunks = []
        device = None
        while True:
            b = self.child.next_batch()
            if b is None:
                break
            device = b.device
            u = _primary_u64(b, self.output_schema, key,
                             self.rank_tables.get(key.col))
            mask, cols, (uh,) = fetch_batch(self, b, (u,))
            chunks.append((mask, cols, uh.view(np.uint64)))
        total = sum(int(c[0].sum()) for c in chunks)
        self._staged = True
        if total == 0:
            return
        # the quantile key vector is 8 B/row over the whole staged input:
        # charge it for the split's lifetime
        with flowmem.staged("flow/spill-staging", 8 * total):
            allu = np.concatenate([u[m] for m, _, u in chunks])
            P = min(self.nparts, max(1, (total + self.budget_rows - 1)
                                     // self.budget_rows * 2))
            qs = np.quantile(allu, np.linspace(0, 1, P + 1)[1:-1])
            bounds = np.unique(qs.astype(np.uint64))
        self.bounds = bounds
        parts = HostPartitions(self.output_schema, len(bounds) + 1)
        for mask, cols, u in chunks:
            pids = np.searchsorted(bounds, u, side="right")
            stage_host(parts, mask, cols, pids, device)
        self.stats.staged_bytes += parts.staged_bytes
        self._parts = parts

    def _next(self):
        if not self._staged:
            self._stage_all()
        if self._parts is None:
            return None
        while self._pid < self._parts.nparts:
            pid = self._pid
            b = self._parts.reload(pid)
            self._parts.free(pid)
            self._pid += 1
            if b is not None:
                return sort_ops.sort_batch(b, self.output_schema, self.keys,
                                           self.rank_tables)
        return None


# ---------------------------------------------------------------------------
# Grace aggregation (external_hash_aggregator.go role), also the external
# DISTINCT, which is aggregation without aggregate functions


class GraceAggregateOp(Operator):
    """External aggregation over partial-state tiles: rows partition by
    group-key hash, so partitions are group-disjoint; each merges,
    finalizes and streams out as one batch, bounding memory by the
    largest partition. Built by AggregateOp's spill handoff: `child`
    replays the spooled state tiles, then continues the live partial
    stream (ChainOp)."""

    def __init__(self, child: Operator, agg_op, nparts: int = 8):
        super().__init__()
        if agg_op.num_keys <= 0:
            raise ValueError("Grace aggregation needs group keys")
        self.child = child
        self.agg = agg_op  # the spilling AggregateOp (owns merge/finalize)
        self.nparts = nparts
        self.output_schema = agg_op.output_schema
        self.dictionaries = dict(agg_op.dictionaries)
        self.col_stats = dict(agg_op.col_stats)
        k = agg_op.num_keys
        tables = {pos: d.hashes for pos, d in agg_op.dictionaries.items()
                  if pos < k}
        self._bucket = make_bucket_fn(agg_op.state_schema, range(k), tables,
                                      nparts)

    def children(self):
        return [self.child]

    def init(self):
        super().init()
        self._parts = None
        self._pid = 0

    def _stage_all(self):
        parts = HostPartitions(self.agg.state_schema, self.nparts)
        n_tiles = 0
        while True:
            b = self.child.next_batch()
            if b is None:
                break
            n_tiles += 1
            stage_batch(self, b, self._bucket(b), parts)
        metric.EXTERNAL_AGG_SPILLS.inc()
        log.info(log.SQL_EXEC, "aggregation spilled to Grace partitions",
                 tiles=n_tiles, partitions=self.nparts,
                 rows=sum(parts.rows))
        self.stats.staged_bytes += parts.staged_bytes
        self._parts = parts

    def _next(self):
        if self._parts is None:
            self._stage_all()
        while self._pid < self.nparts:
            pid = self._pid
            self._pid += 1
            batch = self._parts.reload(pid)
            self._parts.free(pid)  # free as we go
            if batch is None:
                continue
            cap = batch.capacity
            merged, ng = self.agg.merge([batch], cap)
            n = self.sync_int(ng)
            while n > cap:  # one counted sync per retry
                cap = _pow2(n + 1)
                merged, ng = self.agg.merge([batch], cap)
                n = self.sync_int(ng)
            return self.agg.finalize(merged)
        return None

    def close(self):
        self.child.close()
        self._parts = None
