"""What a cached plan holds (cockroach_tpu_torch/sql/plancache.py), counted
by the storages its tree, parameters and graphs keep between runs rather
than by an allocator delta: every cached TPC-H entry at sf=0.005 reads
more than 0 bytes, a tensor another thread allocates during a run is not
charged, and a storage shared by two entries counts once in the cache's
total."""

import threading

import pytest
import torch

from cockroach_tpu_torch.bench import tpch
from cockroach_tpu_torch.bench.tpch_sql import TPCH_SQL
from cockroach_tpu_torch.flow import dispatch, runtime
from cockroach_tpu_torch.sql import plancache, sqlstats
from cockroach_tpu_torch.sql.session import Session
from cockroach_tpu_torch.utils import settings


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These small tables gain nothing from intra-op threads, and several
    test workers' thread pools on shared cores slow each other down."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def cached():
    """The 22 TPC-H texts run once each through one session (q5 under the
    cost-based join order, as chip_smoke.py runs it)."""
    cat = tpch.gen_tpch(sf=0.005, seed=7, device="cpu")
    sess = Session(catalog=cat, device="cpu")
    cache = plancache.cache_for(cat)
    for q in sorted(TPCH_SQL, key=lambda q: int(q[1:])):
        if q == "q5":
            settings.set("sql.opt.join_order", "cost")
        try:
            sess.execute(TPCH_SQL[q])
        finally:
            settings.reset("sql.opt.join_order")
    yield cat, sess, cache
    cache.clear()
    sess.close()


def test_every_cached_tpch_entry_holds_bytes(cached):
    _, _, cache = cached
    entries = cache.entries()
    assert len(entries) == 22
    assert all(e.bytes > 0 and e.storages for e in entries)
    # each storage once: the total is at most the entries' sum
    distinct = {p: n for e in entries for p, n in e.storages.items()}
    assert cache.bytes == sum(distinct.values())
    assert cache.bytes <= sum(e.bytes for e in entries)


def test_allocation_on_another_thread_is_not_charged(cached, monkeypatch):
    cat, sess, cache = cached
    text = TPCH_SQL["q3"]
    for _ in range(2):  # settled: capacities learned, bytes steady
        sess.execute(text)
    fp = sqlstats.fingerprint(text)
    entry = next(e for e in cache.entries() if e.fingerprint == fp)
    before = entry.bytes
    total = cache.bytes
    kept: list = []
    walks: list = []
    run_operator = runtime.run_operator
    held_storages = plancache._held_storages

    def run_with_neighbour(root):
        def allocate():
            kept.append(torch.ones(1 << 16, dtype=torch.int64))

        th = threading.Thread(target=allocate)
        th.start()
        try:
            return run_operator(root)
        finally:
            th.join(timeout=30)

    def counted_walk(e, catalog):
        held = held_storages(e, catalog)
        walks.append((e, held))
        return held

    # every run reads as one that made a new signature, so the hit below
    # recounts what its entry holds while the neighbour's tensor is alive
    ticks = iter(range(1 << 30))
    monkeypatch.setattr(dispatch, "thread_compiles", lambda: next(ticks))
    monkeypatch.setattr(runtime, "run_operator", run_with_neighbour)
    monkeypatch.setattr(plancache, "_held_storages", counted_walk)
    sess.execute(text + " ")  # a plan-cache hit
    assert len(kept) == 1
    assert [e for e, _ in walks] == [entry]
    ptr = kept[0].untyped_storage().data_ptr()
    assert ptr not in walks[0][1]
    assert [e for e in cache.entries() if ptr in e.storages] == []
    assert entry.bytes == before > 0
    assert cache.bytes == total
