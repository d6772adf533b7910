"""The port's two kernel modules against the JAX reference on the CPU.

On CPU tensors each wrapper runs its kernel's plain version:
``cuda_scan.scan_filter`` the window filter, ``cuda_merge.merge_perm``
the stable sort of [A; B]. Each is held, exactly, against the JAX
function the Pallas kernel is held against (``mvcc_scan_filter(window=)``,
``merge_blocks``) and once against the Pallas kernel itself in interpret
mode. The CUDA kernels run only on the card: ``python3 chip_smoke.py``
holds each against its plain version there."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from cockroach_tpu.storage import mvcc as jmvcc
from cockroach_tpu.storage import pallas_merge
from cockroach_tpu.storage.pallas_scan import pallas_scan_filter
from cockroach_tpu_torch.storage import cuda_merge, cuda_scan
from cockroach_tpu_torch.storage import mvcc as tmvcc
from test_pallas_merge import _random_sorted_run
from test_pallas_scan import _window_block

CPU = torch.device("cpu")
READERS = ((50, 0), (10, 0), (50, 1), (200, 2))


def _np(blk) -> dict:
    return {k: np.asarray(getattr(blk, k)) for k in tmvcc.FIELDS}


def _port(blk) -> tmvcc.KVBlock:
    return tmvcc.kvblock_from_numpy(_np(blk), CPU)


def _jax(f: dict) -> jmvcc.KVBlock:
    return jmvcc.KVBlock(**{k: jnp.asarray(v) for k, v in f.items()})


def _live(blk) -> dict:
    f = _np(blk)
    m = f["mask"]
    return {k: v[m] for k, v in f.items()}


def _assert_live_equal(got, want):
    g, w = _live(got), _live(want)
    for k in tmvcc.FIELDS:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ------------------------------------------------------------------ K1


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_scan_filter_plain_matches_reference(seed):
    blk = _window_block(np.random.default_rng(seed))
    port = _port(blk)
    for read_ts, reader in READERS:
        want = jmvcc.mvcc_scan_filter(blk, jnp.int64(read_ts),
                                      jnp.int64(reader), window=256)
        got = cuda_scan.scan_filter(port, read_ts, reader, 256)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("window", [128, 1024])
def test_scan_filter_plain_edge_windows(window):
    f = chip_smoke.edge_windows(window)
    for read_ts, reader in ((50_000, 0), (50, 0), (50_000, 3)):
        want = jmvcc.mvcc_scan_filter(_jax(f), jnp.int64(read_ts),
                                      jnp.int64(reader), window=window)
        got = cuda_scan.scan_filter(tmvcc.kvblock_from_numpy(f, CPU),
                                    read_ts, reader, window)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_scan_filter_plain_matches_pallas_interpret():
    blk = _window_block(np.random.default_rng(4), B=4, window=256)
    want = pallas_scan_filter(blk, jnp.int64(50), jnp.int64(1), window=256,
                              interpret=True)
    got = cuda_scan.scan_filter(_port(blk), 50, 1, 256)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_filter_stage_gate():
    """Shapes that pass the reference's gate go through the kernel
    wrapper, others through mvcc_scan_filter; both agree."""
    blk = _port(_window_block(np.random.default_rng(5), B=2, window=256))
    for window in (256, 64):
        got = tmvcc._filter_stage_flat(blk, 50, 0, window)
        want = tmvcc.mvcc_scan_filter(blk, 50, 0, window=window)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# ------------------------------------------------------------------ K2


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("sizes", [(30, 50), (64, 64), (5, 120), (1, 1),
                                   (700, 300)])
def test_merge_plain_matches_sort(seed, sizes):
    rng = np.random.default_rng(seed)
    a = _random_sorted_run(rng, sizes[0])
    b = _random_sorted_run(rng, sizes[1])
    got = cuda_merge.merge_pair(_port(a), _port(b))
    assert got.capacity == cuda_merge.merged_rows(a.capacity, b.capacity)
    want = jmvcc.merge_blocks((a, b), cap=a.capacity + b.capacity)
    _assert_live_equal(got, want)
    # the permutation is the stable sort of [A; B], pads (-1) last
    perm = cuda_merge.merge_perm(_port(a), _port(b)).numpy()
    n = a.capacity + b.capacity
    assert sorted(perm[:n].tolist()) == list(range(n))
    assert (perm[n:] == -1).all()


@pytest.mark.parametrize("k", [3, 4, 5])
def test_merge_tournament_matches_sort(k):
    rng = np.random.default_rng(7 + k)
    runs = tuple(_random_sorted_run(rng, int(rng.integers(10, 90)))
                 for _ in range(k))
    got = cuda_merge.merge_runs(tuple(_port(r) for r in runs))
    want = jmvcc.merge_blocks(runs, cap=sum(r.capacity for r in runs))
    _assert_live_equal(got, want)
    # merged pads stay last among dead rows: the output is fully sorted
    _assert_live_equal(tmvcc.sort_block(got), got)
    assert torch.equal(tmvcc.sort_block(got).key, got.key)


def test_merge_plain_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    a = _random_sorted_run(rng, 64)
    b = _random_sorted_run(rng, 64)
    want = pallas_merge.merge_pair(a, b, interpret=True)
    got = cuda_merge.merge_pair(_port(a), _port(b))
    assert got.capacity == want.capacity
    _assert_live_equal(got, want)


def test_merge_live_ties():
    """Live rows with equal (key, ts, seq) in both runs: the port keeps
    every row, in stable order, as merge_blocks does. The reference's
    Pallas kernel collapses such ties onto one row (its select at
    pallas_merge.py:130 moves the high element into both slots), so it
    disagrees with merge_blocks here."""
    f = {"key": np.zeros((64, 16), np.uint8), "ts": np.full(64, 5),
         "seq": np.full(64, 9), "txn": np.zeros(64, np.int64),
         "tomb": np.zeros(64, bool), "value": np.zeros((64, 8), np.uint8),
         "vlen": np.full(64, 1, np.int32), "mask": np.ones(64, bool)}
    f["key"][:, :4] = np.frombuffer(b"same", np.uint8)
    a = dict(f, value=f["value"].copy())
    b = dict(f, value=f["value"].copy())
    a["value"][:, 0] = np.arange(64)
    b["value"][:, 0] = np.arange(64, 128)
    ja, jb = _jax(a), _jax(b)
    want = jmvcc.merge_blocks((ja, jb), cap=128)
    got = cuda_merge.merge_pair(tmvcc.kvblock_from_numpy(a, CPU),
                                tmvcc.kvblock_from_numpy(b, CPU))
    _assert_live_equal(got, want)
    assert sorted(_live(got)["value"][:, 0].tolist()) == list(range(128))
    ref_kernel = pallas_merge.merge_pair(ja, jb, interpret=True)
    assert len(set(_live(ref_kernel)["value"][:, 0].tolist())) < 128


def test_eligible_cap():
    def runs(*caps):
        return tuple(SimpleNamespace(capacity=c) for c in caps)

    assert cuda_merge.eligible(runs(1 << 17, 1 << 17))  # YCSB load merge
    assert not cuda_merge.eligible(runs(1 << 17))
    # the bound is next_pow2(K) * 2 * next_pow2(max cap) rows
    cap = cuda_merge.MAX_MERGE_ROWS // 4
    assert cuda_merge.eligible(runs(cap, cap))
    assert not cuda_merge.eligible(runs(cap, cap, 1))
    assert not cuda_merge.eligible(runs(cap + 1, 1))

