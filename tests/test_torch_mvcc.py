"""The port's storage keys and MVCC block operations
(cockroach_tpu_torch.storage.keys / .mvcc) against the JAX reference on the
CPU: the same seeded numpy inputs through both, compared exactly (every
value is an integer or a bool)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cockroach_tpu.storage import keys as jkeys
from cockroach_tpu.storage import mvcc as jmvcc
from cockroach_tpu_torch.storage import keys as tkeys
from cockroach_tpu_torch.storage import mvcc as tmvcc

CPU = torch.device("cpu")


def _fields(rng, n, cap=None, nkeys=40, key_width=16, val_width=8,
            sort=True):
    """Random MVCC rows: keys from a small pool (so runs have several
    versions), intents of txns 1 and 2, tombstones, dead rows."""
    cap = cap or n
    f = {"key": np.zeros((cap, key_width), np.uint8),
         "ts": np.zeros(cap, np.int64), "seq": np.zeros(cap, np.int64),
         "txn": np.zeros(cap, np.int64), "tomb": np.zeros(cap, bool),
         "value": np.zeros((cap, val_width), np.uint8),
         "vlen": np.zeros(cap, np.int32), "mask": np.zeros(cap, bool)}
    for i in range(n):
        k = b"k%05d" % rng.integers(0, nkeys)
        if rng.random() < 0.1:
            k = b"\xff\x80" + k  # high bytes: the words' sign bit is set
        f["key"][i, :len(k)] = np.frombuffer(k, np.uint8)
    f["ts"][:n] = rng.integers(-5, 100, n)
    f["seq"][:n] = rng.integers(0, 1 << 40, n)
    f["txn"][:n] = rng.choice([0, 0, 0, 1, 2], n)
    f["tomb"][:n] = rng.random(n) < 0.2
    f["value"][:n] = rng.integers(0, 256, (n, val_width))
    f["vlen"][:n] = rng.integers(0, val_width + 1, n)
    f["mask"][:n] = rng.random(n) < 0.9
    if sort:
        return _np(jmvcc.sort_block(_jax(f)))
    return f


def _jax(f) -> jmvcc.KVBlock:
    return jmvcc.KVBlock(**{k: jnp.asarray(v) for k, v in f.items()})


def _np(blk) -> dict:
    return {k: np.asarray(getattr(blk, k)) for k in tmvcc.FIELDS}


def _port(f) -> tmvcc.KVBlock:
    return tmvcc.kvblock_from_numpy(f, CPU)


def _port_np(blk: tmvcc.KVBlock) -> dict:
    return {k: getattr(blk, k).numpy() for k in tmvcc.FIELDS}


def _assert_blocks_equal(got: dict, want: dict):
    for k in tmvcc.FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _words_t(w: np.ndarray) -> torch.Tensor:
    return tkeys.words_tensor(w, CPU)


# ------------------------------------------------------------------ keys


def test_keys_match_reference():
    rng = np.random.default_rng(0)
    raw = [bytes(rng.integers(1, 256, rng.integers(0, 17)).astype(np.uint8))
           for _ in range(300)] + [b"", b"\xff" * 16, b"\x80", b"\x7f"]
    enc = jkeys.encode_keys(raw, 16)
    np.testing.assert_array_equal(tkeys.encode_keys(raw, 16), enc)
    assert tkeys.decode_keys(enc) == jkeys.decode_keys(enc)
    jw = np.asarray(jkeys.key_words(jnp.asarray(enc)))
    tw = tkeys.key_words(torch.from_numpy(enc))
    np.testing.assert_array_equal(tw.numpy().view(np.uint64), jw)
    a, b = jw[:-1], jw[1:]
    np.testing.assert_array_equal(
        tkeys.words_cmp_lt(tw[:-1], tw[1:]).numpy(),
        np.asarray(jkeys.words_cmp_lt(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        tkeys.words_cmp_eq(tw[:-1], tw[1:]).numpy(),
        np.asarray(jkeys.words_cmp_eq(jnp.asarray(a), jnp.asarray(b))))
    for lo, hi in ((raw[3], raw[7]), (None, b"\x80"), (b"\x7f", None),
                   (None, None)):
        sw = jkeys.encode_bound(lo, 16)
        ew = jkeys.encode_bound(hi, 16)
        np.testing.assert_array_equal(
            sw if sw is not None else [], tkeys.encode_bound(lo, 16)
            if lo is not None else [])
        want = np.asarray(jkeys.words_in_range(
            jnp.asarray(jw), None if sw is None else jnp.asarray(sw),
            None if ew is None else jnp.asarray(ew)))
        got = tkeys.words_in_range(
            tw, tkeys.words_tensor(sw, CPU), tkeys.words_tensor(ew, CPU))
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tkeys.encode_bounds(raw, 16),
                                  jkeys.encode_bounds(raw, 16))
    for w in (jw[0], np.array([0, 2**64 - 1], np.uint64),
              np.array([2**64 - 1] * 2, np.uint64)):
        np.testing.assert_array_equal(tkeys.bound_next(w),
                                      jkeys.bound_next(w))


def test_kvblock_from_numpy_roundtrip():
    rng = np.random.default_rng(1)
    f = _fields(rng, 50, cap=64, sort=False)
    _assert_blocks_equal(_port_np(_port(_np(_jax(f)))), f)
    bad = dict(f, ts=f["ts"].astype(np.int32))
    with pytest.raises(TypeError):
        tmvcc.kvblock_from_numpy(bad, CPU)


# ------------------------------------------------------------- sorting


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_and_merge_match_reference(seed):
    rng = np.random.default_rng(seed)
    f = _fields(rng, 200, cap=256, sort=False)
    _assert_blocks_equal(_port_np(tmvcc.sort_block(_port(f))),
                         _np(jmvcc.sort_block(_jax(f))))
    runs = [_fields(rng, int(n), cap=128) for n in (100, 128, 37)]
    want = jmvcc.merge_blocks(tuple(_jax(r) for r in runs), cap=512)
    got = tmvcc.merge_blocks(tuple(_port(r) for r in runs), cap=512)
    _assert_blocks_equal(_port_np(got), _np(want))


# ------------------------------------------------------------- filters


@pytest.mark.parametrize("seed", [2, 3])
def test_scan_filter_matches_reference(seed):
    rng = np.random.default_rng(seed)
    f = _fields(rng, 240, cap=256)
    jb, tb = _jax(f), _port(f)
    bounds = [(None, None), (b"k00010", b"k00030"), (b"k00005", None),
              (None, b"\xff\x80k00020")]
    for read_ts, reader in ((50, 0), (10, 1), (99, 2), (-3, 0)):
        for lo, hi in bounds:
            sw = jkeys.encode_bound(lo, 16)
            ew = jkeys.encode_bound(hi, 16)
            want = jmvcc.mvcc_scan_filter(
                jb, jnp.int64(read_ts), jnp.int64(reader),
                None if sw is None else jnp.asarray(sw),
                None if ew is None else jnp.asarray(ew))
            got = tmvcc.mvcc_scan_filter(tb, read_ts, reader, _words_t(sw),
                                         _words_t(ew))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        want = jmvcc.mvcc_scan_filter(jb, jnp.int64(read_ts),
                                      jnp.int64(reader), window=64)
        got = tmvcc.mvcc_scan_filter(tb, read_ts, reader, window=64)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("bottom", [False, True])
def test_gc_filter_matches_reference(bottom):
    rng = np.random.default_rng(4)
    f = _fields(rng, 250, cap=256)
    for gc_ts in (0, 30, 90):
        want = jmvcc.mvcc_gc_filter(_jax(f), jnp.int64(gc_ts), bottom)
        got = tmvcc.mvcc_gc_filter(_port(f), gc_ts, bottom)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("commit", [False, True])
def test_resolve_intents_matches_reference(commit):
    rng = np.random.default_rng(5)
    f = _fields(rng, 100, cap=128)
    want = jmvcc.resolve_intents(_jax(f), jnp.int64(1), jnp.int64(77),
                                 commit)
    got = tmvcc.resolve_intents(_port(f), 1, 77, commit)
    _assert_blocks_equal(_port_np(got), _np(want))


# ---------------------------------------------------------- multi-scan


def test_seek_positions_matches_reference():
    rng = np.random.default_rng(6)
    f = _fields(rng, 120, cap=128)
    words = np.asarray(jkeys.key_words(jnp.asarray(f["key"])))
    n_live = int(f["mask"].sum())
    q = jkeys.encode_bounds(
        [b"k%05d" % i for i in rng.integers(0, 45, 20)] + [b"\xff\xff", b""],
        16)
    want = jmvcc.seek_positions(jnp.asarray(words), jnp.asarray(q),
                                jnp.int32(n_live))
    got = tmvcc.seek_positions(_words_t(words), _words_t(q), n_live)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_multi_scan_and_emit_match_reference():
    rng = np.random.default_rng(7)
    sources = [_fields(rng, n, cap=cap, nkeys=300)
               for n, cap in ((100, 128), (1000, 1024), (700, 1024))]
    starts = jkeys.encode_bounds(
        [b"k%05d" % i for i in rng.integers(0, 300, 8)], 16)
    B, max_keys = len(starts), 16
    for window, read_ts, reader in ((128, 60, 0), (128, 20, 1),
                                    (256, 99, 2)):
        want = jmvcc.multi_scan_sources(
            tuple(_jax(s) for s in sources), jnp.asarray(starts),
            jnp.int64(read_ts), jnp.int64(reader), window)
        got = tmvcc.multi_scan_sources(
            tuple(_port(s) for s in sources), _words_t(starts), read_ts,
            reader, window)
        _assert_blocks_equal(_port_np(got[0]), _np(want[0]))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        flags = np.array(want[1] & want[3])
        jemit = jmvcc._emit_stage(want[0], jnp.asarray(flags), B, max_keys)
        temit = tmvcc._emit_stage(got[0], torch.from_numpy(flags), B,
                                  max_keys)
        for g, w in zip(temit, jemit):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
