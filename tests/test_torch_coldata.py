"""The port's columnar layer against the JAX reference on the CPU: TPC-H
generation, the catalog (padding, stats, dense-key detection, device
batches), batch construction, readback, compaction and dictionaries."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cockroach_tpu.catalog as jcatalog
from cockroach_tpu import coldata as jcd
from cockroach_tpu.bench import tpch as jtpch
from cockroach_tpu.coldata import batch as jbatch
from cockroach_tpu_torch import catalog as tcatalog
from cockroach_tpu_torch.bench import tpch as ttpch
from cockroach_tpu_torch.bench.tpch_run import run_tpch
from cockroach_tpu_torch.coldata import batch as tbatch
from cockroach_tpu_torch.coldata import types as tty

SF, SEED = 0.005, 7
TABLES = ("region", "nation", "supplier", "part", "partsupp", "customer",
          "orders", "lineitem")


# scales at which the port's generator (dictionary codes built straight
# from the pool draws) is held to the reference's
GEN_SFS = (SF, 0.01, 0.05)


@pytest.fixture(scope="module")
def gen_cats():
    """{sf: (reference catalog, port catalog)}, made on first use."""
    cache = {}

    def get(sf):
        if sf not in cache:
            cache[sf] = (jtpch.gen_tpch(sf=sf, seed=SEED),
                         ttpch.gen_tpch(sf=sf, seed=SEED, device="cpu"))
        return cache[sf]

    return get


@pytest.fixture(scope="module")
def ref_cat(gen_cats):
    return gen_cats(SF)[0]


@pytest.fixture(scope="module")
def port_cat(gen_cats):
    return gen_cats(SF)[1]


def host_tables(cat) -> dict:
    """The reference catalog's tables as the plain arrays
    catalog_from_host takes."""
    out = {}
    for name, t in cat.tables.items():
        out[name] = {
            "columns": {c: np.asarray(t.columns[c]) for c in t.schema.names},
            "types": {c: (ty.family.value, ty.width, ty.precision, ty.scale)
                      for c, ty in zip(t.schema.names, t.schema.types)},
            "valids": {c: np.asarray(v) for c, v in t.valids.items()},
            "dictionaries": {c: d.values for c, d in t.dictionaries.items()},
            "ordering": t.ordering,
        }
    return out


def port_type(t) -> tty.SQLType:
    return tty.SQLType(tty.Family(t.family.value), t.width, t.precision,
                       t.scale)


@pytest.mark.parametrize("sf", GEN_SFS)
@pytest.mark.parametrize("table", TABLES)
def test_gen_tpch_matches_reference(gen_cats, table, sf):
    ref_cat, port_cat = gen_cats(sf)
    r, p = ref_cat.get(table), port_cat.get(table)
    assert p.schema.names == tuple(r.schema.names)
    assert p.schema.types == tuple(port_type(t) for t in r.schema.types)
    assert p.ordering == tuple(r.ordering)
    assert set(p.valids) == set(r.valids)
    for c in r.schema.names:
        a, b = np.asarray(r.columns[c]), np.asarray(p.columns[c])
        assert a.dtype == b.dtype and np.array_equal(a, b), c
    assert set(p.dictionaries) == set(r.dictionaries)
    for c, d in r.dictionaries.items():
        assert np.array_equal(d.values, p.dictionaries[c].values), c


@pytest.mark.parametrize("table", TABLES)
def test_catalog_from_host_matches_reference(ref_cat, table):
    """The catalog built from the reference's host arrays uploads the same
    padded batch, with the same stats and dense-key structure."""
    cat = tcatalog.catalog_from_host({table: host_tables(ref_cat)[table]},
                                     device="cpu")
    r, p = ref_cat.get(table), cat.get(table)
    assert p.col_stats() == r.col_stats()
    assert p.dense_key_info() == r.dense_key_info()
    rb, pb = r.device_batch(), p.device_batch()
    assert pb.capacity == rb.capacity
    np.testing.assert_array_equal(pb.mask.numpy(), np.asarray(rb.mask))
    for rc, pc in zip(rb.cols, pb.cols):
        np.testing.assert_array_equal(pc.data.numpy(), np.asarray(rc.data))
        np.testing.assert_array_equal(pc.valid.numpy(), np.asarray(rc.valid))


def test_catalog_from_host_with_nulls_matches_reference():
    """NULLs narrow the stats, break dense-key detection and upload as
    invalid rows, as in the reference."""
    rng = np.random.default_rng(9)
    n = 3000
    cols = {"k": np.arange(10, 10 + n), "v": rng.integers(-50, 50, n),
            "d": rng.integers(0, 9, n), "s": rng.integers(0, 3, n).astype(
                np.int32)}
    valids = {"v": rng.random(n) < 0.7, "d": np.arange(n) > 0}
    valids["v"][np.argmin(cols["v"])] = False
    jschema = jcd.Schema.of(k=jcd.INT64, v=jcd.INT64, d=jcd.DATE,
                            s=jcd.STRING)
    words = np.array(["x", "y", "z"], dtype=object)
    ref = jcatalog.Table("t", jschema, cols, valids=valids,
                         dictionaries={"s": jcd.Dictionary(words)})
    cat = tcatalog.catalog_from_host({"t": {
        "columns": cols, "valids": valids, "dictionaries": {"s": words},
        "types": {c: (t.family.value, t.width, t.precision, t.scale)
                  for c, t in zip(jschema.names, jschema.types)},
    }}, device="cpu")
    t = cat.get("t")
    assert t.col_stats() == ref.col_stats()
    assert t.dense_key_info() == ref.dense_key_info() == {"k": (10, 1)}
    rb, tb = ref.device_batch(), t.device_batch()
    for rc, tc in zip(rb.cols, tb.cols):
        np.testing.assert_array_equal(tc.data.numpy(), np.asarray(rc.data))
        np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(rc.valid))


@pytest.mark.parametrize("n", [0, 1, 1000, 1024, 1025, 8192, 70_000,
                               600_000, (1 << 20) + 1, 3 * (1 << 20) - 5,
                               6_002_051])
def test_pad_cap_matches_reference(n):
    tile = 1 << 20
    assert tcatalog._pad_cap(n, tile) == jcatalog._pad_cap(n, tile)
    assert tcatalog._bucket_cap(n) == jcatalog._bucket_cap(n)


def _mixed_batches(rng, n=40, cap=64):
    jschema = jcd.Schema.of(i=jcd.INT64, f=jcd.FLOAT64, d=jcd.DECIMAL(12, 2),
                            dt=jcd.DATE, s=jcd.STRING, b=jcd.BOOL)
    tschema = tty.Schema(jschema.names,
                         tuple(port_type(t) for t in jschema.types))
    arrays = {
        "i": rng.integers(-50, 50, n), "f": rng.normal(size=n),
        "d": rng.integers(-10_000, 10_000, n),
        "dt": rng.integers(0, 20_000, n).astype(np.int32),
        "s": rng.integers(0, 4, n).astype(np.int32),
        "b": rng.random(n) < 0.5,
    }
    valids = {"i": rng.random(n) < 0.8, "d": rng.random(n) < 0.7,
              "s": rng.random(n) < 0.9}
    jb = jcd.from_host(jschema, arrays, valids=valids, capacity=cap)
    tb = tbatch.from_host(tschema, arrays, valids=valids, capacity=cap,
                          device="cpu")
    return jschema, tschema, jb, tb


def _same_host(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype, k
        assert a.shape == b.shape and all(
            x == y or (x is None and y is None) for x, y in zip(a, b)), k


def test_from_host_to_host_matches_reference():
    rng = np.random.default_rng(3)
    jschema, tschema, jb, tb = _mixed_batches(rng)
    vals = np.array(["pear", "apple", "fig", "kiwi"], dtype=object)
    jd, td = jcd.Dictionary(vals), tbatch.Dictionary(vals)
    _same_host(tbatch.to_host(tb, tschema, {4: td}),
               jcd.to_host(jb, jschema, {4: jd}))


@pytest.mark.parametrize("cap_out", [16, 40, 64, 128])
def test_compact_matches_reference(cap_out):
    rng = np.random.default_rng(cap_out)
    jschema, tschema, jb, tb = _mixed_batches(rng)
    mask = rng.random(64) < 0.3
    jb = jb.with_mask(jb.mask & mask)
    tb = tb.with_mask(tb.mask & torch.from_numpy(mask))
    want = jbatch.compact(jb, capacity=cap_out)
    got = tbatch.compact(tb, capacity=cap_out)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    for jc, tc in zip(want.cols, got.cols):
        np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data))
        np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))


def test_concat_matches_reference():
    rng = np.random.default_rng(11)
    parts = [_mixed_batches(rng) for _ in range(3)]
    masks = [rng.random(64) < p for p in (0.2, 0.0, 0.6)]
    jbs = [p[2].with_mask(p[2].mask & m) for p, m in zip(parts, masks)]
    tbs = [p[3].with_mask(p[3].mask & torch.from_numpy(m))
           for p, m in zip(parts, masks)]
    want = jbatch.concat(jbs, capacity=128)
    got = tbatch.concat(tbs, capacity=128)
    _same_host(tbatch.to_host(got, parts[0][1]),
               jcd.to_host(want, parts[0][0]))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def test_dictionary_matches_reference():
    vals = np.array(["b", "a", "", "é", "ab", "zz", "a b"], dtype=object)
    j, t = jcd.Dictionary(vals), tbatch.Dictionary(vals)
    np.testing.assert_array_equal(t.ranks, j.ranks)
    np.testing.assert_array_equal(t.hashes, j.hashes)
    for v in ("a", "zz", "nope", ""):
        assert t.code_of(v) == j.code_of(v)
    codes = np.array([0, 6, -1, 7, 3])
    assert list(t.decode(codes)) == list(j.decode(codes))


def test_pack_be_words_matches_reference():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (50, 13)).astype(np.uint8)
    want = np.asarray(jbatch.pack_be_words(jnp.asarray(data)))
    got = tbatch.pack_be_words(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), want)


def test_entry_points_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ttpch.gen_tpch(sf=0.0005)
    with pytest.raises(RuntimeError, match="cuda"):
        tcatalog.Catalog()
    with pytest.raises(RuntimeError, match="cuda"):
        tcatalog.catalog_from_host({})
    with pytest.raises(RuntimeError, match="cuda"):
        run_tpch(sf=0.0005, runs=1)
    assert tcatalog.Catalog("cpu").device.type == "cpu"
