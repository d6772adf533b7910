"""The port's SPMD plane (parallel/mesh, shuffle, dist and the mesh
reduction of dense states) against the JAX reference on the CPU: the same
seeded numpy batches go through the reference's functions on
``make_mesh(8)`` (8 virtual CPU devices) and through the port's on an
8-shard CPU mesh (and a 3-shard one, where the shuffle's unsigned
remainder differs from a signed one). Every shard's live rows, mask and
overflow count are equal exactly; FLOAT states within rtol=1e-12 (the
shards' partial sums add in another order)."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from cockroach_tpu import coldata as jcd
from cockroach_tpu.flow import dispatch as jdispatch
from cockroach_tpu.ops import aggregation as jagg
from cockroach_tpu.ops import hashing as jhash
from cockroach_tpu.ops import join as jjoin
from cockroach_tpu.parallel import dist as jdist
from cockroach_tpu.parallel import mesh as jmesh
from cockroach_tpu.parallel import shuffle as jshuf
from cockroach_tpu.parallel._compat import shard_map
from cockroach_tpu_torch.coldata import batch as tbatch
from cockroach_tpu_torch.flow import dispatch as tdispatch
from cockroach_tpu_torch.ops import aggregation as tagg
from cockroach_tpu_torch.ops import hashing as thash
from cockroach_tpu_torch.ops import join as tjoin
from cockroach_tpu_torch.parallel import dist as tdist
from cockroach_tpu_torch.parallel import mesh as tmesh
from cockroach_tpu_torch.parallel import shuffle as tshuf
from test_torch_sqlops import port_out, same

D = 8


@pytest.fixture(scope="module")
def jm():
    return jmesh.make_mesh(D)


@pytest.fixture(scope="module")
def tm():
    return tmesh.make_mesh(D, device="cpu")


def sharded(jm, tm, schema, arrays, cap_per_shard, valids=None):
    """The same host columns row-sharded in both packages."""
    total = cap_per_shard * tm.size
    jb = jcd.from_host(schema, arrays, valids=valids, capacity=total)
    tb = tbatch.from_host(port_out(schema), arrays, valids=valids,
                          capacity=total, device="cpu")
    return jdist.shard_batch(jb, jm), tdist.shard_batch(tb, tm)


def ref_shard(jout, i: int, n: int):
    """Shard i of a reference P(AXIS) output (n shards)."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x).reshape((n, -1) + x.shape[1:])[i], jout)


def same_shards(jout, touts, rtol=1e-12):
    """Every shard: mask equal, live rows' data and valid equal."""
    for i, tb in enumerate(touts):
        jb = ref_shard(jout, i, len(touts))
        m = np.asarray(jb.mask)
        same(tb.mask, m)
        assert len(tb.cols) == len(jb.cols)
        for tc, jc in zip(tb.cols, jb.cols):
            same(tc.valid, jc.valid, where=m)
            same(tc.data, jc.data, where=m & np.asarray(jc.valid),
                 rtol=rtol)


def test_mesh_shapes_and_placements(tm):
    assert tm.size == D and tm.one_device
    x = torch.arange(16)
    parts = tmesh.shard_rows(x, tmesh.make_mesh(4, device="cpu"))
    assert [p.tolist() for p in parts] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                           [8, 9, 10, 11], [12, 13, 14, 15]]
    m4 = tmesh.make_mesh(4, device="cpu")
    sends = [torch.arange(8).reshape(4, 2) + 10 * i for i in range(4)]
    recv = tmesh.all_to_all(sends, m4)
    # shard j receives block j of every sender, senders in order
    assert recv[1].tolist() == [2, 3, 12, 13, 22, 23, 32, 33]
    assert tmesh.all_gather(parts, m4)[3].tolist() == list(range(16))
    assert tmesh.psum(parts, m4)[0].tolist() == [24, 28, 32, 36]
    assert tmesh.pmin(parts, m4)[2].tolist() == [0, 1, 2, 3]
    assert tmesh.pmax(parts, m4)[0].tolist() == [12, 13, 14, 15]
    with pytest.raises(ValueError):
        tmesh.shard_rows(torch.arange(10), m4)


@pytest.mark.parametrize("hot", [False, True])
def test_shuffle_matches_reference(jm, tm, hot):
    rng = np.random.default_rng(5)
    schema = jcd.Schema.of(k=jcd.INT64, s=jcd.STRING, v=jcd.FLOAT64)
    n = 3000
    k = rng.integers(0, 100, n)
    codes = rng.integers(0, 7, n).astype(np.int32)
    d = jcd.Dictionary(np.array([f"w{i}" for i in range(7)], dtype=object))
    valids = {"v": rng.random(n) > 0.1}
    arrays = {"k": k, "s": codes, "v": rng.standard_normal(n)}
    jb, tbs = sharded(jm, tm, schema, arrays, 512, valids)
    hot_hashes = None
    if hot:  # the keys of the first two rows stay on their shards
        g = jcd.from_host(schema, arrays, valids=valids)
        hot_hashes = np.asarray(jhash.hash_columns(
            [g.cols[0], g.cols[1]], [jcd.INT64, jcd.STRING],
            {1: d.hashes}))[:2]
    args = dict(schema=schema, keys=(0, 1), local_capacity=512,
                hash_tables={1: d.hashes}, send_factor=4.0,
                out_capacity=1024, hot_hashes=hot_hashes)
    jout, jovf = jshuf.make_shuffle(jm, **args)(jb)
    args["schema"] = port_out(schema)
    tout, tovf = tshuf.make_shuffle(tm, **args)(tbs)
    same(tovf, np.asarray(jovf))
    assert int(tovf.sum()) == 0
    same_shards(jout, tout)


def test_shuffle_overflow_counts_match(jm, tm):
    """Every row on one key: one shard receives everything, the send
    buckets overflow, and the counts per shard equal the reference's."""
    schema = jcd.Schema.of(k=jcd.INT64)
    jb, tbs = sharded(jm, tm, schema, {"k": np.zeros(4000, np.int64)}, 512)
    args = dict(schema=schema, keys=(0,), local_capacity=512,
                send_factor=1.0)
    jout, jovf = jshuf.make_shuffle(jm, **args)(jb)
    args["schema"] = port_out(schema)
    tout, tovf = tshuf.make_shuffle(tm, **args)(tbs)
    assert int(tovf.sum()) > 0
    same(tovf, np.asarray(jovf))
    same_shards(jout, tout)


def test_shuffle_three_shards_unsigned_remainder():
    """D=3: the bucket is the UNSIGNED remainder of the 64-bit hash (a
    signed one differs for hashes with bit 63 set); three reference
    devices against three port shards."""
    jm3 = jmesh.make_mesh(3)
    tm3 = tmesh.make_mesh(3, device="cpu")
    rng = np.random.default_rng(9)
    schema = jcd.Schema.of(k=jcd.INT64, v=jcd.INT64)
    n = 2500
    arrays = {"k": rng.integers(-10**12, 10**12, n), "v": np.arange(n)}
    jb, tbs = sharded(jm3, tm3, schema, arrays, 1024)
    h = thash.hash_columns([tbs[0].cols[0]], [port_out(schema).types[0]])
    assert bool((h < 0).any())  # bit 63 set: signed % would differ
    args = dict(schema=schema, keys=(0,), local_capacity=1024,
                out_capacity=2048)
    jout, jovf = jshuf.make_shuffle(jm3, **args)(jb)
    args["schema"] = port_out(schema)
    tout, tovf = tshuf.make_shuffle(tm3, **args)(tbs)
    same(tovf, np.asarray(jovf))
    same_shards(jout, tout)
    # every key on exactly one shard
    owner = {}
    for i, b in enumerate(tout):
        for key in b.cols[0].data[b.mask].tolist():
            assert owner.setdefault(key, i) == i


def test_distributed_groupby_matches_reference(jm, tm):
    rng = np.random.default_rng(42)
    schema = jcd.Schema.of(g=jcd.INT64, v=jcd.INT64, f=jcd.DECIMAL(12, 2))
    n = 4000
    arrays = {"g": rng.integers(0, 50, n), "v": rng.integers(-1000, 1000, n),
              "f": rng.integers(0, 10**6, n)}
    jb, tbs = sharded(jm, tm, schema, arrays, 512)
    specs = (("sum", 1, "s"), ("avg", 2, "a"), ("count_rows", None, "n"),
             ("min", 2, "lo"))
    jfn, jschema = jdist.make_distributed_groupby(
        jm, schema, (0,), tuple(jagg.AggSpec(*s) for s in specs),
        local_capacity=512)
    tfn, tschema = tdist.make_distributed_groupby(
        tm, port_out(schema), (0,), tuple(tagg.AggSpec(*s) for s in specs),
        local_capacity=512)
    assert tschema.names == jschema.names
    jout, jovf = jfn(jb)
    d0 = tdispatch.total()
    tout, tovf = tfn(tbs)
    assert tdispatch.total() - d0 == 1  # one program, one dispatch
    same(tovf, np.asarray(jovf))
    same_shards(jout, tout)


def test_distributed_join_matches_reference(jm, tm):
    rng = np.random.default_rng(7)
    pschema = jcd.Schema.of(pk=jcd.INT64, pv=jcd.INT64)
    bschema = jcd.Schema.of(bk=jcd.INT64, bv=jcd.INT64)
    npr, nb = 3000, 800
    pk = rng.integers(0, 1000, npr)
    bk = rng.permutation(1000)[:nb]
    jp, tps = sharded(jm, tm, pschema, {"pk": pk, "pv": np.arange(npr)}, 512)
    jb, tbs = sharded(jm, tm, bschema, {"bk": bk, "bv": bk * 7}, 128)
    args = dict(probe_keys=(0,), build_keys=(0,), probe_capacity=512,
                build_capacity=128)
    jfn, jschema = jdist.make_distributed_join(
        jm, pschema, build_schema=bschema, spec=jjoin.JoinSpec("inner", True),
        **args)
    tfn, tschema = tdist.make_distributed_join(
        tm, port_out(pschema), build_schema=port_out(bschema),
        spec=tjoin.JoinSpec("inner", True), **args)
    assert tschema.names == jschema.names
    jout, jovf = jfn(jp, jb)
    tout, tovf = tfn(tps, tbs)
    same(tovf, np.asarray(jovf))
    same_shards(jout, tout)


def test_psum_dense_states_matches_reference(jm, tm):
    """Dense states of every reducible kind, made per shard and reduced
    across the mesh (psum / pmin / pmax / OR of valid flags)."""
    rng = np.random.default_rng(3)
    schema = jcd.Schema.of(g=jcd.INT64, i=jcd.INT64, f=jcd.FLOAT64,
                           d=jcd.DECIMAL(12, 2))
    n = 3000
    arrays = {"g": rng.integers(0, 6, n), "i": rng.integers(-50, 50, n),
              "f": rng.standard_normal(n), "d": rng.integers(0, 10**5, n)}
    valids = {"i": rng.random(n) > 0.2, "f": rng.random(n) > 0.2}
    jb, tbs = sharded(jm, tm, schema, arrays, 512, valids)
    raw = (("sum", 1), ("sum", 2), ("sum", 3), ("count", 1),
           ("count_rows", None), ("min", 2), ("max", 1), ("any_not_null", 3))
    sizes = (6,)
    G, strides = jagg.dense_layout(sizes)
    jspecs = tuple(jagg.AggSpec(f, c) for f, c in raw)
    tspecs = tuple(tagg.AggSpec(f, c) for f, c in raw)

    def jlocal(b):
        code, _ = jagg.dense_group_codes(b, (0,), strides, sizes)
        st, rows = jagg.dense_scatter_states(b, schema, code, G, jspecs)
        st = jagg.psum_dense_states(jspecs, st, jmesh.AXIS)
        return st, jax.lax.psum(rows, jmesh.AXIS)

    jst, jrows = jdispatch.jit(shard_map(
        jlocal, mesh=jm, in_specs=(P(jmesh.AXIS),), out_specs=P(),
        check_vma=False))(jb)
    tschema = port_out(schema)
    parts = []
    for b in tbs:
        code, _ = tagg.dense_group_codes(b, (0,), strides, sizes)
        parts.append(tagg.dense_scatter_states(b, tschema, code, G, tspecs))
    tst = tagg.psum_dense_states(tspecs, [p[0] for p in parts], tm)
    trows = tmesh.psum([p[1] for p in parts], tm)
    assert len(tst) == D
    for s in range(D):
        same(trows[s], jrows)
        for (td, tv), (jd, jv) in zip(tst[s], jst):
            same(tv, jv)
            same(td, jd, where=np.asarray(jv))
