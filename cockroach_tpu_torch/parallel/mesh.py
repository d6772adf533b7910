"""Device mesh and its collectives — the port of
``cockroach_tpu.parallel.mesh`` and of the collectives the reference
runs inside ``shard_map``.

The reference's mesh is a ``jax.sharding.Mesh`` whose one axis ("d")
plays DistSQL's node set; ``shard_map`` traces one per-device function
and ``all_to_all``, ``all_gather``, ``psum``, ``pmin`` and ``pmax`` move
data between the devices. PyTorch has no ``shard_map``, so the port runs
the mesh from a single controller: a ``Mesh`` is D shards, each a torch
device (devices may repeat: a mesh of D shards can live on one card, as
the reference's tests run on 8 virtual CPU devices), per-shard values
are Python lists of length D, local work maps over the list, and every
collective below is an explicit function of the whole list.

Shards on one device share tensors where a collective's result is the
same for every shard (a gather, a reduction): the data is identical, so
one copy serves them all. Shards on distinct devices get their own copy,
moved with ``.to(device, non_blocking=True)``.
"""

from __future__ import annotations

import torch

from ..coldata.batch import Batch, Column
from ..device import resolve_device

class Mesh:
    """D shards over torch devices (devices may repeat)."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def one_device(self) -> bool:
        """Every shard on the same device (one CUDA graph can hold the
        whole program)."""
        return len(set(self.devices)) == 1

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None, device="cuda",
              devices=None) -> Mesh:
    """A mesh of `n_devices` shards on `device` (one card holds them all),
    or over the given `devices`. With neither count nor list, one shard
    per visible card (one shard on the CPU)."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        for d in devs:
            resolve_device(d)
        return Mesh(devs[:n_devices] if n_devices is not None else devs)
    dev = resolve_device(device)
    if n_devices is None:
        if dev.type == "cuda" and dev.index is None:
            return Mesh([torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())])
        n_devices = 1
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh([dev] * n_devices)


# ---------------------------------------------------------------------------
# per-shard trees: a Batch, a tensor, or tuples/lists of them


def tree_map(fn, *trees):
    """`fn` over the tensors of equally shaped trees (Batch, Column,
    tuple, list, tensor)."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if isinstance(t, Batch):
        return Batch(cols=tuple(tree_map(fn, *cs)
                                for cs in zip(*(x.cols for x in trees))),
                     mask=fn(*(x.mask for x in trees)))
    if isinstance(t, Column):
        return Column(data=fn(*(x.data for x in trees)),
                      valid=fn(*(x.valid for x in trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    raise TypeError(f"not a tensor tree: {type(t).__name__}")


def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return x if x.device == dev else x.to(dev, non_blocking=True)


def per_device(mesh: Mesh, make) -> list:
    """[make(device) for each shard], made once per distinct device."""
    made: dict = {}
    return [made[d] if d in made else made.setdefault(d, make(d))
            for d in mesh.devices]


# ---------------------------------------------------------------------------
# placement


def shard_rows(tree, mesh: Mesh) -> list:
    """Row sharding (``NamedSharding(P(AXIS))``): shard i holds rows
    [i*cap/D, (i+1)*cap/D) of every leaf, on its device, in buffers of
    its own. The capacity must divide by D."""
    D = mesh.size

    def piece(i):
        def cut(x):
            n = x.shape[0]
            if n % D:
                raise ValueError(f"capacity {n} does not divide by {D}")
            c = n // D
            return _to(x[i * c:(i + 1) * c], mesh.devices[i]).clone()
        return tree_map(cut, tree)

    return [piece(i) for i in range(D)]


# ---------------------------------------------------------------------------
# collectives


def all_to_all(sends: list, mesh: Mesh) -> list:
    """``lax.all_to_all(split_axis=0, concat_axis=0)``: every leaf of
    ``sends[i]`` is [D, n, ...]; shard j receives the concatenation of
    ``sends[i][j]`` over i, shaped [D*n, ...]."""
    D = mesh.size

    def recv(j):
        dev = mesh.devices[j]
        return tree_map(
            lambda *xs: torch.cat([_to(x[j], dev) for x in xs]), *sends)

    return [recv(j) for j in range(D)]


def all_gather(xs: list, mesh: Mesh) -> list:
    """``lax.all_gather(tiled=True)``: the concatenation of every shard's
    leaves along axis 0, on every shard."""
    return per_device(mesh, lambda d: tree_map(
        lambda *ls: torch.cat([_to(x, d) for x in ls]), *xs))


def _reduce(op, xs: list, mesh: Mesh) -> list:
    def on(d):
        acc = _to(xs[0], d)
        for x in xs[1:]:
            acc = op(acc, _to(x, d))
        return acc

    return per_device(mesh, on)


def psum(xs: list, mesh: Mesh) -> list:
    """Elementwise sum over the shards (shard order), on every shard."""
    return _reduce(torch.add, xs, mesh)


def pmin(xs: list, mesh: Mesh) -> list:
    return _reduce(torch.minimum, xs, mesh)


def pmax(xs: list, mesh: Mesh) -> list:
    return _reduce(torch.maximum, xs, mesh)


def program(fn, mesh: Mesh):
    """The per-attempt program over all shards, counted as one dispatch:
    on one card ``flow.dispatch.jit`` captures it as one CUDA graph, in a
    memory pool of its own that is released with the program, and
    replays it; over distinct devices (one graph cannot span devices) it
    runs eagerly, counted."""
    from ..flow import dispatch

    if mesh.one_device:
        return dispatch.jit(fn, own_pool=True)
    return dispatch.counted(fn)
