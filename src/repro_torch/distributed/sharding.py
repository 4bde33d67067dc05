"""Logical-axis sharding policy and placement (the port of
``repro.distributed.sharding``): model code names logical axes, the
policy maps them to mesh axes. ``mesh=None`` maps every axis to size 1,
so the same code runs on one device.

Logical axes:
  dp     data parallel (batch)                  -> ('pod', 'data') / ('data',)
  tp     tensor parallel (heads/ffn/vocab/experts/channels/corpus)
  sp     sequence parallel (long-context KV / activations)
  flat   everything (node/edge/candidate sharding over all devices)

``PartitionSpec`` (``P``) holds one entry per dimension: None, one mesh
axis name, or a tuple of two or more, as ``jax.sharding.PartitionSpec``
stores it. A ``NamedSharding`` is a mesh plus a spec, and ``device_put``
places a tensor by one: it splits the tensor into one slab per mesh
position (``split``), each on that position's device. ``split`` is the
one splitting rule of the port: ``shard_map`` splits its arguments by it
and the retrieval store lays its slabs out by it. ``device_put`` also
places a whole tree (a tree of shardings beside it), and a numpy array
block by block from the host, so no device ever holds a whole leaf that
its sharding splits.

``ShardingPolicy.constrain`` is ``repro``'s ``with_sharding_constraint``
for the partitioned model code: the identity without a mesh (and outside
a ``shard_map`` body, where tensors are whole), and inside a body the
move of this position's block from the layout it ``have``s to the named
one: a slice where a dimension becomes split, an ``all_gather`` where it
becomes whole, an ``all_to_all`` where one dimension does each over the
same axes (Megatron-SP's sequence <-> heads). The backward of each is
that of ``shard_map``'s collectives (a slice's is local, so a replicated
value's cotangents add up over the positions, as ``psum``'s transpose
wants; a gather's is a reduce-scatter; an all_to_all's the inverse one).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from math import prod

import numpy as np
import torch

DEFAULT_RULES = {
    "dp": ("data",),
    "tp": ("model",),
    "sp": ("model",),
    "flat": ("data", "model"),
}


def _canonical(entry):
    """One dimension's entry as ``PartitionSpec`` stores it: a 1-tuple of
    axis names as its name, an empty tuple as None."""
    if isinstance(entry, list):
        entry = tuple(entry)
    if isinstance(entry, tuple) and len(entry) <= 1:
        return entry[0] if entry else None
    return entry


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a tensor (``jax.sharding.PartitionSpec``):
    a tuple, so it compares equal to the plain tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}".replace(",)", ")")


P = PartitionSpec


def axes_of(entry) -> tuple:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def rules_for_mesh(mesh) -> dict:
    rules = {k: tuple(v) for k, v in DEFAULT_RULES.items()}
    if mesh is not None and "pod" in mesh.axis_names:
        rules["dp"] = ("pod", "data")
        rules["flat"] = ("pod", "data", "model")
    return rules


@dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout on a mesh: ``spec`` names the mesh axes each
    dimension is split over (``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: PartitionSpec


class ShardingPolicy:
    """``batch`` and ``sp`` are the context a partitioned body's model code
    reads (``body``): the global batch (a batch of 1 is not split) and
    whether the residual stream is sequence-parallel."""
    batch = None
    sp = False

    def __init__(self, mesh, rules: dict | None = None,
                 overrides: dict | None = None):
        self.mesh = mesh
        self.rules = dict(rules or rules_for_mesh(mesh))
        if overrides:
            self.rules.update(overrides)

    def body(self, batch: int | None = None, sp: bool | None = None):
        """A copy carrying a body's context: the global ``batch`` and the
        residual's sequence parallelism ``sp``."""
        out = copy.copy(self)
        if batch is not None:
            out.batch = batch
        if sp is not None:
            out.sp = sp
        return out

    def axes(self, logical) -> tuple:
        """The mesh axes of a logical axis, as a tuple (() for none)."""
        return axes_of(self._resolve(logical))

    def _resolve(self, axis):
        if axis is None:
            return None
        if isinstance(axis, (tuple, list)):
            out: list = []
            for a in axis:
                r = self._resolve(a)
                if r is None:
                    continue
                out.extend(r if isinstance(r, tuple) else (r,))
            return tuple(out) if out else None
        got = self.rules.get(axis, axis)
        if isinstance(got, (tuple, list)):
            got = tuple(got)
            return got if len(got) != 1 else got[0]
        return got

    def spec(self, *axes) -> PartitionSpec:
        return PartitionSpec(*[self._resolve(a) for a in axes])

    def named(self, *axes) -> NamedSharding | None:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.spec(*axes))

    def constrain(self, x, *axes, have=None):
        """``x`` laid out as ``axes`` (logical, one per dimension). The
        identity without a mesh or outside a ``shard_map`` body; inside
        one, ``x`` is this position's block under ``have`` (logical axes,
        default every dimension whole) and the result its block under
        ``axes``."""
        from repro_torch.distributed import shard_map as SM
        if self.mesh is None or not SM.in_shard_map():
            return x
        have = (None,) * x.ndim if have is None else have
        return SM.relayout(x, self.spec(*have), self.spec(*axes))

    def axis_size(self, logical: str) -> int:
        if self.mesh is None:
            return 1
        r = self._resolve(logical)
        if r is None:
            return 1
        if isinstance(r, str):
            r = (r,)
        n = 1
        for a in r:
            n *= self.mesh.shape[a]
        return n

    def tree_shardings(self, tree_of_specs):
        """Map a tree (dicts and lists) of logical-axis tuples to
        ``NamedSharding``s, or None without a mesh."""
        if self.mesh is None:
            return None
        return map_specs(lambda axes: self.named(*axes), tree_of_specs)


def is_spec(x) -> bool:
    """A leaf of a spec tree: a tuple of None, names and tuples of names."""
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, (str, tuple, list)) for a in x)


def map_specs(fn, tree):
    """``fn`` over every spec leaf of a tree of dicts and lists."""
    if is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_specs(fn, v) for v in tree]
    return fn(tree)


def divisible(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


# ---------------------------------------------------------------------------
# placement: one slab per mesh position
# ---------------------------------------------------------------------------

def mesh_coords(mesh) -> list:
    """Every mesh position's coordinates, {axis name: index}, in mesh
    order (``mesh.devices.flat``)."""
    names, sizes = mesh.axis_names, tuple(mesh.devices.shape)
    out = []
    for flat in range(prod(sizes)):
        c, rem = {}, flat
        for a, s in zip(reversed(names), reversed(sizes)):
            c[a] = rem % s
            rem //= s
        out.append({a: c[a] for a in names})
    return out


def linear_index(mesh, axes: tuple, coords: dict) -> int:
    """The position's index along the axes ``axes`` taken together, the
    first one slowest (``jax.lax.axis_index`` over a tuple)."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + coords[a]
    return i


def group_size(mesh, axes: tuple) -> int:
    return prod(mesh.shape[a] for a in axes)


def check_spec(mesh, spec, ndim: int) -> None:
    if len(spec) > ndim:
        raise ValueError(f"spec {spec!r} has {len(spec)} entries for a "
                         f"{ndim}-d tensor")
    seen = []
    for e in spec:
        for a in axes_of(e):
            if a not in mesh.axis_names:
                raise ValueError(f"spec {spec!r} names axis {a!r}, the "
                                 f"mesh has {mesh.axis_names}")
            if a in seen:
                raise ValueError(f"spec {spec!r} names axis {a!r} twice")
            seen.append(a)


def block(x: torch.Tensor, mesh, spec, coords: dict) -> torch.Tensor:
    """The slab of ``x`` that the position at ``coords`` holds under
    ``spec`` (a view of ``x``): each dimension split evenly over its axes,
    the block at the position's index along them."""
    for d, e in enumerate(spec):
        axes = axes_of(e)
        if not axes:
            continue
        n = group_size(mesh, axes)
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of size {x.shape[d]} does not "
                             f"split over {n} positions ({spec!r})")
        size = x.shape[d] // n
        x = x.narrow(d, linear_index(mesh, axes, coords) * size, size)
    return x


# Observers of a run (``launch.op_analysis`` registers its counter here
# while it counts): each is called as ``o(event, *args)``, with
# ("split", whole, block) where a mesh splits a tensor (position 0's
# block); ("collective", kind, result) where a collective of ``repro``'s
# kind ("all-reduce", "all-gather", "reduce-scatter", "all-to-all") gives
# position 0 its result; ("owners", results) with every position's
# result of a collective, in mesh order; ("derived", slab, block, kind)
# where a mesh reshards a placed slab into a block (``kind`` the
# collective that reading it costs, or None); ("reshard", on) around a
# real mesh's gather of a placed tensor for that reshard; ("position",
# stack, index) where a thread starts running position ``index``'s body.
OBSERVERS: list = []


def notify(event: str, *args) -> None:
    for o in OBSERVERS:
        o(event, *args)


def is_meta_mesh(mesh) -> bool:
    """A mesh of ``meta`` devices (shapes only)."""
    return mesh.devices.flat[0].type == "meta"


def first_coords(mesh) -> dict:
    """Position 0's coordinates: every index 0."""
    return {a: 0 for a in mesh.axis_names}


def split(x: torch.Tensor, mesh, spec, copy: bool = False) -> tuple:
    """``x`` laid out over ``mesh`` by ``spec``: one slab per position in
    mesh order, on that position's device (a view when ``x`` is already
    there and ``copy`` is False). Differentiable: a slab's gradient flows
    back into ``x``, summed over the positions that hold the same slab.
    On a meta mesh only position 0's block is made (every position's
    entry is that block). A split is told to ``OBSERVERS`` with position
    0's block."""
    spec = PartitionSpec(*spec)
    check_spec(mesh, spec, x.ndim)
    if is_meta_mesh(mesh):
        b = block(x, mesh, spec, first_coords(mesh)).to("meta", copy=copy)
        notify("split", x, b)
        return (b,) * mesh.size
    out = tuple(block(x, mesh, spec, c).to(dev, copy=copy)
                for c, dev in zip(mesh_coords(mesh), mesh.devices.flat))
    if OBSERVERS:
        notify("split", x, out[0])
    return out


def shard_shape(sharding: NamedSharding, shape: tuple) -> tuple:
    """The shape of one slab of a tensor of ``shape`` under ``sharding``
    (``NamedSharding.shard_shape``); a dimension must split evenly."""
    mesh, spec = sharding.mesh, PartitionSpec(*sharding.spec)
    check_spec(mesh, spec, len(shape))
    out = list(shape)
    for d, e in enumerate(spec):
        n = group_size(mesh, axes_of(e))
        if out[d] % n:
            raise ValueError(f"dimension {d} of size {out[d]} does not "
                             f"split over {n} positions ({spec!r})")
        out[d] //= n
    return tuple(out)


@dataclass
class Sharded:
    """A tensor placed on a mesh (``device_put``'s result): its sharding,
    its global shape and its slabs in mesh order."""
    sharding: NamedSharding
    shape: tuple
    slabs: tuple

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    def gather(self) -> torch.Tensor:
        """The whole tensor on the mesh's first device, assembled from the
        slabs (each block taken from the first position that holds it)."""
        mesh, spec = self.sharding.mesh, self.sharding.spec
        first = mesh.devices.flat[0]
        out = self.slabs[0].new_empty(self.shape, device=first)
        done = set()
        for c, slab in zip(mesh_coords(mesh), self.slabs):
            key = tuple(linear_index(mesh, axes_of(e), c) for e in spec)
            if key in done:
                continue
            done.add(key)
            block(out, mesh, spec, c).copy_(slab)
        return out


def _put(x, sharding: NamedSharding | None, copy: bool):
    if sharding is None:
        return x
    if isinstance(x, Sharded):
        if x.sharding == sharding:
            return x
        x = x.gather()
    if isinstance(x, np.ndarray) or not isinstance(x, torch.Tensor):
        # from the host: each block sliced there and copied to its device
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
        copy = True
    if x.device.type == "meta":               # shapes only
        return empty_placed(sharding, tuple(x.shape), x.dtype, x.device)
    return Sharded(sharding, tuple(x.shape),
                   split(x, sharding.mesh, sharding.spec, copy=copy))


def device_put(x, sharding, copy: bool = False):
    """``x`` placed by ``sharding``: a ``Sharded`` of its slabs (``split``),
    or ``x`` itself when ``sharding`` is None. ``x`` may be a tree (dicts,
    lists and tuples) with a tree of shardings of the same structure
    beside it, or one sharding for every leaf. A numpy leaf is split on
    the host and each block copied to its position's device; a
    ``Sharded`` leaf with another sharding is gathered and split again.
    ``copy=True`` gives every position storage of its own (placed state
    that is updated in place must have it: a replicated slab on a mesh
    that repeats a device would otherwise be one tensor)."""
    if isinstance(x, dict):
        return {k: device_put(v, sharding[k] if isinstance(sharding, dict)
                              else sharding, copy) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not isinstance(x, torch.Tensor):
        shs = (sharding if isinstance(sharding, (list, tuple))
               and not isinstance(sharding, NamedSharding)
               else [sharding] * len(x))
        return type(x)(device_put(v, s, copy) for v, s in zip(x, shs))
    return _put(x, sharding, copy)


def empty_placed(sharding: NamedSharding, shape: tuple, dtype,
                 device=None) -> Sharded:
    """A ``Sharded`` of uninitialised slabs of ``shape``'s shard shape,
    each on its position's device (or all on ``device``, e.g. ``meta``:
    shapes only, nothing allocated, one storage-free slab standing for
    every position)."""
    ss = shard_shape(sharding, tuple(shape))
    devs = sharding.mesh.devices.flat
    if torch.device(device or devs[0]).type == "meta":
        return Sharded(sharding, tuple(shape), (torch.empty(
            ss, dtype=dtype, device="meta"),) * len(devs))
    return Sharded(sharding, tuple(shape), tuple(
        torch.empty(ss, dtype=dtype, device=device or d) for d in devs))


def zeros_placed(sharding: NamedSharding, shape: tuple, dtype,
                 device=None) -> Sharded:
    """``empty_placed`` filled with zeros (on ``meta`` only shapes)."""
    out = empty_placed(sharding, shape, dtype, device)
    for s in out.slabs:
        if s.device.type != "meta":
            s.zero_()
    return out
