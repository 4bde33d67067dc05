"""Per-shard bodies on a single-controller mesh (the port of
``jax.experimental.shard_map`` and of ``jax.lax``'s ``psum``,
``all_to_all``, ``all_gather``, ``axis_index`` and ``axis_size``).

``shard_map(body, mesh, in_specs, out_specs)(*args)`` splits each argument
into per-position blocks by its spec (``sharding.split``: the block on
that position's device), runs ``body`` once per mesh position, and
assembles the outputs by ``out_specs`` on the mesh's first device: an
axis named in an output's spec concatenates the positions' blocks in mesh
order, an axis it leaves out takes the block of the position at index 0
along it (``P()`` takes position 0's value).

The positions run in lockstep, one thread each, so a body is written as
``repro`` writes it: collectives are called by axis name (one axis or a
tuple of axes) inside the body. The threads take turns in mesh order, one
running at a time from one collective to the next (on one card the work
is enqueued on one stream either way; turns keep four threads from
contending for the interpreter at every operation). Each collective is a
rendezvous at which
ONE joint ``torch.autograd.Function`` takes every position's operand and
returns every position's result, so the whole call is one autograd graph
and the caller runs ``backward`` once, on its own thread (a backward per
position would deadlock: autograd runs every caller's backward on one
worker thread per device, and the positions may share one device). The
caller's grad mode, autocast state and current CUDA stream are copied
into each position. An exception on any position fails the whole call;
no position is left waiting.

Gradients are those of ``jax.grad`` through ``repro``'s ``check_rep=False``
bodies: ``psum``'s transpose is ``psum``, ``all_to_all``'s is the inverse
``all_to_all``, ``all_gather``'s is a reduce-scatter, a replicated input's
gradient sums over the positions, and an output's cotangent reaches each
position divided by the number of positions along the axes its spec
leaves out (so ``psum``'d sums divided by a ``psum``'d count under ``P()``
give the true gradient, and ``P()`` over an unreduced value gives
``repro``'s 1/n share).

Sums run in mesh order on the group's first device, the same order on
every device, so a mesh of ``["cuda:0"] * 4`` gives the bits of
``["cpu"] * 4`` wherever the body's own arithmetic does.

An argument that is already placed (a ``sharding.Sharded``) whose spec is
its in_spec enters as its own slabs, with no copy and no gather (so a
body may update it in place, and a slab that requires grad gets its
``.grad``); one with another spec is gathered and split again. An
out_spec given as ``Placed(...)`` leaves that output placed: a
``Sharded`` of every position's block, nothing assembled.

``psum_scatter`` is the reduce-scatter (the sum in the same order as
``psum``'s, each position keeping its block; backward an ``all_gather``),
``pmax`` the maximum across positions (no gradient: the distributed
softmax subtracts it), and ``relayout`` the move behind
``ShardingPolicy.constrain``.

``TRAFFIC`` counts, per collective, the bytes its forward moves between
positions (a chunk or operand that stays on its own position is not
counted); a caller zeroes it and reads it around a call.

On a meta mesh (``sharding.is_meta_mesh``: shapes only) a call runs the
body ONCE, on the caller's thread, as position 0 (every coordinate 0,
the position that does the first-copy work): the counterpart of XLA's
one per-device SPMD program, so a 512-position mesh costs what a
4-position one does. Each collective then returns an empty meta tensor
of position 0's result shape, worked out from the group size n:
``psum`` the operand's shape, ``all_gather`` n times it along its axis
(or a new axis of n), ``psum_scatter`` 1/n along its dimension,
``all_to_all`` 1/n along its split axis and n times along its concat
axis; ``axis_index`` is 0 and ``axis_size`` n. The outputs are empty
meta tensors of their global shapes (``Placed``: one slab standing for
every position). A placed argument with another spec than its in_spec
enters as its block under the in_spec, an ``all_gather`` where that
block is larger than the slab, told where the body first reads it
(``repro``'s partitioner reshards what the program reads).

Every collective, on any mesh, tells ``sharding.OBSERVERS`` the kind
and position 0's result in ``repro``'s names and convention of result
buffers (``launch/dryrun.py``): ``psum`` is "all-reduce",
``all_gather`` "all-gather", ``psum_scatter`` "reduce-scatter",
``all_to_all`` "all-to-all"; the backward of each is told too (a
``psum``'s is an all-reduce, an ``all_gather``'s a reduce-scatter, a
``psum_scatter``'s an all-gather, an ``all_to_all``'s an all-to-all).
``pmax`` and ``relayout`` are built from these and are told as them;
the sum of a replicated input's gradient over the positions is told as
an all-reduce of position 0's block when that gradient arrives.

``checkpoint`` is ``torch.utils.checkpoint`` for bodies: a checkpointed
region that calls a collective replays that collective's forward result
when the backward recomputes the region (the recomputation runs on
autograd's thread, where no other position waits).
"""
from __future__ import annotations

import threading
from contextlib import ExitStack, contextmanager
from math import prod

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from repro_torch.distributed.sharding import (OBSERVERS, NamedSharding, P,
                                              PartitionSpec, Sharded,
                                              axes_of, block, check_spec,
                                              first_coords, group_size,
                                              is_meta_mesh, linear_index,
                                              mesh_coords, notify,
                                              shard_shape, split)

__all__ = ["P", "Placed", "shard_map", "psum", "psum_scatter", "pmax",
           "all_to_all", "all_gather", "axis_index", "axis_size",
           "relayout", "in_shard_map", "checkpoint"]

_local = threading.local()

TRAFFIC = {"psum": 0, "psum_scatter": 0, "all_to_all": 0, "all_gather": 0}


class Placed(PartitionSpec):
    """An out_spec that leaves its output placed (a ``Sharded``)."""


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# positions and the rendezvous
# ---------------------------------------------------------------------------

class _Position:
    def __init__(self, runner, index: int, coords: dict, device):
        self.runner, self.index = runner, index
        self.coords, self.device = coords, device
        self.calls = 0            # collectives called so far
        self.recording = 0        # inside a checkpointed region
        self.log = {}             # call index -> (result, requires grad)


class _Replay:
    """A checkpointed region being recomputed: its collectives return the
    results logged in the forward, in call order."""

    def __init__(self, pos: _Position, start: int):
        self.pos, self.next = pos, start

    def take(self):
        out = self.pos.log[self.next]
        self.next += 1
        return _tree_map(lambda t: t[0].detach().requires_grad_(t[1]), out)


class _Aborted(threading.BrokenBarrierError):
    """Raised on a position whose lockstep another position broke."""


class _Runner:
    """The lockstep: the positions take turns in mesh order, one at a time,
    each running from one collective to the next; the last to arrive
    computes the collective for all, and position 0 goes on. One thread
    runs at a time, so the positions never contend for the interpreter
    and enqueue their work in a fixed order."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.coords = mesh_coords(mesh)
        self.devices = tuple(mesh.devices.flat)
        self.slots = [None] * mesh.size
        self.results = None
        self.go = [threading.Event() for _ in range(mesh.size)]
        self.failed = False
        self.go[0].set()

    def groups(self, axes: tuple) -> list:
        """The positions that reduce together over ``axes``: those equal
        on every other axis, each group in order of ``axis_index(axes)``."""
        by = {}
        for i, c in enumerate(self.coords):
            key = tuple(c[a] for a in self.mesh.axis_names if a not in axes)
            by.setdefault(key, []).append(
                (linear_index(self.mesh, axes, c), i))
        return [[i for _, i in sorted(g)] for g in by.values()]

    def _act(self):
        ops = [s[0] for s in self.slots]
        if any(o != ops[0] for o in ops):
            raise RuntimeError(f"positions called different collectives at "
                               f"one step: {ops}")
        kind, axes, opts = ops[0]
        xs = [s[1] for s in self.slots]
        fn = _COLLECTIVES[kind]
        self.results = fn(self, axes, dict(opts), xs)

    def wait_turn(self, i: int) -> None:
        self.go[i].wait()
        self.go[i].clear()
        if self.failed:
            raise _Aborted()

    def abort(self) -> None:
        self.failed = True
        for e in self.go:
            e.set()

    def call(self, pos: _Position, op: tuple, x):
        i = pos.index
        self.slots[i] = (op, x)
        if i == len(self.slots) - 1:
            self._act()
        self.go[(i + 1) % len(self.slots)].set()
        self.wait_turn(i)
        return self.results[i]


def _position() -> _Position:
    rp = getattr(_local, "replay", None)
    if rp is not None:
        return rp.pos
    pos = getattr(_local, "pos", None)
    if pos is None:
        raise RuntimeError("a collective (psum, all_to_all, all_gather, "
                           "axis_index, axis_size) is called by axis name "
                           "inside a shard_map body; this call is outside "
                           "one")
    return pos


def in_shard_map() -> bool:
    """True inside a ``shard_map`` body (or its recomputation)."""
    return (getattr(_local, "pos", None) is not None
            or getattr(_local, "replay", None) is not None)


def _axes(mesh, axis_name) -> tuple:
    axes = axes_of(axis_name)
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"axis {a!r} is not an axis of the mesh "
                             f"{mesh.axis_names}")
    return axes


def _collective(kind: str, x, axis_name, **opts):
    rp = getattr(_local, "replay", None)
    if rp is not None:
        return rp.take()
    pos = _position()
    axes = _axes(pos.runner.mesh, axis_name)
    out = pos.runner.call(pos, (kind, axes, tuple(sorted(opts.items()))), x)
    if pos.recording:
        pos.log[pos.calls] = _tree_map(lambda t: (t.detach(),
                                                  t.requires_grad), out)
    pos.calls += 1
    return out


def _tree_map(fn, x):
    """``fn`` over the tensors of a list (or a tensor); other leaves as
    they are."""
    if isinstance(x, list):
        return [_tree_map(fn, v) for v in x]
    return fn(x) if isinstance(x, (torch.Tensor, tuple)) else x


# ---------------------------------------------------------------------------
# the joint operations (one autograd node over every position)
# ---------------------------------------------------------------------------

def _sum_to(parts: list, dev) -> torch.Tensor:
    """The parts summed in order on ``dev``."""
    total = parts[0].to(dev)
    for p in parts[1:]:
        total = total + p.to(dev)
    return total


def _group_sums(xs: list, groups: list, devices: tuple) -> list:
    out = [None] * len(xs)
    for g in groups:
        total = _sum_to([xs[i] for i in g], devices[g[0]])
        for j, i in enumerate(g):
            out[i] = (total.to(devices[i], copy=j > 0) if len(g) > 1
                      else total.clone())
    return out


def _told(kind: str, outs: list) -> tuple:
    """``outs`` (every position's result, mesh order) as a tuple, after
    telling the observers position 0's result and whose each result is."""
    if OBSERVERS:
        notify("collective", kind, outs[0])
        notify("owners", outs)
    return tuple(outs)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, devices, *xs):
        ctx.groups, ctx.devices = groups, devices
        return _told("all-reduce", _group_sums(list(xs), groups, devices))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + _told("all-reduce", _group_sums(
            list(gs), ctx.groups, ctx.devices))


def _a2a(xs: list, groups: list, devices: tuple, split_axis: int,
         concat_axis: int) -> list:
    out = [None] * len(xs)
    for g in groups:
        n = len(g)
        chunks = []
        for i in g:
            if xs[i].shape[split_axis] % n:
                raise ValueError(f"all_to_all: dimension {split_axis} of "
                                 f"size {xs[i].shape[split_axis]} does not "
                                 f"split into {n}")
            chunks.append(torch.chunk(xs[i], n, dim=split_axis))
        for j, i in enumerate(g):
            out[i] = torch.cat([chunks[r][j].to(devices[i]) for r in range(n)],
                               dim=concat_axis)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, devices, split_axis, concat_axis, *xs):
        ctx.args = (groups, devices, split_axis, concat_axis)
        return _told("all-to-all", _a2a(list(xs), groups, devices,
                                        split_axis, concat_axis))

    @staticmethod
    def backward(ctx, *gs):
        groups, devices, split_axis, concat_axis = ctx.args
        return (None,) * 4 + _told("all-to-all", _a2a(
            list(gs), groups, devices, concat_axis, split_axis))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, devices, axis, tiled, *xs):
        ctx.args = (groups, devices, axis, tiled, [x.shape[axis] if tiled
                                                   else 1 for x in xs])
        out = [None] * len(xs)
        join = torch.cat if tiled else torch.stack
        for g in groups:
            for i in g:
                out[i] = join([xs[r].to(devices[i]) for r in g], dim=axis)
        return _told("all-gather", out)

    @staticmethod
    def backward(ctx, *gs):
        groups, devices, axis, tiled, sizes = ctx.args
        out = [None] * len(gs)
        for g in groups:
            for j, i in enumerate(g):
                off = sum(sizes[r] for r in g[:j])
                parts = [gs[r].narrow(axis, off, sizes[i]) for r in g]
                s = _sum_to(parts, devices[i])
                out[i] = s if tiled else s.squeeze(axis)
        return (None,) * 4 + _told("reduce-scatter", out)


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, devices, dim, *xs):
        ctx.args = (groups, devices, dim)
        out = [None] * len(xs)
        for g in groups:
            n = len(g)
            if xs[g[0]].shape[dim] % n:
                raise ValueError(f"psum_scatter: dimension {dim} of size "
                                 f"{xs[g[0]].shape[dim]} does not split "
                                 f"into {n}")
            total = _sum_to([xs[i] for i in g], devices[g[0]])
            for i, c in zip(g, torch.chunk(total, n, dim)):
                out[i] = c.to(devices[i], copy=True)
        return _told("reduce-scatter", out)

    @staticmethod
    def backward(ctx, *gs):
        groups, devices, dim = ctx.args
        out = [None] * len(gs)
        for g in groups:
            for i in g:
                out[i] = torch.cat([gs[r].to(devices[i]) for r in g],
                                   dim=dim)
        return (None,) * 3 + _told("all-gather", out)


def _run_psum_scatter(runner, axes, opts, xs):
    dim = opts["dim"] % xs[0].ndim
    TRAFFIC["psum_scatter"] += sum(_nbytes(xs[i]) * (len(g) - 1) // len(g)
                                   for g in runner.groups(axes) for i in g)
    return list(_PSumScatter.apply(runner.groups(axes), runner.devices, dim,
                                   *xs))


def _run_psum(runner, axes, opts, xs):
    if isinstance(xs[0], list):             # a tree's leaves, one at a time
        per_leaf = [_run_psum(runner, axes, opts, [x[j] for x in xs])
                    for j in range(len(xs[0]))]
        return [[leaf[i] for leaf in per_leaf] for i in range(len(xs))]
    if not all(isinstance(x, torch.Tensor) for x in xs):
        n = prod(runner.mesh.shape[a] for a in axes)
        return [x * n for x in xs]
    # each member's operand reaches the n - 1 others
    TRAFFIC["psum"] += sum(_nbytes(xs[i]) * (len(g) - 1)
                           for g in runner.groups(axes) for i in g)
    return list(_PSum.apply(runner.groups(axes), runner.devices, *xs))


def _run_a2a(runner, axes, opts, xs):
    if not opts["tiled"]:
        raise NotImplementedError("all_to_all is ported with repro's "
                                  "tiled=True semantics only")
    sa, ca = opts["split_axis"], opts["concat_axis"]
    sa, ca = sa % xs[0].ndim, ca % xs[0].ndim
    # of each operand's n chunks, n - 1 leave their position
    TRAFFIC["all_to_all"] += sum(_nbytes(xs[i]) * (len(g) - 1) // len(g)
                                 for g in runner.groups(axes) for i in g)
    return list(_AllToAll.apply(runner.groups(axes), runner.devices, sa, ca,
                                *xs))


def _run_gather(runner, axes, opts, xs):
    TRAFFIC["all_gather"] += sum(_nbytes(xs[i]) * (len(g) - 1)
                                 for g in runner.groups(axes) for i in g)
    axis = opts["axis"] % (xs[0].ndim + (0 if opts["tiled"] else 1))
    return list(_AllGather.apply(runner.groups(axes), runner.devices, axis,
                                 opts["tiled"], *xs))


# ---------------------------------------------------------------------------
# a meta mesh: position 0 alone, results of the right shapes
# ---------------------------------------------------------------------------

class _MetaCollective(torch.autograd.Function):
    """One collective at position 0 of a meta mesh: an empty result of
    ``shape``, told as ``kind``; its backward an empty operand-shaped
    gradient, told as ``back``."""

    @staticmethod
    def forward(ctx, kind, back, shape, x):
        ctx.back, ctx.shape = back, tuple(x.shape)
        return _told(kind, [x.new_empty(shape)])[0]

    @staticmethod
    def backward(ctx, g):
        return None, None, None, _told(ctx.back,
                                       [g.new_empty(ctx.shape)])[0]


def _meta_result(kind: str, n: int, opts: dict, x) -> torch.Tensor:
    shape = list(x.shape)
    if kind == "psum":
        return _MetaCollective.apply("all-reduce", "all-reduce", shape, x)
    if kind == "all_gather":
        axis = opts["axis"] % (x.ndim + (0 if opts["tiled"] else 1))
        if opts["tiled"]:
            shape[axis] *= n
        else:
            shape.insert(axis, n)
        return _MetaCollective.apply("all-gather", "reduce-scatter", shape,
                                     x)
    if kind == "psum_scatter":
        dim = opts["dim"] % x.ndim
        if shape[dim] % n:
            raise ValueError(f"psum_scatter: dimension {dim} of size "
                             f"{shape[dim]} does not split into {n}")
        shape[dim] //= n
        return _MetaCollective.apply("reduce-scatter", "all-gather", shape,
                                     x)
    if kind == "all_to_all":
        if not opts["tiled"]:
            raise NotImplementedError("all_to_all is ported with repro's "
                                      "tiled=True semantics only")
        sa, ca = opts["split_axis"] % x.ndim, opts["concat_axis"] % x.ndim
        if shape[sa] % n:
            raise ValueError(f"all_to_all: dimension {sa} of size "
                             f"{shape[sa]} does not split into {n}")
        shape[sa] //= n
        shape[ca] *= n
        return _MetaCollective.apply("all-to-all", "all-to-all", shape, x)
    raise ValueError(kind)


class _MetaRunner:
    """Position 0 of a meta mesh, alone: a collective is its result's
    shape (module docstring), ``done`` nothing."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.coords = [first_coords(mesh)]
        self.devices = (mesh.devices.flat[0],)

    def call(self, pos: _Position, op: tuple, x):
        kind, axes, opts = op
        if kind == "done":
            return None
        n = group_size(self.mesh, axes)
        opts = dict(opts)
        if kind == "psum" and isinstance(x, list):
            return [self._one(kind, n, opts, v) for v in x]
        return self._one(kind, n, opts, x)

    @staticmethod
    def _one(kind, n, opts, x):
        if not isinstance(x, torch.Tensor):         # psum of a number
            return x * n
        return _meta_result(kind, n, opts, x)


_COLLECTIVES = {"psum": _run_psum, "psum_scatter": _run_psum_scatter,
                "all_to_all": _run_a2a,
                "all_gather": _run_gather,
                # every body ends here, so a position that returns while
                # another waits at a collective fails the call
                "done": lambda runner, axes, opts, xs: [None] * len(xs)}


# ---------------------------------------------------------------------------
# the collectives, by axis name
# ---------------------------------------------------------------------------

def psum(x, axis_name):
    """Sum over the positions along ``axis_name`` (a name or a tuple of
    names); every position gets the sum. ``psum(1, axes)`` is the number
    of positions along the axes. A tensor, a number, or a dict, list or
    tuple of them (one rendezvous for the whole tree)."""
    if isinstance(x, dict):
        return dict(zip(x, psum(list(x.values()), axis_name)))
    if isinstance(x, tuple):
        return tuple(psum(list(x), axis_name))
    if isinstance(x, list):
        if any(isinstance(v, (dict, list, tuple)) for v in x):
            return [psum(v, axis_name) for v in x]
        return _collective("psum", list(x), axis_name)
    return _collective("psum", x, axis_name)


def psum_scatter(x: torch.Tensor, axis_name, scatter_dimension: int = 0,
                 tiled: bool = True) -> torch.Tensor:
    """``jax.lax.psum_scatter`` with ``tiled=True``: the sum over the
    positions along ``axis_name`` (in ``psum``'s order, so its blocks are
    ``psum``'s bits), split into n blocks along ``scatter_dimension``;
    the position at index j keeps block j."""
    if not tiled:
        raise NotImplementedError("psum_scatter is ported with tiled=True")
    return _collective("psum_scatter", x, axis_name, dim=scatter_dimension)


def pmax(x: torch.Tensor, axis_name) -> torch.Tensor:
    """The elementwise maximum over the positions along ``axis_name``,
    detached (built from ``all_gather``): the shift of a softmax or
    logsumexp split across positions, whose gradient cancels."""
    with torch.no_grad():
        return all_gather(x.detach(), axis_name, axis=0).amax(dim=0)


def relayout(x: torch.Tensor, have, want) -> torch.Tensor:
    """This position's block of a tensor laid out by ``have`` (mesh-axis
    spec) -> its block under ``want``. Per dimension: split over more
    axes -> a local slice; over fewer -> ``all_gather`` over the ones
    dropped; one dimension leaving axes A that another takes up ->
    ``all_to_all`` over A; anything else gathers whole, then slices."""
    nd = x.ndim
    H = [axes_of(e) for e in tuple(have) + (None,) * (nd - len(have))]
    W = [axes_of(e) for e in tuple(want) + (None,) * (nd - len(want))]
    for a in range(nd):
        if H[a] and not W[a]:
            for b in range(nd):
                if b != a and not H[b] and W[b] == H[a]:
                    x = all_to_all(x, H[a], split_axis=b, concat_axis=a,
                                   tiled=True)
                    H[a], H[b] = (), W[b]
                    break
    for d in range(nd):
        if H[d] == W[d] or W[d][:len(H[d])] == H[d]:
            continue
        drop = (H[d][len(W[d]):] if H[d][:len(W[d])] == W[d] else H[d])
        x = all_gather(x, drop, axis=d, tiled=True)
        H[d] = H[d][:len(H[d]) - len(drop)]
    for d in range(nd):
        if H[d] == W[d]:
            continue
        extra = W[d][len(H[d]):]
        n = axis_size(extra)
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of size {x.shape[d]} does not "
                             f"split over {n} positions")
        size = x.shape[d] // n
        x = x.narrow(d, axis_index(extra) * size, size)
    return x


def all_to_all(x: torch.Tensor, axis_name, split_axis: int,
               concat_axis: int, tiled: bool = False) -> torch.Tensor:
    """``jax.lax.all_to_all`` with ``tiled=True``: position r splits ``x``
    into n chunks along ``split_axis``, chunk j goes to the position at
    index j along ``axis_name``, and each position concatenates what it
    receives along ``concat_axis`` in order of the sender's index."""
    return _collective("all_to_all", x, axis_name, split_axis=split_axis,
                       concat_axis=concat_axis, tiled=tiled)


def all_gather(x: torch.Tensor, axis_name, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Every position's ``x`` along ``axis_name``, in index order: stacked
    on a new dimension ``axis``, or concatenated along it when
    ``tiled``."""
    return _collective("all_gather", x, axis_name, axis=axis, tiled=tiled)


def axis_index(axis_name) -> int:
    """This position's index along ``axis_name`` (a tuple of axes counts
    with the first one slowest)."""
    pos = _position()
    mesh = pos.runner.mesh
    return linear_index(mesh, _axes(mesh, axis_name), pos.coords)


def axis_size(axis_name) -> int:
    pos = _position()
    mesh = pos.runner.mesh
    return prod(mesh.shape[a] for a in _axes(mesh, axis_name))


def mesh_axes() -> tuple:
    """Every axis of the body's mesh."""
    return tuple(_position().runner.mesh.axis_names)


def replicated_axes(spec) -> tuple:
    """The mesh axes a leaf laid out by ``spec`` is replicated over (those
    its spec does not name), in mesh order."""
    named = {a for e in spec for a in axes_of(e)}
    return tuple(a for a in mesh_axes() if a not in named)


def first_copy(spec) -> bool:
    """True where this position holds the first copy of its block of a
    leaf laid out by ``spec`` (index 0 along every replicated axis)."""
    pos = _position()
    return all(pos.coords[a] == 0 for a in replicated_axes(spec))


# ---------------------------------------------------------------------------
# checkpointing inside a body
# ---------------------------------------------------------------------------

def checkpoint(fn, *args):
    """``torch.utils.checkpoint(fn, *args, use_reentrant=False)``; inside a
    body the region's collectives are logged in the forward and replayed
    when the backward recomputes it."""
    rp = getattr(_local, "replay", None)
    pos = getattr(_local, "pos", None) or (rp.pos if rp is not None
                                           else None)
    if pos is None:
        return _torch_checkpoint(fn, *args, use_reentrant=False)
    start = {}

    @contextmanager
    def forward_ctx():
        # a region nested in one being recomputed starts at the replay's
        # cursor, not at the forward's count
        now = getattr(_local, "replay", None)
        start["at"] = now.next if now is not None else pos.calls
        pos.recording += 1
        try:
            yield
        finally:
            pos.recording -= 1

    @contextmanager
    def recompute_ctx():
        prev = getattr(_local, "replay", None)
        _local.replay = _Replay(pos, start["at"])
        try:
            yield
        finally:
            _local.replay = prev

    return _torch_checkpoint(fn, *args, use_reentrant=False,
                             context_fn=lambda: (forward_ctx(),
                                                 recompute_ctx()))


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------

def _is_leaf_spec(s) -> bool:
    return isinstance(s, PartitionSpec)


def in_specs_of(tree):
    """The mesh-axis specs of a tree of ``NamedSharding``s (or of placed
    tensors), as ``shard_map``'s in_specs want them."""
    if isinstance(tree, dict):
        return {k: in_specs_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_leaf_spec(tree):
        return type(tree)(in_specs_of(v) for v in tree)
    if isinstance(tree, (NamedSharding, Sharded)):
        return PartitionSpec(*tree.spec) if isinstance(
            tree, NamedSharding) else PartitionSpec(*tree.sharding.spec)
    return tree


def _split_arg(x, spec, mesh, n: int | None = None) -> list:
    """One argument (a tensor, or a dict, list or tuple of them, with a
    spec or a matching tree of specs) as per-position values (the first
    ``n`` positions', by default all); anything else goes to every
    position as it is."""
    n = mesh.size if n is None else n
    if isinstance(x, dict):
        specs = spec if isinstance(spec, dict) else {k: spec for k in x}
        parts = {k: _split_arg(v, specs[k], mesh, n) for k, v in x.items()}
        return [{k: parts[k][i] for k in x} for i in range(n)]
    if isinstance(x, (list, tuple)) and not isinstance(x, torch.Tensor):
        specs = (spec if isinstance(spec, (list, tuple))
                 and not _is_leaf_spec(spec) else [spec] * len(x))
        parts = [_split_arg(v, s, mesh, n) for v, s in zip(x, specs)]
        return [type(x)(p[i] for p in parts) for i in range(n)]
    if isinstance(x, Sharded):
        if not _is_leaf_spec(spec):
            raise TypeError(f"in_specs entry {spec!r} for a placed tensor")
        if x.sharding.mesh == mesh and _same_spec(x.sharding.spec, spec):
            return list(x.slabs[:n])
        if is_meta_mesh(mesh):
            return [_meta_reshard(x, spec, mesh)] * n
        # the gather reads every slab; as on a meta mesh, a slab counts
        # as read where its block is (``_tell_reshard``)
        notify("reshard", True)
        try:
            out = _split_arg(x.gather(), spec, mesh, n)
        finally:
            notify("reshard", False)
        _tell_reshard(x.slabs[0], out[0])
        return out
    if not isinstance(x, torch.Tensor):
        return [x] * n
    if not _is_leaf_spec(spec):
        raise TypeError(f"in_specs entry {spec!r} for a tensor: use P(...)")
    out = split(x, mesh, spec)
    if OBSERVERS and x.requires_grad and len(
            {a for e in spec for a in axes_of(e)}) < len(mesh.axis_names):
        _tell_grad_sum(x, out[0])
    return list(out[:n])


def _tell_grad_sum(x: torch.Tensor, blk: torch.Tensor) -> None:
    """Tell the observers, once, when ``x``'s gradient arrives: the sum of
    a replicated input's gradient over the positions, ``repro``'s
    all-reduce of position 0's block."""
    def hook(g):
        handle.remove()
        notify("collective", "all-reduce", blk)
    handle = x.register_hook(hook)


def _tell_reshard(slab: torch.Tensor, blk: torch.Tensor) -> None:
    """Tell the observers that ``blk``, position 0's block under another
    spec, is derived from the placed ``slab``: an all-gather where it is
    larger than the slab, a local slice otherwise. The all-gather counts
    where the block is read (XLA reshards only what the program reads)."""
    notify("derived", slab, blk, "all-gather"
           if blk.numel() > slab.numel() else None)


def _meta_reshard(x: Sharded, spec, mesh) -> torch.Tensor:
    """Position 0's block under ``spec`` of a placed meta tensor laid out
    by another spec (``_tell_reshard``)."""
    shape = shard_shape(NamedSharding(mesh, PartitionSpec(*spec)), x.shape)
    out = torch.empty(shape, dtype=x.slabs[0].dtype, device="meta")
    _tell_reshard(x.slabs[0], out)
    return out


def _same_spec(a, b) -> bool:
    """Specs equal up to trailing whole dimensions."""
    a, b = list(PartitionSpec(*a)), list(PartitionSpec(*b))
    while a and a[-1] is None:
        a.pop()
    while b and b[-1] is None:
        b.pop()
    return a == b


class _Assemble(torch.autograd.Function):
    """Every position's block of one output -> the whole output on
    ``dev``; the cotangent goes back to each position's block divided by
    the number of positions along the axes the spec leaves out."""

    @staticmethod
    def forward(ctx, mesh, spec, dev, *blocks):
        coords = mesh_coords(mesh)
        named = {a for e in spec for a in axes_of(e)}
        rest = [a for a in mesh.axis_names if a not in named]
        ctx.args = (mesh, spec, coords, [b.device for b in blocks],
                    prod(mesh.shape[a] for a in rest))
        shape = list(blocks[0].shape)
        for d, e in enumerate(spec):
            shape[d] *= prod(mesh.shape[a] for a in axes_of(e))
        out = blocks[0].new_empty(shape, device=dev)
        for c, b in zip(coords, blocks):
            if all(c[a] == 0 for a in rest):
                if tuple(b.shape) != tuple(blocks[0].shape):
                    raise ValueError(f"positions returned blocks of shapes "
                                     f"{tuple(b.shape)} and "
                                     f"{tuple(blocks[0].shape)}")
                block(out, mesh, spec, c).copy_(b)
        if OBSERVERS:
            notify("split", out, blocks[0])
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, spec, coords, devs, n_rest = ctx.args
        grads = []
        for c, d in zip(coords, devs):
            b = block(g, mesh, spec, c)
            grads.append((b / n_rest if n_rest > 1 else b.clone()).to(d))
        if OBSERVERS:
            notify("owners", grads)
        return (None, None, None) + tuple(grads)


def _assemble(outs: list, spec, mesh):
    first = outs[0]
    if isinstance(first, dict):
        specs = spec if isinstance(spec, dict) else {k: spec for k in first}
        return {k: _assemble([o[k] for o in outs], specs[k], mesh)
                for k in first}
    if isinstance(first, (list, tuple)) and not _is_leaf_spec(first):
        specs = (spec if isinstance(spec, (list, tuple))
                 and not _is_leaf_spec(spec) else [spec] * len(first))
        return type(first)(_assemble([o[i] for o in outs], specs[i], mesh)
                           for i in range(len(first)))
    if not isinstance(first, torch.Tensor):
        return first
    if not _is_leaf_spec(spec):
        raise TypeError(f"out_specs entry {spec!r} for a tensor: use P(...)")
    check_spec(mesh, spec, first.ndim)
    if isinstance(spec, Placed):
        shape = list(first.shape)
        for d, e in enumerate(spec):
            shape[d] *= group_size(mesh, axes_of(e))
        return Sharded(NamedSharding(mesh, PartitionSpec(*spec)),
                       tuple(shape), tuple(outs) if len(outs) > 1
                       else tuple(outs) * mesh.size)
    if is_meta_mesh(mesh):
        return _MetaAssemble.apply(mesh, spec, first)
    return _Assemble.apply(mesh, spec, mesh.devices.flat[0], *outs)


class _MetaAssemble(torch.autograd.Function):
    """Position 0's block of one output -> an empty meta tensor of the
    global shape (a meta mesh); the gradient an empty block."""

    @staticmethod
    def forward(ctx, mesh, spec, b):
        ctx.shape = tuple(b.shape)
        shape = list(b.shape)
        for d, e in enumerate(spec):
            shape[d] *= group_size(mesh, axes_of(e))
        out = b.new_empty(shape)
        notify("split", out, b)
        return out

    @staticmethod
    def backward(ctx, g):
        return None, None, g.new_empty(ctx.shape)


def _thread_state(mesh):
    """A function that puts the caller's grad mode, autocast state and
    current CUDA streams into a position's thread (all per thread)."""
    grad = torch.is_grad_enabled()
    inference = torch.is_inference_mode_enabled()
    casts = [(dt, torch.get_autocast_dtype(dt)) for dt in ("cuda", "cpu")
             if torch.is_autocast_enabled(dt)]
    streams = {d: torch.cuda.current_stream(d) for d in set(mesh.devices.flat)
               if d.type == "cuda"}

    def enter(stack: ExitStack, device, index: int = 0):
        if OBSERVERS:
            notify("position", stack, index)
        stack.enter_context(torch.inference_mode(inference))
        stack.enter_context(torch.set_grad_enabled(grad))
        for dt, dtype in casts:
            stack.enter_context(torch.autocast(dt, dtype=dtype))
        if device.type == "cuda":
            stack.enter_context(torch.cuda.device(device))
            stack.enter_context(torch.cuda.stream(streams[device]))
    return enter


def shard_map(body, mesh, in_specs, out_specs):
    """``body`` as a function of whole tensors over ``mesh``: each call
    splits its arguments by ``in_specs`` (one spec per argument, or a
    tree of specs matching a dict/list argument; ``P()`` replicates),
    runs ``body`` on every position's blocks in lockstep, and assembles
    the results by ``out_specs`` on ``mesh.devices.flat[0]``. A mesh of
    CUDA devices runs every position on its card; nothing falls back to
    the CPU or to an unsharded function."""
    single = _is_leaf_spec(in_specs)
    in_specs = (in_specs,) if single else tuple(in_specs)

    def call(*args):
        if in_shard_map():
            raise RuntimeError("shard_map inside a shard_map body")
        if len(args) != len(in_specs):
            raise TypeError(f"{len(args)} arguments for {len(in_specs)} "
                            "in_specs")
        if is_meta_mesh(mesh):
            return _meta_call(body, mesh, in_specs, out_specs, args)
        per_arg = [_split_arg(a, s, mesh) for a, s in zip(args, in_specs)]
        runner = _Runner(mesh)
        n = mesh.size
        outs, errors = [None] * n, [None] * n
        enter = _thread_state(mesh)

        def run(i):
            pos = _Position(runner, i, runner.coords[i], runner.devices[i])
            _local.pos = pos
            try:
                runner.wait_turn(i)
                with ExitStack() as stack:
                    enter(stack, pos.device, i)
                    outs[i] = body(*[a[i] for a in per_arg])
                    runner.call(pos, ("done", (), ()), None)
                    # after the last rendezvous, hand the turn on
                    if i + 1 < n:
                        runner.go[i + 1].set()
            except BaseException as e:          # noqa: BLE001 - rethrown
                errors[i] = e
                runner.abort()
            finally:
                _local.pos = None

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        real = [e for e in errors if e is not None
                and not isinstance(e, threading.BrokenBarrierError)]
        if real:
            raise real[0]
        if any(e is not None for e in errors):
            raise RuntimeError("shard_map: a position left the lockstep "
                               "(a collective it waited at was broken)")
        return _assemble(outs, out_specs, mesh)

    return call


def _meta_call(body, mesh, in_specs, out_specs, args):
    """``shard_map`` on a meta mesh: the body once, on this thread, as
    position 0 (module docstring)."""
    per_arg = [_split_arg(a, s, mesh, 1)[0]
               for a, s in zip(args, in_specs)]
    runner = _MetaRunner(mesh)
    _local.pos = _Position(runner, 0, runner.coords[0], runner.devices[0])
    try:
        out = body(*per_arg)
    finally:
        _local.pos = None
    return _assemble([out], out_specs, mesh)
