"""Device meshes for one controller (the port of ``repro.launch.mesh``).

``repro`` runs a sharded program as ONE jitted XLA program over a
``jax.sharding.Mesh``, with ``shard_map`` for the per-shard body. The port
keeps that single-controller model: one process holds a ``Mesh`` of
``torch.device``s, runs the per-shard body once per mesh position on that
position's device, and gathers the shards' results onto the mesh's first
device (``mesh.devices.flat[0]``), the port's ``all_gather``. A mesh may
list one device several times: ``make_mesh((4,), ("data",),
devices=["cpu"] * 4)`` gives four shards on the CPU (the tests), and
``devices=["cuda:0"] * 4`` four shards on one card, the counterparts of
``repro``'s ``--xla_force_host_platform_device_count=4``.

Defined as functions, never module-level meshes, so importing this module
touches no device.
"""
from __future__ import annotations

from collections import OrderedDict
from math import prod

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device


class Mesh:
    """An ndarray of ``torch.device`` with named axes (the port's
    ``jax.sharding.Mesh``). ``shape`` maps axis name -> size, as JAX's
    does; ``devices`` is the ndarray, ``devices.flat`` in mesh order.
    Meshes with the same devices, shape and axis names compare equal and
    hash alike (they key search-function caches)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> OrderedDict:
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _key(self) -> tuple:
        return (tuple(self.devices.flat), self.devices.shape,
                self.axis_names)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(shape: tuple, axes: tuple, devices=None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``. ``devices`` (any
    sequence of ``prod(shape)`` devices or device strings, repeats
    allowed) fills it in mesh order; by default the first ``prod(shape)``
    CUDA devices, and fewer cards than that raise. The CPU is never
    picked unless ``devices`` names it. ``["meta"] * n`` gives a
    shapes-only mesh (``sharding.is_meta_mesh``: ``shard_map`` runs a body
    once, as position 0, and nothing is allocated); a mesh mixing meta
    with other devices raises."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    n = prod(shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a mesh of {n} devices needs {n} CUDA devices, found "
                f"{have}; pass devices= (e.g. ['cuda:0'] * {n}, or "
                f"['cpu'] * {n} for the plain versions)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a mesh of {n}")
    flat = np.empty((n,), dtype=object)
    for i, d in enumerate(devices):
        d = resolve_device(d)
        if d.type == "cuda" and d.index is None:   # as tensors report it
            d = torch.device("cuda", torch.cuda.current_device())
        flat[i] = d
    metas = sum(d.type == "meta" for d in flat)
    if 0 < metas < n:
        raise ValueError("a mesh is all meta (shapes only) or holds no meta "
                         "device")
    return Mesh(flat.reshape(shape), axes)


def make_production_mesh(devices, *, multi_pod: bool = False) -> Mesh:
    """``repro``'s production layout over ``devices``: one pod is 16 x 16
    = 256 devices (data, model); two pods 2 x 16 x 16 = 512 (pod, data,
    model), the pod axis an extra data-parallel dimension. One card
    cannot hold 256 devices, so the caller names them (``["meta"] *
    256`` for the dry run)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def home_device(mesh, device=None) -> torch.device:
    """Where an entry point given ``mesh`` and ``device`` keeps its
    host-facing tensors and results: the mesh's first device (the gather
    device; a ``device`` given beside the mesh must be that one), or
    without a mesh ``device``, "cuda" by default."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    first = mesh.devices.flat[0]
    dev = None if device is None else resolve_device(device)
    if dev is not None and (dev.type, dev.index or 0) != (first.type,
                                                           first.index or 0):
        raise ValueError(f"device {device} is not the mesh's first device "
                         f"{first}, where its results land")
    return first


def n_devices(mesh) -> int:
    n = 1
    for a in mesh.axis_names:
        n *= mesh.shape[a]
    return n
