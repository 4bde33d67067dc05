"""A model's parameters placed on a mesh, leaf by leaf.

``repro`` places a params tree by ``in_shardings``: each leaf (a layer
stack ``[reps, ...]`` or one tensor) split by its spec. The port's models
hold one ``nn.Parameter`` per layer, and name ``repro``'s leaves
(``jax_leaf_names``: ``embed``, ``segments/0/1/attn/wq``, ``blocks/wq``,
...). A placed model is a dict of ``Sharded`` by those names, each slab
stacked as ``repro``'s shard is, so its shapes are ``repro``'s
``shard_shape``s exactly. ``local_module`` binds one position's slabs to
a structural copy of the model (its parameters the slabs, or views of a
stacked slab per layer), which the model code then runs as usual.

Placing reads one leaf at a time (a model's layers stacked, or a numpy
leaf split on the host), so no device holds a whole leaf its spec splits.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from repro_torch.distributed.sharding import (Sharded, device_put,
                                              empty_placed)


def bind_params(module: nn.Module, params: dict) -> nn.Module:
    """A shallow copy of ``module`` (and of each submodule) whose
    parameters are ``params``, by ``named_parameters()`` name. A body
    takes the model's parameters as an argument, so each position reads
    its own tensors on its own device; ``module`` itself is not touched,
    so the positions, which take turns, never see each other's tensors."""
    def bound(mod, prefix):
        new = copy.copy(mod)
        new.__dict__["_parameters"] = {
            k: None if v is None else params[prefix + k]
            for k, v in mod._parameters.items()}
        new.__dict__["_modules"] = {
            k: None if sub is None else bound(sub, f"{prefix}{k}.")
            for k, sub in mod._modules.items()}
        return new
    return bound(module, "")


def leaf_map(model: nn.Module) -> dict:
    """{leaf name: [(parameter name, rep index or None), ...]}: which of
    the model's parameters each of ``repro``'s leaves holds."""
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}
    for leaf in model.jax_leaf_names():
        ps = model.jax_leaf_params(leaf)
        stacked = model.jax_stacked(leaf)
        out[leaf] = [(names[id(p)], r if stacked else None)
                     for r, p in enumerate(ps)]
    return out


def leaf_shapes(model: nn.Module) -> dict:
    """{leaf name: shape} of ``repro``'s tree (stacks with their leading
    rep axis)."""
    out = {}
    for leaf in model.jax_leaf_names():
        ps = model.jax_leaf_params(leaf)
        shape = tuple(ps[0].shape)
        out[leaf] = ((len(ps),) + shape if model.jax_stacked(leaf)
                     else shape)
    return out


def place_model(model: nn.Module, shardings: dict) -> dict:
    """The model's parameters placed by ``shardings`` (by leaf name): each
    leaf stacked on its own (one at a time), split, and every slab a copy
    of its own."""
    out = {}
    with torch.no_grad():
        for leaf in model.jax_leaf_names():
            ps = model.jax_leaf_params(leaf)
            whole = (torch.stack([p.detach() for p in ps])
                     if model.jax_stacked(leaf) else ps[0].detach())
            out[leaf] = device_put(whole, shardings[leaf], copy=True)
            del whole
    return out


def place_leaves(leaves: dict, shardings: dict) -> dict:
    """Leaves by name (numpy arrays or tensors) placed by ``shardings``; a
    numpy leaf is split on the host, block by block."""
    return {n: device_put(leaves[n] if isinstance(leaves[n], torch.Tensor)
                          else np.asarray(leaves[n]), shardings[n],
                          copy=True)
            for n in shardings}


def empty_model(model: nn.Module, shardings: dict, device=None) -> dict:
    """Uninitialised float32 slabs of every leaf (on ``meta``: shapes
    only)."""
    shapes = leaf_shapes(model)
    return {n: empty_placed(shardings[n], shapes[n], torch.float32, device)
            for n in shardings}


def local_module(model: nn.Module, leaves: dict, lmap: dict | None = None):
    """``model``'s structure holding one position's slabs: a stacked slab's
    rep r is layer r's parameter (a view, so gradients reach the slab)."""
    lmap = lmap if lmap is not None else leaf_map(model)
    params = {}
    for leaf, t in leaves.items():
        for name, r in lmap[leaf]:
            params[name] = t if r is None else t[r]
    return bind_params(model, params)


def _placed_leaves(tree) -> list:
    """Every ``Sharded`` of a tree of dicts, lists and tuples."""
    if isinstance(tree, Sharded):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _placed_leaves(v)]
    return []


def slab_bytes(tree) -> int:
    """Bytes ONE position holds of a placed tree (its first position's
    slabs)."""
    return sum(s.slabs[0].numel() * s.slabs[0].element_size()
               for s in _placed_leaves(tree))


def whole_bytes(tree) -> int:
    """Bytes of a placed tree's leaves whole."""
    return sum(int(np.prod(s.shape)) * s.slabs[0].element_size()
               for s in _placed_leaves(tree))
