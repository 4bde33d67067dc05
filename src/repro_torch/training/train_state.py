"""A train state (a model + optimizer state) as ``repro``'s checkpoint tree.

``repro`` checkpoints ``{"p": params, "o": opt_state}`` from its retriever
train loop (``examples/train_retriever.py``) and ``{"params": params,
"opt": opt_state}`` from its LM launcher (``launch/train.py``);
``training.checkpoint`` already writes the on-disk format. This module
flattens a model (``ColXEncoder`` or ``DecoderLM``) and its
``init_opt_state`` dict into that tree's leaves in ``jax.tree.leaves``
order, and loads them back, so a checkpoint written by either package
resumes in the other. With ``keys=(params, opt)`` naming the two
top-level keys (``RETRIEVER_KEYS`` or ``LM_KEYS``):

    <opt>/per_leaf/<param path>/m, .../v   (adamw; rowwise: .../acc)
    <opt>/step                             int32 scalar
    <params>/<param path>                  e.g. p/blocks/wq [n_layers, d, d]

Keys sort at every level (the optimizer state before the parameters in
both trees), and a model's stacked leaves (``blocks/`` of the encoder,
``segments/`` of the LM), moments included, carry a leading layer axis as
``jax.vmap`` stacks them. Names are the '/'-joined keys of each leaf's
path.
"""
from __future__ import annotations

import torch

from repro_torch.training import checkpoint as CKPT

RETRIEVER_KEYS = ("p", "o")       # examples/train_retriever.py
LM_KEYS = ("params", "opt")       # launch/train.py


def _keys(keys: tuple) -> tuple:
    """(params key, opt key); the opt key sorts first, so its leaves come
    first in ``jax.tree.leaves`` order."""
    params_key, opt_key = keys
    if not opt_key < params_key:
        raise ValueError(f"keys {keys}: the optimizer key must sort before "
                         "the parameters key")
    return params_key, opt_key


def _layout(model) -> list:
    """[(jax param path, [port parameter names])] in leaf order."""
    pname = {id(p): n for n, p in model.named_parameters()}
    return [(path, [pname[id(p)] for p in model.jax_leaf_params(path)])
            for path in model.jax_leaf_names()]


def leaf_names(model, opt_state, keys: tuple = RETRIEVER_KEYS) -> list:
    """The names of ``leaves``' entries, in the same order."""
    params_key, opt_key = _keys(keys)
    names = []
    for path, ports in _layout(model):
        for key in sorted(opt_state["per_leaf"][ports[0]]):
            names.append(f"{opt_key}/per_leaf/{path}/{key}")
    names.append(f"{opt_key}/step")
    return names + [f"{params_key}/{path}" for path, _ in _layout(model)]


def leaves(model, opt_state) -> list:
    """The train state's leaves in ``jax.tree.leaves`` order, the same for
    both trees (``leaf_names`` names them)."""
    per_leaf = opt_state["per_leaf"]
    out = []
    for path, ports in _layout(model):
        stacked = model.jax_stacked(path)
        for key in sorted(per_leaf[ports[0]]):
            if stacked and key == "acc":
                raise ValueError(f"{path}: a row-wise accumulator of a "
                                 "layer stack has no per-layer layout")
            parts = [per_leaf[n][key] for n in ports]
            out.append(torch.stack(parts) if stacked else parts[0])
    out.append(opt_state["step"])
    return out + model.to_jax_leaves()


@torch.no_grad()
def load(model, opt_state, tensors: list,
         keys: tuple = RETRIEVER_KEYS) -> None:
    """Copy ``leaves``-ordered tensors into the model and the optimizer
    state, bit for bit, on the model's device."""
    names = leaf_names(model, opt_state, keys)
    if len(tensors) != len(names):
        raise ValueError(f"{len(tensors)} leaves, the train state has "
                         f"{len(names)}")
    dev = model.device
    per_leaf = opt_state["per_leaf"]
    i = 0
    for path, ports in _layout(model):
        for key in sorted(per_leaf[ports[0]]):
            x = torch.as_tensor(tensors[i]).to(dev)
            parts = list(x) if model.jax_stacked(path) else [x]
            for n, v in zip(ports, parts, strict=True):
                if v.shape != per_leaf[n][key].shape:
                    raise ValueError(f"{names[i]}: shape {tuple(v.shape)}, "
                                     f"the state has "
                                     f"{tuple(per_leaf[n][key].shape)}")
                per_leaf[n][key] = v.to(torch.float32).clone()
            i += 1
    opt_state["step"] = torch.as_tensor(tensors[i]).to(
        dev, torch.int32).reshape(())
    model.load_jax_leaves(tensors[i + 1:])


def save(ckpt_dir: str, step: int, model, opt_state, keep: int = 3,
         keys: tuple = RETRIEVER_KEYS, meta: dict | None = None) -> str:
    """Write the train state as checkpoint ``step`` (``repro``'s format,
    leaf names and ``meta`` recorded). Returns the step's directory."""
    return CKPT.save(ckpt_dir, step, leaves(model, opt_state),
                     meta=meta, keep=keep,
                     leaf_names=leaf_names(model, opt_state, keys))


def restore(ckpt_dir: str, model, opt_state,
            keys: tuple = RETRIEVER_KEYS) -> dict:
    """Load the LATEST checkpoint, written by this package or by
    ``repro``, into ``model`` and ``opt_state`` on the model's device.
    Returns the checkpoint's meta (``meta["step"]``)."""
    tensors, meta = CKPT.restore(ckpt_dir, device=model.device)
    load(model, opt_state, tensors, keys)
    return meta
