"""Optimizers and LR schedules over named tensors (the port of
``repro.training.optimizer``).

- AdamW: float32 moments, decoupled weight decay, global-norm clipping.
- Row-wise Adagrad for embedding tables: one accumulator per row.
- Schedules: cosine, WSD (warmup-stable-decay, MiniCPM), const.

The optimizer is label-routed: a label per parameter ("adamw" | "rowwise",
``default_labels``) picks its update rule. Parameters, gradients, labels
and per-leaf state are dicts keyed by the parameter's name (a model's
``named_parameters``, components joined by '.'). ``apply_updates`` writes
the new parameters into the given tensors under ``torch.no_grad`` and
keeps ``repro``'s order of operations, which ``torch.optim.AdamW`` does
not: the step is counted before the schedule is read, the clip scale is
``min(1, clip / max(gn, 1e-9))``, and weight decay rides inside the
learning-rate product on every adamw leaf, norms and biases included.
Schedules take and return float32 tensors, so a step on the card never
waits for the host.

On a mesh (``train_loop.make_train_step(mesh=)``) the parameters and
moments are placed (``sharding.Sharded``) and the update runs inside a
``shard_map`` body on each position's slabs: ``init_opt_state`` of placed
parameters places the moments by ``opt_state_specs``, ``global_norm``
with ``specs`` counts each distinct block once (a position adds a leaf's
squares only where it holds the first copy of its block) and ``psum``s
the sum over every position, and ``apply_updates`` with ``specs`` takes
that norm for its clipping and writes moments and step in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.distributed import sharding as SH


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        t = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return lr


def wsd_schedule(base_lr: float, warmup: int, stable: int, decay: int,
                 floor: float = 0.1):
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395 §4): linear warmup,
    long constant plateau, short exponential-ish decay to floor*base."""
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        t = ((step - warmup - stable) / max(decay, 1)).clamp(0.0, 1.0)
        dec = base_lr * torch.pow(torch.tensor(floor, dtype=torch.float32,
                                               device=step.device), t)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable,
                                       torch.full_like(step, base_lr), dec))
    return lr


# ---------------------------------------------------------------------------
# optimizer state
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "cosine"        # cosine | wsd | const
    warmup: int = 100
    total_steps: int = 10_000


def make_schedule(oc: OptConfig):
    if oc.schedule == "cosine":
        return cosine_schedule(oc.lr, oc.warmup, oc.total_steps)
    if oc.schedule == "wsd":
        stable = int(0.8 * oc.total_steps)
        return wsd_schedule(oc.lr, oc.warmup, stable,
                            oc.total_steps - oc.warmup - stable)
    return lambda step: torch.full_like(_f32(step), oc.lr)


def default_labels(params: dict,
                   rowwise_paths=("emb", "items", "big", "small")) -> dict:
    """Label a parameter 'rowwise' when a component of its name (split at
    '.' or '/') equals one of ``rowwise_paths`` (the embedding tables),
    else 'adamw'."""
    return {name: ("rowwise" if set(name.replace("/", ".").split("."))
                   & set(rowwise_paths) else "adamw") for name in params}


def init_opt_state(params: dict, labels: dict | None = None) -> dict:
    """``{"step": int32 0, "per_leaf": {name: {"m", "v"} | {"acc"}}}``:
    float32 moments for adamw leaves, a float32 accumulator per row for
    rowwise ones, on each parameter's device."""
    labels = labels if labels is not None else default_labels(params)
    first = next(iter(params.values()))
    if isinstance(first, SH.Sharded):
        return _placed_opt_state(params, labels, first.sharding.mesh)
    dev = first.device

    def leaf_state(p, lab):
        if lab == "rowwise":
            return {"acc": torch.zeros(p.shape[:1], dtype=torch.float32,
                                       device=p.device)}
        return {"m": torch.zeros_like(p, dtype=torch.float32),
                "v": torch.zeros_like(p, dtype=torch.float32)}
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "per_leaf": {n: leaf_state(p, labels[n])
                         for n, p in params.items()}}


def _placed_opt_state(params: dict, labels: dict, mesh) -> dict:
    """``init_opt_state`` of placed parameters: each moment a ``Sharded``
    of float32 zeros on the parameter's sharding, a row-wise accumulator
    on its first axis's, the step an int32 zero on every position."""
    def leaf_state(p, lab):
        if lab == "rowwise":
            sh = SH.NamedSharding(mesh, SH.P(*tuple(p.spec)[:1]))
            return {"acc": SH.Sharded(sh, tuple(p.shape[:1]), tuple(
                torch.zeros(s.shape[:1], dtype=torch.float32,
                            device=s.device) for s in p.slabs))}
        return {k: SH.Sharded(p.sharding, tuple(p.shape), tuple(
            torch.zeros_like(s, dtype=torch.float32) for s in p.slabs))
            for k in ("m", "v")}
    first = next(iter(params.values())).slabs
    step = SH.Sharded(SH.NamedSharding(mesh, SH.P()), (), tuple(
        torch.zeros((), dtype=torch.int32, device=s.device) for s in first))
    return {"step": step, "per_leaf": {n: leaf_state(p, labels[n])
                                       for n, p in params.items()}}


def opt_state_specs(param_specs: dict, labels: dict) -> dict:
    """Logical axes of ``init_opt_state``'s tree from each parameter's
    (``param_specs``, a dict by name like ``labels``): adamw moments take
    the parameter's axes, a row-wise accumulator its first axis."""
    def leaf_spec(spec, lab):
        if lab == "rowwise":
            return {"acc": tuple(spec)[:1]}
        return {"m": spec, "v": spec}
    return {"step": (), "per_leaf": {n: leaf_spec(s, labels[n])
                                     for n, s in param_specs.items()}}


def global_norm(tensors, specs=None) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (float32). Inside a
    ``shard_map`` body, ``specs`` (one mesh-axis spec per tensor, the
    layout of its slab) makes it the norm of the placed tree: each
    distinct block counted once, the sum ``psum``'d over every
    position."""
    if specs is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tensors))
    from repro_torch.distributed import shard_map as SM
    total = None
    for x, spec in zip(tensors, specs):
        part = torch.sum(torch.square(x.float()))
        if not SM.first_copy(spec):
            part = torch.zeros_like(part)
        total = part if total is None else total + part
    return torch.sqrt(SM.psum(total, SM.mesh_axes()))


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict, oc: OptConfig,
                  labels: dict | None = None, schedule=None,
                  specs: dict | None = None) -> torch.Tensor:
    """One optimizer step: writes the new values into ``params``' tensors
    and the new moments and step into ``state``. Returns the gradients'
    global norm before clipping (the train step's ``grad_norm``).

    ``specs`` (a mesh-axis spec per name) runs it on this position's
    slabs inside a ``shard_map`` body: the placed ``global_norm``, and
    moments and step written into the given tensors in place."""
    labels = labels if labels is not None else default_labels(params)
    schedule = schedule or make_schedule(oc)
    step = state["step"] + 1
    lr = schedule(step)
    gn = global_norm((grads[n] for n in params),
                     None if specs is None else [specs[n] for n in params])
    scale = (torch.clamp(oc.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
             if oc.clip_norm > 0 else 1.0)
    b1, b2 = oc.betas
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(stepf, b1), stepf)
    bc2 = 1.0 - torch.pow(torch.full_like(stepf, b2), stepf)
    per_leaf = state["per_leaf"]
    for name, p in params.items():
        g = grads[name].float() * scale
        s = per_leaf[name]
        if labels[name] == "rowwise":
            if specs is not None and any(tuple(specs[name])[1:]):
                raise NotImplementedError(
                    f"{name}: a row-wise leaf split past its first axis")
            row = torch.square(g).mean(dim=tuple(range(1, g.ndim)))
            acc = s["acc"] + row
            denom = torch.sqrt(acc) + oc.eps
            new_p = p - lr * g / denom.reshape(
                denom.shape + (1,) * (g.ndim - 1))
            p.copy_(new_p.to(p.dtype))
            _store(per_leaf, name, {"acc": acc}, specs is not None)
            continue
        m = b1 * s["m"] + (1 - b1) * g
        v = b2 * s["v"] + (1 - b2) * g * g
        mhat, vhat = m / bc1, v / bc2
        new_p = p.float() - lr * (mhat / (torch.sqrt(vhat) + oc.eps)
                                  + oc.weight_decay * p)
        p.copy_(new_p.to(p.dtype))
        _store(per_leaf, name, {"m": m, "v": v}, specs is not None)
    if specs is not None:
        state["step"].copy_(step)
    else:
        state["step"] = step
    return gn


def _store(per_leaf: dict, name: str, new: dict, in_place: bool) -> None:
    if in_place:
        for k, v in new.items():
            per_leaf[name][k].copy_(v)
    else:
        per_leaf[name] = new
