"""Generic training-step builder: loss, backward, optimizer (the port of
``repro.training.train_loop``).

``repro`` jits value_and_grad + ``apply_updates`` into one donated step;
here the step runs eagerly (no ``torch.compile``) and updates the model's
parameters and the optimizer state in place.

With ``mesh=`` and ``in_specs=`` (the counterpart of ``jax.jit(step,
in_shardings=...)``) the step takes placed arguments (``Sharded`` trees:
parameters by name, ``init_opt_state``'s tree, the batch) and runs them
as they lie: one ``shard_map`` over (params, batch) calls ``loss_fn`` on
every position's slabs, one ``backward`` runs on the caller's thread,
and a second ``shard_map`` over (params, opt state) sums each leaf's
gradient over the mesh axes its spec replicates it on (a ``psum`` per
set of such axes) and applies the update to the slabs in place.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import shard_map as SM
from repro_torch.training import optimizer as OPT


def make_train_step(loss_fn, oc: OPT.OptConfig, labels: dict | None = None,
                    mesh=None, in_specs=None):
    """``loss_fn(model, batch)`` -> scalar tensor. Returns
    ``step(model, opt_state, batch) -> metrics``: one backward pass and
    one ``apply_updates`` on the model's named parameters (a parameter
    with no gradient takes zeros, as ``jax.grad`` gives it). Metrics are
    float32 tensors on the model's device: ``loss``, ``grad_norm`` (before
    clipping) and ``lr``, the schedule at the NEW step.

    With ``mesh``: ``in_specs`` are the shardings (or mesh-axis specs) of
    (params, opt state, batch), ``loss_fn(params, batch)`` gets one
    position's slabs (a dict by name, the batch's blocks) inside the body
    and returns the loss, the same on every position (its sums ``psum``'d
    over the data axes and divided by the global count: through
    ``shard_map``'s ``P()`` rule each position's local sum then enters
    the gradient once). ``step(params, opt_state, batch)`` updates the
    placed parameters and state in place; the metrics land on the mesh's
    first device."""
    schedule = OPT.make_schedule(oc)
    if mesh is not None:
        return _placed_step(loss_fn, oc, labels, mesh, in_specs, schedule)

    def step(model, opt_state, batch) -> dict:
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss = loss_fn(model, batch)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        labs = labels if labels is not None else OPT.default_labels(params)
        gn = OPT.apply_updates(params, grads, opt_state, oc, labels=labs,
                               schedule=schedule)
        return {"loss": loss.detach().float(),
                "grad_norm": gn,
                "lr": schedule(opt_state["step"])}

    return step


def sync_grads(grads: dict, specs: dict) -> dict:
    """Inside a body: each leaf's gradient summed over the mesh axes its
    spec replicates it on, one ``psum`` per set of such axes."""
    groups = {}
    for name in grads:
        groups.setdefault(SM.replicated_axes(specs[name]), []).append(name)
    out = dict(grads)
    for axes, names in groups.items():
        if axes:
            out.update(zip(names, SM.psum([grads[n] for n in names], axes)))
    return out


def _placed_step(loss_fn, oc, labels, mesh, in_specs, schedule):
    pspecs, ospecs, bspecs = (SM.in_specs_of(s) for s in in_specs)

    def update(params, state):
        with torch.no_grad():
            grads = sync_grads({n: p.grad if p.grad is not None
                                else torch.zeros_like(p)
                                for n, p in params.items()}, pspecs)
            labs = labels if labels is not None else \
                OPT.default_labels(params)
            gn = OPT.apply_updates(params, grads, state, oc, labels=labs,
                                   schedule=schedule, specs=pspecs)
            return gn, schedule(state["step"])

    forward = SM.shard_map(loss_fn, mesh, (pspecs, bspecs), SM.P())
    apply = SM.shard_map(update, mesh, (pspecs, ospecs), (SM.P(), SM.P()))

    def step(params, opt_state, batch) -> dict:
        slabs = [s for p in params.values() for s in p.slabs]
        for s in slabs:
            s.requires_grad_(True)
            s.grad = None
        loss = forward(params, batch)
        loss.backward()
        gn, lr = apply(params, opt_state)
        for s in slabs:
            s.grad = None
        return {"loss": loss.detach().float(), "grad_norm": gn, "lr": lr}

    return step


def train_many(step_fn, model, opt_state, batches, log_every: int = 10,
               callback=None) -> list:
    """Simple host loop used by examples: one ``step_fn`` per batch;
    returns the log (step and float metrics every ``log_every`` steps, or
    every step with a ``callback(i, metrics)``)."""
    log = []
    for i, batch in enumerate(batches):
        m = step_fn(model, opt_state, batch)
        if i % log_every == 0 or callback is not None:
            m = {k: float(v) for k, v in m.items()}
            log.append({"step": i, **m})
            if callback is not None:
                callback(i, m)
    return log
