"""Generic training-step builder: loss, backward, optimizer (the port of
``repro.training.train_loop``).

``repro`` jits value_and_grad + ``apply_updates`` into one donated step;
here the step runs eagerly (no ``torch.compile``) and updates the model's
parameters and the optimizer state in place.
"""
from __future__ import annotations

import torch

from repro_torch.training import optimizer as OPT


def make_train_step(loss_fn, oc: OPT.OptConfig, labels: dict | None = None):
    """``loss_fn(model, batch)`` -> scalar tensor. Returns
    ``step(model, opt_state, batch) -> metrics``: one backward pass and
    one ``apply_updates`` on the model's named parameters (a parameter
    with no gradient takes zeros, as ``jax.grad`` gives it). Metrics are
    float32 tensors on the model's device: ``loss``, ``grad_norm`` (before
    clipping) and ``lr``, the schedule at the NEW step."""
    schedule = OPT.make_schedule(oc)

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
