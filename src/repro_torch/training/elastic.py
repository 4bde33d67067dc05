"""Elastic scaling and straggler mitigation (the port of
``repro.training.elastic``).

``remesh`` builds the largest (data, model) mesh that fits the healthy
devices, and ``reshard_tree`` re-places every leaf of a train state on it
by the leaf's logical axes resolved against the new mesh: resharding is a
re-resolution, no model code changes. Also deterministic per-step data
assignment (any host can recompute any shard's batch from ``(run, step,
shard)``) and a step-time watchdog that flags slow steps.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.distributed.sharding import (Sharded, ShardingPolicy,
                                              device_put, is_spec)
from repro_torch.launch.mesh import make_mesh


def remesh(n_devices: int, model_parallel: int, devices=None):
    """The largest (data, model) mesh over ``devices`` (default: the first
    ``n_devices`` CUDA devices; fewer raise): model = min(model_parallel,
    devices), data = devices // model, the rest left out."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"remesh over {n_devices} devices found {have} "
                               "CUDA devices; pass devices=")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    devices = list(devices)
    model = min(model_parallel, len(devices))
    data = len(devices) // model
    return make_mesh((data, model), ("data", "model"),
                     devices[:data * model])


def reshard_tree(tree, logical_specs, new_mesh, overrides=None):
    """Every leaf of ``tree`` (dicts and lists of tensors, or of
    ``Sharded`` leaves from an earlier mesh) placed on ``new_mesh`` by its
    logical axes in ``logical_specs`` (the same structure): a ``Sharded``
    per leaf, each slab its own copy."""
    pol = ShardingPolicy(new_mesh, overrides=overrides)

    def place(x, axes):
        if isinstance(x, Sharded):
            x = x.gather()
        return device_put(x, pol.named(*axes), copy=True)

    def walk(x, spec):
        if is_spec(spec):
            return place(x, spec)
        if isinstance(spec, dict):
            return {k: walk(x[k], spec[k]) for k in spec}
        return type(spec)(walk(a, s) for a, s in zip(x, spec))
    return walk(tree, logical_specs)


def deterministic_batch_seed(run_seed: int, step: int, shard: int) -> int:
    """Any host can recompute any shard's batch: seed = f(run, step, shard).
    A recovered or backup host resumes mid-epoch without coordination."""
    return (run_seed * 1_000_003 + step) * 65_537 + shard


@dataclass
class StragglerWatchdog:
    """Flags steps (hosts) whose duration exceeds median * tolerance."""
    tolerance: float = 2.0
    window: int = 32
    times: list = field(default_factory=list)

    def record(self, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        self.times.append(seconds)
        self.times = self.times[-self.window:]
        if len(self.times) < 8:
            return False
        med = float(np.median(self.times))
        return seconds > self.tolerance * med
