"""Straggler mitigation for data-parallel training (the port of
``repro.training.elastic``'s host-side half).

Deterministic per-step data assignment (any host can recompute any shard's
batch from ``(run, step, shard)``) and a step-time watchdog that flags slow
steps. ``repro``'s ``remesh`` and ``reshard_tree`` rebuild a device mesh
and re-place the train state on it; they wait for the training
collectives' slice, with ``training.compression``'s all-reduce.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


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
