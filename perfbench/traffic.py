"""Traffic generators: the open loop's arrival schedule and the sample of
served answers that the reference checks.

The schedule is ``frontend.replay_open_loop``'s Poisson process made
reproducible per seed AND of fixed shape: its ``n = rate * seconds`` gaps
are the midpoint quantiles of the exponential distribution at ``rate``,
a fixed multiset, in an order drawn from the seed. Every seed then sends
the same number of requests over the same span, in another order.
"""
from __future__ import annotations

import math

import numpy as np

from perfbench import corpus as C

S_ARRIVAL, S_SAMPLE = 11, 12


def arrivals(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Arrival times [n] in seconds from the window's start, increasing."""
    n = max(int(round(rate * seconds)), 1)
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u) / rate
    order = C.permutation(seed, S_ARRIVAL, n).numpy()
    return np.cumsum(gaps[order]) - gaps[order[0]]


def sample(seed: int, n_avail: int, k: int) -> np.ndarray:
    """``min(k, n_avail)`` distinct indices of [0, n_avail) drawn from the
    seed."""
    return C.permutation(seed, S_SAMPLE, n_avail).numpy()[:min(k, n_avail)]


def nearest_rank(values, q: float) -> float:
    """The q-quantile (0 < q <= 1) by nearest rank; ``inf`` entries (failed
    requests) sort last."""
    v = sorted(values)
    return float(v[max(math.ceil(q * len(v)) - 1, 0)])
