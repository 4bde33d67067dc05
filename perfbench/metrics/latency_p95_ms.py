"""latency_p95_ms: the 95th percentile (nearest rank) of every request due
in the window, from its scheduled arrival to its results on the host. A
shed, rejected or failed request counts as missing and sorts last; a
percentile that lands on one reads 1e12 ms."""
import math

from perfbench.traffic import nearest_rank


def read(run):
    if not run.latencies:
        return None
    v = nearest_rank(run.latencies, 0.95)
    return 1e3 * v if math.isfinite(v) else 1e12
