"""device_idle_share: the share of the traced window in which no operation
ran on the device (the union of the profiler's device intervals), in %."""
from perfbench import trace as T


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.trace.window
    if hi <= lo:
        return None
    return 100.0 * (1.0 - T.busy_s(run.trace) / ((hi - lo) / 1e9))
