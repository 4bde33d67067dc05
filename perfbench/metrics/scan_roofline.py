"""scan_roofline: the scan kernels' share of their roofline in the traced
window, in %: the benchmark's bound of every stage-0 scan call
(``counts``: operations at the bf16 peak or bytes at the memory peak)
over the profiler's time of the scan kernels (the warp route, the
tensor route and the double-buffered scan, bf16 or int8)."""
from perfbench import counts as K
from perfbench import trace as T

KERNELS = ("maxsim_scan_kernel", "scan_wgmma_kernel",
           "maxsim_scan_db_kernel")


def read(run):
    if run.trace is None or not run.work or not run.work.scan:
        return None
    t = T.kernel_s(run.trace, KERNELS)
    if t <= 0:
        return None
    bound = sum(K.bound_s(o, b, run.peaks) for o, b in run.work.scan)
    return 100.0 * bound / t
