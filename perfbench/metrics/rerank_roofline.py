"""rerank_roofline: the rerank kernel's share of its roofline in the
traced window, in %: the benchmark's bound of every rerank call
(``counts``: each distinct candidate's valid vectors and mask once, the
operations of the valid tokens and vectors) over the profiler's time of
the rerank kernels (tensor and warp routes)."""
from perfbench import counts as K
from perfbench import trace as T

KERNELS = ("rerank_wgmma_kernel", "maxsim_rerank_kernel")


def read(run):
    if run.trace is None or not run.work or not run.work.rerank:
        return None
    t = T.kernel_s(run.trace, KERNELS)
    if t <= 0:
        return None
    bound = sum(K.bound_s(o, b, run.peaks) for o, b in run.work.rerank)
    return 100.0 * bound / t
