"""search_mfu: the whole search's share of the card's dense bf16 peak in
the traced window, in %: the useful operations of every query completed
there (``counts``: valid query tokens x valid page vectors of each stage,
a one-vector stage's tokens collapsed) over the traced window's seconds."""


def read(run):
    if run.trace is None or not run.work:
        return None
    w = run.work
    flops = sum(o for o, _ in w.scan) + sum(o for o, _ in w.rerank) \
        + w.other_flops
    lo, hi = run.trace.window
    if flops <= 0 or hi <= lo:
        return None
    return 100.0 * flops / ((hi - lo) / 1e9) / run.peaks["bf16_dense_flops"]
