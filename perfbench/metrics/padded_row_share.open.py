"""padded_row_share.open: share of the dispatched rows that were bucket
padding, over the window (``ServingFrontend.stats``: rows_padded over
rows_real + rows_padded), in %."""


def read(run):
    real = run.stats.get("rows_real", 0)
    pad = run.stats.get("rows_padded", 0)
    return 100.0 * pad / (real + pad) if real + pad else None
