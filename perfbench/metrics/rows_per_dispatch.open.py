"""rows_per_dispatch.open: real query rows a frontend dispatch carried,
over the window (``ServingFrontend.stats``: rows_real / dispatches)."""


def read(run):
    d = run.stats.get("dispatches", 0)
    return run.stats["rows_real"] / d if d else None
