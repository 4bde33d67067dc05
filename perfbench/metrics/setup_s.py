"""setup_s: process start to the first timed query (host clock): imports,
the device, kernel libraries (built on a checkout's first run), the
corpus made and indexed, the cell's shapes warmed."""


def read(run):
    return run.setup_s
