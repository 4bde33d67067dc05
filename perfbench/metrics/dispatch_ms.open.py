"""dispatch_ms.open: mean host time of a frontend ``pump()`` that
dispatched (the benchmark's ``dispatch`` span), in ms."""


def read(run):
    d = run.spans.get("dispatch")
    return 1e3 * sum(d) / len(d) if d else None
