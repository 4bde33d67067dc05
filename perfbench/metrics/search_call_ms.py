"""search_call_ms: mean host time of a ``Retriever.search`` call in the
traced window (the benchmark's ``search`` span), in ms."""


def read(run):
    d = run.spans.get("search")
    return 1e3 * sum(d) / len(d) if d else None
