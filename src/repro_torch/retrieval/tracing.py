"""Trace-count hook for the no-retrace contract.

The JAX package counts every trace of a serving jit: a jit retraces per
distinct argument shape, so a new corpus layout, a new query shape or a
new ingest batch shape each costs a compile. Eager PyTorch traces
nothing, so a new query or batch shape costs nothing here. What the port
counts instead are the two costs that steady-state serving must never
pay again once warm:

- a kernel library built or loaded (a cache miss of
  ``repro_torch.kernels.build.library``: an ``nvcc`` build or a
  ``dlopen``). The kernel layer only appends the library's name to
  ``build.LOADED``; this module folds new entries into its count and log
  whenever it is read or written, so the kernels never import it;
- a search function built for a new ``(stages, segment layout)``
  (``repro_torch.retrieval.engine.make_segmented_search_fn``, cached per
  stages and layout by ``Retriever.search_fn``). A new segment allocated
  by an upsert or ingest past the headroom, ``compact()`` and
  ``enable_routing`` change the layout, so the next search counts one;
- a per-segment function of the tiered pipeline
  (``engine.make_segment_scan_fn``/``make_segment_rerank_fn``, cached by
  ``tiering.TieredEngine`` per kind, stages, stage and the segment's
  layout). A segment's tier and position are not part of its layout, so
  promotions and demotions count nothing.

After warm-up, a steady-state upsert/ingest/delete/search/traffic
sequence must leave the counter unchanged; tests, ``chip_smoke.py`` and
``launch/serve.py`` assert ``trace_count()`` deltas of 0.

Every mutation of the counter and its log holds ``_LOCK``, so
``record_trace()`` is safe from any thread and deltas observed around a
quiesced region are exact. ``no_retrace()`` is a per-thread assertion
idiom.
"""
from __future__ import annotations

import sys
import threading
from contextlib import contextmanager

from repro_torch.kernels import build

_LOCK = threading.Lock()
_TRACES = [0]
_TRACE_LOG: list = []        # qualified name per counted build
_TRACE_LOG_MAX = 256         # bound the log; the count stays exact
_LOADS_SEEN = [0]            # entries of build.LOADED already counted


def _count(name: str) -> None:
    _TRACES[0] += 1
    if len(_TRACE_LOG) < _TRACE_LOG_MAX:
        _TRACE_LOG.append(name)


def _fold_loads() -> None:
    """Count the kernel libraries loaded since the last call (under
    ``_LOCK``)."""
    loaded = build.LOADED[_LOADS_SEEN[0]:]
    _LOADS_SEEN[0] += len(loaded)
    for lib in loaded:
        _count(f"{build.__name__}.library:{lib}")


def record_trace(name: str | None = None) -> None:
    """Count one build. Records the caller's qualified name
    (module.function, from the calling frame when ``name`` is not given)
    alongside the count, so ``no_retrace()`` can say WHAT was built."""
    if name is None:
        f = sys._getframe(1)
        name = f"{f.f_globals.get('__name__', '?')}.{f.f_code.co_name}"
    with _LOCK:
        _fold_loads()
        _count(name)


def trace_count() -> int:
    with _LOCK:
        _fold_loads()
        return _TRACES[0]


def traced_names(since: int = 0) -> tuple:
    """Names recorded by ``record_trace()`` calls ``since`` a prior
    ``trace_count()`` snapshot (entries past the log bound are dropped;
    ``no_retrace`` reports them as unattributed)."""
    with _LOCK:
        _fold_loads()
        return tuple(_TRACE_LOG[since:])


def reset_trace_count() -> None:
    with _LOCK:
        _fold_loads()
        _TRACES[0] = 0
        _TRACE_LOG.clear()


@contextmanager
def no_retrace(what: str = "steady state"):
    """Assert that nothing counted above is built inside the block::

        frontend.warm()
        with tracing.no_retrace("ragged traffic"):
            for q, qm in traffic:
                frontend.search(q, qm)

    On failure the assertion names what was built (the ``record_trace()``
    call sites).
    """
    before = trace_count()
    yield
    delta = trace_count() - before
    if delta != 0:
        names = traced_names(since=before)
        unattributed = delta - len(names)
        who = ", ".join(sorted(set(names))) or "<log saturated>"
        if unattributed > 0 and names:
            who += f" (+{unattributed} past the log bound)"
        raise AssertionError(
            f"{what}: {delta} build(s) of kernel libraries or search "
            f"functions — the no-retrace contract is broken (built: {who})")
