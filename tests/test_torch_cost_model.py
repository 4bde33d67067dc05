"""The cascade cost model: ``qps_cost_model`` (Eq.-1 multiply-adds for one
query) and ``cascade_hbm_bytes`` (the per-stage byte bill of a query
batch) against ``repro``'s, and ``SegmentedStore.vec_dims`` of a live
store against ``repro``'s.

Both functions are integer arithmetic on ``Stage`` fields: every int and
every dict must be EQUAL to ``repro``'s. The first tests are the cases of
the JAX package's own cost-model tests, run on the port; the sweep covers
1-, 2- and 3-stage cascades, ``scan_topk`` with and without ``chunk``,
``rerank_kernel``, int8 ``bytes_per_coord``, Matryoshka ``vec_dims``,
routed stages, ``batch`` and ``cold_rows``.
"""
import itertools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import matryoshka as JMRL
from repro.core import multistage as JM
from repro.retrieval.segments import SegmentedStore as JaxSegmented
from repro.retrieval.store import VectorStore as JaxVectorStore
from repro.retrieval.store import quantize_store as jax_quantize
from repro_torch.core import matryoshka as TMRL
from repro_torch.core import multistage as TM
from repro_torch.retrieval.segments import SegmentedStore
from repro_torch.retrieval.store import from_numpy, quantize_store

torch.set_num_threads(1)

DIMS = {"initial": 1024, "mean_pooling": 34, "global_pooling": 1}


@pytest.fixture(scope="module", autouse=True)
def repro_trace_log_kept():
    """Leave ``repro``'s trace counter and its bounded name log (256
    names a process) as this module found them: its jitted builds here
    are the reference's, not steady-state serving, and a later test in
    the same worker reads names from that log."""
    from repro.retrieval import tracing
    count, names = tracing._TRACES[0], list(tracing._TRACE_LOG)
    yield
    tracing._TRACES[0] = count
    tracing._TRACE_LOG[:] = names
FIELDS = ("use_kernel", "chunk", "dtype", "scan_topk", "rerank_kernel",
          "n_probe", "n_clusters")


def _pair(stages):
    """(repro stages, port stages) from one tuple of (vector, k, policy)."""
    return (tuple(JM.Stage(v, k, **kw) for v, k, kw in stages),
            tuple(TM.Stage(v, k, **kw) for v, k, kw in stages))


# ----------------------------------------------------------------------
# the JAX package's own cases, on the port
# ----------------------------------------------------------------------

def test_multistage_cost_model():
    c1 = TM.qps_cost_model(10_000, 10, 128, TM.one_stage(100), DIMS)
    c2 = TM.qps_cost_model(10_000, 10, 128, TM.two_stage(256, 100), DIMS)
    assert c1 / c2 > 10          # the paper's multiplicative saving
    assert c1 == JM.qps_cost_model(10_000, 10, 128, JM.one_stage(100), DIMS)
    assert c2 == JM.qps_cost_model(10_000, 10, 128,
                                   JM.two_stage(256, 100), DIMS)


def test_cost_model_bills_matryoshka_stage_at_its_own_dim():
    stages = TM.two_stage(100, 10)
    dims = {"initial": 16, "mean_pooling": 16}
    vec_dims = {"initial": 128, "mean_pooling": 64}
    c = TM.qps_cost_model(1000, 10, 128, stages, dims, vec_dims)
    assert c == 10 * 16 * 1000 * 64 + 10 * 16 * 100 * 128
    assert TM.qps_cost_model(1000, 10, 128, stages, dims) > c
    wide = TM.qps_cost_model(1000, 10, 128, stages, dims,
                             {"initial": 256, "mean_pooling": 128})
    assert wide == TM.qps_cost_model(1000, 10, 128, stages, dims)
    assert c == JM.qps_cost_model(1000, 10, 128, JM.two_stage(100, 10),
                                  dims, vec_dims)


def test_routed_cost_model_sublinear():
    dims, dim = {"mean_pooling": 3}, 8
    n, k_c = 100_000, 128
    ex = (TM.Stage("mean_pooling", 10),)
    rt = TM.with_routing_policy(ex, n_probe=8, n_clusters=k_c)
    full = TM.with_routing_policy(ex, n_probe=k_c, n_clusters=k_c)
    assert TM.qps_cost_model(n, 4, dim, rt, dims) < \
        TM.qps_cost_model(n, 4, dim, ex, dims) / 4
    assert TM.qps_cost_model(n, 4, dim, full, dims) >= \
        TM.qps_cost_model(n, 4, dim, ex, dims)
    b_ex = TM.cascade_hbm_bytes(n, 4, dim, ex, dims)
    b_rt = TM.cascade_hbm_bytes(n, 4, dim, rt, dims)
    assert b_rt["stages"][0]["kind"] == "routed-scan"
    assert b_rt["total_bytes"] < b_ex["total_bytes"]
    b_rt2 = TM.cascade_hbm_bytes(2 * n, 4, dim, rt, dims)
    assert b_rt2["stages"][0]["read_bytes"] < \
        2.5 * b_rt["stages"][0]["read_bytes"]
    jrt = JM.with_routing_policy((JM.Stage("mean_pooling", 10),),
                                 n_probe=8, n_clusters=k_c)
    assert b_rt == JM.cascade_hbm_bytes(n, 4, dim, jrt, dims)


def test_stage_fields_match():
    """The cost model reads these ``Stage`` fields; both packages' stages
    carry them with the same defaults."""
    j, t = JM.Stage("initial", 5), TM.Stage("initial", 5)
    for f in FIELDS:
        assert getattr(j, f) == getattr(t, f), f
    assert TM.DEFAULT_SCAN_TOPK_CHUNK == JM.DEFAULT_SCAN_TOPK_CHUNK


# ----------------------------------------------------------------------
# the sweep
# ----------------------------------------------------------------------

def _cascades():
    """Named cascades of (vector, k, policy) covering every branch."""
    return {
        "1": [("initial", 100, {})],
        "1-topk": [("initial", 100, {"scan_topk": True})],
        "1-topk-chunk256": [("initial", 100,
                             {"scan_topk": True, "chunk": 256})],
        "1-topk-chunk-over-n": [("initial", 100,
                                 {"scan_topk": True, "chunk": 1 << 20})],
        "1-pooled-topk": [("global_pooling", 100, {"scan_topk": True})],
        "2": [("mean_pooling", 256, {}), ("initial", 100, {})],
        "2-rk": [("mean_pooling", 256, {"use_kernel": True}),
                 ("initial", 100, {"rerank_kernel": True})],
        "2-topk-rk": [("mean_pooling", 256, {"scan_topk": True,
                                             "chunk": 512}),
                      ("initial", 100, {"rerank_kernel": True})],
        "3": [("global_pooling", 1024, {}), ("mean_pooling", 256, {}),
              ("initial", 100, {})],
        "3-rk": [("global_pooling", 1024, {}),
                 ("mean_pooling", 256, {"rerank_kernel": True}),
                 ("initial", 100, {"rerank_kernel": True})],
        "2-routed8": [("mean_pooling", 256, {"n_probe": 8,
                                             "n_clusters": 64}),
                      ("initial", 100, {})],
        "2-routed8-kernel": [("mean_pooling", 256,
                              {"n_probe": 8, "n_clusters": 64,
                               "use_kernel": True}),
                             ("initial", 100, {"rerank_kernel": True})],
        "2-routed-full": [("mean_pooling", 256, {"n_probe": 64,
                                                 "n_clusters": 64,
                                                 "rerank_kernel": True}),
                          ("initial", 100, {})],
        "2-routed-probe-over-k": [("mean_pooling", 256,
                                   {"n_probe": 99, "n_clusters": 64}),
                                  ("initial", 100, {})],
        "1-probe-no-clusters": [("initial", 100, {"n_probe": 8})],
        "2-mrl": [("initial_mrl32", 256, {}), ("initial", 100, {})],
    }


SWEEP_DIMS = dict(DIMS, initial_mrl32=1024)
STORES = {
    # (n_docs, q_tokens, dim, store_dims, vec_dims, bytes_per_coord)
    "float": (4096, 16, 128, SWEEP_DIMS, None, None),
    "int8": (4096, 16, 128, SWEEP_DIMS, None,
             {"initial": 1, "mean_pooling": 1}),
    "mrl": (4096, 16, 128, SWEEP_DIMS,
            {"initial": 128, "mean_pooling": 64, "global_pooling": 128,
             "initial_mrl32": 32}, None),
    "small": (50, 10, 64, SWEEP_DIMS,
              {"initial_mrl32": 32}, {"initial": 1}),
}


@pytest.mark.parametrize("store,cascade", list(itertools.product(
    STORES, _cascades())))
def test_cost_model_sweep(store, cascade):
    n, qt, dim, sd, vd, bpc = STORES[store]
    js, ts = _pair(_cascades()[cascade])
    assert TM.qps_cost_model(n, qt, dim, ts, sd, vd) == \
        JM.qps_cost_model(n, qt, dim, js, sd, vd)
    for batch, cold in ((1, 0), (32, 0), (32, 1000)):
        got = TM.cascade_hbm_bytes(n, qt, dim, ts, sd, vd, batch=batch,
                                   bytes_per_coord=bpc, cold_rows=cold)
        want = JM.cascade_hbm_bytes(n, qt, dim, js, sd, vd, batch=batch,
                                    bytes_per_coord=bpc, cold_rows=cold)
        assert got == want, (batch, cold)
        assert all(type(e[k]) is int for e in got["stages"]
                   for k in ("read_bytes", "score_write_bytes",
                             "total_bytes"))


# ----------------------------------------------------------------------
# a live corpus
# ----------------------------------------------------------------------

def _vectors(rng, n=24, d=32):
    docs = rng.normal(size=(n, 12, d)).astype(np.float32)
    return {"initial": docs,
            "initial_mask": np.ones((n, 12), bool),
            "mean_pooling": docs[:, :4].copy(),
            "mean_pooling_mask": np.ones((n, 4), bool),
            "global_pooling": docs.mean(1)}


@pytest.mark.parametrize("variant", ["float", "mrl", "int8"])
def test_segmented_store_vec_dims(variant):
    rng = np.random.default_rng(7)
    raw = _vectors(rng)
    jv = {k: jnp.asarray(v) for k, v in raw.items()}
    if variant == "mrl":
        jv = JMRL.add_truncated_stage(jv, "initial", 16)
    jstore = JaxVectorStore(jv, 24)
    if variant == "int8":
        jstore = jax_quantize(jstore, ("initial", "mean_pooling"))
    tstore = from_numpy({k: np.asarray(v) for k, v in jstore.vectors.items()},
                        device="cpu")
    if variant == "mrl":
        # the port's own truncation gives the same widths
        own = TMRL.add_truncated_stage(
            from_numpy(raw, device="cpu").vectors, "initial", 16)
        assert own["initial_mrl16"].shape == tstore.vectors[
            "initial_mrl16"].shape
    if variant == "int8":
        own = quantize_store(from_numpy(raw, device="cpu"),
                             ("initial", "mean_pooling"))
        assert set(own.vectors) == set(tstore.vectors)
    jseg = JaxSegmented.from_store(jstore, capacity=32)
    tseg = SegmentedStore.from_store(tstore, capacity=32, device="cpu")
    assert tseg.vec_dims() == jseg.vec_dims() == tstore.vec_dims()
    assert tseg.dims() == jseg.dims()
    stages = ((TM.Stage("mean_pooling", 8), TM.Stage("initial", 4)),
              (JM.Stage("mean_pooling", 8), JM.Stage("initial", 4)))
    if variant == "mrl":
        stages = ((TM.Stage("initial_mrl16", 8), TM.Stage("initial", 4)),
                  (JM.Stage("initial_mrl16", 8), JM.Stage("initial", 4)))
    bpc = ({"initial": 1, "mean_pooling": 1} if variant == "int8" else None)
    for cold in (0, 10):
        assert TM.cascade_hbm_bytes(
            tseg.total_capacity, 8, 32, stages[0], tseg.dims(),
            tseg.vec_dims(), batch=4, bytes_per_coord=bpc,
            cold_rows=cold) == JM.cascade_hbm_bytes(
            jseg.total_capacity, 8, 32, stages[1], jseg.dims(),
            jseg.vec_dims(), batch=4, bytes_per_coord=bpc, cold_rows=cold)
    assert TM.qps_cost_model(tseg.n_valid, 8, 32, stages[0], tseg.dims(),
                             tseg.vec_dims()) == JM.qps_cost_model(
        jseg.n_valid, 8, 32, stages[1], jseg.dims(), jseg.vec_dims())
