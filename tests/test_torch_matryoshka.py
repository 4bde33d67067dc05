"""Matryoshka stages and the raw-store search function against ``repro``.

- ``truncate_dims`` (with and without re-normalisation) and
  ``add_truncated_stage`` (the derived vector inherits its source's mask
  through ``store.companion_entries``) are allclose to ``repro``'s at
  rtol=1e-6, atol=1e-6 on f32 inputs; key sets and masks are exact;
- the MRL32 2-stage cascade gives ``repro``'s ids exactly, on every
  policy path (the plain path, and the kernel wrappers' plain versions),
  scores within rtol=1e-5, atol=1e-5;
- ``make_search_fn`` over a raw store of a ragged size (no power of two)
  equals ``repro``'s ``make_search_fn(None, ...)``: ids exactly, scores
  within rtol=1e-5, atol=1e-5. Mirrors ``tests/test_retrieval.py``'s
  ``test_matryoshka_stage`` and the Matryoshka cases of
  ``tests/test_core.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core import matryoshka as JMR
from repro.core import multistage as JM
from repro.retrieval import store as JS
from repro.retrieval.engine import make_search_fn as jax_make_search_fn
from repro_torch.configs import get_config
from repro_torch.core import matryoshka as TMR
from repro_torch.core import multistage as TM
from repro_torch.data.synthetic import evaluate_ranking, make_benchmark
from repro_torch.retrieval import store as TS
from repro_torch.retrieval import tracing
from repro_torch.retrieval.engine import make_search_fn
from repro_torch.retrieval.retriever import Retriever

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
STOL = dict(rtol=1e-5, atol=1e-5)
SHRINK = dict(grid_h=4, grid_w=4, out_dim=64)


@pytest.fixture(scope="module")
def bench_stores():
    """A small ColPali-geometry benchmark (d=64) indexed by both packages
    in f32."""
    jc = dataclasses.replace(jax_config("colpali"), **SHRINK)
    tc = dataclasses.replace(get_config("colpali"), **SHRINK)
    bench = make_benchmark(tc, (13, 11, 9), (4, 4, 4), n_topics_per_ds=4)
    ts = TS.build_store(tc, bench.pages, bench.token_types,
                        store_dtype=torch.float32, device="cpu")
    js = JS.build_store(jc, jnp.asarray(bench.pages),
                        jnp.asarray(bench.token_types),
                        store_dtype=jnp.float32)
    return bench, ts, js


@pytest.mark.parametrize("d_prime", [8, 32])
@pytest.mark.parametrize("renorm", [True, False])
def test_truncate_dims_matches_repro(d_prime, renorm):
    x = np.random.default_rng(0).normal(size=(3, 5, 64)).astype(np.float32)
    x[1, 2] = 0.0                                   # a zero vector: no NaN
    got = TMR.truncate_dims(torch.from_numpy(x), d_prime, renorm)
    want = JMR.truncate_dims(jnp.asarray(x), d_prime, renorm)
    assert tuple(got.shape) == (3, 5, d_prime) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.isfinite(got.numpy()).all()


def test_add_truncated_stage_matches_repro(bench_stores):
    _, ts, js = bench_stores
    tv = TMR.add_truncated_stage(ts.vectors, "mean_pooling", 32)
    jv = JMR.add_truncated_stage(js.vectors, "mean_pooling", 32)
    assert set(tv) == set(jv) == set(ts.vectors) | {
        "mean_pooling_mrl32", "mean_pooling_mrl32_mask"}
    np.testing.assert_allclose(tv["mean_pooling_mrl32"].numpy(),
                               np.asarray(jv["mean_pooling_mrl32"]), **TOL)
    np.testing.assert_array_equal(tv["mean_pooling_mrl32_mask"].numpy(),
                                  np.asarray(jv["mean_pooling_mrl32_mask"]))
    # the source store is left as it was; a custom name is honoured
    assert "mean_pooling_mrl32" not in ts.vectors
    named = TMR.add_truncated_stage(ts.vectors, "initial", 16, name="x16")
    assert named["x16"].shape[-1] == 16 and "x16_mask" in named
    assert TS.companion_entries(ts.vectors, "global_pooling", "g") == {}


def _policy(stages, policy):
    if policy == "ref":
        return stages
    return TM.with_rerank_policy(
        TM.with_scan_policy(stages, use_kernel=True), rerank_kernel=True)


@pytest.mark.parametrize("policy", ["ref", "kernel"])
def test_mrl32_cascade_ids_match_repro(bench_stores, policy):
    bench, ts, js = bench_stores
    tv = TMR.add_truncated_stage(ts.vectors, "mean_pooling", 32)
    jv = JMR.add_truncated_stage(js.vectors, "mean_pooling", 32)
    n = ts.n_docs
    t_stages = _policy((TM.Stage("mean_pooling_mrl32", 12),
                        TM.Stage("initial", 5)), policy)
    j_stages = (JM.Stage("mean_pooling_mrl32", 12), JM.Stage("initial", 5))
    r = Retriever(TS.VectorStore(tv, n, "float32"), device="cpu")
    s, i = r.search(bench.queries, bench.query_mask, stages=t_stages)
    js_, ji = jax_make_search_fn(None, j_stages, n)(
        jv, jnp.asarray(bench.queries), jnp.asarray(bench.query_mask))
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js_), **STOL)
    m = evaluate_ranking(i, bench.qrels, ks=(5,))
    assert m["ndcg@5"] > 0.5


@pytest.mark.parametrize("stages_of", [
    lambda M: M.one_stage(6), lambda M: M.two_stage(9, 4),
    lambda M: M.three_stage(20, 9, 4)])
def test_make_search_fn_matches_repro_on_a_ragged_store(bench_stores,
                                                        stages_of):
    bench, ts, js = bench_stores
    n = ts.n_docs
    assert n & (n - 1)                              # not a power of two
    q, qm = bench.queries, bench.query_mask
    s, i = make_search_fn(stages_of(TM), n)(ts.vectors, q, qm)
    js_, ji = jax_make_search_fn(None, stages_of(JM), n)(
        js.vectors, jnp.asarray(q), jnp.asarray(qm))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js_), **STOL)
    # the same function over a store that carries doc_valid (one row
    # dead): that row never comes back, as in repro
    dv = torch.ones((n,), dtype=torch.bool)
    dv[int(i[0, 0])] = False
    vecs = dict(ts.vectors, doc_valid=dv)
    s2, i2 = make_search_fn(stages_of(TM), n)(vecs, q, qm)
    jvecs = dict(js.vectors, doc_valid=jnp.asarray(dv.numpy()))
    js2, ji2 = jax_make_search_fn(None, stages_of(JM), n)(
        jvecs, jnp.asarray(q), jnp.asarray(qm))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ji2))
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), **STOL)
    assert int(i[0, 0]) not in i2[0].tolist()


def test_make_search_fn_counts_one_build(bench_stores):
    bench, ts, _ = bench_stores
    before = tracing.trace_count()
    fn = make_search_fn(TM.two_stage(9, 4), ts.n_docs)
    assert tracing.trace_count() == before + 1
    with tracing.no_retrace("raw-store search"):
        for b in (1, 3, 12):
            fn(ts.vectors, bench.queries[:b], bench.query_mask[:b])
