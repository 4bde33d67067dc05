"""The slice as a whole: the 1/2/3-stage cascade through the port's
``multistage.search`` oracle and ``Retriever.search`` (kernel flags on and
off) against ``repro``'s ``Retriever`` on the same corpus, carried across
with ``from_numpy``; again after upserts and deletes; then the ranking
metrics.

Ids must be equal — including the -1 filler when k exceeds the live
documents, which only holds if the port's selection breaks ties by the
lower index as ``jax.lax.top_k`` does. Scores: rtol=1e-5, atol=1e-5 (f32
sums in another order; with the kernel flags, repro runs its Pallas scan
in interpret mode and its fused rerank twin).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core import multistage as JM
from repro.data.synthetic import evaluate_ranking, make_benchmark
from repro.retrieval.retriever import Retriever as JaxRetriever
from repro.retrieval.store import build_store as jax_build
from repro_torch.configs import get_config
from repro_torch.core import multistage as TM
from repro_torch.data import synthetic as TS
from repro_torch.retrieval.retriever import Retriever
from repro_torch.retrieval.store import from_numpy

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
SHRINK = dict(grid_h=8, grid_w=8, out_dim=32)
CASCADES = {1: lambda: JM.one_stage(10),
            2: lambda: JM.two_stage(16, 10),
            3: lambda: JM.three_stage(32, 16, 10)}


def _port(stages):
    return tuple(TM.Stage(s.vector, s.k, use_kernel=s.use_kernel,
                          chunk=s.chunk, rerank_kernel=s.rerank_kernel)
                 for s in stages)


def _flags(stages, kernels: bool, chunk: int = 0):
    st = JM.with_scan_policy(stages, use_kernel=kernels, chunk=chunk)
    return JM.with_rerank_policy(st, rerank_kernel=kernels)


@pytest.fixture(scope="module")
def corpus():
    jc = dataclasses.replace(jax_config("colpali"), **SHRINK)
    bench = make_benchmark(jc, (18, 16, 14), (5, 5, 4), n_topics_per_ds=6,
                           seed=11)
    js = jax_build(jc, jnp.asarray(bench.pages),
                   jnp.asarray(bench.token_types))
    ts = from_numpy({k: np.asarray(v) for k, v in js.vectors.items()},
                    device="cpu")
    extra = [jax_build(jc, jnp.asarray(bench.pages[i:i + n] + 0.05),
                       jnp.asarray(bench.token_types))
             for i, n in ((0, 6), (10, 20))]
    return dict(cfg=jc, bench=bench, jax=js, port=ts, extra=extra)


def _same(jres, tres):
    (js, ji), (ts, ti) = jres, tres
    np.testing.assert_array_equal(np.asarray(ji), np.asarray(ti))
    np.testing.assert_allclose(np.asarray(js), np.asarray(ts), **TOL)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_multistage_search_oracle(corpus, n):
    q, qm = corpus["bench"].queries, corpus["bench"].query_mask
    stages = CASCADES[n]()
    jres = JM.search(corpus["jax"].vectors, jnp.asarray(q), stages,
                     jnp.asarray(qm))
    tres = TM.search(corpus["port"].vectors, torch.from_numpy(q),
                     _port(stages), torch.from_numpy(qm))
    _same(jres, tres)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_retriever_search_matches_repro(corpus, n, kernels):
    q, qm = corpus["bench"].queries, corpus["bench"].query_mask
    stages = _flags(CASCADES[n](), kernels)
    jr = JaxRetriever(corpus["jax"], capacity=64)
    tr = Retriever(corpus["port"], capacity=64, device="cpu")
    _same(jr.search(jnp.asarray(q), jnp.asarray(qm), stages=stages),
          tr.search(q, qm, stages=_port(stages)))
    # raw slot ids too (the same capacity-padded slot space)
    _same(jr.search(jnp.asarray(q), jnp.asarray(qm), stages=stages,
                    translate_ids=False),
          tr.search(q, qm, stages=_port(stages), translate_ids=False))


@pytest.mark.parametrize("kernels", [False, True])
def test_filler_ids_when_k_exceeds_live_docs(corpus, kernels):
    """k=60 > 48 live documents: NEG-scored dead slots fill the tail. The
    raw slot ids of the filler depend on tie order (all score NEG) and
    must match repro's; translated ids are -1."""
    q, qm = corpus["bench"].queries, corpus["bench"].query_mask
    for stages in (JM.one_stage(60), JM.two_stage(60, 55)):
        stages = _flags(stages, kernels, chunk=7)
        jr = JaxRetriever(corpus["jax"], capacity=64)
        tr = Retriever(corpus["port"], capacity=64, device="cpu")
        jres = jr.search(jnp.asarray(q), jnp.asarray(qm), stages=stages,
                         translate_ids=False)
        tres = tr.search(q, qm, stages=_port(stages), translate_ids=False)
        _same(jres, tres)
        _, ids = tr.search(q, qm, stages=_port(stages))
        _, jids = jr.search(jnp.asarray(q), jnp.asarray(qm), stages=stages)
        np.testing.assert_array_equal(ids, np.asarray(jids))
        assert (ids[:, 48:] == -1).all() and (ids[:, :48] >= 0).all()


@pytest.mark.parametrize("kernels", [False, True])
def test_search_after_upsert_and_delete(corpus, kernels):
    """Upserts (the second overflows into a new segment) and deletes leave
    the port's results equal to repro's."""
    q, qm = corpus["bench"].queries, corpus["bench"].query_mask
    jr = JaxRetriever(corpus["jax"], capacity=64)
    tr = Retriever(corpus["port"], capacity=64, device="cpu")
    for batch in corpus["extra"]:
        tb = from_numpy({k: np.asarray(v) for k, v in batch.vectors.items()},
                        device="cpu")
        np.testing.assert_array_equal(jr.upsert(batch), tr.upsert(tb))
    assert jr.store.capacities == tr.store.capacities == (64, 64)
    dead = [0, 5, 47, 50, 70]
    assert jr.delete(dead) == tr.delete(dead) == 5
    assert jr.n_docs == tr.n_docs == 69
    for n in (1, 2, 3):
        stages = _flags(CASCADES[n](), kernels)
        _same(jr.search(jnp.asarray(q), jnp.asarray(qm), stages=stages),
              tr.search(q, qm, stages=_port(stages)))
    stages = _flags(JM.two_stage(100, 90), kernels)      # k > live docs
    jres = jr.search(jnp.asarray(q), jnp.asarray(qm), stages=stages)
    tres = tr.search(q, qm, stages=_port(stages))
    _same(jres, tres)
    assert (tres[1][:, 69:] == -1).all()
    assert not np.isin(tres[1], dead).any()


@pytest.mark.parametrize("n", [1, 2, 3])
def test_evaluate_ranking_on_port_results(corpus, n):
    """The same NDCG/Recall@5/10 as repro for the same cascade, computed
    by either package's metric code."""
    bench = corpus["bench"]
    stages = _flags(CASCADES[n](), True)
    _, ids = Retriever(corpus["port"], device="cpu").search(
        bench.queries, bench.query_mask, stages=_port(stages))
    _, jids = JaxRetriever(corpus["jax"]).search(
        jnp.asarray(bench.queries), jnp.asarray(bench.query_mask),
        stages=stages)
    m = TS.evaluate_ranking(ids, bench.qrels, ks=(5, 10))
    assert m == evaluate_ranking(ids, bench.qrels, ks=(5, 10))
    assert m == evaluate_ranking(np.asarray(jids), bench.qrels, ks=(5, 10))
    assert m["ndcg@10"] > 0.5                  # the planted topics are found
