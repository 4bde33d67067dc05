"""The shape-bucketed micro-batching frontend: the port against itself and
against ``repro``'s, mirroring ``tests/test_frontend.py`` (without the
tiered-engine paths) and the frontend tests of ``tests/test_filters.py``.

- the same requests through ``repro``'s and the port's frontends give
  equal ids and scores within rtol=1e-6, atol=1e-6, directly and
  micro-batched, filtered and not;
- micro-batched results equal per-request results BIT FOR BIT, padded
  batch rows (no valid token) included in the blocks;
- after ``warm()`` ragged traffic builds nothing, and so does ragged
  traffic on the raw ``Retriever``: eager PyTorch compiles nothing per
  query shape, where ``repro`` retraces once per new shape (3 in its
  ``test_raw_retriever_retraces_per_shape``); the port counts 0;
- flush triggers, the result cache (LRU, invalidated by every mutation
  through the store generation, isolated per tenant), tenant quotas,
  round-robin fairness, deadline shedding and the error paths of
  ``flush`` run on a fake clock.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import multistage as JM
from repro.retrieval import frontend as JF
from repro.retrieval import store as JS
from repro.retrieval.retriever import Retriever as JRetriever
from repro_torch.core import multistage as TM
from repro_torch.retrieval import tracing
from repro_torch.retrieval.frontend import (AdmissionError, DeadlineExceeded,
                                            PendingResult, ServingFrontend,
                                            bucket_ladder, replay_open_loop)
from repro_torch.retrieval.retriever import Retriever
from repro_torch.retrieval.store import NULL_FILTER, FilterSpec, VectorStore

torch.set_num_threads(1)

D, DP, DIM = 4, 2, 8
STAGES = TM.two_stage(8, 4)
TOL = dict(rtol=1e-6, atol=1e-6)
NEG_CUT = -1e29


def _arrays(n: int, seed: int) -> dict:
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, D, DIM)).astype(np.float32)
    ini = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)
    return {"initial": ini, "initial_mask": np.ones((n, D), bool),
            "mean_pooling": np.ascontiguousarray(ini[:, :DP]),
            "mean_pooling_mask": np.ones((n, DP), bool),
            "global_pooling": ini.mean(1)}


def _batch(n: int, seed: int) -> VectorStore:
    return VectorStore({k: torch.from_numpy(v.copy())
                        for k, v in _arrays(n, seed).items()}, n, "float32")


def _jbatch(n: int, seed: int) -> JS.VectorStore:
    return JS.VectorStore({k: jnp.asarray(v)
                           for k, v in _arrays(n, seed).items()}, n,
                          "float32")


def _retriever(n=24, seed=0, **kw):
    return Retriever(_batch(n, seed), device="cpu", **kw)


@pytest.fixture()
def frontend():
    return ServingFrontend(_retriever(), STAGES, max_batch=4, max_q=8,
                           min_q=2, flush_ms=1.0)


def _ragged(rng, b=None, q_hi=8):
    b = b or int(rng.integers(1, 5))
    ql = int(rng.integers(1, q_hi + 1))
    return rng.normal(size=(b, ql, DIM)).astype(np.float32)


def _clock(t0=0.0):
    t = [t0]
    return t, (lambda: t[0])


def test_bucket_ladder_is_repros():
    assert bucket_ladder(16) == (1, 2, 4, 8, 16)
    assert bucket_ladder(20, 5) == (8, 16, 32)      # both ends round up
    for hi, lo in ((1, 1), (16, 1), (20, 5), (32, 8), (7, 7), (3, 9)):
        assert bucket_ladder(hi, lo) == JF.bucket_ladder(hi, lo)
    for bad in ((0, 1), (4, 0)):
        with pytest.raises(ValueError):
            bucket_ladder(*bad)


def test_bucket_for_bounds(frontend):
    assert frontend.bucket_for(3, 5) == (4, 8)
    assert frontend.bucket_for(1, 1) == (1, 2)      # min_q floor
    assert frontend.bucket_for(4, 8) == (4, 8)
    for b, q in ((5, 4), (1, 9), (0, 4)):
        with pytest.raises(ValueError):
            frontend.bucket_for(b, q)
    with pytest.raises(ValueError):
        frontend.search(np.zeros((2, 3, 4, DIM), np.float32))


def test_query_shape_zero_retrace_acceptance(frontend):
    """Warm the bucket set, then arbitrary in-bounds ragged traffic —
    mixed batch sizes AND token counts, direct and micro-batched — builds
    nothing."""
    warmed = frontend.warm()
    assert warmed == len(frontend.b_buckets) * len(frontend.q_buckets)
    rng = np.random.default_rng(1)
    with tracing.no_retrace("ragged traffic"):
        for _ in range(25):
            frontend.search(_ragged(rng))
        pending = [frontend.submit(_ragged(rng, b=1)) for _ in range(9)]
        frontend.drain()
    assert all(p.done() for p in pending)


def test_raw_retriever_builds_nothing_per_query_shape():
    """repro's raw Retriever retraces its cascade once per new (B, Q)
    query shape (3 here); an eager PyTorch search function takes any
    shape, so the port counts 0 — only the first search builds one."""
    r = _retriever()
    rng = np.random.default_rng(2)
    before = tracing.trace_count()
    r.search(_ragged(rng), stages=STAGES)
    assert tracing.trace_count() - before == 1
    with tracing.no_retrace("new query shapes"):
        for b, ql in ((1, 3), (2, 5), (3, 7)):
            r.search(rng.normal(size=(b, ql, DIM)).astype(np.float32),
                     stages=STAGES)


def test_same_requests_as_repro(frontend):
    """Direct and micro-batched requests through both frontends: equal
    ids, scores within 1e-6."""
    jfe = JF.ServingFrontend(JRetriever(_jbatch(24, 0)),
                             JM.two_stage(8, 4), max_batch=4, max_q=8,
                             min_q=2, flush_ms=1.0)
    rng = np.random.default_rng(3)
    reqs = [_ragged(rng) for _ in range(6)]
    for q in reqs:
        s, i = frontend.search(q)
        js, ji = jfe.search(q)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(s, np.asarray(js, np.float32), **TOL)
    singles = [_ragged(rng, b=1) for _ in range(7)]
    prs = [frontend.submit(q) for q in singles]
    jprs = [jfe.submit(q) for q in singles]
    frontend.drain()
    jfe.drain()
    for pr, jpr in zip(prs, jprs):
        np.testing.assert_array_equal(pr.ids, jpr.ids)
        np.testing.assert_allclose(pr.scores,
                                   np.asarray(jpr.scores, np.float32), **TOL)
    assert frontend.stats["dispatches"] == jfe.stats["dispatches"]
    assert frontend.stats["rows_padded"] == jfe.stats["rows_padded"]


def test_padded_vs_exact_score_parity(frontend):
    """A ragged query padded to its bucket matches the exact-shape search:
    identical ranking, scores equal to 1e-6."""
    rng = np.random.default_rng(3)
    for _ in range(5):
        q = _ragged(rng)
        s_f, i_f = frontend.search(q)
        s_e, i_e = frontend.retriever.search(q, stages=STAGES)
        np.testing.assert_array_equal(i_f, i_e)
        np.testing.assert_allclose(s_f, s_e.numpy(), **TOL)


def test_padded_batch_rows_dropped(frontend):
    rng = np.random.default_rng(4)
    q = _ragged(rng, b=3)                           # bucket pads to B=4
    s, i = frontend.search(q)
    assert s.shape[0] == 3 and i.shape[0] == 3
    assert (i >= 0).all()                           # all real live pages
    assert frontend.stats["rows_padded"] == 1


@pytest.mark.parametrize("policy", ["ref", "kernel"])
def test_micro_batch_bitwise_equals_per_request(policy):
    """Coalesced micro-batches (blocks with padded zero-token rows
    included) return exactly what per-request dispatches return, and what
    Retriever.search on the unpadded query returns: the same ids, scores
    to 1e-6 (on the card, where the kernels sum only the valid tokens,
    ``chip_smoke.py`` holds those bit for bit too)."""
    stages = STAGES if policy == "ref" else TM.with_rerank_policy(
        TM.with_scan_policy(STAGES, use_kernel=True), rerank_kernel=True)
    fe = ServingFrontend(_retriever(), stages, max_batch=4, max_q=8,
                         min_q=2, flush_ms=1.0)
    fe.warm()
    rng = np.random.default_rng(5)
    reqs = [_ragged(rng, b=1) for _ in range(7)] + [_ragged(rng, b=2)]
    pending = [fe.submit(q) for q in reqs]
    fe.drain()
    # micro-batching happened, and some block carried padded rows
    assert fe.stats["dispatches"] < len(reqs)
    assert fe.stats["rows_padded"] > 0
    for q, pr in zip(reqs, pending):
        s1, i1 = fe.search(q)
        np.testing.assert_array_equal(pr.scores, s1)
        np.testing.assert_array_equal(pr.ids, i1)
        # against the unpadded query shape: the plain path's sum over the
        # Q token slots takes the masked zeros in another order (1 ulp)
        s2, i2 = fe.retriever.search(q, stages=stages)
        np.testing.assert_allclose(pr.scores, s2.numpy(), **TOL)
        np.testing.assert_array_equal(pr.ids, i2)


def test_zero_token_rows_score_zero():
    """A batch row with no valid token (what bucket padding sends) scores
    0 for every document on every policy path, as in repro, and does not
    change its neighbours' results."""
    r = _retriever()
    rng = np.random.default_rng(6)
    q = rng.normal(size=(3, 4, DIM)).astype(np.float32)
    qm = np.ones((3, 4), bool)
    qm[1] = False
    for stages in (STAGES, TM.with_rerank_policy(TM.with_scan_policy(
            STAGES, use_kernel=True, chunk=8), rerank_kernel=True)):
        s, i = r.search(q, qm, stages=stages)
        assert (s[1] == 0).all()
        for b in (0, 2):
            s1, i1 = r.search(q[b:b + 1], qm[b:b + 1], stages=stages)
            assert torch.equal(s[b:b + 1], s1)
            np.testing.assert_array_equal(i[b:b + 1], i1)
    jr = JRetriever(_jbatch(24, 0))
    js, _ = jr.search(jnp.asarray(q), jnp.asarray(qm),
                      stages=JM.two_stage(8, 4))
    assert (np.asarray(js)[1] == 0).all()


def test_flush_triggers():
    t, clock = _clock()
    fe = ServingFrontend(_retriever(16), STAGES, max_batch=4, max_q=4,
                         min_q=4, flush_ms=5.0, clock=clock)
    rng = np.random.default_rng(6)
    one = lambda: fe.submit(rng.normal(size=(1, 4, DIM)).astype(np.float32))
    one()
    assert fe.pump() == 0 and fe.pending == 1       # neither trigger fired
    t[0] += 0.006                                   # past the 5ms deadline
    assert fe.pump() == 1 and fe.pending == 0
    prs = [one() for _ in range(4)]                 # fills max_batch=4 rows
    assert fe.pump() == 4 and all(p.done() for p in prs)
    assert fe.next_deadline() is None


def test_result_cache_lru():
    fe = ServingFrontend(_retriever(16), STAGES, max_batch=2, max_q=4,
                         min_q=4, cache_size=2)
    rng = np.random.default_rng(7)
    qs = [rng.normal(size=(1, 4, DIM)).astype(np.float32) for _ in range(3)]
    s0, i0 = fe.search(qs[0])
    d0 = fe.stats["dispatches"]
    s0b, i0b = fe.search(qs[0])                     # hit: no new dispatch
    assert fe.stats["dispatches"] == d0 and fe.stats["cache_hits"] == 1
    np.testing.assert_array_equal(s0, s0b)
    np.testing.assert_array_equal(i0, i0b)
    pr = fe.submit(qs[0])                           # hit on the queue path
    assert pr.done() and pr.cached and fe.pending == 0
    np.testing.assert_array_equal(pr.scores, s0)
    fe.search(qs[1])
    fe.search(qs[2])                                # evicts qs[0] (LRU, 2)
    fe.search(qs[0])
    assert fe.stats["cache_hits"] == 2              # miss after eviction


def test_result_cache_invalidated_on_corpus_mutation():
    """upsert, ingest-style commits, delete and compact all bump the store
    generation, which is part of the cache key."""
    r = Retriever(_batch(12, 0), capacity=64, device="cpu")
    fe = ServingFrontend(r, STAGES, max_batch=2, max_q=4, min_q=4,
                         cache_size=8)
    rng = np.random.default_rng(10)
    q = rng.normal(size=(1, 4, DIM)).astype(np.float32)
    s0, i0 = fe.search(q)
    r.delete([int(i0[0, 0])])                       # kill the top hit
    s1, i1 = fe.search(q)                           # must NOT come cached
    assert fe.stats["cache_hits"] == 0
    assert int(i0[0, 0]) not in i1[0]
    r.upsert(_batch(3, 1))
    fe.search(q)
    assert fe.stats["cache_hits"] == 0              # invalidated again
    fe.search(q)
    assert fe.stats["cache_hits"] == 1              # stable corpus: hits
    r.compact()
    fe.search(q)
    assert fe.stats["cache_hits"] == 1              # compact invalidates
    assert r.delete([10_000]) == 0                  # a no-op delete ...
    fe.search(q)
    assert fe.stats["cache_hits"] == 2              # ... keeps the line


def test_warm_does_not_pollute_traffic_stats(frontend):
    frontend.warm()
    assert frontend.stats["dispatches"] == 0
    assert frontend.stats["rows_real"] == 0 and \
        frontend.stats["rows_padded"] == 0


def test_submit_honors_scheduled_arrival_time():
    t, clock = _clock(10.0)
    fe = ServingFrontend(_retriever(8), STAGES, max_batch=1, max_q=4,
                         min_q=4, clock=clock)
    q = np.random.default_rng(11).normal(size=(1, 4, DIM)).astype(np.float32)
    pr = fe.submit(q, t_submit=7.5)                 # fell due 2.5s "ago"
    t[0] = 10.5
    fe.flush()
    assert pr.latency == pytest.approx(10.5 - 7.5)


def test_retriever_mask_normalization():
    """q_mask=None, an all-ones bool mask and an all-ones float mask give
    bit-identical results and build one search function."""
    r = _retriever(16)
    q = np.random.default_rng(8).normal(size=(2, 4, DIM)).astype(np.float32)
    s0, i0 = r.search(q, None, stages=STAGES)
    with tracing.no_retrace("mask-normalization"):
        s1, i1 = r.search(q, np.ones((2, 4), bool), stages=STAGES)
        s2, i2 = r.search(q, torch.ones((2, 4)), stages=STAGES)
    for s, i in ((s1, i1), (s2, i2)):
        assert torch.equal(s, s0)
        np.testing.assert_array_equal(i, i0)


def test_chunked_int8_nondivisible_n():
    from repro.kernels.maxsim import ops as JOPS
    from repro_torch.kernels.maxsim import ops as KOPS

    rng = np.random.default_rng(9)
    q = rng.normal(size=(3, 5, DIM)).astype(np.float32)
    docs = rng.normal(size=(21, D, DIM)).astype(np.float32)
    codes, scales = KOPS.quantize_int8(torch.from_numpy(docs))
    full = KOPS.maxsim_scores(torch.from_numpy(q), codes, scales=scales)
    jc, js = JOPS.quantize_int8(jnp.asarray(docs))
    jfull = JOPS.maxsim_scores(jnp.asarray(q), jc, jnp.ones((3, 5), bool),
                               jnp.ones((21, D), bool), js, impl="ref")
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), rtol=1e-5,
                               atol=1e-5)
    for chunk in (8, 5):                            # 21 % 8, 21 % 5 != 0
        part = KOPS.maxsim_scores_chunked(torch.from_numpy(q), codes,
                                          chunk=chunk, scales=scales)
        np.testing.assert_allclose(part.numpy(), full.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_pending_result_latency():
    pr = PendingResult(t_submit=1.0)
    with pytest.raises(ValueError):
        pr.latency
    with pytest.raises(ValueError):
        pr.result()
    pr.t_done = 1.25
    assert pr.latency == pytest.approx(0.25)


def test_poisoned_dispatch_completes_requests_no_leak():
    """A dispatch that throws completes every popped request WITH the
    error, the queued-row and quota accounting returns to zero, and the
    next healthy flush serves normally."""
    r = _retriever(16)
    fe = ServingFrontend(r, STAGES, max_batch=4, max_q=4, min_q=4,
                         tenant_quota=8)
    rng = np.random.default_rng(12)
    qs = [rng.normal(size=(1, 4, DIM)).astype(np.float32) for _ in range(3)]
    boom = RuntimeError("injected dispatch failure")
    good_search = r.search
    r.search = lambda *a, **kw: (_ for _ in ()).throw(boom)
    prs = [fe.submit(q) for q in qs]
    assert fe.flush() == len(prs)
    for pr in prs:
        assert pr.done() and pr.error is boom and not pr.shed
        with pytest.raises(RuntimeError, match="injected dispatch"):
            pr.result()
    assert fe.stats["errors"] == len(prs)
    assert fe.pending == 0 and fe._queued_rows == 0
    assert not fe._tenant_rows
    r.search = good_search
    pr = fe.submit(qs[0])
    fe.flush()
    s, i = pr.result()
    np.testing.assert_array_equal(s, fe.search(qs[0])[0])
    np.testing.assert_array_equal(i, fe.search(qs[0])[1])


def test_kill_signal_completes_cohort_then_propagates():
    r = _retriever(16)
    fe = ServingFrontend(r, STAGES, max_batch=4, max_q=4, min_q=4)
    rng = np.random.default_rng(13)
    qs = [rng.normal(size=(1, 4, DIM)).astype(np.float32) for _ in range(2)]
    boom = KeyboardInterrupt("drain now")
    r.search = lambda *a, **kw: (_ for _ in ()).throw(boom)
    prs = [fe.submit(q) for q in qs]
    with pytest.raises(KeyboardInterrupt):
        fe.flush()
    for pr in prs:
        assert pr.done() and pr.error is boom
    assert fe.pending == 0 and fe._queued_rows == 0


def test_deadline_shed_at_admission_and_flush():
    t, clock = _clock()
    fe = ServingFrontend(_retriever(16), STAGES, max_batch=4, max_q=4,
                         min_q=4, deadline_ms=10.0, clock=clock)
    q = np.random.default_rng(13).normal(size=(1, 4, DIM)).astype(np.float32)
    late = fe.submit(q, t_submit=-1.0)              # blown at admission
    assert late.done() and late.shed and fe.pending == 0
    with pytest.raises(DeadlineExceeded):
        late.result()
    doomed = fe.submit(q)
    live = fe.submit(q, deadline_ms=60_000.0)       # per-request override
    t[0] = 0.02                                     # 20ms > 10ms deadline
    fe.flush()
    assert doomed.shed and not live.shed and live.error is None
    live.result()
    assert fe.stats["shed"] == 2
    fe2 = ServingFrontend(_retriever(8), STAGES, max_batch=1, max_q=4,
                          min_q=4, clock=clock)
    pr = fe2.submit(q, t_submit=-100.0)
    assert pr.deadline is None and not pr.done()


def test_replay_open_loop_serves_every_request():
    fe = ServingFrontend(_retriever(), STAGES, max_batch=4, max_q=8,
                         min_q=2, flush_ms=1.0)
    fe.warm()
    rng = np.random.default_rng(14)
    reqs = [(q[0], np.ones(q.shape[1], bool))
            for q in (_ragged(rng, b=1) for _ in range(12))]
    with tracing.no_retrace("replay"):
        served, wall = replay_open_loop(fe, reqs, rate=2000.0, seed=1)
    assert len(served) == 12 and wall > 0
    assert all(p.done() and p.error is None and p.latency >= 0
               for p in served)
    for (q, qm), pr in zip(reqs, served):
        s, i = fe.search(q, qm)
        np.testing.assert_array_equal(pr.ids, i)


# ----------------------------------------------------------------------
# multi-tenant serving (tests/test_filters.py's frontend tests)
# ----------------------------------------------------------------------

def _tenant_frontend(**kw):
    from test_torch_filters import _two_tenant
    tr, jr, _, _, _ = _two_tenant()
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_q", 8)
    return ServingFrontend(tr, TM.two_stage(8, 4), **kw), tr, jr


def _tq():
    from test_torch_filters import QMASK, QUERY
    return QUERY, QMASK


def test_cross_tenant_cache_isolation():
    fe, _, _ = _tenant_frontend(cache_size=16)
    query, _ = _tq()
    q = query[0]
    s0, i0 = fe.search(q, filter=FilterSpec(tenant=0))
    s1, i1 = fe.search(q, filter=FilterSpec(tenant=1))
    assert fe.stats["cache_hits"] == 0
    assert not np.array_equal(i0, i1)
    assert set(i0[s0 > NEG_CUT]) <= set(range(4, 12))
    assert set(i1[s1 > NEG_CUT]) <= set(range(12, 24))
    s0b, i0b = fe.search(q, filter=FilterSpec(tenant=0))
    assert fe.stats["cache_hits"] == 1
    np.testing.assert_array_equal(i0b, i0)
    fe.search(q)
    fe.search(q, filter=NULL_FILTER)
    assert fe.stats["cache_hits"] == 2


def test_tenant_quota_rejects_excess():
    fe, _, _ = _tenant_frontend(tenant_quota=2)
    query, _ = _tq()
    f1 = FilterSpec(tenant=1)
    fe.submit(query[0], filter=f1)
    fe.submit(query[1], filter=f1)
    with pytest.raises(AdmissionError):
        fe.submit(query[2], filter=f1)
    assert fe.stats["rejected"] == 1
    pr = fe.submit(query[2], filter=FilterSpec(tenant=0))
    assert fe.drain() == 3 and pr.done()
    fe.submit(query[2], filter=f1)
    assert fe.pending == 1


def test_round_robin_flush_is_fair():
    fe, _, _ = _tenant_frontend()
    query, _ = _tq()
    burst, quiet = FilterSpec(tenant=1), FilterSpec(tenant=0)
    for j in range(8):
        fe.submit(query[j % 3] + j, filter=burst)
    pq = fe.submit(query[0], filter=quiet)
    fe.flush()
    fe.flush()
    assert pq.done(), "quiet tenant starved behind the burst backlog"
    assert fe.drain() > 0


def test_micro_batch_carries_one_filter_and_matches_repro():
    """Mixed-filter submissions never share a block; each equals the
    direct search and repro's frontend on the same store."""
    fe, tr, jr = _tenant_frontend()
    query, qmask = _tq()
    jfe = JF.ServingFrontend(jr, JM.two_stage(8, 4), max_batch=4, max_q=8)
    specs = (FilterSpec(tenant=0), FilterSpec(tenant=1), None)
    jspecs = (JS.FilterSpec(tenant=0), JS.FilterSpec(tenant=1), None)
    prs = [fe.submit(query[0], filter=f) for f in specs]
    jprs = [jfe.submit(query[0], filter=f) for f in jspecs]
    assert fe.drain() == 3 and jfe.drain() == 3
    assert fe.stats["dispatches"] == 3
    for pr, jpr, f in zip(prs, jprs, specs):
        s, i = tr.search(query[:1], qmask[:1], stages=fe.stages, filter=f)
        np.testing.assert_array_equal(pr.ids, i)
        np.testing.assert_allclose(pr.scores, s.numpy(), **TOL)
        s1, i1 = fe.search(query[0], filter=f)
        np.testing.assert_array_equal(pr.ids, i1)
        np.testing.assert_array_equal(pr.scores, s1)
        np.testing.assert_array_equal(pr.ids, jpr.ids)
        np.testing.assert_allclose(pr.scores, np.asarray(jpr.scores), **TOL)
