"""The chunked and streamed scans: the port's ``maxsim_scores_chunked`` /
``maxsim_scores_pipelined`` (their CPU path, the plain chunked loop)
against ``repro``'s double-buffered ``maxsim_pallas_db`` in interpret
mode, and ``maxsim_topk_chunked`` / ``Stage.scan_topk`` against repro's
streamed top-k.

Tolerance: rtol=1e-5, atol=1e-4 on scores — the same f32 products summed
in another order (int8: the same dequantised products). Top-k ids must be
exactly equal: ties keep the lower index in both packages.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core import multistage as JM
from repro.data.synthetic import make_benchmark
from repro.kernels import maxsim as JK
from repro.kernels.maxsim import ops as JOPS
from repro.retrieval.retriever import Retriever as JaxRetriever
from repro.retrieval.store import build_store as jax_build
from repro_torch.core import multistage as TM
from repro_torch.kernels import dispatch as DSP
from repro_torch.kernels import maxsim as TK
from repro_torch.retrieval import engine as TE
from repro_torch.retrieval.retriever import Retriever
from repro_torch.retrieval.store import _to_tensor, from_numpy

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
NEG = -1e30


def _t(x):
    return _to_tensor(np.asarray(x))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **TOL)


def _inputs(seed, dtype, B=3, Q=9, N=34, D=24, d=128):
    """numpy inputs; docs as the JAX array of ``dtype`` (int8: codes of a
    normal draw, with their scales)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Q, d)).astype(np.float32)
    x = rng.normal(size=(N, D, d)).astype(np.float32)
    scales = None
    if dtype == "int8":
        docs, scales = JK.quantize_int8(jnp.asarray(x))
    else:
        docs = jnp.asarray(x, getattr(jnp, dtype))
    qm = rng.random((B, Q)) > 0.25
    dm = rng.random((N, D)) > 0.1
    valid = rng.random(N) > 0.25
    return rng, q, docs, scales, qm, dm, valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("chunk", [5, 8, 16])
@pytest.mark.parametrize("mask", ["full", "broadcast"])
def test_chunked_scan_matches_pallas_db(dtype, chunk, mask):
    """N=34 is no chunk multiple; dead ``doc_valid`` slots, a fully masked
    document (floored at NEG/2 per valid token) and, for "broadcast", one
    [1, D] mask row that every chunk must see whole (repro's db kernel
    takes it expanded to [N, D])."""
    _, q, docs, scales, qm, dm, valid = _inputs(0, dtype)
    dm[6] = False
    if mask == "broadcast":
        dm = dm[:1] | True
        dm[0, :3] = False
    jdm = np.broadcast_to(dm, (docs.shape[0], dm.shape[1]))
    ref = JOPS.maxsim_scores_pipelined(
        jnp.asarray(q), docs, jnp.asarray(qm, jnp.float32),
        jnp.asarray(jdm, jnp.float32), scales, jnp.asarray(valid),
        chunk=chunk, interpret=True)
    sc = None if scales is None else _t(scales)
    DSP.reset_counts()
    out = TK.maxsim_scores_chunked(_t(q), _t(docs), _t(qm), _t(dm),
                                   _t(valid), chunk=chunk, scales=sc)
    assert all(DSP.launch_count(k) == 0 for k in DSP.KERNELS)
    _close(out, ref)
    assert (out[:, ~valid] == NEG).all()
    # the pipelined entry point and the plain loop are the same function
    # on the CPU; chunk never changes a score
    np.testing.assert_array_equal(
        TK.maxsim_scores_pipelined(_t(q), _t(docs), _t(qm), _t(dm),
                                   _t(valid), chunk=chunk,
                                   scales=sc).numpy(), out.numpy())
    _close(TK.maxsim_chunked_ref(_t(q), _t(docs), _t(qm), _t(dm), _t(valid),
                                 chunk=0, scales=sc), out)


def test_broadcast_mask_is_not_sliced_per_chunk():
    """A [1, D] mask scores every chunk, not only the first: the chunked
    scan with one broadcast row equals the scan with that row repeated."""
    _, q, docs, _, qm, _, _ = _inputs(1, "float32", N=20)
    row = torch.ones((1, 24), dtype=torch.bool)
    row[0, 5:9] = False
    out = TK.maxsim_scores_chunked(_t(q), _t(docs), _t(qm), row, chunk=6)
    full = TK.maxsim_scores(_t(q), _t(docs), _t(qm), row.expand(20, 24))
    np.testing.assert_array_equal(out.numpy(), full.numpy())


# ---------------------------------------------------------------------------
# streamed top-k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("chunk", [5, 16, 48, 200])
def test_topk_chunked_matches_global_select(chunk, use_kernel):
    """Mirror of ``test_kernels.py::test_topk_chunked_matches_global_select``
    against repro's streamed top-k, ids exactly equal."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(3, 9, 64)).astype(np.float32)
    docs = rng.normal(size=(48, 24, 64)).astype(np.float32)
    qm = rng.random((3, 9)) > 0.2
    dm = rng.random((48, 24)) > 0.1
    dv = rng.random(48) > 0.3
    ev, ei = JK.maxsim_topk_chunked(
        jnp.asarray(q), jnp.asarray(docs), jnp.asarray(qm, jnp.float32),
        jnp.asarray(dm, jnp.float32), None, jnp.asarray(dv), k=12,
        chunk=chunk, impl="ref")
    v, i = TK.maxsim_topk_chunked(_t(q), _t(docs), _t(qm), _t(dm), _t(dv),
                                  k=12, chunk=chunk, use_kernel=use_kernel)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ei))
    _close(v, ev)
    s = TK.maxsim_scores(_t(q), _t(docs), _t(qm), _t(dm), _t(dv))
    gv, gi = TM.top_k(s, 12)
    np.testing.assert_array_equal(i.numpy(), gi.numpy())


def test_topk_chunked_padding_never_leaks_ids():
    """Mirror of ``test_kernels.py::test_topk_chunked_padding_never_leaks_
    ids``: N=5 in chunks of 4 pads 3 slots at -inf, below a fully token-
    masked live document's Q*NEG; k=5 takes every real slot."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 6, 32)).astype(np.float32)
    docs = rng.normal(size=(5, 8, 32)).astype(np.float32)
    dm = np.ones((5, 8), bool)
    dm[0] = False
    ev, ei = JK.maxsim_topk_chunked(jnp.asarray(q), jnp.asarray(docs), None,
                                    jnp.asarray(dm, jnp.float32), None, None,
                                    k=5, chunk=4, impl="ref")
    v, i = TK.maxsim_topk_chunked(_t(q), _t(docs), None, _t(dm), None, k=5,
                                  chunk=4)
    assert (i >= 0).all() and (i < 5).all(), i
    np.testing.assert_array_equal(i.numpy(), np.asarray(ei))
    _close(v, ev)


def test_topk_chunked_dead_slots_and_all_masked():
    """k above the live documents: dead ``doc_valid`` slots fill the tail
    at NEG in index order, never padding ids."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 5, 16)).astype(np.float32)
    docs = rng.normal(size=(11, 6, 16)).astype(np.float32)
    dv = np.zeros(11, bool)
    dv[[2, 7]] = True
    ev, ei = JK.maxsim_topk_chunked(jnp.asarray(q), jnp.asarray(docs), None,
                                    None, None, jnp.asarray(dv), k=9,
                                    chunk=4, impl="ref")
    v, i = TK.maxsim_topk_chunked(_t(q), _t(docs), None, None, _t(dv), k=9,
                                  chunk=4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ei))
    _close(v, ev)
    assert (i < 11).all() and (v[:, 2:] == NEG).all()


def test_topk_chunked_int8_pallas():
    """Mirror of ``test_kernels.py::test_topk_chunked_int8_pallas``: repro
    streams int8 codes through its Pallas scan (interpret); the port's
    CPU path through the plain int8 scan."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 8, 128)).astype(np.float32)
    docs = rng.normal(size=(32, 16, 128)).astype(np.float32)
    codes, scales = JK.quantize_int8(jnp.asarray(docs))
    ev, ei = JK.maxsim_topk_chunked(jnp.asarray(q), codes, None, None,
                                    scales, None, k=6, chunk=8,
                                    impl="pallas", block_n=8, block_d=16)
    v, i = TK.maxsim_topk_chunked(_t(q), _t(codes), k=6, chunk=8,
                                  scales=_t(scales))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ei))
    _close(v, ev)


# ---------------------------------------------------------------------------
# the cascade with the chunked and streamed scans
# ---------------------------------------------------------------------------

def test_scan_policy_mirrors_repro():
    assert TM.DEFAULT_SCAN_TOPK_CHUNK == JM.DEFAULT_SCAN_TOPK_CHUNK
    assert TE.INT8_REF_CHUNK == 1024
    st = TM.with_scan_policy(TM.two_stage(16, 10), use_kernel=True,
                             chunk=8, scan_topk=True)
    jst = JM.with_scan_policy(JM.two_stage(16, 10), use_kernel=True,
                              chunk=8, scan_topk=True)
    assert [(s.vector, s.k, s.use_kernel, s.chunk, s.scan_topk) for s in st] \
        == [(s.vector, s.k, s.use_kernel, s.chunk, s.scan_topk) for s in jst]
    assert TM.with_scan_policy(st, chunk=3)[0].scan_topk


@pytest.fixture(scope="module")
def corpus():
    jc = dataclasses.replace(jax_config("colpali"), grid_h=8, grid_w=8,
                             out_dim=32)
    bench = make_benchmark(jc, (16, 14, 12), (4, 4, 4), n_topics_per_ds=5,
                           seed=9)
    js = jax_build(jc, jnp.asarray(bench.pages),
                   jnp.asarray(bench.token_types))
    ts = from_numpy({k: np.asarray(v) for k, v in js.vectors.items()},
                    device="cpu")
    return dict(bench=bench, jax=js, port=ts)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("kernels,chunk,topk", [
    (True, 7, False), (True, 7, True), (False, 0, True), (False, 9, True)])
def test_retriever_chunked_and_scan_topk_match_repro(corpus, n, kernels,
                                                     chunk, topk):
    q, qm = corpus["bench"].queries, corpus["bench"].query_mask
    stages = {1: JM.one_stage(10), 2: JM.two_stage(16, 10),
              3: JM.three_stage(32, 16, 10)}[n]
    st = JM.with_rerank_policy(
        JM.with_scan_policy(stages, use_kernel=kernels, chunk=chunk,
                            scan_topk=topk), rerank_kernel=kernels)
    pst = tuple(TM.Stage(s.vector, s.k, use_kernel=s.use_kernel,
                         chunk=s.chunk, scan_topk=s.scan_topk,
                         rerank_kernel=s.rerank_kernel) for s in st)
    js, ji = JaxRetriever(corpus["jax"], capacity=64).search(
        jnp.asarray(q), jnp.asarray(qm), stages=st, translate_ids=False)
    ts, ti = Retriever(corpus["port"], capacity=64, device="cpu").search(
        q, qm, stages=pst, translate_ids=False)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=1e-5,
                               atol=1e-5)
