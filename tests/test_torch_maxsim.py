"""MaxSim scoring: the port's ``core.maxsim``, the scan's plain version
``maxsim_ref`` and the kernel wrappers ``maxsim_scores`` /
``maxsim_scores_chunked`` / ``maxsim_rerank`` (their CPU path) against
``repro``: the jnp references and the Pallas kernels in interpret mode.

Tolerance: rtol=1e-5, atol=1e-5 in f32 — the same float32 math summed in
another order (XLA on the CPU against PyTorch's CPU kernels). NEG
sentinels (-1e30, and Qv*NEG sums) fall under the relative term.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import maxsim as JMS
from repro.kernels import maxsim as JK
from repro_torch.core import maxsim as TMS
from repro_torch.kernels import maxsim as TK

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
NEG = -1e30


def _inputs(seed, B=3, Q=11, N=19, D=13, d=32, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Q, d)).astype(np.float32)
    docs = rng.normal(size=(N, D, d)).astype(dtype)
    qm = rng.random((B, Q)) > 0.25
    dm = rng.random((N, D)) > 0.15
    return rng, q, docs, qm, dm


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **TOL)


# ---------------------------------------------------------------------------
# core.maxsim
# ---------------------------------------------------------------------------

def test_core_maxsim_single_pair_and_scan():
    _, q, docs, qm, dm = _inputs(0)
    _close(TMS.maxsim(_t(q[0]), _t(docs[2]), _t(qm[0]), _t(dm[2])),
           JMS.maxsim(jnp.asarray(q[0]), jnp.asarray(docs[2]),
                      jnp.asarray(qm[0]), jnp.asarray(dm[2])))
    _close(TMS.maxsim_scan(_t(q[1]), _t(docs), _t(qm[1]), _t(dm)),
           JMS.maxsim_scan(jnp.asarray(q[1]), jnp.asarray(docs),
                           jnp.asarray(qm[1]), jnp.asarray(dm)))
    _close(TMS.maxsim_scan(_t(q[1]), _t(docs)),
           JMS.maxsim_scan(jnp.asarray(q[1]), jnp.asarray(docs)))


@pytest.mark.parametrize("chunk", [0, 4, 7, 19, 50])
def test_core_maxsim_batched_chunks(chunk):
    _, q, docs, qm, dm = _inputs(1)
    dm[5] = False                                # fully masked doc: Qv*NEG
    out = TMS.maxsim_batched(_t(q), _t(docs), _t(qm), _t(dm), chunk=chunk)
    ref = JMS.maxsim_batched(jnp.asarray(q), jnp.asarray(docs),
                             jnp.asarray(qm), jnp.asarray(dm), chunk=chunk)
    _close(out, ref)
    # chunking never changes the per-document math
    np.testing.assert_array_equal(
        out.numpy(), TMS.maxsim_batched(_t(q), _t(docs), _t(qm), _t(dm))
        .numpy())


def test_core_maxsim_bf16_store_promotes_to_f32():
    """f32 queries against a bf16 store: JAX promotes to f32; the port
    casts explicitly and must agree."""
    _, q, docs, qm, dm = _inputs(2)
    jd = jnp.asarray(docs, jnp.bfloat16)
    td = _t(docs).to(torch.bfloat16)
    _close(TMS.maxsim_batched(_t(q), td, _t(qm), _t(dm)),
           JMS.maxsim_batched(jnp.asarray(q), jd, jnp.asarray(qm),
                              jnp.asarray(dm)))
    vecs = docs[:, 0]
    _close(TMS.maxsim_single_vector(_t(q), _t(vecs).to(torch.bfloat16),
                                    _t(qm)),
           JMS.maxsim_single_vector(jnp.asarray(q),
                                    jnp.asarray(vecs, jnp.bfloat16),
                                    jnp.asarray(qm)))


def test_search_cost_madds_identical():
    args = (64, 16, 4096, 1024, 128)
    assert TMS.search_cost_madds(*args) == JMS.search_cost_madds(*args)


# ---------------------------------------------------------------------------
# the scan: plain version + wrapper
# ---------------------------------------------------------------------------

def test_maxsim_ref_matches_jax_ref_with_floor():
    _, q, docs, qm, dm = _inputs(3)
    dm[0] = False                                # clamped at NEG/2 per token
    out = TK.maxsim_ref(_t(q), _t(qm), _t(docs), _t(dm))
    ref = JK.maxsim_ref(jnp.asarray(q), jnp.asarray(qm, jnp.float32),
                        jnp.asarray(docs), jnp.asarray(dm, jnp.float32))
    _close(out, ref)
    np.testing.assert_allclose(out[:, 0].numpy(), qm.sum(1) * NEG / 2,
                               rtol=1e-6)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("B,Q,N,D,d", [(2, 8, 16, 32, 32),
                                       (3, 11, 19, 13, 32)])
def test_maxsim_scores_doc_valid(impl, B, Q, N, D, d):
    rng, q, docs, qm, dm = _inputs(4, B, Q, N, D, d)
    dm[1] = False                                # fully masked live doc
    valid = rng.random(N) > 0.3
    valid[1] = True
    out = TK.maxsim_scores(_t(q), _t(docs), _t(qm), _t(dm), _t(valid))
    ref = JK.maxsim_scores(jnp.asarray(q), jnp.asarray(docs),
                           jnp.asarray(qm, jnp.float32),
                           jnp.asarray(dm, jnp.float32), None,
                           jnp.asarray(valid), impl=impl, block_n=8,
                           block_d=8)
    _close(out, ref)
    assert (out[:, ~valid] == NEG).all()


def test_maxsim_scores_without_masks_and_bf16_docs():
    _, q, docs, _, _ = _inputs(5)
    out = TK.maxsim_scores(_t(q), _t(docs).to(torch.bfloat16))
    ref = JK.maxsim_scores(jnp.asarray(q), jnp.asarray(docs, jnp.bfloat16),
                           impl="pallas", block_n=8, block_d=8)
    _close(out, ref)


@pytest.mark.parametrize("chunk", [0, 5, 8, 64])
def test_maxsim_scores_chunked(chunk):
    rng, q, docs, qm, dm = _inputs(6, N=21)
    valid = rng.random(21) > 0.2
    out = TK.maxsim_scores_chunked(_t(q), _t(docs), _t(qm), _t(dm),
                                   _t(valid), chunk=chunk)
    ref = JK.maxsim_scores_chunked(jnp.asarray(q), jnp.asarray(docs),
                                   jnp.asarray(qm, jnp.float32),
                                   jnp.asarray(dm, jnp.float32), None,
                                   jnp.asarray(valid), chunk=chunk,
                                   impl="ref")
    _close(out, ref)


# ---------------------------------------------------------------------------
# the fused gather + rerank: plain version + wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_maxsim_rerank_ok_mask_and_clipped_rows(impl):
    rng, q, docs, qm, dm = _inputs(7)
    rows = rng.integers(-3, 22, (3, 9)).astype(np.int32)   # out of range
    ok = rng.random((3, 9)) > 0.3
    out = TK.maxsim_rerank(_t(q), _t(docs), _t(rows), _t(qm), _t(dm),
                           _t(ok))
    ref = JK.maxsim_rerank(jnp.asarray(q), jnp.asarray(docs),
                           jnp.asarray(rows), jnp.asarray(qm, jnp.float32),
                           jnp.asarray(dm, jnp.float32), None,
                           jnp.asarray(ok), impl=impl, block_d=13)
    _close(out, ref)
    assert (out[~_t(ok)] == NEG).all()


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_maxsim_rerank_broadcast_mask(impl):
    """No doc mask: JAX's kernel streams one broadcast [1, D] ones row; the
    port's wrapper takes None (and an explicit [1, D] row) the same way."""
    rng, q, docs, qm, _ = _inputs(8)
    rows = rng.integers(0, 19, (3, 6)).astype(np.int32)
    ref = JK.maxsim_rerank(jnp.asarray(q), jnp.asarray(docs),
                           jnp.asarray(rows), jnp.asarray(qm, jnp.float32),
                           impl=impl, block_d=13)
    _close(TK.maxsim_rerank(_t(q), _t(docs), _t(rows), _t(qm)), ref)
    row = torch.ones((1, docs.shape[1]), dtype=torch.bool)
    _close(TK.maxsim_rerank(_t(q), _t(docs), _t(rows), _t(qm), row), ref)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_maxsim_rerank_fully_masked_candidate_has_no_floor(impl):
    """A fully masked candidate scores Qv*NEG (no NEG/2 clamp, unlike the
    scan) and leaks nothing into the other candidates."""
    rng, q, docs, qm, dm = _inputs(9)
    dm[4] = False
    rows = np.asarray([[0, 4, 6]] * 3, np.int32)
    out = TK.maxsim_rerank(_t(q), _t(docs), _t(rows), _t(qm), _t(dm))
    ref = JK.maxsim_rerank(jnp.asarray(q), jnp.asarray(docs),
                           jnp.asarray(rows), jnp.asarray(qm, jnp.float32),
                           jnp.asarray(dm, jnp.float32), impl=impl,
                           block_d=13)
    _close(out, ref)
    qv = qm.sum(axis=1)
    np.testing.assert_allclose(out[:, 1].numpy(), qv * NEG, rtol=1e-6)
    assert np.isfinite(out[:, [0, 2]].numpy()).all()


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_maxsim_rerank_matryoshka_prefix(impl):
    """Docs narrower than the query score against the query prefix."""
    rng, q, docs, qm, dm = _inputs(10, d=32)
    narrow = np.ascontiguousarray(docs[..., :16])
    rows = rng.integers(0, 19, (3, 5)).astype(np.int32)
    out = TK.maxsim_rerank(_t(q), _t(narrow), _t(rows), _t(qm), _t(dm))
    ref = JK.maxsim_rerank(jnp.asarray(q), jnp.asarray(narrow),
                           jnp.asarray(rows), jnp.asarray(qm, jnp.float32),
                           jnp.asarray(dm, jnp.float32), impl=impl,
                           block_d=13)
    _close(out, ref)
