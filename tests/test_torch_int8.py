"""int8 storage: the port's ``quantize_int8``, the int8 scan and rerank
wrappers (their CPU path), ``quantize_store``/``quantize_vectors``, the
schema of a quantised store, the ingest pipeline's ``quantize=`` option,
int8 search through ``Retriever`` and ``serve.py --int8`` against
``repro``.

Exact where the reference is exact: int8 codes and f32 scales bit for bit
(the port writes XLA's arithmetic: ``max(amax, eps) * float32(1/127)`` and
a real per-element division, rounding half to even), key sets, schema
records and ids. Scores: rtol=1e-5, atol=1e-4 — f32 sums of the same
dequantised products in another order (repro runs its Pallas kernels in
interpret mode).
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
from repro.retrieval import ingest as JI
from repro.retrieval import store as JS
from repro.retrieval.retriever import Retriever as JaxRetriever
from repro_torch.configs import get_config
from repro_torch.core import multistage as TM
from repro_torch.kernels import maxsim as TK
from repro_torch.launch import serve as TSERVE
from repro_torch.retrieval import ingest as TI
from repro_torch.retrieval import store as TS
from repro_torch.retrieval.retriever import Retriever

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
NEG = -1e30
SHRINK = dict(grid_h=8, grid_w=8, out_dim=32)


def _t(x):
    return TS._to_tensor(np.asarray(x))


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **TOL)


def _same_codes(jres, tres):
    (jc, js), (tc, ts) = jres, tres
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(js).view(np.uint32),
                                  ts.numpy().view(np.uint32))


# ---------------------------------------------------------------------------
# quantize_int8: codes and scales bit for bit
# ---------------------------------------------------------------------------

def _ties(rng):
    """[4, 3, 16] vectors whose elements land exactly on k + 0.5 after the
    division by their scale: the amax is 127 * 2**-m, which makes the
    scale exactly 2**-m, so (k + 0.5) * 2**-m divides exactly."""
    rows = []
    for m in (3, 6, 9, 12):
        amax = np.float32(127 * 2.0 ** -m)
        s = amax * np.float32(1 / 127)
        assert s == np.float32(2.0 ** -m)
        for sign in (1, -1):
            k = rng.integers(0, 126, 15) + 0.5
            rows.append(np.concatenate([[amax], sign * k * s]))
        rows.append(np.concatenate([[-amax], (np.arange(15) - 7.5) * s]))
    x = np.asarray(rows, np.float32).reshape(4, 3, 16)
    assert (np.abs(x / np.abs(x).max(-1, keepdims=True)
                   * np.float32(127)) % 1 == 0.5).sum() > 100
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [0, 5, 8])
def test_quantize_int8_bitwise(dtype, chunk):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(21, 34, 128)).astype(np.float32)
    x[2, 7] = 0.0                                  # the eps path
    x[4] *= 1e-3
    jx = jnp.asarray(x, getattr(jnp, dtype))
    _same_codes(JK.quantize_int8(jx, chunk=chunk),
                TK.quantize_int8(_t(jx), chunk=chunk))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_round_half_to_even(dtype):
    x = _ties(np.random.default_rng(1))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jres = JK.quantize_int8(jx)
    tres = TK.quantize_int8(_t(jx))
    _same_codes(jres, tres)
    codes = tres[0].numpy().astype(np.int64)
    assert (codes[..., 1:] % 2 == 0).all()         # every .5 went to even


# ---------------------------------------------------------------------------
# int8 scan and rerank wrappers against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------

def _int8_inputs(seed, B=2, Q=8, N=16, D=64, d=128):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Q, d)).astype(np.float32)
    docs = rng.normal(size=(N, D, d)).astype(np.float32)
    codes, scales = JK.quantize_int8(jnp.asarray(docs))
    qm = rng.random((B, Q)) > 0.25
    dm = rng.random((N, D)) > 0.1
    return rng, q, docs, codes, scales, qm, dm


def test_maxsim_int8():
    """Mirror of ``test_kernels.py::test_maxsim_int8``: the int8 scan
    against repro's int8 Pallas scan, and against the float scan within
    the int8 quantisation error."""
    rng, q, docs, codes, scales, qm, dm = _int8_inputs(0)
    dm[3] = False                                   # fully masked doc
    valid = rng.random(16) > 0.2
    out = TK.maxsim_scores(_t(q), _t(codes), _t(qm), _t(dm), _t(valid),
                           scales=_t(scales))
    ref = JK.maxsim_scores(jnp.asarray(q), codes,
                           jnp.asarray(qm, jnp.float32),
                           jnp.asarray(dm, jnp.float32), scales,
                           jnp.asarray(valid), impl="pallas", block_n=8,
                           block_d=64)
    _close(out, ref)
    assert (out[:, ~valid] == NEG).all()
    full = JK.maxsim_ref(jnp.asarray(q), jnp.ones((2, 8)),
                         jnp.asarray(docs), jnp.ones((16, 64)))
    np.testing.assert_allclose(
        TK.maxsim_scores(_t(q), _t(codes), scales=_t(scales)).numpy(),
        np.asarray(full), rtol=2e-2, atol=2e-1)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_rerank_int8_dequant_in_kernel(impl):
    """Mirror of ``test_kernels.py::test_rerank_int8_dequant_in_kernel``,
    with a doc mask, a fully masked candidate (Qv*NEG, no floor) and an
    ``ok`` mask."""
    rng, q, _, codes, scales, qm, dm = _int8_inputs(1, N=24, D=32)
    dm[5] = False
    rows = rng.integers(0, 24, (2, 7)).astype(np.int32)
    rows[:, 2] = 5
    ok = rng.random((2, 7)) > 0.2
    out = TK.maxsim_rerank(_t(q), _t(codes), _t(rows), _t(qm), _t(dm),
                           _t(ok), scales=_t(scales))
    ref = JK.maxsim_rerank(jnp.asarray(q), codes, jnp.asarray(rows),
                           jnp.asarray(qm, jnp.float32),
                           jnp.asarray(dm, jnp.float32), scales,
                           jnp.asarray(ok), impl=impl, block_d=16)
    _close(out, ref)
    live = ok[:, 2]
    np.testing.assert_allclose(out[live, 2].numpy(),
                               qm[live].sum(1) * NEG, rtol=1e-6)


def test_int8_wrappers_need_scales():
    _, q, _, codes, scales, _, _ = _int8_inputs(2)
    rows = torch.zeros((2, 3), dtype=torch.int32)
    for fn in (lambda: TK.maxsim_scores(_t(q), _t(codes),
                                        scales=_t(scales)[:3]),
               lambda: TK.maxsim_rerank(_t(q), _t(codes), rows)):
        with pytest.raises((ValueError, RuntimeError)):
            fn()


# ---------------------------------------------------------------------------
# quantised stores: schema, accessors, ingest, search
# ---------------------------------------------------------------------------

def _port(stages):
    return tuple(TM.Stage(s.vector, s.k, use_kernel=s.use_kernel,
                          chunk=s.chunk, scan_topk=s.scan_topk,
                          rerank_kernel=s.rerank_kernel)
                 for s in stages)


@pytest.fixture(scope="module")
def corpus():
    jc = dataclasses.replace(jax_config("colpali"), **SHRINK)
    bench = make_benchmark(jc, (14, 12, 10), (4, 4, 4), n_topics_per_ds=5,
                           seed=5)
    js = JS.build_store(jc, jnp.asarray(bench.pages),
                        jnp.asarray(bench.token_types))
    extra = JS.build_store(jc, jnp.asarray(bench.pages[:9] + 0.05),
                           jnp.asarray(bench.token_types))
    return dict(cfg=jc, bench=bench, jax=js, extra=extra)


def _carry(jstore):
    return TS.from_numpy({k: np.asarray(v) for k, v in jstore.vectors.items()},
                         n_docs=jstore.n_docs, device="cpu")


QUANT_CASES = {
    "initial-kept": (("initial",), None),
    "initial-1stage": (("initial",), lambda: JM.one_stage(10)),
    "pooled-2stage": (("mean_pooling",), lambda: JM.two_stage(16, 10)),
    "both-2stage": (("mean_pooling", "initial"), lambda: JM.two_stage(16, 10)),
    "global": (("global_pooling",), lambda: JM.three_stage(32, 16, 10)),
}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantize_store_schema_and_accessors(corpus, case):
    names, mk = QUANT_CASES[case]
    stages = None if mk is None else mk()
    jq = JS.quantize_store(corpus["jax"], names=names, stages=stages)
    tq = TS.quantize_store(_carry(corpus["jax"]), names=names,
                           stages=None if stages is None else _port(stages))
    assert set(jq.vectors) == set(tq.vectors)
    for k in jq.vectors:
        a, b = np.asarray(jq.vectors[k]), tq.vectors[k]
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), k
        if k.endswith(("_int8", "_scale", "_mask")) or k == "initial":
            np.testing.assert_array_equal(a.astype(np.float32), _np(b),
                                          err_msg=k)
    jsch, tsch = JS.VectorSchema.infer(jq.vectors), tq.schema()
    assert jsch.names == tsch.names
    for jn, tn in zip(jsch, tsch):
        assert (jn.role, jn.vec_dim, jn.n_vecs, jn.quantized, jn.has_float,
                jn.has_mask, jn.key) == (tn.role, tn.vec_dim, tn.n_vecs,
                                         tn.quantized, tn.has_float,
                                         tn.has_mask, tn.key)
        assert jsch.keys_for(jn.name) == tsch.keys_for(tn.name)
        assert tn.name in tsch
    assert jq.dims() == tq.dims() and jq.vec_dims() == tq.vec_dims()
    jb, tb = JS.base_vectors(jq.vectors), TS.base_vectors(tq.vectors)
    assert {k: v.shape for k, v in jb.items()} == \
        {k: tuple(v.shape) for k, v in tb.items()}
    for name in tsch.names:
        for jfn, tfn in ((JS.scan_arrays, TS.scan_arrays),
                         (JS.rerank_arrays, TS.rerank_arrays)):
            for a, b in zip(jfn(jq.vectors, name), tfn(tq.vectors, name)):
                assert (a is None) == (b is None), (name, jfn.__name__)
                if a is not None:
                    np.testing.assert_allclose(np.asarray(a, np.float32),
                                               _np(b), rtol=2 ** -7,
                                               atol=1e-6)


def test_from_numpy_carries_codes_and_scales_bitwise(corpus):
    jq = JS.quantize_store(corpus["jax"], names=("initial", "mean_pooling"))
    tq = _carry(jq)
    for k in ("initial_int8", "initial_scale", "mean_pooling_int8",
              "mean_pooling_scale"):
        a = np.asarray(jq.vectors[k])
        assert tq.vectors[k].dtype == {"int8": torch.int8,
                                       "float32": torch.float32}[a.dtype.name]
        assert a.tobytes() == tq.vectors[k].numpy().tobytes(), k


def _ids_close(jres, tres, tie=1e-5):
    """Equal ids except where repro's scores tie within ``tie`` at a
    neighbouring rank; scores allclose."""
    (js, ji), (ts, ti) = jres, tres
    js, ji, ts, ti = (np.asarray(js), np.asarray(ji), np.asarray(ts),
                      np.asarray(ti))
    np.testing.assert_allclose(js, ts, **TOL)
    for r, c in zip(*np.nonzero(ji != ti)):
        near = [abs(js[r, c] - js[r, cc]) <= tie * max(1.0, abs(js[r, c]))
                for cc in (c - 1, c + 1) if 0 <= cc < js.shape[1]]
        assert any(near), (r, c, ji[r], ti[r])


SEARCH_CASES = [
    # (quantised names, stages, use_kernel, chunk, scan_topk, drop floats)
    (("initial",), lambda: JM.one_stage(10), False, 0, False, True),
    (("initial",), lambda: JM.one_stage(10), True, 8, False, True),
    (("initial",), lambda: JM.one_stage(10), True, 8, True, False),
    (("initial",), lambda: JM.one_stage(10), False, 0, True, True),
    (("mean_pooling",), lambda: JM.two_stage(16, 10), True, 8, False, True),
    (("mean_pooling",), lambda: JM.two_stage(16, 10), True, 7, True, True),
    (("mean_pooling",), lambda: JM.two_stage(16, 10), False, 0, False,
     False),
    (("initial",), lambda: JM.two_stage(16, 10), True, 8, False, "cross"),
]


@pytest.mark.parametrize("i", range(len(SEARCH_CASES)))
def test_int8_search_matches_repro(corpus, i):
    """A JAX store quantised with and without ``stages``, carried across
    by ``from_numpy``, searched by both Retrievers with the same policy.
    "cross" quantises ``initial`` for a 1-stage cascade (float copy
    dropped) and serves it with a 2-stage one: its rerank is int8."""
    names, mk, kern, chunk, topk, drop = SEARCH_CASES[i]
    stages = mk()
    qstages = JM.one_stage(10) if drop == "cross" else stages
    jq = JS.quantize_store(corpus["jax"], names=names,
                           stages=qstages if drop else None)
    st = JM.with_scan_policy(stages, use_kernel=kern, chunk=chunk,
                             scan_topk=topk)
    st = JM.with_rerank_policy(st, rerank_kernel=kern)
    q, qm = corpus["bench"].queries, corpus["bench"].query_mask
    jres = JaxRetriever(jq, capacity=64).search(
        jnp.asarray(q), jnp.asarray(qm), stages=st, translate_ids=False)
    tres = Retriever(_carry(jq), capacity=64, device="cpu").search(
        q, qm, stages=_port(st), translate_ids=False)
    _ids_close(jres, tres)


def test_upsert_quantised_batches_matches_repro(corpus):
    """Quantised batches upserted into a quantised store (the second one
    overflows into a new segment), with deletes, searched with the int8
    chunked scan and int8 rerank."""
    stages = JM.one_stage(10)
    jq = JS.quantize_store(corpus["jax"], ("initial",), stages)
    jr = JaxRetriever(jq, capacity=64)
    tr = Retriever(_carry(jq), capacity=64, device="cpu")
    for sl in (slice(0, 4), slice(0, 9)):
        part = JS.VectorStore({k: v[sl] for k, v in
                               corpus["extra"].vectors.items()},
                              sl.stop, "bfloat16")
        jb = JS.quantize_store(part, ("initial",), stages)
        np.testing.assert_array_equal(jr.upsert(jb), tr.upsert(_carry(jb)))
    assert jr.store.capacities == tr.store.capacities
    assert tr.store.schema() == TS.VectorSchema.infer(
        tr.store.segments[-1].vectors)
    assert jr.delete([1, 40, 45]) == tr.delete([1, 40, 45])
    q, qm = corpus["bench"].queries, corpus["bench"].query_mask
    for st in (JM.one_stage(10), JM.two_stage(16, 10)):
        st = JM.with_rerank_policy(
            JM.with_scan_policy(st, use_kernel=True, chunk=8),
            rerank_kernel=True)
        _ids_close(jr.search(jnp.asarray(q), jnp.asarray(qm), stages=st),
                   tr.search(q, qm, stages=_port(st)))


def test_ingest_pipeline_quantize_matches_repro(corpus):
    """``IngestPipeline(quantize=, stages=)``: the same key set as repro's;
    ``initial`` codes and scales bit for bit (its bf16 rows are equal in
    both packages), ``mean_pooling`` codes within one step (its bf16 rows
    may differ by one rounding)."""
    jc, bench = corpus["cfg"], corpus["bench"]
    tc = dataclasses.replace(get_config("colpali"), **SHRINK)
    stages = JM.two_stage(16, 10)
    jp = JI.IngestPipeline(jc, quantize=("initial", "mean_pooling"),
                           stages=stages, use_kernel=False)
    tp = TI.IngestPipeline(tc, quantize=("initial", "mean_pooling"),
                           stages=_port(stages), use_kernel=False,
                           device="cpu")
    jv = jp.index(jnp.asarray(bench.pages[:11]),
                  jnp.asarray(bench.token_types)).vectors
    tv = tp.index(bench.pages[:11], bench.token_types).vectors
    assert set(jv) == set(tv)
    assert "mean_pooling" not in tv and "initial" in tv
    n = tv["initial"].shape[0]
    for k in ("initial_int8", "initial_scale"):
        np.testing.assert_array_equal(np.asarray(jv[k])[:n], tv[k].numpy())
    dc = (np.asarray(jv["mean_pooling_int8"])[:n].astype(np.int32)
          - tv["mean_pooling_int8"].numpy().astype(np.int32))
    assert np.abs(dc).max() <= 1
    np.testing.assert_allclose(np.asarray(jv["mean_pooling_scale"])[:n],
                               tv["mean_pooling_scale"].numpy(),
                               rtol=2 ** -7)
    with pytest.raises(ValueError, match="not among produced"):
        TI.IngestPipeline(tc, quantize=("nope",), device="cpu")


@pytest.mark.parametrize("stages,flags", [
    (2, ["--use-kernel", "--chunk", "8", "--scan-topk", "--rerank-kernel"]),
    (1, ["--use-kernel", "--chunk", "16"]),
    (3, []),
])
def test_serve_int8_cli(capsys, stages, flags):
    res = TSERVE.main(["--pages", "60", "--queries", "12", "--stages",
                       str(stages), "--int8", "--device", "cpu", *flags])
    out = capsys.readouterr().out
    assert np.isfinite(res["qps"]) and res["qps"] > 0
    assert 0.5 < res["ndcg@10"] <= 1.0
    if stages == 3:
        assert "single-vector; skipping quantisation" in out
        assert "/int8" not in out
    else:
        assert "/int8" in out
        assert ("/scan-topk" in out) == ("--scan-topk" in flags)
