"""Three faults of the port against ``repro``, each repaired and held here.

1. ``Stage.dtype``: the scan stage's compute-type policy. Mirrors
   ``tests/test_dispatch.py::test_scan_dtype_policy`` against ``repro`` on
   the same numpy inputs: with ``dtype="bfloat16"`` the ids equal the f32
   oracle's and ``repro``'s, the scores lie within the reference's
   rtol=atol=2e-2 of the oracle; int8 codes stay int8.
2. Queries longer than 80 tokens at d = 128: each kernel's query limit
   (the scan library's token cap for the tensor route, which the wrapper
   asks for, and ``ops.warp_query_cap``) admits Q = 128, and the check
   reads shapes only (it runs here on meta tensors).
3. Routed tie order: on a store with duplicate pages (exact score ties),
   routed full probe gives the exhaustive ids exactly. ``repro``'s routed
   stage breaks ties by probed-row position, so its routed ids differ from
   the port's there, and only on exact ties between duplicate pages.
"""
import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core import multistage as JM
from repro.data.synthetic import make_benchmark
from repro.retrieval import store as JS
from repro.retrieval.retriever import Retriever as JaxRetriever
from repro.retrieval.store import build_store as jax_build
from repro_torch.core import multistage as TM
from repro_torch.kernels import build
from repro_torch.kernels import dispatch as DSP
from repro_torch.kernels.maxsim import ops as KOPS
from repro_torch.retrieval import engine
from repro_torch.retrieval import store as TS
from repro_torch.retrieval.retriever import Retriever
from repro_torch.retrieval.store import from_numpy, quantize_store

torch.set_num_threads(1)

BASE = TM.two_stage(24, 8)
JBASE = JM.two_stage(24, 8)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)      # the reference's bf16 tolerance


# ----------------------------------------------------------------------
# fault 1: Stage.dtype
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench():
    """``tests/test_dispatch.py``'s benchmark: ColPali, 48 pages, 16
    queries, seed 7."""
    cfg = jax_config("colpali")
    b = make_benchmark(cfg, (20, 16, 12), (6, 6, 4), seed=7)
    js = jax_build(cfg, jnp.asarray(b.pages), jnp.asarray(b.token_types))
    ts = from_numpy({k: np.asarray(v) for k, v in js.vectors.items()},
                    device="cpu")
    q, qm = b.queries, b.query_mask
    so, io = Retriever(ts, device="cpu").search(
        torch.from_numpy(q), torch.from_numpy(qm), stages=BASE)
    return dict(jax=js, port=ts, q=q, qm=qm, so=so.numpy(), io=io)


def test_stage_dtype_field_mirrors_repro():
    """The field sits where the reference has it, after ``chunk``, and
    ``with_scan_policy(dtype=)`` sets it on the scan stage only."""
    names = [f.name for f in dataclasses.fields(TM.Stage)]
    assert names == [f.name for f in dataclasses.fields(JM.Stage)]
    assert names.index("dtype") == names.index("chunk") + 1
    st = TM.with_scan_policy(BASE, dtype="bfloat16")
    assert st[0].dtype == "bfloat16" and st[1].dtype is None
    assert TM.with_scan_policy(st, chunk=4)[0].dtype == "bfloat16"


@pytest.mark.parametrize("use_kernel", [False, True])
def test_scan_dtype_policy_matches_repro(bench, use_kernel):
    """dtype="bfloat16" scans in bf16: the f32 oracle's ranking and
    ``repro``'s ids, scores within the bf16 tolerance of the oracle."""
    st = TM.with_scan_policy(BASE, dtype="bfloat16", use_kernel=use_kernel)
    s, i = Retriever(bench["port"], device="cpu").search(
        torch.from_numpy(bench["q"]), torch.from_numpy(bench["qm"]),
        stages=st)
    js, ji = JaxRetriever(bench["jax"]).search(
        jnp.asarray(bench["q"]), jnp.asarray(bench["qm"]),
        stages=JM.with_scan_policy(JBASE, dtype="bfloat16"))
    np.testing.assert_array_equal(i, bench["io"])
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s.float().numpy(), bench["so"], **BF16_TOL)
    np.testing.assert_allclose(s.float().numpy(),
                               np.asarray(js, np.float32), **BF16_TOL)


def test_scan_prep_casts_query_and_float_docs_only():
    stage = TM.Stage("initial", 4, dtype="bfloat16")
    q = torch.randn(2, 3, 16)
    docs = torch.randn(5, 7, 16)
    codes, scales = KOPS.quantize_int8(docs)
    v, qq = engine._scan_prep(stage, docs, q, None)
    assert v.dtype == qq.dtype == torch.bfloat16
    v, qq = engine._scan_prep(stage, codes, q, scales)
    assert v.dtype == torch.int8 and torch.equal(v, codes)
    assert qq.dtype == torch.bfloat16
    v, qq = engine._scan_prep(TM.Stage("initial", 4), docs, q, None)
    assert v is docs and qq is q
    v, qq = engine._scan_prep(stage, docs[..., :8], q, None)   # Matryoshka
    assert qq.shape[-1] == 8 and qq.dtype == torch.bfloat16


@pytest.mark.parametrize("scan_topk", [False, True])
def test_int8_scan_with_dtype_keeps_codes(bench, scan_topk):
    """An int8 scan stage under dtype="bfloat16" still scans the codes
    (the store holds no float copy of them) and ranks as ``repro``."""
    stages = TM.with_scan_policy(BASE, dtype="bfloat16",
                                 scan_topk=scan_topk, chunk=8)
    tq = quantize_store(bench["port"], ("mean_pooling",), BASE)
    assert "mean_pooling" not in tq.vectors
    jq = JS.quantize_store(bench["jax"], ("mean_pooling",), JBASE)
    s, i = Retriever(tq, device="cpu").search(
        torch.from_numpy(bench["q"]), torch.from_numpy(bench["qm"]),
        stages=stages)
    js, ji = JaxRetriever(jq).search(
        jnp.asarray(bench["q"]), jnp.asarray(bench["qm"]),
        stages=JM.with_scan_policy(JBASE, dtype="bfloat16",
                                   scan_topk=scan_topk, chunk=8))
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s.float().numpy(),
                               np.asarray(js, np.float32), **BF16_TOL)


# ----------------------------------------------------------------------
# fault 2: the kernels' query limits
# ----------------------------------------------------------------------

class _TensorRouteLibrary:
    """A stand-in scan library that answers the tensor route with the
    token cap the real one gives at d = 128 (320, printed per shape by
    ``chip_smoke.py``) and records its launches."""
    CAP = 320

    def __init__(self):
        self.launches = 0

    def maxsim_scan_route(self, docs_type, D, d):
        return 1

    def maxsim_scan_token_cap(self, docs_type, d):
        return self.CAP

    def maxsim_scan_launch(self, *args):
        self.launches += 1
        return 0


def test_query_limits_admit_128_tokens_at_d128(monkeypatch):
    """The warp kernels hold 448 query slots at d = 128; the scan wrapper
    checks Q against the token cap the library gives, so a 128-token
    query launches on the tensor route and one above the cap does not."""
    assert KOPS.warp_query_cap(128) == 448
    lib = _TensorRouteLibrary()
    monkeypatch.setattr(DSP, "on_cuda", lambda t: True)
    monkeypatch.setattr(build, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    docs = torch.zeros((3, 16, 128), dtype=torch.bfloat16)
    KOPS.maxsim_scores(torch.zeros((2, 128, 128)), docs)
    assert lib.launches == 1
    with pytest.raises(ValueError, match="exceed"):
        KOPS.maxsim_scores(torch.zeros((1, lib.CAP + 1, 128)), docs)
    assert lib.launches == 1


@pytest.mark.parametrize("Q", [96, 128])
@pytest.mark.parametrize("cap", ["scan_tensor", "scan_warp", "rerank"])
def test_query_check_reads_shapes_only(Q, cap):
    """The check runs on meta tensors (shapes, no data) and admits the
    96- and 128-token queries the old 48 KB limit refused (80 at most)."""
    q = torch.empty((2, Q, 128), device="meta")
    limit = {"scan_tensor": _TensorRouteLibrary.CAP,
             "scan_warp": KOPS.warp_query_cap(128),
             "rerank": KOPS.warp_query_cap(128)}[cap]
    KOPS._check_query_smem(q, cap, limit)
    with pytest.raises(ValueError, match="exceed"):
        KOPS._check_query_smem(torch.empty((2, limit + 1, 128),
                                           device="meta"), cap, limit)


# ----------------------------------------------------------------------
# fault 3: routed tie order
# ----------------------------------------------------------------------

D, DIM, TOPK, K = 3, 8, 6, 4


def _batch(n, seed):
    r = np.random.default_rng(seed)
    return {"mean_pooling": r.normal(size=(n, D, DIM)).astype(np.float32),
            "global_pooling": r.normal(size=(n, DIM)).astype(np.float32)}


def _stores(a):
    t = TS.VectorStore({k: torch.from_numpy(v.copy()) for k, v in a.items()},
                       len(a["mean_pooling"]), "float32")
    j = JS.VectorStore({k: jnp.asarray(v) for k, v in a.items()},
                       len(a["mean_pooling"]), "float32")
    return t, j


@pytest.mark.parametrize("qseed,extra,repro_differs",
                         [(2, 3, True), (0, 4, True), (1, 2, False)])
def test_routed_full_probe_gives_exhaustive_ids_on_duplicates(
        qseed, extra, repro_differs):
    """12 pages, then the first ``extra`` of them again (the same random
    stream, as in the JAX property test's falsifying example
    ``ops=[('upsert', 2)], qseed=2``): every duplicate ties its original
    exactly at every stage. ``repro_differs`` records whether ``repro``'s
    routed ids leave the exhaustive order on this data (they do in the
    first two cases, the reference's fault)."""
    tb, jb = _stores(_batch(12, qseed))
    tr = Retriever(tb, capacity=64, device="cpu", routing=K)
    jr = JaxRetriever(jb, capacity=64, routing=K)
    tu, ju = _stores(_batch(extra, qseed))
    np.testing.assert_array_equal(tr.upsert(tu), np.asarray(jr.upsert(ju)))
    q = np.random.default_rng(qseed).normal(size=(2, 4, DIM)).astype(
        np.float32)
    ex = (TM.Stage("mean_pooling", TOPK),)
    routed = TM.with_routing_policy(ex, n_probe=K, n_clusters=K)
    s0, i0 = tr.search(torch.from_numpy(q), stages=ex)
    s1, i1 = tr.search(torch.from_numpy(q), stages=routed)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(s1.numpy(), s0.numpy(), rtol=1e-5, atol=1e-5)
    # the exhaustive ids are repro's exhaustive ids; repro's routed ids
    # differ from them only where two duplicate pages tie exactly
    je = (JM.Stage("mean_pooling", TOPK),)
    _, ji0 = jr.search(jnp.asarray(q), stages=je)
    np.testing.assert_array_equal(i0, np.asarray(ji0))
    js1, ji1 = jr.search(jnp.asarray(q), stages=JM.with_routing_policy(
        je, n_probe=K, n_clusters=K))
    ji1 = np.asarray(ji1)
    vec = np.concatenate([_batch(12, qseed)["mean_pooling"],
                          _batch(extra, qseed)["mean_pooling"]])
    for b, j in zip(*np.nonzero(ji1 != i1)):
        assert np.array_equal(vec[ji1[b, j]], vec[i1[b, j]]), \
            "repro's routed ids differ from the port's off an exact tie"
    assert (ji1 != i1).any() == repro_differs
    # the data does hold exact ties among the results
    tied = [len({vec[i].tobytes() for i in row}) < len(row) for row in i1]
    assert any(tied)


def test_routed_rows_are_in_slot_order_padding_last():
    tb, _ = _stores(_batch(30, 5))
    r = Retriever(tb, capacity=64, device="cpu", routing=K)
    vec = r.store.segments[0].vectors
    q = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, 4, DIM)).astype(np.float32))
    st = TM.Stage("mean_pooling", TOPK, n_probe=3, n_clusters=K)
    rows = engine._routed_rows(vec, st, q, None)
    for row in rows:
        live = row[row >= 0]
        assert torch.equal(live, torch.sort(live)[0])
        assert (row[len(live):] == -1).all()
