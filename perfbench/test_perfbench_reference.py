"""The plain reference against the port's index path and scoring on the
CPU, and the comparison on hand-made served lists."""
import math

import pytest
import torch

from perfbench import corpus as C
from perfbench import reference as R
from perfbench.test_perfbench_generators import _spec

torch.set_num_threads(1)


def _port_index(spec, raw, h_eff, use_kernel, quantize=()):
    from repro_torch.configs.base import RetrieverConfig
    from repro_torch.retrieval.ingest import IngestPipeline
    g = spec.geo
    if g.kind == "tiles":
        cfg = RetrieverConfig("colsmol", "tiles", 768, 12, 12, 3072,
                              tile_patches=g.row_w, n_tiles=g.rows,
                              n_special=g.n_special, pool="tiles")
    else:
        cfg = RetrieverConfig("colqwen", "dynamic", 1024, 16, 16, 4096,
                              grid_h=g.rows, grid_w=g.row_w,
                              max_rows=g.max_rows, n_special=g.n_special,
                              pool="adaptive", smooth="gaussian")
    pipe = IngestPipeline(cfg, device="cpu", use_kernel=use_kernel,
                          quantize=quantize)
    return pipe.index(raw, C.token_types(g), h_eff=h_eff).vectors


@pytest.mark.parametrize("kind,use_kernel", [("tiles", True),
                                             ("tiles", False),
                                             ("dynamic", True)])
def test_reference_index_path_matches_the_port(kind, use_kernel):
    spec = _spec(kind, pages=32)
    tab = C.tables(spec, 11)
    ids = torch.arange(32)
    raw = C.pages(spec, 11, tab, ids)
    h = tab.h_eff if kind == "dynamic" else None
    port = _port_index(spec, raw, h, use_kernel)
    sv = R.stage_vectors("initial", raw, spec.geo, tab.h_eff, False)
    assert sv.lo is None and torch.equal(sv.v, port["initial"].float())
    assert torch.equal(sv.mask, port["initial_mask"].bool())
    sv = R.stage_vectors("mean_pooling", raw, spec.geo, tab.h_eff, False)
    pv = port["mean_pooling"].float()
    assert torch.equal(sv.mask, port["mean_pooling_mask"].bool())
    # the port's bf16 values lie within the reference's bounds
    assert torch.all((sv.lo <= pv) & (pv <= sv.hi))
    assert torch.all((sv.lo <= sv.v) & (sv.v <= sv.hi))
    assert (sv.v == pv).float().mean() > 0.98
    sv = R.stage_vectors("global_pooling", raw, spec.geo, tab.h_eff, False)
    gv = port["global_pooling"].float()
    assert torch.all((sv.lo <= gv) & (gv <= sv.hi))


def test_int8_bounds_hold_the_port_codes():
    from repro_torch.kernels.maxsim.ops import quantize_int8
    spec = _spec("tiles", pages=32)
    tab = C.tables(spec, 13)
    raw = C.pages(spec, 13, tab, torch.arange(32))
    port = _port_index(spec, raw, None, True, quantize=("mean_pooling",))
    from repro_torch.retrieval.store import codes_key, scale_key
    deq = port[codes_key("mean_pooling")].float() * \
        port[scale_key("mean_pooling")][..., None]
    sv = R.stage_vectors("mean_pooling", raw, spec.geo, tab.h_eff, True)
    assert torch.all((sv.lo <= deq) & (deq <= sv.hi))
    codes, scales = quantize_int8(port["mean_pooling"])
    assert torch.equal(codes.float() * scales[..., None], deq)


def test_score_bounds_hold_every_rounding():
    q = torch.randn(3, 8, 128)
    qm = torch.rand(3, 8) > 0.3
    v32 = torch.randn(20, 13, 128) * 0.1
    sv = R.StageVecs(R._bf16(v32), R._bf16(v32 - 1e-3),
                     R._bf16(v32 + 1e-3), None)
    lo, hi = R.score_bounds(q, qm, sv)
    for _ in range(4):
        pick = torch.where(torch.rand_like(v32) < 0.5, sv.lo, sv.hi)
        s = R.scores(q, qm, pick, None)
        assert torch.all((lo - 1e-4 <= s) & (s <= hi + 1e-4))


def test_reference_int8_codes_match_the_port():
    from repro_torch.kernels.maxsim.ops import quantize_int8
    x = torch.randn(64, 13, 128).to(torch.bfloat16)
    codes, scales = quantize_int8(x)
    assert torch.equal(R.int8_dequant(x),
                       codes.float() * scales[..., None])


def test_reference_scores_match_the_port():
    from repro_torch.kernels.maxsim.ref import maxsim_ref
    q = torch.randn(3, 8, 128)
    qm = torch.rand(3, 8) > 0.3
    docs = torch.randn(20, 13, 128)
    dm = torch.rand(20, 13) > 0.2
    dm[:, 0] = True
    got = R.scores(q * qm[..., None], qm, docs, dm)
    want = maxsim_ref(q * qm[..., None], qm.float(), docs, dm.float())
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-4)
    g = torch.randn(20, 128)
    one = R.scores(q, qm, g, None)
    want = (q * qm[..., None]).sum(1) @ g.T
    assert torch.allclose(one, want, rtol=1e-5, atol=1e-5)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -12, 1.0 + 2 ** -11,
                      1.0 + 3 * 2 ** -11, -3.14159])
    y = R.tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2 ** -10
    assert y[2] == 1.0                       # below half a step: down
    assert y[3] == 1.0                       # a tie: to even
    assert y[4] == 1.0 + 2 ** -9             # a tie: to even
    assert abs(y[5] - x[5]) <= 2 ** -10 * 4
    assert torch.equal(R.tf32(y), y)


def _tiny(kind="tiles", cascade=(("mean_pooling", 16), ("initial", 8))):
    spec = _spec(kind, pages=64, topics=4)
    tab = C.tables(spec, 21)
    q = C.queries(spec, 21, tab, 6, 32, (8, 32))
    stages = tuple(R.RefStage(v, k) for v, k in cascade)
    return spec, tab, q, stages


def _served_by_reference(spec, tab, q, stages):
    """The cascade's answer by brute force over the dense scores."""
    S = []
    for st in stages:
        s, _, _ = R._stage_scores(spec, 21, tab, st, None, q.q, q.mask,
                                  False, 64)
        S.append(s)
    cand = torch.ones_like(S[0], dtype=torch.bool)
    for st, s in zip(stages, S):
        v = torch.where(cand, s, -torch.inf)
        top = torch.topk(v, st.k, dim=1)
        cand = torch.zeros_like(cand).scatter_(1, top.indices, True)
    return R.Served(top.indices, top.values)


@pytest.mark.parametrize("kind,cascade", [
    ("tiles", (("mean_pooling", 16), ("initial", 8))),
    ("dynamic", (("global_pooling", 32), ("mean_pooling", 16),
                 ("initial", 8)))])
def test_an_honest_answer_reads_rounding_and_a_broken_one_does_not(
        kind, cascade):
    spec, tab, q, stages = _tiny(kind, cascade)
    good = _served_by_reference(spec, tab, q, stages)
    # a score altered where it is produced
    altered = R.Served(good.ids.clone(), good.scores.clone())
    altered.scores[2, 3] += 1e-3
    # the best page left out: the rest move up, its place is lost
    shifted = R.Served(torch.cat([good.ids[:, 1:], good.ids[:, :1]], 1),
                       torch.cat([good.scores[:, 1:], good.scores[:, :1]],
                                 1))
    # a page the scan could not have kept
    s0, _, _ = R._stage_scores(spec, 21, tab, stages[0], None, q.q,
                               q.mask, False, 64)
    far = R.Served(good.ids.clone(), good.scores.clone())
    far.ids[:, -1:] = torch.topk(-s0, 1).indices
    # invalid ids
    dup = R.Served(good.ids.clone(), good.scores.clone())
    dup.ids[0, 1] = dup.ids[0, 0]
    neg = R.Served(good.ids.clone(), good.scores.clone())
    neg.ids[1, 4] = -1
    out = R.Served(good.ids.clone(), good.scores.clone())
    out.ids[2, 0] = spec.pages
    r = R.cascade(spec, 21, tab, stages, q.q, q.mask,
                  [good, altered, shifted, far, dup, neg, out],
                  control=True)["readings"]
    honest, ctrl = r[0], r[-1]
    assert honest["score_gap"] <= 1e-5 and honest["select_gap"] <= 1e-5
    # the control (TF32 operands) misses the scores by far more
    assert ctrl["score_gap"] > 10 * max(honest["score_gap"], 1e-6)
    assert r[1]["score_gap"] >= 9e-4
    assert r[2]["select_gap"] > 1e-3
    assert r[3]["score_gap"] > 1e-3 or r[3]["select_gap"] > 1e-3
    for rd in r[4:7]:
        assert all(math.isinf(rd[n]) for n in R.NUMBERS)
