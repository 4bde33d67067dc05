"""The generators on the CPU: the same seed gives the same corpus chunk,
queries and arrival schedule; a page made alone equals the same page made
in a chunk, bit for bit; every seed draws the same multiset of sizes."""
import numpy as np
import pytest
import torch

from perfbench import corpus as C
from perfbench import traffic as TR

torch.set_num_threads(1)

BIG = 2 ** 31 + 4_000_000_123          # more than 32 bits, as seeds are


def _spec(kind: str, pages: int = 64, topics: int = 8) -> C.CorpusSpec:
    if kind == "tiles":
        retr = {"geometry": "tiles", "n_tiles": 13, "tile_patches": 64,
                "n_special": 6, "out_dim": 128, "smooth": "none"}
        h = None
    else:
        retr = {"geometry": "dynamic", "grid_h": 28, "grid_w": 28,
                "max_rows": 32, "n_special": 8, "out_dim": 128,
                "smooth": "gaussian"}
        h = [20, 28]
    return C.CorpusSpec.of({
        "retriever": retr, "corpus_pages": pages,
        "generator": {"topics": topics, "noise": 0.55, "signal": 1.0,
                      "jitter": 0.15, "band_rows": 3, "query_noise": 0.35,
                      "h_eff": h}})


@pytest.mark.parametrize("kind", ["tiles", "dynamic"])
def test_same_seed_same_chunk(kind):
    spec = _spec(kind)
    ids = torch.arange(16, 32)
    a = C.pages(spec, BIG, C.tables(spec, BIG), ids)
    b = C.pages(spec, BIG, C.tables(spec, BIG), ids)
    assert torch.equal(a, b)
    c = C.pages(spec, BIG + 1, C.tables(spec, BIG + 1), ids)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("kind", ["tiles", "dynamic"])
def test_a_page_alone_equals_the_page_in_its_chunk(kind):
    spec = _spec(kind)
    tab = C.tables(spec, 7)
    chunk = C.pages(spec, 7, tab, torch.arange(0, 32))
    some = torch.tensor([31, 0, 17, 17])
    alone = C.pages(spec, 7, tab, some)
    assert torch.equal(alone, chunk[some])


def test_page_layout():
    spec = _spec("dynamic")
    tab = C.tables(spec, 3)
    raw = C.pages(spec, 3, tab, torch.arange(8))
    geo = spec.geo
    assert raw.shape == (8, geo.seq, geo.dim)
    norms = raw.norm(dim=-1)
    # specials and valid grid rows are unit tokens; rows past h_eff are 0
    for p in range(8):
        h = int(tab.h_eff[p])
        grid = norms[p, geo.n_special:].view(geo.rows, geo.row_w)
        assert torch.allclose(grid[:h], torch.ones_like(grid[:h]),
                              atol=1e-5)
        assert torch.all(grid[h:] == 0)
    assert torch.allclose(norms[:, :geo.n_special],
                          torch.ones(8, geo.n_special), atol=1e-5)


def test_topic_is_planted_in_a_band():
    spec = _spec("tiles")
    tab = C.tables(spec, 5)
    raw = C.pages(spec, 5, tab, torch.arange(4))
    geo = spec.geo
    for p in range(4):
        t = tab.topics[tab.topic_of[p]]
        sim = raw[p, geo.n_special:] @ t
        rows = sim.view(geo.rows, geo.row_w).mean(1)
        hot = (rows > 0.5).nonzero().flatten().tolist()
        assert len(hot) == spec.band_rows
        assert hot == list(range(hot[0], hot[0] + spec.band_rows))


def test_every_seed_draws_the_same_multisets():
    spec = _spec("dynamic", pages=256, topics=16)
    a, b = C.tables(spec, 1), C.tables(spec, BIG)
    assert torch.equal(torch.bincount(a.topic_of),
                       torch.full((16,), 16))
    assert torch.equal(torch.sort(a.h_eff).values,
                       torch.sort(b.h_eff).values)
    assert not torch.equal(a.h_eff, b.h_eff)
    qa = C.queries(spec, 1, a, 100, 32, (8, 32))
    qb = C.queries(spec, BIG, b, 100, 32, (8, 32))
    assert torch.equal(torch.sort(qa.lengths).values,
                       torch.sort(qb.lengths).values)
    assert int(qa.lengths.min()) == 8 and int(qa.lengths.max()) == 32


def test_queries_are_deterministic_and_masked():
    spec = _spec("tiles")
    tab = C.tables(spec, 9)
    q1 = C.queries(spec, 9, tab, 20, 32, (8, 32))
    q2 = C.queries(spec, 9, tab, 20, 32, (8, 32))
    assert torch.equal(q1.q, q2.q) and torch.equal(q1.mask, q2.mask)
    assert torch.all(q1.q[~q1.mask] == 0)
    n = q1.q[q1.mask].norm(dim=-1)
    assert torch.allclose(n, torch.ones_like(n), atol=1e-5)
    assert torch.equal(q1.topic, tab.topic_of[q1.anchor])


def test_arrival_schedule():
    a = TR.arrivals(BIG, 200.0, 10.0)
    b = TR.arrivals(BIG, 200.0, 10.0)
    c = TR.arrivals(12, 200.0, 10.0)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert len(a) == len(c) == 2000
    assert a[0] == 0.0 and np.all(np.diff(a) > 0)
    # the gaps are one fixed multiset in the seed's order: every seed's
    # span is their sum less its first gap
    u = (np.arange(2000) + 0.5) / 2000
    gaps = -np.log1p(-u) / 200.0
    for x in (a, c):
        assert gaps.sum() - gaps.max() <= x[-1] <= gaps.sum()
        d = np.diff(x)
        near = np.abs(d[:, None] - gaps[None, :]).min(1)
        assert near.max() < 1e-9
    assert 9.0 < a[-1] < 10.0


def test_sample_and_nearest_rank():
    s = TR.sample(BIG, 1000, 64)
    assert len(set(s.tolist())) == 64 and s.max() < 1000
    assert np.array_equal(s, TR.sample(BIG, 1000, 64))
    assert len(TR.sample(1, 10, 64)) == 10
    assert TR.nearest_rank([3, 1, 2, 4], 0.5) == 2
    assert TR.nearest_rank([1, 2, float("inf")], 0.95) == float("inf")


def test_hash_is_a_bijection_on_a_sample():
    x = torch.arange(1 << 16, dtype=torch.int64) * 65521
    h = C.mix32(x & C.M32)
    assert h.unique().numel() == x.numel()
    assert int(h.max()) <= C.M32 and int(h.min()) >= 0
    assert C.mix32(12345) == int(C.mix32(torch.tensor([12345]))[0])


def test_tree_norm_matches_the_norm():
    x = torch.randn(5, 7, 128)
    assert torch.allclose(C.tree_norm(x)[..., 0], x.norm(dim=-1),
                          rtol=1e-5)
