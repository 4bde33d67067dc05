"""IVF centroid routing: the port's ``retrieval.routing``, the routed
stage 0 of the engine and ``centroid_scores`` against ``repro``'s,
mirroring ``tests/test_routing.py`` on well-separated clusters.

- clustering: centroids within rtol=1e-5, atol=1e-5 (f32 sums in another
  order); assignments, member lists, fills and drift exactly;
- maintenance: the same upserts and deletes (``on_commit``, a fresh
  segment's zero-state walk, ``on_delete``, drift re-clustering) leave
  the same members, fills and drift as ``repro``;
- search: full probe (``n_probe == K``) gives the exhaustive cascade's ids
  exactly, and a partial probe gives ``repro``'s routed ids exactly;
  scores within rtol=1e-5, atol=1e-5;
- a routed stage on a store without routing companions raises.

The data sit around centres at distinct distances from each other, so
the greedy k-means++ init picks the same rows in the same order in both
packages and no two scores tie. (The JAX property test that draws
repeated pages — exact ties, ordered differently by the routed and the
exhaustive paths — is a fault of the reference and is not mirrored.)
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import multistage as JM
from repro.kernels.maxsim import ops as JOPS
from repro.retrieval import routing as JRT
from repro.retrieval import store as JS
from repro.retrieval.retriever import Retriever as JRetriever
from repro_torch.core import multistage as TM
from repro_torch.kernels.maxsim import ops as TOPS
from repro_torch.retrieval import routing as RT
from repro_torch.retrieval import store as TS
from repro_torch.retrieval.retriever import Retriever
from repro_torch.retrieval.segments import SegmentedStore

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
K, D, DI, DIM = 4, 3, 5, 8
TOPK = 6
CENTERS = np.stack([s * np.eye(DIM, dtype=np.float32)[g]
                    for g, s in enumerate((4.0, 8.0, 12.0, 16.0))])


def _arrays(n: int, seed: int, first: int = 0) -> dict:
    """Pages ``first .. first+n-1`` of the mixture: page i sits at centre
    i % K plus noise, in every named vector."""
    r = np.random.default_rng(seed)
    g = (first + np.arange(n)) % K
    c = CENTERS[g]
    return {
        "mean_pooling": (c[:, None, :] + 0.1 * r.normal(size=(n, D, DIM))
                         ).astype(np.float32),
        "initial": (c[:, None, :] + 0.1 * r.normal(size=(n, DI, DIM))
                    ).astype(np.float32),
        "global_pooling": (c + 0.1 * r.normal(size=(n, DIM))
                           ).astype(np.float32),
    }


def _tb(a):
    return TS.VectorStore({k: torch.from_numpy(v.copy()) for k, v in
                           a.items()}, len(a["initial"]), "float32")


def _jb(a):
    return JS.VectorStore({k: jnp.asarray(v) for k, v in a.items()},
                          len(a["initial"]), "float32")


def _queries(seed=9, centres=(0, 2), q=4):
    r = np.random.default_rng(seed)
    x = CENTERS[list(centres)][:, None, :] + 0.3 * r.normal(
        size=(len(centres), q, DIM))
    return x.astype(np.float32)


def _pair(n=40, cap=64, policy=K, seed=0):
    a = _arrays(n, seed)
    jpol = policy if isinstance(policy, int) else JRT.RoutingPolicy(
        policy.n_clusters, policy.cluster_capacity, policy.iters,
        policy.drift_threshold)
    return (Retriever(_tb(a), capacity=cap, device="cpu", routing=policy),
            JRetriever(_jb(a), capacity=cap, routing=jpol))


def _same_routing(tr, jr):
    assert len(tr.store.segments) == len(jr.store.segments)
    for ts, js in zip(tr.store.segments, jr.store.segments):
        np.testing.assert_allclose(ts.vectors["ivf_centroids"].numpy(),
                                   np.asarray(js.vectors["ivf_centroids"]),
                                   **TOL)
        np.testing.assert_array_equal(ts.vectors["ivf_members"].numpy(),
                                      np.asarray(js.vectors["ivf_members"]))
        np.testing.assert_array_equal(ts.routing.fills, js.routing.fills)
        assert ts.routing.drift == js.routing.drift


def _routed(MS, stages, n_probe, n_clusters=K):
    return MS.with_routing_policy(stages, n_probe=n_probe,
                                  n_clusters=n_clusters)


# ----------------------------------------------------------------------
# policy units
# ----------------------------------------------------------------------

@pytest.mark.parametrize("k,cap,cc", [(4, 64, 0), (4, 64, 32), (7, 100, 0),
                                      (64, 4096, 0), (200, 64, 0)])
def test_member_width_and_clusters_match_repro(k, cap, cc):
    tp, jp = RT.RoutingPolicy(k, cc), JRT.RoutingPolicy(k, cc)
    kk = RT.segment_clusters(tp, cap)
    assert kk == JRT.segment_clusters(jp, cap)
    c = RT.member_width(tp, cap, kk)
    assert c == JRT.member_width(jp, cap, kk)
    assert kk * c >= cap
    if not cc:
        assert c & (c - 1) == 0 and kk * c >= 4 * cap


def test_too_narrow_member_lists_raise():
    with pytest.raises(ValueError):
        RT.member_width(RT.RoutingPolicy(4, cluster_capacity=8), 64, 4)


def test_routing_source_matches_repro():
    a = _arrays(10, 4)
    masked = dict(a, mean_pooling_mask=np.random.default_rng(1).random(
        (10, D)) > 0.3)
    for arrs in (a, {k: v for k, v in masked.items()
                     if k != "global_pooling"}):
        tv = {k: torch.from_numpy(v.copy()) for k, v in arrs.items()}
        jv = {k: jnp.asarray(v) for k, v in arrs.items()}
        np.testing.assert_allclose(RT.routing_source(tv).numpy(),
                                   np.asarray(JRT.routing_source(jv)), **TOL)
        assert RT.routing_dim(tv) == JRT.routing_dim(jv)


# ----------------------------------------------------------------------
# clustering and maintenance
# ----------------------------------------------------------------------

def test_clustering_matches_repro():
    tr, jr = _pair()
    _same_routing(tr, jr)
    # every live slot in exactly one member list, grouped by its centre
    m = tr.store.segments[0].vectors["ivf_members"].numpy()
    assert sorted(int(s) for s in m.ravel() if s >= 0) == list(range(40))
    for row in m:
        slots = row[row >= 0]
        assert len(set(slots % K)) == 1
    cents = tr.store.segments[0].vectors["ivf_centroids"].numpy()
    for c in cents:
        assert np.abs(CENTERS - c).sum(1).min() < 0.5


def test_kmeans_and_assignment_match_repro():
    x = np.concatenate([_arrays(32, 5)["global_pooling"],
                        np.zeros((8, DIM), np.float32)])
    w = np.r_[np.ones(30), np.zeros(2), np.ones(4), np.zeros(4)].astype(
        np.float32)
    for iters in (0, 1, 8):
        tc = RT._kmeans(torch.from_numpy(x), torch.from_numpy(w), K, iters)
        jc = JRT._kmeans(jnp.asarray(x), jnp.asarray(w), K, iters)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
        np.testing.assert_array_equal(
            RT._nearest(torch.from_numpy(x), tc, chunk=7).numpy(),
            np.asarray(JRT._nearest(jnp.asarray(x), jc, chunk=7)))
        np.testing.assert_array_equal(
            RT._rank(torch.from_numpy(x), tc).numpy(),
            np.asarray(JRT._rank_jit(jnp.asarray(x), jc)))


def test_pack_members_matches_repro():
    r = np.random.default_rng(2)
    assign = r.integers(0, 4, 50)
    assign[:20] = 1                              # overflows a width of 16
    live = r.random(50) > 0.2
    tm, tf = RT._pack_members(assign, live, 4, 16)
    jm, jf = JRT._pack_members(assign, live, 4, 16)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tf, jf)


def test_commit_delete_and_drift_match_repro():
    """Upserts assign to the nearest cluster with room, deletes tick the
    drift, and past the threshold both packages re-cluster alike."""
    tr, jr = _pair(n=20, cap=128)
    step = 20
    for n, seed, dels in ((10, 1, [3]), (30, 2, [0, 25]), (5, 3, []),
                          (40, 4, [41, 42, 43]), (8, 5, list(range(60, 75)))):
        a = _arrays(n, seed, first=step)
        step += n
        np.testing.assert_array_equal(tr.upsert(_tb(a)), jr.upsert(_jb(a)))
        _same_routing(tr, jr)
        assert tr.delete(dels) == jr.delete(dels)
        _same_routing(tr, jr)
    # a drift re-cluster happened along the way (drift resets)
    assert tr.store.segments[0].routing.drift < step - 20


def test_fresh_segment_zero_state_walk_matches_repro():
    """A batch that overflows allocates a fresh segment with zero
    centroids: its rows spread by the ranked with-room walk, as in
    repro, until drift schedules the first clustering."""
    tr, jr = _pair(n=60, cap=64, policy=RT.RoutingPolicy(K, iters=4))
    for n, seed, first in ((30, 7, 60), (70, 8, 90)):
        a = _arrays(n, seed, first)
        np.testing.assert_array_equal(tr.upsert(_tb(a)), jr.upsert(_jb(a)))
        _same_routing(tr, jr)
    assert tr.store.capacities == jr.store.capacities
    assert len(tr.store.segments) == 3


# ----------------------------------------------------------------------
# routed search
# ----------------------------------------------------------------------

CASCADES = {"1-stage": lambda MS: (MS.Stage("mean_pooling", TOPK),),
            "2-stage": lambda MS: MS.two_stage(8, TOPK),
            "2-stage kernels": lambda MS: MS.with_rerank_policy(
                MS.with_scan_policy(MS.two_stage(8, TOPK), use_kernel=True),
                rerank_kernel=True)}


def _search(r, q, stages, **kw):
    s, i = r.search(torch.from_numpy(q) if isinstance(r, Retriever)
                    else jnp.asarray(q), None, stages=stages, **kw)
    return np.asarray(s, np.float32), np.asarray(i)


@pytest.mark.parametrize("cascade", list(CASCADES))
def test_full_probe_equals_exhaustive(cascade):
    tr, _ = _pair()
    q = _queries(centres=(0, 1, 3))
    ex = CASCADES[cascade](TM)
    s0, i0 = _search(tr, q, ex)
    s1, i1 = _search(tr, q, _routed(TM, ex, K))
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(s1, s0, **TOL)


@pytest.mark.parametrize("cascade", list(CASCADES))
@pytest.mark.parametrize("n_probe", [1, 2, K])
def test_routed_search_matches_repro(cascade, n_probe):
    tr, jr = _pair()
    q = _queries(centres=(0, 2, 3))
    ts, ti = _search(tr, q, _routed(TM, CASCADES[cascade](TM), n_probe))
    js, ji = _search(jr, q, _routed(JM, CASCADES[cascade](JM), n_probe))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, **TOL)


def test_one_probe_on_separated_clusters_matches_exhaustive():
    """n_probe=1 reads ONE cluster yet gives the exhaustive top-k: the
    clustering recovered the mixture."""
    tr, _ = _pair()
    q = _queries(centres=(1, 2))
    ex = (TM.Stage("mean_pooling", TOPK),)
    s0, i0 = _search(tr, q, ex)
    s1, i1 = _search(tr, q, _routed(TM, ex, 1))
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(s1, s0, **TOL)


@pytest.mark.parametrize("ops", [
    [("upsert", 3), ("delete", 1)],
    [("upsert", 5), ("upsert", 2), ("delete", 0)],
    [("delete", 2), ("upsert", 1), ("delete", 0), ("upsert", 6)]])
def test_full_probe_parity_under_mutation(ops):
    a = _arrays(12, 21)
    r = Retriever(_tb(a), capacity=64, device="cpu", routing=K)
    q = _queries(seed=3, centres=(0, 3))
    alive = list(range(12))
    first = 12
    ex = (TM.Stage("mean_pooling", TOPK),)
    for kind, arg in ops:
        if kind == "upsert":
            alive += list(r.upsert(_tb(_arrays(1 + arg % 4, arg, first))))
            first += 1 + arg % 4
        else:
            r.delete([int(alive.pop(arg % len(alive)))])
        s0, i0 = _search(r, q, ex)
        s1, i1 = _search(r, q, _routed(TM, ex, K))
        np.testing.assert_array_equal(i1, i0)
        np.testing.assert_allclose(s1, s0, **TOL)


def test_filtered_routed_composition():
    tr, jr = _pair(n=24)
    for rr in (tr, jr):
        a = _arrays(10, 1, first=24)
        b = _arrays(8, 2, first=34)
        ids_a = rr.upsert(_tb(a) if rr is tr else _jb(a), tenant=1,
                          tags=(2,))
        ids_b = rr.upsert(_tb(b) if rr is tr else _jb(b), tenant=2)
        rr.delete(ids_a[:3])
    q = _queries()
    ex = (TM.Stage("mean_pooling", TOPK),)
    for spec in (TS.FilterSpec(tenant=1), TS.FilterSpec(tenant=2),
                 TS.FilterSpec(tenant=1, any_tags=(2,)), None):
        s0, i0 = _search(tr, q, ex, filter=spec)
        s1, i1 = _search(tr, q, _routed(TM, ex, K), filter=spec)
        np.testing.assert_array_equal(i1, i0)
        np.testing.assert_allclose(s1, s0, **TOL)
        jspec = None if spec is None else JS.FilterSpec(
            spec.tenant, spec.require_tags, spec.any_tags)
        _, ji = _search(jr, q, _routed(JM, (JM.Stage("mean_pooling", TOPK),),
                                       2), filter=jspec)
        _, ti = _search(tr, q, _routed(TM, ex, 2), filter=spec)
        np.testing.assert_array_equal(ti, ji)
        if spec is not None and spec.tenant == 2:
            hits = set(i1.ravel()) - {-1}
            assert hits and hits <= set(int(i) for i in ids_b)


def test_routed_stage_without_routing_companions_raises():
    r = Retriever(_tb(_arrays(16, 0)), device="cpu")
    with pytest.raises(ValueError, match="no routing companions"):
        r.search(torch.from_numpy(_queries()), None,
                 stages=_routed(TM, (TM.Stage("mean_pooling", TOPK),), K))


def test_jax_store_carried_across_routes_the_same():
    """``SegmentedStore.from_numpy`` brings the centroids, members,
    fills and drift across; routed searches and further writes agree."""
    _, jr = _pair(n=30, cap=64)
    jr.upsert(_jb(_arrays(7, 3, first=30)), tenant=1)
    jr.delete([2, 31])
    ts = SegmentedStore.from_numpy(jr.store, device="cpu")
    tr = Retriever(ts, device="cpu")
    assert ts.router == RT.RoutingPolicy(K)
    _same_routing(tr, jr)
    q = _queries(centres=(1, 3))
    for n_probe in (1, 2):
        ts_, ti = _search(tr, q, _routed(TM, CASCADES["2-stage"](TM),
                                         n_probe))
        js_, ji = _search(jr, q, _routed(JM, CASCADES["2-stage"](JM),
                                         n_probe))
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts_, js_, **TOL)
    a = _arrays(9, 4, first=37)
    np.testing.assert_array_equal(tr.upsert(_tb(a)), jr.upsert(_jb(a)))
    _same_routing(tr, jr)


# ----------------------------------------------------------------------
# centroid_scores
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dc", [DIM, 4])
@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_centroid_scores_matches_repro(dc, impl):
    r = np.random.default_rng(6)
    q = r.normal(size=(3, 5, DIM)).astype(np.float32)
    qm = r.random((3, 5)) > 0.3
    c = r.normal(size=(9, dc)).astype(np.float32)
    want = JOPS.centroid_scores(jnp.asarray(q), jnp.asarray(c),
                                jnp.asarray(qm), impl=impl)
    got = TOPS.centroid_scores(torch.from_numpy(q), torch.from_numpy(c),
                               torch.from_numpy(qm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        TOPS.centroid_scores(torch.from_numpy(q), torch.from_numpy(c))
        .numpy(),
        np.asarray(JOPS.centroid_scores(jnp.asarray(q), jnp.asarray(c),
                                        impl=impl)), **TOL)


def test_serve_full_probe_equals_unrouted():
    from repro_torch.launch import serve
    base = ["--pages", "60", "--queries", "12", "--stages", "2",
            "--prefetch-k", "16", "--top-k", "10", "--device", "cpu"]
    plain = serve.main(base)
    full = serve.main(base + ["--n-clusters", "4", "--n-probe", "4"])
    part = serve.main(base + ["--n-clusters", "4", "--n-probe", "1",
                              "--use-kernel", "--rerank-kernel"])
    for k in ("ndcg@5", "recall@5", "ndcg@10", "recall@10"):
        assert full[k] == plain[k]
        assert 0.0 <= part[k] <= 1.0
