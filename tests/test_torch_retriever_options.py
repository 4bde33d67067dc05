"""The serving facade's options: ``Retriever(scan_chunk=)`` (a default
chunk for scan stages that set none; a stage's own chunk wins),
``Retriever(place=False)`` on a mesh (the store stays where it is and
each search splits it), ``Retriever.from_snapshot(place=)`` and
``tiering.restore_store(place=)``.

``scan_chunk`` against ``repro``'s ``Retriever(scan_chunk=)`` on the same
corpus, and its search-function cache identity as
``tests/test_dispatch.py:396`` holds it for ``repro``. ``place=False``
against ``place=True`` on a 4-position CPU mesh, bit for bit, and against
``repro``'s one-device retriever (ids exact, scores rtol 1e-5, atol
1e-6).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import multistage as JM
from repro.retrieval.retriever import Retriever as JRetriever
from repro.retrieval.store import VectorStore as JVectorStore
from repro_torch.core import multistage as TM
from repro_torch.launch.mesh import make_mesh
from repro_torch.retrieval import store as TS
from repro_torch.retrieval import tiering, tracing
from repro_torch.retrieval.retriever import Retriever
from repro_torch.retrieval.segments import SegmentedStore
from test_torch_cost_model import repro_trace_log_kept  # noqa: F401

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
D, DP, DIM = 6, 2, 8


def _arrays(n: int, seed: int) -> dict:
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, D, DIM)).astype(np.float32)
    ini = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)
    mask = r.random((n, D)) > 0.2
    mask[:, 0] = True
    return {"initial": ini, "initial_mask": mask,
            "mean_pooling": ini[:, :DP].copy(),
            "mean_pooling_mask": np.ones((n, DP), bool),
            "global_pooling": ini.mean(1)}


def _queries():
    r = np.random.default_rng(5)
    q = r.normal(size=(4, 5, DIM)).astype(np.float32)
    qm = r.random((4, 5)) > 0.2
    qm[:, 0] = True
    return q, qm


def _batch(n, seed):
    return TS.VectorStore({k: torch.from_numpy(v) for k, v in
                           _arrays(n, seed).items()}, n, "float32")


def _jbatch(n, seed):
    return JVectorStore({k: jnp.asarray(v) for k, v in
                         _arrays(n, seed).items()}, n, "float32")


def _search(r, stages, spec=None):
    q, qm = _queries()
    s, i = r.search(torch.from_numpy(q), torch.from_numpy(qm),
                    stages=stages, filter=spec)
    return s.numpy(), np.asarray(i)


def _jsearch(r, stages, spec=None):
    q, qm = _queries()
    s, i = r.search(jnp.asarray(q), jnp.asarray(qm), stages=stages,
                    filter=spec)
    return np.asarray(s), np.asarray(i)


def _bitwise(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def mesh4():
    return make_mesh((4,), ("data",), devices=["cpu"] * 4)


def cascades(M) -> dict:
    two = M.two_stage(12, 5)
    return {"one": M.one_stage(6),
            "two": two,
            "three": M.three_stage(16, 12, 5),
            "fused": M.with_rerank_policy(
                M.with_scan_policy(two, scan_topk=True, chunk=5),
                rerank_kernel=True),
            "routed": M.with_routing_policy(two, n_probe=2, n_clusters=4),
            "routed_full": M.with_routing_policy(two, n_probe=4,
                                                 n_clusters=4)}


# ----------------------------------------------------------------------
# scan_chunk
# ----------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
def test_scan_chunk_default_matches_repro(use_kernel):
    """``Retriever(scan_chunk=16)`` gives ``repro``'s results for a scan
    stage without a chunk (the plain scan then runs in chunks of 16),
    and its search function is the one built for the stage with
    ``chunk=16``; a stage's own chunk wins."""
    base = TM.with_scan_policy(TM.two_stage(24, 8), use_kernel=use_kernel)
    jbase = JM.with_scan_policy(JM.two_stage(24, 8), use_kernel=use_kernel)
    r = Retriever(_batch(48, 0), scan_chunk=16, device="cpu")
    jr = JRetriever(_jbatch(48, 0), scan_chunk=16)
    s, i = _search(r, base)
    js, ji = _jsearch(jr, jbase)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, **TOL)
    assert r.scan_chunk == 16
    assert r.search_fn(base) is r.search_fn(
        TM.with_scan_policy(base, chunk=16))
    assert r.search_fn(TM.with_scan_policy(base, chunk=7)) is not \
        r.search_fn(base)
    # unchunked and chunked plain scans score alike
    _bitwise(_search(Retriever(_batch(48, 0), device="cpu"), base), (s, i))


def test_scan_chunk_reaches_the_frontend():
    """The frontend's stages carry the retriever's default chunk, as
    ``repro``'s frontend normalises them."""
    r = Retriever(_batch(24, 1), scan_chunk=8, device="cpu")
    jr = JRetriever(_jbatch(24, 1), scan_chunk=8)
    fe, jfe = r.frontend(TM.two_stage(12, 5)), jr.frontend(
        JM.two_stage(12, 5))
    assert fe.stages[0].chunk == jfe.stages[0].chunk == 8
    fe2 = r.frontend(TM.with_scan_policy(TM.two_stage(12, 5), chunk=3))
    assert fe2.stages[0].chunk == 3


def test_scan_chunk_builds_once():
    """Steady-state searches with and without the chunk spelled out build
    nothing after the first."""
    r = Retriever(_batch(24, 2), scan_chunk=8, device="cpu")
    _search(r, TM.two_stage(12, 5))
    before = tracing.trace_count()
    _search(r, TM.two_stage(12, 5))
    _search(r, TM.with_scan_policy(TM.two_stage(12, 5), chunk=8))
    assert tracing.trace_count() == before


# ----------------------------------------------------------------------
# place
# ----------------------------------------------------------------------

def _recipe(**kw):
    """A 4-shard retriever over 21 pages in a 24-slot segment (tenants
    and tags across shard boundaries), IVF routing and two deletes."""
    r = Retriever(_batch(9, 0), mesh=mesh4(), capacity=24, filter_words=2,
                  routing=4, **kw)
    r.upsert(_batch(7, 1), tenant=1, tags=(2,))
    r.upsert(_batch(5, 2), tenant=1, tags=(40,))
    r.delete([3, 11])
    return r


def _jrecipe():
    r = JRetriever(_jbatch(9, 0), capacity=24, filter_words=2, routing=4)
    r.upsert(_jbatch(7, 1), tenant=1, tags=(2,))
    r.upsert(_jbatch(5, 2), tenant=1, tags=(40,))
    r.delete([3, 11])
    return r


SPECS = {"none": None, "t1": (1, ()), "t1_req2": (1, (2,))}


def _spec(F, s):
    return None if s is None else F(tenant=s[0], require_tags=s[1])


@pytest.fixture(scope="module")
def placed():
    return _recipe()


@pytest.fixture(scope="module")
def unplaced():
    return _recipe(place=False)


def test_unplaced_store_stays_where_it_is(placed, unplaced):
    assert unplaced.store.mesh is None
    assert all(len(seg.slabs) == 1 for seg in unplaced.store.segments)
    assert all(len(seg.slabs) == 4 for seg in placed.store.segments)
    assert unplaced.store.capacities == placed.store.capacities
    assert unplaced.store.n_shards == placed.store.n_shards == 4


@pytest.mark.parametrize("cascade", list(cascades(TM)))
@pytest.mark.parametrize("spec", list(SPECS))
def test_unplaced_equals_placed_bitwise(placed, unplaced, cascade, spec):
    """``place=False``: the search splits the store over the mesh on each
    call and gives the placed search's scores and ids bit for bit."""
    st = cascades(TM)[cascade]
    f = _spec(TS.FilterSpec, SPECS[spec])
    _bitwise(_search(unplaced, st, f), _search(placed, st, f))


@pytest.mark.parametrize("cascade", ["one", "two", "three", "routed_full"])
def test_unplaced_matches_repro(unplaced, cascade):
    """The unplaced mesh search against ``repro``'s one-device retriever
    over the same mutations (no tie among these random scores)."""
    s, i = _search(unplaced, cascades(TM)[cascade])
    js, ji = _jsearch(_jrecipe(), cascades(JM)[cascade])
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, **TOL)


def test_segmented_store_not_placed():
    """A ``SegmentedStore`` handed over with ``place=False`` is not laid
    out on the mesh, and answers as the placed one."""
    st = TM.two_stage(12, 5)
    seg = SegmentedStore.from_store(_batch(20, 3), capacity=24, n_shards=4,
                                    device="cpu")
    r = Retriever(seg, mesh=mesh4(), place=False)
    assert seg.mesh is None and len(seg.segments[0].slabs) == 1
    want = _search(Retriever(_batch(20, 3), mesh=mesh4(), capacity=24), st)
    _bitwise(_search(r, st), want)


def test_unplaced_tiered_equals_resident():
    """A budget of one segment over an unplaced mesh store: every scope
    runs as one sharded cascade over the whole segments, bit for bit the
    resident search."""
    r = _recipe(place=False)
    r.upsert(_batch(20, 4))                  # past the headroom
    assert len(r.store.segments) == 2
    st = cascades(TM)["two"]
    want = _search(r, st)
    q, qm = _queries()
    with r.tiered(r.store.segments[0].nbytes + 1) as eng:
        for _ in range(2):
            s, i = eng.search(torch.from_numpy(q), torch.from_numpy(qm),
                              stages=st)
            _bitwise((s.numpy(), i), want)
        assert eng.stats["promotions"] > 0


@pytest.mark.parametrize("how", ["restore_store", "from_snapshot"])
def test_restore_unplaced(tmp_path, placed, how):
    """``restore_store(mesh=, place=False)`` keeps every segment whole on
    the mesh's first device, ``from_snapshot(mesh=, place=False)`` serves
    it, and both search bit for bit as the placed restore."""
    placed.snapshot(str(tmp_path))
    if how == "restore_store":
        store = tiering.restore_store(str(tmp_path), mesh=mesh4(),
                                      place=False)
        assert store.mesh is None
        assert all(len(seg.slabs) == 1 for seg in store.segments)
        assert store.n_shards == 4
        r = Retriever(store, mesh=mesh4(), place=False)
    else:
        r = Retriever.from_snapshot(str(tmp_path), mesh=mesh4(),
                                    place=False)
        assert r.store.mesh is None
    r_placed = Retriever.from_snapshot(str(tmp_path), mesh=mesh4())
    assert r_placed.store.mesh is not None
    for name in ("two", "routed_full"):
        st = cascades(TM)[name]
        want = _search(placed, st)
        _bitwise(_search(r, st), want)
        _bitwise(_search(r_placed, st), want)
