"""Tiered segment residency and snapshot/restore in the port, mirroring
8 of the 9 tests of ``tests/test_tiering.py`` (the ninth, the multi-shard
subprocess test, is mirrored in ``tests/test_torch_mesh_retrieval.py``).

- **residency is invisible**: a ``TieredEngine`` search under any budget
  (evictions, promotions mid-search, prefetch on or off, int8 stores,
  tenant/tag filters) returns the port's fully resident
  ``Retriever.search`` bit for bit, and ``repro``'s tiered search on the
  same numpy inputs: ids exactly, scores within rtol=1e-5, atol=1e-5
  (f32 sums in another order, the tolerance of ``test_torch_filters``);
- **snapshot round trips**: snapshot -> ``Retriever.from_snapshot`` ->
  search is bit for bit the original, slot maps, deletes, routing state
  and tenants included, also when the snapshot is taken with segments on
  both tiers;
- **no build axis**: tier churn between warmed searches builds nothing
  (``retrieval.tracing``), where ``repro`` counts no retrace;
- **LRU discipline**: resident bytes equal the device-tier segments'
  bytes, stay within the budget while an unpinned victim exists, and the
  least recently used unpinned segment is the one evicted (hypothesis,
  bounded examples).

On the CPU the host tier is the store's CPU tensors and a promotion a
clone; the pinned buffers and the copy stream run on the card
(``chip_smoke.py`` phase 4j).
"""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import multistage as JM
from repro.retrieval import store as JS
from repro.retrieval.retriever import Retriever as JRetriever
from repro_torch.core import multistage as TM
from repro_torch.retrieval import tracing
from repro_torch.retrieval.retriever import Retriever
from repro_torch.retrieval.store import FilterSpec, VectorStore, quantize_store
from repro_torch.retrieval.tiering import restore_store

torch.set_num_threads(1)

D_FULL, D_POOL, DIM = 6, 2, 16
CAP = 64                     # == SEGMENT_MIN_CAPACITY: a CAP-row batch
#                              fills exactly one segment
TWO = (TM.Stage("mean_pooling", 8), TM.Stage("initial", 4))
JTWO = (JM.Stage("mean_pooling", 8), JM.Stage("initial", 4))
TOL = dict(rtol=1e-5, atol=1e-5)


def _arrays(n, seed):
    r = np.random.default_rng(seed)
    full = r.normal(size=(n, D_FULL, DIM)).astype(np.float32)
    return {"initial": full,
            "mean_pooling": full.reshape(n, D_POOL, D_FULL // D_POOL,
                                         DIM).mean(2)}


def batch(n, seed=0, quant=False):
    vs = VectorStore({k: torch.from_numpy(v) for k, v in
                      _arrays(n, seed).items()}, n, "float32")
    return quantize_store(vs, names=("initial",)) if quant else vs


def jbatch(n, seed=0, quant=False):
    vs = JS.VectorStore({k: jnp.asarray(v) for k, v in
                         _arrays(n, seed).items()}, n, "float32")
    return JS.quantize_store(vs, names=("initial",)) if quant else vs


def queries(seed=9, b=2, q=4):
    return np.random.default_rng(seed).normal(size=(b, q, DIM)).astype(
        np.float32)


def multi_segment_retriever(n_segs=4, quant=False, routing=None,
                            jax=False):
    """CAP-row segments, tenants 0/1 interleaved, a few deletes — the
    state a snapshot must carry and an eviction must not corrupt (the
    same sequence in ``repro`` with ``jax=True``)."""
    if jax:
        r = JRetriever(jbatch(CAP, 0, quant), capacity=CAP, routing=routing)
        mk = jbatch
    else:
        r = Retriever(batch(CAP, 0, quant), capacity=CAP, device="cpu",
                      routing=routing)
        mk = batch
    for s in range(1, n_segs):
        r.upsert(mk(CAP, s, quant), tenant=s % 2, tags=(s % 3,))
    r.delete([1, CAP + 2, n_segs * CAP - 3])
    assert len(r.store.segments) == n_segs
    return r


FILTERS = (None, FilterSpec(tenant=1), FilterSpec(tenant=0, any_tags=(2,)))
JFILTERS = (None, JS.FilterSpec(tenant=1),
            JS.FilterSpec(tenant=0, any_tags=(2,)))


def all_searches(search_fn, stages=TWO, filters=FILTERS):
    q = queries()
    return [search_fn(q, stages=stages, filter=spec) for spec in filters]


def assert_bitwise(got, want):
    for (gs, gi), (ws, wi) in zip(got, want):
        assert torch.equal(gs, ws), "scores differ"
        np.testing.assert_array_equal(gi, wi)


def assert_repro(got, jwant):
    for (gs, gi), (ws, wi) in zip(got, jwant):
        np.testing.assert_array_equal(gi, np.asarray(wi))
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)


# ----------------------------------------------------------------------
# snapshot / restore
# ----------------------------------------------------------------------


@pytest.mark.parametrize("quant", [False, True])
def test_snapshot_restore_bitwise(tmp_path, quant):
    r = multi_segment_retriever(quant=quant)
    want = all_searches(r.search)
    assert_repro(want, all_searches(
        multi_segment_retriever(quant=quant, jax=True).search, JTWO,
        JFILTERS))
    path = r.snapshot(str(tmp_path))
    assert os.path.isdir(path)
    r2 = Retriever.from_snapshot(str(tmp_path), device="cpu")
    assert r2.n_docs == r.n_docs
    assert r2.store.capacities == r.store.capacities
    assert_bitwise(all_searches(r2.search), want)
    # the restored corpus keeps ingesting where the old one left off:
    # fresh ids, no collision with live slots
    ids_a = r.upsert(batch(4, 77, quant))
    ids_b = r2.upsert(batch(4, 77, quant))
    np.testing.assert_array_equal(ids_a, ids_b)
    assert_bitwise(all_searches(r2.search), all_searches(r.search))


def test_snapshot_restore_routing(tmp_path):
    r = multi_segment_retriever(routing=4)
    rt = TM.with_routing_policy(TWO, n_probe=4, n_clusters=4)
    q = queries()
    want = r.search(q, stages=rt)
    jr = multi_segment_retriever(routing=4, jax=True)
    assert_repro([want], [jr.search(
        jnp.asarray(q), stages=JM.with_routing_policy(JTWO, n_probe=4,
                                                      n_clusters=4))])
    r.snapshot(str(tmp_path))
    store = restore_store(str(tmp_path), device="cpu")
    assert store.router is not None and store.router.n_clusters == 4
    for seg_a, seg_b in zip(r.store.segments, store.segments):
        np.testing.assert_array_equal(seg_a.routing.fills,
                                      seg_b.routing.fills)
        assert seg_a.routing.drift == seg_b.routing.drift
    got = Retriever(store, device="cpu").search(q, stages=rt)
    assert_bitwise([got], [want])


def test_snapshot_is_generation_stamped(tmp_path):
    r = multi_segment_retriever(n_segs=2)
    gen = r.store.generation
    r.snapshot(str(tmp_path))
    r2 = Retriever.from_snapshot(str(tmp_path), device="cpu")
    assert r2.store.generation == gen
    # a second snapshot after mutation lands as a NEWER step
    r.upsert(batch(3, 5))
    r.snapshot(str(tmp_path))
    r3 = Retriever.from_snapshot(str(tmp_path), device="cpu")
    assert r3.n_docs == r.n_docs
    assert r3.store.generation == r.store.generation > gen


# ----------------------------------------------------------------------
# tiered search parity + builds
# ----------------------------------------------------------------------


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("overlap", [False, True])
def test_evict_then_search_parity(quant, overlap):
    """Under a budget that holds ONE segment, every search churns the
    residency (promote + demote) — results must stay bit for bit those of
    the fully resident search computed before any eviction, and equal to
    ``repro``'s tiered search on the same inputs."""
    r = multi_segment_retriever(quant=quant)
    want = all_searches(r.search)                 # fully resident
    seg_bytes = r.store.segments[0].nbytes
    with r.tiered(seg_bytes + 1, prefetch=overlap) as eng:
        assert len(eng.resident()) <= 1
        got = [eng.search(queries(), stages=TWO, filter=spec,
                          overlap=overlap) for spec in FILTERS]
        assert_bitwise(got, want)
        assert eng.stats["demotions"] > 0, "budget never forced a spill"
    jr = multi_segment_retriever(quant=quant, jax=True)
    jq = jnp.asarray(queries())
    with jr.tiered(jr.store.segments[0].nbytes + 1, prefetch=overlap) as je:
        jgot = [je.search(jq, stages=JTWO, filter=spec, overlap=overlap)
                for spec in JFILTERS]
    assert_repro(got, jgot)
    # the per-segment pipeline == the joint cascade, segment by segment:
    # scope to each segment and cross-check against a scoped engine whose
    # budget holds the whole corpus
    with r.tiered(2 * seg_bytes) as eng, \
            r.tiered(len(r.store.segments) * 2 * seg_bytes) as ref:
        for si in range(len(r.store.segments)):
            got = eng.search(queries(), stages=TWO, scope=[si],
                             overlap=overlap)
            oracle = ref.search(queries(), stages=TWO, scope=[si])
            assert_bitwise([got], [oracle])


def test_snapshot_restore_under_tiering(tmp_path):
    """A snapshot taken while segments sit on BOTH tiers restores to a
    searchable store: host-tier tensors persist bit for bit too."""
    r = multi_segment_retriever()
    want = all_searches(r.search)
    with r.tiered(r.store.segments[0].nbytes + 1) as eng:
        eng.search(queries(), stages=TWO, scope=[2])
        tiers = {s.tier for s in r.store.segments}
        assert tiers == {"host", "device"}
        eng.snapshot(str(tmp_path))
    r2 = Retriever.from_snapshot(str(tmp_path), device="cpu")
    assert all(s.tier == "device" for s in r2.store.segments)
    assert_bitwise(all_searches(r2.search), want)


def test_zero_builds_under_churn():
    r = multi_segment_retriever()
    want = r.search(queries(), stages=TWO)
    seg_bytes = r.store.segments[0].nbytes
    with r.tiered(2 * seg_bytes + 1) as eng:
        q = queries()
        eng.search(q, stages=TWO, scope=[0, 1])          # build
        eng.search(q, stages=TWO, scope=[2, 3])          # churn warm
        before = tracing.trace_count()
        for i in range(8):
            scope = [(i % 4), ((i + 1) % 4)]
            eng.search(q, stages=TWO, scope=scope)
        assert tracing.trace_count() == before, \
            "tier churn leaked into a build"
        assert eng.stats["promotions"] > 2
        assert_bitwise([eng.search(q, stages=TWO)], [want])


# ----------------------------------------------------------------------
# LRU discipline
# ----------------------------------------------------------------------


def lru_state_ok(eng, store, budget):
    resident = eng.resident()
    by_tier = {i for i, s in enumerate(store.segments)
               if s.tier == "device"}
    assert set(resident) == by_tier, "LRU set disagrees with segment tiers"
    assert eng.resident_bytes == sum(store.segments[i].nbytes
                                     for i in resident)
    if eng.resident_bytes > budget:
        assert eng.stats["overflow"] > 0, \
            "over budget without an overflow event"


def test_lru_deterministic_floor():
    r = multi_segment_retriever()
    seg_bytes = r.store.segments[0].nbytes
    budget = 2 * seg_bytes + 1
    with r.tiered(budget) as eng:
        for si in (0, 1, 2):
            eng.search(queries(), stages=TWO, scope=[si])
            lru_state_ok(eng, r.store, budget)
        # 0 is the least recently used of {0,1,2}'s survivors: touching
        # 2 must have evicted it, and re-touching 1 then 3 evicts 2
        assert 0 not in eng.resident()
        eng.search(queries(), stages=TWO, scope=[1])
        eng.search(queries(), stages=TWO, scope=[3])
        lru_state_ok(eng, r.store, budget)
        assert 2 not in eng.resident()
        assert set(eng.resident()) == {1, 3}


def test_lru_invariants_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    r = multi_segment_retriever(n_segs=5)
    seg_bytes = r.store.segments[0].nbytes

    @given(st.lists(st.integers(0, 4), min_size=1, max_size=24),
           st.integers(1, 3))
    @settings(deadline=None, max_examples=12)
    def prop(accesses, cap_segs):
        budget = cap_segs * seg_bytes + 1
        with r.tiered(budget) as eng:
            for i in accesses:
                eng._acquire(i, overlap=False)
                lru_state_ok(eng, r.store, budget)
                assert i == eng.resident()[-1], "touched != MRU"
                eng._release(i)
            assert len(eng.resident()) <= cap_segs
            assert not eng._pins or not any(eng._pins.values())

    prop()
