"""Tenant and tag filters: the port's filter API and filtered search
against ``repro``'s, mirroring the single-device parts of
``tests/test_filters.py``.

- ``pack_tags``/``FilterSpec``/``as_filter_arrays``: the same words (the
  port holds them as int32 bit patterns of JAX's uint32 words, tag 31
  included), the same canonical specs, the same bounds errors;
- ``effective_validity``: each term gives JAX's mask exactly;
- a filtered search equals the unfiltered search over a store rebuilt
  from only the matching pages (same capacity), on every policy path,
  ids exactly and scores exactly (each (query, document) pair is scored
  alone, so removing other documents changes no score), and equals
  ``repro``'s filtered search: ids exactly, scores within rtol=1e-5,
  atol=1e-5 (f32 sums in another order);
- filler ids of filter-excluded live pages come back -1;
- the tenant and tag companions written by ``upsert``, the ingest
  pipeline and ``delete`` equal JAX's exactly, and a JAX store carried
  across with ``SegmentedStore.from_numpy`` searches the same.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import multistage as JM
from repro.retrieval import store as JS
from repro.retrieval.retriever import Retriever as JRetriever
from repro_torch.core import multistage as TM
from repro_torch.retrieval import store as TS
from repro_torch.retrieval.retriever import Retriever
from repro_torch.retrieval.segments import SegmentedStore

torch.set_num_threads(1)

D, DP, DIM = 4, 2, 8
NEG_CUT = -1e29
TOL = dict(rtol=1e-5, atol=1e-5)
QUERY = np.random.default_rng(99).normal(size=(3, 5, DIM)).astype(np.float32)
QMASK = np.ones((3, 5), bool)


def _arrays(n: int, seed: int) -> dict:
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, D, DIM)).astype(np.float32)
    ini = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)
    return {"initial": ini, "initial_mask": np.ones((n, D), bool),
            "mean_pooling": np.ascontiguousarray(ini[:, :DP]),
            "mean_pooling_mask": np.ones((n, DP), bool),
            "global_pooling": ini.mean(1)}


def _tb(arrs: dict) -> TS.VectorStore:
    return TS.VectorStore({k: torch.from_numpy(v.copy())
                           for k, v in arrs.items()},
                          len(arrs["initial"]), "float32")


def _jb(arrs: dict) -> JS.VectorStore:
    return JS.VectorStore({k: jnp.asarray(v) for k, v in arrs.items()},
                          len(arrs["initial"]), "float32")


def _rows(arrs: dict) -> list:
    return [{k: a[i] for k, a in arrs.items()}
            for i in range(len(arrs["initial"]))]


def _stack(rows: list) -> dict:
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def _twords(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


# ----------------------------------------------------------------------
# FilterSpec / pack_tags / as_filter_arrays
# ----------------------------------------------------------------------

@pytest.mark.parametrize("tags,n_words", [
    ((0, 5, 31), 1), ((35,), 2), ((), 3), ((31, 63, 32, 0), 2),
    ((7, 7, 40), 2)])
def test_pack_tags_matches_repro(tags, n_words):
    got = TS.pack_tags(tags, n_words)
    want = JS.pack_tags(tags, n_words)
    assert got.dtype == np.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the store's int32 bit patterns are the same 32 bits
    np.testing.assert_array_equal(_twords(TS.words_tensor(got)), want)


@pytest.mark.parametrize("tags,n_words", [((32,), 1), ((-1,), 1),
                                          ((64,), 2)])
def test_pack_tags_out_of_range_raises_like_repro(tags, n_words):
    with pytest.raises(ValueError):
        JS.pack_tags(tags, n_words)
    with pytest.raises(ValueError):
        TS.pack_tags(tags, n_words)


def test_filterspec_canonical_and_hashable():
    a = TS.FilterSpec(tenant=np.int64(3), require_tags=[5, 3, 5],
                      any_tags=(2,))
    b = TS.FilterSpec(tenant=3, require_tags=(3, 5), any_tags=[2])
    assert a == b and hash(a) == hash(b)
    assert a.tenant == 3 and a.require_tags == (3, 5)
    j = JS.FilterSpec(tenant=np.int64(3), require_tags=[5, 3, 5],
                      any_tags=(2,))
    assert (a.tenant, a.require_tags, a.any_tags) == \
        (j.tenant, j.require_tags, j.any_tags)
    assert not a.is_null
    assert TS.NULL_FILTER.is_null and TS.FilterSpec().is_null
    assert not TS.FilterSpec(tenant=0).is_null     # tenant 0 IS a scope


@pytest.mark.parametrize("spec", [
    None, TS.FilterSpec(tenant=2, require_tags=(1, 31)),
    TS.FilterSpec(any_tags=(33, 63)), TS.FilterSpec(tenant=-1)])
def test_as_filter_arrays_matches_repro(spec):
    w = 2
    got = TS.as_filter_arrays(spec, w)
    jspec = None if spec is None else JS.FilterSpec(
        spec.tenant, spec.require_tags, spec.any_tags)
    want = JS.as_filter_arrays(jspec, w)
    assert got[0].dtype == torch.int32 and got[0].shape == ()
    assert int(got[0]) == int(want[0])
    for g, x in zip(got[1:], want[1:]):
        assert g.dtype == torch.int32 and tuple(g.shape) == (w,)
        np.testing.assert_array_equal(_twords(g), np.asarray(x))
    # the null filter has the same structure; a packed triple passes
    null = TS.as_filter_arrays(None, w)
    assert [tuple(t.shape) for t in null] == [tuple(t.shape) for t in got]
    assert TS.as_filter_arrays(got, w) is got
    # W clamps to >= 1 for filter-less stores
    assert tuple(TS.as_filter_arrays(None, 0)[1].shape) == (1,)


def _companions(tags_per_doc, n_words, tenants, valid):
    words = np.stack([JS.pack_tags(t, n_words) for t in tags_per_doc])
    return ({"doc_valid": jnp.asarray(valid),
             "doc_tenant": jnp.asarray(tenants, jnp.int32),
             "doc_filter": jnp.asarray(words)},
            {"doc_valid": torch.from_numpy(np.asarray(valid)),
             "doc_tenant": torch.tensor(tenants, dtype=torch.int32),
             "doc_filter": torch.from_numpy(words.view(np.int32))})


SPECS = [None, TS.FilterSpec(tenant=1), TS.FilterSpec(require_tags=(1, 2)),
         TS.FilterSpec(any_tags=(2, 3)),
         TS.FilterSpec(tenant=1, any_tags=(1, 3)),
         TS.FilterSpec(tenant=1, require_tags=(1, 2)),
         TS.FilterSpec(require_tags=(31,)), TS.FilterSpec(any_tags=(31, 63)),
         TS.FilterSpec(tenant=1, require_tags=(31, 63)),
         TS.FilterSpec(tenant=7)]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_effective_validity_terms_match_repro(spec):
    tags = [(1, 2), (1,), (3,), (1, 2), (31,), (31, 63), (63,), ()]
    jv, tv = _companions(tags, 2, [0, 1, 1, 1, 0, 1, 1, 0],
                         [True, True, True, False, True, True, True, True])
    jspec = None if spec is None else JS.FilterSpec(
        spec.tenant, spec.require_tags, spec.any_tags)
    want = np.asarray(JS.effective_validity(jv, JS.as_filter_arrays(jspec,
                                                                    2)))
    got = TS.effective_validity(tv, TS.as_filter_arrays(spec, 2))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    # doc_valid always ANDs in: the dead slot never matches anything
    assert not bool(got[3])


def test_effective_validity_hand_checked():
    _, tv = _companions([(1, 2), (1,), (3,), (1, 2)], 1, [0, 1, 1, 1],
                        [True, True, True, False])

    def eff(spec):
        return TS.effective_validity(tv, TS.as_filter_arrays(spec, 1))\
            .numpy().astype(int).tolist()

    assert eff(None) == [1, 1, 1, 0]
    assert eff(TS.FilterSpec(tenant=1)) == [0, 1, 1, 0]
    assert eff(TS.FilterSpec(require_tags=(1, 2))) == [1, 0, 0, 0]
    assert eff(TS.FilterSpec(any_tags=(2, 3))) == [1, 0, 1, 0]
    assert eff(TS.FilterSpec(tenant=1, any_tags=(1, 3))) == [0, 1, 1, 0]
    # a store without companions: no filter terms, doc_valid only or None
    assert TS.effective_validity({}, TS.as_filter_arrays(
        TS.FilterSpec(tenant=1), 1)) is None


# ----------------------------------------------------------------------
# filtered search == search over the rebuilt matching corpus
# ----------------------------------------------------------------------

def _two_tenant(cap=64):
    """Tenant 0: pages 4-11 (tags 1, 2). Tenant 1: pages 12-19 (tag 1)
    and 20-23 (no tags). Seed pages 0-3 deleted, and page 13. The same
    operations on a port and a JAX retriever."""
    seed = _arrays(4, 9)
    tr = Retriever(_tb(seed), capacity=cap, device="cpu")
    jr = JRetriever(_jb(seed), capacity=cap)
    rows, meta = _rows(seed), [(0, ())] * 4
    for r in (tr, jr):
        r.delete([0, 1, 2, 3])
    dead = {0, 1, 2, 3}
    for n, s, tenant, tags in ((8, 0, 0, (1, 2)), (8, 1, 1, (1,)),
                               (4, 2, 1, ())):
        a = _arrays(n, s)
        ti = tr.upsert(_tb(a), tenant=tenant, tags=tags)
        ji = jr.upsert(_jb(a), tenant=tenant, tags=tags)
        np.testing.assert_array_equal(ti, ji)
        rows += _rows(a)
        meta += [(tenant, tuple(tags))] * n
    for r in (tr, jr):
        r.delete([13])
    dead.add(13)
    return tr, jr, rows, meta, dead


def _matching(meta, dead, spec):
    out = []
    for i, (t, tags) in enumerate(meta):
        if i in dead:
            continue
        if spec.tenant >= 0 and t != spec.tenant:
            continue
        if any(x not in tags for x in spec.require_tags):
            continue
        if spec.any_tags and not any(x in tags for x in spec.any_tags):
            continue
        out.append(i)
    return out


def _policy(MS, policy, k1=8, k2=4):
    base = MS.two_stage(k1, k2)
    if policy == "ref":
        return base
    if policy == "kernel":
        return MS.with_scan_policy(base, use_kernel=True, chunk=16)
    if policy == "scan_topk":
        return MS.with_scan_policy(base, use_kernel=True, chunk=16,
                                   scan_topk=True)
    return MS.with_rerank_policy(
        MS.with_scan_policy(base, use_kernel=True, chunk=16,
                            scan_topk=True), rerank_kernel=True)


FSPECS = [TS.FilterSpec(tenant=0), TS.FilterSpec(tenant=1),
          TS.FilterSpec(require_tags=(1,)),
          TS.FilterSpec(tenant=1, require_tags=(1,)),
          TS.FilterSpec(any_tags=(2,))]


def _j(spec):
    return JS.FilterSpec(spec.tenant, spec.require_tags, spec.any_tags)


@pytest.mark.parametrize("policy", ["ref", "kernel", "scan_topk",
                                    "fused_rerank"])
@pytest.mark.parametrize("spec", FSPECS, ids=str)
def test_filtered_equals_rebuild_and_repro(policy, spec):
    cap = 64
    tr, jr, rows, meta, dead = _two_tenant(cap)
    stages = _policy(TM, policy)
    s, i = tr.search(torch.from_numpy(QUERY), torch.from_numpy(QMASK),
                     stages=stages, filter=spec)
    match = _matching(meta, dead, spec)
    rb = Retriever(_tb(_stack([rows[m] for m in match])), capacity=cap,
                   device="cpu")
    sr, ir = rb.search(torch.from_numpy(QUERY), torch.from_numpy(QMASK),
                       stages=stages)
    mapped = np.asarray([[match[j] if j >= 0 else -1 for j in row]
                         for row in ir])
    np.testing.assert_array_equal(i, mapped)
    np.testing.assert_array_equal(s.numpy(), sr.numpy())
    # ... and repro's filtered search on the same corpus and policy
    js, ji = jr.search(jnp.asarray(QUERY), jnp.asarray(QMASK),
                       stages=_policy(JM, policy), filter=_j(spec))
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("spec", FSPECS, ids=str)
def test_multistage_oracle_filter_matches_repro(spec):
    tr, jr, _, _, _ = _two_tenant()
    tv = tr.store.vectors
    jv = jr.store.segments[0].vectors
    stages = TM.two_stage(8, 4)
    s, i = TM.search(tv, torch.from_numpy(QUERY), stages,
                     torch.from_numpy(QMASK), fspec=spec)
    js, ji = JM.search(jv, jnp.asarray(QUERY), JM.two_stage(8, 4),
                       jnp.asarray(QMASK), fspec=_j(spec))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    # the engine and the oracle agree on slots
    es, ei = tr.search(torch.from_numpy(QUERY), torch.from_numpy(QMASK),
                       stages=stages, filter=spec, translate_ids=False)
    live = s.numpy() > NEG_CUT
    np.testing.assert_array_equal(ei.numpy()[live], i.numpy()[live])
    np.testing.assert_allclose(es.numpy(), s.numpy(), **TOL)


def test_no_match_filter_returns_only_filler():
    """A filter matching nothing leaks no live page id through its NEG
    filler entries."""
    tr, _, _, _, _ = _two_tenant()
    s, i = tr.search(torch.from_numpy(QUERY), None,
                     stages=TM.two_stage(8, 4),
                     filter=TS.FilterSpec(require_tags=(7,)))
    assert (s.numpy() < NEG_CUT).all()
    assert set(i.ravel()) == {-1}


def test_filler_hides_other_tenants_ids():
    """k above the tenant's live pages: the tail is filler (-1), never a
    page of another tenant."""
    tr, jr, _, meta, dead = _two_tenant()
    stages = (TM.Stage("mean_pooling", 16), TM.Stage("initial", 12))
    spec = TS.FilterSpec(tenant=0)
    s, i = tr.search(torch.from_numpy(QUERY), None, stages=stages,
                     filter=spec)
    mine = set(_matching(meta, dead, spec))
    assert len(mine) == 8
    for row, srow in zip(i, s.numpy()):
        assert set(row[:8]) == mine
        assert (row[8:] == -1).all() and (srow[8:] < NEG_CUT).all()
    _, ji = jr.search(jnp.asarray(QUERY), None,
                      stages=(JM.Stage("mean_pooling", 16),
                              JM.Stage("initial", 12)), filter=_j(spec))
    np.testing.assert_array_equal(i, np.asarray(ji))


def test_null_filter_equals_unfiltered():
    tr, _, _, _, _ = _two_tenant()
    stages = TM.two_stage(8, 4)
    q = torch.from_numpy(QUERY)
    s0, i0 = tr.search(q, None, stages=stages)
    for f in (None, TS.NULL_FILTER, TS.FilterSpec(tenant=-1)):
        s, i = tr.search(q, None, stages=stages, filter=f)
        np.testing.assert_array_equal(s.numpy(), s0.numpy())
        np.testing.assert_array_equal(i, i0)


# ----------------------------------------------------------------------
# companions through upsert / ingest / delete, and across packages
# ----------------------------------------------------------------------

def test_companions_through_upsert_and_delete_match_repro():
    tr, jr, _, _, _ = _two_tenant()
    (ts,), (js,) = tr.store.segments, jr.store.segments
    for k in ("doc_valid", "doc_tenant"):
        np.testing.assert_array_equal(ts.vectors[k].numpy(),
                                      np.asarray(js.vectors[k]), err_msg=k)
    np.testing.assert_array_equal(_twords(ts.vectors["doc_filter"]),
                                  np.asarray(js.vectors["doc_filter"]))
    # deletes flip doc_valid only: page 13 keeps its tenant and tags
    assert int(ts.vectors["doc_tenant"][13]) == 1
    assert not bool(ts.vectors["doc_valid"][13])
    # dead slots beyond the fill hold zeros
    assert not ts.vectors["doc_tenant"][24:].any()
    assert not ts.vectors["doc_filter"][24:].any()


def test_new_segment_and_wide_bitset_match_repro():
    """A batch that overflows allocates a new segment whose companions
    start zeroed; tags across two words, tag 63 included."""
    seed = _arrays(6, 3)
    tr = Retriever(_tb(seed), capacity=8, device="cpu", filter_words=2)
    jr = JRetriever(_jb(seed), capacity=8, filter_words=2)
    for n, s, tenant, tags in ((2, 4, 5, (31, 63)), (9, 5, 6, (0, 32)),
                               (3, 6, 7, ())):
        a = _arrays(n, s)
        np.testing.assert_array_equal(
            tr.upsert(_tb(a), tenant=tenant, tags=tags),
            jr.upsert(_jb(a), tenant=tenant, tags=tags))
    assert tr.store.capacities == jr.store.capacities
    for tseg, jseg in zip(tr.store.segments, jr.store.segments):
        np.testing.assert_array_equal(tseg.vectors["doc_tenant"].numpy(),
                                      np.asarray(jseg.vectors["doc_tenant"]))
        np.testing.assert_array_equal(_twords(tseg.vectors["doc_filter"]),
                                      np.asarray(jseg.vectors["doc_filter"]))
    q = torch.from_numpy(QUERY)
    for spec in (TS.FilterSpec(require_tags=(63,)),
                 TS.FilterSpec(tenant=6, any_tags=(32, 1)),
                 TS.FilterSpec(any_tags=(31,))):
        s, i = tr.search(q, None, stages=TM.two_stage(8, 4), filter=spec)
        js, ji = jr.search(jnp.asarray(QUERY), None,
                           stages=JM.two_stage(8, 4), filter=_j(spec))
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


def test_ingest_stamps_tenant_and_tags_like_upsert():
    """``IngestPipeline.ingest`` writes the companions ``upsert`` writes,
    and equal to repro's fused ingest path."""
    from repro.configs.base import RetrieverConfig as JCfg
    from repro.core.hygiene import SPECIAL, VISUAL
    from repro.retrieval.ingest import IngestPipeline as JPipe
    from repro_torch.configs.base import RetrieverConfig
    from repro_torch.retrieval.ingest import IngestPipeline

    kw = dict(name="mini", geometry="grid", grid_h=8, grid_w=8,
              smooth="conv1d", d_model=64, n_layers=1, n_heads=1, d_ff=64,
              out_dim=16, n_special=3, max_query_tokens=8)
    jcfg, tcfg = JCfg(**kw), RetrieverConfig(**kw)
    tt = np.asarray([SPECIAL] * jcfg.n_special + [VISUAL] * jcfg.n_patches)
    rng = np.random.default_rng(7)

    def pages(n):
        x = rng.normal(size=(n, jcfg.seq_len, jcfg.out_dim)).astype(
            np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    p0, p1 = pages(4), pages(3)
    jpipe = JPipe.for_config(jcfg, use_kernel=False)
    jr = JRetriever(jpipe.index(jnp.asarray(p0), jnp.asarray(tt)),
                    capacity=64, ingest=jpipe)
    jids = jr.ingest(jnp.asarray(p1), jnp.asarray(tt), tenant=4, tags=(6,))
    tpipe = IngestPipeline(tcfg, use_kernel=False, device="cpu")
    tr = Retriever(tpipe.index(p0, tt), capacity=64, device="cpu")
    ids = tpipe.ingest(tr.store, p1, tt, tenant=4, tags=(6,))
    np.testing.assert_array_equal(ids, jids)
    seg, jseg = tr.store.segments[0], jr.store.segments[0]
    t = seg.vectors["doc_tenant"].numpy()
    np.testing.assert_array_equal(t, np.asarray(jseg.vectors["doc_tenant"]))
    np.testing.assert_array_equal(_twords(seg.vectors["doc_filter"]),
                                  np.asarray(jseg.vectors["doc_filter"]))
    np.testing.assert_array_equal(t[ids], 4)
    assert (t[7:] == 0).all()
    q = rng.normal(size=(2, 4, 16)).astype(np.float32)
    s, i = tr.search(torch.from_numpy(q), None, stages=TM.two_stage(6, 3),
                     filter=TS.FilterSpec(tenant=4, require_tags=(6,)))
    live = i[s.numpy() > NEG_CUT]
    assert set(live) == set(int(x) for x in ids)


def test_jax_segmented_store_carried_across_searches_the_same():
    """``SegmentedStore.from_numpy`` brings a JAX store's tenants, tag
    words and slot maps across: both packages' filtered searches over
    the same state agree."""
    _, jr, _, _, _ = _two_tenant()
    ts = SegmentedStore.from_numpy(jr.store, device="cpu")
    tr = Retriever(ts, device="cpu")
    jseg, tseg = jr.store.segments[0], ts.segments[0]
    assert tseg.vectors["doc_filter"].dtype == torch.int32
    np.testing.assert_array_equal(_twords(tseg.vectors["doc_filter"]),
                                  np.asarray(jseg.vectors["doc_filter"]))
    np.testing.assert_array_equal(tseg.doc_ids, jseg.doc_ids)
    assert (ts.next_id, ts.filter_words) == (jr.store.next_id,
                                             jr.store.filter_words)
    for spec in FSPECS:
        s, i = tr.search(torch.from_numpy(QUERY), None,
                         stages=TM.two_stage(8, 4), filter=spec)
        js, ji = jr.search(jnp.asarray(QUERY), None,
                           stages=JM.two_stage(8, 4), filter=_j(spec))
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    # the carried store takes further stamped writes as repro's does
    a = _arrays(3, 8)
    np.testing.assert_array_equal(tr.upsert(_tb(a), tenant=2, tags=(3,)),
                                  jr.upsert(_jb(a), tenant=2, tags=(3,)))
    np.testing.assert_array_equal(
        ts.segments[0].vectors["doc_tenant"].numpy(),
        np.asarray(jr.store.segments[0].vectors["doc_tenant"]))


def test_spec_is_dataclass_frozen():
    with pytest.raises(dataclasses.FrozenInstanceError):
        TS.FilterSpec(tenant=1).tenant = 2


def test_out_of_range_tag_at_upsert_writes_nothing():
    """A tag beyond the store's filter words raises before any write: no
    page id is taken and no segment is allocated."""
    tr = Retriever(_tb(_arrays(4, 1)), capacity=4, device="cpu")
    with pytest.raises(ValueError, match="filter_words=1"):
        tr.upsert(_tb(_arrays(3, 2)), tenant=1, tags=(32,))
    assert tr.store.capacities == (4,) and tr.store.next_id == 4
