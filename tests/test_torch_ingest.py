"""The fused ingest, the segment bookkeeping it shares with ``add_pages``,
and ``compact``: the port against itself and against ``repro``, mirroring
``tests/test_ingest.py`` and ``tests/test_filters.py``'s
``test_compact_preserves_tenancy``.

- fused ``Retriever.ingest`` leaves every segment array BIT FOR BIT equal
  to ``build_store`` (+ ``quantize_store``) + ``upsert`` on the same
  pipeline, never-claimed padding slots included, for the three pooling
  geometries with int8 off and on; both equal ``repro``'s arrays within
  rtol=1e-6, atol=1e-6 (bools, ids and int8 codes exactly);
- ``batch_bucket``, ``produced_keys`` and the layout of ``index`` are
  ``repro``'s; the kernel (fused operator) mode matches the reference
  mode to bf16 tolerance (2e-2), as in ``repro``'s test;
- steady-state ingestion of mixed batch sizes builds nothing (trace
  delta 0); a batch past the headroom allocates a bucketed segment,
  which the next search counts as one new search function;
- a pipeline/store key mismatch and a misordered token layout raise;
- ``compact`` keeps ids, tenancy and tags: filtered searches after it
  equal a search over the rebuilt matching corpus and ``repro``'s
  compacted search.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.configs.base import RetrieverConfig as JCfg
from repro.core import multistage as JM
from repro.retrieval import ingest as JI
from repro.retrieval.retriever import Retriever as JRetriever
from repro_torch.configs.base import RetrieverConfig
from repro_torch.core import multistage as TM
from repro_torch.core.hygiene import PAD, SPECIAL, VISUAL
from repro_torch.kernels.maxsim.ops import quantize_int8
from repro_torch.retrieval import tracing
from repro_torch.retrieval.ingest import IngestPipeline, batch_bucket
from repro_torch.retrieval.retriever import Retriever
from repro_torch.retrieval.store import (FilterSpec, build_store, codes_key,
                                         mask_key, quantize_store, scale_key)

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
_BASE = dict(d_model=64, n_layers=1, n_heads=1, d_ff=64, out_dim=16,
             n_special=3, max_query_tokens=8)
GEOM = {
    "grid": dict(name="mini-grid", geometry="grid", grid_h=8, grid_w=8,
                 smooth="conv1d", **_BASE),
    "tiles": dict(name="mini-tiles", geometry="tiles", n_tiles=4,
                  tile_patches=8, smooth="none", **_BASE),
    # grid_h < max_rows: the store pads pooled rows with a validity mask
    "dynamic": dict(name="mini-dyn", geometry="dynamic", grid_h=6,
                    grid_w=6, max_rows=8, smooth="gaussian", **_BASE),
}
MINI = {g: RetrieverConfig(**kw) for g, kw in GEOM.items()}
JMINI = {g: JCfg(**kw) for g, kw in GEOM.items()}


def _pages(cfg, n, seed):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, cfg.seq_len, cfg.out_dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _types(cfg):
    return np.asarray([SPECIAL] * cfg.n_special + [VISUAL] * cfg.n_patches,
                      np.int32)


def _np(v):
    return v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()


def _assert_stores_bitwise(r1, r2):
    assert len(r1.store.segments) == len(r2.store.segments)
    for s1, s2 in zip(r1.store.segments, r2.store.segments):
        assert set(s1.vectors) == set(s2.vectors)
        assert s1.n_docs == s2.n_docs
        np.testing.assert_array_equal(s1.doc_ids, s2.doc_ids)
        for k in s1.vectors:
            assert s1.vectors[k].dtype == s2.vectors[k].dtype, k
            assert torch.equal(s1.vectors[k], s2.vectors[k]), k


@pytest.mark.parametrize("geom", ["grid", "tiles", "dynamic"])
@pytest.mark.parametrize("int8", [False, True])
def test_pipeline_parity_bitwise(geom, int8):
    """Fused ingest == build_store(+quantize_store)+upsert, bit for bit on
    every stored array (never-claimed padding slots included), and both
    equal repro's fused ingest."""
    cfg, jcfg = MINI[geom], JMINI[geom]
    tt = _types(cfg)
    stages = TM.two_stage(6, 3)
    quantize = ("mean_pooling",) if int8 else ()
    pipe = IngestPipeline.for_config(
        cfg, use_kernel=False, quantize=quantize,
        stages=stages if int8 else None, device="cpu")

    def legacy(pages):
        batch = build_store(cfg, pages, tt, device="cpu")
        if int8:
            batch = quantize_store(batch, names=quantize, stages=stages)
        return batch

    r1 = Retriever(pipe.index(_pages(cfg, 6, 0), tt), capacity=32,
                   ingest=pipe, device="cpu")
    r2 = Retriever(legacy(_pages(cfg, 6, 0)), capacity=32, device="cpu")
    jpipe = JI.IngestPipeline.for_config(
        jcfg, use_kernel=False, quantize=quantize,
        stages=JM.two_stage(6, 3) if int8 else None)
    jr = JRetriever(jpipe.index(jnp.asarray(_pages(cfg, 6, 0)),
                                jnp.asarray(tt)), capacity=32, ingest=jpipe)
    g0 = r1.store.generation
    for seed, n in ((1, 5), (2, 11), (3, 3)):   # mixed sizes, two buckets
        ids1 = r1.ingest(_pages(cfg, n, seed), tt)
        ids2 = r2.upsert(legacy(_pages(cfg, n, seed)))
        jids = jr.ingest(jnp.asarray(_pages(cfg, n, seed)), jnp.asarray(tt))
        np.testing.assert_array_equal(ids1, ids2)
        np.testing.assert_array_equal(ids1, jids)
    assert r1.store.generation == g0 + 3
    _assert_stores_bitwise(r1, r2)
    for s1, js in zip(r1.store.segments, jr.store.segments):
        assert set(s1.vectors) == set(js.vectors)
        for k, v in s1.vectors.items():
            want = np.asarray(js.vectors[k])
            if k == "doc_filter":
                want = want.view(np.int32)
            if v.dtype in (torch.bool, torch.int8, torch.int32):
                np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
            else:
                np.testing.assert_allclose(_np(v), want.astype(np.float32),
                                           err_msg=k, **TOL)
    # the same arrays give the same search results, bit for bit
    q = np.random.default_rng(9).normal(
        size=(2, 4, cfg.out_dim)).astype(np.float32)
    s1, i1 = r1.search(q, stages=stages)
    s2, i2 = r2.search(q, stages=stages)
    np.testing.assert_array_equal(i1, i2)
    assert torch.equal(s1, s2)


@pytest.mark.parametrize("geom", ["grid", "tiles", "dynamic"])
def test_index_matches_independent_eager_reference(geom):
    """The pipeline's reference mode against the index path re-built here
    from the core primitives (hygiene -> pool_pages_batch -> global_pool
    -> bf16), bit for bit: the bucket padding perturbs no real page."""
    from repro_torch.core import hygiene as HG
    from repro_torch.core import pooling as PL

    cfg = MINI[geom]
    tt = torch.from_numpy(_types(cfg))
    pages = torch.from_numpy(_pages(cfg, 5, 11))
    N, S, _ = pages.shape
    emb, keep = HG.apply_hygiene(pages, tt[None].expand(N, S))
    vis = emb[:, S - cfg.n_patches:]
    vis_mask = keep[:, S - cfg.n_patches:]
    pooled, pooled_mask = PL.pool_pages_batch(cfg, vis, vis_mask)
    expect = {
        "initial": vis.to(torch.bfloat16),
        mask_key("initial"): vis_mask,
        "mean_pooling": pooled.to(torch.bfloat16),
        mask_key("mean_pooling"): pooled_mask,
        "global_pooling": PL.global_pool(vis, vis_mask).to(torch.bfloat16),
    }
    got = IngestPipeline.for_config(cfg, use_kernel=False,
                                    device="cpu").index(pages, tt)
    assert set(got.vectors) == set(expect) and got.n_docs == 5
    for k in expect:
        assert torch.equal(expect[k], got.vectors[k]), k


@pytest.mark.parametrize("geom", ["grid", "tiles", "dynamic"])
def test_kernel_mode_matches_reference(geom):
    """Fused-operator pooling (its plain version here) == the reference
    semantics to bf16 tolerance; identical layout (names, shapes, masks);
    ``pool_path`` names the route."""
    cfg = MINI[geom]
    tt = _types(cfg)
    pr = IngestPipeline.for_config(cfg, use_kernel=False, device="cpu")
    pk = IngestPipeline.for_config(cfg, use_kernel=True, device="cpu")
    assert (pr.pool_path, pk.pool_path) == ("reference", "fused-plain")
    ref, ker = (p.index(_pages(cfg, 7, 4), tt) for p in (pr, pk))
    assert set(ref.vectors) == set(ker.vectors)
    for k in ref.vectors:
        a, b = ref.vectors[k], ker.vectors[k]
        assert a.shape == b.shape, k
        if a.dtype == torch.bool:
            assert torch.equal(a, b), k
        else:
            np.testing.assert_allclose(_np(a), _np(b), rtol=2e-2, atol=2e-2,
                                       err_msg=k)


def test_dynamic_padded_pooled_rows():
    """grid_h < max_rows: trailing pooled slots are zero vectors with a
    False mask, in both pooling modes."""
    cfg = MINI["dynamic"]
    tt = _types(cfg)
    for uk in (False, True):
        st = IngestPipeline.for_config(cfg, use_kernel=uk,
                                       device="cpu").index(
            _pages(cfg, 3, 5), tt)
        mask = st.vectors[mask_key("mean_pooling")].numpy()
        assert mask.shape == (3, cfg.max_rows)
        assert mask[:, :cfg.grid_h].all() and not mask[:, cfg.grid_h:].any()
        pooled = _np(st.vectors["mean_pooling"])
        assert (pooled[:, cfg.grid_h:] == 0).all()


def test_steady_state_ingestion_never_retraces():
    """Mixed batch sizes ingest + search with ZERO builds once the search
    function exists; the port does not need one warm-up per bucket (a new
    batch shape costs nothing in eager PyTorch), so the first ingests are
    already inside the no-retrace block."""
    cfg = MINI["grid"]
    tt = _types(cfg)
    stages = TM.two_stage(6, 3)
    pipe = IngestPipeline.for_config(cfg, use_kernel=True, device="cpu")
    r = Retriever(pipe.index(_pages(cfg, 4, 0), tt), capacity=256,
                  ingest=pipe, device="cpu")
    q = np.random.default_rng(8).normal(
        size=(2, 4, cfg.out_dim)).astype(np.float32)
    r.search(q, stages=stages)
    with tracing.no_retrace("mixed-size ingestion"):
        for seed, n in enumerate((8, 16, 5, 13, 8, 1, 16, 11)):
            r.ingest(_pages(cfg, n, 20 + seed), tt)
            r.search(q, stages=stages)
    assert r.n_docs == 4 + 24 + 54


def test_ingest_beyond_headroom_allocates_bucketed_segment():
    """A batch past the headroom gets a new bucketed segment (a full
    bucket of room for the fused copy); the layout change invalidates the
    cached search function, and the next search counts one build."""
    cfg = MINI["tiles"]
    tt = _types(cfg)
    stages = TM.two_stage(6, 3)
    pipe = IngestPipeline.for_config(cfg, use_kernel=False, device="cpu")
    r = Retriever(pipe.index(_pages(cfg, 4, 0), tt), capacity=8,
                  ingest=pipe, device="cpu")
    q = np.random.default_rng(1).normal(
        size=(1, 4, cfg.out_dim)).astype(np.float32)
    r.search(q, stages=stages)
    r.ingest(_pages(cfg, 3, 1), tt)         # 4 + 3 <= 8, but bucket 8: new
    assert len(r.store.segments) == 2
    r.ingest(_pages(cfg, 6, 2), tt)         # fits the second segment's room
    assert len(r.store.segments) == 2
    assert all(c & (c - 1) == 0 for c in r.store.capacities)
    assert r.store.capacities[1] >= batch_bucket(6)
    assert r.store.total_capacity == sum(r.store.capacities)
    assert r.n_docs == 13
    before = tracing.trace_count()
    s, i = r.search(q, stages=TM.two_stage(13, 13))
    assert tracing.trace_count() == before + 1
    assert sorted(i[0].tolist()) == list(range(13))
    with tracing.no_retrace("same layout"):
        r.search(q, stages=TM.two_stage(13, 13))


def test_batch_bucket_family_is_repros():
    assert batch_bucket(1) == 8             # min bucket floor
    assert batch_bucket(9) == 16
    assert batch_bucket(257) == 320         # bulk: 64-row granules
    for n in (1, 7, 8, 9, 31, 64, 65, 200, 256, 257, 600, 1000):
        assert batch_bucket(n) == JI.batch_bucket(n), n
    for n, mb in ((3, 1), (3, 4), (40, 32)):
        assert batch_bucket(n, mb) == JI.batch_bucket(n, mb), (n, mb)
    for bad in (0, -1):
        with pytest.raises(ValueError):
            batch_bucket(bad)
        with pytest.raises(ValueError):
            JI.batch_bucket(bad)


@pytest.mark.parametrize("kw", [
    dict(), dict(experimental_smooth="gaussian"),
    dict(quantize=("mean_pooling",)),
    dict(quantize=("initial", "mean_pooling"), stages="two"),
    dict(quantize=("initial",), stages="one")])
def test_produced_keys_are_repros(kw):
    cfg, jcfg = MINI["grid"], JMINI["grid"]
    st = kw.pop("stages", None)
    t_st = {"one": TM.one_stage(3), "two": TM.two_stage(6, 3)}.get(st)
    j_st = {"one": JM.one_stage(3), "two": JM.two_stage(6, 3)}.get(st)
    tp = IngestPipeline(cfg, use_kernel=False, stages=t_st, device="cpu",
                        **kw)
    jp = JI.IngestPipeline(jcfg, use_kernel=False, stages=j_st, **kw)
    assert tp.produced_keys == jp.produced_keys
    got = tp.index(_pages(cfg, 2, 3), _types(cfg))
    assert tuple(sorted(got.vectors)) == tp.produced_keys


def test_for_config_shares_one_pipeline_per_options():
    cfg = MINI["grid"]
    a = IngestPipeline.for_config(cfg, use_kernel=False, device="cpu")
    assert IngestPipeline.for_config(cfg, use_kernel=False,
                                     device="cpu") is a
    assert IngestPipeline.for_config(cfg, use_kernel=True,
                                     device="cpu") is not a
    assert IngestPipeline.for_config(cfg, use_kernel=False,
                                     store_dtype=torch.float32,
                                     device="cpu") is not a


def test_pipeline_store_mismatch_raises():
    """A pipeline must not write into segments whose named arrays it
    does not produce (e.g. quantisation options differ); nothing is
    written."""
    cfg = MINI["grid"]
    tt = _types(cfg)
    stages = TM.two_stage(6, 3)
    pipe_q = IngestPipeline.for_config(
        cfg, use_kernel=False, quantize=("mean_pooling",), stages=stages,
        device="cpu")
    r = Retriever(build_store(cfg, _pages(cfg, 4, 0), tt, device="cpu"),
                  capacity=16, ingest=pipe_q, device="cpu")
    with pytest.raises(ValueError, match="quantize/stages"):
        r.ingest(_pages(cfg, 2, 1), tt)
    assert r.n_docs == 4 and r.store.generation == 0
    with pytest.raises(ValueError, match="no ingest pipeline"):
        Retriever(build_store(cfg, _pages(cfg, 4, 0), tt, device="cpu"),
                  device="cpu").ingest(_pages(cfg, 2, 1), tt)
    with pytest.raises(ValueError, match="not among produced"):
        IngestPipeline(cfg, quantize=("experimental",), device="cpu")


def test_visual_tail_validation():
    """token_types must mark the trailing n_patches as visual —
    misordered layouts raise instead of silently mis-indexing."""
    cfg = MINI["grid"]
    pages = _pages(cfg, 2, 0)
    bad_tail = np.asarray([VISUAL] * cfg.n_patches + [SPECIAL] * 3)
    with pytest.raises(ValueError, match="trailing"):
        build_store(cfg, pages, bad_tail, device="cpu")
    leak = _types(cfg).copy()
    leak[0] = VISUAL
    leak[-1] = PAD
    with pytest.raises(ValueError):
        build_store(cfg, pages, leak, device="cpu")


def test_ingest_pads_2d_token_types_with_pad():
    """[N, S] token types pad to the bucket with PAD rows; the real pages
    index as with their own [S] types, and the padding rows are zero in
    every array."""
    cfg = MINI["grid"]
    tt = _types(cfg)
    pipe = IngestPipeline.for_config(cfg, use_kernel=True, device="cpu")
    r1 = Retriever(pipe.index(_pages(cfg, 4, 0), tt), capacity=32,
                   ingest=pipe, device="cpu")
    r2 = Retriever(pipe.index(_pages(cfg, 4, 0), tt), capacity=32,
                   ingest=pipe, device="cpu")
    r1.ingest(_pages(cfg, 3, 1), np.broadcast_to(tt, (3, len(tt))).copy())
    r2.ingest(_pages(cfg, 3, 1), tt)
    _assert_stores_bitwise(r1, r2)
    seg = r1.store.segments[0]
    for k, v in seg.vectors.items():
        assert not v[7:].any(), k               # slots 7..14 written as 0


def test_schema_round_trip_quantized_store():
    cfg = MINI["grid"]
    tt = _types(cfg)
    stages = TM.two_stage(6, 3)
    store = quantize_store(build_store(cfg, _pages(cfg, 4, 0), tt,
                                       device="cpu"),
                           names=("mean_pooling",), stages=stages)
    sch = store.schema()
    assert sch.names == ("global_pooling", "initial", "mean_pooling")
    mp = sch["mean_pooling"]
    assert mp.quantized and not mp.has_float and mp.has_mask
    assert mp.key == codes_key("mean_pooling")
    all_keys = set()
    for nv in sch:
        all_keys |= set(sch.keys_for(nv.name))
    assert all_keys == set(store.vectors)
    assert set(sch.keys_for("mean_pooling")) == {
        mask_key("mean_pooling"), codes_key("mean_pooling"),
        scale_key("mean_pooling")}
    assert store.dims() == {"initial": cfg.n_patches,
                            "mean_pooling": cfg.n_pooled,
                            "global_pooling": 1}


def test_quantize_int8_store_dtype_and_chunked_parity():
    docs = torch.from_numpy(np.random.default_rng(3).normal(
        size=(21, 6, 16)).astype(np.float32)).to(torch.bfloat16)
    ref_c, ref_s = quantize_int8(docs.float())
    for chunk in (0, 8, 5):
        c, s = quantize_int8(docs, chunk=chunk)
        assert torch.equal(c, ref_c) and torch.equal(s, ref_s)


def test_build_store_wrapper_is_reference_semantics():
    cfg = MINI["grid"]
    tt = _types(cfg)
    pages = _pages(cfg, 5, 7)
    store = build_store(cfg, pages, tt, device="cpu")
    assert store.n_docs == 5 and store.store_dtype == "bfloat16"
    assert torch.equal(store.vectors["initial"],
                       torch.from_numpy(pages[:, cfg.n_special:]).to(
                           torch.bfloat16))
    assert bool(store.vectors[mask_key("initial")].all())


# ---------------------------------------------------------------------------
# compact
# ---------------------------------------------------------------------------

def test_compact_preserves_tenancy():
    """Compaction gathers the tenant/filter companions alongside the data
    rows and rebuilds doc_valid: filtered searches stay rebuild-equivalent
    and equal repro's compacted store's."""
    from test_torch_filters import (QMASK, QUERY, _j, _matching, _stack,
                                    _tb, _two_tenant)

    tr, jr, rows, meta, dead = _two_tenant(64)
    for r in (tr, jr):
        r.delete([4, 19])
    dead |= {4, 19}
    g = tr.store.generation
    tr.compact()
    jr.compact()
    assert tr.store.generation == g + 1
    assert tr.store.capacities == jr.store.capacities
    seg, jseg = tr.store.segments[0], jr.store.segments[0]
    np.testing.assert_array_equal(seg.doc_ids, jseg.doc_ids)
    for k in ("doc_valid", "doc_tenant"):
        np.testing.assert_array_equal(seg.vectors[k].numpy(),
                                      np.asarray(jseg.vectors[k]))
    stages = TM.two_stage(8, 4)
    for spec in (FilterSpec(tenant=0), FilterSpec(tenant=1),
                 FilterSpec(tenant=1, require_tags=(1,))):
        s, i = tr.search(QUERY, QMASK, stages=stages, filter=spec)
        match = _matching(meta, dead, spec)
        rb = Retriever(_tb(_stack([rows[m] for m in match])), capacity=64,
                       device="cpu")
        sr, ir = rb.search(QUERY, QMASK, stages=stages)
        mapped = np.asarray([[match[j] if j >= 0 else -1 for j in row]
                             for row in ir])
        np.testing.assert_array_equal(i, mapped)
        assert torch.equal(s, sr)
        js, ji = jr.search(jnp.asarray(QUERY), jnp.asarray(QMASK),
                           stages=JM.two_stage(8, 4), filter=_j(spec))
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-5)


def test_compact_reclusters_a_routed_store():
    """With routing on, compact clusters the new segment afresh: every
    live slot sits in exactly one member list, and routed full probe
    gives the exhaustive ids."""
    from test_torch_filters import QMASK, QUERY, _two_tenant

    tr, _, _, _, _ = _two_tenant(64)
    tr.store.enable_routing(4)
    tr.compact()
    seg = tr.store.segments[0]
    members = seg.vectors["ivf_members"].numpy()
    live = members[members >= 0]
    assert sorted(live.tolist()) == list(range(seg.n_docs))
    two = TM.two_stage(8, 4)
    s, i = tr.search(QUERY, QMASK, stages=two)
    sr, ir = tr.search(QUERY, QMASK, stages=TM.with_routing_policy(
        two, n_probe=4, n_clusters=4))
    np.testing.assert_array_equal(i, ir)
