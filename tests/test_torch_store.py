"""The index path and the store: ``build_store`` / ``IngestPipeline``
against ``repro``'s, ``from_numpy`` carrying a JAX store across, and the
segmented store's bookkeeping.

Exact where the reference is exact: key sets, hygiene masks and the
stored bf16 ``initial`` rows (f32 -> bf16 rounds to nearest even in both
frameworks). Pooled vectors are computed in f32 by sums taken in another
order, then stored in bf16, so a last-bit f32 difference can move one bf16
rounding step: rtol=2**-7 (two bf16 steps), atol=1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.data.synthetic import make_benchmark
from repro.retrieval import ingest as JI
from repro.retrieval import segments as JSG
from repro.retrieval.store import VectorSchema as JSchema
from repro.retrieval.store import build_store as jax_build
from repro_torch.configs import get_config
from repro_torch.retrieval import ingest as TI
from repro_torch.retrieval import segments as TSG
from repro_torch.retrieval.store import (VectorSchema, build_store,
                                         from_numpy, mask_key)

torch.set_num_threads(1)

POOLED_TOL = dict(rtol=2 ** -7, atol=1e-6)
SHRINK = {"colpali": dict(grid_h=8, grid_w=8, out_dim=32),
          "colsmol": dict(n_tiles=5, tile_patches=16, out_dim=32),
          "colqwen": dict(grid_h=6, grid_w=6, max_rows=8, out_dim=32)}


def _cfgs(arch):
    return (dataclasses.replace(jax_config(arch), **SHRINK[arch]),
            dataclasses.replace(get_config(arch), **SHRINK[arch]))


def _bench(cfg, seed=0):
    return make_benchmark(cfg, (9, 7, 6), (2, 2, 2), n_topics_per_ds=4,
                          seed=seed)


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _compare(jvecs, tvecs):
    assert set(jvecs) == set(tvecs)
    for k in jvecs:
        a = np.asarray(jvecs[k])
        b = tvecs[k]
        assert a.shape == tuple(b.shape), k
        if k in ("initial",) or k.endswith("_mask"):
            np.testing.assert_array_equal(a.astype(np.float32), _np(b),
                                          err_msg=k)
        else:
            np.testing.assert_allclose(a.astype(np.float32), _np(b),
                                       err_msg=k, **POOLED_TOL)


@pytest.mark.parametrize("arch", ["colpali", "colsmol", "colqwen"])
def test_build_store_matches_repro(arch):
    jc, tc = _cfgs(arch)
    bench = _bench(jc)
    js = jax_build(jc, jnp.asarray(bench.pages),
                   jnp.asarray(bench.token_types))
    ts = build_store(tc, bench.pages, bench.token_types, device="cpu")
    assert ts.n_docs == js.n_docs and ts.store_dtype == js.store_dtype
    assert ts.vectors["initial"].dtype == torch.bfloat16
    _compare(js.vectors, ts.vectors)
    assert ts.dims() == js.dims() and ts.vec_dims() == js.vec_dims()
    assert ts.schema().names == JSchema.infer(js.vectors).names


@pytest.mark.parametrize("arch", ["colpali", "colqwen"])
def test_ingest_pipeline_fused_pooling_matches_repro_kernel(arch):
    """use_kernel=True pools through ``pool_pages_fused`` (its plain
    version on the CPU), held against repro's pipeline running the Pallas
    pooling kernel in interpret mode; per-page token types included."""
    jc, tc = _cfgs(arch)
    bench = _bench(jc, seed=1)
    tt = np.broadcast_to(bench.token_types, bench.pages.shape[:2]).copy()
    jp = JI.IngestPipeline.for_config(jc, use_kernel=True, impl="pallas",
                                      interpret=True)
    js = jp.index(jnp.asarray(bench.pages[:11]), jnp.asarray(tt[:11]))
    tp = TI.IngestPipeline(tc, use_kernel=True, device="cpu")
    ts = tp.index(bench.pages[:11], tt[:11])
    assert ts.n_docs == 11
    _compare(js.vectors, ts.vectors)


def test_buckets_match_repro():
    for n in (1, 7, 8, 9, 100, 256, 257, 1000):
        assert TI.batch_bucket(n) == JI.batch_bucket(n)
        assert TSG.bucket_capacity(n) == JSG.bucket_capacity(n)
    with pytest.raises(ValueError):
        TI.batch_bucket(0)


def test_from_numpy_round_trips_a_jax_store():
    jc, tc = _cfgs("colpali")
    bench = _bench(jc, seed=2)
    js = jax_build(jc, jnp.asarray(bench.pages),
                   jnp.asarray(bench.token_types))
    ts = from_numpy({k: np.asarray(v) for k, v in js.vectors.items()},
                    device="cpu")
    assert ts.n_docs == js.n_docs
    for k, v in js.vectors.items():
        a = np.asarray(v)
        b = ts.vectors[k]
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), k
        if b.dtype == torch.bfloat16:            # bit for bit
            np.testing.assert_array_equal(a.view(np.uint16),
                                          b.view(torch.int16).numpy()
                                          .view(np.uint16))
        else:
            np.testing.assert_array_equal(a, b.numpy())
    # ... and equals the port's own index of the same pages
    own = build_store(tc, bench.pages, bench.token_types, device="cpu")
    np.testing.assert_array_equal(_np(own.vectors["initial"]),
                                  _np(ts.vectors["initial"]))


def test_segmented_store_add_delete_translate():
    jc, tc = _cfgs("colpali")
    bench = _bench(jc, seed=3)
    ts = build_store(tc, bench.pages, bench.token_types, device="cpu")
    js = jax_build(jc, jnp.asarray(bench.pages),
                   jnp.asarray(bench.token_types))
    tstore = TSG.SegmentedStore.from_store(ts, capacity=32)
    jstore = JSG.SegmentedStore.from_store(js, capacity=32)
    for batch in (slice(0, 5), slice(5, 20)):    # the second one overflows
        sub = build_store(tc, bench.pages[batch], bench.token_types,
                          device="cpu")
        jsub = jax_build(jc, jnp.asarray(bench.pages[batch]),
                         jnp.asarray(bench.token_types))
        np.testing.assert_array_equal(tstore.add_pages(sub),
                                      jstore.add_pages(jsub))
    assert tstore.capacities == jstore.capacities == (32, 64)
    assert tstore.delete([3, 25, -1, 999]) == jstore.delete([3, 25, -1, 999])
    np.testing.assert_array_equal(tstore.slot_doc_ids(),
                                  jstore.slot_doc_ids())
    slots = np.asarray([[0, 3, 40, -1, 95]])
    np.testing.assert_array_equal(tstore.translate_slots(slots),
                                  jstore.translate_slots(slots))
    assert tstore.n_valid == jstore.n_valid
    for tseg, jseg in zip(tstore.segments, jstore.segments):
        for k in tseg.vectors:
            np.testing.assert_array_equal(
                _np(tseg.vectors[k]),
                np.asarray(jseg.vectors[k]).astype(_np(tseg.vectors[k])
                                                   .dtype), err_msg=k)
    sch = VectorSchema.infer(tstore.segments[0].vectors)
    assert sch.has_validity and sch["initial"].has_mask
    assert sch.names == ("global_pooling", "initial", "mean_pooling")
    assert mask_key("initial") in tstore.segments[0].vectors
    with pytest.raises(ValueError):
        tstore.vectors                          # two segments: no flat view
