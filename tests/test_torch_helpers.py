"""The last helpers and options of ``repro``'s surface, against
``repro``: ``hygiene.retained_counts``, ``pooling.global_matrix``,
``checkpoint.named_dtype``, ``IngestPipeline(min_bucket=)`` and
``cells.build_retriever_cell(stages=)``.

``min_bucket``: the fused ingest with a given smallest bucket leaves every
segment array equal to ``repro``'s with the same ``min_bucket`` (bools,
ids and int8 codes exactly, floats rtol 1e-6, atol 1e-6), capacities
included, and, where each bucket fits the headroom the batch leaves
(``min_bucket`` 2), bit for bit equal to ``index`` + ``add_pages`` on the
same pipeline; a bucket of 32 reserves a fresh segment where
``add_pages`` would not. ``named_dtype``: numpy's types as
``repro``'s; bfloat16 and float8 names, which numpy lacks, as the
unsigned integer of the same width (``repro`` returns the ``ml_dtypes``
type), by design. ``build_retriever_cell(stages=)`` on ``meta``:
``model_flops``, note and inputs equal to ``repro``'s.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.configs import ShapeSpec as JShapeSpec
from repro.configs import get_shapes as jax_shapes
from repro.core import hygiene as JHG
from repro.core import multistage as JM
from repro.kernels import pooling as JP
from repro.launch import cells as JC
from repro.retrieval import ingest as JI
from repro.retrieval.retriever import Retriever as JRetriever
from repro.training import checkpoint as JCK
from repro_torch.configs import ShapeSpec, get_shapes
from repro_torch.core import hygiene as HG
from repro_torch.core import multistage as TM
from repro_torch.kernels import pooling as TP
from repro_torch.launch import cells as TC
from repro_torch.retrieval.ingest import IngestPipeline, batch_bucket
from repro_torch.retrieval.retriever import Retriever
from repro_torch.retrieval.store import scale_key
from repro_torch.training import checkpoint as CK
from test_torch_ingest import JMINI, MINI, _pages, _types
from test_torch_cost_model import repro_trace_log_kept  # noqa: F401

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------
# retained_counts, global_matrix
# ----------------------------------------------------------------------

def test_retained_counts_matches_repro():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 12, 8)).astype(np.float32)
    x[1, 3:6] = 0.0                                  # batch padding
    tt = np.asarray([1, 1, 2] + [0] * 9, np.int32)
    _, mask = HG.apply_hygiene(torch.from_numpy(x), torch.from_numpy(tt))
    _, jmask = JHG.apply_hygiene(jnp.asarray(x), jnp.asarray(tt))
    got = HG.retained_counts(mask)
    want = np.asarray(JHG.retained_counts(jmask))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [9, 6, 9, 9, 9]


@pytest.mark.parametrize("s", [1, 7, 1024])
def test_global_matrix_matches_repro(s):
    got, want = TP.global_matrix(s), JP.global_matrix(s)
    assert got.dtype == want.dtype and got.shape == want.shape == (1, s)
    np.testing.assert_array_equal(got, want)
    assert "global_matrix" in TP.__all__


# ----------------------------------------------------------------------
# named_dtype
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["float32", "float16", "float64", "int8",
                                  "int32", "int64", "uint8", "uint16",
                                  "uint32", "bool"])
def test_named_dtype_numpy_names_match_repro(name):
    assert CK.named_dtype(name) == JCK.named_dtype(name) == np.dtype(name)


@pytest.mark.parametrize("name", ["bfloat16", "float8_e4m3fn",
                                  "float8_e5m2"])
def test_named_dtype_extended_names_are_their_bit_patterns(name):
    """numpy lacks these; the port gives the unsigned integer of the same
    width, the form its checkpoint stores their bits in."""
    got, want = CK.named_dtype(name), JCK.named_dtype(name)
    assert got.kind == "u" and got.itemsize == want.itemsize
    assert got.itemsize == getattr(torch, name).itemsize


def test_named_dtype_unknown_name_raises():
    with pytest.raises(TypeError, match="unknown dtype name"):
        CK.named_dtype("float7")


def test_named_dtype_reads_a_stored_bfloat16_leaf(tmp_path):
    """A bf16 leaf's recorded name maps to the stored array's own dtype."""
    x = torch.randn(3, 4).to(torch.bfloat16)
    CK.save(str(tmp_path), 0, [x])
    meta = CK.load_meta(str(tmp_path), 0)
    assert meta["dtypes"] == ["bfloat16"]
    stored, _ = CK._stored(x)
    assert CK.named_dtype(meta["dtypes"][0]) == stored.dtype
    got, _ = CK.restore(str(tmp_path), step=0, device="cpu")
    assert torch.equal(got[0], x)


# ----------------------------------------------------------------------
# IngestPipeline(min_bucket=)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("min_bucket", [1, 4, 32])
def test_batch_bucket_min_matches_repro(min_bucket):
    for n in (1, 3, 5, 8, 17, 100, 300):
        assert batch_bucket(n, min_bucket) == JI.batch_bucket(n, min_bucket)


@pytest.mark.parametrize("geom", ["grid", "dynamic"])
@pytest.mark.parametrize("min_bucket", [2, 32])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_min_bucket_ingest_matches_repro(geom, min_bucket, use_kernel):
    cfg, jcfg = MINI[geom], JMINI[geom]
    tt = _types(cfg)
    pipe = IngestPipeline.for_config(cfg, use_kernel=use_kernel,
                                     min_bucket=min_bucket, device="cpu")
    assert pipe.min_bucket == min_bucket
    assert pipe is IngestPipeline.for_config(
        cfg, use_kernel=use_kernel, min_bucket=min_bucket, device="cpu")
    assert pipe is not IngestPipeline.for_config(cfg, use_kernel=use_kernel,
                                                 device="cpu")
    jpipe = JI.IngestPipeline.for_config(jcfg, use_kernel=use_kernel,
                                         min_bucket=min_bucket)
    seed_pages = _pages(cfg, 3, 0)
    r1 = Retriever(pipe.index(seed_pages, tt), capacity=16, ingest=pipe,
                   device="cpu")
    r2 = Retriever(pipe.index(seed_pages, tt), capacity=16, device="cpu")
    jr = JRetriever(jpipe.index(jnp.asarray(seed_pages), jnp.asarray(tt)),
                    capacity=16, ingest=jpipe)
    for seed, n in ((1, 1), (2, 5), (3, 3), (4, 9)):
        pages = _pages(cfg, n, seed)
        assert pipe._padded(pages, tt)[0].shape[0] == batch_bucket(
            n, min_bucket)
        ids1 = r1.ingest(pages, tt)
        ids2 = r2.upsert(pipe.index(pages, tt))
        jids = jr.ingest(jnp.asarray(pages), jnp.asarray(tt))
        np.testing.assert_array_equal(ids1, jids)
        if min_bucket <= 8:
            # the bucket fits the headroom add_pages needs, so both
            # paths fill the same segments
            np.testing.assert_array_equal(ids1, ids2)
    assert r1.store.capacities == jr.store.capacities
    if min_bucket <= 8:
        for s1, s2 in zip(r1.store.segments, r2.store.segments):
            for k in s1.vectors:
                assert torch.equal(s1.vectors[k], s2.vectors[k]), k
    for s1, js in zip(r1.store.segments, jr.store.segments):
        assert s1.n_docs == js.n_docs
        np.testing.assert_array_equal(s1.doc_ids, js.doc_ids)
        assert set(s1.vectors) == set(js.vectors)
        for k, v in s1.vectors.items():
            want = np.asarray(js.vectors[k])
            if k == "doc_filter":
                want = want.view(np.int32)
            if v.dtype in (torch.bool, torch.int8, torch.int32):
                np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
            else:
                np.testing.assert_allclose(
                    v.float().numpy(), want.astype(np.float32), err_msg=k,
                    **TOL)


# ----------------------------------------------------------------------
# build_retriever_cell(stages=)
# ----------------------------------------------------------------------

def _cascades(M, shape):
    return {"three": M.three_stage(4 * shape.prefetch_k, shape.prefetch_k,
                                   shape.top_k),
            "global": (M.Stage("global_pooling", shape.prefetch_k),
                       M.Stage("initial", shape.top_k)),
            "one": M.one_stage(shape.top_k)}


@pytest.mark.parametrize("arch", ["colpali", "colqwen"])
@pytest.mark.parametrize("variant", ["base", "opt", "stage1"])
@pytest.mark.parametrize("cascade", ["three", "global", "one", None])
def test_retriever_cell_stages_match_repro(arch, variant, cascade):
    """On ``meta``: ``model_flops``, the note naming the cascade's
    vectors, and the store's keys, shapes and dtypes equal ``repro``'s;
    ``stages=None`` keeps the variant's cascade."""
    shape = get_shapes(arch)["search_1m"]
    jshape = jax_shapes(arch)["search_1m"]
    assert isinstance(shape, ShapeSpec) and isinstance(jshape, JShapeSpec)
    st = None if cascade is None else _cascades(TM, shape)[cascade]
    jst = None if cascade is None else _cascades(JM, jshape)[cascade]
    got = TC.build_retriever_cell(arch, shape, "meta", variant, stages=st)
    want = JC.build_retriever_cell(arch, jshape, None, variant, stages=jst)
    assert got.model_flops == want.model_flops
    assert got.note == want.note
    if cascade is not None:
        assert got.note == f"stages={[s.vector for s in st]}"
    store, jstore = got.args[0], want.args[0]
    assert set(store) == set(jstore)
    first = (st or TC.search_stages(shape, variant))[0].vector
    for k, v in jstore.items():
        want_shape = tuple(v.shape)
        if k == scale_key(first) and store[first].ndim == 2:
            # a single-vector scan stage's int8 scales: one per vector,
            # [N], as ``quantize_int8`` makes them; ``repro``'s cell
            # declares its store's ``shape[:2]``, [N, d], there
            want_shape = want_shape[:1]
        assert tuple(store[k].shape) == want_shape, k
        assert store[k].device.type == "meta"
