"""The port's configs, synthetic benchmark and ranking metrics are its own
copies of ``repro``'s: identical values for the same seed."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import synthetic as JS
from repro_torch.configs import PAPER_ARCHS, get_config
from repro_torch.data import synthetic as TS

torch.set_num_threads(1)

ARCHS = ("colpali", "colsmol", "colqwen")


@pytest.mark.parametrize("arch", ARCHS)
def test_retriever_configs_identical(arch):
    a, b = jax_config(arch), get_config(arch)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for prop in ("family", "n_patches", "seq_len", "n_pooled"):
        assert getattr(a, prop) == getattr(b, prop), prop
    assert set(PAPER_ARCHS) == set(ARCHS)
    assert get_config("gemma2-9b").family == "lm"
    from repro.configs import base as JB
    from repro_torch.configs import GNN_ARCHS
    from repro_torch.configs import base as TB
    ja, ta = jax_config("equiformer-v2"), get_config("equiformer-v2")
    assert dataclasses.asdict(ja) == dataclasses.asdict(ta)
    assert ta.family == "gnn" and GNN_ARCHS == ("equiformer-v2",)
    assert (ja.n_sph, ja.n_sph_m) == (ta.n_sph, ta.n_sph_m) == (49, 29)
    assert [(s.name, s.kind, s.dims) for s in TB.GNN_SHAPES] == [
        (s.name, s.kind, s.dims) for s in JB.GNN_SHAPES]
    # the cells' registry: shapes of every arch, the cell list, the arch
    # tuples in ``repro``'s order
    from repro.configs import registry as JREG
    from repro_torch.configs import registry as TREG
    assert [(s.name, s.kind, s.dims) for s in TB.RETRIEVER_SHAPES] == [
        (s.name, s.kind, s.dims) for s in JB.RETRIEVER_SHAPES]
    assert TREG.ASSIGNED_ARCHS == JREG.ASSIGNED_ARCHS
    assert TREG.ALL_ARCHS == JREG.ALL_ARCHS
    assert TREG.get_cells() == JREG.get_cells()
    assert TREG.get_cells(TREG.ALL_ARCHS) == JREG.get_cells(JREG.ALL_ARCHS)
    for a in TREG.ALL_ARCHS:
        assert [(s.name, s.kind, s.dims) for s in
                TREG.get_shapes(a).values()] == [
            (s.name, s.kind, s.dims) for s in JREG.get_shapes(a).values()], a
    assert [(s.name, s.kind, s.dims) for s in TREG.get_shapes(arch).values()
            ] == [(s.name, s.kind, s.dims) for s in TB.RETRIEVER_SHAPES]


@pytest.mark.parametrize("arch", ("dcn-v2", "autoint", "bert4rec",
                                  "dlrm-mlperf"))
def test_recsys_configs_identical(arch):
    from repro.configs import base as JB
    from repro_torch.configs import RECSYS_ARCHS
    from repro_torch.configs import base as TB
    a, b = jax_config(arch), get_config(arch)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.family == b.family == "recsys"
    assert a.n_params() == b.n_params()
    assert arch in RECSYS_ARCHS
    assert TB.CRITEO_KAGGLE_VOCABS == JB.CRITEO_KAGGLE_VOCABS
    assert TB.CRITEO_TB_VOCABS == JB.CRITEO_TB_VOCABS
    assert [(s.name, s.kind, s.dims) for s in TB.RECSYS_SHAPES] == [
        (s.name, s.kind, s.dims) for s in JB.RECSYS_SHAPES]
    assert [(f.name, f.default) for f in dataclasses.fields(
        TB.RecsysConfig)] == [(f.name, f.default) for f in
                              dataclasses.fields(JB.RecsysConfig)]


def _small(get, arch):
    shrink = {"colpali": dict(grid_h=8, grid_w=8, out_dim=32),
              "colsmol": dict(n_tiles=5, tile_patches=16, out_dim=32),
              "colqwen": dict(grid_h=6, grid_w=6, max_rows=8, out_dim=32)}
    return dataclasses.replace(get(arch), **shrink[arch])


@pytest.mark.parametrize("arch,seed", [("colpali", 0), ("colsmol", 3),
                                       ("colqwen", 7)])
def test_make_benchmark_identical(arch, seed):
    kw = dict(n_pages_per_ds=(12, 9, 7), queries_per_ds=(4, 3, 3),
              n_topics_per_ds=5, seed=seed)
    a = JS.make_benchmark(_small(jax_config, arch), **kw)
    b = TS.make_benchmark(_small(get_config, arch), **kw)
    for f in ("pages", "token_types", "queries", "query_mask",
              "dataset_of_page", "dataset_of_query"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)   # exact: same numpy
    assert a.qrels == b.qrels


def test_ranking_metrics_identical():
    rng = np.random.default_rng(0)
    ranked = rng.permutation(40)[None].repeat(6, 0)
    for r in ranked:
        rng.shuffle(r)
    ranked[2, :3] = -1                           # filler ids never match
    qrels = [{int(i): int(rng.integers(1, 3))
              for i in rng.choice(40, 4, replace=False)} for _ in range(6)]
    qrels[5] = {}
    for k in (1, 5, 10, 100):
        for r, q in zip(ranked, qrels):
            assert JS.ndcg_at_k(r, q, k) == TS.ndcg_at_k(r, q, k)
            assert JS.recall_at_k(r, q, k) == TS.recall_at_k(r, q, k)
    assert (JS.evaluate_ranking(ranked, qrels, ks=(5, 10))
            == TS.evaluate_ranking(ranked, qrels, ks=(5, 10)))


def test_make_page_image_identical():
    a = JS.make_page_image(np.random.default_rng(5), h=64, w=48)
    b = TS.make_page_image(np.random.default_rng(5), h=64, w=48)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]
