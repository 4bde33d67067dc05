"""Token hygiene, every pooling strategy and the fused pooling operator
(``pool_pages_fused``'s CPU path, ``pool_pages_grouped``) against
``repro``: the jnp references and the Pallas pooling kernel in interpret
mode, for the three geometries — colpali (grid), colsmol (tiles) and
colqwen (dynamic) — at small widths.

Tolerance: rtol=1e-5, atol=1e-6 in f32 — the same float32 sums taken in
another order. Masks and matrices built from integers are exact.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core import hygiene as JH
from repro.core import pooling as JP
from repro.kernels.pooling import ops as JPO
from repro_torch.configs import get_config
from repro_torch.core import hygiene as TH
from repro_torch.core import pooling as TP
from repro_torch.kernels.pooling import ops as TPO

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
ARCHS = ("colpali", "colsmol", "colqwen")
SHRINK = {"colpali": dict(grid_h=8, grid_w=8, out_dim=32),
          "colsmol": dict(n_tiles=5, tile_patches=16, out_dim=32),
          "colqwen": dict(grid_h=6, grid_w=6, max_rows=8, out_dim=32)}


def _cfgs(arch):
    return (dataclasses.replace(jax_config(arch), **SHRINK[arch]),
            dataclasses.replace(get_config(arch), **SHRINK[arch]))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------

def test_hygiene_masks_and_zeroing():
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(3, 20, 16)).astype(np.float32)
    emb[1, 15:] = 0.0                                  # batch padding
    tt = np.zeros((20,), np.int32)
    tt[:4] = [1, 1, 2, 3]
    je, jm = JH.apply_hygiene(jnp.asarray(emb), jnp.asarray(tt))
    te, tm = TH.apply_hygiene(_t(emb), _t(tt))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))     # exact
    np.testing.assert_array_equal(
        TH.hygiene_mask(_t(emb)).numpy(), np.asarray(JH.hygiene_mask(
            jnp.asarray(emb))))


def test_require_visual_tail_rejects_what_repro_rejects():
    good = np.asarray([1, 1, 0, 0, 0, 0], np.int32)
    TH.require_visual_tail(good, 4)
    TH.require_visual_tail(_t(np.stack([good, good])), 4)
    for bad in ([1, 0, 0, 0, 0, 1], [0, 1, 0, 0, 0, 0]):
        with pytest.raises(ValueError):
            JH.require_visual_tail(np.asarray(bad), 4)
        with pytest.raises(ValueError):
            TH.require_visual_tail(np.asarray(bad), 4)


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------

def test_tile_row_col_means_masked():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 48, 8)).astype(np.float32)
    m = rng.random((2, 48)) > 0.3
    m[0, :12] = False                           # a fully masked group
    _close(TP.tile_mean_pool(_t(x), 4, 12, _t(m)),
           JP.tile_mean_pool(jnp.asarray(x), 4, 12, jnp.asarray(m)))
    _close(TP.row_mean_pool(_t(x), 6, 8, _t(m)),
           JP.row_mean_pool(jnp.asarray(x), 6, 8, jnp.asarray(m)))
    _close(TP.col_mean_pool(_t(x), 6, 8, _t(m)),
           JP.col_mean_pool(jnp.asarray(x), 6, 8, jnp.asarray(m)))
    _close(TP.row_mean_pool(_t(x), 6, 8),
           JP.row_mean_pool(jnp.asarray(x), 6, 8))


@pytest.mark.parametrize("k", [3, 5])
def test_conv1d_extend(k):
    rows = np.random.default_rng(2).normal(size=(2, 7, 8)).astype(np.float32)
    _close(TP.conv1d_extend(_t(rows), k), JP.conv1d_extend(jnp.asarray(rows),
                                                           k))


@pytest.mark.parametrize("kind", ["gaussian", "triangular", "uniform"])
def test_smoothing(kind):
    rng = np.random.default_rng(3)
    _close(TP.smoothing_weights(kind, 5), JP.smoothing_weights(kind, 5))
    rows = rng.normal(size=(2, 9, 8)).astype(np.float32)
    rm = rng.random((2, 9)) > 0.3
    _close(TP.smooth_same_length(_t(rows), kind, 3),
           JP.smooth_same_length(jnp.asarray(rows), kind, 3))
    _close(TP.smooth_same_length(_t(rows), kind, 3, _t(rm)),
           JP.smooth_same_length(jnp.asarray(rows), kind, 3,
                                 jnp.asarray(rm)))
    with pytest.raises(ValueError):
        TP.smoothing_weights("box", 3)


@pytest.mark.parametrize("h_eff,t_max", [(6, 8), (12, 5), (7, 7)])
def test_adaptive_row_pool_static_height(h_eff, t_max):
    rows = np.random.default_rng(4).normal(size=(12, 8)).astype(np.float32)
    tp, tm = TP.adaptive_row_pool(_t(rows), h_eff, t_max)
    jp, jm = JP.adaptive_row_pool(jnp.asarray(rows), h_eff, t_max)
    _close(tp, jp)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_global_pool():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 10, 8)).astype(np.float32)
    m = rng.random((3, 10)) > 0.4
    for b in range(3):
        _close(TP.global_pool(_t(x[b]), _t(m[b])),
               JP.global_pool(jnp.asarray(x[b]), jnp.asarray(m[b])))
    _close(TP.global_pool(_t(x), _t(m))[1],
           JP.global_pool(jnp.asarray(x[1]), jnp.asarray(m[1])))


@pytest.mark.parametrize("arch", ARCHS)
def test_pool_pages_batch_per_geometry(arch):
    jc, tc = _cfgs(arch)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, tc.n_patches, 32)).astype(np.float32)
    m = rng.random((4, tc.n_patches)) > 0.1
    tp, tm = TP.pool_pages_batch(tc, _t(x), _t(m))
    jp, jm = JP.pool_pages_batch(jc, jnp.asarray(x), jnp.asarray(m))
    assert tuple(tp.shape) == (4, tc.n_pooled, 32)
    _close(tp, jp)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # a single page through pool_page is the same operator
    p1, _ = TP.pool_page(tc, _t(x[2]), _t(m[2]))
    _close(p1, jp[2])


# ---------------------------------------------------------------------------
# pooling matrices and the fused operator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_pooling_matrices(arch):
    jc, tc = _cfgs(arch)
    _close(TPO.pooling_matrix(tc), JPO.pooling_matrix(jc))
    tm, tv = TPO.pooling_matrix_static(tc)
    jm, jv = JPO.pooling_matrix_static(jc)
    _close(tm, jm)
    np.testing.assert_array_equal(tv, jv)
    tg, tp2, tv2 = TPO.pooling_factors(tc)
    jg, jp2, jv2 = JPO.pooling_factors(jc)
    assert tg == jg
    _close(tp2, jp2)
    np.testing.assert_array_equal(tv2, jv2)
    for f, a in (("rowmean_matrix", (4, 3)), ("tile_matrix", (3, 4)),
                 ("conv1d_matrix", (6,)), ("adaptive_matrix", (9, 4))):
        np.testing.assert_array_equal(getattr(TPO, f)(*a),
                                      getattr(JPO, f)(*a))
    _close(TPO.smooth_matrix(6, "gaussian"), JPO.smooth_matrix(6, "gaussian"))


@pytest.mark.parametrize("arch", ARCHS)
def test_pool_pages_fused_and_grouped(arch):
    """The fused operator's CPU path (``pool_ref``, the kernel's plain
    version) against the Pallas pooling kernel in interpret mode, with a
    strided visual-tail view and a hygiene-style mask; the factored
    ``pool_pages_grouped`` against repro's."""
    jc, tc = _cfgs(arch)
    rng = np.random.default_rng(7)
    S = tc.n_patches
    full = rng.normal(size=(3, S + 4, 32)).astype(np.float32)
    x = full[:, 4:]
    m = np.ones((3, S), bool)
    m[1, -5:] = False
    pm, _ = TPO.pooling_matrix_static(tc)
    out = TPO.pool_pages_fused(_t(full)[:, 4:], _t(m), _t(pm))
    ref = JPO.pool_pages_fused(jnp.asarray(x), jnp.asarray(m, jnp.float32),
                               jnp.asarray(pm), impl="pallas",
                               interpret=True)
    _close(out, ref)
    g, p2, _ = TPO.pooling_factors(tc)
    _close(TPO.pool_pages_grouped(_t(x), _t(m), _t(p2), g),
           JPO.pool_pages_grouped(jnp.asarray(x), jnp.asarray(m),
                                  jnp.asarray(p2), g))
    raw = TPO.pool_pages_fused(_t(x), _t(m), _t(pm), l2_norm=False)
    _close(raw, JPO.pool_pages_fused(jnp.asarray(x),
                                     jnp.asarray(m, jnp.float32),
                                     jnp.asarray(pm), impl="ref",
                                     l2_norm=False))
