"""Cropping and per-page effective heights: the port against ``repro``.

- ``crop_box``, ``crop`` and ``effective_grid`` (numpy in both packages)
  give ``repro``'s boxes, crops and grids exactly on ``make_page_image``
  pages, a blank page included; ``crop_mask`` (torch here, jnp there) is
  exact;
- ``adaptive_row_pool`` with a per-page ``h_eff``, ``pool_pages_batch``
  and ``build_store(h_eff=)`` on ColQwen (dynamic) geometry are allclose
  to ``repro`` at rtol=1e-6, atol=1e-6 (f32 sums in another order); masks
  are exact. Mirrors ``tests/test_core.py``'s cropping and adaptive
  pooling tests.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core import cropping as JC
from repro.core import pooling as JP
from repro.data.synthetic import make_page_image as jax_page_image
from repro.retrieval.store import build_store as jax_build_store
from repro_torch.configs import get_config
from repro_torch.core import cropping as TC
from repro_torch.core import pooling as TP
from repro_torch.data.synthetic import make_page_image
from repro_torch.retrieval.store import build_store

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
QWEN = dict(grid_h=6, grid_w=6, max_rows=8, out_dim=16)


def _pages():
    """Three rendered pages (with and without page numbers, another
    margin) and a blank page, from one seed."""
    rng = np.random.default_rng(0)
    out = [make_page_image(rng)[0],
           make_page_image(rng, page_number=False)[0],
           make_page_image(rng, h=128, w=96, margin=0.25)[0],
           np.ones((64, 48), np.float32)]
    rgb = np.repeat(out[0][..., None], 3, axis=-1)
    rgb[..., 1] *= 0.5
    return out + [rgb]


def test_make_page_image_is_repros():
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    img, box = make_page_image(a)
    jimg, jbox = jax_page_image(b)
    np.testing.assert_array_equal(img, jimg)
    assert box == jbox


@pytest.mark.parametrize("i", range(5))
@pytest.mark.parametrize("thresh,strip", [(0.02, 0.0), (0.02, 0.05),
                                          (0.1, 0.1)])
def test_crop_box_and_crop_equal_repro(i, thresh, strip):
    img = _pages()[i]
    box = TC.crop_box(img, std_thresh=thresh, page_number_strip=strip)
    assert box == JC.crop_box(img, std_thresh=thresh,
                              page_number_strip=strip)
    np.testing.assert_array_equal(TC.crop(img, thresh, strip),
                                  JC.crop(img, thresh, strip))
    for patch, cap in ((14, None), (28, (4, 3)), (16, (32, 32))):
        assert TC.effective_grid(box, patch, cap) == \
            JC.effective_grid(box, patch, cap)


def test_crop_box_finds_the_margins():
    rng = np.random.default_rng(0)
    img, (mt, mb, ml, mr) = make_page_image(rng)
    t, b, l, r = TC.crop_box(img, std_thresh=0.02, page_number_strip=0.05)
    assert abs(t - mt) <= 2 and abs(l - ml) <= 2
    assert b <= mb + 2 and r <= mr + 2
    assert b < img.shape[0] * 0.9          # the footer strip is gone
    assert TC.crop_box(np.ones((64, 48), np.float32)) == (0, 64, 0, 48)


@pytest.mark.parametrize("i", range(5))
def test_crop_mask_equals_repro(i):
    img = _pages()[i]
    got = TC.crop_mask(torch.from_numpy(img))
    want = np.asarray(JC.crop_mask(jnp.asarray(img)))
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_crop_mask_is_the_box():
    img = _pages()[0]
    t, b, l, r = TC.crop_box(img)
    want = np.zeros(img.shape, bool)
    want[t:b, l:r] = True
    np.testing.assert_array_equal(TC.crop_mask(torch.from_numpy(img)).numpy(),
                                  want)


# ---------------------------------------------------------------------------
# per-page effective heights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t_max", [8, 5])
def test_adaptive_row_pool_per_page_h_eff(t_max):
    rng = np.random.default_rng(4)
    rows = rng.normal(size=(5, 12, 8)).astype(np.float32)
    h = np.asarray([12, 3, 7, 1, 8], np.int32)
    tp, tm = TP.adaptive_row_pool(torch.from_numpy(rows),
                                  torch.from_numpy(h), t_max)
    for b in range(5):
        jp, jm = JP.adaptive_row_pool(jnp.asarray(rows[b]), int(h[b]), t_max)
        np.testing.assert_allclose(tp[b].numpy(), np.asarray(jp), **TOL)
        np.testing.assert_array_equal(tm[b].numpy(), np.asarray(jm))
        # the per-page row equals the static-height call on that page
        sp, sm = TP.adaptive_row_pool(torch.from_numpy(rows[b]), int(h[b]),
                                      t_max)
        np.testing.assert_array_equal(tp[b].numpy(), sp.numpy())
        np.testing.assert_array_equal(tm[b].numpy(), sm.numpy())


def test_adaptive_pool_no_upsample():
    rows = torch.from_numpy(np.random.default_rng(0).normal(
        size=(32, 8)).astype(np.float32))
    _, mask = TP.adaptive_row_pool(rows, 20, 32)
    assert int(mask.sum()) == 20          # h_eff < T: NOT upsampled
    pooled2, mask2 = TP.adaptive_row_pool(rows, 32, 16)
    assert int(mask2.sum()) == 16         # h_eff > T: binned down
    np.testing.assert_allclose(pooled2[mask2].numpy(),
                               rows.numpy().reshape(16, 2, 8).mean(1),
                               rtol=1e-5)


def _qwen():
    return (dataclasses.replace(jax_config("colqwen"), **QWEN),
            dataclasses.replace(get_config("colqwen"), **QWEN))


def test_pool_pages_batch_per_page_h_eff_matches_repro():
    jc, tc = _qwen()
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, tc.n_patches, 16)).astype(np.float32)
    m = rng.random((4, tc.n_patches)) > 0.1
    h = np.asarray([6, 2, 4, 5], np.int32)
    tp, tm = TP.pool_pages_batch(tc, torch.from_numpy(x), torch.from_numpy(m),
                                 torch.from_numpy(h))
    jp, jm = JP.pool_pages_batch(jc, jnp.asarray(x), jnp.asarray(m),
                                 jnp.asarray(h))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm.numpy().sum(axis=1).tolist() == [6, 2, 4, 5]
    # None = every page at the full grid height
    tn, tnm = TP.pool_pages_batch(tc, torch.from_numpy(x), torch.from_numpy(m))
    tf, tfm = TP.pool_pages_batch(tc, torch.from_numpy(x), torch.from_numpy(m),
                                  torch.full((4,), tc.grid_h))
    np.testing.assert_allclose(tn.numpy(), tf.numpy(), **TOL)
    np.testing.assert_array_equal(tnm.numpy(), tfm.numpy())


@pytest.mark.parametrize("smooth", [None, "triangular"])
def test_build_store_h_eff_matches_repro(smooth):
    """``build_store(h_eff=)`` (and ``experimental_smooth``) on ColQwen
    geometry, from pages whose heights come from cropping."""
    jc, tc = _qwen()
    rng = np.random.default_rng(8)
    n = 5
    x = rng.normal(size=(n, tc.seq_len, tc.out_dim)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    tt = np.asarray([1] * tc.n_special + [0] * tc.n_patches, np.int32)
    imgs = [make_page_image(rng, h=int(rng.integers(40, 100)), w=60)[0]
            for _ in range(n)]
    h = np.asarray([TC.effective_grid(TC.crop_box(im), 14,
                                      (tc.grid_h, tc.grid_w))[0]
                    for im in imgs], np.int32)
    assert len(set(h.tolist())) > 1
    ts = build_store(tc, x, tt, h_eff=h, store_dtype=torch.float32,
                     experimental_smooth=smooth, device="cpu")
    js = jax_build_store(jc, jnp.asarray(x), jnp.asarray(tt),
                         h_eff=jnp.asarray(h), store_dtype=jnp.float32,
                         experimental_smooth=smooth)
    assert set(ts.vectors) == set(js.vectors)
    for k, v in ts.vectors.items():
        want = np.asarray(js.vectors[k])
        if v.dtype == torch.bool:
            np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), want, err_msg=k, **TOL)
    np.testing.assert_array_equal(
        ts.vectors["mean_pooling_mask"].numpy().sum(axis=1), h)
