"""Empty-region cropping (paper §2.2).

Detect and remove low-variance border regions (blank margins) using
row/column standard-deviation thresholds, with configurable page-number
strip removal. Host-side preprocessing runs the numpy path (images have
data-dependent crop shapes); ``crop_mask`` returns a crop *mask* of the
image's own shape on a torch tensor's device.

For fixed-resolution encoders the tighter crop focuses capacity on content;
for dynamic-resolution encoders it additionally reduces the number of
patches/tiles — i.e. fewer stored vectors per page (D) and fewer inner
products at search time (Eq. 1).
"""
from __future__ import annotations

import numpy as np
import torch


def _gray(img):
    if img.ndim == 3:
        return img.mean(axis=-1)
    return img


def crop_box(img: np.ndarray, std_thresh: float = 0.02,
             page_number_strip: float = 0.0) -> tuple[int, int, int, int]:
    """Compute (top, bottom, left, right) content bounding box (numpy).

    Rows/columns whose pixel std is below ``std_thresh`` (relative to the
    image's dynamic range) are considered empty. ``page_number_strip``
    removes the bottom fraction of the page (page numbers / footers) before
    scanning, when > 0.
    """
    g = _gray(np.asarray(img, np.float32))
    h, w = g.shape
    if page_number_strip > 0:
        g = g[: int(h * (1.0 - page_number_strip))]
        h = g.shape[0]
    rng = max(float(g.max() - g.min()), 1e-6)
    gn = (g - g.min()) / rng
    row_std = gn.std(axis=1)
    col_std = gn.std(axis=0)
    rows = np.where(row_std > std_thresh)[0]
    cols = np.where(col_std > std_thresh)[0]
    if len(rows) == 0 or len(cols) == 0:      # fully blank page: keep as-is
        return 0, h, 0, w
    return int(rows[0]), int(rows[-1]) + 1, int(cols[0]), int(cols[-1]) + 1


def crop(img: np.ndarray, std_thresh: float = 0.02,
         page_number_strip: float = 0.0) -> np.ndarray:
    t, b, l, r = crop_box(img, std_thresh, page_number_strip)
    return np.asarray(img)[t:b, l:r]


def crop_mask(img: torch.Tensor, std_thresh: float = 0.02) -> torch.Tensor:
    """Static-shape variant: bool [H, W] content mask (True = keep), on
    ``img``'s device. Population std (``correction=0``), as numpy's."""
    g = img.float()
    if g.ndim == 3:
        g = g.mean(dim=-1)
    rng = (g.max() - g.min()).clamp_min(1e-6)
    gn = (g - g.min()) / rng
    row_keep = gn.std(dim=1, correction=0) > std_thresh
    col_keep = gn.std(dim=0, correction=0) > std_thresh

    # bounding-box closure: everything between first/last kept row/col
    def _bbox(keep):
        idx = torch.arange(keep.shape[0], device=keep.device)
        lo = torch.where(keep, idx, keep.shape[0]).min()
        hi = torch.where(keep, idx, -1).max()
        return (idx >= lo) & (idx <= hi)

    return _bbox(row_keep)[:, None] & _bbox(col_keep)[None, :]


def effective_grid(box: tuple[int, int, int, int], patch: int,
                   grid_cap: tuple[int, int] | None = None) -> tuple[int, int]:
    """Patch-grid dims a dynamic-resolution encoder would produce for a crop."""
    t, b, l, r = box
    h = max(1, (b - t + patch - 1) // patch)
    w = max(1, (r - l + patch - 1) // patch)
    if grid_cap is not None:
        h, w = min(h, grid_cap[0]), min(w, grid_cap[1])
    return h, w
