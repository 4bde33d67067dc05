"""Training-free, model-aware spatial pooling (paper §2.3).

Plain PyTorch, parameter-free and mask-aware (composing with token
hygiene, §2.1). Every function takes any number of leading batch
dimensions, which replaces the JAX package's ``vmap``. The fused pooling
kernel in ``repro_torch.kernels.pooling`` implements the index-time hot
path; these are the reference semantics it is tested against.

Strategies (paper section in parens):
- ``tile_mean_pool``       ColSmol tile-level mean, Eq. 2       (§2.3.1)
- ``row_mean_pool``        ColPali row-wise mean, Eq. 3         (§2.3.2)
- ``conv1d_extend``        uniform sliding window, N->N+2, Eq.4 (§2.3.2)
- ``smooth_same_length``   Gaussian/Triangular N->N, Eq. 5      (§2.3.3)
- ``adaptive_row_pool``    dynamic-resolution row binning       (§2.3.3)
- ``global_pool``          single-vector summary (3-stage cascade, §2.4)
"""
from __future__ import annotations

import torch


def _masked_mean(x: torch.Tensor, mask: torch.Tensor | None,
                 dim: int) -> torch.Tensor:
    """Mean over ``dim`` counting only mask-valid rows (mask broadcasts)."""
    if mask is None:
        return x.mean(dim=dim)
    m = mask.to(x.dtype)
    while m.ndim < x.ndim:
        m = m[..., None]
    num = (x * m).sum(dim=dim)
    den = m.sum(dim=dim).clamp_min(1.0)
    return num / den


# ---------------------------------------------------------------------------
# §2.3.1 ColSmol: tile-level mean pooling (Eq. 2)
# ---------------------------------------------------------------------------

def tile_mean_pool(x: torch.Tensor, n_tiles: int, tile_patches: int,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """[..., n_tiles*P, d] -> [..., n_tiles, d]: mean within each tile."""
    P = tile_patches
    if x.shape[-2] != n_tiles * P:
        raise ValueError(f"{tuple(x.shape)} is not {n_tiles} tiles of {P}")
    xg = x.reshape(x.shape[:-2] + (n_tiles, P, x.shape[-1]))
    mg = None if mask is None else mask.reshape(
        mask.shape[:-1] + (n_tiles, P))
    return _masked_mean(xg, mg, dim=-2)


# ---------------------------------------------------------------------------
# §2.3.2 ColPali: row-wise mean pooling (Eq. 3)
# ---------------------------------------------------------------------------

def row_mean_pool(x: torch.Tensor, grid_h: int, grid_w: int,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """[..., H*W, d] -> [..., H, d]: mean across columns of the grid."""
    if x.shape[-2] != grid_h * grid_w:
        raise ValueError(f"{tuple(x.shape)} is not a {grid_h}x{grid_w} grid")
    xg = x.reshape(x.shape[:-2] + (grid_h, grid_w, x.shape[-1]))
    mg = None if mask is None else mask.reshape(
        mask.shape[:-1] + (grid_h, grid_w))
    return _masked_mean(xg, mg, dim=-2)


def col_mean_pool(x: torch.Tensor, grid_h: int, grid_w: int,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """[..., H*W, d] -> [..., W, d]: column means (ablation variant)."""
    xg = x.reshape(x.shape[:-2] + (grid_h, grid_w, x.shape[-1]))
    mg = None if mask is None else mask.reshape(
        mask.shape[:-1] + (grid_h, grid_w))
    return _masked_mean(xg, mg, dim=-3)


# ---------------------------------------------------------------------------
# §2.3.2 conv1d sliding-window pooling with boundary extension (Eq. 4)
# ---------------------------------------------------------------------------

def conv1d_extend(rows: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Uniform sliding window over row vectors, N -> N + 2r outputs.

    Output i averages input rows ``W_i = {j : |j - (i - r)| <= r} ∩ [0, N)``
    (Eq. 4). With k=3 (r=1) this yields N+2 vectors; boundary windows are
    truncated and averaged over their valid support.
    """
    r = k // 2
    n = rows.shape[-2]
    idx = torch.arange(n + 2 * r, device=rows.device)[:, None] - r
    offs = torch.arange(-r, r + 1, device=rows.device)[None, :]
    j = idx + offs                                      # [N+2r, k]
    valid = (j >= 0) & (j < n)
    jc = j.clamp(0, n - 1)
    win = rows[..., jc, :]                              # [..., N+2r, k, d]
    w = valid.to(rows.dtype)[..., None]
    return (win * w).sum(dim=-2) / w.sum(dim=-2).clamp_min(1.0)


# ---------------------------------------------------------------------------
# §2.3.3 ColQwen: weighted same-length smoothing (Eq. 5)
# ---------------------------------------------------------------------------

def smoothing_weights(kind: str, k: int,
                      dtype=torch.float32) -> torch.Tensor:
    """Window weights w_delta for delta in [-r, r]."""
    r = k // 2
    d = torch.arange(-r, r + 1).abs().to(dtype)
    if kind == "gaussian":
        sigma = max(0.5, r / 2.0)
        w = torch.exp(-(d ** 2) / (2.0 * sigma ** 2))
    elif kind == "triangular":
        w = (r + 1.0) - d
    elif kind == "uniform":
        w = torch.ones_like(d)
    else:
        raise ValueError(f"unknown smoothing kind {kind!r}")
    return w


def smooth_same_length(rows: torch.Tensor, kind: str = "gaussian",
                       k: int = 3,
                       row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Same-length (N->N) weighted smoothing with boundary renormalisation.

    Boundary indices outside [0, N) — and mask-invalid rows — are skipped
    and the weights renormalised (Eq. 5).
    """
    r = k // 2
    n = rows.shape[-2]
    w = smoothing_weights(kind, k, dtype=rows.dtype).to(rows.device)
    i = torch.arange(n, device=rows.device)[:, None]
    j = i + torch.arange(-r, r + 1, device=rows.device)[None, :]  # [N, k]
    valid = (j >= 0) & (j < n)
    jc = j.clamp(0, n - 1)
    if row_mask is not None:
        valid = valid & row_mask[..., jc]
    win = rows[..., jc, :]                                  # [..., N, k, d]
    wv = w[None, :] * valid.to(rows.dtype)                  # [..., N, k]
    z = wv.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return torch.einsum("...nk,...nkd->...nd", wv / z, win)


# ---------------------------------------------------------------------------
# §2.3.3 adaptive row-mean pooling for dynamic resolution
# ---------------------------------------------------------------------------

def adaptive_row_pool(rows: torch.Tensor, h_eff, t_max: int) -> tuple:
    """Down-sample up to ``h_eff`` valid rows to at most ``t_max`` outputs.

    ``rows`` is [..., H_max, d] with the first ``h_eff`` rows of each page
    valid. ``h_eff`` is one row count for every page (an int) or a per-page
    int tensor of ``rows``' leading shape (e.g. [B], the height each page's
    crop gives). Rows go to evenly spaced bins ``b(j) = floor(j * T / h)``
    with ``T = min(h, t_max)``, rows past ``h`` to an overflow bin that is
    dropped; pages with h_eff < t_max are NOT upsampled: trailing bins are
    empty and masked.

    Returns (pooled [..., t_max, d], out_mask [t_max] bool for an int
    ``h_eff``, else [..., t_max]).
    """
    j = torch.arange(rows.shape[-2], device=rows.device)
    h = torch.as_tensor(h_eff, device=rows.device).long()[..., None]
    t = h.clamp_max(t_max)
    bins = torch.where(j < h, (j * t) // h.clamp_min(1), t_max)  # [.., H]
    one_hot = (bins[..., :, None] == torch.arange(
        t_max, device=rows.device)).to(rows.dtype)               # [.., H, T]
    num = torch.einsum("...jd,...jt->...td", rows, one_hot)
    cnt = one_hot.sum(dim=-2)                                 # [..., t_max]
    pooled = num / cnt.clamp_min(1.0)[..., :, None]
    return pooled, cnt > 0


# ---------------------------------------------------------------------------
# §2.4 global pooling (stage-0 of the 3-stage cascade)
# ---------------------------------------------------------------------------

def global_pool(x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """[..., D, d] -> [..., d] single-vector summary (masked mean,
    L2-normalised)."""
    g = _masked_mean(x, mask, dim=-2)
    return g / torch.linalg.vector_norm(g, dim=-1,
                                        keepdim=True).clamp_min(1e-9)


# ---------------------------------------------------------------------------
# Model-aware dispatch
# ---------------------------------------------------------------------------

def pool_page(cfg, patches: torch.Tensor,
              mask: torch.Tensor | None = None, h_eff=None) -> tuple:
    """Apply the model-aware pooling stack for a RetrieverConfig.

    ``patches`` holds visual tokens only ([..., n_patches, d]). Returns
    (pooled [..., n_pooled, d], pooled_mask [..., n_pooled] bool).
    ``h_eff`` (dynamic geometry only) is the effective grid height: an
    int, or a per-page int tensor of the leading shape; None pools at the
    full static grid height.
    """
    lead = patches.shape[:-2]
    if cfg.geometry == "tiles":
        pooled = tile_mean_pool(patches, cfg.n_tiles, cfg.tile_patches, mask)
        pmask = torch.ones(pooled.shape[:-1], dtype=torch.bool,
                           device=patches.device)
    elif cfg.geometry == "grid":
        rows = row_mean_pool(patches, cfg.grid_h, cfg.grid_w, mask)
        if cfg.smooth == "conv1d":
            pooled = conv1d_extend(rows, k=3)
        elif cfg.smooth in ("gaussian", "triangular"):
            pooled = smooth_same_length(rows, cfg.smooth, k=3)
        else:
            pooled = rows
        pmask = torch.ones(pooled.shape[:-1], dtype=torch.bool,
                           device=patches.device)
    elif cfg.geometry == "dynamic":
        rows = row_mean_pool(patches, cfg.grid_h, cfg.grid_w, mask)
        if cfg.smooth in ("gaussian", "triangular"):
            rows = smooth_same_length(rows, cfg.smooth, k=3)
        h = cfg.grid_h if h_eff is None else h_eff
        pooled, pm = adaptive_row_pool(rows, h, cfg.max_rows)
        pmask = pm.expand(lead + pm.shape[-1:])
    else:
        raise ValueError(cfg.geometry)
    # pooled vectors are re-L2-normalised so MaxSim stays cosine-like
    pooled = pooled / torch.linalg.vector_norm(
        pooled, dim=-1, keepdim=True).clamp_min(1e-9)
    return pooled, pmask


def pool_pages_batch(cfg, patches: torch.Tensor, mask: torch.Tensor,
                     h_eff: torch.Tensor | None = None) -> tuple:
    """``pool_page`` over a batch [B, n_patches, d] + mask [B, n_patches]
    with an optional per-page effective height ``h_eff`` [B] int (None:
    every page at the full static grid height): the one batch entry point
    of the index paths' reference mode."""
    return pool_page(cfg, patches, mask, h_eff)
