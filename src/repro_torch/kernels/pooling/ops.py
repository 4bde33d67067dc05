"""Pooling matrices and the wrapper of the fused pooling CUDA kernel.

Every training-free strategy is one linear operator over the patch-token
axis, built here as a numpy [n_out, S] matrix; strategy composition (e.g.
conv1d over row means) is matrix composition with the kernel's single
mask-normalisation — exactly the two-step reference whenever the hygiene
mask is uniform within a pooling group (padding lives outside the
visual-token range).

``pool_pages_fused`` launches the hand-written kernel (``csrc/pool.cu``)
for CUDA tensors and runs the plain version ``pool_ref`` for CPU
tensors. The kernel skips P's structural zeros, which gives the same
result for finite pages (a page holding inf or NaN where its weight is
zero gives NaN in the plain version only). ``pool_pages_grouped`` is the factored evaluation of the same
operator (group reshape-sum + a small stage-2 matrix).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.pooling import smoothing_weights
from repro_torch.kernels import build
from repro_torch.kernels import dispatch as DSP
from repro_torch.kernels.dispatch import full_f32


def rowmean_matrix(grid_h: int, grid_w: int) -> np.ndarray:
    """[H, H*W] indicator: masked mean across each grid row (Eq. 3)."""
    p = np.zeros((grid_h, grid_h * grid_w), np.float32)
    for h in range(grid_h):
        p[h, h * grid_w:(h + 1) * grid_w] = 1.0
    return p


def tile_matrix(n_tiles: int, tile_patches: int) -> np.ndarray:
    """[T, T*P] indicator: masked mean within each tile group (Eq. 2)."""
    p = np.zeros((n_tiles, n_tiles * tile_patches), np.float32)
    for t in range(n_tiles):
        p[t, t * tile_patches:(t + 1) * tile_patches] = 1.0
    return p


def conv1d_matrix(n: int, k: int = 3) -> np.ndarray:
    """[N+2r, N] uniform sliding window with boundary extension (Eq. 4)."""
    r = k // 2
    p = np.zeros((n + 2 * r, n), np.float32)
    for i in range(n + 2 * r):
        for off in range(-r, r + 1):
            j = (i - r) + off
            if 0 <= j < n:
                p[i, j] = 1.0
    return p


def smooth_matrix(n: int, kind: str, k: int = 3) -> np.ndarray:
    """[N, N] same-length weighted smoothing (Eq. 5)."""
    r = k // 2
    w = smoothing_weights(kind, k).numpy()
    p = np.zeros((n, n), np.float32)
    for i in range(n):
        for di, off in enumerate(range(-r, r + 1)):
            j = i + off
            if 0 <= j < n:
                p[i, j] = w[di]
    return p


def adaptive_matrix(h: int, t_max: int) -> np.ndarray:
    """[T, H] evenly spaced row binning for a static h."""
    t = min(h, t_max)
    p = np.zeros((t, h), np.float32)
    for j in range(h):
        p[(j * t) // h, j] = 1.0
    return p


def global_matrix(s: int) -> np.ndarray:
    """[1, S] ones: the single-vector (global) pooling row over S
    tokens."""
    return np.ones((1, s), np.float32)


def pooling_matrix(cfg) -> np.ndarray:
    """Compose the model-aware pooling stack into one matrix [n_pooled, S]."""
    if cfg.geometry == "tiles":
        return tile_matrix(cfg.n_tiles, cfg.tile_patches)
    base = rowmean_matrix(cfg.grid_h, cfg.grid_w)
    if cfg.geometry == "grid":
        if cfg.smooth == "conv1d":
            return conv1d_matrix(cfg.grid_h) @ base
        if cfg.smooth in ("gaussian", "triangular"):
            return smooth_matrix(cfg.grid_h, cfg.smooth) @ base
        return base
    if cfg.geometry == "dynamic":
        if cfg.smooth in ("gaussian", "triangular"):
            base = smooth_matrix(cfg.grid_h, cfg.smooth) @ base
        return adaptive_matrix(cfg.grid_h, cfg.max_rows) @ base
    raise ValueError(cfg.geometry)


def pooling_matrix_static(cfg) -> tuple:
    """``pooling_matrix`` padded to the store's static pooled-vector count:
    (matrix [cfg.n_pooled, n_patches], row_valid [cfg.n_pooled] bool).
    Zero rows reproduce the dynamic geometry's empty trailing slots
    (0-vectors, mask False)."""
    p = pooling_matrix(cfg)
    n_out = cfg.n_pooled
    if p.shape[0] < n_out:
        p = np.concatenate(
            [p, np.zeros((n_out - p.shape[0], p.shape[1]), p.dtype)])
    return p, p.sum(axis=1) > 0


def pooling_factors(cfg) -> tuple:
    """Factor the composed stack as ``P = P2 @ G``: a uniform GROUP
    indicator ``G`` [n_groups, S] (grid rows / tile groups, evaluated as a
    reshape-sum) followed by a small dense matrix ``P2``
    [cfg.n_pooled, n_groups]. Returns (n_groups, P2, row_valid);
    ``P2 @ G == pooling_matrix_static(cfg)[0]`` exactly."""
    if cfg.geometry == "tiles":
        g = cfg.n_tiles
        p2 = np.eye(g, dtype=np.float32)
    else:
        g = cfg.grid_h
        if cfg.geometry == "grid":
            if cfg.smooth == "conv1d":
                p2 = conv1d_matrix(g)
            elif cfg.smooth in ("gaussian", "triangular"):
                p2 = smooth_matrix(g, cfg.smooth)
            else:
                p2 = np.eye(g, dtype=np.float32)
        else:                                  # dynamic
            p2 = adaptive_matrix(g, cfg.max_rows)
            if cfg.smooth in ("gaussian", "triangular"):
                p2 = p2 @ smooth_matrix(g, cfg.smooth)
    n_out = cfg.n_pooled
    if p2.shape[0] < n_out:
        p2 = np.concatenate(
            [p2, np.zeros((n_out - p2.shape[0], p2.shape[1]), p2.dtype)])
    return g, np.asarray(p2, np.float32), p2.sum(axis=1) > 0


def pool_pages_grouped(x: torch.Tensor, mask: torch.Tensor,
                       p2: torch.Tensor, n_groups: int,
                       l2_norm: bool = True) -> torch.Tensor:
    """Factored evaluation of the fused pooling operator:
    x [B,S,d] + mask [B,S] + p2 [n_out, n_groups] -> pooled [B,n_out,d].

    Same masked single-normalisation semantics as
    ``pool_ref(x, mask, p2 @ G)``: numerator and denominator both factor
    through the group sums."""
    full_f32()
    B, S, d = x.shape
    w = S // n_groups
    if S != n_groups * w:
        raise ValueError(f"S={S} is not {n_groups} equal groups")
    m = mask.float()
    xf = x.float() * m[..., None]
    gx = xf.reshape(B, n_groups, w, d).sum(dim=2)           # [B, G, d]
    gm = m.reshape(B, n_groups, w).sum(dim=2)               # [B, G]
    p2 = p2.float()
    num = torch.einsum("og,bgd->bod", p2, gx)
    den = torch.einsum("og,bg->bo", p2, gm)
    out = num / den.clamp_min(1e-9)[..., None]
    if l2_norm:
        out = out / torch.linalg.vector_norm(
            out, dim=-1, keepdim=True).clamp_min(1e-9)
    return out


def pool_ref(x: torch.Tensor, mask: torch.Tensor, pool_mat: torch.Tensor,
             l2_norm: bool = True) -> torch.Tensor:
    """The pooling kernel's plain version: x [B,S,d], mask [B,S],
    pool_mat [n_out,S] -> [B,n_out,d] f32."""
    full_f32()
    xf = x.float()
    m = mask.float()
    p = pool_mat.float()
    num = torch.einsum("os,bsd->bod", p, xf * m[..., None])
    den = torch.einsum("os,bs->bo", p, m)
    out = num / den.clamp_min(1e-9)[..., None]
    if l2_norm:
        out = out / torch.linalg.vector_norm(
            out, dim=-1, keepdim=True).clamp_min(1e-9)
    return out


def _pool_cuda(x, mask, pool_mat, l2_norm: bool) -> torch.Tensor:
    """Launch ``pool_launch``: [B, n_out, d] f32. The mask and pooling
    matrix go to the kernel as f32 rows of S rounded up to a multiple of 4
    (zero past S), so every row starts 16-byte aligned."""
    B, S, d = x.shape
    n_out = pool_mat.shape[0]
    if pool_mat.shape[1] != S:
        raise ValueError(f"pool_mat {tuple(pool_mat.shape)} does not match "
                         f"S={S}")
    if d % 4 or d > 1024:
        raise ValueError(f"vector dim {d} must be a multiple of 4 and at "
                         "most 1024 (16-byte row loads, 256 threads)")
    dev = x.device
    x = x.float()
    if (x.stride(2) != 1 or x.stride(1) != d or x.stride(0) % 4
            or x.data_ptr() % 16):
        x = x.contiguous()
    s4 = -(-S // 4) * 4
    m = mask.to(device=dev, dtype=torch.float32)
    p = pool_mat.to(device=dev, dtype=torch.float32)
    if s4 != S:
        m = torch.nn.functional.pad(m, (0, s4 - S))
        p = torch.nn.functional.pad(p, (0, s4 - S))
    m, p = m.contiguous(), p.contiguous()
    out = torch.empty((B, n_out, d), dtype=torch.float32, device=dev)
    if B == 0 or n_out == 0:
        return out
    lib = build.library("pool")
    with torch.cuda.device(dev):
        rc = lib.pool_launch(x.data_ptr(), x.stride(0), m.data_ptr(),
                             p.data_ptr(), out.data_ptr(), B, S, s4, d,
                             n_out, int(l2_norm),
                             torch.cuda.current_stream().cuda_stream)
    build.check(rc, "pool")
    DSP.record("pooling")
    return out


def pool_cost(x: torch.Tensor, mask: torch.Tensor,
              pool_mat: torch.Tensor) -> tuple:
    """(operations, bytes) of one pooling call (the bound of PERF.md's
    kernel table): the f32 pages, the mask bytes, P and the f32 output
    once; 2*(d+1) operations per (page, nonzero of P), the mask sums
    included. On meta every entry of P counts as nonzero."""
    B, S, d = x.shape
    n_out = pool_mat.shape[0]
    # a direct caller's data: a body reaches this function only under
    # dispatch.costing, on meta tensors
    meta = pool_mat.device.type == "meta"
    # audit: allow-R3 meta skips this read (costing only in bodies)
    nnz = n_out * S if meta else int((pool_mat != 0).sum())
    nbytes = B * S * d * 4 + B * S + n_out * S * 4 + B * n_out * d * 4
    return 2.0 * B * nnz * (d + 1), nbytes


def pool_pages_fused(x: torch.Tensor, mask: torch.Tensor,
                     pool_mat: torch.Tensor, *,
                     l2_norm: bool = True) -> torch.Tensor:
    """x [B,S,d] + mask [B,S] + pool_mat [n_out,S] -> pooled [B,n_out,d]:
    ``(P @ (x*m)) / max(P @ m, 1e-9)`` per page, then an L2 renorm."""
    if DSP.shapes_only(x):
        DSP.record_cost("pooling", *pool_cost(x, mask, pool_mat),
                        (x, mask, pool_mat))
        return x.new_empty((x.shape[0], pool_mat.shape[0], x.shape[2]),
                           dtype=torch.float32)
    if DSP.on_cuda(x):
        return _pool_cuda(x, mask, pool_mat, l2_norm)
    return pool_ref(x, mask, pool_mat, l2_norm)
