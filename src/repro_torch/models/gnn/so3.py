"""SO(3) machinery for EquiformerV2/eSCN: real spherical harmonics, Wigner
rotations, edge-frame alignment and m-truncation metadata (the port of
``repro.models.gnn.so3``).

Real orthonormal SH come from division-free Cartesian recursions (Q_l^m
polynomials in z; c_m = rho^m cos(m phi), s_m = rho^m sin(m phi) by the
complex-multiply recurrence), flattened as idx(l, m) = l^2 + l + m.

Wigner matrices D^l(R) (real basis) are built numerically from
Y(R r) = D^l(R) Y(r): a pseudo-inverse of the SH at fixed sample
directions is computed once in numpy float64 (``_pinv_table``, the same
tables as ``repro``'s) and cast once to the rotations' dtype and device;
each call evaluates the SH at the rotated samples.

eSCN (arXiv:2302.03655): rotating an edge's features so that the edge is
the z-axis makes the convolution block-diagonal in m, so only the
|m| <= m_max coefficients (``m_indices``) go through per-m SO(2) maps.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


# ---------------------------------------------------------------------------
# real spherical harmonics
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _k_norm(l_max: int) -> np.ndarray:
    """Orthonormalisation constants K_lm (numpy, float64)."""
    K = np.zeros((l_max + 1, l_max + 1))
    for l in range(l_max + 1):
        for m in range(l + 1):
            K[l, m] = math.sqrt((2 * l + 1) / (4 * math.pi)
                                * math.factorial(l - m) / math.factorial(l + m))
    return K


def sph_harm(xyz: torch.Tensor, l_max: int) -> torch.Tensor:
    """Real orthonormal SH of unit vectors. [..., 3] -> [..., (l_max+1)^2].
    Each constant K_lm enters as a float64 scalar, rounded to the
    tensor's dtype where it meets the tensor, as in ``repro``."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    K = _k_norm(l_max).tolist()
    # Q_l^m(z) = P_l^m / rho^m  (polynomials in z), rho^2 = x^2 + y^2
    Q: dict = {}
    for m in range(l_max + 1):
        if m == 0:
            Q[(0, 0)] = torch.ones_like(z)
        else:
            Q[(m, m)] = Q[(m - 1, m - 1)] * (-(2 * m - 1))
        if m + 1 <= l_max:
            Q[(m + 1, m)] = z * (2 * m + 1) * Q[(m, m)]
        for l in range(m + 2, l_max + 1):
            Q[(l, m)] = ((2 * l - 1) * z * Q[(l - 1, m)]
                         - (l + m - 1) * Q[(l - 2, m)]) / (l - m)
    # c_m = rho^m cos(m phi), s_m = rho^m sin(m phi)
    cs = {0: (torch.ones_like(z), torch.zeros_like(z))}
    for m in range(1, l_max + 1):
        cm, sm = cs[m - 1]
        cs[m] = (cm * x - sm * y, sm * x + cm * y)
    out = [None] * (l_max + 1) ** 2
    sqrt2 = math.sqrt(2.0)
    for l in range(l_max + 1):
        out[l * l + l] = K[l][0] * Q[(l, 0)]
        for m in range(1, l + 1):
            cm, sm = cs[m]
            out[l * l + l + m] = sqrt2 * K[l][m] * cm * Q[(l, m)]
            out[l * l + l - m] = sqrt2 * K[l][m] * sm * Q[(l, m)]
    return torch.stack(out, dim=-1)


def n_sph(l_max: int) -> int:
    return (l_max + 1) ** 2


# ---------------------------------------------------------------------------
# Wigner rotations via sampled SH (numpy pinv precomputed per l)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _sample_dirs(l_max: int) -> np.ndarray:
    """Generic, well-spread unit vectors (Fibonacci sphere), oversampled."""
    k = 2 * (2 * l_max + 1)
    i = np.arange(k) + 0.5
    phi = math.pi * (3.0 - math.sqrt(5.0)) * i
    ct = 1.0 - 2.0 * i / k
    st = np.sqrt(np.maximum(0.0, 1.0 - ct * ct))
    return np.stack([st * np.cos(phi), st * np.sin(phi), ct], axis=-1)


def _sph_harm_np(xyz: np.ndarray, l_max: int) -> np.ndarray:
    """Pure-numpy float64 twin of sph_harm (table construction only)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    K = _k_norm(l_max)
    Q: dict = {}
    for m in range(l_max + 1):
        if m == 0:
            Q[(0, 0)] = np.ones_like(z)
        else:
            Q[(m, m)] = Q[(m - 1, m - 1)] * (-(2 * m - 1))
        if m + 1 <= l_max:
            Q[(m + 1, m)] = z * (2 * m + 1) * Q[(m, m)]
        for l in range(m + 2, l_max + 1):
            Q[(l, m)] = ((2 * l - 1) * z * Q[(l - 1, m)]
                         - (l + m - 1) * Q[(l - 2, m)]) / (l - m)
    cs = {0: (np.ones_like(z), np.zeros_like(z))}
    for m in range(1, l_max + 1):
        cm, sm = cs[m - 1]
        cs[m] = (cm * x - sm * y, sm * x + cm * y)
    out = [None] * (l_max + 1) ** 2
    sqrt2 = math.sqrt(2.0)
    for l in range(l_max + 1):
        out[l * l + l] = K[l, 0] * Q[(l, 0)]
        for m in range(1, l + 1):
            cm, sm = cs[m]
            out[l * l + l + m] = sqrt2 * K[l, m] * cm * Q[(l, m)]
            out[l * l + l - m] = sqrt2 * K[l, m] * sm * Q[(l, m)]
    return np.stack(out, axis=-1)


@lru_cache(maxsize=None)
def _pinv_table(l_max: int):
    """pinv of Y(samples) restricted to each l block: list of [2l+1, K]."""
    S = _sample_dirs(l_max)
    Y = _sph_harm_np(S.astype(np.float64), l_max)
    out = []
    for l in range(l_max + 1):
        blk = Y[:, l * l:(l + 1) * (l + 1)]          # [K, 2l+1]
        out.append(np.linalg.pinv(blk))              # [2l+1, K]
    return out, S


@lru_cache(maxsize=None)
def _pinv_tensors(l_max: int, dtype: torch.dtype, device: torch.device):
    """``_pinv_table``'s float64 tables cast once to ``dtype`` on
    ``device``: ([per-l pinv [2l+1, K]], samples [K, 3])."""
    pinvs, S = _pinv_table(l_max)
    return ([torch.as_tensor(P, dtype=dtype, device=device) for P in pinvs],
            torch.as_tensor(S, dtype=dtype, device=device))


def wigner_blocks(R: torch.Tensor, l_max: int) -> list:
    """D^l(R) per l. R [..., 3, 3] -> list of [..., 2l+1, 2l+1].

    D = (pinv(Y_S) @ Y(R S))^T per l block.
    """
    pinvs, S = _pinv_tensors(l_max, R.dtype, R.device)
    RS = torch.einsum("...ij,kj->...ki", R, S)        # [..., K, 3]
    Yr = sph_harm(RS, l_max)                          # [..., K, (l_max+1)^2]
    out = []
    for l in range(l_max + 1):
        blk = Yr[..., l * l:(l + 1) * (l + 1)]        # [..., K, 2l+1]
        out.append(torch.einsum("mk,...kn->...nm", pinvs[l], blk))
    return out


def apply_wigner(blocks: list, coeffs: torch.Tensor,
                 transpose: bool = False) -> torch.Tensor:
    """coeffs [..., (l_max+1)^2, C]; blocks per l [..., 2l+1, 2l+1]."""
    outs = []
    for l, D in enumerate(blocks):
        c = coeffs[..., l * l:(l + 1) * (l + 1), :]
        eq = "...nm,...mc->...nc" if not transpose else "...mn,...mc->...nc"
        outs.append(torch.einsum(eq, D, c))
    return torch.cat(outs, dim=-2)


def apply_wigner_trunc(blocks: list, coeffs: torch.Tensor,
                       l_max: int, m_max: int) -> torch.Tensor:
    """Fused rotate-into-edge-frame + m-truncate: only the |m| <= m_max
    output rows of each D^l block, so the full [(l_max+1)^2, C] rotated
    tensor never materialises. Exact. Returns [..., n_keep, C] in keep
    order."""
    outs = []
    for l, D in enumerate(blocks):
        rows = slice(l - min(l, m_max), l + min(l, m_max) + 1)
        c = coeffs[..., l * l:(l + 1) * (l + 1), :]
        outs.append(torch.einsum("...nm,...mc->...nc", D[..., rows, :], c))
    return torch.cat(outs, dim=-2)


def apply_wigner_expand(blocks: list, trunc: torch.Tensor,
                        l_max: int, m_max: int) -> torch.Tensor:
    """Fused expand-from-m-truncated + rotate-back (transpose): contracts
    only the |m| <= m_max columns of each D^l, so the zero-padded
    [(l_max+1)^2, C] tensor never materialises. Exact inverse path of
    apply_wigner_trunc. trunc [..., n_keep, C] -> [..., (l_max+1)^2, C]."""
    outs = []
    off = 0
    for l in range(l_max + 1):
        n = 2 * min(l, m_max) + 1
        rows = slice(l - min(l, m_max), l + min(l, m_max) + 1)
        c = trunc[..., off:off + n, :]
        outs.append(torch.einsum("...mn,...mc->...nc", blocks[l][..., rows, :],
                                 c))
        off += n
    return torch.cat(outs, dim=-2)


@lru_cache(maxsize=None)
def _flip(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The rotation by pi about x, made once per dtype and device."""
    return torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=dtype)).to(device)


def rotation_to_z(v: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """R with R @ v_hat = z_hat. v [..., 3] -> [..., 3, 3] (Rodrigues).

    Both degenerate branches are computed and selected with
    ``torch.where``, as ``repro`` selects them: v ~ +z gives I, v ~ -z the
    rotation by pi about x. ``sqrt(max(s2, eps))`` keeps the unselected
    Rodrigues branch finite."""
    norm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    v = v / torch.clamp(norm, min=eps)
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    # axis = v x z = (vy, -vx, 0); angle: cos = vz
    s2 = vx * vx + vy * vy                           # sin^2(theta)
    safe = s2 > eps
    c = vz
    # Rodrigues: R = c I + sin [a]_x + (1-c) a a^T, axis a = (v x z)/|v x z|
    sn = torch.sqrt(torch.clamp(s2, min=eps))
    aux, auy = vy / sn, -vx / sn
    zero = torch.zeros_like(aux)
    K = torch.stack([torch.stack([zero, zero, auy], dim=-1),
                     torch.stack([zero, zero, -aux], dim=-1),
                     torch.stack([-auy, aux, zero], dim=-1)], dim=-2)
    I = torch.eye(3, dtype=v.dtype, device=v.device)
    a = torch.stack([aux, auy, zero], dim=-1)
    R = (c[..., None, None] * I
         + sn[..., None, None] * K
         + (1 - c)[..., None, None] * a[..., :, None] * a[..., None, :])
    flip = _flip(v.dtype, v.device)
    Rdeg = torch.where((vz > 0)[..., None, None], I, flip)
    return torch.where(safe[..., None, None], R, Rdeg)


# ---------------------------------------------------------------------------
# m-truncation metadata (eSCN)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def m_indices(l_max: int, m_max: int):
    """Index arrays for the |m|<=m_max retained coefficients.

    Returns dict with:
      keep      [n_keep] flat indices into the (l_max+1)^2 axis
      m0        positions (within keep) of m=0 comps, ordered by l
      cos[m]    positions of +m comps per m=1..m_max (ordered by l)
      sin[m]    positions of -m comps per m
    """
    keep, pos_of = [], {}
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            if abs(m) <= m_max:
                pos_of[(l, m)] = len(keep)
                keep.append(l * l + l + m)
    out = {
        "keep": np.asarray(keep, np.int32),
        "m0": np.asarray([pos_of[(l, 0)] for l in range(l_max + 1)], np.int32),
        "cos": {}, "sin": {},
    }
    for m in range(1, m_max + 1):
        ls = [l for l in range(m, l_max + 1)]
        out["cos"][m] = np.asarray([pos_of[(l, m)] for l in ls], np.int32)
        out["sin"][m] = np.asarray([pos_of[(l, -m)] for l in ls], np.int32)
    return out


def n_keep(l_max: int, m_max: int) -> int:
    return int(len(m_indices(l_max, m_max)["keep"]))
