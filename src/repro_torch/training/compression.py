"""Int8 error-feedback gradient compression (the port of
``repro.training.compression``).

Gradients are quantised to int8 with one float32 scale per tensor, and the
quantisation residual is carried into the next step (error feedback keeps
the method unbiased over time). Gradients and residuals are dicts keyed
by parameter name. The compressed all-reduce (``repro``'s
``psum_compressed``) is not ported yet: it waits for the training
collectives, which have to decide between the single-controller mesh the
retrieval path uses (``launch.mesh``) and ``torch.distributed`` process
groups.
"""
from __future__ import annotations

import torch


def init_residuals(params: dict) -> dict:
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()}


def quantize_int8(x: torch.Tensor, eps: float = 1e-12) -> tuple:
    """(int8 codes, float32 scale): scale = max(max|x|, eps) / 127, codes
    rounded half to even and clipped to [-127, 127]. Both divisions are
    real divisions, as in ``repro``'s op-by-op call."""
    amax = torch.amax(torch.abs(x))
    scale = torch.clamp(amax, min=eps) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads: dict, residuals: dict) -> tuple:
    """(int8 codes, scales, new residuals), each a dict by name."""
    qs, ss, rs = {}, {}, {}
    for n, g in grads.items():
        gf = g.float() + residuals[n]
        qs[n], ss[n] = quantize_int8(gf)
        rs[n] = gf - qs[n].float() * ss[n]
    return qs, ss, rs


def decompress_grads(qs: dict, ss: dict) -> dict:
    return {n: q.float() * ss[n] for n, q in qs.items()}
