"""Int8 error-feedback gradient compression (the port of
``repro.training.compression``).

Gradients are quantised to int8 with one float32 scale per tensor, and the
quantisation residual is carried into the next step (error feedback keeps
the method unbiased over time). Gradients and residuals are dicts keyed
by parameter name. ``psum_compressed`` is the compressed all-reduce, called
inside a ``shard_map`` body (``distributed.shard_map``): the int8 codes are
summed in int32 over the axis, and each position scales the sum by ITS
OWN scale, as ``repro``'s does, so the result differs per position.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import shard_map as SM


def init_residuals(params: dict) -> dict:
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()}


def quantize_int8(x: torch.Tensor, eps: float = 1e-12) -> tuple:
    """(int8 codes, float32 scale): scale = max(max|x|, eps) / 127, codes
    rounded half to even and clipped to [-127, 127]. Both divisions are
    real divisions, as in ``repro``'s op-by-op call, on every device: the
    divisors are tensors on ``x``'s device (PyTorch's CUDA kernels turn a
    division by a host scalar into a product with its reciprocal)."""
    amax = torch.amax(torch.abs(x))
    scale = torch.clamp(amax, min=eps) / amax.new_full((), 127.0)
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


def psum_compressed(grads: dict, residuals: dict, axis_name) -> tuple:
    """Error-feedback int8 all-reduce over ``axis_name`` inside a
    ``shard_map`` body: ``(averages, new residuals)``, each a dict by
    name. The codes are summed as int32 (no overflow); an average is that
    sum times this position's own scale, over the number of positions."""
    qs, ss, rs = compress_grads(grads, residuals)
    summed = SM.psum({k: q.to(torch.int32) for k, q in qs.items()},
                     axis_name)
    n = SM.psum(1, axis_name)
    return {k: summed[k].to(torch.float32) * ss[k] / ss[k].new_full((), n)
            for k in summed}, rs
