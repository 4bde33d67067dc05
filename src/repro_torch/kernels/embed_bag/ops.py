"""The EmbeddingBag op: modes, padding and dispatch to the kernel.

``embed_bag(table, indices, valid=None, mode="sum"|"mean")`` is a multi-hot
lookup: each of B bags sums (or averages) up to L table rows. For a table
on the card it launches the hand-written CUDA kernel (``csrc/embed_bag.cu``)
and counts one ``embed_bag`` launch after a launch that succeeded; for a
CPU table it runs the plain version ``embed_bag_ref``. There is no fallback
from a failed launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import dispatch as DSP
from repro_torch.kernels.embed_bag.ref import embed_bag_ref

_TABLE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _embed_bag_cuda(table: torch.Tensor, idx: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Launch ``embed_bag_launch``: [B, d] f32. An empty batch (B == 0 or
    L == 0) is all zeros, launches nothing and counts nothing."""
    B, L = idx.shape
    d = table.shape[1]
    if table.dtype not in _TABLE_TYPES:
        raise TypeError(f"embed_bag: table must be float32, bfloat16 or "
                        f"float16 on the card, got {table.dtype}")
    dev = table.device
    if B == 0 or L == 0 or d == 0:
        return torch.zeros((B, d), dtype=torch.float32, device=dev)
    table = table.contiguous()
    idx = idx.to(device=dev, dtype=torch.int32).contiguous()
    w = w.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((B, d), dtype=torch.float32, device=dev)
    lib = build.library("embed_bag")
    with torch.cuda.device(dev):
        rc = lib.embed_bag_launch(table.data_ptr(), _TABLE_TYPES[table.dtype],
                                  idx.data_ptr(), w.data_ptr(),
                                  out.data_ptr(), B, L, d,
                                  torch.cuda.current_stream().cuda_stream)
    build.check(rc, "embed_bag")
    DSP.record("embed_bag")
    return out


def embed_bag_cost(table: torch.Tensor, idx: torch.Tensor,
                   w: torch.Tensor) -> tuple:
    """(operations, bytes) of one bag call (the bound of PERF.md's kernel
    table): every slot's distinct row once (a zero-weight slot reads its
    clipped row too), the int32 ids and f32 weights, the f32 output; 2*d
    operations per weighted slot. On meta every slot id counts as
    distinct (at most V) and every weight as nonzero."""
    B, L = idx.shape
    V, d = table.shape
    if table.device.type == "meta":
        need, slots = min(B * L, V), B * L
    else:
        need, slots = torch.unique(idx).numel(), int((w != 0).sum())
    nbytes = need * d * table.element_size() + B * L * 8 + B * d * 4
    return 2.0 * slots * d, nbytes


def embed_bag(table: torch.Tensor, indices: torch.Tensor,
              valid: torch.Tensor | None = None, *,
              mode: str = "sum") -> torch.Tensor:
    """Multi-hot embedding-bag lookup.

    table [V,d] (any float type); indices [B,L] (entries < 0, or where
    ``valid`` is False, are padding); mode "sum" or "mean" (the sum over
    the valid entries divided by max(count, 1)). Indices are clipped to
    [0, V-1]. Returns [B,d] f32.

    Every slot adds weight * row, padding included (weight 0, at its
    clipped id), as in the reference: a non-finite value in a row that a
    padded or masked-out slot points at propagates (0 * inf is NaN), on
    the card and on the CPU alike."""
    if table.ndim != 2 or indices.ndim != 2:
        raise ValueError(f"embed_bag: table must be [V, d] and indices "
                         f"[B, L], got {tuple(table.shape)} and "
                         f"{tuple(indices.shape)}")
    if valid is None:
        valid = indices >= 0
    w = valid.to(torch.float32)
    if mode == "mean":
        w = w / w.sum(dim=-1, keepdim=True).clamp_min(1.0)
    elif mode != "sum":
        raise ValueError(mode)
    idx = indices.clamp(0, table.shape[0] - 1).to(torch.int32)
    if DSP.shapes_only(table):
        DSP.record_cost("embed_bag", *embed_bag_cost(table, idx, w),
                        (table, idx, w))
        return table.new_empty((idx.shape[0], table.shape[1]),
                               dtype=torch.float32)
    if DSP.on_cuda(table):
        return _embed_bag_cuda(table, idx, w)
    return embed_bag_ref(table, idx, w)
