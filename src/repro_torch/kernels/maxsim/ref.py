"""The MaxSim scan's plain PyTorch version (the scan kernel's contract),
int8 dequantisation, and the stable top-k every selection uses."""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import full_f32

NEG = -1e30


def top_k(x: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the k largest entries along the last axis,
    descending, ties broken by the lower index (``jax.lax.top_k``'s
    order). ``torch.topk`` does not guarantee that order."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def dequantize(docs: torch.Tensor, scales: torch.Tensor | None
               ) -> torch.Tensor:
    """docs as f32; int8 codes times their per-vector ``scales`` [..., D]
    element by element (the arithmetic the kernels do)."""
    if (docs.dtype == torch.int8) != (scales is not None):
        raise ValueError("int8 codes need their scales, and only int8 codes "
                         "take scales")
    df = docs.float()
    if scales is not None:
        df = df * scales.float()[..., None]
    return df


def maxsim_ref(q: torch.Tensor, q_mask: torch.Tensor, docs: torch.Tensor,
               doc_mask: torch.Tensor,
               scales: torch.Tensor | None = None) -> torch.Tensor:
    """q [B,Q,d], q_mask [B,Q], docs [N,D,d] (f32/bf16, or int8 codes with
    ``scales`` [N,D] f32), doc_mask [N,D] (or a broadcast [1,D] row) ->
    [B,N] f32.

    Valid query tokens are floored at NEG/2, invalid ones count 0, so a
    fully masked document scores Qv*NEG/2 (the scan kernel's contract)."""
    full_f32()
    qf = q.float()
    df = dequantize(docs, scales)
    sim = torch.einsum("bqd,njd->bnqj", qf, df)
    sim.masked_fill_(~(doc_mask > 0)[None, :, None, :], NEG)
    best = sim.amax(dim=-1)                               # [B, N, Q]
    best = torch.where((q_mask > 0)[:, None, :], best.clamp_min(NEG / 2),
                       0.0)
    return best.sum(dim=-1)
