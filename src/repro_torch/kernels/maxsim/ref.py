"""The MaxSim scan's plain PyTorch version (the scan kernel's contract)."""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import full_f32

NEG = -1e30


def maxsim_ref(q: torch.Tensor, q_mask: torch.Tensor, docs: torch.Tensor,
               doc_mask: torch.Tensor) -> torch.Tensor:
    """q [B,Q,d], q_mask [B,Q], docs [N,D,d], doc_mask [N,D] (or a
    broadcast [1,D] row) -> [B,N] f32.

    Valid query tokens are floored at NEG/2, invalid ones count 0, so a
    fully masked document scores Qv*NEG/2 (the scan kernel's contract)."""
    full_f32()
    qf = q.float()
    df = docs.float()
    sim = torch.einsum("bqd,njd->bnqj", qf, df)
    sim.masked_fill_(~(doc_mask > 0)[None, :, None, :], NEG)
    best = sim.amax(dim=-1)                               # [B, N, Q]
    best = torch.where((q_mask > 0)[:, None, :], best.clamp_min(NEG / 2),
                       0.0)
    return best.sum(dim=-1)
