"""The EmbeddingBag kernel's plain PyTorch version (take + weighted sum)."""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import full_f32


def embed_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """table [V,d] (any float type), indices [B,L] in [0,V), weights [B,L]
    -> [B,d] f32: the rows taken, cast to f32, then a weighted sum. The
    [B, L, d] gathered copy is materialised."""
    full_f32()
    rows = table[indices.long()].float()                        # [B, L, d]
    return torch.einsum("bl,bld->bd", weights.float(), rows)
