"""Top-k selection with ids: local select and score/id merge."""
from __future__ import annotations

import torch

from repro_torch.core.multistage import top_k


def local_topk_with_ids(scores: torch.Tensor, k: int, id_offset) -> tuple:
    """scores [B, n_local] -> (vals [B,k], global ids [B,k])."""
    k = min(k, scores.shape[-1])
    v, i = top_k(scores, k)
    return v, i + id_offset


def merge_topk(vals: torch.Tensor, ids: torch.Tensor, k: int) -> tuple:
    """Merge candidate sets along the last axis: vals/ids [B, M] -> top-k
    (ties keep the earlier entry, as ``jax.lax.top_k`` does)."""
    k = min(k, vals.shape[-1])
    v, sel = top_k(vals, k)
    return v, torch.gather(ids, -1, sel)
