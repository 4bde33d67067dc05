"""Top-k selection with ids: local select, score/id merge, and the mesh's
gathered merge (never moves a document, only (score, id) pairs).

On a mesh (``launch.mesh``) the per-shard results are lists in mesh
order, one tensor per shard on that shard's device; ``all_gather``
concatenates them along the last axis on the gather device, shard 0
first, as ``jax.lax.all_gather(..., tiled=True)`` does. On a meta mesh
the lists hold shard 0's result alone and ``n`` names the shard count:
the gather is an empty meta tensor of the gathered shape. Every gather
is told to ``sharding.OBSERVERS`` as an "all-gather" of its result."""
from __future__ import annotations

import torch

from repro_torch.core.multistage import top_k
from repro_torch.distributed.sharding import OBSERVERS, notify

NEG = -1e30


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


def all_gather(parts: list, device=None, n: int | None = None
               ) -> torch.Tensor:
    """Per-shard tensors [B, m] in mesh order -> [B, S * m] on ``device``
    (default: shard 0's), shard 0 first. ``n`` with one meta part (a
    meta mesh's shard 0): the [B, n * m] shape, nothing gathered."""
    device = parts[0].device if device is None else device
    if n is not None and len(parts) == 1 and parts[0].device.type == "meta":
        p = parts[0]
        out = p.new_empty(tuple(p.shape[:-1]) + (n * p.shape[-1],))
    else:
        out = torch.cat([p.to(device) for p in parts], dim=-1)
    if OBSERVERS:
        notify("collective", "all-gather", out)
    return out


def gathered_merge_topk(vals: list, global_ids: list, k: int,
                        device=None, n: int | None = None) -> tuple:
    """Gather the shards' (vals, GLOBAL ids) [B, k'] winner lists in mesh
    order onto ``device`` and merge them to the top-k. Traffic: S * B * k'
    scores and ids, never the documents. The merge half of
    ``allgather_topk``, used directly by the streamed scan top-k path
    (whose local select already happened chunk by chunk). ``n`` as in
    ``all_gather``."""
    return merge_topk(all_gather(vals, device, n),
                      all_gather(global_ids, device, n), k)


def allgather_topk(scores_local: list, k: int, n_local: int,
                   valid_local: list | None = None, seg_offset: int = 0,
                   device=None, n: int | None = None) -> tuple:
    """Per-shard top-k, then the gathered merge: ``scores_local`` holds
    shard r's [B, n_local] scores at position r; returns (vals, global
    ids) [B, k] on ``device``.

    ``valid_local`` (one [n_local] bool per shard, or None) NEGs dead and
    padding slots before the local select (the tail of a ragged shard and
    deleted documents must never win on merit). Shard r's local slot j is
    global slot ``r * n_local + j + seg_offset``. ``n`` as in
    ``all_gather``."""
    vs, gis = [], []
    for r, s in enumerate(scores_local):
        if valid_local is not None and valid_local[r] is not None:
            s = s.masked_fill(~valid_local[r][None, :], NEG)
        v, gi = local_topk_with_ids(s, k, r * n_local + seg_offset)
        vs.append(v)
        gis.append(gi)
    return gathered_merge_topk(vs, gis, k, device, n)
