"""Matryoshka-style dimension truncation (beyond-paper stage-1 variant).

The paper's pooling reduces the *number* of vectors (D axis); Matryoshka
Representation Learning motivates the orthogonal reduction along the
*dimension* (d axis): score stage-1 with the first d' << d coordinates.
The engine scores such a stage against the matching query prefix
(``retrieval.engine._prefix``); on the card the scan's tensor route takes
d' of 32, 64 and 128.

Cost: stage-1 madds become Q x D' x N x d' — multiplicative with the
paper's vector-count reduction.
"""
from __future__ import annotations

import torch


def truncate_dims(vecs: torch.Tensor, d_prime: int,
                  renorm: bool = True) -> torch.Tensor:
    """[..., d] -> [..., d'] prefix truncation (optionally re-L2-normalised,
    in ``vecs``' own dtype)."""
    out = vecs[..., :d_prime]
    if renorm:
        out = out / torch.linalg.vector_norm(
            out, dim=-1, keepdim=True).clamp_min(1e-9)
    return out.contiguous()


def add_truncated_stage(store: dict, source: str, d_prime: int,
                        name: str | None = None) -> dict:
    """Register a truncated named vector derived from an existing one.
    The derived vector inherits ``source``'s companion arrays (same
    [N, D] geometry) through the store's ``companion_entries``; retrieval
    depends on core, so the import is made at call time."""
    from repro_torch.retrieval.store import companion_entries
    name = name or f"{source}_mrl{d_prime}"
    out = dict(store)
    out[name] = truncate_dims(store[source], d_prime)
    out.update(companion_entries(store, source, name))
    return out
