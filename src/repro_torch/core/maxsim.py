"""MaxSim late-interaction scoring (ColBERT/ColPali relevance operator).

score(q, x) = sum_i max_j <q_i, x_j>    (paper Eq. 1 cost model)

Plain PyTorch on tensors; the serving engine dispatches the scan and
rerank stages to the CUDA kernels (``repro_torch.kernels.maxsim``) when the
stage asks for them. Masks: ``q_mask`` marks valid query tokens,
``doc_mask`` marks valid stored vectors (token hygiene §2.1).

Mixed types follow JAX's promotion, written out: torch's matmul rejects
f32 x bf16, so both operands are cast to the promoted type (f32 for an f32
query against a bf16 store) before the product.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import full_f32

NEG = -1e30


def _promote(a: torch.Tensor, b: torch.Tensor) -> tuple:
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def maxsim(q: torch.Tensor, doc: torch.Tensor,
           q_mask: torch.Tensor | None = None,
           doc_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Single pair: q [Q,d], doc [D,d] -> scalar."""
    full_f32()
    q, doc = _promote(q, doc)
    sim = q @ doc.T                                   # [Q, D]
    if doc_mask is not None:
        sim = sim.masked_fill(~doc_mask.bool()[None, :], NEG)
    best = sim.amax(dim=-1)                           # [Q]
    if q_mask is not None:
        best = torch.where(q_mask.bool(), best, 0.0)
    return best.sum(dim=-1)


def maxsim_scan(q: torch.Tensor, docs: torch.Tensor,
                q_mask: torch.Tensor | None = None,
                doc_mask: torch.Tensor | None = None) -> torch.Tensor:
    """One query against a corpus: q [Q,d], docs [N,D,d] -> [N]."""
    full_f32()
    q, docs = _promote(q, docs)
    sim = torch.einsum("qd,njd->nqj", q, docs)        # [N, Q, D]
    if doc_mask is not None:
        sim.masked_fill_(~doc_mask.bool()[:, None, :], NEG)
    best = sim.amax(dim=-1)                           # [N, Q]
    if q_mask is not None:
        best = torch.where(q_mask.bool()[None, :], best, 0.0)
    return best.sum(dim=-1)


def maxsim_batched(q: torch.Tensor, docs: torch.Tensor,
                   q_mask: torch.Tensor | None = None,
                   doc_mask: torch.Tensor | None = None,
                   chunk: int = 0) -> torch.Tensor:
    """Query batch against corpus: q [B,Q,d], docs [N,D,d] -> [B,N].

    ``chunk`` > 0 scans the corpus in chunks of that many documents to
    bound the [B,N,Q,D] score intermediate. The per-document math is the
    same in every chunk, so chunked == unchunked bitwise (a ragged last
    chunk needs no padding in eager PyTorch).
    """
    full_f32()

    def block(d_blk, m_blk):
        qq, dd = _promote(q, d_blk)
        sim = torch.einsum("bqd,njd->bnqj", qq, dd)
        if m_blk is not None:
            sim.masked_fill_(~m_blk.bool()[None, :, None, :], NEG)
        best = sim.amax(dim=-1)                       # [B, n, Q]
        if q_mask is not None:
            best = torch.where(q_mask.bool()[:, None, :], best, 0.0)
        return best.sum(dim=-1)                       # [B, n]

    n = docs.shape[0]
    if chunk <= 0 or chunk >= n:
        return block(docs, doc_mask)
    return torch.cat([
        block(docs[i:i + chunk],
              None if doc_mask is None else doc_mask[i:i + chunk])
        for i in range(0, n, chunk)], dim=1)


def maxsim_single_vector(q: torch.Tensor, vecs: torch.Tensor,
                         q_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Global-pooling stage: q [B,Q,d] vs one vector per doc [N,d] -> [B,N].

    MaxSim degenerates to a masked sum of query tokens dotted with the doc
    vector — a single matrix product.
    """
    full_f32()
    if q_mask is not None:
        q = q * q_mask[..., None].to(q.dtype)
    qsum = q.sum(dim=-2)                              # [B, d]
    qsum, vecs = _promote(qsum, vecs)
    return qsum @ vecs.T


def search_cost_madds(n_queries: int, q_tokens: int, n_docs: int,
                      d_vecs: int, dim: int) -> int:
    """Paper Eq. 1: Q x D x N x d multiply-adds (per query batch)."""
    return n_queries * q_tokens * d_vecs * n_docs * dim
