"""Token hygiene (paper §2.1): keep only visual patch tokens at index time.

VLM processors emit, alongside visual patch tokens: (i) special tokens
(CLS/BOS/EOS), (ii) prompt/instruction tokens, (iii) batch-padding tokens
(trailing zero vectors). Standard MaxSim treats all tokens equally, letting
non-visual tokens act as spurious high-similarity attractors. They are
masked out at index time; pooling and MaxSim both respect the mask.

Token-type convention:
    0 = visual patch, 1 = special, 2 = prompt/instruction, 3 = padding
"""
from __future__ import annotations

import torch

VISUAL, SPECIAL, PROMPT, PAD = 0, 1, 2, 3


def visual_mask_from_types(token_types: torch.Tensor) -> torch.Tensor:
    """[S] int token types -> [S] bool (True = keep for indexing)."""
    return token_types == VISUAL


def detect_padding(embeddings: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Batch-padding tokens as (near-)zero vectors: [..., S, d] -> [..., S]
    bool (True = is padding)."""
    return torch.linalg.vector_norm(embeddings, dim=-1) < eps


def hygiene_mask(embeddings: torch.Tensor,
                 token_types: torch.Tensor | None = None) -> torch.Tensor:
    """Combined visual-token mask: type-based when types are available,
    plus zero-vector padding detection always."""
    keep = ~detect_padding(embeddings)
    if token_types is not None:
        keep = keep & visual_mask_from_types(token_types)
    return keep


def apply_hygiene(embeddings: torch.Tensor,
                  token_types: torch.Tensor | None = None) -> tuple:
    """Returns (embeddings, mask). Vectors are not physically removed
    (static shapes); masked vectors are zeroed so they can never win a
    MaxSim max even if a caller forgets the mask."""
    mask = hygiene_mask(embeddings, token_types)
    return embeddings * mask[..., None].to(embeddings.dtype), mask


def retained_counts(mask: torch.Tensor) -> torch.Tensor:
    """Number of retained (visual) tokens per page, int32 — the paper
    reports e.g. ColPali 1024/1030 and ColQwen 720–768 (mean 743)."""
    return torch.sum(mask.to(torch.int32), dim=-1, dtype=torch.int32)


def require_visual_tail(token_types, n_vis: int) -> None:
    """Validate the static token layout the index path assumes.

    ``build_store``/``IngestPipeline`` separate visual tokens as the
    TRAILING ``n_vis`` sequence positions (specials/prompt lead). A
    ``token_types`` row that disagrees would be silently mis-indexed, so
    this raises instead (host-side, before any device work)."""
    tt = torch.as_tensor(token_types).cpu().numpy()
    tail = tt[..., tt.shape[-1] - n_vis:]
    if not (tail == VISUAL).all():
        bad = int((tail != VISUAL).sum())
        raise ValueError(
            f"token_types must mark the trailing n_patches={n_vis} "
            f"positions as visual (type {VISUAL}); {bad} tail position(s) "
            "are non-visual. The index path assumes specials lead the "
            "sequence — reorder the processor output or fix token_types.")
    lead = tt[..., : tt.shape[-1] - n_vis]
    if (lead == VISUAL).any():
        bad = int((lead == VISUAL).sum())
        raise ValueError(
            f"{bad} visual token(s) outside the trailing n_patches={n_vis} "
            "window would be silently dropped at index time; the index "
            "path assumes specials lead the sequence.")
