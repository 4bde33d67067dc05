"""Wrappers of the MaxSim CUDA kernels: argument checks, masks, dispatch.

``maxsim_scores(q, docs, ...)`` is the scan: [B, N] MaxSim scores of a
query batch against a whole corpus. For CUDA tensors it launches the
hand-written scan kernel (``csrc/maxsim_scan.cu``), which masks the ragged
Q, N and D edges itself (nothing is padded); for CPU tensors it runs the
plain version ``maxsim_ref``.

``maxsim_rerank(q, docs, rows, ...)`` is the fused gather + MaxSim rerank:
per-query candidate slot ids in, [B, L] exact MaxSim scores out. For CUDA
tensors it launches ``csrc/maxsim_rerank.cu``, which reads each
candidate's rows straight from the corpus (no gathered [B, L, D, d]
copy); for CPU tensors it runs the plain version ``_rerank_ref``.

Neither wrapper falls back: a failed launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import dispatch as DSP
from repro_torch.kernels.dispatch import full_f32
from repro_torch.kernels.maxsim.ref import NEG, maxsim_ref

_QT = 16                     # query tokens per register pass in the kernels
_SMEM_LIMIT = 48 * 1024      # static launch limit without opt-in


def _ones_mask(shape, device) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32, device=device)


def _mask_arg(mask, N: int, D: int, device) -> tuple:
    """A doc mask as the kernels read it: uint8 rows of D bytes and the row
    stride (D, or 0 for one broadcast row). None is a broadcast all-ones
    row, never a corpus-sized array."""
    if mask is None:
        return torch.ones((1, D), dtype=torch.uint8, device=device), 0
    if mask.shape not in ((N, D), (1, D)):
        raise ValueError(f"doc_mask shape {tuple(mask.shape)} is neither "
                         f"[{N}, {D}] nor a broadcast [1, {D}] row")
    if mask.dtype == torch.bool:
        m = mask.contiguous().view(torch.uint8)
    else:
        m = (mask > 0).to(torch.uint8).contiguous()
    return m, (0 if mask.shape[0] == 1 else D)


def _kernel_inputs(q, q_mask, docs, what: str) -> tuple:
    """Shared checks of the scan and rerank kernels' operands; returns the
    query and its mask as contiguous f32 on the docs' device."""
    d = q.shape[-1]
    if docs.shape[-1] != d:
        raise ValueError(f"{what}: query dim {d} != doc dim {docs.shape[-1]}")
    if docs.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: docs must be bfloat16 or float32, got "
                        f"{docs.dtype}")
    if d % 8:
        raise ValueError(f"{what}: vector dim {d} must be a multiple of 8 "
                         "(16-byte row loads)")
    if not docs.is_contiguous() or docs.data_ptr() % 16:
        raise ValueError(f"{what}: docs must be contiguous and 16-byte "
                         "aligned")
    qp = -(-q.shape[1] // _QT) * _QT
    if (qp * d + qp) * 4 > _SMEM_LIMIT:
        raise ValueError(f"{what}: {q.shape[1]} query tokens of dim {d} do "
                         "not fit the kernel's shared-memory query block")
    dev = docs.device
    qf = q.to(device=dev, dtype=torch.float32).contiguous()
    qm = q_mask.to(device=dev, dtype=torch.float32).contiguous()
    return qf, qm


def _scan_cuda(q, q_mask, docs, doc_mask) -> torch.Tensor:
    """Launch ``maxsim_scan_launch``: [B, N] f32 scores (NEG/2 floor)."""
    B, Q, d = q.shape
    N, D, _ = docs.shape
    qf, qm = _kernel_inputs(q, q_mask, docs, "maxsim_scan")
    out = torch.empty((B, N), dtype=torch.float32, device=docs.device)
    if B == 0 or N == 0:
        return out
    dm, stride = _mask_arg(doc_mask, N, D, docs.device)
    lib = build.library("maxsim_scan")
    with torch.cuda.device(docs.device):
        rc = lib.maxsim_scan_launch(
            qf.data_ptr(), qm.data_ptr(), docs.data_ptr(),
            int(docs.dtype == torch.bfloat16), dm.data_ptr(), stride,
            out.data_ptr(), B, Q, N, D, d,
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "maxsim_scan")
    DSP.record("maxsim_scan")
    return out


def maxsim_scores(q: torch.Tensor, docs: torch.Tensor,
                  q_mask: torch.Tensor | None = None,
                  doc_mask: torch.Tensor | None = None,
                  doc_valid: torch.Tensor | None = None) -> torch.Tensor:
    """q [B,Q,d], docs [N,D,d] -> scores [B,N] (f32).

    ``doc_valid`` [N] bool marks live documents in a capacity-padded store;
    dead slots score NEG so they can never enter a top-k on merit. The mask
    is applied to the kernel OUTPUT: the kernel still streams the full
    padded corpus."""
    B, Q, _ = q.shape
    N, D, _ = docs.shape
    if q_mask is None:
        q_mask = _ones_mask((B, Q), q.device)
    if DSP.on_cuda(docs):
        out = _scan_cuda(q, q_mask, docs, doc_mask)
    else:
        if doc_mask is None:
            doc_mask = _ones_mask((1, D), docs.device)
        out = maxsim_ref(q, q_mask, docs, doc_mask)
    if doc_valid is not None:
        out = out.masked_fill(~doc_valid[None, :], NEG)
    return out


def maxsim_scores_chunked(q: torch.Tensor, docs: torch.Tensor,
                          q_mask: torch.Tensor | None = None,
                          doc_mask: torch.Tensor | None = None,
                          doc_valid: torch.Tensor | None = None,
                          *, chunk: int) -> torch.Tensor:
    """Streaming corpus scan: score ``chunk`` documents per call.

    Bounds the plain version's [B, chunk, Q, D] similarity block
    regardless of corpus size N (the kernel never builds it, so on the
    card chunking only adds launches). chunk <= 0 means unchunked.
    ``doc_valid`` [N] bool NEGs dead capacity-padding slots, applied once
    on the assembled [B, N] output."""
    N = docs.shape[0]
    if chunk <= 0 or chunk >= N:
        return maxsim_scores(q, docs, q_mask, doc_mask, doc_valid)
    out = torch.cat([
        maxsim_scores(q, docs[i:i + chunk], q_mask,
                      None if doc_mask is None else doc_mask[i:i + chunk])
        for i in range(0, N, chunk)], dim=1)
    if doc_valid is not None:
        out = out.masked_fill(~doc_valid[None, :], NEG)
    return out


# ---------------------------------------------------------------------------
# fused gather + MaxSim rerank
# ---------------------------------------------------------------------------

def _rerank_ref(q, docs, rows, q_mask, doc_mask):
    """The rerank's plain version: per query, gather the candidate rows
    and score them with ``core.maxsim.maxsim_scan``'s math — no NEG/2
    floor, so a fully masked candidate scores Qv*NEG. The gathered copy
    is [L, D, d] for one query at a time."""
    full_f32()
    out = []
    for b in range(q.shape[0]):
        cl = rows[b].long()
        dv = docs[cl].to(q.dtype)                          # [L, D, d]
        sim = torch.einsum("qd,njd->nqj", q[b], dv)
        if doc_mask is not None:
            dm = doc_mask if doc_mask.shape[0] == 1 else doc_mask[cl]
            sim.masked_fill_(~(dm > 0)[:, None, :], NEG)
        best = sim.amax(dim=-1)                            # [L, Q]
        best = torch.where((q_mask[b] > 0)[None, :], best, 0.0)
        out.append(best.sum(dim=-1))
    return torch.stack(out) if out else q.new_zeros((0, rows.shape[1]))


def _rerank_cuda(q, q_mask, docs, rows, doc_mask) -> torch.Tensor:
    """Launch ``maxsim_rerank_launch``: [B, L] f32 scores (no floor)."""
    B, Q, d = q.shape
    N, D, _ = docs.shape
    L = rows.shape[1]
    qf, qm = _kernel_inputs(q, q_mask, docs, "maxsim_rerank")
    out = torch.empty((B, L), dtype=torch.float32, device=docs.device)
    if B == 0 or L == 0:
        return out
    rows = rows.to(device=docs.device, dtype=torch.int32).contiguous()
    dm, stride = _mask_arg(doc_mask, N, D, docs.device)
    lib = build.library("maxsim_rerank")
    with torch.cuda.device(docs.device):
        rc = lib.maxsim_rerank_launch(
            rows.data_ptr(), qf.data_ptr(), qm.data_ptr(), docs.data_ptr(),
            int(docs.dtype == torch.bfloat16), dm.data_ptr(), stride,
            out.data_ptr(), B, L, Q, D, d,
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "maxsim_rerank")
    DSP.record("maxsim_rerank")
    return out


def maxsim_rerank(q: torch.Tensor, docs: torch.Tensor, rows: torch.Tensor,
                  q_mask: torch.Tensor | None = None,
                  doc_mask: torch.Tensor | None = None,
                  ok: torch.Tensor | None = None) -> torch.Tensor:
    """Fused gather + exact MaxSim rerank: q [B,Q,d], docs [N,D,d],
    rows [B,L] candidate slot ids -> scores [B,L] f32.

    ``rows`` are clipped in-range; ``ok`` [B,L] bool marks candidates the
    caller actually owns — the rest score NEG so they can never win a
    top-k slot on merit. ``doc_mask`` is [N,D], a broadcast [1,D] row, or
    None (a broadcast all-ones row). Matryoshka stores (docs narrower than
    q) score against the matching query prefix."""
    B, Q, d = q.shape
    N, D, dd = docs.shape
    if dd < d:                                # Matryoshka rerank stage
        q = q[..., :dd]
    rows = rows.clamp(0, N - 1)
    if q_mask is None:
        q_mask = _ones_mask((B, Q), q.device)
    if DSP.on_cuda(docs):
        out = _rerank_cuda(q, q_mask, docs, rows, doc_mask)
    else:
        out = _rerank_ref(q, docs, rows, q_mask, doc_mask)
    if ok is not None:
        out = out.masked_fill(~ok, NEG)
    return out
