"""Wrappers of the MaxSim CUDA kernels: argument checks, masks, dispatch.

``maxsim_scores(q, docs, ...)`` is the scan: [B, N] MaxSim scores of a
query batch against a whole corpus. For CUDA tensors it launches the
hand-written scan kernel (``csrc/maxsim_scan.cu``), which masks the ragged
N and D edges itself; for CPU tensors it runs the plain version
``maxsim_ref``. The launcher takes one of two routes, from the document
type, D and d alone; the wrapper asks the scan library which
(``scan_route``, ``scan_token_cap``):

- ``tensor``: bf16 documents or int8 codes with D >= 16 and d of 32, 64
  or 128. bf16 wgmma over the documents (M side) and the packed VALID
  query tokens (N side) as a split-precision pair: ``scan_query_operand``
  packs and splits the query on its device (q = q_hi + q_lo in bf16,
  within 2^-16 relative) and the kernel groups whole queries itself. A
  query's Q token slots must fit the library's token cap (320 at d =
  128). Scores agree with ``maxsim_ref`` to rtol 1e-5, atol 1e-4 at the
  main path's 10 unit-vector tokens per query;
- ``warp``: f32 documents, small D (the D = 1 IVF centroid scores) and
  other d: one warp per (query, document) in f32 on the CUDA cores.

``maxsim_scores_chunked(q, docs, ..., chunk=C)`` is the chunked scan. For
CUDA tensors with 0 < C < N it promotes itself, as the JAX package's does,
to ``maxsim_scores_pipelined``: ONE launch of the double-buffered scan
(``csrc/maxsim_scan_db.cu``), which on the tensor route launches the
scan's own tensor-core kernel over the packed query and on the warp route
its f32 kernel. For CPU tensors it runs the plain chunked loop
``maxsim_chunked_ref``. ``chunk`` never changes a score.

``maxsim_rerank(q, docs, rows, ...)`` is the fused gather + MaxSim rerank:
per-query candidate slot ids in, [B, L] exact MaxSim scores out. For CUDA
tensors it launches ``csrc/maxsim_rerank.cu``, which reads each
candidate's rows straight from the corpus (no gathered [B, L, D, d]
copy): on the tensor route a bf16 wgmma kernel over the packed query's
valid tokens, 16 per pass (any Q), on the warp route one warp per (query,
candidate) in f32. For CPU tensors it runs the plain version
``_rerank_ref``. The db scan and the rerank take the scan's route, asked
of the scan library (``scan_route``).

``maxsim_topk_chunked`` is the streamed scan top-k: it scores the corpus
chunk by chunk and carries a running per-query top-k, so the [B, N] score
matrix never exists.

``centroid_scores(q, centroids, ...)`` is IVF routing's query-vs-centroid
score. MaxSim against a one-vector document is the masked query sum
dotted with that vector, so for CUDA tensors it launches the scan kernel
on a ``centroids[:, None, :]`` view (D=1) and counts an ``ivf_route``
launch; for CPU tensors it runs the plain masked-sum product
``centroid_scores_ref``.

Every scan and the rerank take int8 codes with per-vector ``scales``
[N, D] f32 (``quantize_int8``); the kernels dequantise in the product.
No wrapper falls back: a failed launch raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import dispatch as DSP
from repro_torch.kernels.dispatch import full_f32
from repro_torch.kernels.maxsim.ref import NEG, dequantize, maxsim_ref, top_k

_QT = 16                     # query tokens per register pass (warp kernels)
_SMEM_OPTIN = 232448         # opt-in shared memory per block on sm_90
_DOC_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_INV_127 = np.float32(1.0 / 127.0)


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


def _kernel_inputs(q, q_mask, docs, scales, what: str) -> tuple:
    """Shared checks of the kernels' operands; returns the query and its
    mask as contiguous f32 on the docs' device, the document type code and
    the scales as contiguous f32 (None for float documents)."""
    d = q.shape[-1]
    N, D = docs.shape[:2]
    if docs.shape[-1] != d:
        raise ValueError(f"{what}: query dim {d} != doc dim {docs.shape[-1]}")
    if docs.dtype not in _DOC_TYPES:
        raise TypeError(f"{what}: docs must be float32, bfloat16 or int8 "
                        f"codes, got {docs.dtype}")
    if (docs.dtype == torch.int8) != (scales is not None):
        raise ValueError(f"{what}: int8 codes need their scales, and only "
                         "int8 codes take scales")
    if d % 8:
        raise ValueError(f"{what}: vector dim {d} must be a multiple of 8 "
                         "(8-element row loads)")
    align = 8 if docs.dtype == torch.int8 else 16
    if not docs.is_contiguous() or docs.data_ptr() % align:
        raise ValueError(f"{what}: docs must be contiguous and {align}-byte "
                         "aligned")
    dev = docs.device
    if scales is not None:
        if tuple(scales.shape) != (N, D):
            raise ValueError(f"{what}: scales shape {tuple(scales.shape)} != "
                             f"[{N}, {D}]")
        scales = scales.to(device=dev, dtype=torch.float32).contiguous()
    qf = q.to(device=dev, dtype=torch.float32).contiguous()
    qm = q_mask.to(device=dev, dtype=torch.float32).contiguous()
    return qf, qm, _DOC_TYPES[docs.dtype], scales


def scan_route(docs_dtype, D: int, d: int) -> str:
    """The scan launcher's route for documents of ``docs_dtype`` with D
    vectors of dim d, as the scan library states it (``maxsim_scan_route``
    in ``csrc/maxsim_scan.cu``, the rule's one statement): "tensor" (bf16
    wgmma) or "warp" (f32 CUDA cores). Needs the built library."""
    lib = build.library("maxsim_scan")
    code = _DOC_TYPES.get(docs_dtype, 0)      # another type is refused later
    return "tensor" if lib.maxsim_scan_route(code, D, d) else "warp"


def scan_token_cap(docs_dtype, d: int) -> int:
    """Query tokens per group (a multiple of 64) that the tensor route
    holds in shared memory and registers, as the scan library states it
    (``maxsim_scan_token_cap``); a query's Q token slots must fit."""
    lib = build.library("maxsim_scan")
    return lib.maxsim_scan_token_cap(_DOC_TYPES.get(docs_dtype, 0), d)


def warp_query_cap(d: int) -> int:
    """Query tokens the warp kernels (the scan's warp route, the rerank,
    ``centroid_scores``) hold in shared memory: ((Qp*d + Qp) * 4 bytes,
    Qp = Q rounded up to 16) within the opt-in maximum; 448 at d = 128."""
    return _SMEM_OPTIN // (4 * (d + 1)) // _QT * _QT


def _check_query_smem(q, what: str, cap: int) -> None:
    """Raise unless the query's Q token slots fit the kernel (``cap``)."""
    if q.shape[1] > cap:
        raise ValueError(f"{what}: {q.shape[1]} query tokens of dim "
                         f"{q.shape[-1]} exceed the kernel's {cap} "
                         "(shared-memory query block)")


def split_bf16(x: torch.Tensor) -> tuple:
    """f32 x -> (hi, lo) bf16 with hi = bf16(x), lo = bf16(x - hi): hi +
    lo equals x to within 2^-16 relative."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    return hi, (x - hi).to(torch.bfloat16)


def scan_query_operand(q: torch.Tensor, q_mask: torch.Tensor) -> tuple:
    """The tensor route's query operand, built on q's device with no wait
    for it: (qpack [B*Q + 1, 2, d] bf16 — the valid tokens' (q_hi, q_lo)
    in (query, token) order from row 0; rows past the last valid token
    are never read, and the masked slots are written to the last row —,
    qstart [B] int32 (a query's first row), qcount [B] int32). The kernel
    groups whole queries itself, at most ``scan_token_cap`` tokens per
    group."""
    B, Q, d = q.shape
    valid = q_mask > 0
    counts = valid.sum(dim=1, dtype=torch.int32)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    rows = torch.where(valid, torch.cumsum(valid, 1) + (starts[:, None] - 1),
                       B * Q)
    qpack = torch.empty((B * Q + 1, 2, d), dtype=torch.bfloat16,
                        device=q.device)
    qpack.index_copy_(0, rows.reshape(-1),
                      torch.stack(split_bf16(q.reshape(B * Q, d)), dim=1))
    return qpack, starts, counts


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _check_operand(operand: tuple, B: int, Q: int, d: int, device,
                   what: str = "maxsim_scan") -> None:
    """Raise unless ``operand`` has the layout ``scan_query_operand`` gives
    a [B, Q, d] query on ``device``. The kernels read qstart and qcount of
    every query and the qpack rows they point at, so an operand built for
    another batch would read out of bounds on the card."""
    qpack, qstart, qcount = operand
    ok = (qpack.dtype == torch.bfloat16
          and tuple(qpack.shape) == (B * Q + 1, 2, d)
          and all(t.dtype == torch.int32 and tuple(t.shape) == (B,)
                  for t in (qstart, qcount))
          and all(t.device == device and t.is_contiguous() for t in operand))
    if not ok:
        raise ValueError(
            f"{what}: the query operand is not a scan_query_operand of "
            f"this [{B}, {Q}, {d}] query on {device}")


def _tensor_cap(q, docs, what: str) -> int:
    """The scan kernels' route for ``docs`` as the scan library states it:
    0 for the warp route, else the tensor route's query tokens per group
    (``scan_token_cap``), once the query's Q token slots are within that
    cap and the documents are 16-byte aligned (``ValueError`` otherwise,
    before any launch)."""
    d = q.shape[-1]
    if scan_route(docs.dtype, docs.shape[1], d) != "tensor":
        return 0
    cap = scan_token_cap(docs.dtype, d)
    _check_query_smem(q, what, cap)
    _check_aligned_16(docs, what)
    return cap


def _check_aligned_16(docs, what: str) -> None:
    if docs.data_ptr() % 16:
        raise ValueError(f"{what}: the tensor route reads documents in "
                         "16-byte copies; docs must be 16-byte aligned")


def scan_cost(q, q_mask, docs, doc_mask=None, scales=None) -> tuple:
    """(operations, bytes) of one scan, the db scan's too (the bound of
    PERF.md's kernel table): the f32 query and its mask, the documents
    (and int8 scales), the mask bytes and the [B, N] f32 scores read or
    written once; 2*d operations per (valid query token, unmasked
    document vector). On meta tensors every mask entry counts as set."""
    B, Q, _ = q.shape
    N, D, d = docs.shape
    meta = docs.device.type == "meta"
    # the reads back below count a direct caller's data: a body reaches
    # this function only under dispatch.costing, on meta tensors
    # audit: allow-R3 meta skips this read (costing only in bodies)
    qv = B * Q if q_mask is None or meta else int((q_mask > 0).sum())
    if doc_mask is None:
        nd, mask_bytes = N * D, D
    else:
        mask_bytes = doc_mask.numel()
        # audit: allow-R3 meta skips this read (costing only in bodies)
        nd = (N * D if meta else int((doc_mask > 0).sum())
              * (N if doc_mask.shape[0] == 1 else 1))
    nbytes = (2 * B * Q * 4 + docs.numel() * docs.element_size()
              + (0 if scales is None else scales.numel() * 4) + mask_bytes
              + B * N * 4)
    return 2.0 * qv * nd * d, nbytes


def rerank_cost(q, q_mask, docs, rows, doc_mask=None, scales=None) -> tuple:
    """(operations, bytes) of one rerank (the bound of PERF.md's kernel
    table): the rows, the f32 query and its mask, the [B, L] scores, and
    each DISTINCT candidate's vectors, mask bytes and int8 scales once;
    2*d operations per (valid query token, unmasked candidate vector).
    On meta tensors every mask entry counts as set and every candidate
    as distinct (at most N of them)."""
    B, Q, _ = q.shape
    N, D, d = docs.shape
    L = rows.shape[1]
    row_bytes = d * docs.element_size() + 1 + (0 if scales is None else 4)
    if docs.device.type == "meta":
        uniq, vecs = min(B * L, N), B * L * D * Q
    else:
        # a direct caller's data; a body reaches this function only under
        # dispatch.costing, on meta tensors (the branch above)
        r = rows.long().clamp(0, N - 1)
        uniq = torch.unique(r).numel()    # audit: allow-R3 not in costing
        per_cand = torch.full((B, L), float(D))
        if doc_mask is not None:
            dm = (doc_mask > 0).float().sum(-1)
            per_cand = dm[0 if doc_mask.shape[0] == 1 else r].expand(B, L)
        per_q = (torch.full((B, 1), float(Q)) if q_mask is None
                 else (q_mask > 0).float().sum(-1, keepdim=True))
        # audit: allow-R3 not in costing (meta takes the branch above)
        vecs = int((per_cand.cpu() * per_q.cpu()).sum())
    nbytes = (rows.numel() * 4 + 2 * B * Q * 4 + uniq * D * row_bytes
              + B * L * 4)
    return 2.0 * vecs * d, nbytes


def _scan_launch(entry: str, counter: str, q, q_mask, docs, doc_mask,
                 scales, cap: int = 0, operand=None) -> torch.Tensor:
    """Launch the scan ``entry`` ("maxsim_scan" or "maxsim_scan_db").
    [B, N] f32 scores (NEG/2 floor). ``cap`` > 0 takes the tensor route
    with that many query tokens per group: the launch then reads the
    packed query operand (``scan_query_operand``; built here unless
    given); cap 0 is the warp route. Counts one launch of ``counter`` once
    the launch succeeded; an empty query batch or corpus launches nothing
    and counts nothing."""
    B, Q, d = q.shape
    N, D, _ = docs.shape
    qf, qm, dtype, sc = _kernel_inputs(q, q_mask, docs, scales, entry)
    out = torch.empty((B, N), dtype=torch.float32, device=docs.device)
    if B == 0 or N == 0:
        return out
    dm, stride = _mask_arg(doc_mask, N, D, docs.device)
    extra = [0, 0, 0, 0]
    if cap:
        if operand is None:
            operand = scan_query_operand(qf, qm)
        _check_operand(operand, B, Q, d, docs.device, entry)
        extra = [t.data_ptr() for t in operand] + [cap]
    lib = build.library(entry)
    with torch.cuda.device(docs.device):
        rc = getattr(lib, entry + "_launch")(
            qf.data_ptr(), qm.data_ptr(), docs.data_ptr(), dtype, _ptr(sc),
            dm.data_ptr(), stride, out.data_ptr(), B, Q, N, D, d, *extra,
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, entry)
    DSP.record(counter)
    return out


def maxsim_scores(q: torch.Tensor, docs: torch.Tensor,
                  q_mask: torch.Tensor | None = None,
                  doc_mask: torch.Tensor | None = None,
                  doc_valid: torch.Tensor | None = None,
                  *, scales: torch.Tensor | None = None,
                  operand: tuple | None = None) -> torch.Tensor:
    """q [B,Q,d], docs [N,D,d] (f32/bf16, or int8 codes with ``scales``
    [N,D] f32) -> scores [B,N] (f32).

    ``doc_valid`` [N] bool marks live documents in a capacity-padded store;
    dead slots score NEG so they can never enter a top-k on merit. The mask
    is applied to the kernel OUTPUT: the kernel still streams the full
    padded corpus. ``operand`` is a ``scan_query_operand`` of (q, q_mask)
    built once for repeated scans of one query batch (the tensor route);
    one of another shape or device is refused."""
    B, Q, d = q.shape
    N, D, _ = docs.shape
    if q_mask is None:
        q_mask = _ones_mask((B, Q), q.device)
    if DSP.shapes_only(docs):
        DSP.record_cost("maxsim_scan_int8" if scales is not None
                        else "maxsim_scan",
                        *scan_cost(q, q_mask, docs, doc_mask, scales),
                        (q, q_mask, docs, doc_mask, scales))
        out = docs.new_empty((B, N), dtype=torch.float32)
    elif DSP.on_cuda(docs):
        cap = _tensor_cap(q, docs, "maxsim_scan")
        if not cap:
            _check_query_smem(q, "maxsim_scan", warp_query_cap(d))
        out = _scan_launch("maxsim_scan", "maxsim_scan_int8"
                           if scales is not None else "maxsim_scan",
                           q, q_mask, docs, doc_mask, scales, cap,
                           operand if cap else None)
    else:
        if doc_mask is None:
            doc_mask = _ones_mask((1, D), docs.device)
        out = maxsim_ref(q, q_mask, docs, doc_mask, scales)
    if doc_valid is not None:
        out = out.masked_fill(~doc_valid[None, :], NEG)
    return out


def maxsim_chunked_ref(q: torch.Tensor, docs: torch.Tensor,
                       q_mask: torch.Tensor | None = None,
                       doc_mask: torch.Tensor | None = None,
                       doc_valid: torch.Tensor | None = None,
                       *, chunk: int,
                       scales: torch.Tensor | None = None) -> torch.Tensor:
    """The chunked scans' plain version on any device: ``maxsim_ref`` over
    ``chunk`` documents at a time, so the [B, chunk, Q, D] similarity
    block (and, for int8, the dequantised [chunk, D, d] copy) is bounded
    whatever N is. A broadcast [1, D] mask is passed to every chunk
    whole; an [N, D] mask is sliced with the documents."""
    B, Q, _ = q.shape
    N, D, _ = docs.shape
    if q_mask is None:
        q_mask = _ones_mask((B, Q), q.device)
    if doc_mask is None:
        doc_mask = _ones_mask((1, D), docs.device)
    chunk = chunk if 0 < chunk < N else max(N, 1)
    out = torch.cat([
        maxsim_ref(q, q_mask, docs[i:i + chunk],
                   doc_mask if doc_mask.shape[0] == 1
                   else doc_mask[i:i + chunk],
                   None if scales is None else scales[i:i + chunk])
        for i in range(0, max(N, 1), chunk)], dim=1)
    if doc_valid is not None:
        out = out.masked_fill(~doc_valid[None, :], NEG)
    return out


def maxsim_scores_pipelined(q: torch.Tensor, docs: torch.Tensor,
                            q_mask: torch.Tensor | None = None,
                            doc_mask: torch.Tensor | None = None,
                            doc_valid: torch.Tensor | None = None,
                            *, chunk: int,
                            scales: torch.Tensor | None = None,
                            operand: tuple | None = None
                            ) -> torch.Tensor:
    """The double-buffered streaming scan: for CUDA tensors ONE launch of
    ``csrc/maxsim_scan_db.cu``, which streams the corpus through a ring
    of shared-memory tiles (the copies of the next tiles in flight while
    one is scored). Its route is the scan's, as the scan library states
    it: on the tensor route it launches the scan's tensor-core kernel
    over the packed query (``operand``, as in ``maxsim_scores``), on the
    warp route its own f32 kernel. Its tiles are its own, so ``chunk``
    only sets the plain version's chunk and changes no score. For CPU
    tensors, ``maxsim_chunked_ref``."""
    B, Q, _ = q.shape
    if DSP.shapes_only(docs):
        DSP.record_cost("maxsim_scan_db",
                        *scan_cost(q, q_mask, docs, doc_mask, scales),
                        (q, q_mask, docs, doc_mask, scales))
        out = docs.new_empty((B, docs.shape[0]), dtype=torch.float32)
        return out if doc_valid is None else out.masked_fill(
            ~doc_valid[None, :], NEG)
    if not DSP.on_cuda(docs):
        return maxsim_chunked_ref(q, docs, q_mask, doc_mask, doc_valid,
                                  chunk=chunk, scales=scales)
    if q_mask is None:
        q_mask = _ones_mask((B, Q), q.device)
    cap = _tensor_cap(q, docs, "maxsim_scan_db")
    out = _scan_launch("maxsim_scan_db", "maxsim_scan_db", q, q_mask, docs,
                       doc_mask, scales, cap, operand if cap else None)
    if doc_valid is not None:
        out = out.masked_fill(~doc_valid[None, :], NEG)
    return out


def maxsim_scores_chunked(q: torch.Tensor, docs: torch.Tensor,
                          q_mask: torch.Tensor | None = None,
                          doc_mask: torch.Tensor | None = None,
                          doc_valid: torch.Tensor | None = None,
                          *, chunk: int,
                          scales: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Streaming corpus scan in ``chunk``-document steps; chunk <= 0 (or
    >= N) means unchunked (``maxsim_scores``). Otherwise the double-
    buffered scan ``maxsim_scores_pipelined``: one kernel launch on the
    card, the plain chunked loop on the CPU. ``doc_valid`` [N] bool NEGs
    dead capacity-padding slots, applied once on the [B, N] output."""
    N = docs.shape[0]
    if chunk <= 0 or chunk >= N:
        return maxsim_scores(q, docs, q_mask, doc_mask, doc_valid,
                             scales=scales)
    return maxsim_scores_pipelined(q, docs, q_mask, doc_mask, doc_valid,
                                   chunk=chunk, scales=scales)


# ---------------------------------------------------------------------------
# fused gather + MaxSim rerank
# ---------------------------------------------------------------------------

def _rerank_ref(q, docs, rows, q_mask, doc_mask, scales=None):
    """The rerank's plain version: per query, gather (and dequantise) the
    candidate rows and score them with ``core.maxsim.maxsim_scan``'s math
    — no NEG/2 floor, so a fully masked candidate scores Qv*NEG. The
    gathered copy is [L, D, d] for one query at a time."""
    full_f32()
    out = []
    for b in range(q.shape[0]):
        cl = rows[b].long()
        dv = dequantize(docs[cl], None if scales is None else scales[cl])
        sim = torch.einsum("qd,njd->nqj", q[b].float(), dv)
        if doc_mask is not None:
            dm = doc_mask if doc_mask.shape[0] == 1 else doc_mask[cl]
            sim.masked_fill_(~(dm > 0)[:, None, :], NEG)
        best = sim.amax(dim=-1)                            # [L, Q]
        best = torch.where((q_mask[b] > 0)[None, :], best, 0.0)
        out.append(best.sum(dim=-1))
    return torch.stack(out) if out else q.new_zeros((0, rows.shape[1]))


def _rerank_cuda(q, q_mask, docs, rows, doc_mask, scales,
                 operand) -> torch.Tensor:
    """Launch ``maxsim_rerank_launch``: [B, L] f32 scores (no floor). The
    route is the scan library's rule for the documents: the tensor route
    reads the packed query (``scan_query_operand``, built here unless
    given) and takes any Q; the warp route holds Q token slots up to
    ``warp_query_cap``."""
    B, Q, d = q.shape
    N, D, _ = docs.shape
    L = rows.shape[1]
    tensor = scan_route(docs.dtype, D, d) == "tensor"
    if not tensor:
        _check_query_smem(q, "maxsim_rerank", warp_query_cap(d))
    qf, qm, dtype, sc = _kernel_inputs(q, q_mask, docs, scales,
                                       "maxsim_rerank")
    if tensor:
        _check_aligned_16(docs, "maxsim_rerank")
    out = torch.empty((B, L), dtype=torch.float32, device=docs.device)
    if B == 0 or L == 0:
        return out
    rows = rows.to(device=docs.device, dtype=torch.int32).contiguous()
    dm, stride = _mask_arg(doc_mask, N, D, docs.device)
    extra = [0, 0, 0]
    if tensor:
        if operand is None:
            operand = scan_query_operand(qf, qm)
        _check_operand(operand, B, Q, d, docs.device, "maxsim_rerank")
        extra = [t.data_ptr() for t in operand]
    lib = build.library("maxsim_rerank")
    with torch.cuda.device(docs.device):
        rc = lib.maxsim_rerank_launch(
            rows.data_ptr(), qf.data_ptr(), qm.data_ptr(), docs.data_ptr(),
            dtype, _ptr(sc), dm.data_ptr(), stride, out.data_ptr(), B, L, Q,
            D, d, *extra, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "maxsim_rerank")
    DSP.record("maxsim_rerank_int8" if scales is not None
               else "maxsim_rerank")
    return out


def maxsim_rerank(q: torch.Tensor, docs: torch.Tensor, rows: torch.Tensor,
                  q_mask: torch.Tensor | None = None,
                  doc_mask: torch.Tensor | None = None,
                  ok: torch.Tensor | None = None,
                  *, scales: torch.Tensor | None = None,
                  operand: tuple | None = None) -> torch.Tensor:
    """Fused gather + exact MaxSim rerank: q [B,Q,d], docs [N,D,d] (float,
    or int8 codes with ``scales`` [N,D]), rows [B,L] candidate slot ids ->
    scores [B,L] f32.

    ``rows`` are clipped in-range; ``ok`` [B,L] bool marks candidates the
    caller actually owns — the rest score NEG so they can never win a
    top-k slot on merit. ``doc_mask`` is [N,D], a broadcast [1,D] row, or
    None (a broadcast all-ones row). Matryoshka stores (docs narrower than
    q) score against the matching query prefix. ``operand`` is a
    ``scan_query_operand`` of that (prefix) query for the tensor route,
    built once for repeated calls; one of another shape is refused."""
    B, Q, d = q.shape
    N, D, dd = docs.shape
    if dd < d:                                # Matryoshka rerank stage
        q = q[..., :dd]
    rows = rows.clamp(0, N - 1)
    if q_mask is None:
        q_mask = _ones_mask((B, Q), q.device)
    if DSP.shapes_only(docs):
        DSP.record_cost("maxsim_rerank_int8" if scales is not None
                        else "maxsim_rerank",
                        *rerank_cost(q, q_mask, docs, rows, doc_mask,
                                     scales),
                        (q, q_mask, docs, rows, doc_mask, scales))
        out = docs.new_empty(tuple(rows.shape), dtype=torch.float32)
    elif DSP.on_cuda(docs):
        out = _rerank_cuda(q, q_mask, docs, rows, doc_mask, scales,
                           operand)
    else:
        out = _rerank_ref(q, docs, rows, q_mask, doc_mask, scales)
    if ok is not None:
        out = out.masked_fill(~ok, NEG)
    return out


# ---------------------------------------------------------------------------
# IVF centroid routing
# ---------------------------------------------------------------------------

def centroid_scores_ref(q: torch.Tensor, centroids: torch.Tensor,
                        q_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The routing score's plain version: the masked query sum times the
    transposed centroids, q [B,Q,d], centroids [K,dc] -> [B,K] f32, with
    the query's first dc dims when the centroids are narrower."""
    full_f32()
    dc = centroids.shape[1]
    q = q[..., :dc].float()
    if q_mask is not None:
        q = q * q_mask[..., None].float()
    return q.sum(dim=-2) @ centroids.float().T


def centroid_scores(q: torch.Tensor, centroids: torch.Tensor,
                    q_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Query-vs-centroid routing scores: q [B,Q,d], centroids [K,dc] ->
    [B,K] f32.

    For CUDA tensors: the scan kernel (``csrc/maxsim_scan.cu``) on the
    centroids as K one-vector f32 documents with an all-ones mask, counted
    as ``ivf_route``; it sums the valid tokens' products in another order
    than the plain product, so the two agree to float tolerance. For CPU
    tensors: ``centroid_scores_ref``. Narrower (Matryoshka) centroids
    score against the matching query prefix."""
    B, Q, d = q.shape
    dc = centroids.shape[1]
    if not DSP.on_cuda(centroids):
        return centroid_scores_ref(q, centroids, q_mask)
    if dc < d:
        q = q[..., :dc]
    if q_mask is None:
        q_mask = _ones_mask((B, Q), q.device)
    _check_query_smem(q, "centroid_scores", warp_query_cap(dc))
    docs = centroids.float()[:, None, :].contiguous()           # [K, 1, dc]
    # f32 one-vector documents: the warp route (the launcher refuses a
    # warp call for a shape of the tensor route)
    return _scan_launch("maxsim_scan", "ivf_route", q, q_mask, docs, None,
                        None)


# ---------------------------------------------------------------------------
# streamed scan top-k
# ---------------------------------------------------------------------------

def _merge_topk(vals, ids, new_vals, new_ids, k: int) -> tuple:
    """(vals, ids) [B, k] running winners + a chunk's [B, kb] locals ->
    merged [B, k]; ties keep the carry first (``top_k`` is stable)."""
    v, sel = top_k(torch.cat([vals, new_vals], dim=1), k)
    return v, torch.gather(torch.cat([ids, new_ids], dim=1), 1, sel)


def maxsim_topk_chunked(q: torch.Tensor, docs: torch.Tensor,
                        q_mask: torch.Tensor | None = None,
                        doc_mask: torch.Tensor | None = None,
                        doc_valid: torch.Tensor | None = None,
                        *, k: int, chunk: int,
                        scales: torch.Tensor | None = None,
                        use_kernel: bool = True) -> tuple:
    """Streaming corpus scan with a RUNNING per-query top-k: returns
    (vals [B, k], local ids [B, k]) without ever assembling the [B, N]
    score matrix.

    Each step scores one ``chunk``-document block (``maxsim_scores``: the
    scan kernel on the card; with ``use_kernel=False`` its plain version
    on any device), NEGs dead ``doc_valid`` slots BEFORE the block's
    local top-k, selects the block's top ``min(k, chunk)`` and merges
    them into the carry. Ids are local and always < N: the last block is
    padded to ``chunk`` with slots scored -inf, strictly below every real
    slot (a fully token-masked live document scores Q*NEG, below the
    dead-slot NEG but finite), and the carry is seeded with -inf, so with
    k <= N real slots a padding id never leaks out."""
    B = q.shape[0]
    N = docs.shape[0]
    k = min(k, N)

    operand = None
    if (use_kernel and not DSP.shapes_only(docs) and DSP.on_cuda(docs)
            and B and N
            and scan_route(docs.dtype, docs.shape[1], q.shape[-1])
            == "tensor"):
        # one packed query operand for every chunk's launch
        qm = _ones_mask(q.shape[:2], docs.device) if q_mask is None \
            else q_mask.to(device=docs.device, dtype=torch.float32)
        operand = scan_query_operand(
            q.to(device=docs.device, dtype=torch.float32), qm)

    def score(lo, hi):
        dm = doc_mask
        if dm is not None and dm.shape[0] != 1:
            dm = dm[lo:hi]
        sc = None if scales is None else scales[lo:hi]
        if use_kernel:
            return maxsim_scores(q, docs[lo:hi], q_mask, dm, scales=sc,
                                 operand=operand)
        return maxsim_chunked_ref(q, docs[lo:hi], q_mask, dm, chunk=0,
                                  scales=sc)

    if chunk <= 0 or chunk >= N:
        s = score(0, N)
        if doc_valid is not None:
            s = s.masked_fill(~doc_valid[None, :], NEG)
        return top_k(s, k)
    kb = min(k, chunk)
    vals = torch.full((B, k), -torch.inf, dtype=torch.float32,
                      device=docs.device)
    ids = torch.zeros((B, k), dtype=torch.int64, device=docs.device)
    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        s = score(lo, hi)
        if doc_valid is not None:
            s = s.masked_fill(~doc_valid[None, lo:hi], NEG)
        if hi - lo < chunk:                    # chunk padding sinks to -inf
            s = torch.cat([s, s.new_full((B, chunk - (hi - lo)),
                                         -torch.inf)], dim=1)
        v, i = top_k(s, kb)
        vals, ids = _merge_topk(vals, ids, v, i + lo, k)
    return vals, ids


# ---------------------------------------------------------------------------
# int8 quantisation
# ---------------------------------------------------------------------------

def _quantize_block(docs: torch.Tensor, eps: float) -> tuple:
    amax = docs.abs().float().amax(dim=-1)
    # the JAX reference's `max(amax, eps) / 127.0` compiles to a product
    # with the f32 reciprocal; the per-element division below is a real
    # division there and here, so codes and scales agree bit for bit. The
    # f32 reciprocal is filled on the device: a copy from the host would
    # make the host wait for the device's queue
    inv = torch.full((), float(_INV_127), dtype=torch.float32,
                     device=docs.device)
    scales = amax.clamp_min(eps) * inv
    codes = torch.round(docs.float() / scales[..., None]).clamp_(-127, 127)
    return codes.to(torch.int8), scales


def quantize_int8(docs: torch.Tensor, eps: float = 1e-9,
                  chunk: int = 0) -> tuple:
    """Per-vector symmetric int8 quantisation: docs [..., d] (any float
    type) -> (int8 codes [..., d], f32 scales [...]), rounding half to
    even. ``chunk`` > 0 processes the leading axis in slabs of that many
    rows, bounding the f32 transient at [chunk, ..., d]."""
    if 0 < chunk < docs.shape[0]:
        parts = [_quantize_block(docs[i:i + chunk], eps)
                 for i in range(0, docs.shape[0], chunk)]
        return (torch.cat([c for c, _ in parts]),
                torch.cat([s for _, s in parts]))
    return _quantize_block(docs, eps)
