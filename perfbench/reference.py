"""The plain reference: the cascade of a cell worked out again from the
regenerated raw pages, and the comparison that decides ``correct``.

Plain PyTorch on the same device as the run, float32 with TF32 off. It
imports nothing of the program: from the generator's raw pages it redoes
token hygiene (the leading specials and zero-vector padding dropped),
the model-aware pooling (tile means; or masked row means, same-length
smoothing and adaptive row bins for the dynamic geometry, at each page's
own ``h_eff``), the global vector, the store's bfloat16 rounding and the
int8 codes of quantised stages, and scores every stage with MaxSim.

Pooled and global vectors are the program's own float32 arithmetic in
another order, stored in bf16: the reference carries, per coordinate, the
bf16 values an honest program may store (``StageVecs``), so each stage's
score is an interval. The comparison judges the program's served lists
(page ids and scores, the last stage's ``k`` of them per query) against
those intervals, with a tie band ``TIE_BAND`` around each stage's cut-off
for the kernels' float32 accumulation, so that a page whose score may lie
on either side of a cut may be kept or left:

- ``score_gap``: the widest |served score - the reference's score of that
  page| (the last stage's scoring);
- ``select_gap``: the widest of two selection gaps: by how much a served
  page lies below a stage's cut-off (the k-th best score among the pages
  that every honest cascade keeps) at any stage before the last (scan
  and top-k), and by how much the r-th served page's reference score
  lies below the r-th best among the pages every honest cascade reranks
  last (selection, order, and candidates left out).

An id out of range, repeated, or -1 reads ``inf``. ``control=True`` also
runs the control: this same cascade in the place of the program, its
operands rounded to TF32 (10 mantissa bits, the precision a float32
product falls to with TF32 on), judged the same way.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from perfbench import corpus as C

# scores within this of a stage's cut-off may be kept or left by either
# side; pages further than this above the cut must be kept
TIE_BAND = 1e-3
# float32 distance between the program's value of a derived (pooled or
# global) vector coordinate and this one, summed in another order: unit
# vectors of at most 784 tokens, far below 2**-17
DERIVED_ERR = 2 ** -17
NUMBERS = ("score_gap", "select_gap")


@dataclass(frozen=True)
class RefStage:
    vector: str        # initial | mean_pooling | global_pooling
    k: int
    int8: bool = False


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 explicit mantissa bits, to nearest
    even."""
    i = x.float().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


# ---------------------------------------------------------------------------
# the index path, plain
# ---------------------------------------------------------------------------

def hygiene(raw: torch.Tensor, geo: C.Geometry) -> tuple:
    """Raw pages [P, S, d] -> (visual tokens [P, n_vis, d] with masked ones
    zeroed, keep [P, n_vis] bool): specials lead and are dropped,
    zero-vector padding tokens are masked."""
    vis = raw[:, geo.n_special:]
    keep = torch.linalg.vector_norm(vis, dim=-1) >= 1e-6
    return vis * keep[..., None].to(vis.dtype), keep


def _masked_mean(x, m, dim):
    m = m.to(x.dtype)[..., None]
    return (x * m).sum(dim) / m.sum(dim).clamp_min(1.0)


def _l2(x):
    return x / torch.linalg.vector_norm(x, dim=-1,
                                        keepdim=True).clamp_min(1e-9)


def _smooth(rows: torch.Tensor, kind: str) -> torch.Tensor:
    """Same-length k=3 Gaussian smoothing over the row axis (sigma 0.5),
    weights renormalised over the in-range neighbours (Eq. 5)."""
    if kind == "none":
        return rows
    if kind != "gaussian":
        raise ValueError(f"no reference smoothing {kind!r}")
    w = (math.exp(-2.0), 1.0, math.exp(-2.0))
    n = rows.shape[-2]
    out = torch.zeros_like(rows)
    z = torch.zeros(n, dtype=rows.dtype, device=rows.device)
    for off, wt in zip((-1, 0, 1), w):
        lo, hi = max(0, -off), min(n, n - off)
        out[..., lo:hi, :] += wt * rows[..., lo + off:hi + off, :]
        z[lo:hi] += wt
    return out / z[:, None]


def pooled(vis, keep, geo: C.Geometry, h_eff) -> tuple:
    """Model-aware pooling: (pooled [P, n_pooled, d] f32, mask)."""
    P, _, d = vis.shape
    if geo.kind == "tiles":
        out = _masked_mean(vis.view(P, geo.rows, geo.row_w, d),
                           keep.view(P, geo.rows, geo.row_w), 2)
        mask = torch.ones(out.shape[:2], dtype=torch.bool,
                          device=vis.device)
    elif geo.kind == "dynamic":
        rows = _masked_mean(vis.view(P, geo.rows, geo.row_w, d),
                            keep.view(P, geo.rows, geo.row_w), 2)
        rows = _smooth(rows, geo.smooth)
        h = h_eff.long()[:, None]                              # [P, 1]
        t = h.clamp_max(geo.max_rows)
        j = torch.arange(geo.rows, device=vis.device)[None, :]
        bins = torch.where(j < h, (j * t) // h, geo.max_rows)  # [P, R]
        one = (bins[..., None] == torch.arange(
            geo.max_rows, device=vis.device)).to(rows.dtype)   # [P, R, T]
        cnt = one.sum(1)                                       # [P, T]
        out = torch.einsum("prd,prt->ptd", rows, one) / \
            cnt.clamp_min(1.0)[..., None]
        mask = cnt > 0
    else:
        raise ValueError(f"no reference pooling for {geo.kind!r}")
    return _l2(out), mask


def global_vector(vis, keep) -> torch.Tensor:
    return _l2(_masked_mean(vis, keep, 1))


def int8_dequant(x: torch.Tensor) -> torch.Tensor:
    """Per-vector symmetric int8 codes of x (half to even), dequantised."""
    x = x.float()
    s = x.abs().amax(-1).clamp_min(1e-9) * torch.tensor(
        1.0 / 127.0, dtype=torch.float32, device=x.device)
    return torch.round(x / s[..., None]).clamp(-127, 127) * s[..., None]


@dataclass
class StageVecs:
    """One stage's stored vectors for some pages, as the reference stores
    them (``v``: bf16 values, or dequantised int8 codes) and, for vectors
    the program derives itself (pooled, global), the per-coordinate
    bounds ``lo``/``hi`` of what an honest program may store (None where
    it must store exactly ``v``)."""
    v: torch.Tensor
    lo: torch.Tensor | None
    hi: torch.Tensor | None
    mask: torch.Tensor | None


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _int8_bounds(lo, hi) -> tuple:
    """Bounds of the dequantised int8 codes of any vector lying between
    ``lo`` and ``hi`` coordinate by coordinate: its scale comes from the
    smallest or the largest possible max |x|, its codes from the lowest or
    highest x."""
    inv = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=lo.device)
    big = torch.maximum(lo.abs(), hi.abs()).amax(-1)
    small = torch.where(lo * hi > 0, torch.minimum(lo.abs(), hi.abs()),
                        torch.zeros_like(lo)).amax(-1)
    outs = [torch.round(x / s[..., None]).clamp(-127, 127) * s[..., None]
            for x in (lo, hi)
            for s in (small.clamp_min(1e-9) * inv, big.clamp_min(1e-9) * inv)]
    return (torch.stack(outs).amin(0), torch.stack(outs).amax(0))


def stage_vectors(name: str, raw, geo, h_eff, int8: bool) -> StageVecs:
    """The stored vectors of one stage for raw pages. ``initial`` is the
    hygiene'd encoder output in bf16, which the program stores exactly.
    A pooled or global vector is float32 arithmetic summed in the
    program's own order: its float32 value may lie ``DERIVED_ERR`` from
    this one, so a coordinate that close to a bf16 rounding boundary may
    round to either neighbour (one bf16 step can move a topical page's
    score by ~1e-3, every query token taking its max on that vector)."""
    vis, keep = hygiene(raw, geo)
    if name == "initial":
        return StageVecs(_bf16(vis), None, None, keep)
    if name == "mean_pooling":
        v32, m = pooled(vis, keep, geo, h_eff)
    elif name == "global_pooling":
        v32, m = global_vector(vis, keep), None
    else:
        raise ValueError(name)
    v = _bf16(v32)
    lo, hi = _bf16(v32 - DERIVED_ERR), _bf16(v32 + DERIVED_ERR)
    if int8:
        v = int8_dequant(v)
        lo, hi = _int8_bounds(lo, hi)
    return StageVecs(v, lo, hi, m)


# ---------------------------------------------------------------------------
# scores
# ---------------------------------------------------------------------------

def scores(q, qm, v, m, low: bool = False) -> torch.Tensor:
    """MaxSim of queries q [B, Q, d] (mask qm) against pages v [n, D, d]
    (mask m) or one vector a page [n, d]: [B, n] f32. ``low`` rounds the
    operands to TF32 first."""
    qm = qm.to(torch.float32)
    if low:
        q, v = tf32(q), tf32(v)
    if v.ndim == 2:
        qs = (q * qm[..., None]).sum(1)
        if low:
            qs = tf32(qs)
        return qs @ v.T
    sim = torch.einsum("bqd,njd->bnqj", q, v)
    if m is not None:
        sim.masked_fill_(~m[None, :, None, :], -torch.inf)
    best = sim.amax(-1)                                    # [B, n, Q]
    return (best * qm[:, None, :]).sum(-1)


def score_bounds(q, qm, sv: StageVecs) -> tuple:
    """(lowest, highest) MaxSim [B, n] that pages stored anywhere within
    ``sv``'s bounds can score: each similarity lies within q . mid +- |q| .
    rad, and the max over a page's vectors and the sum over tokens keep
    the order."""
    if sv.lo is None:
        s = scores(q, qm, sv.v, sv.mask)
        return s, s
    mid, rad = (sv.lo + sv.hi) / 2, (sv.hi - sv.lo) / 2
    qm = qm.to(torch.float32)
    if mid.ndim == 2:
        qs = (q * qm[..., None]).sum(1)
        c, r = qs @ mid.T, qs.abs() @ rad.T
        return c - r, c + r
    c = torch.einsum("bqd,njd->bnqj", q, mid)
    r = torch.einsum("bqd,njd->bnqj", q.abs(), rad)
    out = []
    for sim in (c - r, c + r):
        if sv.mask is not None:
            sim.masked_fill_(~sv.mask[None, :, None, :], -torch.inf)
        out.append((sim.amax(-1) * qm[:, None, :]).sum(-1))
    return tuple(out)


def _kth(x: torch.Tensor, sets: torch.Tensor, k: int) -> torch.Tensor:
    """Per row, the k-th best of x over the True entries of ``sets``
    (-inf where a row has fewer than k)."""
    v = torch.where(sets, x, -torch.inf)
    kk = min(k, v.shape[1])
    out = torch.topk(v, kk, dim=1).values[:, -1]
    return torch.where(sets.sum(1) >= k, out, -torch.inf)


@dataclass
class Served:
    ids: torch.Tensor          # [B, K] int64 page ids (-1 = none)
    scores: torch.Tensor       # [B, K] f32


def _stage_scores(spec, seed, tab, stage, pages_needed, q, qm, low,
                  chunk):
    """Dense [B, N] bounds of one stage's scores (-inf off
    ``pages_needed``): (lowest, highest, the control's TF32 scores or
    None)."""
    B, N = q.shape[0], spec.pages
    dev = q.device
    out = [torch.full((B, N), -torch.inf, device=dev)
           for _ in range(3 if low else 2)]
    ids_all = pages_needed if pages_needed is not None else \
        torch.arange(N, device=dev)
    for lo in range(0, ids_all.shape[0], chunk):
        ids = ids_all[lo:lo + chunk]
        raw = C.pages(spec, seed, tab, ids)
        sv = stage_vectors(stage.vector, raw, spec.geo, tab.h_eff[ids],
                           stage.int8)
        del raw
        out[0][:, ids], out[1][:, ids] = score_bounds(q, qm, sv)
        if low:
            out[2][:, ids] = scores(q, qm, sv.v, sv.mask, low=True)
    return out[0], out[1], out[2] if low else None


def _chunk_of(stage: RefStage) -> int:
    # bound the [B, n, Q, D] similarity block
    return 64 if stage.vector == "initial" else 512


def cascade(spec, seed, tab, stages: tuple, q, qm, served: list,
            control: bool = False) -> dict:
    """Judge ``served`` (a list of ``Served``; the program's, and the
    control's is added with ``control``) against the reference cascade.
    Returns {"readings": [dict per served list], "control": Served or
    None}."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _cascade(spec, seed, tab, stages, q, qm, served, control)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _cascade(spec, seed, tab, stages, q, qm, served, control):
    B, N = q.shape[0], spec.pages
    dev = q.device
    for s in served:
        s.ids = s.ids.to(dev)
        s.scores = s.scores.to(dev).float()
    served_pages = torch.cat([s.ids.clamp(0, N - 1).reshape(-1)
                              for s in served])
    S, lows = [], []        # per stage: dense [B, N] (lowest, highest)
    M = U = torch.ones((B, N), dtype=torch.bool, device=dev)
    lo_cut = []
    ctrl = torch.ones((B, N), dtype=torch.bool, device=dev) \
        if control else None
    for si, st in enumerate(stages):
        need = None
        if si > 0:
            mark = U.any(0)
            mark[served_pages] = True
            if control:
                mark |= ctrl.any(0)
            need = torch.nonzero(mark).flatten()
        s_lo, s_hi, s_ctrl = _stage_scores(spec, seed, tab, st, need, q, qm,
                                           control, _chunk_of(st))
        S.append((s_lo, s_hi))
        # the cut of every honest cascade lies in [lo, hi]
        lo = _kth(s_lo, M, st.k)
        hi = _kth(s_hi, U, st.k)
        lo_cut.append(lo)
        if si < len(stages) - 1:
            M = M & (s_lo > hi[:, None] + TIE_BAND)
            U = U & (s_hi >= lo[:, None] - TIE_BAND)
        if control:
            v = torch.where(ctrl, s_ctrl, -torch.inf)
            top = torch.topk(v, min(st.k, N), dim=1)
            keep = torch.zeros_like(ctrl)
            keep.scatter_(1, top.indices, True)
            ctrl = ctrl & keep
            lows.append(top)
    out = {"control": None}
    if control:
        last = lows[-1]
        out["control"] = Served(last.indices, last.values)
        served = served + [out["control"]]
    out["readings"] = [_judge(s, S, lo_cut, M, stages, N) for s in served]
    return out


def _judge(sv: Served, S: list, lo_cut: list, M_last, stages, N) -> dict:
    ids, sc = sv.ids, sv.scores
    B, K = ids.shape
    bad = (ids < 0) | (ids >= N)
    srt = torch.sort(ids, dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]).any(1)
    if bool(bad.any()) or bool(dup.any()):
        return {n: math.inf for n in NUMBERS}
    last_lo, last_hi = S[-1]
    ref_lo = torch.gather(last_lo, 1, ids)
    ref_hi = torch.gather(last_hi, 1, ids)
    if not bool(torch.isfinite(ref_lo).all()):
        return {n: math.inf for n in NUMBERS}
    score_gap = torch.maximum(ref_lo - sc, sc - ref_hi).clamp_min(0).max()
    cut = torch.zeros((), device=ids.device)
    for si in range(len(stages) - 1):
        below = lo_cut[si][:, None] - torch.gather(S[si][1], 1, ids)
        cut = torch.maximum(cut, below.max())
    best = torch.topk(torch.where(M_last, last_lo, -torch.inf), K,
                      dim=1).values                       # [B, K]
    rank = torch.where(torch.isfinite(best), best - ref_hi,
                       torch.zeros_like(ref_hi)).max()
    return {"score_gap": float(score_gap),
            "select_gap": max(float(cut), float(rank), 0.0),
            "cut": float(cut), "rank": float(rank)}
