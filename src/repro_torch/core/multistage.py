"""Multi-stage retrieval (paper §2.4) — reference single-device semantics.

Each page is stored under named vectors:
  - ``initial``        full multi-vector set (~700–1024 x d), exact MaxSim
  - ``mean_pooling``   compact pooled set (~13–34 x d)
  - ``global_pooling`` one vector per page

A retrieval config is a cascade of stages; stage i scores only the
candidates surviving stage i-1 and keeps its top-``k``:

  1-stage:  [Stage("initial", k)]                       (exact baseline)
  2-stage:  [Stage("mean_pooling", K), Stage("initial", k)]
  3-stage:  [Stage("global_pooling", K0), Stage("mean_pooling", K),
             Stage("initial", k)]

The serving engine (``repro_torch.retrieval.engine``) executes the same
cascade over a segmented store; ``search`` here is its oracle in tests.

Selection is ``top_k``: a stable descending sort, so equal scores keep the
lower index first — the order ``jax.lax.top_k`` gives. Dead slots and
filler all score NEG, so which ids fill a result when k exceeds the live
documents depends on exactly this tie order.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.core import maxsim as ms
from repro_torch.kernels.maxsim.ref import dequantize, top_k


@dataclass(frozen=True)
class Stage:
    """One cascade stage plus its dispatch policy.

    The policy fields only affect execution by the serving engine; this
    module's ``search`` is the plain oracle and ignores them.

    use_kernel     score the full-corpus scan (first) stage with the CUDA
                   scan kernels (``kernels.maxsim.ops``): the scan, or with
                   ``chunk`` the double-buffered scan in one launch;
                   single-vector scans stay one matrix product
    chunk          > 0 scans the corpus in chunks of that many documents,
                   bounding the plain scan's [B, chunk, Q, D] similarity
                   block (scores do not depend on it)
    dtype          the scan stage's compute type (a torch dtype name such
                   as "bfloat16"): the query, and float documents, are
                   cast to it before scoring; int8 codes stay int8. The
                   CUDA kernels read the cast query widened back to f32,
                   which holds the same values
    scan_topk      stream a RUNNING per-query top-k across corpus chunks
                   (``kernels.maxsim.ops.maxsim_topk_chunked``; chunk
                   ``DEFAULT_SCAN_TOPK_CHUNK`` when ``chunk`` is 0) instead
                   of assembling the [B, N] score matrix and selecting
                   globally. Single-vector scans keep score-then-select
    rerank_kernel  score this rerank (non-first) stage with the fused
                   gather + MaxSim kernel (``kernels.maxsim.ops
                   .maxsim_rerank``) instead of gathering a [B, L, D, d]
                   candidate copy; single-vector rerank stages ignore it
    n_probe        IVF routing for the scan (first) stage: > 0 scores the
                   query against each segment's [K, d] centroids
                   (``kernels.maxsim.ops.centroid_scores``, the scan kernel
                   with ``use_kernel``), keeps the top ``n_probe`` clusters
                   and scores only their member slots, through the rerank
                   machinery (the gather-rerank kernel with ``use_kernel``
                   or ``rerank_kernel``); ``chunk`` and ``scan_topk`` do
                   not apply. ``n_probe == n_clusters`` recovers the
                   exhaustive candidate set (every live slot sits in
                   exactly one member list)
    n_clusters     the per-segment K the store was clustered with; a
                   record for the reader — the store's own clustering
                   (``SegmentedStore.enable_routing``) is what runs

    ``search`` below is always exhaustive: it ignores ``n_probe``.
    """
    vector: str            # named vector to score with
    k: int                 # candidates kept after this stage
    use_kernel: bool = False
    chunk: int = 0
    dtype: str | None = None
    scan_topk: bool = False
    rerank_kernel: bool = False
    n_probe: int = 0
    n_clusters: int = 0


# default corpus chunk for a streamed scan top-k whose stage did not set one
DEFAULT_SCAN_TOPK_CHUNK = 1024


def with_scan_policy(stages: tuple, *, use_kernel: bool | None = None,
                     chunk: int | None = None,
                     dtype: str | None = None,
                     scan_topk: bool | None = None) -> tuple:
    """Return ``stages`` with the scan (first) stage's dispatch policy
    replaced; ``None`` keeps the existing value."""
    first, rest = stages[0], tuple(stages[1:])
    kw = {}
    if use_kernel is not None:
        kw["use_kernel"] = use_kernel
    if chunk is not None:
        kw["chunk"] = chunk
    if dtype is not None:
        kw["dtype"] = dtype
    if scan_topk is not None:
        kw["scan_topk"] = scan_topk
    return (dataclasses.replace(first, **kw),) + rest


def with_routing_policy(stages: tuple, *, n_probe: int | None = None,
                        n_clusters: int | None = None) -> tuple:
    """Return ``stages`` with the scan (first) stage's IVF routing policy
    replaced; ``None`` keeps the existing value."""
    first, rest = stages[0], tuple(stages[1:])
    kw = {}
    if n_probe is not None:
        kw["n_probe"] = n_probe
    if n_clusters is not None:
        kw["n_clusters"] = n_clusters
    return (dataclasses.replace(first, **kw),) + rest


def with_rerank_policy(stages: tuple, *,
                       rerank_kernel: bool | None = None) -> tuple:
    """Return ``stages`` with every RERANK (non-first) stage's dispatch
    policy replaced; ``None`` keeps the existing values."""
    if rerank_kernel is None or len(stages) <= 1:
        return tuple(stages)
    return (stages[0],) + tuple(
        dataclasses.replace(s, rerank_kernel=rerank_kernel)
        for s in stages[1:])


def two_stage(prefetch_k: int = 256, top_k: int = 100,
              pooled: str = "mean_pooling") -> tuple:
    return (Stage(pooled, prefetch_k), Stage("initial", top_k))


def three_stage(k0: int = 1024, prefetch_k: int = 256, top_k: int = 100,
                pooled: str = "mean_pooling") -> tuple:
    return (Stage("global_pooling", k0), Stage(pooled, prefetch_k),
            Stage("initial", top_k))


def one_stage(top_k: int = 100) -> tuple:
    return (Stage("initial", top_k),)


def _store_accessors():
    """The store's key schema is owned by ``repro_torch.retrieval.store``;
    retrieval depends on core, so the oracle imports the accessors at call
    time (core is fully imported before any search runs)."""
    from repro_torch.retrieval import store
    return store


def _score_stage(stage: Stage, store: dict, q: torch.Tensor,
                 q_mask: torch.Tensor | None,
                 cand: torch.Tensor | None) -> torch.Tensor:
    """Scores for one stage. q [B,Q,d]; cand [B,C] doc ids or None (=all).

    Returns [B, C] (or [B, N] when cand is None). Dead slots of a
    capacity-padded store score NEG at every stage. A vector whose float
    copy was dropped (``quantize_store(stages=...)``) is dequantised
    whole: the oracle's reference semantics.
    """
    ST = _store_accessors()
    vecs, mask, scales = ST.rerank_arrays(store, stage.vector)
    if scales is not None:
        vecs = dequantize(vecs, scales)
    valid = ST.validity(store)
    if vecs.shape[-1] < q.shape[-1]:
        # Matryoshka stage: score with the matching query dim prefix
        q = q[..., : vecs.shape[-1]]
    if vecs.ndim == 2:                       # single-vector stage
        scores = ms.maxsim_single_vector(q, vecs, q_mask)      # [B, N]
        if valid is not None:
            scores = scores.masked_fill(~valid[None, :], ms.NEG)
        if cand is not None:
            scores = torch.gather(scores, 1, cand)
        return scores
    if cand is None:
        scores = ms.maxsim_batched(q, vecs, q_mask, mask)      # [B, N]
        if valid is not None:
            scores = scores.masked_fill(~valid[None, :], ms.NEG)
        return scores

    scores = torch.stack([
        ms.maxsim_scan(q[b], vecs[cand[b]],
                       None if q_mask is None else q_mask[b],
                       None if mask is None else mask[cand[b]])
        for b in range(q.shape[0])])
    if valid is not None:
        scores = scores.masked_fill(~valid[cand], ms.NEG)
    return scores


def search(store: dict, q: torch.Tensor, stages: tuple,
           q_mask: torch.Tensor | None = None, fspec=None) -> tuple:
    """Run the cascade. Returns (scores [B, k_final], ids [B, k_final]),
    ids sorted by descending final-stage score.

    ``fspec`` is a request-scoped ``retrieval.store.FilterSpec`` (or a
    packed triple, or None): it is folded into the store's validity entry
    by the same ``effective_validity`` the engine uses."""
    if fspec is not None:
        ST = _store_accessors()
        dev = next(iter(store.values())).device
        arrays = ST.as_filter_arrays(fspec, ST.filter_words(store), dev)
        store = dict(store)
        eff = ST.effective_validity(store, arrays)
        if eff is not None:
            store[ST.VALIDITY_KEY] = eff
    cand = None
    scores = None
    for stage in stages:
        s = _score_stage(stage, store, q, q_mask, cand)        # [B, C|N]
        k = min(stage.k, s.shape[-1])
        top_s, top_i = top_k(s, k)
        cand = top_i if cand is None else torch.gather(cand, 1, top_i)
        scores = top_s
    return scores, cand


def qps_cost_model(n_docs: int, q_tokens: int, dim: int, stages: tuple,
                   store_dims: dict, vec_dims: dict | None = None) -> int:
    """Eq.-1 multiply-add count for one query through a cascade.

    Counts MADDS, NOT BYTES: an int8 store halves the scan stage's memory
    traffic but does the same multiply-adds after dequantisation, so it
    is invisible here (``cascade_hbm_bytes`` bills the bytes). ``cand`` is
    clamped to ``n_docs`` before each stage's term, so no stage bills
    more candidates than documents exist.

    ``store_dims`` maps vector name -> vectors per page (D, 1 for a
    single-vector stage); ``vec_dims`` maps vector name -> stored
    embedding dim. A Matryoshka stage narrower than the query scores the
    matching query prefix, so it is billed at ``min(vec_dim, dim)``;
    without ``vec_dims`` every stage is billed at ``dim``
    (``VectorStore.vec_dims()`` / ``SegmentedStore.vec_dims()`` supply the
    real widths).

    A routed scan stage (``n_probe > 0`` with ``n_clusters > 0``) is
    billed at the centroid product (K centroid rows at the stage dim; the
    query tokens collapse to one summed vector first, so no q_tokens
    factor) plus the expected probed members ``ceil(N * n_probe / K)``
    instead of all N.
    """
    total, cand = 0, n_docs
    for si, stage in enumerate(stages):
        cand = min(cand, n_docs)
        d_vecs = store_dims[stage.vector]
        stage_dim = dim if vec_dims is None else \
            min(dim, vec_dims.get(stage.vector, dim))
        if si == 0 and stage.n_probe > 0 and stage.n_clusters > 0:
            k_c = stage.n_clusters
            probed = min(cand, -(-n_docs * min(stage.n_probe, k_c) // k_c))
            total += k_c * stage_dim                      # centroid product
            total += q_tokens * d_vecs * probed * stage_dim
        else:
            total += q_tokens * d_vecs * cand * stage_dim
        cand = min(stage.k, cand)
    return total


def cascade_hbm_bytes(n_docs: int, q_tokens: int, dim: int, stages: tuple,
                      store_dims: dict, vec_dims: dict | None = None,
                      *, batch: int = 1,
                      bytes_per_coord: dict | None = None,
                      cold_rows: int = 0) -> dict:
    """Per-stage device-memory byte model for one query BATCH through a
    cascade, the bytes companion of ``qps_cost_model``'s madds. The scan
    and candidate paths are memory-bound, so a stage's predicted time is
    its bytes over the card's memory rate.

    Billed per stage, from the ``Stage`` fields:

    - **scan**: one corpus read (``N * D' * d' * bytes``, plus the f32
      scales of int8 codes) + the score write, ``B * N * 4`` for
      score-then-select, ``B * min(k, chunk) * 8 * n_chunks`` (values +
      ids per chunk) when ``scan_topk`` streams a running top-k over a
      multi-vector stage (chunk ``DEFAULT_SCAN_TOPK_CHUNK`` when the stage
      sets none).
    - **rerank**: the candidate gather, 3x the candidate bytes for the
      plain path (read the rows, write the gathered [B, L, D, d] copy,
      read it again) and 1x with ``rerank_kernel`` (the fused gather),
      plus the ``B * L * 4`` score write.
    - **routed-scan** (scan stage with ``n_probe`` and ``n_clusters``
      set): one f32 centroid read (``K * d * 4``) plus a candidate-style
      gather of the expected probed members ``ceil(N * n_probe / K)``
      (3x plain, 1x with ``use_kernel`` or ``rerank_kernel``), plus the
      ``B * (K + probed) * 4`` score writes.
    - **tier-transfer** (``cold_rows`` > 0): ``cold_rows`` rows of the
      WHOLE per-row storage (every named vector at its stored precision,
      plus the f32 scales of int8 names: a promotion moves a segment's
      whole vectors dict), which crosses the host link, not device
      memory.

    ``bytes_per_coord`` maps vector name -> stored bytes per coordinate
    (default 2 = bf16; 1 for int8 codes). The query reads (``B * Q * d``)
    are noise at corpus scale and not billed. Returns {"stages": [{
    "stage", "kind", "read_bytes", "score_write_bytes", "total_bytes"},
    ...], "total_bytes"}.
    """
    bpc = bytes_per_coord or {}
    per_stage, cand = [], n_docs
    for si, stage in enumerate(stages):
        cand = min(cand, n_docs)
        d_vecs = store_dims[stage.vector]
        vd = dim if vec_dims is None else \
            min(dim, vec_dims.get(stage.vector, dim))
        b = bpc.get(stage.vector, 2)
        k = min(stage.k, cand)
        if si == 0 and stage.n_probe > 0 and stage.n_clusters > 0:
            k_c = stage.n_clusters
            probed = min(n_docs,
                         -(-n_docs * min(stage.n_probe, k_c) // k_c))
            read = k_c * vd * 4                      # f32 centroids
            gather = batch * probed * d_vecs * vd * b
            if b == 1:
                gather += batch * probed * d_vecs * 4
            factor = 1 if (stage.use_kernel or stage.rerank_kernel) else 3
            entry = {"stage": stage.vector, "kind": "routed-scan",
                     "read_bytes": read + factor * gather,
                     "score_write_bytes": batch * (k_c + probed) * 4}
        elif si == 0:
            read = n_docs * d_vecs * vd * b
            if b == 1:        # int8 codes stream per-vector f32 scales too
                read += n_docs * d_vecs * 4
            # a single-vector scan keeps score-then-select in the engine
            # (``_dispatch_scan_topk``): bill the [B, N] write it does
            if stage.scan_topk and d_vecs > 1:
                chunk = min(stage.chunk if stage.chunk > 0
                            else DEFAULT_SCAN_TOPK_CHUNK, n_docs)
                n_chunks = -(-n_docs // chunk)
                write = batch * min(k, chunk) * 8 * n_chunks
            else:
                write = batch * n_docs * 4
            entry = {"stage": stage.vector, "kind": "scan",
                     "read_bytes": read, "score_write_bytes": write}
        else:
            gather = batch * cand * d_vecs * vd * b
            if b == 1:
                gather += batch * cand * d_vecs * 4
            factor = 1 if stage.rerank_kernel else 3
            entry = {"stage": stage.vector, "kind": "rerank",
                     "read_bytes": factor * gather,
                     "score_write_bytes": batch * cand * 4}
        entry["total_bytes"] = (entry["read_bytes"]
                                + entry["score_write_bytes"])
        per_stage.append(entry)
        cand = k
    if cold_rows > 0:
        row_bytes = 0
        for name, d_vecs in store_dims.items():
            vd = dim if vec_dims is None else \
                min(dim, vec_dims.get(name, dim))
            b = bpc.get(name, 2)
            row_bytes += d_vecs * vd * b
            if b == 1:            # int8 names ship their f32 scales too
                row_bytes += d_vecs * 4
        xfer = cold_rows * row_bytes
        per_stage.append({"stage": "host->device", "kind": "tier-transfer",
                          "read_bytes": xfer, "score_write_bytes": 0,
                          "total_bytes": xfer})
    return {"stages": per_stage,
            "total_bytes": sum(e["total_bytes"] for e in per_stage)}
