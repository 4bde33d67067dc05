"""Multi-stage MaxSim search engine over a segmented corpus, one device.

Executes the paper's prefetch -> rerank cascade (§2.4) eagerly over the
segments of a ``SegmentedStore``:

- stage 0 scans every segment (the CUDA scan kernels when the stage sets
  ``use_kernel`` — with ``Stage.chunk`` the double-buffered scan in one
  launch — the plain scan otherwise), over int8 codes when the store
  holds them; it keeps each segment's top-k (or, with
  ``Stage.scan_topk``, streams a running top-k across corpus chunks) and
  merges them in a global SLOT id space (segment offsets = cumulative
  capacities);
- later stages rerank the surviving candidates against each segment (the
  fused gather + MaxSim kernel when the stage sets ``rerank_kernel``, a
  per-query gather + ``maxsim_scan`` otherwise). A candidate is real in
  exactly one segment and NEG in the others, so the cross-segment combine
  is an elementwise max;
- every stage NEGs dead slots through the segment's effective mask:
  ``doc_valid`` AND the request's tenant/tag filter
  (``store.effective_validity`` over the ``doc_tenant``/``doc_filter``
  companions and the packed ``FilterSpec`` triple), so mutation never
  changes tensor shapes and a filtered search scores exactly what an
  unfiltered search over only the matching documents would;
- ``Stage.n_probe > 0`` replaces the stage-0 exhaustive scan with IVF
  centroid ROUTING: the query is scored against each segment's [K, d]
  centroid table (``kernels.maxsim.ops.centroid_scores``), the top
  ``n_probe`` clusters' -1-padded member-slot lists become the candidate
  rows, and those rows are scored by ``_score_candidates``, the rerank
  stages' machinery (the gather-rerank kernel with ``use_kernel`` or
  ``rerank_kernel``). Each query's probed rows are put in slot-id order
  (padding last) before they are scored, so equal scores keep the lower
  slot id first, as in the exhaustive scan: at ``n_probe == K`` every
  live slot sits in exactly one member list and the routed stage gives
  the exhaustive ids, exact ties included. (``repro``'s routed stage
  breaks ties by probed-row position instead, so its routed ids can
  differ from these on exact ties, and only there.)

With a ``mesh`` (``launch.mesh``: one controller, a device per mesh
position) the cascade runs SHARDED, as ``repro``'s ``shard_map`` body
does, once per mesh position on that position's device and slab:

- documents never move: shard r scans and reranks only its slab, slots
  ``[r * n_local, (r + 1) * n_local)`` of each segment (``n_local =
  capacity // S``; a capacity divides by S);
- only (score, id) pairs cross between devices: each stage gathers the
  shards' lists onto the mesh's first device in mesh order
  (``topk.allgather_topk``/``gathered_merge_topk``/``all_gather``) and
  merges them with the stable top-k, so every result lands there;
- rerank stages (and a routed stage 0, whose replicated routing
  companions give every shard the identical probed rows) compact each
  shard's OWNED candidates to the front with a stable sort, keeping the
  candidate order, and score the first ``cap_slots = min(L, ceil(L / S)
  * rerank_overcommit)`` of them (default 8, ``repro``'s): exact when no
  shard owns more than that (always, when S <= rerank_overcommit);
  otherwise a shard drops its owned candidates past the first
  ``cap_slots``, as ``repro``'s does, trading exactness for rerank work;
- a non-owned copy scores NEG AND drops its id to -1, so NEG filler can
  never duplicate a live page when k exceeds the live candidates.

Stores come placed (``SegmentedStore.place_on``; ``shards()`` hands
over a tuple of slab dicts per segment) or as one raw dict
(``make_search_fn``), which the search splits over the mesh on each call
(``store.split_slabs``; views on the tensors' own device). No step of the per-shard body reads a value back to the host.
On a meta mesh (shapes only, ``launch.dryrun``) shard 0 runs alone and
each gather is the gathered shape (``topk.all_gather``); the owner
compaction is already static (``cap_slots`` rows a shard), so nothing
of the body depends on data.

The oracle is ``repro_torch.core.multistage.search``.
"""
from __future__ import annotations

import torch

from repro_torch.core import maxsim as MS
from repro_torch.core.multistage import DEFAULT_SCAN_TOPK_CHUNK, Stage, top_k
from repro_torch.distributed.sharding import is_meta_mesh
from repro_torch.kernels.maxsim import ops as KOPS
from repro_torch.kernels.maxsim.ref import dequantize
from repro_torch.retrieval.store import (ROUTING_KEYS, VALIDITY_KEY,
                                         as_filter_arrays,
                                         effective_validity, filter_words,
                                         rerank_arrays, routing_arrays,
                                         scan_arrays, split_slabs)
from repro_torch.retrieval.topk import (all_gather, allgather_topk,
                                        gathered_merge_topk, merge_topk)
from repro_torch.retrieval.tracing import record_trace

NEG = -1e30
INT8_REF_CHUNK = 1024      # plain int8 scan chunk when the stage sets none


def _mesh_shards(mesh) -> int:
    return 1 if mesh is None else mesh.size


def _prefix(vecs, q):
    """The Matryoshka query-prefix slice: a stage whose vectors are
    narrower than the query scores the matching prefix."""
    if vecs.shape[-1] < q.shape[-1]:
        q = q[..., : vecs.shape[-1]]
    return q


def _scan_prep(stage: Stage, vecs, q, scales):
    """The scan stage's compute-type policy (``Stage.dtype``: the query,
    and float documents, cast to it; int8 codes stay int8) and the
    Matryoshka prefix slice, shared by the score and streamed top-k
    paths: (vecs, q)."""
    if stage.dtype is not None:
        dt = getattr(torch, stage.dtype)
        q = q.to(dt)
        if scales is None:                    # int8 codes must stay int8
            vecs = vecs.to(dt)
    return vecs, _prefix(vecs, q)


def _single_vector_scores(q, vecs, q_mask, scales, doc_valid):
    """A single-vector (pooled) scan is one matrix product, over the
    dequantised vectors when they are int8 codes: [B, N]."""
    if scales is not None:
        vecs = vecs.to(q.dtype) * scales[..., None].to(q.dtype)
    s = MS.maxsim_single_vector(q, vecs, q_mask)
    if doc_valid is not None:
        s = s.masked_fill(~doc_valid[None, :], NEG)
    return s


def _dispatch_scan(stage: Stage, vecs, mask, q, q_mask, scales,
                   doc_valid=None):
    """Score the full-corpus scan stage per the stage's dispatch policy:
    [n_docs, D, d] -> [B, n_docs]. ``doc_valid`` [N] bool NEGs dead
    capacity-padding slots.

    ``use_kernel`` takes the kernel wrappers (the double-buffered scan
    when ``chunk`` is set). Otherwise an int8 stage streams through the
    plain chunked scan, dequantising one chunk at a time (a whole
    [N, D, d] float copy would undo the int8 saving), with a bounded
    default chunk; a float stage runs ``core.maxsim``."""
    vecs, q = _scan_prep(stage, vecs, q, scales)
    if vecs.ndim == 2:                        # single-vector stage
        return _single_vector_scores(q, vecs, q_mask, scales, doc_valid)
    if stage.use_kernel:
        return KOPS.maxsim_scores_chunked(q, vecs, q_mask, mask, doc_valid,
                                          chunk=stage.chunk, scales=scales)
    if scales is not None:
        chunk = stage.chunk if stage.chunk > 0 else INT8_REF_CHUNK
        return KOPS.maxsim_chunked_ref(q, vecs, q_mask, mask, doc_valid,
                                       chunk=chunk, scales=scales)
    s = MS.maxsim_batched(q, vecs, q_mask, mask, chunk=stage.chunk)
    if doc_valid is not None:
        s = s.masked_fill(~doc_valid[None, :], NEG)
    return s


def _dispatch_scan_topk(stage: Stage, vecs, mask, q, q_mask, scales,
                        doc_valid, k: int):
    """Scan-stage select with a STREAMED running top-k: (vals, local ids)
    [B, k] without the [B, N] score matrix
    (``kernels.maxsim.ops.maxsim_topk_chunked``; each chunk through the
    scan kernel when the stage sets ``use_kernel``). Single-vector scans
    keep score-then-select: their [B, N] scores are the product's output,
    not an avoidable intermediate."""
    vecs, q = _scan_prep(stage, vecs, q, scales)
    if vecs.ndim == 2:
        s = _single_vector_scores(q, vecs, q_mask, scales, doc_valid)
        return top_k(s, min(k, vecs.shape[0]))
    chunk = stage.chunk if stage.chunk > 0 else DEFAULT_SCAN_TOPK_CHUNK
    return KOPS.maxsim_topk_chunked(q, vecs, q_mask, mask, doc_valid, k=k,
                                    chunk=chunk, scales=scales,
                                    use_kernel=stage.use_kernel)


def _score_candidates(stage_vecs, stage_mask, stage_scales, q, q_mask, rows,
                      ok, rerank_kernel: bool = False):
    """Score per-query candidate lists against ONE segment's tensors.

    rows [B, L] in-range local slot ids; ok [B, L] marks candidates this
    segment owns (in-segment and doc_valid) — the rest score NEG.
    ``stage_scales`` is set when the float copy was dropped (int8 rerank):
    every path dequantises the gathered rows, which is elementwise and so
    the same as the oracle's dequantise-then-gather.
    ``rerank_kernel`` routes multi-vector stages to the fused gather +
    MaxSim wrapper (no [B, L, D, d] copy); otherwise each query gathers
    its [L, D, d] candidates and scores them with ``maxsim_scan``, the
    oracle's math. Single-vector stages are a small gather + product.
    """
    q = _prefix(stage_vecs, q)
    if stage_vecs.ndim == 2:
        vecs = stage_vecs[rows.long()]                          # [B, L, d]
        if stage_scales is not None:
            vecs = dequantize(vecs, stage_scales[rows.long()])
        if q_mask is not None:
            q = q * q_mask[..., None].to(q.dtype)
        qs = q.sum(dim=-2)
        s = torch.einsum("bd,bld->bl", qs, vecs.to(qs.dtype))
        return s.masked_fill(~ok, NEG)
    if rerank_kernel:
        return KOPS.maxsim_rerank(q, stage_vecs, rows, q_mask, stage_mask,
                                  ok, scales=stage_scales)

    def gathered(b):
        cl = rows[b].long()
        dv = stage_vecs[cl]
        if stage_scales is not None:
            dv = dequantize(dv, stage_scales[cl])
        return MS.maxsim_scan(q[b], dv,
                              None if q_mask is None else q_mask[b],
                              None if stage_mask is None else stage_mask[cl])

    s = torch.stack([gathered(b) for b in range(q.shape[0])])
    return s.masked_fill(~ok, NEG)


def _offsets(capacities: tuple) -> tuple:
    offs, off = [], 0
    for cap in capacities:
        offs.append(off)
        off += cap
    return tuple(offs)


def _slot_order(rows):
    """Per query, the permutation that puts ``rows`` [B, R] in slot-id
    order, -1 (padding) last, ties kept in place."""
    key = torch.where(rows >= 0, rows, torch.iinfo(torch.int64).max)
    return torch.sort(key, dim=1, stable=True)[1]


def _routed_rows(store: dict, stage: Stage, q, q_mask,
                 slot_order: bool = True):
    """Stage-0 candidate rows by centroid routing for ONE segment: score
    the query against the segment's [K, d] centroids, keep the top
    ``n_probe`` clusters, and emit their member-slot lists as one
    [B, n_probe * C] row set in slot-id order, -1 (padded member slots)
    last, so a stable select breaks score ties by slot id. With
    ``slot_order=False`` the rows stay in ``repro``'s order (cluster rank,
    then member), which decides the rows a mesh shard keeps when it owns
    more than it may score."""
    routing = routing_arrays(store)
    if routing is None:
        raise ValueError(
            f"stage '{stage.vector}' sets n_probe={stage.n_probe} but the "
            "store carries no routing companions — enable routing on the "
            "SegmentedStore (Retriever(routing=...) or "
            "store.enable_routing(...)) before searching")
    cents, members = routing                          # [K, d], [K, C]
    score = KOPS.centroid_scores if stage.use_kernel \
        else KOPS.centroid_scores_ref
    cs = score(q, cents, q_mask)                      # [B, K]
    _, cid = top_k(cs, min(stage.n_probe, cents.shape[0]))
    rows = members[cid].reshape(q.shape[0], -1).long()
    if not slot_order:
        return rows
    return torch.gather(rows, 1, _slot_order(rows))


def _segment_stage0(stage: Stage, store: dict, eff, cap: int, off: int, q,
                    q_mask):
    """Stage-0 candidate generation over ONE segment: (vals [B, k0],
    GLOBAL slot ids [B, k0]) with k0 = min(stage.k, cap[, probed rows])."""
    vecs, mask, scales = scan_arrays(store, stage.vector)
    if stage.n_probe > 0:
        rows = _routed_rows(store, stage, q, q_mask)
        rclip = rows.clamp(0, cap - 1)
        ok = rows >= 0                  # -1 = padded member slot
        if eff is not None:
            ok = ok & eff[rclip]
        s = _score_candidates(vecs, mask, scales, q, q_mask, rclip, ok,
                              stage.use_kernel or stage.rerank_kernel)
        v, sel = top_k(s, min(stage.k, cap, rows.shape[1]))
        # dead winners (k > live probed members) drop their slot id:
        # -1 is the filler sentinel
        i = torch.where(torch.gather(ok, 1, sel),
                        torch.gather(rclip, 1, sel) + off, -1)
        return v, i
    if stage.scan_topk:
        v, i = _dispatch_scan_topk(stage, vecs, mask, q, q_mask, scales,
                                   eff, min(stage.k, cap))
    else:
        s = _dispatch_scan(stage, vecs, mask, q, q_mask, scales,
                           doc_valid=eff)
        v, i = top_k(s, min(stage.k, cap))
    return v, i + off


def _segment_rerank(stage: Stage, store: dict, eff, cap: int, off: int, q,
                    q_mask, cand):
    """One rerank stage's scores for the global candidate set against ONE
    segment: [B, L]; out-of-segment and dead candidates score NEG."""
    local = cand - off
    in_seg = (local >= 0) & (local < cap)
    rows = local.clamp(0, cap - 1)
    ok = in_seg
    if eff is not None:
        ok = ok & eff[rows]
    vecs, mask, scales = rerank_arrays(store, stage.vector)
    return _score_candidates(vecs, mask, scales, q, q_mask, rows, ok,
                             stage.rerank_kernel)


def _resolve_stage0(stages: tuple) -> Stage:
    """The stage-0 dispatch that ``make_segmented_search_fn`` and
    ``make_segment_scan_fn`` share. The port resolves kernel or plain
    version per call, from the stage's flags (``use_kernel``: the scan
    and the routed centroid scores; ``use_kernel or rerank_kernel``: the
    routed candidate scores) and the tensors' device, inside
    ``_segment_stage0``; both builders hand that function this same stage,
    so a per-segment function and the joint cascade route every op alike
    (what makes tiered results bit for bit the resident ones)."""
    stages = tuple(stages)
    if not stages:
        raise ValueError("search needs at least one stage")
    return stages[0]


def make_segmented_search_fn(stages: tuple, capacities: tuple, mesh=None,
                             rerank_overcommit: int = 8):
    """The cascade over a tuple of segment stores.

    Returns fn(stores: tuple, q [B,Q,d], q_mask [B,Q], fspec=None) ->
    (scores [B,k], global slot ids [B,k]). ``fspec`` is a
    ``store.FilterSpec`` (or a packed triple, or None for the
    match-everything filter), packed here for the stores' device. Without
    ``mesh`` each store is one dict; with it the cascade runs sharded
    (``_mesh_search``), each store being a segment's slabs
    (``SegmentedStore.shards``) or one dict, and the results land on the
    mesh's first device; each shard scores at most ``ceil(L / S) *
    rerank_overcommit`` of a stage's L candidates (module docstring).
    Each build counts one ``tracing.record_trace`` (``Retriever`` caches
    the function per stages, store layout, mesh and overcommit, so
    steady-state serving builds none).
    """
    record_trace()
    stages = tuple(stages)
    capacities = tuple(capacities)
    _resolve_stage0(stages)
    if not capacities:
        raise ValueError("search needs at least one segment")
    if mesh is not None:
        return _mesh_search(mesh, stages, capacities, rerank_overcommit)
    offsets = _offsets(capacities)
    total_cap = sum(capacities)

    def search(stores, q, q_mask, fspec=None):
        arrays = as_filter_arrays(fspec, filter_words(stores[0]), q.device)
        # one effective mask per segment — doc_valid AND the request's
        # tenant/tag terms — threaded through every stage
        effs = tuple(effective_validity(s, arrays) for s in stores)
        scores = cand = None
        for si, stage in enumerate(stages):
            if si == 0:
                parts = [_segment_stage0(stage, store, eff, cap, off, q,
                                         q_mask)
                         for store, eff, cap, off in zip(stores, effs,
                                                         capacities, offsets)]
                scores, cand = merge_topk(
                    torch.cat([v for v, _ in parts], dim=1),
                    torch.cat([i for _, i in parts], dim=1),
                    min(stage.k, total_cap))
            else:
                s_all = None
                for store, eff, cap, off in zip(stores, effs, capacities,
                                                offsets):
                    s = _segment_rerank(stage, store, eff, cap, off, q,
                                        q_mask, cand)
                    # each candidate lives in exactly one segment; the
                    # others scored it NEG, so max == owner's score
                    s_all = s if s_all is None else torch.maximum(s_all, s)
                k = min(stage.k, cand.shape[1])
                scores, sel = top_k(s_all, k)
                cand = torch.gather(cand, 1, sel)
        return scores, cand

    return search


def _owned_first(mine, n: int):
    """Per row, the positions of the True entries of ``mine`` [B, L] in
    their order, then the rest, cut to the first ``n``: a stable sort
    (``repro``'s ``argsort(~mine)``), so ties keep the candidate order."""
    key = (~mine).to(torch.uint8)
    return torch.sort(key, dim=1, stable=True)[1][:, :n]


def _mesh_search(mesh, stages: tuple, capacities: tuple,
                 rerank_overcommit: int = 8):
    """The sharded cascade: ``repro``'s ``shard_map`` body, run once per
    mesh position on its device, with each stage's (score, id) lists
    gathered in mesh order onto the mesh's first device."""
    devices = tuple(mesh.devices.flat)
    gdev = devices[0]
    n_shards = len(devices)
    # a meta mesh runs shard 0 alone and gathers shapes (``topk``)
    meta = is_meta_mesh(mesh)
    ran = 1 if meta else n_shards
    gather_n = n_shards if meta else None
    for cap in capacities:
        # segment capacities are shard-padded at allocation, raw corpora
        # by make_search_fn: no corpus-size constraint, only this one
        if cap % n_shards:
            raise ValueError(f"segment capacity {cap} not divisible by "
                             f"{n_shards} shards")
    offsets = _offsets(capacities)
    total_cap = sum(capacities)

    def stage0(stage, slab, eff, cap, off, r, q, q_mask):
        """Shard r's stage 0 over one segment's slab: its winners as
        (vals, GLOBAL slot ids), or its [B, n_local] scores for the
        exhaustive scan (selected in ``allgather_topk``)."""
        n_local = cap // n_shards
        vecs, mask, scales = scan_arrays(slab, stage.vector)
        if stage.n_probe > 0:
            # the replicated routing companions give every shard the same
            # rows; it scores the ones it owns, compacted to cap_slots
            # (>= n_local when K * C >= capacity, the member-width
            # invariant, so full probe stays exact). The compaction keeps
            # the first owned rows in ``repro``'s row order, so a shard
            # that owns more than cap_slots keeps the rows ``repro``'s
            # does; the kept rows are then put in slot-id order, the
            # single-device path's tie order
            rows = _routed_rows(slab, stage, q, q_mask, slot_order=False)
            R = rows.shape[1]
            rclip = rows.clamp(0, cap - 1)
            cap_slots = min(R, max(1, -(-R // n_shards)) * rerank_overcommit)
            mine = (rows >= 0) & (rclip // n_local == r)
            order = _owned_first(mine, cap_slots)
            ok = torch.gather(mine, 1, order)
            order = torch.gather(order, 1, _slot_order(torch.where(
                ok, torch.gather(rows, 1, order), -1)))
            rsel = torch.gather(rclip % n_local, 1, order)
            gsel = torch.gather(rclip, 1, order)
            ok = torch.gather(mine, 1, order)
            if eff is not None:
                ok = ok & eff[rsel]
            s = _score_candidates(vecs, mask, scales, q, q_mask, rsel, ok,
                                  stage.use_kernel or stage.rerank_kernel)
            v, sel = top_k(s, min(stage.k, cap, cap_slots))
            gi = torch.where(torch.gather(ok, 1, sel),
                             torch.gather(gsel, 1, sel) + off, -1)
            return v, gi
        if stage.scan_topk:
            # streamed per-shard running top-k; ids shift into the global
            # slot space before the gathered merge
            v, i = _dispatch_scan_topk(stage, vecs, mask, q, q_mask, scales,
                                       eff, min(stage.k, cap))
            return v, i + r * n_local + off
        return _dispatch_scan(stage, vecs, mask, q, q_mask, scales)

    def rerank(stage, slab, eff, cap, off, r, q, q_mask, cand, cap_slots):
        """Shard r's scores for its owned candidates of one segment,
        compacted to ``cap_slots``, and their global ids (-1 where not
        owned or dead)."""
        n_local = cap // n_shards
        local = cand - off
        in_seg = (local >= 0) & (local < cap)
        lclip = local.clamp(0, cap - 1)
        mine = in_seg & (lclip // n_local == r)
        order = _owned_first(mine, cap_slots)
        rows = torch.gather(lclip % n_local, 1, order)
        ok = torch.gather(mine, 1, order)
        if eff is not None:
            ok = ok & eff[rows]
        vecs, mask, scales = rerank_arrays(slab, stage.vector)
        s = _score_candidates(vecs, mask, scales, q, q_mask, rows, ok,
                              stage.rerank_kernel)
        # a non-owned copy drops its id, not only its score: with k above
        # the live candidates, NEG filler carrying a live id would
        # duplicate that page; -1 scores NEG in every later stage too
        return s, torch.where(ok, torch.gather(cand, 1, order), -1)

    def search(stores, q, q_mask, fspec=None):
        slabs = [store if isinstance(store, tuple)
                 else split_slabs(store, mesh) for store in stores]
        for sl in slabs:
            if len(sl) != n_shards:
                raise ValueError(f"a segment in {len(sl)} slabs on a mesh "
                                 f"of {n_shards}")
        arrays = as_filter_arrays(fspec, filter_words(slabs[0][0]), gdev)
        # the query and the request filter are replicated: every shard
        # applies them to its own slab
        qs = [q.to(d) for d in devices[:ran]]
        qms = [q_mask.to(d) for d in devices[:ran]]
        effs = [[effective_validity(sl[r], tuple(t.to(d) for t in arrays))
                 for r, d in enumerate(devices[:ran])] for sl in slabs]
        scores = cand = None
        for si, stage in enumerate(stages):
            parts_v, parts_i = [], []
            if si == 0:
                for sl, eff, cap, off in zip(slabs, effs, capacities,
                                             offsets):
                    got = [stage0(stage, sl[r], eff[r], cap, off, r, qs[r],
                                  qms[r]) for r in range(ran)]
                    k0 = min(stage.k, cap)
                    if stage.n_probe > 0 or stage.scan_topk:
                        v, i = gathered_merge_topk([g[0] for g in got],
                                                   [g[1] for g in got], k0,
                                                   gdev, gather_n)
                    else:
                        v, i = allgather_topk(got, k0, cap // n_shards,
                                              valid_local=eff,
                                              seg_offset=off, device=gdev,
                                              n=gather_n)
                    parts_v.append(v)
                    parts_i.append(i)
                k = min(stage.k, total_cap)
            else:
                L = cand.shape[1]
                cap_slots = min(L, max(1, -(-L // n_shards))
                                * rerank_overcommit)
                cands = [cand.to(d) for d in devices[:ran]]
                for sl, eff, cap, off in zip(slabs, effs, capacities,
                                             offsets):
                    got = [rerank(stage, sl[r], eff[r], cap, off, r, qs[r],
                                  qms[r], cands[r], cap_slots)
                           for r in range(ran)]
                    parts_v.append(all_gather([g[0] for g in got], gdev,
                                              gather_n))
                    parts_i.append(all_gather([g[1] for g in got], gdev,
                                              gather_n))
                k = min(stage.k, L)
            scores, cand = merge_topk(torch.cat(parts_v, dim=1),
                                      torch.cat(parts_i, dim=1), k)
        return scores, cand

    return search


def make_segment_scan_fn(stages: tuple, capacity: int):
    """Stage 0 over ONE segment, for the tiered per-segment pipeline
    (``retrieval.tiering``).

    Returns fn(store: dict, q [B,Q,d], q_mask [B,Q], fspec, offset) ->
    (vals [B,k0], GLOBAL slot ids [B,k0]). ``offset`` is the segment's
    first global slot, a plain int argument and never part of a cache
    key, so one function serves every segment of this layout and a
    change of residency builds nothing. The body is ``_segment_stage0``,
    the code the joint cascade runs per segment. Each build counts one
    ``tracing.record_trace``."""
    record_trace()
    stage = _resolve_stage0(stages)

    def seg_scan(store, q, q_mask, fspec, offset: int):
        arrays = as_filter_arrays(fspec, filter_words(store), q.device)
        eff = effective_validity(store, arrays)
        return _segment_stage0(stage, store, eff, capacity, offset, q,
                               q_mask)

    return seg_scan


def make_segment_rerank_fn(stages: tuple, stage_index: int, capacity: int):
    """Rerank stage ``stage_index`` over ONE segment (the tiered twin of
    the joint cascade's rerank block: the same ``_segment_rerank``).

    Returns fn(store, q, q_mask, fspec, offset, cand [B,L]) -> [B,L]
    scores, NEG for candidates this segment does not own; the caller
    folds segments with an elementwise max (each candidate is real in
    exactly one segment). ``offset`` as in ``make_segment_scan_fn``. Each
    build counts one ``tracing.record_trace``."""
    record_trace()
    stage = tuple(stages)[stage_index]

    def seg_rerank(store, q, q_mask, fspec, offset: int, cand):
        arrays = as_filter_arrays(fspec, filter_words(store), q.device)
        eff = effective_validity(store, arrays)
        return _segment_rerank(stage, store, eff, capacity, offset, q,
                               q_mask, cand)

    return seg_rerank


def make_search_fn(stages: tuple, n_docs: int, mesh=None,
                   rerank_overcommit: int = 8):
    """The cascade over ONE raw store dict of ``n_docs`` rows (no
    segments): fn(store_vectors: dict, q [B,Q,d], q_mask [B,Q],
    fspec=None) -> (scores [B,k], ids [B,k]), ids being row numbers.
    ``fspec`` as in ``make_segmented_search_fn``, applied against
    whichever store companions the dict carries. A store without
    ``doc_valid`` is all live; one with it (a ragged capacity-padded
    store) keeps its own.

    The store is served as one segment. On a ``mesh`` of S positions its
    rows are padded with zeros to a multiple of S (``doc_valid`` with
    False) on each call, so any ``n_docs`` shards; the routing companions
    are left whole; ``rerank_overcommit`` as in
    ``make_segmented_search_fn``."""
    cap = -(-n_docs // _mesh_shards(mesh)) * _mesh_shards(mesh)
    body = make_segmented_search_fn(stages, (cap,), mesh, rerank_overcommit)

    def pad(v):
        if v.shape[0] == cap:
            return v
        return torch.cat([v, v.new_zeros((cap - n_docs,) + v.shape[1:])])

    def fn(store, q, q_mask=None, fspec=None):
        dev = next(iter(store.values())).device
        store = dict(store)
        if VALIDITY_KEY not in store:
            store[VALIDITY_KEY] = torch.ones((n_docs,), dtype=torch.bool,
                                             device=dev)
        store = {k: v if k in ROUTING_KEYS else pad(v)
                 for k, v in store.items()}
        q = torch.as_tensor(q).to(dev)
        q_mask = (torch.ones(q.shape[:2], dtype=torch.bool, device=dev)
                  if q_mask is None else torch.as_tensor(q_mask).to(dev))
        return body((store,), q, q_mask.bool(), fspec)

    return fn

