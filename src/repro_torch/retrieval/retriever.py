"""Serving facade: one object that owns the corpus, the mesh and the
cascade fns.

``Retriever`` wraps the engine (``repro_torch.retrieval.engine``) over a
SEGMENTED, capacity-padded corpus (``repro_torch.retrieval.segments``) on
one device or sharded over a mesh (``launch.mesh``), and caches the
cascade function per ``(stages, segment layout, mesh, overcommit)`` — not
per fill level.

    store = build_store(cfg, pages, token_types)         # on cuda
    r = Retriever(store, capacity=4096,                  # ingest headroom
                  ingest=IngestPipeline.for_config(cfg))
    scores, ids = r.search(q, q_mask, stages=MST.two_stage(256, 100))
    r.upsert(build_store(cfg, new_pages, token_types), tenant=2, tags=(5,))
    r.ingest(raw_pages, token_types)                     # fused write
    r.delete([3, 17])
    scores, ids = r.search(q, q_mask, stages=stages,
                           filter=FilterSpec(tenant=2, require_tags=(5,)))

    mesh = make_mesh((4,), ("data",), devices=["cuda:0"] * 4)
    r4 = Retriever(store, mesh=mesh, capacity=4096)      # 4 shards
    r4x = Retriever(store, mesh=mesh, rerank_overcommit=2)   # inexact

The no-retrace contract (``retrieval.tracing``): ``upsert``/``ingest``
into preallocated padding and ``delete`` keep the layout, so steady-state
mutation and search build nothing; a new segment or ``compact()``
changes the layout and the next search builds its function once
(``trace_count()`` deltas show it). Query shapes cost nothing in eager
PyTorch; ``frontend()`` adds shape buckets and micro-batching for
traffic.

Scan-dispatch policy (``Stage.use_kernel`` / ``chunk`` / ``scan_topk``)
and rerank policy
(``Stage.rerank_kernel``) ride on the stages tuple, and so does IVF
routing (``Stage.n_probe``, on a store built with ``routing=``);
``scan_chunk`` supplies a default chunk for scan stages that set none,
bounding the plain scan's score block. Returned
ids are STABLE page ids (assigned at upsert); slots that never matched
(k > live docs, or documents the request's filter excluded) come back as
-1.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import multistage as MST
from repro_torch.launch.mesh import home_device
from repro_torch.retrieval import engine, tracing
from repro_torch.retrieval.segments import SegmentedStore
from repro_torch.retrieval.store import VectorStore


class Retriever:
    def __init__(self, store, capacity: int | None = None, device=None,
                 filter_words: int = 1, routing=None, ingest=None,
                 mesh=None, rerank_overcommit: int = 8, scan_chunk: int = 0,
                 place: bool = True):
        """``store`` is a built ``VectorStore`` (wrapped as segment 0 —
        exact fit by default, or preallocated to ``capacity`` slots for
        ingestion headroom) or an existing ``SegmentedStore``, which must
        already live on the retriever's device type. ``device`` defaults
        to "cuda"; with a ``mesh`` the retriever's device is the mesh's
        first device, where results land. ``filter_words`` sizes the
        packed metadata-tag bitset (32 tags per word) when wrapping a
        ``VectorStore``; a ``SegmentedStore`` keeps its own width.
        ``routing`` enables IVF centroid routing on the store (an int
        cluster count or a ``routing.RoutingPolicy``): segments are
        clustered now and maintained through upsert, ingest, delete and
        compact, and scan stages with ``Stage.n_probe > 0`` route through
        the clusters. ``ingest`` is an optional ``IngestPipeline`` that
        enables ``Retriever.ingest`` (raw pages in, stable ids out).

        ``mesh`` shards the search over the mesh's S positions, with
        capacities rounded to multiples of S (a ``SegmentedStore`` whose
        capacities do not divide by S raises). ``place=True`` lays the
        corpus out on the mesh once (``SegmentedStore.place_on``);
        ``place=False`` leaves it where it is (a ``VectorStore`` is
        wrapped on the mesh's first device) and each search splits it
        over the mesh (``store.split_slabs``: views, no copy), with the
        same results. Each shard scores at most ``ceil(L / S) *
        rerank_overcommit`` of a rerank stage's L candidates, so with
        more than ``rerank_overcommit`` shards a shard that owns more
        drops the rest (``engine``'s module docstring). Without a mesh,
        a store placed on a mesh of several positions raises: restore it
        onto one device (``tiering.restore_store``) or pass its mesh.

        ``scan_chunk`` > 0 is the chunk of every scan stage whose own
        ``chunk`` is 0; a stage's own chunk wins."""
        self.mesh = mesh
        self.device = home_device(mesh, device)
        self.rerank_overcommit = rerank_overcommit
        self.scan_chunk = scan_chunk
        self._ingest = ingest
        self._fns: dict = {}
        n_shards = engine._mesh_shards(mesh)
        if isinstance(store, VectorStore):
            store = SegmentedStore.from_store(
                store, capacity=capacity, device=self.device,
                filter_words=filter_words, n_shards=n_shards,
                mesh=mesh if place else None)
        else:
            if store.device.type != self.device.type:
                raise ValueError(f"store lives on {store.device}, retriever "
                                 f"on {self.device}")
            for cap in store.capacities:
                if cap % n_shards:
                    raise ValueError(
                        f"segment capacity {cap} not divisible by "
                        f"{n_shards} shards — allocate with n_shards set")
            store.n_shards = max(store.n_shards, n_shards)
            if mesh is not None and place:
                store.place_on(mesh)
            elif mesh is None and any(len(seg.slabs) > 1
                                      for seg in store.segments):
                raise ValueError(
                    f"the store is placed on a mesh of {store.mesh.size} "
                    "positions; pass mesh= to search it sharded, or "
                    "restore it onto one device")
        self.store = store
        if routing is not None:
            self.store.enable_routing(routing)

    @property
    def n_docs(self) -> int:
        """Live (valid) documents — shrinks on delete, grows on upsert."""
        return self.store.n_valid

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------

    def upsert(self, batch: VectorStore, tenant: int = 0,
               tags=()) -> np.ndarray:
        """Ingest an indexed batch (``build_store``, ``quantize_store`` or
        ``IngestPipeline.index`` output) with the store's key set: a
        quantised store takes batches quantised the same way. Every page
        is stamped with ``tenant`` and the metadata ``tags`` (searches
        scope to them with ``filter=FilterSpec(...)``). Returns stable
        page ids."""
        return self.store.add_pages(batch, tenant=tenant, tags=tags)

    def ingest(self, pages, token_types, tenant: int = 0,
               tags=()) -> np.ndarray:
        """Raw encoder output ``[N, S, d]`` in, stable page ids out: the
        attached ``IngestPipeline`` indexes the bucket-padded batch on the
        device and writes it straight into segment headroom (no indexed
        array comes back to the host). ``tenant``/``tags`` stamp the
        batch's store companions as in ``upsert``."""
        if self._ingest is None:
            raise ValueError(
                "no ingest pipeline attached — construct the retriever as "
                "Retriever(store, ingest=IngestPipeline.for_config(cfg, "
                "...)) to ingest raw pages (or use upsert(build_store(...))"
                " for host-driven batches)")
        return self._ingest.ingest(self.store, pages, token_types,
                                   tenant=tenant, tags=tags)

    def delete(self, ids) -> int:
        """Invalidate pages by stable id (validity masking; no data moves).
        Returns the number of pages deleted."""
        return self.store.delete(ids)

    def compact(self) -> None:
        """Reclaim dead slots (amortised; changes the layout, so the next
        search per stages config builds its function again)."""
        self.store.compact()

    @staticmethod
    def trace_count() -> int:
        """Kernel-library loads and search-function builds so far (see
        ``retrieval.tracing``)."""
        return tracing.trace_count()

    def frontend(self, stages: tuple, **kwargs):
        """A ``ServingFrontend`` over this retriever: shape-bucketed query
        padding, micro-batching, an optional result cache. See
        ``repro_torch.retrieval.frontend`` for the knobs."""
        from repro_torch.retrieval.frontend import ServingFrontend
        return ServingFrontend(self, stages, **kwargs)

    # ------------------------------------------------------------------
    # tiered residency + persistence (``retrieval.tiering``)
    # ------------------------------------------------------------------

    def tiered(self, hbm_budget: int, **kwargs):
        """A ``tiering.TieredEngine`` over this retriever: device-resident
        segment bytes capped at ``hbm_budget``, cold segments in (pinned)
        host memory, LRU promotion and demotion, async prefetch on a copy
        stream. The corpus can then exceed the card's memory."""
        from repro_torch.retrieval.tiering import TieredEngine
        return TieredEngine(self, hbm_budget, **kwargs)

    def snapshot(self, directory: str, **kwargs) -> str:
        """Persist the whole corpus (tensors, slot maps, tenant/filter/IVF
        companions) so a restart serves without re-ingesting; see
        ``tiering.snapshot``."""
        from repro_torch.retrieval import tiering
        return tiering.snapshot(self.store, directory, **kwargs)

    @classmethod
    def from_snapshot(cls, directory: str, mesh=None, *,
                      step: int | None = None, device=None,
                      place: bool = True, **kwargs) -> "Retriever":
        """Cold-start a retriever from a ``snapshot`` directory (this
        package's or ``repro``'s), bit for bit the store that was saved,
        every segment resident on ``device`` or, with ``mesh`` (and
        ``place``), placed on the mesh. Extra kwargs go to the constructor
        (``scan_chunk``, ``ingest``, ...)."""
        from repro_torch.retrieval import tiering
        store = tiering.restore_store(directory, mesh=mesh, step=step,
                                      device=device, place=place)
        return cls(store, device=device, mesh=mesh, place=False, **kwargs)

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    def _normalize(self, stages: tuple) -> tuple:
        """``stages`` with ``scan_chunk`` as the scan stage's chunk where
        the stage sets none."""
        stages = tuple(stages)
        if self.scan_chunk and stages and stages[0].chunk == 0:
            stages = MST.with_scan_policy(stages, chunk=self.scan_chunk)
        return stages

    def search_fn(self, stages: tuple):
        """The cascade function for ``stages`` (after ``scan_chunk``),
        built at most once per (stages, segment layout, mesh,
        overcommit); functions of an older layout are dropped.
        Signature: fn(stores: tuple, q, q_mask, fspec=None) -> (scores,
        slot ids)."""
        stages = self._normalize(stages)
        layout = self.store.layout_key()
        key = (stages, layout, self.mesh, self.rerank_overcommit)
        fn = self._fns.get(key)
        if fn is None:
            self._fns = {k: v for k, v in self._fns.items()
                         if k[1] == layout}
            fn = engine.make_segmented_search_fn(
                stages, self.store.capacities, self.mesh,
                self.rerank_overcommit)
            self._fns[key] = fn
        return fn

    def search(self, q, q_mask=None, *, stages: tuple,
               translate_ids: bool = True, filter=None) -> tuple:
        """Run the cascade: q [B,Q,d] -> (scores [B,k], ids [B,k]).

        ids are stable page ids (np.int64; -1 marks filler when k exceeds
        the live, matching corpus); pass translate_ids=False for the raw
        slot ids (a tensor on the retriever's device).

        ``filter`` is a request-scoped ``store.FilterSpec`` (tenant scope,
        required and any-of tags) or None for the whole corpus; the
        result is what an unfiltered search over only the matching
        documents returns."""
        q = torch.as_tensor(q).to(self.device)
        if q_mask is None:
            q_mask = torch.ones(q.shape[:2], dtype=torch.bool,
                                device=self.device)
        else:
            q_mask = torch.as_tensor(q_mask).to(self.device).bool()
        # a placed store hands over its slabs; an unplaced one its dicts,
        # which a mesh search splits on each call
        placed = self.mesh is not None and self.store.mesh is not None
        stores = self.store.shards() if placed else self.store.stores()
        scores, slots = self.search_fn(stages)(stores, q, q_mask, filter)
        if not translate_ids:
            return scores, slots
        ids = self.store.translate_slots(slots.cpu().numpy())
        # NEG-scored entries are filler, not results: dead slots already
        # translate to -1, but a slot also scores NEG when the request's
        # filter excluded a LIVE document — mask those ids too, so no
        # tenant learns another tenant's page ids from its filler
        filler = (scores <= engine.NEG / 2).cpu().numpy()
        return scores, np.where(filler, np.int64(-1), ids)
