"""Segmented, capacity-padded mutable corpus (the live-index store).

- a ``Segment`` is a fixed-``capacity`` slab of named-vector tensors padded
  with zero slots, plus a ``doc_valid`` [capacity] bool mask (stored in the
  vectors dict so it threads through the engine like any per-doc array)
  and a host-side ``doc_ids`` map from slot to user page id;
- ``SegmentedStore.add_pages`` writes an indexed batch into the
  preallocated tail of the last segment, in place; when a batch does not
  fit, a NEW segment is allocated at a bucketed power-of-two capacity;
- ``delete`` only flips ``doc_valid`` bits (validity masking), it never
  moves a byte;
- ``compact`` is the amortised reclaim: it rebuilds the corpus from the
  surviving rows into one right-sized segment (a layout change);
- ``reserve``/``commit`` are the slot bookkeeping that ``add_pages`` and
  the fused ``IngestPipeline.ingest`` share: ``reserve`` finds (or
  allocates) tail room without claiming it, the caller writes the
  segment's tensors, and ``commit`` assigns page ids, advances the fill
  and bumps ``generation``, the counter every mutation bumps (result
  caches key on it);
- ``doc_valid`` has two siblings written by the same writes:
  ``doc_tenant`` [capacity] int32 (``add_pages(tenant=)``, 0 by default)
  and ``doc_filter`` [capacity, filter_words] int32, the packed tag bitset
  (``add_pages(tags=)``; int32 bit patterns of uint32 words, see
  ``store``). Dead slots hold zeros; ``delete`` leaves both in place;
- with IVF routing on (``enable_routing``), each segment also carries its
  cluster index (``ivf_centroids`` [K, d], ``ivf_members`` [K, C]) and its
  host-side ``routing.RouteState``; every write assigns the new slots to
  clusters (``routing.on_commit``) and every delete ticks the drift
  counter (``routing.on_delete``), re-clustering past the policy's drift
  threshold;
- every array keeps its own dtype: the store dtype for float vectors, int8
  for quantised codes, f32 for their scales, bool for masks. A batch is
  written into a segment cast to the segment's dtypes, as the JAX store
  does.

Search-side, the engine scans each segment per stage and merges candidates
in a global SLOT id space (segment offsets = cumulative capacities);
``translate_slots`` turns slots back into stable user page ids.

A segment's tensors are a tuple of store dicts, ``Segment.slabs``: one
for a store on one device, and on a mesh (``launch.mesh``) one per mesh
position, where shard r holds slots
``[r * n_local, (r + 1) * n_local)`` of every per-document tensor
(``n_local = capacity // n_shards``; ``repro``'s ``P(axes)``) on its
device, with the routing companions copied whole to every shard
(``P()``). Capacities are multiples of ``n_shards`` (``bucket_capacity``
rounds them up). The writes (``add_pages``, the fused ingest's block,
``delete``, ``compact``) split their row ranges across the slabs through
``Segment.write``/``fill``/``invalidate``/``take``; the slot -> page id
map stays one host table. The slabs are updated in place (JAX's arrays
are immutable; here the in-place writes save a copy of the segment per
mutation).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.launch.mesh import home_device
from repro_torch.retrieval import routing as RT
from repro_torch.retrieval.store import (FILTER_KEY, ROUTING_KEYS,
                                         TENANT_KEY, VALIDITY_KEY,
                                         VectorSchema,
                                         VectorStore, from_numpy,
                                         is_store_companion, pack_tags,
                                         split_slabs, words_tensor)

SEGMENT_MIN_CAPACITY = 64


def bucket_capacity(n: int, n_shards: int = 1,
                    min_capacity: int = SEGMENT_MIN_CAPACITY) -> int:
    """Smallest power of two >= n (and >= min_capacity), rounded up to a
    multiple of ``n_shards`` so every shard owns an equal slab."""
    cap = 1 << max(0, int(n - 1).bit_length())
    cap = max(cap, min_capacity)
    return _round_up(cap, n_shards)


def _round_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


@dataclass
class Segment:
    """One fixed-capacity segment. ``slabs`` holds every named tensor
    padded to ``capacity`` rows (including ``doc_valid``) as a tuple of
    store dicts in mesh order: one on one device, one per mesh position
    on a mesh, each with its shard's ``capacity // len(slabs)`` rows;
    ``n_docs`` is the high-water mark (next free tail slot); ``doc_ids``
    maps slot -> stable user page id, -1 for never-written or deleted
    slots."""
    slabs: tuple
    capacity: int
    n_docs: int
    doc_ids: np.ndarray
    # host-side IVF bookkeeping (``routing.RouteState``); None until the
    # store's router is enabled. The centroid / member tensors live in
    # every slab under the reserved routing keys.
    routing: object = None
    # residency tier (``retrieval.tiering``): "device" = the tensors live
    # on the store's device; "host" = spilled to host memory (pinned CPU
    # tensors when the store is on the card) with the SAME keys, shapes
    # and dtypes. Residency is placement, never shape: ``layout_key()``
    # ignores it, so search functions survive tier swaps (a host-tier
    # segment is promoted before it is scanned; the tiering layer owns
    # that).
    tier: str = "device"

    @property
    def free(self) -> int:
        return self.capacity - self.n_docs

    @property
    def n_valid(self) -> int:
        return int((self.doc_ids >= 0).sum())

    @property
    def vectors(self) -> dict:
        """The store dict of a segment on one device (its only slab)."""
        if len(self.slabs) != 1:
            raise ValueError(f"a segment in {len(self.slabs)} slabs has no "
                             "flat vectors view; use slabs or gathered()")
        return self.slabs[0]

    @property
    def nbytes(self) -> int:
        """Bytes of this segment's tensors in its current tier (the unit
        of the tiering layer's device-memory budget): the whole segment,
        its slabs summed, with the routing companions that every shard
        holds counted once, as ``repro``'s global arrays count them."""
        return sum(v.numel() * v.element_size()
                   for r, slab in enumerate(self.slabs)
                   for k, v in slab.items() if r == 0 or k not in ROUTING_KEYS)

    def _pieces(self, start: int, end: int):
        """(slab, local start, local end, offset into the row range) of
        each slab that global rows ``[start, end)`` touch."""
        slabs = self.slabs
        n_local = self.capacity // len(slabs)
        for r, slab in enumerate(slabs):
            lo, hi = max(start, r * n_local), min(end, (r + 1) * n_local)
            if lo < hi:
                yield slab, lo - r * n_local, hi - r * n_local, lo - start

    def _local(self, slots: np.ndarray):
        """(slab, its local slot ids) of the global ``slots`` each slab
        owns, in slot order within a slab."""
        slabs = self.slabs
        n_local = self.capacity // len(slabs)
        for r, slab in enumerate(slabs):
            own = slots[(slots >= r * n_local) & (slots < (r + 1) * n_local)]
            if own.size:
                yield slab, own - r * n_local

    def write(self, key: str, start: int, block: torch.Tensor) -> None:
        """Copy ``block`` [m, ...] into rows ``[start, start + m)`` of the
        per-document tensor ``key`` (cast to its dtype), across the slabs
        the rows span."""
        for slab, lo, hi, b in self._pieces(start, start + block.shape[0]):
            dst = slab[key][lo:hi]
            dst.copy_(block[b:b + hi - lo].to(dst.device))

    def fill(self, key: str, start: int, end: int, value) -> None:
        """Set rows ``[start, end)`` of ``key`` to ``value``: a scalar, or
        a tensor broadcast over the rows."""
        for slab, lo, hi, _ in self._pieces(start, end):
            dst = slab[key][lo:hi]
            if isinstance(value, torch.Tensor):
                dst.copy_(value.to(dst.device))
            else:
                dst.fill_(value)

    def invalidate(self, slots: np.ndarray) -> None:
        """Clear the ``doc_valid`` bits of the global ``slots``."""
        for slab, local in self._local(slots):
            valid = slab[VALIDITY_KEY]
            valid[torch.from_numpy(local).to(valid.device)] = False

    def take(self, key: str, slots: np.ndarray, device=None
             ) -> torch.Tensor:
        """Rows of the per-document tensor ``key`` at the ascending global
        ``slots``, on ``device`` (default: the first slab's)."""
        device = self.slabs[0][key].device if device is None else device
        parts = [slab[key][torch.from_numpy(local).to(slab[key].device)]
                 .to(device) for slab, local in self._local(slots)]
        if not parts:
            return self.slabs[0][key][:0].to(device)
        return torch.cat(parts)

    def tensor(self, key: str, device=None) -> torch.Tensor:
        """The whole segment's tensor ``key`` on ``device`` (default: the
        first slab's): the slabs' rows in mesh order; a routing companion
        from the first slab (every slab holds the same)."""
        slabs = self.slabs
        device = slabs[0][key].device if device is None else device
        if len(slabs) == 1 or key in ROUTING_KEYS:
            return slabs[0][key].to(device)
        return torch.cat([s[key].to(device) for s in slabs])

    def gathered(self) -> dict:
        """Every tensor of the segment whole (``tensor``), on the first
        slab's device; for a segment on one device, its own tensors."""
        return {k: self.tensor(k) for k in self.slabs[0]}

    def set_replicated(self, key: str, t: torch.Tensor) -> None:
        """Store a routing companion: ``t`` itself on the first slab, a
        copy on each further slab's device."""
        for r, slab in enumerate(self.slabs):
            slab[key] = t.to(slab[VALIDITY_KEY].device, copy=r > 0)


class SegmentedStore:
    """A mutable corpus as a list of capacity-padded segments, on one
    device or placed on a mesh (``place_on``)."""

    def __init__(self, segments: list, store_dtype: str = "bfloat16",
                 next_id: int = 0, filter_words: int = 1,
                 n_shards: int = 1, mesh=None):
        self.segments = list(segments)
        self.store_dtype = store_dtype
        self.next_id = next_id
        # width of the packed tag bitset (32 tags per word), fixed at
        # construction
        self.filter_words = max(int(filter_words), 1)
        # capacities are multiples of n_shards; ``mesh`` (when set) is
        # where new segments are allocated, one slab per position
        self.n_shards = max(int(n_shards), 1 if mesh is None else mesh.size)
        self.mesh = mesh
        # IVF routing policy (``routing.RoutingPolicy``); None = exhaustive
        # scans only. Set by ``enable_routing``.
        self.router = None
        self._slot_ids: np.ndarray | None = None   # slot->page-id cache
        # bumped on every content mutation (add_pages/ingest commit,
        # delete, compact) so result caches keyed on it can never serve
        # pre-mutation answers
        self.generation = 0

    @classmethod
    def from_store(cls, store: VectorStore, capacity: int | None = None,
                   device=None, filter_words: int = 1, n_shards: int = 1,
                   mesh=None):
        """Wrap a built store as segment 0, on ``device`` (default: the
        store's own) or, with ``mesh``, placed on the mesh. Default
        capacity is an exact fit; pass ``capacity`` (e.g.
        ``bucket_capacity``) to preallocate ingestion headroom; either is
        rounded up to a multiple of ``n_shards`` (at least the mesh's
        size). Wrapped pages get tenant 0 and no tags; ``filter_words``
        sizes the packed bitset for pages upserted later."""
        cap = capacity if capacity is not None else store.n_docs
        if cap < store.n_docs:
            raise ValueError(f"capacity {cap} < n_docs {store.n_docs}")
        out = cls([], store.store_dtype, filter_words=filter_words,
                  n_shards=n_shards, mesh=mesh)
        dev = store.device if device is None else torch.device(device)
        seg = out._alloc_segment(store.vectors,
                                 _round_up(cap, out.n_shards), dev)
        n = store.n_docs
        for k, v in store.vectors.items():
            seg.write(k, 0, v)
        seg.fill(VALIDITY_KEY, 0, n, True)
        seg.doc_ids[:n] = np.arange(n)
        seg.n_docs = n
        out.next_id = n
        return out

    @classmethod
    def from_numpy(cls, src, device=None, mesh=None):
        """The port's copy of another segmented store ``src`` — e.g. a
        ``repro`` ``SegmentedStore``, read through its attributes only:
        every segment's arrays (taken with ``np.asarray``; tenant ids, tag
        words, routing centroids and members included), capacity, fill,
        slot -> page id map and ``RouteState`` (fills, drift), and the
        store's next id, filter width, shard count and routing policy. On
        ``device`` ("cuda" by default), or placed on ``mesh``."""
        dev = home_device(mesh, device)
        out = cls([], src.store_dtype, next_id=int(src.next_id),
                  filter_words=int(src.filter_words),
                  n_shards=int(getattr(src, "n_shards", 1)))
        if src.router is not None:
            p = src.router
            out.router = RT.RoutingPolicy(
                int(p.n_clusters), int(p.cluster_capacity), int(p.iters),
                float(p.drift_threshold))
        for seg in src.segments:
            vecs = from_numpy({k: np.asarray(v)
                               for k, v in seg.vectors.items()},
                              device=dev).vectors
            st = seg.routing
            routing = None if st is None else RT.RouteState(
                fills=np.array(st.fills, np.int64), drift=int(st.drift))
            out.segments.append(Segment(
                (vecs,), int(seg.capacity), int(seg.n_docs),
                np.array(seg.doc_ids, np.int64), routing))
        if mesh is not None:
            out.place_on(mesh)
        return out

    def place_on(self, mesh) -> None:
        """Lay every segment out on ``mesh``, once (never per search): one
        slab per mesh position, each on its device with its shard's rows
        of every per-document tensor; the IVF routing companions are
        copied whole to every shard (every shard routes a query through
        the same centroids and member lists, then scores only the member
        slots it owns). Later segments are allocated on the mesh.
        Capacities must divide by the mesh's size, and every segment must
        be device-resident."""
        devices = tuple(mesh.devices.flat)
        for seg in self.segments:
            if seg.capacity % len(devices):
                raise ValueError(f"segment capacity {seg.capacity} not "
                                 f"divisible by {len(devices)} shards")
            if seg.tier != "device":
                raise ValueError("a host-tier segment cannot be placed; "
                                 "promote it first")
        self.mesh = mesh
        self.n_shards = max(self.n_shards, len(devices))
        for seg in self.segments:
            if tuple(s[VALIDITY_KEY].device for s in seg.slabs) != devices:
                seg.slabs = split_slabs(seg.gathered(), mesh, copy=True)

    def _alloc_segment(self, like_vectors: dict, capacity: int,
                       device) -> Segment:
        devices = ((torch.device(device),) if self.mesh is None
                   else tuple(self.mesh.devices.flat))
        slabs = tuple(self._zeros(like_vectors, capacity // len(devices), d)
                      for d in devices)
        seg = Segment(slabs, capacity, 0, np.full((capacity,), -1, np.int64))
        if self.router is not None:
            arrays, seg.routing = RT.alloc_arrays(self.router, like_vectors,
                                                  capacity, devices[0])
            for k, v in arrays.items():
                seg.set_replicated(k, v)
        self.segments.append(seg)
        return seg

    def _zeros(self, like_vectors: dict, rows: int, device) -> dict:
        vecs = {k: torch.zeros((rows,) + tuple(v.shape[1:]), dtype=v.dtype,
                               device=device)
                for k, v in like_vectors.items() if not is_store_companion(k)}
        # the store companions are zero-initialised: dead slots are
        # invalid, tenant 0, no tags, until a write claims them
        vecs[VALIDITY_KEY] = torch.zeros((rows,), dtype=torch.bool,
                                         device=device)
        vecs[TENANT_KEY] = torch.zeros((rows,), dtype=torch.int32,
                                       device=device)
        vecs[FILTER_KEY] = torch.zeros((rows, self.filter_words),
                                       dtype=torch.int32, device=device)
        return vecs

    def enable_routing(self, policy) -> None:
        """Build (or rebuild) the IVF cluster index over every segment.

        ``policy`` is a ``routing.RoutingPolicy`` or a plain int K. Adds
        the centroid/member companions; ``add_pages`` and ``delete`` then
        maintain them (assign-to-nearest on each write, drift-triggered
        re-clustering). A cascade opts in with ``Stage.n_probe``
        (``multistage.with_routing_policy``). On a mesh each segment is
        clustered once, whole, and every shard gets the same index."""
        if not isinstance(policy, RT.RoutingPolicy):
            policy = RT.RoutingPolicy(n_clusters=int(policy))
        self.router = policy
        for seg in self.segments:
            RT.recluster(self, seg)

    @property
    def device(self) -> torch.device:
        """The device of the store's device-tier segments (segment 0's
        when every segment is spilled to host memory); on a mesh, the
        first slab's, the gather device."""
        seg = next((s for s in self.segments if s.tier == "device"),
                   self.segments[0])
        return seg.slabs[0][VALIDITY_KEY].device

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------

    def reserve(self, n: int, like: dict | None = None,
                min_free: int | None = None) -> tuple:
        """Find (or allocate) room for ``n`` new pages at the tail of the
        corpus. Returns ``(segment index, start slot)``; the slots are NOT
        claimed until ``commit`` runs. Batches are never split: when the
        last segment's free tail is too small, a NEW segment is allocated
        at a bucketed power-of-two capacity (``like`` supplies the layout
        when the store is still empty). ``min_free`` asks for tail room
        beyond ``n``: the fused ingest copies a full bucket-wide block, so
        the whole block must fit although only ``n`` slots are claimed."""
        need = max(n, min_free or 0)
        seg = self.segments[-1] if self.segments else None
        if seg is None or seg.free < need:
            if seg is None and like is None:
                raise ValueError("reserve() on an empty store needs `like` "
                                 "arrays for the segment layout")
            dev = (next(iter(like.values())).device if seg is None
                   else self.device)
            self._alloc_segment(like if like is not None else seg.slabs[0],
                                bucket_capacity(need, self.n_shards), dev)
        return len(self.segments) - 1, self.segments[-1].n_docs

    def commit(self, seg_i: int, n: int) -> np.ndarray:
        """The host bookkeeping shared by ``add_pages`` and the fused
        ingest, once they have written the ``n`` reserved tail slots of
        segment ``seg_i`` in place: assign stable page ids to them, advance
        the high-water mark, bump the generation and, with routing on,
        assign the new slots to their clusters. Returns the assigned
        ids."""
        seg = self.segments[seg_i]
        start = seg.n_docs
        ids = np.arange(self.next_id, self.next_id + n, dtype=np.int64)
        seg.doc_ids[start:start + n] = ids
        seg.n_docs = start + n
        self.next_id += n
        self._slot_ids = None
        self.generation += 1
        if self.router is not None:
            RT.on_commit(self, seg, np.arange(start, start + n,
                                              dtype=np.int64))
        return ids

    def add_pages(self, batch: VectorStore, tenant: int = 0,
                  tags=()) -> np.ndarray:
        """Ingest an indexed batch (the output of ``build_store`` or
        ``IngestPipeline.index``). Returns the assigned stable page ids.

        The batch must carry the store's exact key set (int8 codes and
        scales included). Fits the WHOLE batch into the last segment's
        free tail when possible; otherwise allocates a new bucketed
        segment sized to the batch (batches are never split).

        ``tenant``/``tags`` stamp the batch's store companions: every page
        of the batch belongs to ``tenant`` and carries the packed ``tags``
        bitset (queries filter on them with ``store.FilterSpec``). With
        routing on, the new slots join their nearest cluster with room."""
        n = batch.n_docs
        if self.segments:
            names = {k for k in self.segments[0].slabs[0]
                     if not is_store_companion(k)}
            if set(batch.vectors) != names:
                raise ValueError(f"batch vectors {sorted(batch.vectors)} != "
                                 f"store vectors {sorted(names)}")
        words = pack_tags(tags, self.filter_words)
        seg_i, start = self.reserve(n, like=batch.vectors)
        seg = self.segments[seg_i]
        for k, v in batch.vectors.items():
            seg.write(k, start, v)
        seg.fill(VALIDITY_KEY, start, start + n, True)
        seg.fill(TENANT_KEY, start, start + n, int(tenant))
        seg.fill(FILTER_KEY, start, start + n, words_tensor(words)[None, :])
        return self.commit(seg_i, n)

    def delete(self, ids) -> int:
        """Invalidate pages by stable id. Only flips ``doc_valid`` bits —
        no data moves, no shapes change. Returns #pages deleted."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        # search results use -1 as dead-slot filler; piping them back in
        # must not match the -1 sentinel in doc_ids
        ids = ids[ids >= 0]
        deleted = 0
        for seg in self.segments:
            slots = np.flatnonzero(np.isin(seg.doc_ids, ids))
            if slots.size == 0:
                continue
            seg.invalidate(slots)
            seg.doc_ids[slots] = -1
            deleted += int(slots.size)
            if self.router is not None:
                RT.on_delete(self, seg, int(slots.size))
        if deleted:
            self._slot_ids = None
            self.generation += 1
        return deleted

    def compact(self) -> "SegmentedStore":
        """Rebuild the corpus from surviving rows into one right-sized
        segment, keeping page ids and their relative order. Survivors are
        gathered in slot order (ids ascending); ``doc_tenant`` and
        ``doc_filter`` ride the gather, ``doc_valid`` is rebuilt (every
        survivor is live) and, with routing on, the segment is clustered
        afresh. The layout changes, so search functions are rebuilt."""
        if not self.segments:
            return self
        dev = self.device
        first = self.segments[0].slabs[0]
        names = [k for k in first
                 if k != VALIDITY_KEY and k not in ROUTING_KEYS]
        like = {k: first[k] for k in names}
        rows = {k: [] for k in names}
        ids = []
        for seg in self.segments:
            slots = np.flatnonzero(seg.doc_ids >= 0)
            if slots.size == 0:
                continue
            for k in names:
                rows[k].append(seg.take(k, slots, dev))
            ids.append(seg.doc_ids[slots])
        total = int(sum(len(i) for i in ids))
        self.segments = []
        seg = self._alloc_segment(
            like, bucket_capacity(max(total, 1), self.n_shards), dev)
        if total:
            for k in names:
                seg.write(k, 0, torch.cat(rows[k]))
            seg.fill(VALIDITY_KEY, 0, total, True)
            seg.doc_ids[:total] = np.concatenate(ids)
        seg.n_docs = total
        if self.router is not None:
            RT.recluster(self, seg)
        self._slot_ids = None
        self.generation += 1
        return self

    def tier_swap(self, seg_i: int, slabs: tuple, tier: str) -> None:
        """Adopt a promotion's or demotion's slabs for segment ``seg_i``:
        the SAME slabs, keys, shapes and dtypes in another placement
        (device tensors on promote, host tensors on demote). The one
        mutation the tiering layer makes to the store:

        - ``generation`` bumps: no value changed, but result caches keyed
          on it (the frontend's) drop their entries rather than reason
          about residency;
        - ``doc_ids`` and the slot map are untouched, and so is
          ``layout_key()``: a tier swap builds no search function.
        """
        seg = self.segments[seg_i]
        if len(slabs) != len(seg.slabs) or any(
                set(a) != set(b) for a, b in zip(slabs, seg.slabs)):
            raise ValueError(
                f"tier swap changed the key set for segment {seg_i}: "
                f"{sorted(set(slabs[0]) ^ set(seg.slabs[0]))}, "
                f"{len(slabs)} slabs for {len(seg.slabs)}")
        seg.slabs = tuple(slabs)
        seg.tier = tier
        self.generation += 1

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------

    def stores(self) -> tuple:
        """Per-segment store dicts, in slot order — the single-device
        engine's input (each segment's only slab)."""
        return tuple(seg.vectors for seg in self.segments)

    def shards(self) -> tuple:
        """Per-segment slabs in mesh order, in slot order — the sharded
        engine's input."""
        return tuple(seg.slabs for seg in self.segments)

    @property
    def vectors(self) -> dict:
        """Single-segment convenience view on one device (the
        capacity-padded tensors, ``doc_valid`` included)."""
        if len(self.segments) != 1:
            raise ValueError(
                f"{len(self.segments)} segments have no flat vectors view; "
                "use stores()")
        return self.segments[0].vectors

    @property
    def capacities(self) -> tuple:
        return tuple(seg.capacity for seg in self.segments)

    @property
    def n_valid(self) -> int:
        return sum(seg.n_valid for seg in self.segments)

    @property
    def total_capacity(self) -> int:
        return sum(self.capacities)

    def layout_key(self) -> tuple:
        """Everything a search function's shapes depend on: capacities and
        per-array trailing dims and dtypes, NOT the fill level or the
        placement. Upserts into existing padding and deletes leave it
        unchanged; a new segment, ``compact`` and ``enable_routing``
        change it."""
        return tuple(
            (seg.capacity,
             tuple(sorted((k, tuple(v.shape[1:]), str(v.dtype))
                          for k, v in seg.slabs[0].items())))
            for seg in self.segments)

    def slot_doc_ids(self) -> np.ndarray:
        """Global slot -> stable page id (-1 = dead slot), concatenated in
        segment order to match the engine's global slot id space."""
        if self._slot_ids is None:
            self._slot_ids = np.concatenate(
                [seg.doc_ids for seg in self.segments])
        return self._slot_ids

    def translate_slots(self, slots) -> np.ndarray:
        """Global slot ids -> stable page ids. Slot -1 (the dead-filler
        sentinel) maps to page id -1 rather than wrapping to the last
        slot."""
        table = self.slot_doc_ids()
        slots = np.asarray(slots)
        return np.where(slots >= 0,
                        table[np.clip(slots, 0, len(table) - 1)],
                        np.int64(-1))

    def schema(self) -> VectorSchema:
        return VectorSchema.infer(self.segments[0].slabs[0])

    def dims(self) -> dict:
        return self.schema().dims()

    def vec_dims(self) -> dict:
        """Stored embedding dim per named vector (``VectorStore.vec_dims``'s
        twin, so ``multistage.qps_cost_model`` and ``cascade_hbm_bytes``
        bill a live corpus)."""
        return self.schema().vec_dims()
