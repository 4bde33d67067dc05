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
- every array keeps its own dtype: the store dtype for float vectors, int8
  for quantised codes, f32 for their scales, bool for masks. A batch is
  written into a segment cast to the segment's dtypes, as the JAX store
  does.

Search-side, the engine scans each segment per stage and merges candidates
in a global SLOT id space (segment offsets = cumulative capacities);
``translate_slots`` turns slots back into stable user page ids.

This is the single-device store: segments live on one device and are
updated in place (JAX's arrays are immutable; here the in-place writes
save a copy of the segment per mutation).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.retrieval.store import (VALIDITY_KEY, VectorSchema,
                                         VectorStore, is_store_companion)

SEGMENT_MIN_CAPACITY = 64


def bucket_capacity(n: int, min_capacity: int = SEGMENT_MIN_CAPACITY) -> int:
    """Smallest power of two >= n (and >= min_capacity)."""
    cap = 1 << max(0, int(n - 1).bit_length())
    return max(cap, min_capacity)


@dataclass
class Segment:
    """One fixed-capacity slab. ``vectors`` holds every named tensor
    padded to ``capacity`` rows (including ``doc_valid``); ``n_docs`` is
    the high-water mark (next free tail slot); ``doc_ids`` maps slot ->
    stable user page id, -1 for never-written or deleted slots."""
    vectors: dict
    capacity: int
    n_docs: int
    doc_ids: np.ndarray

    @property
    def free(self) -> int:
        return self.capacity - self.n_docs

    @property
    def n_valid(self) -> int:
        return int((self.doc_ids >= 0).sum())


class SegmentedStore:
    """A mutable corpus as a list of capacity-padded segments on one
    device."""

    def __init__(self, segments: list, store_dtype: str = "bfloat16",
                 next_id: int = 0):
        self.segments = list(segments)
        self.store_dtype = store_dtype
        self.next_id = next_id
        self._slot_ids: np.ndarray | None = None   # slot->page-id cache

    @classmethod
    def from_store(cls, store: VectorStore, capacity: int | None = None,
                   device=None):
        """Wrap a built store as segment 0, on ``device`` (default: the
        store's own). Default capacity is an exact fit; pass ``capacity``
        (e.g. ``bucket_capacity``) to preallocate ingestion headroom."""
        cap = capacity if capacity is not None else store.n_docs
        if cap < store.n_docs:
            raise ValueError(f"capacity {cap} < n_docs {store.n_docs}")
        out = cls([], store.store_dtype)
        dev = store.device if device is None else torch.device(device)
        seg = out._alloc_segment(store.vectors, cap, dev)
        n = store.n_docs
        for k, v in store.vectors.items():
            seg.vectors[k][:n] = v
        seg.vectors[VALIDITY_KEY][:n] = True
        seg.doc_ids[:n] = np.arange(n)
        seg.n_docs = n
        out.next_id = n
        return out

    def _alloc_segment(self, like_vectors: dict, capacity: int,
                       device) -> Segment:
        vecs = {k: torch.zeros((capacity,) + tuple(v.shape[1:]),
                               dtype=v.dtype, device=device)
                for k, v in like_vectors.items() if not is_store_companion(k)}
        # dead slots are invalid until a write claims them
        vecs[VALIDITY_KEY] = torch.zeros((capacity,), dtype=torch.bool,
                                         device=device)
        seg = Segment(vecs, capacity, 0, np.full((capacity,), -1, np.int64))
        self.segments.append(seg)
        return seg

    @property
    def device(self) -> torch.device:
        return self.segments[0].vectors[VALIDITY_KEY].device

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------

    def add_pages(self, batch: VectorStore) -> np.ndarray:
        """Ingest an indexed batch (the output of ``build_store`` or
        ``IngestPipeline.index``). Returns the assigned stable page ids.

        The batch must carry the store's exact key set (int8 codes and
        scales included). Fits the WHOLE batch into the last segment's
        free tail when possible; otherwise allocates a new bucketed
        segment sized to the batch (batches are never split)."""
        n = batch.n_docs
        names = {k for k in self.segments[0].vectors
                 if not is_store_companion(k)}
        if set(batch.vectors) != names:
            raise ValueError(f"batch vectors {sorted(batch.vectors)} != "
                             f"store vectors {sorted(names)}")
        seg = self.segments[-1]
        if seg.free < n:
            seg = self._alloc_segment(seg.vectors, bucket_capacity(n),
                                      self.device)
        start = seg.n_docs
        for k, v in batch.vectors.items():
            seg.vectors[k][start:start + n] = v
        seg.vectors[VALIDITY_KEY][start:start + n] = True
        ids = np.arange(self.next_id, self.next_id + n, dtype=np.int64)
        seg.doc_ids[start:start + n] = ids
        seg.n_docs = start + n
        self.next_id += n
        self._slot_ids = None
        return ids

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
            valid = seg.vectors[VALIDITY_KEY]
            valid[torch.from_numpy(slots).to(valid.device)] = False
            seg.doc_ids[slots] = -1
            deleted += int(slots.size)
        if deleted:
            self._slot_ids = None
        return deleted

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------

    def stores(self) -> tuple:
        """Per-segment vectors dicts, in slot order — the engine's input."""
        return tuple(seg.vectors for seg in self.segments)

    @property
    def vectors(self) -> dict:
        """Single-segment convenience view (the capacity-padded tensors,
        ``doc_valid`` included)."""
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
        return VectorSchema.infer(self.segments[0].vectors)

    def dims(self) -> dict:
        return self.schema().dims()
