"""The index path: raw page embeddings in, named vectors out.

``IngestPipeline`` runs hygiene mask -> model-aware pooling -> global pool
-> store dtype -> (optional) int8 quantisation on the pipeline's device,
batch by batch:

    pipe = IngestPipeline(cfg)                  # device="cuda" by default
    batch = pipe.index(raw_pages, token_types)  # a VectorStore
    retriever.upsert(batch)
    ids = pipe.ingest(retriever.store, raw_pages, token_types,
                      tenant=3, tags=(7,))      # index + write, stamped

Pooling (``use_kernel``):
- True  -> the fused one-matrix pooling operator ``pool_pages_fused``
  (the CUDA kernel for tensors on the card, its plain version on the CPU);
- False -> the functional ``core.pooling`` reference (``build_store``
  wraps this mode).

Quantisation (``quantize``/``stages``) follows ``quantize_store``: the
named vectors to int8-quantise (from the stored dtype, after pooling),
and the cascade that decides which float copies are dead weight. A
pipeline produces one fixed key set; the store it feeds must hold the
same set (``Retriever.upsert`` checks it).

Eager PyTorch never retraces, so a batch is indexed at its own size; the
JAX pipeline's power-of-two padding (``batch_bucket``) is not needed here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hygiene as HG
from repro_torch.core.pooling import global_pool, pool_pages_batch
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.pooling import ops as POPS
from repro_torch.retrieval.segments import bucket_capacity
from repro_torch.retrieval.store import (VectorStore, mask_key,
                                         quantize_vectors)

INGEST_BUCKET_MIN = 8
INGEST_BUCKET_MAX = 256        # the paper's index step (pages_per_step)
_BULK_GRANULE = 64
# the named vectors a pipeline produces, with their rank ([N, D, d] sets
# or one [N, d] vector per page)
PRODUCED_NDIM = {"initial": 3, "mean_pooling": 3, "global_pooling": 2}


def batch_bucket(n: int) -> int:
    """The ingest batch size the JAX pipeline pads ``n`` pages to. Up to
    ``INGEST_BUCKET_MAX``: the smallest power of two >= n (the
    ``segments.bucket_capacity`` ladder). Above it, the next 64-row
    granule (< 25% worst-case padding)."""
    if n < 1:
        raise ValueError(f"ingest batch must be >= 1 page, got {n}")
    if n > INGEST_BUCKET_MAX:
        return -(-n // _BULK_GRANULE) * _BULK_GRANULE
    return bucket_capacity(n, min_capacity=INGEST_BUCKET_MIN)


class IngestPipeline:
    """Hygiene -> pooling -> store dtype -> int8 codes, on one device."""

    def __init__(self, cfg, *, store_dtype=torch.bfloat16,
                 use_kernel: bool = True, quantize: tuple = (),
                 stages: tuple | None = None, device="cuda"):
        self.cfg = cfg
        self.store_dtype = store_dtype
        self.use_kernel = use_kernel
        self.quantize = tuple(quantize)
        self.stages = None if stages is None else tuple(stages)
        for name in self.quantize:
            if name not in PRODUCED_NDIM:
                raise ValueError(f"quantize name {name!r} not among "
                                 f"produced vectors {sorted(PRODUCED_NDIM)}")
        self.device = resolve_device(device)
        pm, row_valid = POPS.pooling_matrix_static(cfg)
        self._mat = torch.from_numpy(pm).to(self.device)
        self._row_valid = torch.from_numpy(row_valid).to(self.device)

    def _pool(self, vis, vis_mask) -> tuple:
        """Model-aware pooling: the fused one-matrix operator when enabled,
        the functional reference otherwise."""
        if not self.use_kernel:
            return pool_pages_batch(self.cfg, vis, vis_mask)
        pooled = POPS.pool_pages_fused(vis, vis_mask, self._mat)
        return pooled, self._row_valid.expand(pooled.shape[:-1])

    def _index_arrays(self, pages: torch.Tensor,
                      token_types: torch.Tensor) -> dict:
        """pages [B, S, d] f32 + token_types [S]|[B, S] -> the named-vector
        dict for the batch, in the store dtype (quantised names also as
        int8 codes + f32 scales)."""
        N, S, _ = pages.shape
        if token_types.ndim == 1:
            token_types = token_types[None].expand(N, S)
        emb, keep = HG.apply_hygiene(pages, token_types)

        # physically separate visual tokens (static layout: specials lead,
        # validated host-side by hygiene.require_visual_tail)
        n_vis = self.cfg.n_patches
        vis = emb[:, S - n_vis:]
        vis_mask = keep[:, S - n_vis:]
        sd = self.store_dtype
        pooled, pooled_mask = self._pool(vis, vis_mask)
        vectors = {
            "initial": vis.to(sd).contiguous(),
            mask_key("initial"): vis_mask.contiguous(),
            "mean_pooling": pooled.to(sd),
            mask_key("mean_pooling"): pooled_mask.contiguous(),
            "global_pooling": global_pool(vis, vis_mask).to(sd),
        }
        if self.quantize:
            vectors = quantize_vectors(vectors, self.quantize, self.stages)
        return vectors

    def _admit(self, pages, token_types) -> tuple:
        pages = torch.as_tensor(pages).to(device=self.device,
                                          dtype=torch.float32)
        if pages.ndim != 3 or pages.shape[1] != self.cfg.seq_len:
            raise ValueError(
                f"pages must be [N, S={self.cfg.seq_len}, d] raw encoder "
                f"output, got shape {tuple(pages.shape)}")
        HG.require_visual_tail(token_types, self.cfg.n_patches)
        return pages, torch.as_tensor(token_types).to(self.device)

    def index(self, pages, token_types) -> VectorStore:
        """Index a raw batch (numpy or torch, any device) into a standalone
        ``VectorStore`` on the pipeline's device."""
        pages, tt = self._admit(pages, token_types)
        return VectorStore(self._index_arrays(pages, tt), int(pages.shape[0]),
                           str(self.store_dtype).removeprefix("torch."))

    def ingest(self, store, pages, token_types, tenant: int = 0,
               tags=()) -> np.ndarray:
        """Index a raw batch and write it into ``store`` (a
        ``SegmentedStore`` holding this pipeline's key set), every page
        stamped with ``tenant`` and the packed ``tags`` bitset, as
        ``SegmentedStore.add_pages`` stamps them. With routing on, the new
        slots join their clusters there. Returns the stable page ids."""
        return store.add_pages(self.index(pages, token_types),
                               tenant=tenant, tags=tags)
