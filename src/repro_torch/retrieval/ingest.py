"""The index path: raw page embeddings in, named vectors out.

``IngestPipeline`` runs hygiene mask -> model-aware pooling -> global pool
-> store dtype -> (optional) int8 quantisation on the pipeline's device,
batch by batch, and ``ingest`` writes the result straight into a
segmented store's headroom:

    pipe = IngestPipeline.for_config(cfg)        # device="cuda" by default
    r = Retriever(pipe.index(seed_pages, token_types), capacity=1 << 16,
                  ingest=pipe)
    ids = r.ingest(raw_pages, token_types, tenant=3, tags=(7,))
    batch = pipe.index(raw_pages, token_types)   # a standalone VectorStore

Pooling (``use_kernel``):
- True  -> the fused one-matrix pooling operator ``pool_pages_fused``
  (the CUDA kernel for tensors on the card, its plain version on the
  CPU). A per-page effective height ``h_eff`` takes the reference path:
  the operator's one matrix holds one geometry;
- False -> the functional ``core.pooling`` reference (``build_store``
  wraps this mode).

Quantisation (``quantize``/``stages``) follows ``quantize_store``: the
named vectors to int8-quantise (from the stored dtype, after pooling),
and the cascade that decides which float copies are dead weight. A
pipeline produces one fixed key set (``produced_keys``); the store it
writes into must hold the same set.

Batches are padded to a small family of INGEST BUCKETS (``batch_bucket``:
powers of two, then 64-row granules), with zero pages and PAD token
types. ``index`` and ``ingest`` compute on the same padded shapes, so the
fused write gives the arrays of ``index`` + ``add_pages`` bit for bit, and
``ingest`` copies each array into the segment tail as ONE full-bucket
slice copy (the padding rows zeroed, so an unclaimed slot holds exactly
its allocation state; the next batch overwrites them). No result comes
back to the host before ``SegmentedStore.commit``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import hygiene as HG
from repro_torch.core.pooling import global_pool, pool_pages_batch
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.pooling import ops as POPS
from repro_torch.retrieval.segments import bucket_capacity
from repro_torch.retrieval.store import (FILTER_KEY, TENANT_KEY,
                                         VALIDITY_KEY, VectorStore,
                                         codes_key, is_store_companion,
                                         mask_key, pack_tags,
                                         quantize_vectors, scale_key,
                                         words_tensor)

INGEST_BUCKET_MIN = 8
INGEST_BUCKET_MAX = 256        # the paper's index step (pages_per_step)
_BULK_GRANULE = 64
# the named vectors a pipeline produces, with their rank ([N, D, d] sets
# or one [N, d] vector per page)
PRODUCED_NDIM = {"initial": 3, "mean_pooling": 3, "global_pooling": 2,
                 "experimental": 3}


def batch_bucket(n: int, min_bucket: int = INGEST_BUCKET_MIN) -> int:
    """The ingest batch family. Up to ``INGEST_BUCKET_MAX``: the smallest
    power of two >= n (and >= ``min_bucket``; the
    ``segments.bucket_capacity`` ladder). Above it (one-shot bulk builds),
    the next 64-row granule (< 25% worst-case padding)."""
    if n < 1:
        raise ValueError(f"ingest batch must be >= 1 page, got {n}")
    if n > INGEST_BUCKET_MAX:
        return -(-n // _BULK_GRANULE) * _BULK_GRANULE
    return bucket_capacity(n, min_capacity=min_bucket)


def _pad_rows(x: torch.Tensor, to: int, fill=0) -> torch.Tensor:
    n = x.shape[0]
    if n == to:
        return x
    out = torch.full((to,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    out[:n] = x
    return out


_PIPELINES: dict = {}


class IngestPipeline:
    """Hygiene -> pooling -> store dtype -> int8 codes, on one device."""

    def __init__(self, cfg, *, store_dtype=torch.bfloat16,
                 experimental_smooth: str | None = None,
                 quantize: tuple = (), stages: tuple | None = None,
                 use_kernel: bool = True, device="cuda",
                 min_bucket: int = INGEST_BUCKET_MIN):
        """``min_bucket`` is the smallest ingest-batch bucket
        (``batch_bucket``): a batch of n pages is padded to the smallest
        power of two >= max(n, min_bucket), and ``ingest`` reserves that
        many slots of segment headroom."""
        self.cfg = cfg
        self.store_dtype = store_dtype
        self.experimental_smooth = experimental_smooth
        self.quantize = tuple(quantize)
        self.stages = None if stages is None else tuple(stages)
        self.use_kernel = use_kernel
        self.device = resolve_device(device)
        self.min_bucket = min_bucket
        for name in self.quantize:
            if name not in self._produced_names():
                raise ValueError(
                    f"quantize name {name!r} not among produced vectors "
                    f"{self._produced_names()}")
        self._mats = {}
        if use_kernel:
            self._mats["mean_pooling"] = self._static_operator(cfg)
            if experimental_smooth:
                self._mats["experimental"] = self._static_operator(
                    dataclasses.replace(cfg, smooth=experimental_smooth))
        self.produced_keys = self._produced_keys()

    @classmethod
    def for_config(cls, cfg, *, store_dtype=torch.bfloat16,
                   experimental_smooth: str | None = None,
                   quantize: tuple = (), stages: tuple | None = None,
                   use_kernel: bool = True, device="cuda",
                   min_bucket: int = INGEST_BUCKET_MIN) -> "IngestPipeline":
        """Shared pipeline per (cfg, options, device): the process-wide
        cache behind ``build_store``, so repeated builds reuse one
        pipeline (and its pooling operator on the device)."""
        dev = resolve_device(device)
        key = (cfg, store_dtype, experimental_smooth, tuple(quantize),
               None if stages is None else tuple(stages), use_kernel,
               str(dev), min_bucket)
        pipe = _PIPELINES.get(key)
        if pipe is None:
            pipe = _PIPELINES[key] = cls(
                cfg, store_dtype=store_dtype,
                experimental_smooth=experimental_smooth, quantize=quantize,
                stages=stages, use_kernel=use_kernel, device=dev,
                min_bucket=min_bucket)
        return pipe

    # ------------------------------------------------------------------
    # static layout
    # ------------------------------------------------------------------

    @property
    def pool_path(self) -> str:
        """Where static-geometry pooling runs: ``fused-cuda`` (the pooling
        kernel on the card), ``fused-plain`` (the operator's plain version
        on the CPU) or ``reference`` (the functional ``core.pooling``
        chain, i.e. ``use_kernel=False``)."""
        if not self.use_kernel:
            return "reference"
        return "fused-cuda" if self.device.type == "cuda" else "fused-plain"

    def _produced_names(self) -> tuple:
        names = ["initial", "mean_pooling", "global_pooling"]
        if self.experimental_smooth:
            names.append("experimental")
        return tuple(names)

    def _produced_keys(self) -> tuple:
        """The key set ``index`` produces: every named vector, the masks
        of the multi-vector ones, int8 codes and scales of the quantised
        ones, minus the float copies ``quantize_vectors`` drops."""
        names = self._produced_names()
        keys = set(names) | {mask_key(n) for n in names
                             if PRODUCED_NDIM[n] == 3}
        rerank = {s.vector for s in (self.stages or ())[1:]}
        for n in self.quantize:
            keys |= {codes_key(n), scale_key(n)}
            if self.stages is not None and n not in rerank:
                keys.discard(n)
        return tuple(sorted(keys))

    def _static_operator(self, cfg) -> dict:
        pm, row_valid = POPS.pooling_matrix_static(cfg)
        return {"mat": torch.from_numpy(pm).to(self.device),
                "row_valid": torch.from_numpy(row_valid).to(self.device)}

    # ------------------------------------------------------------------
    # device bodies
    # ------------------------------------------------------------------

    def _pool(self, name: str, cfg, vis, vis_mask, h_eff) -> tuple:
        """Model-aware pooling: the fused one-matrix operator when enabled
        and the geometry is static, the functional reference otherwise."""
        if not self.use_kernel or h_eff is not None:
            return pool_pages_batch(cfg, vis, vis_mask, h_eff)
        op = self._mats[name]
        pooled = POPS.pool_pages_fused(vis, vis_mask, op["mat"])
        return pooled, op["row_valid"].expand(pooled.shape[:-1])

    def _index_arrays(self, pages: torch.Tensor, token_types: torch.Tensor,
                      h_eff) -> dict:
        """pages [B, S, d] f32 + token_types [S]|[B, S] -> the named-vector
        dict for the batch, in the store dtype (quantised names also as
        int8 codes + f32 scales). Rows are independent, so bucket padding
        never perturbs real pages."""
        cfg = self.cfg
        N, S, _ = pages.shape
        if token_types.ndim == 1:
            token_types = token_types[None].expand(N, S)
        emb, keep = HG.apply_hygiene(pages, token_types)

        # physically separate visual tokens (static layout: specials lead,
        # validated host-side by hygiene.require_visual_tail)
        n_vis = cfg.n_patches
        vis = emb[:, S - n_vis:]
        vis_mask = keep[:, S - n_vis:]
        sd = self.store_dtype
        pooled, pooled_mask = self._pool("mean_pooling", cfg, vis, vis_mask,
                                         h_eff)
        vectors = {
            "initial": vis.to(sd).contiguous(),
            mask_key("initial"): vis_mask.contiguous(),
            "mean_pooling": pooled.to(sd),
            mask_key("mean_pooling"): pooled_mask.contiguous(),
            "global_pooling": global_pool(vis, vis_mask).to(sd),
        }
        if self.experimental_smooth:
            cfg2 = dataclasses.replace(cfg, smooth=self.experimental_smooth)
            exp, exp_mask = self._pool("experimental", cfg2, vis, vis_mask,
                                       h_eff)
            vectors["experimental"] = exp.to(sd)
            vectors[mask_key("experimental")] = exp_mask.contiguous()
        if self.quantize:
            vectors = quantize_vectors(vectors, self.quantize, self.stages)
        return vectors

    def _write_body(self, seg, pages, token_types, start: int,
                    n_real: int, tenant: int, words: np.ndarray) -> None:
        """Index the bucket-padded batch and write it into the segment's
        reserved tail: one full-bucket slice copy per array, then the
        padding rows zeroed (pooled masks and int8 scales are nonzero for
        zero pages), so never-claimed slots keep their allocation state
        and the arrays equal ``index`` + ``add_pages``'s. ``doc_valid``,
        ``doc_tenant`` and ``doc_filter`` are stamped on the claimed rows
        only. ``reserve`` left a full bucket of tail room, so the block
        never reaches a live row. The batch is indexed once, on the
        pipeline's device; on a mesh its rows are then split onto the
        slabs they land in (``Segment.write``)."""
        batch = self._index_arrays(pages, token_types, None)
        bucket = pages.shape[0]
        for k, v in batch.items():
            seg.write(k, start, v)
            if n_real < bucket:
                seg.fill(k, start + n_real, start + bucket, 0)
        end = start + n_real
        seg.fill(VALIDITY_KEY, start, end, True)
        seg.fill(TENANT_KEY, start, end, int(tenant))
        seg.fill(FILTER_KEY, start, end,
                 words_tensor(words, pages.device)[None, :])

    # ------------------------------------------------------------------
    # host entry points
    # ------------------------------------------------------------------

    def _admit(self, pages, token_types) -> tuple:
        pages = torch.as_tensor(pages).to(device=self.device,
                                          dtype=torch.float32)
        if pages.ndim != 3 or pages.shape[1] != self.cfg.seq_len:
            raise ValueError(
                f"pages must be [N, S={self.cfg.seq_len}, d] raw encoder "
                f"output, got shape {tuple(pages.shape)}")
        HG.require_visual_tail(token_types, self.cfg.n_patches)
        return pages, torch.as_tensor(token_types).to(self.device)

    def _padded(self, pages, token_types) -> tuple:
        """Admit a raw batch and pad it to its bucket: (pages [bucket, S,
        d], token types, n real pages)."""
        pages, tt = self._admit(pages, token_types)
        n = int(pages.shape[0])
        bucket = batch_bucket(n, self.min_bucket)
        if tt.ndim == 2:
            tt = _pad_rows(tt, bucket, fill=HG.PAD)
        return _pad_rows(pages, bucket), tt, n

    def index(self, pages, token_types, h_eff=None) -> VectorStore:
        """Index a raw batch (numpy or torch, any device) into a standalone
        ``VectorStore`` on the pipeline's device. ``h_eff`` [N] int is a
        per-page effective grid height (dynamic geometry), pooled by the
        reference path."""
        pages_p, tt, n = self._padded(pages, token_types)
        h = None
        if h_eff is not None:
            h = _pad_rows(torch.as_tensor(h_eff).to(self.device),
                          pages_p.shape[0], fill=self.cfg.grid_h)
        out = self._index_arrays(pages_p, tt, h)
        return VectorStore({k: v[:n] for k, v in out.items()}, n,
                           str(self.store_dtype).removeprefix("torch."))

    def ingest(self, store, pages, token_types, tenant: int = 0,
               tags=()) -> np.ndarray:
        """Index a raw batch and write it straight into ``store``'s
        segment headroom (a ``SegmentedStore`` holding this pipeline's key
        set), every page stamped with ``tenant`` and the packed ``tags``
        bitset as ``SegmentedStore.add_pages`` stamps them. The slots land
        through ``store.commit``, so with routing on they join their
        clusters there. Returns the assigned stable page ids."""
        if store.segments:
            have = {k for k in store.segments[0].slabs[0]
                    if not is_store_companion(k)}
            if have != set(self.produced_keys):
                raise ValueError(
                    f"pipeline produces {sorted(self.produced_keys)} but "
                    f"the store's segments hold {sorted(have)} — build the "
                    "seed store with the same quantize/stages options")
        words = pack_tags(tags, store.filter_words)
        pages_p, tt, n = self._padded(pages, token_types)
        # a full bucket of headroom: the write is a bucket-wide block
        seg_i, start = store.reserve(n, min_free=pages_p.shape[0])
        self._write_body(store.segments[seg_i], pages_p, tt, start, n,
                         tenant, words)
        return store.commit(seg_i, n)
