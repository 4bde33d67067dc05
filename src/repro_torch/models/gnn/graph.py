"""Message-passing substrate: segment ops and two edge-execution plans (the
port of ``repro.models.gnn.graph``).

``repro`` builds message passing on ``jax.ops.segment_sum``/``segment_max``
over edge-index arrays, outside any Pallas kernel; here they are
``index_add``, ``scatter_reduce("amax")`` and ``index_select``. On the
card ``index_add`` adds with atomics, so sums come out in a varying order
(allclose to the CPU, not bit for bit); on the CPU they add in edge order.

Three plans expose the same interface to the model:

- ``LocalEdges``: a plain COO edge list (small graphs, sampled
  minibatches, a batch of molecules as one disjoint union).
- ``FlatEdges``: one position's block of a COO edge list split over the
  ``flat`` mesh axes inside a ``shard_map`` body, every node on every
  position (``repro``'s XLA-partitioned ``LocalEdges`` of the small
  full-graph cell). Its two reductions over a node's edges are global:
  ``aggregate`` ``psum``s the local segment sums, ``softmax`` takes the
  global segment max (``pmax``, detached: the shift's gradient cancels)
  and ``psum``s the local sums of the exponentials.
- ``ShardedEdges``: the vertex-cut layout of ``partition_edges``, edges
  bucketed by (src shard, dst shard), one shard's buckets inside a
  ``shard_map`` body (``distributed.shard_map``): src gathers are local,
  messages cross between positions once per layer through ``exchange``
  (an ``all_to_all`` over the plan's ``axis_names``), dst aggregation is
  a local segment sum. Positions are replicated, so both sides rebuild
  the edge direction. At one shard with no axis names ``exchange`` is the
  identity (the single-device cells).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.distributed import shard_map as SM

NEG = -1e30


def _bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[E] -> [E, 1, ...] against x [E, ...]."""
    return v.reshape(v.shape + (1,) * (x.ndim - 1))


def segment_sum(x: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows of x [E, ...] summed by seg_ids [E]
    into [num_segments, ...] (empty segments 0)."""
    out = x.new_zeros((num_segments,) + tuple(x.shape[1:]))
    return out.index_add(0, seg_ids, x)


def segment_max(x: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max``: empty segments -inf; the gradient splits
    evenly between tied maxima, as JAX's scatter-max derivative splits
    it."""
    base = x.new_full((num_segments,) + tuple(x.shape[1:]), -float("inf"))
    idx = _bcast(seg_ids, x).expand(x.shape).long()
    return base.scatter_reduce(0, idx, x, "amax", include_self=False)


def segment_softmax(scores: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Numerically-stable softmax over edges grouped by destination.

    scores [E, ...]; seg_ids [E]; returns weights [E, ...] summing to 1 per
    segment (masked edges get 0). The segment max stays in the autograd
    graph, as in ``repro``.
    """
    if mask is not None:
        scores = torch.where(_bcast(mask, scores), scores,
                             torch.full_like(scores, NEG))
    smax = segment_max(scores, seg_ids, num_segments)
    smax = torch.nan_to_num(smax, neginf=0.0)
    ex = torch.exp(scores - smax.index_select(0, seg_ids))
    if mask is not None:
        ex = ex * _bcast(mask, scores).to(ex.dtype)
    den = segment_sum(ex, seg_ids, num_segments)
    return ex / torch.clamp(den.index_select(0, seg_ids), min=1e-9)


@dataclass
class LocalEdges:
    """COO edges on one device (or one sampled subgraph)."""
    src: torch.Tensor         # [E] int
    dst: torch.Tensor         # [E] int
    mask: torch.Tensor        # [E] bool
    n_nodes: int

    def gather_src(self, x):
        return x.index_select(0, self.src)

    def src_pos(self, pos):
        return pos.index_select(0, self.src)

    def dst_pos(self, pos):
        return pos.index_select(0, self.dst)

    # src-side -> dst-side handoff (identity locally)
    def exchange(self, msgs):
        return msgs

    # ---- dst side (recv edges == send edges locally)
    def recv_mask(self):
        return self.mask

    def recv_dst(self):
        return self.dst

    def gather_dst(self, x):
        return x.index_select(0, self.dst)

    def recv_dvec(self, pos):
        return self.dst_pos(pos) - self.src_pos(pos)

    def aggregate(self, msgs, valid=None):
        m = self.mask if valid is None else (self.mask & valid)
        return segment_sum(msgs * _bcast(m, msgs).to(msgs.dtype), self.dst,
                           self.n_nodes)

    def softmax(self, scores, valid=None):
        m = self.mask if valid is None else (self.mask & valid)
        return segment_softmax(scores, self.dst, self.n_nodes, m)


@dataclass
class FlatEdges(LocalEdges):
    """This position's block of the edges (``src``, ``dst``, ``mask`` over
    ``axis_names``, the ``flat`` axes), inside ``shard_map``; nodes are
    replicated. A node's edges may lie on any positions, all on one, or
    on none; masked (padding) edges add nothing, to the max as to the
    sums, as in ``LocalEdges``."""
    axis_names: tuple = ()

    def aggregate(self, msgs, valid=None):
        return SM.psum(super().aggregate(msgs, valid), self.axis_names)

    def softmax(self, scores, valid=None):
        m = self.mask if valid is None else (self.mask & valid)
        scores = torch.where(_bcast(m, scores), scores,
                             torch.full_like(scores, NEG))
        smax = SM.pmax(segment_max(scores, self.dst, self.n_nodes),
                       self.axis_names)
        smax = torch.nan_to_num(smax, neginf=0.0)
        ex = torch.exp(scores - smax.index_select(0, self.dst))
        ex = ex * _bcast(m, scores).to(ex.dtype)
        den = SM.psum(segment_sum(ex, self.dst, self.n_nodes),
                      self.axis_names)
        return ex / torch.clamp(den.index_select(0, self.dst), min=1e-9)


@dataclass
class ShardedEdges:
    """Vertex-cut bucketed edges of one shard (``partition_edges``' arrays
    at that shard's index), inside ``shard_map``.

    Send side (this shard owns the SRC nodes):
      esrc  [D, CAP] local src index, bucket row = dst shard
      edstg [D, CAP] global dst id (for the edge direction)
      emask [D, CAP]
    Recv side (this shard owns the DST nodes; the static transpose of the
    partition):
      rdst  [D, CAP] local dst index, bucket row = src shard
      rsrcg [D, CAP] global src id
      rmask [D, CAP]
    ``shard_offset`` is the global id of this shard's first node (the
    body's ``axis_index(axis_names) * n_local``); ``axis_names`` the mesh
    axes that form the flat shard axis (empty: one shard, no mesh).
    """
    esrc: torch.Tensor
    edstg: torch.Tensor
    emask: torch.Tensor
    rdst: torch.Tensor
    rsrcg: torch.Tensor
    rmask: torch.Tensor
    n_local: int              # nodes on this shard
    shard_offset: int         # global id of this shard's first node
    axis_names: tuple = ()    # mesh axes forming the flat shard axis

    def gather_src(self, x):
        return x[self.esrc]

    def src_pos(self, pos):
        return pos[self.shard_offset + self.esrc]

    def dst_pos(self, pos):
        return pos[self.edstg]

    def exchange(self, msgs):
        """[D, CAP, ...] bucket row=dst shard -> bucket row=src shard: the
        ``all_to_all`` over ``axis_names`` inside ``shard_map`` (the
        identity at one shard without axis names)."""
        d = self.esrc.shape[0]
        if self.axis_names:
            if not SM.in_shard_map():
                raise RuntimeError(
                    f"ShardedEdges.exchange across {d} shards is an "
                    f"all_to_all over {self.axis_names}: call it inside a "
                    "shard_map body (distributed.shard_map)")
            return SM.all_to_all(msgs, self.axis_names, 0, 0, tiled=True)
        if d != 1:
            raise RuntimeError(
                f"ShardedEdges.exchange across {d} shards needs the mesh "
                "axes of its all_to_all (axis_names) and a shard_map body "
                "(distributed.shard_map) to run in")
        return msgs

    def recv_mask(self):
        return self.rmask.reshape(-1)

    def recv_dst(self):
        return self.rdst.reshape(-1)

    def gather_dst(self, x):
        return x.index_select(0, self.recv_dst())

    def recv_dvec(self, pos):
        ps = pos.index_select(0, self.rsrcg.reshape(-1))
        pd = pos.index_select(0, self.shard_offset + self.recv_dst())
        return pd - ps

    def aggregate(self, msgs, valid=None):
        m = self.recv_mask()
        if valid is not None:
            m = m & valid
        return segment_sum(msgs * _bcast(m, msgs).to(msgs.dtype),
                           self.recv_dst(), self.n_local)

    def softmax(self, scores, valid=None):
        m = self.recv_mask()
        if valid is not None:
            m = m & valid
        return segment_softmax(scores, self.recv_dst(), self.n_local, m)


# ---------------------------------------------------------------------------
# host-side partitioner (numpy): COO -> bucketed vertex-cut layout
# ---------------------------------------------------------------------------

def partition_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                    n_shards: int, cap: int | None = None):
    """Split a COO edge list into the ShardedEdges bucket arrays.

    Nodes are block-partitioned: shard s owns [s*sz, (s+1)*sz). Returns a
    dict of [S, S, CAP] arrays (leading axis = owning shard) + metadata.
    Edges overflowing a bucket's capacity are dropped (counted in 'dropped');
    size CAP generously for real runs.
    """
    sz = -(-n_nodes // n_shards)
    if cap is None:
        per = len(src) / (n_shards * n_shards)
        cap = max(1, int(np.ceil(per * 2.0)))
    S = n_shards
    esrc = np.zeros((S, S, cap), np.int32)
    edstg = np.zeros((S, S, cap), np.int32)
    emask = np.zeros((S, S, cap), bool)
    rdst = np.zeros((S, S, cap), np.int32)
    rsrcg = np.zeros((S, S, cap), np.int32)
    rmask = np.zeros((S, S, cap), bool)
    fill = np.zeros((S, S), np.int64)
    dropped = 0
    ss, ds = src // sz, dst // sz
    for e in range(len(src)):
        a, b = int(ss[e]), int(ds[e])
        k = fill[a, b]
        if k >= cap:
            dropped += 1
            continue
        esrc[a, b, k] = src[e] - a * sz
        edstg[a, b, k] = dst[e]
        emask[a, b, k] = True
        rdst[b, a, k] = dst[e] - b * sz
        rsrcg[b, a, k] = src[e]
        rmask[b, a, k] = True
        fill[a, b] = k + 1
    return dict(esrc=esrc, edstg=edstg, emask=emask, rdst=rdst,
                rsrcg=rsrcg, rmask=rmask, shard_size=sz, cap=cap,
                dropped=dropped)
