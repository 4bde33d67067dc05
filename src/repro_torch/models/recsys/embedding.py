"""Sparse-embedding substrate of the recsys family (the port of
``repro.models.recsys.embedding``).

Fields with a vocabulary of at least ``row_shard_threshold`` rows are
concatenated into ONE table (``big``), the others into a second one
(``small``), as ``repro`` lays them out. ``big`` is row-sharded over the
tp axis (``embedding_specs``; ``init_embedding(n_shards=)`` pads its rows
to a multiple of the shards, as ``layout.padded_rows`` does), ``small`` is
replicated. ``lookup_shardmap`` is the explicit per-shard lookup into the
row-sharded table: a masked local take on each tp position's rows, then a
``psum`` over tp (``distributed.shard_map``).

Rows are taken with ``take_rows``, which gives ``jnp.take``'s results:
negative ids wrap once, ids past either end give a row of NaN.

Partitioned (``lookup`` with a ``shard`` policy inside a ``shard_map``
body, the cells' placed slabs): ``big`` is this position's row slab over
tp and ``take_split_rows`` takes from it what ``repro``'s XLA-partitioned
``jnp.take`` gives: each position takes the ids inside its slab (rows
outside it zeroed), and the partial rows are summed over tp. Where every
tp position holds the same ids (a batch split over dp, or replicated) the
sum is a ``psum``; where the ids differ over tp (candidates split over
``flat``) they are first gathered over tp and the sums scattered back
(``psum_scatter``). Every other term of a sum is 0, so the rows are the
unsharded take's bit for bit, wrap and NaN included.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import shard_map as SM
from repro_torch.models.layers import _normal, partitioned


@dataclass(frozen=True)
class EmbeddingLayout:
    vocab_sizes: tuple
    dim: int
    row_shard_threshold: int = 100_000

    @property
    def big_fields(self) -> tuple:
        return tuple(i for i, v in enumerate(self.vocab_sizes)
                     if v >= self.row_shard_threshold)

    @property
    def small_fields(self) -> tuple:
        return tuple(i for i, v in enumerate(self.vocab_sizes)
                     if v < self.row_shard_threshold)

    def offsets(self, fields) -> tuple:
        offs, cum = [], 0
        for i in fields:
            offs.append(cum)
            cum += self.vocab_sizes[i]
        return np.asarray(offs, np.int64), cum

    def padded_rows(self, total: int, n_shards: int) -> int:
        return -(-total // max(n_shards, 1)) * max(n_shards, 1)


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: ids in [-n, 0) wrap to the end,
    ids outside [-n, n) give a row of NaN (and no gradient). The rows come
    from ``F.embedding``, whose backward sums duplicate ids in a sorted
    order (deterministic on the card) into a dense gradient."""
    n = table.shape[0]
    ids = torch.where(ids < 0, ids + n, ids)
    bad = (ids < 0) | (ids >= n)
    rows = F.embedding(ids.masked_fill(bad, 0), table)
    # in place: the embedding's backward reads the ids, not its output
    return rows.masked_fill_(bad[..., None], float("nan"))


class Embedding(nn.Module):
    """``repro``'s embedding params ``{"big", "small"}``: ``big`` holds the
    fields of ``layout.big_fields`` end to end, ``small`` the others; a
    table exists only when it has a field. The fields and offsets of each
    table are made once per device (``tables``), so a lookup copies
    nothing from the host after the first; a module bound to slabs
    (``placement.local_module``) shares them."""

    def __init__(self, layout: EmbeddingLayout,
                 generator: torch.Generator | None = None, device="cpu",
                 n_shards: int = 1):
        super().__init__()
        self.layout = layout
        self._index = {}           # device -> [(part, fields, offsets)]
        for part in self.parts():
            _, total = layout.offsets(getattr(layout, f"{part}_fields"))
            if part == "big":
                total = layout.padded_rows(max(total, 1), n_shards)
            setattr(self, part, nn.Parameter(_normal(
                generator, (total, layout.dim), layout.dim ** -0.5, device)))
        self.to(generator.device if generator is not None else device)

    def parts(self) -> list:
        """The tables that exist, of ``("big", "small")``."""
        return [p for p in ("big", "small")
                if getattr(self.layout, f"{p}_fields")]

    def tables(self) -> list:
        """[(part, table, fields, offsets)] of the tables that exist; the
        fields and offsets int64 on the tables' device."""
        first = getattr(self, self.parts()[0])
        index = self._index.get(first.device)
        if index is None:
            index = []
            for part in self.parts():
                fields = getattr(self.layout, f"{part}_fields")
                offs, _ = self.layout.offsets(fields)
                index.append((part, torch.tensor(fields, dtype=torch.int64,
                                                 device=first.device),
                              torch.from_numpy(offs).to(first.device)))
            self._index[first.device] = index
        return [(part, getattr(self, part), f, o) for part, f, o in index]


def init_embedding(layout: EmbeddingLayout,
                   generator: torch.Generator | None = None,
                   device="cpu", n_shards: int = 1) -> Embedding:
    """``repro``'s ``init_embedding``: each table normal x ``dim ** -0.5``,
    drawn from ``generator``, not from a JAX key; ``big``'s rows padded
    to a multiple of ``n_shards``."""
    return Embedding(layout, generator, device, n_shards)


def embedding_specs(layout: EmbeddingLayout) -> dict:
    """Logical axes of the tables: ``big`` row-sharded over tp, ``small``
    replicated."""
    out = {}
    if layout.big_fields:
        out["big"] = ("tp", None)
    if layout.small_fields:
        out["small"] = (None, None)
    return out


def _slab_rows(slab: torch.Tensor, ids: torch.Tensor, tp) -> torch.Tensor:
    """This tp position's share of the rows of ``ids`` (ids into the whole
    table, whose rows are split over ``tp``): the rows inside its
    ``slab``, zero rows elsewhere."""
    r = slab.shape[0]
    loc = ids - SM.axis_index(tp) * r
    ok = (loc >= 0) & (loc < r)
    got = F.embedding(loc.clamp(0, r - 1), slab)
    return torch.where(ok[..., None], got, torch.zeros_like(got))


def take_split_rows(slab: torch.Tensor, ids: torch.Tensor, shard,
                    rows: tuple = ()) -> torch.Tensor:
    """``take_rows(table, ids)`` of a table whose rows are split over the
    policy's tp axes, inside a body: ``slab`` is this position's block of
    the rows, ``ids`` this position's block of ids, split along their
    first dimension over the mesh axes ``rows`` (() where every position
    holds the same ids). The ids of a tp group are gathered first where
    ``rows`` names a tp axis, and the summed rows scattered back."""
    tp = shard.axes("tp")
    if not tp:
        return take_rows(slab, ids)
    spread = bool(set(rows) & set(tp))
    r = slab.shape[0]
    n = r * SM.axis_size(tp)
    ids = torch.where(ids < 0, ids + n, ids)
    bad = (ids < 0) | (ids >= n)
    if spread:
        ids = SM.all_gather(ids, tp, axis=0, tiled=True)
    got = _slab_rows(slab, ids, tp)
    got = SM.psum_scatter(got, tp, 0) if spread else SM.psum(got, tp)
    return got.masked_fill(bad[..., None], float("nan"))


def lookup(emb: Embedding, idx: torch.Tensor, shard=None) -> torch.Tensor:
    """idx [B, n_fields] per-field local ids -> [B, n_fields, dim]: each
    field's rows from its table at its offset (``out.at[:, fields].set``
    as an index assignment into zeros; gradients reach both tables).
    Inside a body (``shard`` on a mesh) ``big`` is this position's row
    slab (``take_split_rows``, the ids' rows split over the policy's dp
    axes: the batch's, or the candidates' ``flat`` ones) and ``small`` is
    taken whole; the rows keep the ids' layout, ``repro``'s
    ``constrain(out, "dp", None, None)``."""
    B, nf = idx.shape
    tables = emb.tables()
    out = tables[0][1].new_zeros((B, nf, emb.layout.dim))
    split = partitioned(shard)
    for part, table, fields, offs in tables:
        gid = idx[:, fields] + offs
        if split and part == "big":
            out[:, fields] = take_split_rows(table, gid, shard,
                                             shard.axes("dp"))
        else:
            out[:, fields] = take_rows(table, gid)
    if shard is not None:
        out = shard.constrain(out, "dp", None, None, have=("dp", None, None))
    return out


def lookup_shardmap(emb: Embedding, idx: torch.Tensor, shard) -> torch.Tensor:
    """``lookup`` with the big table row-sharded over the policy's tp axis:
    inside ``shard_map`` each tp position takes the rows it holds
    (``clip``ped local ids, rows outside its slab zeroed) and the partial
    rows are ``psum``'d over tp; ``small`` is taken whole. An id outside
    every slab gives a zero row (``repro``'s masked take)."""
    layout = emb.layout
    B, nf = idx.shape
    tables = emb.tables()
    out = tables[0][1].new_zeros((B, nf, layout.dim))
    tp_axes = shard.rules["tp"]
    tp_ax = tp_axes[0] if isinstance(tp_axes, tuple) else tp_axes

    def local(table_loc, gids):
        return SM.psum(_slab_rows(table_loc, gids, tp_ax), tp_ax)

    for part, table, fields, offs in tables:
        gid = idx[:, fields] + offs
        if part == "big":
            out[:, fields] = SM.shard_map(
                local, shard.mesh, in_specs=(SM.P(tp_ax, None), SM.P()),
                out_specs=SM.P())(table, gid)
        else:
            out[:, fields] = take_rows(table, gid)
    return out


def bag_lookup(table: torch.Tensor, indices: torch.Tensor,
               valid: torch.Tensor | None = None,
               mode: str = "mean") -> torch.Tensor:
    """Multi-hot embedding bag as ``repro`` writes it: ids clipped into
    the table, weights from ``valid`` (default ``indices >= 0``), divided
    by the bag's count in ``mean`` mode, summed otherwise."""
    if valid is None:
        valid = indices >= 0
    w = valid.to(torch.float32)
    if mode == "mean":
        w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1.0)
    rows = take_rows(table, indices.clamp(0, table.shape[0] - 1))
    return torch.einsum("...l,...ld->...d", w, rows)
