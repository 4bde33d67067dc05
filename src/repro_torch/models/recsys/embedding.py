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
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import shard_map as SM
from repro_torch.models.layers import _normal


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
    table are kept as device buffers, so a lookup copies nothing from the
    host."""

    def __init__(self, layout: EmbeddingLayout,
                 generator: torch.Generator | None = None, device="cpu",
                 n_shards: int = 1):
        super().__init__()
        self.layout = layout
        for part, fields in (("big", layout.big_fields),
                             ("small", layout.small_fields)):
            if not fields:
                continue
            offs, total = layout.offsets(fields)
            if part == "big":
                total = layout.padded_rows(max(total, 1), n_shards)
            setattr(self, part, nn.Parameter(_normal(
                generator, (total, layout.dim), layout.dim ** -0.5, device)))
            self.register_buffer(f"{part}_fields", torch.tensor(
                fields, dtype=torch.int64), persistent=False)
            self.register_buffer(f"{part}_offsets", torch.from_numpy(offs),
                                 persistent=False)
        self.to(generator.device if generator is not None else device)

    def tables(self) -> list:
        """[(table, fields, offsets)] of the tables that exist."""
        return [(getattr(self, p), getattr(self, f"{p}_fields"),
                 getattr(self, f"{p}_offsets"))
                for p in ("big", "small") if hasattr(self, f"{p}_fields")]


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


def lookup(emb: Embedding, idx: torch.Tensor) -> torch.Tensor:
    """idx [B, n_fields] per-field local ids -> [B, n_fields, dim]: each
    field's rows from its table at its offset (``out.at[:, fields].set``
    as an index assignment into zeros; gradients reach both tables)."""
    B, nf = idx.shape
    tables = emb.tables()
    out = tables[0][0].new_zeros((B, nf, emb.layout.dim))
    for table, fields, offs in tables:
        out[:, fields] = take_rows(table, idx[:, fields] + offs)
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
    out = tables[0][0].new_zeros((B, nf, layout.dim))
    tp_axes = shard.rules["tp"]
    tp_ax = tp_axes[0] if isinstance(tp_axes, tuple) else tp_axes

    def local(table_loc, gids):
        rows = table_loc.shape[0]
        loc = gids - SM.axis_index(tp_ax) * rows
        ok = (loc >= 0) & (loc < rows)
        got = F.embedding(loc.clamp(0, rows - 1), table_loc)
        got = torch.where(ok[..., None], got, 0.0)
        return SM.psum(got, tp_ax)

    for part, (table, fields, offs) in zip(
            [p for p in ("big", "small") if hasattr(emb, f"{p}_fields")],
            tables):
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
