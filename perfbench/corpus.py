"""Corpus and query generators: a torch rewrite of the synthetic ViDoRe
analogue (``data/synthetic.py``) that any device can run and any page of
which can be made again on its own.

A page is ``n_special`` leading special tokens and a patch grid of unit
noise tokens with one topic planted in a contiguous band of grid rows
(tiles, for the tile geometry), renormalised token by token. Pages of the
dynamic geometry have a per-page effective height ``h_eff``: the rows past
it are zero vectors (padding), which token hygiene masks. A query is
``L`` valid tokens around one topic (``topic + query_noise * unit
noise``, renormalised), zero-padded to ``q_slots`` with a mask.

Every value is a pure function of (seed, stream, item, element), made by
a 32-bit counter hash (``mix32``) in int64 tensor arithmetic, so a chunk
of pages made at set-up and the same pages made one by one for the
reference agree bit for bit, on any device. Vector norms are summed as a
fixed pairwise tree of elementwise additions, whose order does not depend
on the tensor's shape. What the seed decides as a whole (each page's
topic, each page's ``h_eff``, each query's length) is a permutation of a
FIXED multiset, so every seed asks for the same amount of work in another
order.

Imports nothing of ``repro_torch``: the plain reference makes the corpus
again through this module.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

M32 = 0xFFFFFFFF
_C1, _C2 = 0x7FEB352D, 0x2C1B3C6D      # odd, < 2**31: products fit int64
_GOLDEN = 0x9E3779B9

# hash streams
S_NOISE, S_BAND, S_SPECIAL, S_TOPIC, S_QUERY, S_ANCHOR, S_PERM = range(1, 8)

SPECIAL, VISUAL = 1, 0          # token types (``core.hygiene``'s codes)


def mix32(x):
    """A bijective 32-bit integer hash (xorshift-multiply) of a Python int
    or an int64 tensor holding values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * _C1) & M32
    x = x ^ (x >> 15)
    x = (x * _C2) & M32
    return x ^ (x >> 16)


def seed_key(seed: int) -> int:
    """A 32-bit key of any whole-number seed (more than 32 bits too)."""
    s = int(seed) % (1 << 64)
    return mix32((s & M32) ^ mix32(((s >> 32) ^ _GOLDEN) & M32))


def stream_key(seed: int, stream: int) -> int:
    return mix32(seed_key(seed) ^ mix32((stream * _GOLDEN) & M32))


def item_keys(seed: int, stream: int, items: torch.Tensor) -> torch.Tensor:
    """Per-item 32-bit keys: items [P] int64 -> [P] int64."""
    return mix32(mix32(items.long() & M32) ^ stream_key(seed, stream))


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """[P] item keys -> [P, n] float32 in (-1, 1), element j of item p a
    function of (key p, j) alone."""
    j = mix32(torch.arange(n, dtype=torch.int64, device=keys.device))
    h = mix32(j[None, :] ^ keys[:, None])
    return h.to(torch.float32).add_(0.5).mul_(2.0 ** -31).sub_(1.0)


def tree_norm(x: torch.Tensor) -> torch.Tensor:
    """L2 norm over the last axis (a power of two) as a fixed pairwise tree
    of elementwise additions: [..., d] -> [..., 1]."""
    s = x * x
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = s[..., :h] + s[..., h:]
    return s.sqrt()


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / tree_norm(x).clamp_min(1e-9)


def permutation(seed: int, stream: int, n: int) -> torch.Tensor:
    """A permutation of range(n) decided by (seed, stream): the order of
    the items' hash keys (ties, which a bijective hash of distinct items
    cannot give, would break by index)."""
    keys = item_keys(seed, stream, torch.arange(n, dtype=torch.int64))
    return torch.sort(keys, stable=True).indices


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Geometry:
    """A page's layout, from a configuration file's ``retriever`` group."""
    kind: str              # tiles | dynamic
    rows: int              # grid rows (tiles for the tile geometry)
    row_w: int             # tokens a row
    n_special: int
    dim: int
    n_pooled: int          # stored pooled vectors a page
    max_rows: int          # adaptive pooling target (dynamic)
    smooth: str

    @property
    def n_vis(self) -> int:
        return self.rows * self.row_w

    @property
    def seq(self) -> int:
        return self.n_vis + self.n_special

    @classmethod
    def of(cls, retriever: dict) -> "Geometry":
        kind = retriever["geometry"]
        if kind == "tiles":
            rows, row_w = retriever["n_tiles"], retriever["tile_patches"]
            n_pooled = rows
        elif kind == "dynamic":
            rows, row_w = retriever["grid_h"], retriever["grid_w"]
            n_pooled = retriever["max_rows"]
        else:
            raise ValueError(f"no generator for the {kind!r} geometry")
        return cls(kind, rows, row_w, retriever["n_special"],
                   retriever.get("out_dim", 128), n_pooled,
                   retriever.get("max_rows", 32),
                   retriever.get("smooth", "none"))


@dataclass(frozen=True)
class CorpusSpec:
    geo: Geometry
    pages: int
    topics: int
    noise: float
    signal: float
    jitter: float
    band_rows: int
    query_noise: float
    h_eff: tuple | None        # (lo, hi) valid rows a page, dynamic only

    def __post_init__(self):
        lo = self.geo.rows if self.h_eff is None else self.h_eff[0]
        if not 1 <= self.band_rows <= lo:
            raise ValueError(f"band of {self.band_rows} rows does not fit "
                             f"pages of {lo} valid rows")
        if self.pages % self.topics:
            raise ValueError("pages must divide into topics evenly")

    @classmethod
    def of(cls, config: dict) -> "CorpusSpec":
        g = config["generator"]
        h = g.get("h_eff")
        return cls(Geometry.of(config["retriever"]),
                   int(config["corpus_pages"]), int(g["topics"]),
                   float(g["noise"]), float(g["signal"]),
                   float(g["jitter"]), int(g["band_rows"]),
                   float(g["query_noise"]),
                   None if h is None else (int(h[0]), int(h[1])))


def token_types(geo: Geometry, device=None) -> torch.Tensor:
    """[S] int32: the leading specials, then the visual grid."""
    return torch.cat([
        torch.full((geo.n_special,), SPECIAL, dtype=torch.int32),
        torch.full((geo.n_vis,), VISUAL, dtype=torch.int32)]).to(device)


# ---------------------------------------------------------------------------
# per-corpus tables (a permutation of a fixed multiset each)
# ---------------------------------------------------------------------------

@dataclass
class Tables:
    topics: torch.Tensor       # [T, d] f32 unit topic vectors
    topic_of: torch.Tensor     # [N] int64: page -> topic (N / T pages each)
    h_eff: torch.Tensor        # [N] int64 valid rows a page

    def to(self, device) -> "Tables":
        return Tables(self.topics.to(device), self.topic_of.to(device),
                      self.h_eff.to(device))


def tables(spec: CorpusSpec, seed: int, device=None) -> Tables:
    n, t, geo = spec.pages, spec.topics, spec.geo
    topics = unit(uniform(item_keys(seed, S_TOPIC, torch.arange(t)),
                          geo.dim))
    perm = permutation(seed, S_PERM, n)
    topic_of = perm % t
    if spec.h_eff is None:
        h = torch.full((n,), geo.rows, dtype=torch.int64)
    else:
        lo, hi = spec.h_eff
        # the multiset {i % span} of a permutation of range(n) is fixed
        h = lo + permutation(seed, S_PERM + 100, n) % (hi - lo + 1)
    return Tables(topics, topic_of, h).to(device)


# ---------------------------------------------------------------------------
# pages
# ---------------------------------------------------------------------------

def pages(spec: CorpusSpec, seed: int, tab: Tables,
          ids: torch.Tensor) -> torch.Tensor:
    """Raw pages ``ids`` [P] int64 (on the tables' device) -> [P, S, d]
    f32 encoder output: specials first, then the grid."""
    geo, d = spec.geo, spec.geo.dim
    P = ids.shape[0]
    dev = ids.device
    out = torch.empty((P, geo.seq, d), dtype=torch.float32, device=dev)
    spec_tok = uniform(item_keys(seed, S_SPECIAL, ids), geo.n_special * d)
    out[:, :geo.n_special] = unit(spec_tok.view(P, geo.n_special, d))
    del spec_tok
    noise = uniform(item_keys(seed, S_NOISE, ids), geo.n_vis * d)
    noise = unit(noise.view(P, geo.n_vis, d))
    # the band: rows [r0, r0 + band) of the valid rows [0, h)
    h = tab.h_eff[ids]
    band = spec.band_rows
    bk = item_keys(seed, S_BAND, ids)
    r0 = bk % (h - band + 1)                                  # [P]
    row = torch.arange(geo.rows, device=dev)[None, :]         # [1, R]
    in_band = (row >= r0[:, None]) & (row < r0[:, None] + band)
    in_band = in_band.repeat_interleave(geo.row_w, dim=1)     # [P, n_vis]
    # jitter: the noise token's coordinates rolled by one, another unit
    # vector nearly orthogonal to it
    jit = torch.roll(noise, 1, dims=-1)
    sig = tab.topics[tab.topic_of[ids]][:, None, :] + spec.jitter * jit
    page = noise.mul_(spec.noise).add_(
        sig.mul_(in_band[..., None].to(torch.float32) * spec.signal))
    del sig, jit
    page = unit(page)
    valid = (row < h[:, None]).repeat_interleave(geo.row_w, dim=1)
    page.mul_(valid[..., None].to(torch.float32))     # padding rows: zero
    out[:, geo.n_special:] = page
    return out


def page_chunks(spec: CorpusSpec, chunk: int):
    """(lo, hi) page ranges of the index chunks."""
    for lo in range(0, spec.pages, chunk):
        yield lo, min(lo + chunk, spec.pages)


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------

@dataclass
class Queries:
    q: torch.Tensor            # [n, q_slots, d] f32
    mask: torch.Tensor         # [n, q_slots] bool
    topic: torch.Tensor        # [n] int64
    anchor: torch.Tensor       # [n] int64: the page graded 2

    @property
    def lengths(self) -> torch.Tensor:
        return self.mask.sum(dim=1)


def fixed_lengths(n: int, lo: int, hi: int) -> torch.Tensor:
    """n lengths spread evenly over [lo, hi], in increasing order."""
    span = hi - lo + 1
    return lo + (torch.arange(n, dtype=torch.int64) * span) // n


def queries(spec: CorpusSpec, seed: int, tab: Tables, n: int, q_slots: int,
            q_valid: tuple) -> Queries:
    """``n`` queries: each anchored on a page drawn from the seed, around
    that page's topic; lengths a permutation of ``fixed_lengths``."""
    dev = tab.topic_of.device
    d = spec.geo.dim
    idx = torch.arange(n, dtype=torch.int64)
    anchor = (item_keys(seed, S_ANCHOR, idx) % spec.pages).to(dev)
    topic = tab.topic_of[anchor]
    lens = fixed_lengths(n, *q_valid)[permutation(seed, S_QUERY + 100, n)]
    noise = uniform(item_keys(seed, S_QUERY, idx.to(dev)), q_slots * d)
    noise = unit(noise.view(n, q_slots, d))
    q = unit(tab.topics[topic][:, None, :] + spec.query_noise * noise)
    mask = torch.arange(q_slots)[None, :] < lens[:, None]
    mask = mask.to(dev)
    return Queries(q * mask[..., None].to(torch.float32), mask, topic,
                   anchor)


# ---------------------------------------------------------------------------
# relevance (ranking quality is printed, never compared)
# ---------------------------------------------------------------------------

def ndcg_recall_at(ranked: list, topic: list, anchor: list,
                   topic_of, k: int = 10) -> tuple:
    """Mean NDCG@k and Recall@k of ranked page-id lists against the planted
    relevance: the anchor page graded 2, its topic's other pages 1."""
    import numpy as np
    topic_of = np.asarray(topic_of)
    ndcg, rec = [], []
    for ids, t, a in zip(ranked, topic, anchor):
        rel = set(np.flatnonzero(topic_of == t).tolist())
        gains = [(2 if int(i) == a else 1 if int(i) in rel else 0)
                 for i in ids[:k]]
        dcg = sum((2 ** g - 1) / math.log2(r + 2)
                  for r, g in enumerate(gains))
        ideal = sorted([2] + [1] * (len(rel) - 1), reverse=True)[:k]
        idcg = sum((2 ** g - 1) / math.log2(r + 2)
                   for r, g in enumerate(ideal))
        ndcg.append(dcg / idcg)
        rec.append(len(rel & {int(i) for i in ids[:k]}) / len(rel))
    return float(np.mean(ndcg)), float(np.mean(rec))
