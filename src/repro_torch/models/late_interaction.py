"""ColX-family late-interaction retriever encoders (the paper's models).

The port of ``repro.models.late_interaction``. The modality frontend is a
stub: pages arrive as precomputed patch embeddings ``[B, n_raw, D_PATCH]``.
After that: the processor geometry (ColSmol tiles, the ColPali grid, the
ColQwen dynamic grid behind a learned 2x2 ``patch_merger``), a
bidirectional transformer shared by pages and queries, the projection to
the late-interaction dim, L2 normalisation, token types for hygiene (§2.1),
and the ColBERT-style in-batch contrastive loss over MaxSim scores.

Layout: each transformer block is an ``nn.Module`` in an ``nn.ModuleList``
(``blocks.<i>.<name>``), so autograd gives every layer its own gradient
tensor. ``repro`` keeps the blocks stacked along a leading ``[n_layers]``
axis (``jax.vmap`` of the block init); ``params_from_jax`` unstacks them
and ``to_jax_leaves`` stacks them again, in ``jax.tree.leaves`` order
(dict keys sorted). Weights are ``[in, out]`` as in ``repro``, so a layer
is ``x @ w``. Parameters and activations are float32, products in full
float32 (``full_f32``: TF32 off), as ``repro`` computes them.

Numerics kept from ``repro``: GELU is the tanh approximation
(``jax.nn.gelu``'s default); the norm scales by ``1 + w`` with no bias,
the population variance and eps 1e-6 inside the rsqrt; masked attention
keys score -1e30 (a fully masked row softmaxes to uniform, finite);
vectors are divided by ``max(norm, 1e-9)``. On the training path each
block runs under ``torch.utils.checkpoint`` (``repro``'s
``jax.checkpoint`` inside its layer scan): its activations are recomputed
in the backward pass.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import hygiene
from repro_torch.core.maxsim import NEG, maxsim_batched
from repro_torch.distributed import shard_map as SM
from repro_torch.kernels.dispatch import full_f32, resolve_device

D_PATCH = 64          # frontend-stub patch embedding dim

BLOCK_KEYS = ("b1", "b2", "ln1", "ln2", "w1", "w2", "wk", "wo", "wq", "wv")
MERGER_KEYS = ("b", "ln", "w1", "w2")


def _dense(gen, shape, scale=None) -> torch.Tensor:
    """Normal draws times ``scale`` on ``gen``'s device (the default
    device without a generator)."""
    scale = scale if scale is not None else shape[0] ** -0.5
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=None if gen is None else gen.device) * scale


def _zeros(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32))


def _norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * (1.0 + w)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _l2(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1,
                                        keepdim=True).clamp_min(1e-9)


class Block(nn.Module):
    """One pre-norm bidirectional transformer block (``repro``'s scan
    body)."""

    def __init__(self, d: int, dff: int, n_heads: int, gen=None):
        super().__init__()
        self.n_heads = n_heads
        self.ln1 = _zeros(d)
        self.wq = nn.Parameter(_dense(gen, (d, d)))
        self.wk = nn.Parameter(_dense(gen, (d, d)))
        self.wv = nn.Parameter(_dense(gen, (d, d)))
        self.wo = nn.Parameter(_dense(gen, (d, d)))
        self.ln2 = _zeros(d)
        self.w1 = nn.Parameter(_dense(gen, (d, dff)))
        self.b1 = _zeros(dff)
        self.w2 = nn.Parameter(_dense(gen, (dff, d)))
        self.b2 = _zeros(d)

    def forward(self, x: torch.Tensor, amask: torch.Tensor) -> torch.Tensor:
        """x [B, S, d]; amask [B, 1, 1, S] bool (True = attend)."""
        B, S, d = x.shape
        H = self.n_heads
        h = _norm(x, self.ln1)
        q = (h @ self.wq).reshape(B, S, H, d // H)
        k = (h @ self.wk).reshape(B, S, H, d // H)
        v = (h @ self.wv).reshape(B, S, H, d // H)
        s = torch.einsum("bshk,bthk->bhst", q, k) / math.sqrt(d // H)
        s = s.masked_fill(~amask, NEG)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhst,bthk->bshk", a, v).reshape(B, S, d)
        x = x + o @ self.wo
        h = _norm(x, self.ln2)
        return x + _gelu(h @ self.w1 + self.b1) @ self.w2 + self.b2


class Merger(nn.Module):
    """ColQwen's learned 2x2 spatial merge: norm -> 2x2 concat -> MLP."""

    def __init__(self, d: int, gen=None):
        super().__init__()
        self.ln = _zeros(4 * D_PATCH)
        self.w1 = nn.Parameter(_dense(gen, (4 * D_PATCH, d)))
        self.w2 = nn.Parameter(_dense(gen, (d, D_PATCH)))
        self.b = _zeros(D_PATCH)


class ColXEncoder(nn.Module):
    """The ColX encoder (``repro``'s ``init_params`` tree as a module).

    ``generator`` seeds the random init: the weights are drawn on its
    device with ``repro``'s scales (``_dense``: ``shape[0] ** -0.5``;
    ``pos_embed`` 0.02; norms and biases zero) and moved to ``device``,
    so one CPU generator gives the same model on every device (a CUDA
    one draws on the card). ``device`` defaults to the card and raises
    without one."""

    def __init__(self, cfg, generator: torch.Generator | None = None,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        d, gen = cfg.d_model, generator
        self.blocks = nn.ModuleList(
            Block(d, cfg.d_ff, cfg.n_heads, gen)
            for _ in range(cfg.n_layers))
        self.patch_proj = nn.Parameter(_dense(gen, (D_PATCH, d)))
        self.text_embed = nn.Parameter(_dense(gen, (cfg.query_vocab, d)))
        self.special_embed = nn.Parameter(_dense(gen, (cfg.n_special, d)))
        self.pos_embed = nn.Parameter(_dense(
            gen, (cfg.seq_len + cfg.max_query_tokens, d), 0.02))
        self.ln_f = _zeros(d)
        self.out = nn.Parameter(_dense(gen, (d, cfg.out_dim)))
        self.merger = Merger(d, gen) if cfg.geometry == "dynamic" else None
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.out.device

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------

    def _backbone(self, x: torch.Tensor, mask: torch.Tensor):
        """Bidirectional transformer. x [B, S, d_model], mask [B, S]."""
        full_f32()
        amask = mask.bool()[:, None, None, :]
        for blk in self.blocks:
            if torch.is_grad_enabled():
                x = checkpoint(blk, x, amask, use_reentrant=False)
            else:
                x = blk(x, amask)
        return _norm(x, self.ln_f)

    def patch_merger(self, patches: torch.Tensor) -> torch.Tensor:
        """[B, H*W, D_PATCH] -> [B, H/2*W/2, D_PATCH] (2x2 blocks in
        ``repro``'s ``moveaxis(g, 3, 2)`` order)."""
        cfg, m = self.cfg, self.merger
        H, W = cfg.grid_h * 2, cfg.grid_w * 2
        B = patches.shape[0]
        g = patches.reshape(B, H // 2, 2, W // 2, 2, D_PATCH)
        g = g.movedim(3, 2).reshape(B, (H // 2) * (W // 2), 4 * D_PATCH)
        h = _gelu(_norm(g, m.ln) @ m.w1)
        return h @ m.w2 + m.b

    def encode_pages(self, patch_embeds: torch.Tensor) -> tuple:
        """patch_embeds [B, n_raw_patches, D_PATCH] -> (vecs [B, S, out],
        types [S]); S = n_patches + n_special, types mark the specials for
        hygiene (the paper indexes visual tokens only)."""
        cfg = self.cfg
        x = torch.as_tensor(patch_embeds).to(self.device, torch.float32)
        B = x.shape[0]
        if cfg.geometry == "dynamic":
            x = self.patch_merger(x)
        x = x @ self.patch_proj
        sp = self.special_embed[None].expand(B, cfg.n_special, cfg.d_model)
        x = torch.cat([sp, x], dim=1)
        x = x + self.pos_embed[: x.shape[1]]
        mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
        vecs = _l2(self._backbone(x, mask) @ self.out)
        types = torch.full((x.shape[1],), hygiene.VISUAL, dtype=torch.int32,
                           device=x.device)
        types[:cfg.n_special] = hygiene.SPECIAL
        return vecs, types

    def encode_queries(self, tokens: torch.Tensor,
                       qmask: torch.Tensor) -> torch.Tensor:
        """tokens [B, Q] int -> query vectors [B, Q, out_dim], zero where
        ``qmask`` is False. Queries take ``pos_embed`` rows [seq_len,
        seq_len + Q)."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens).to(self.device, torch.long)
        qmask = torch.as_tensor(qmask).to(self.device).bool()
        Q = tokens.shape[1]
        if Q > cfg.max_query_tokens:
            raise ValueError(f"{Q} query tokens > max_query_tokens "
                             f"{cfg.max_query_tokens}")
        x = F.embedding(tokens, self.text_embed)
        x = x + self.pos_embed[cfg.seq_len:cfg.seq_len + Q]
        vecs = _l2(self._backbone(x, qmask) @ self.out)
        return vecs * qmask[..., None].to(vecs.dtype)

    def contrastive_loss(self, batch: dict, shard=None) -> torch.Tensor:
        """In-batch ColBERT-style contrastive loss over MaxSim scores of
        the visual tokens (hygiene at training time too), scaled by
        1/sqrt(out_dim): mean(logsumexp - gold).

        Inside a ``shard_map`` body (``shard`` a policy on the mesh, the
        batch split over dp) the negatives stay global, as ``repro``'s
        [B, B] score matrix spans the global batch under GSPMD: the query
        vectors are gathered over dp, the local pages scored against all
        of them, the score columns gathered, and each position sums its
        own queries' rows; the loss is that sum ``psum``'d over dp over
        the global batch."""
        cfg = self.cfg
        pages, _ = self.encode_pages(batch["patches"])
        qmask = torch.as_tensor(batch["query_mask"]).to(self.device).bool()
        queries = self.encode_queries(batch["query_tokens"], qmask)
        S = pages.shape[1]
        vis = torch.arange(S, device=pages.device) >= cfg.n_special
        part = shard is not None and shard.mesh is not None and \
            SM.in_shard_map()
        dp = shard.axes("dp") if part else ()
        r0 = SM.axis_index(dp) * queries.shape[0] if dp else 0
        if dp:
            queries = SM.all_gather(queries, dp, axis=0, tiled=True)
            qmask = SM.all_gather(qmask, dp, axis=0, tiled=True)
        scores = maxsim_batched(queries, pages, q_mask=qmask,
                                doc_mask=vis[None].expand(pages.shape[0], S))
        scores = scores / math.sqrt(cfg.out_dim)
        if dp:
            n = pages.shape[0]
            scores = SM.all_gather(scores, dp, axis=1, tiled=True)
            scores = scores[r0:r0 + n]
        labels = r0 + torch.arange(scores.shape[0], device=scores.device)
        logz = torch.logsumexp(scores, dim=-1)
        gold = scores.gather(-1, labels[:, None])[:, 0]
        if not part:
            return (logz - gold).mean()
        total = (logz - gold).sum()
        B = shard.batch if shard.batch is not None else scores.shape[1]
        return (SM.psum(total, dp) if dp else total) / B

    # ------------------------------------------------------------------
    # ``repro``'s parameter tree
    # ------------------------------------------------------------------

    def jax_leaf_names(self) -> list:
        """Paths of ``repro``'s params tree in ``jax.tree.leaves`` order,
        '/'-joined (``blocks/wq`` is the [n_layers, d, d] stack)."""
        names = [f"blocks/{k}" for k in BLOCK_KEYS] + ["ln_f"]
        if self.merger is not None:
            names += [f"merger/{k}" for k in MERGER_KEYS]
        return names + ["out", "patch_proj", "pos_embed", "special_embed",
                        "text_embed"]

    def jax_stacked(self, name: str) -> bool:
        """True for a leaf stacked along a leading [n_layers] axis."""
        return name.startswith("blocks/")

    def jax_leaf_params(self, name: str) -> list:
        """The parameters behind one ``repro`` leaf: the per-layer tensors
        of a ``blocks/`` stack, else the one parameter."""
        head, _, key = name.partition("/")
        if head == "blocks":
            return [getattr(b, key) for b in self.blocks]
        if head == "merger":
            return [getattr(self.merger, key)]
        return [getattr(self, head)]

    @torch.no_grad()
    def to_jax_leaves(self) -> list:
        """The parameters as ``repro``'s leaves (blocks stacked
        [n_layers, ...]), in ``jax.tree.leaves`` order."""
        out = []
        for name in self.jax_leaf_names():
            ps = self.jax_leaf_params(name)
            out.append(torch.stack(ps) if self.jax_stacked(name)
                       else ps[0].detach().clone())
        return out

    @torch.no_grad()
    def load_jax_leaves(self, leaves) -> None:
        """Copy ``repro``-ordered leaves (numpy arrays or tensors, blocks
        stacked) into the parameters, bit for bit; shapes must match."""
        names = self.jax_leaf_names()
        if len(leaves) != len(names):
            raise ValueError(f"{len(leaves)} leaves, the model has "
                             f"{len(names)}")
        for name, x in zip(names, leaves):
            x = torch.as_tensor(x)
            ps = self.jax_leaf_params(name)
            parts = list(x) if self.jax_stacked(name) else [x]
            if len(parts) != len(ps):
                raise ValueError(f"{name}: {len(parts)} layers, the model "
                                 f"has {len(ps)}")
            for p, v in zip(ps, parts):
                if tuple(v.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {tuple(v.shape)}, the "
                                     f"model has {tuple(p.shape)}")
                p.copy_(v)


def _tree_get(tree: dict, name: str):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def init_params(cfg, generator: torch.Generator | None = None,
                device="cuda") -> ColXEncoder:
    """A randomly initialised encoder (``repro``'s ``init_params``; the
    draws come from ``generator``, not from a JAX key)."""
    return ColXEncoder(cfg, generator, device)


def params_from_jax(cfg, tree: dict, device="cuda") -> ColXEncoder:
    """An encoder holding ``repro``'s params ``tree`` (nested dicts of
    numpy arrays, ``blocks`` stacked [n_layers, ...]) bit for bit."""
    model = ColXEncoder(cfg, torch.Generator().manual_seed(0), device)
    model.load_jax_leaves([_tree_get(tree, n)
                           for n in model.jax_leaf_names()])
    return model

