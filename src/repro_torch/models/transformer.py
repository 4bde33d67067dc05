"""Decoder-only LM family: gemma2/gemma3/minicpm/granite-moe/olmoe (the port
of ``repro.models.transformer``).

``DecoderLM`` is an ``nn.Module`` holding one ``Block`` per layer in an
``nn.ModuleList`` (``layers.<i>``), so autograd gives every layer its own
gradient. ``repro`` scans over layers with parameters stacked per segment:
a segment is ``reps`` repetitions of the arch's attention pattern of P
slots, and runs rep 0 slot 0, rep 0 slot 1, ..., so layer
``offset + r*P + k`` is ``segments[s][k][r]`` in ``repro``'s tree.
``params_from_jax`` unstacks that tree and ``to_jax_leaves`` stacks it
again, in ``jax.tree.leaves`` order (dict keys sorted at every level).

Kept from ``repro``: each block runs under ``torch.utils.checkpoint`` when
``cfg.remat`` (``repro`` checkpoints its scan body), as does each chunk of
the cross-entropy; the embedding rows are taken, cast to ``cfg.dtype`` and
scaled by ``d_model ** 0.5`` rounded to that dtype; the logits are the
hidden states times the tied embedding, soft-capped, with the padded
vocabulary masked to -1e30; the loss takes its chunks' logits to float32
before the logsumexp. With ``dtype="float32"`` the products run in full
float32 (``full_f32``: TF32 off).

``param_specs``, ``param_shardings`` and ``_layer_specs`` are ``repro``'s
logical axes of its params tree (``segments/<s>/<slot>`` stacks
prepended with a rep axis). ``forward`` and ``loss_fn`` take a ``shard``
policy as ``repro``'s do. Called on a whole model, the MoE's
``ragged_ep`` runs its expert-parallel body over the policy's mesh.

Partitioned: ``place_params``/``params_from_jax(mesh=)`` place the
leaves by ``param_specs`` (a dict of ``Sharded`` by leaf name), and the
step functions run inside a ``shard_map`` body on a position's slabs
(``local_model`` binds them; ``shard`` carries the global batch,
``ShardingPolicy.body``). There: the embedding is split over vocab (a
masked local take, ``psum`` over tp); under ``cfg.sp_activations`` (batch
and sequence above 1) the residual stream lives split over the sequence
(Megatron-SP), each layer gathering its rows and reduce-scattering its
partial sums; ``lm_loss`` takes vocab-split logits chunk by chunk,
soft-capped, the padded vocabulary masked by global index, the max and
the sum of exponentials taken across tp, the gold logit from its owner,
and returns the global mean (its sum ``psum``'d over dp); prefill fills
caches laid out by ``cache_logical_axes`` and decode attends to them
split over the sequence. A checkpointed region replays its collectives
(``shard_map.checkpoint``).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import placement as PL
from repro_torch.distributed import shard_map as SM
from repro_torch.distributed.sharding import map_specs
from repro_torch.kernels.dispatch import full_f32, resolve_device
from repro_torch.models import kv_cache as KV
from repro_torch.models import layers as L

LAYER_KEYS = {
    "attn": ("wk", "wo", "wq", "wv"),
    "mlp": ("w1", "w2", "w3"),
    "moe": ("router", "w1", "w2", "w3"),
}


# ---------------------------------------------------------------------------
# segment plan: n_layers -> [(reps, windows_tuple), ...]
# ---------------------------------------------------------------------------

def segment_plan(cfg) -> list[tuple[int, tuple]]:
    p = len(cfg.attn_pattern)
    full, rem = divmod(cfg.n_layers, p)
    plan = []
    if full:
        plan.append((full, tuple(cfg.attn_pattern)))
    if rem:
        plan.append((1, tuple(cfg.attn_pattern[:rem])))
    return plan


def layer_order(cfg) -> list[tuple[int, int, int, int]]:
    """(segment, slot, rep, window) of every layer in execution order."""
    return [(s, k, r, w) for s, (reps, windows) in enumerate(segment_plan(cfg))
            for r in range(reps) for k, w in enumerate(windows)]


def padded_vocab(cfg, mult: int = 256) -> int:
    """Vocab rounded up to a multiple of ``mult`` (``repro`` pads so the
    embedding shards evenly; padded logits are masked in the loss)."""
    return -(-cfg.vocab_size // mult) * mult


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# logical sharding axes of ``repro``'s params tree
# ---------------------------------------------------------------------------

def _layer_specs(cfg, tp: int, dp: int) -> dict:
    """Logical sharding axes per layer param (leading rep axis prepended).

    Preference order per leaf:
      1. tensor-parallel on the natural axis (heads / kv-heads / experts /
         d_ff) when it divides tp;
      2. otherwise ZeRO-style sharding over dp on the leading (d_model)
         axis (``wo``: its last, d_model, axis);
      3. otherwise replicated (norms).
    """
    tp, dp = max(tp, 1), max(dp, 1)
    D = cfg.d_model

    def zero(ndim):
        return (None,) + ("dp",) + (None,) * (ndim - 1) \
            if D % dp == 0 else (None,) * (ndim + 1)

    heads_ok = cfg.n_heads % tp == 0
    kv_ok = cfg.n_kv_heads % tp == 0
    wo_zero = ((None, None, None, "dp") if D % dp == 0 else (None,) * 4)
    attn = {
        "wq": (None, None, "tp", None) if heads_ok else zero(3),
        "wk": (None, None, "tp", None) if kv_ok else zero(3),
        "wv": (None, None, "tp", None) if kv_ok else zero(3),
        "wo": (None, "tp", None, None) if heads_ok else wo_zero,
    }
    if cfg.moe is not None:
        ok = cfg.moe.n_experts % tp == 0
        ffn = {"router": (None, None, None),
               "w1": (None, "tp", None, None) if ok else (None,) * 4,
               "w3": (None, "tp", None, None) if ok else (None,) * 4,
               "w2": (None, "tp", None, None) if ok else (None,) * 4}
    else:
        ok = cfg.d_ff % tp == 0
        ffn = {"w1": (None, None, "tp") if ok else zero(2),
               "w3": (None, None, "tp") if ok else zero(2),
               "w2": (None, "tp", None) if ok else (None, None, None)}
    return {"ln1": (None, None), "attn": attn, "ln2": (None, None),
            "ffn": ffn}


def param_specs(cfg, tp: int = 1, dp: int = 1) -> dict:
    """Logical axes of every leaf of ``repro``'s params tree (the tree of
    ``DecoderLM.to_jax_leaves``' names: ``embed``, ``segments/<s>/<slot>``,
    ``final_norm``)."""
    per_layer = _layer_specs(cfg, tp, dp)
    return {"embed": ("tp", None),
            "segments": [[per_layer for _ in windows]
                         for _, windows in segment_plan(cfg)],
            "final_norm": (None,)}


def param_shardings(cfg, shard):
    """``param_specs`` at the policy's tp and dp as ``NamedSharding``s;
    None without a mesh."""
    if shard.mesh is None:
        return None
    return map_specs(lambda axes: shard.named(*axes),
                     param_specs(cfg, shard.axis_size("tp"),
                                 shard.axis_size("dp")))


def leaf_shardings(cfg, shard) -> dict:
    """``param_shardings`` by leaf name (``DecoderLM.jax_leaf_names``)."""
    tree = param_shardings(cfg, shard)
    return {n: _tree_get(tree, n) for n in template(cfg).jax_leaf_names()}


@functools.lru_cache(maxsize=16)
def template(cfg) -> "DecoderLM":
    """A storage-free model of ``cfg`` (meta): the structure a position's
    slabs are bound to (built once per config; never modified)."""
    with torch.device("meta"):
        return DecoderLM(cfg, None, "meta")


def place_params(model: "DecoderLM", shard) -> dict:
    """The model's leaves placed by ``param_specs`` at the policy's tp and
    dp (a dict of ``Sharded`` by leaf name), one leaf at a time."""
    return PL.place_model(model, leaf_shardings(model.cfg, shard))


def local_model(tmpl: "DecoderLM", leaves: dict, lmap=None) -> "DecoderLM":
    """``tmpl``'s structure holding one position's slabs (a dict by leaf
    name; a segment stack's rep r is that layer's parameter)."""
    return PL.local_module(tmpl, leaves, lmap)


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One pre-norm decoder layer: ``ln1``, ``attn`` (wq, wk, wv, wo),
    ``ln2``, ``ffn`` (w1, w3, w2 and, for MoE, the router); its sliding
    window (0 = global) is ``window``."""

    def __init__(self, cfg, window: int, gen=None, device="cpu"):
        super().__init__()
        self.window = window
        D = cfg.d_model
        self.ln1 = nn.Parameter(torch.zeros(D, dtype=torch.float32))
        self.attn = nn.ParameterDict(L.attention_params(cfg, gen, device))
        self.ln2 = nn.Parameter(torch.zeros(D, dtype=torch.float32))
        self.ffn = nn.ParameterDict(L.ffn_params(cfg, gen, device))


class DecoderLM(nn.Module):
    """The decoder-only LM of ``cfg`` (an ``LMConfig``).

    Weights are drawn from ``generator`` on its device (a CUDA generator
    draws on the card; a CPU one on the host, then the model moves to
    ``device``) with ``repro``'s scales: normal * ``d_model ** -0.5`` for
    wq/wk/wv, w1/w3 and the router, ``(H * hd) ** -0.5`` for wo,
    ``d_ff ** -0.5`` for w2, norms zero. ``device`` defaults to the card
    and raises without one. ``cfg`` may be replaced by one of the same
    shapes (another ``dtype`` or ``moe.impl``)."""

    def __init__(self, cfg, generator: torch.Generator | None = None,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.layers = nn.ModuleList(Block(cfg, w, generator, dev)
                                    for _, _, _, w in layer_order(cfg))
        self.embed = nn.Parameter(L._normal(
            generator, (padded_vocab(cfg), cfg.d_model), cfg.d_model ** -0.5,
            dev))
        self.final_norm = nn.Parameter(torch.zeros(cfg.d_model,
                                                   dtype=torch.float32))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor, caches: list | None = None):
        return forward(self, tokens, caches)

    # ------------------------------------------------------------------
    # ``repro``'s parameter tree
    # ------------------------------------------------------------------

    def _layer_keys(self) -> list:
        ffn = LAYER_KEYS["moe" if self.cfg.moe is not None else "mlp"]
        return ([f"attn/{k}" for k in LAYER_KEYS["attn"]]
                + [f"ffn/{k}" for k in ffn] + ["ln1", "ln2"])

    def jax_leaf_names(self) -> list:
        """Paths of ``repro``'s params tree in ``jax.tree.leaves`` order,
        '/'-joined (``segments/<s>/<slot>/attn/wq`` is the [reps, D, H, hd]
        stack of that slot's layers)."""
        names = ["embed", "final_norm"]
        for s, (_, windows) in enumerate(segment_plan(self.cfg)):
            for k in range(len(windows)):
                names += [f"segments/{s}/{k}/{key}"
                          for key in self._layer_keys()]
        return names

    def jax_stacked(self, name: str) -> bool:
        """True for a leaf stacked along a leading [reps] axis."""
        return name.startswith("segments/")

    def jax_leaf_params(self, name: str) -> list:
        """The parameters behind one ``repro`` leaf: one per rep of a
        ``segments/`` stack, else the one parameter."""
        if not self.jax_stacked(name):
            return [getattr(self, name)]
        _, s, k, *key = name.split("/")
        out = []
        for i, (ls, lk, _, _) in enumerate(layer_order(self.cfg)):
            if (ls, lk) == (int(s), int(k)):
                p = self.layers[i]
                for part in key:
                    p = p[part] if isinstance(p, nn.ParameterDict) \
                        else getattr(p, part)
                out.append(p)
        return out

    @torch.no_grad()
    def to_jax_leaves(self) -> list:
        """The parameters as ``repro``'s leaves (segment slots stacked
        [reps, ...]), in ``jax.tree.leaves`` order."""
        out = []
        for name in self.jax_leaf_names():
            ps = self.jax_leaf_params(name)
            out.append(torch.stack(ps) if self.jax_stacked(name)
                       else ps[0].detach().clone())
        return out

    @torch.no_grad()
    def load_jax_leaves(self, leaves) -> None:
        """Copy ``repro``-ordered leaves (numpy arrays or tensors, segment
        slots stacked) into the parameters, bit for bit; shapes must
        match."""
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


def init_params(cfg, generator: torch.Generator | None = None,
                device="cuda") -> DecoderLM:
    """A randomly initialised model (``repro``'s ``init_params``; the draws
    come from ``generator``, not from a JAX key)."""
    return DecoderLM(cfg, generator, device)


def _tree_get(tree, name: str):
    for k in name.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def params_from_jax(cfg, tree: dict, device="cuda", shard=None):
    """A model holding ``repro``'s params ``tree`` (nested dicts and lists
    of numpy arrays, segment slots stacked [reps, ...]) bit for bit. With
    ``shard`` (a ``ShardingPolicy`` on a mesh) the leaves are placed
    straight into slabs by ``param_specs`` instead (a dict of ``Sharded``
    by leaf name), each block copied from the host."""
    if shard is not None and shard.mesh is not None:
        sh = leaf_shardings(cfg, shard)
        return PL.place_leaves({n: _tree_get(tree, n) for n in sh}, sh)
    model = DecoderLM(cfg, torch.Generator().manual_seed(0), device)
    model.load_jax_leaves([_tree_get(tree, n)
                           for n in model.jax_leaf_names()])
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _block(cfg, p: Block, x, positions, cache=None, pos=None, shard=None):
    h = L.rms_norm(x, p.ln1, cfg.norm_eps)
    y, new_cache = L.attention(cfg, p.attn, h, positions, p.window,
                               kv_cache=cache, decode_pos=pos, shard=shard)
    x = x + y
    h = L.rms_norm(x, p.ln2, cfg.norm_eps)
    return x + L.ffn(cfg, p.ffn, h, shard), new_cache


def _block_train(cfg, p: Block, x, positions, shard=None):
    return _block(cfg, p, x, positions, shard=shard)[0]


def _embed(model, tokens: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    dtype = compute_dtype(cfg)
    if dtype == torch.float32:
        full_f32()
    tokens = torch.as_tensor(tokens).to(model.device, torch.long)
    x = F.embedding(tokens, model.embed).to(dtype)
    return x * L._round(cfg.d_model ** 0.5, x.dtype)


def _layer_cache(caches, s: int, k: int, r: int) -> dict:
    slot = caches[s][k]
    return {"k": slot["k"][r], "v": slot["v"][r]}


def forward(model: DecoderLM, tokens: torch.Tensor,
            caches: list | None = None, shard=None):
    """Train/prefill forward. tokens [B,S] -> hidden [B,S,D].

    When ``caches`` is given (prefill), each layer persists its K/V into
    its cache (in place); returns (hidden, caches), else hidden only.
    ``shard`` (a ``ShardingPolicy``) reaches the MoE (``L.ffn``). Inside a
    body the hidden states come back in the residual's layout (split over
    the sequence under Megatron-SP, ``_sp``).
    """
    if L.partitioned(shard):
        return _forward_part(model, tokens, caches, shard)
    cfg = model.cfg
    x = _embed(model, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for blk, (s, k, r, _) in zip(model.layers, layer_order(cfg)):
        if caches is not None:
            x, _ = _block(cfg, blk, x, positions,
                          cache=_layer_cache(caches, s, k, r), shard=shard)
        elif remat:
            x = checkpoint(_block_train, cfg, blk, x, positions, shard,
                           use_reentrant=False)
        else:
            x = _block_train(cfg, blk, x, positions, shard)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    if caches is not None:
        return x, caches
    return x


def _logits_of(cfg, emb: torch.Tensor, h: torch.Tensor,
               off: int = 0) -> torch.Tensor:
    """``h @ emb.T``, soft-capped, padded vocabulary masked; ``emb`` is the
    embedding already in ``h``'s dtype, rows [off, off + V) of the
    vocabulary (a tp slab: the mask is by global index)."""
    logits = torch.einsum("...d,vd->...v", h, emb)
    logits = L.softcap(logits, cfg.final_softcap)
    vp = emb.shape[0]
    if off + vp > cfg.vocab_size:                 # mask vocab padding
        pad_mask = off + torch.arange(vp, device=h.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits, -1e30)
    return logits


def _logits(model: DecoderLM, h: torch.Tensor) -> torch.Tensor:
    return _logits_of(model.cfg, model.embed.to(h.dtype), h)


def _chunk_loss(cfg, emb, h, y):
    logits = _logits_of(cfg, emb, h).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, y[:, None])[:, 0]
    return (logz - gold).sum()


def lm_loss(model: DecoderLM, hidden: torch.Tensor,
            labels: torch.Tensor, shard=None) -> torch.Tensor:
    """Chunked cross-entropy over token chunks, so [tokens, V] never
    materialises at once. hidden [B,S,D], labels [B,S] -> scalar mean CE
    (float32). Inside a body (``shard``), see ``_lm_loss_part``."""
    if L.partitioned(shard):
        return _lm_loss_part(model, hidden, labels, shard)
    cfg = model.cfg
    B, S, D = hidden.shape
    T = B * S
    h2 = hidden.reshape(T, D)
    y2 = torch.as_tensor(labels).to(hidden.device, torch.long).reshape(T)
    n_chunks = cfg.loss_chunks
    while T % n_chunks:
        n_chunks -= 1
    c = T // n_chunks
    emb = model.embed.to(hidden.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, T, c):
        h, y = h2[i:i + c], y2[i:i + c]
        part = (checkpoint(_chunk_loss, cfg, emb, h, y, use_reentrant=False)
                if remat else _chunk_loss(cfg, emb, h, y))
        total = total + part
    return total / T


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def loss_fn(model: DecoderLM, batch: dict, shard=None) -> torch.Tensor:
    h = forward(model, batch["tokens"], shard=shard)
    return lm_loss(model, h, batch["labels"], shard)


@torch.no_grad()
def prefill_step(model: DecoderLM, batch: dict,
                 decode_budget: int = 0, shard=None,
                 windowed_cache: bool = True) -> tuple:
    """Prefill: build KV caches + last-position logits. batch: tokens [B,S].

    ``decode_budget`` reserves extra cache capacity for subsequent decode
    steps (global-attention slots grow by it; ring windows don't need to).
    ``windowed_cache=False`` gives window layers full-length caches too
    (``kv_cache.cache_len``), with the ring's logits.
    Returns (logits [B,1,Vp], caches). Inside a body: this position's
    vocab slice of the logits and its cache slabs (``cache_logical_axes``).
    """
    if L.partitioned(shard):
        return _prefill_part(model, batch, decode_budget, shard,
                             windowed_cache)
    cfg = model.cfg
    tokens = torch.as_tensor(batch["tokens"])
    B, S = tokens.shape
    caches = KV.init_cache(cfg, segment_plan(cfg), B, S + decode_budget,
                           compute_dtype(cfg), device=model.device,
                           windowed=windowed_cache)
    h, caches = forward(model, tokens, caches=caches)
    return _logits(model, h[:, -1:]), caches


@torch.no_grad()
def decode_step(model: DecoderLM, caches: list, token: torch.Tensor,
                pos: int, shard=None) -> tuple:
    """One decode step. token [B,1] int; ``pos`` its position; caches from
    ``prefill_step`` (written in place). Returns (logits [B,1,Vp],
    caches). Inside a body: this position's vocab slice of the logits,
    its cache slabs written in place."""
    if L.partitioned(shard):
        return _decode_part(model, caches, token, pos, shard)
    cfg = model.cfg
    x = _embed(model, token)
    positions = torch.full((1,), int(pos), dtype=torch.long, device=x.device)
    for blk, (s, k, r, _) in zip(model.layers, layer_order(cfg)):
        x, _ = _block(cfg, blk, x, positions,
                      cache=_layer_cache(caches, s, k, r), pos=pos)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return _logits(model, x), caches


# ---------------------------------------------------------------------------
# partitioned: one position's part inside a ``shard_map`` body
# ---------------------------------------------------------------------------

def _sp(cfg, shard, B: int, S: int) -> bool:
    """``repro``'s Megatron-SP residual: on with ``sp_activations`` when
    batch and sequence are above 1 (and sp has more than one position)."""
    return bool(cfg.sp_activations and B > 1 and S > 1
                and L._size(shard.axes("sp")) > 1)


def _vocab_slab(model: DecoderLM, shard) -> tuple:
    """(this position's embedding rows, their first row's index, tp
    axes): the embedding is split over vocab along tp."""
    emb = model.embed
    tp = shard.axes("tp")
    vp = padded_vocab(model.cfg)
    off = L._index(tp) * emb.shape[0] if emb.shape[0] < vp else 0
    return emb, off, tp if emb.shape[0] < vp else ()


def _embed_part(model: DecoderLM, tokens: torch.Tensor, shard):
    """The masked local take of the vocab slab's rows, ``psum``'d over tp
    (every other position adds zeros: exact)."""
    cfg = model.cfg
    dtype = compute_dtype(cfg)
    if dtype == torch.float32:
        full_f32()
    emb, off, tp = _vocab_slab(model, shard)
    ids = torch.as_tensor(tokens).to(emb.device, torch.long) - off
    inside = (ids >= 0) & (ids < emb.shape[0])
    rows = F.embedding(ids.clamp(0, emb.shape[0] - 1), emb)
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    x = SM.psum(rows, tp) if tp else rows
    x = x.to(dtype)
    return x * L._round(cfg.d_model ** 0.5, x.dtype)


def _forward_part(model: DecoderLM, tokens, caches, shard):
    cfg = model.cfg
    S = tokens.shape[1]
    B = shard.batch if shard.batch is not None else tokens.shape[0]
    pol = shard.body(batch=B, sp=_sp(cfg, shard, B, S))
    x = L.rows_local(_embed_part(model, tokens, pol), pol)
    positions = torch.arange(S, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for blk, (s, k, r, _) in zip(model.layers, layer_order(cfg)):
        if caches is not None:
            x, _ = _block(cfg, blk, x, positions,
                          cache=_layer_cache(caches, s, k, r), shard=pol)
        elif remat:
            x = SM.checkpoint(_block_train, cfg, blk, x, positions, pol)
        else:
            x = _block_train(cfg, blk, x, positions, pol)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    if caches is not None:
        return x, caches
    return x


def _chunk_loss_part(cfg, emb, off, tp, h, y):
    """One chunk's summed cross-entropy over vocab-split logits."""
    logits = _logits_of(cfg, emb, h, off).float()
    if tp:
        m = SM.pmax(logits.amax(dim=-1), tp)
        z = SM.psum(torch.exp(logits - m[:, None]).sum(dim=-1), tp)
        logz = torch.log(z) + m
    else:
        logz = torch.logsumexp(logits, dim=-1)
    local = y - off
    inside = (local >= 0) & (local < emb.shape[0])
    gold = logits.gather(-1, local.clamp(0, emb.shape[0] - 1)[:, None])[:, 0]
    gold = torch.where(inside, gold, torch.zeros_like(gold))
    if tp:
        gold = SM.psum(gold, tp)
    return (logz - gold).sum()


def _lm_loss_part(model: DecoderLM, hidden, labels, shard):
    """The global mean cross-entropy, the same on every position: this
    position's tokens (its dp block, every row of it) chunk by chunk, the
    chunks' sums ``psum``'d over dp and divided by the global count."""
    cfg = model.cfg
    labels = torch.as_tensor(labels).to(hidden.device, torch.long)
    S = labels.shape[1]
    B = shard.batch if shard.batch is not None else labels.shape[0]
    pol = shard.body(batch=B, sp=_sp(cfg, shard, B, S))
    hidden = L.rows_whole(hidden, pol)
    Bl, _, D = hidden.shape
    T = Bl * S
    h2, y2 = hidden.reshape(T, D), labels.reshape(T)
    n_chunks = cfg.loss_chunks
    while T % n_chunks:
        n_chunks -= 1
    c = T // n_chunks
    emb, off, tp = _vocab_slab(model, pol)
    emb = emb.to(hidden.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, T, c):
        args = (cfg, emb, off, tp, h2[i:i + c], y2[i:i + c])
        total = total + (SM.checkpoint(_chunk_loss_part, *args) if remat
                         else _chunk_loss_part(*args))
    dp = pol.axes("dp") if L._batch_axis(pol) else ()
    if dp:
        total = SM.psum(total, dp)
    return total / (B * S)


def _local_logits(model: DecoderLM, h, shard):
    emb, off, _ = _vocab_slab(model, shard)
    return _logits_of(model.cfg, emb.to(h.dtype), h, off)


def _prefill_part(model: DecoderLM, batch, decode_budget, shard,
                  windowed_cache: bool = True):
    cfg = model.cfg
    tokens = torch.as_tensor(batch["tokens"])
    Bl, S = tokens.shape
    B = shard.batch if shard.batch is not None else Bl
    pol = shard.body(batch=B, sp=_sp(cfg, shard, B, S))
    caches = KV.init_cache(cfg, segment_plan(cfg), Bl, S + decode_budget,
                           compute_dtype(cfg), device=model.device,
                           seq_shards=L._size(L._seq_axes(pol)),
                           windowed=windowed_cache)
    h, caches = _forward_part(model, tokens, caches, pol)
    last = h[:, -1:]
    if pol.sp:                        # the last row lives on the last block
        last = SM.all_gather(last, pol.axes("sp"), axis=1, tiled=True)[:, -1:]
    return _local_logits(model, last, pol), caches


def _decode_part(model: DecoderLM, caches, token, pos, shard):
    cfg = model.cfg
    pol = shard.body(sp=False)
    x = _embed_part(model, token, pol)
    pos = int(pos)
    positions = torch.full((1,), pos, dtype=torch.long, device=x.device)
    for blk, (s, k, r, _) in zip(model.layers, layer_order(cfg)):
        x, _ = _block(cfg, blk, x, positions,
                      cache=_layer_cache(caches, s, k, r), pos=pos,
                      shard=pol)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return _local_logits(model, x, pol), caches
