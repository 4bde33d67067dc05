"""Decoder-LM layers: RMSNorm, RoPE, GQA attention (sliding window and
logit soft-capping, train / prefill / ring-buffer decode), the gated MLP
and MoE (the dense all-expert baseline, the sorted ragged dispatch, and
its expert-parallel body over a mesh, ``moe_ragged_ep``).

The port of ``repro.models.layers``. Functions are plain functions on
tensors; ``p`` is a mapping of parameter name to tensor (a layer's
``nn.ParameterDict``). Parameters stay float32 and are cast to the
activations' dtype at each use, as ``repro`` casts them. The products are
``torch.einsum``/``matmul`` on cuBLAS: ``repro`` computes them outside any
Pallas kernel (``jnp.einsum``, ``jax.lax.ragged_dot``).

Numerics kept from ``repro``: the norm runs in float32, scales by
``1 + w`` and casts back; RoPE is the rotate-half layout with float32
angles; q is scaled by ``head_dim ** -0.5`` (rounded to the compute
dtype) after RoPE; masked scores are -1e30 and a key j is in a query i's
window when ``i - j < window``; softmax runs in float32 and casts back;
GELU (the tanh form) and SiLU follow ``jax.nn``'s formulas op for op, so
bfloat16 rounds where JAX rounds; the router's top k breaks ties by lower
expert id (``jax.lax.top_k``'s order) and the ragged dispatch sorts
stably.
``F.scaled_dot_product_attention`` is not used: it is a library kernel
with another arithmetic.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG = -1e30

# above this many query positions, attention loops over q-chunks so the
# [S, S] score matrix never materialises (exact; it only saves memory)
ATTN_CHUNK_THRESHOLD = 8192
ATTN_CHUNK = 1024


def _round(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as JAX rounds a weak-typed scalar to the
    array's dtype before the operation. Rounded on the host: a scalar
    tensor made on the card would be a copy that waits for the card."""
    return torch.tensor(v, dtype=dtype).item()


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + w.float())
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x [..., S, H, hd]; positions [S] (rotate-half layout)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    # ang: [S, 1, half] (broadcasts over the head axis)
    ang = positions[..., :, None, None].float() * freq
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s tanh form op for op, each step rounded to x's
    dtype as JAX rounds it (``F.gelu`` rounds once: another bf16 result)."""
    c = _round(math.sqrt(2 / math.pi), x.dtype)
    inner = c * (x + _round(0.044715, x.dtype) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


class _Logistic(torch.autograd.Function):
    """``jax.lax.logistic``: ``1 / (1 + exp(-x))`` with each step rounded
    to x's dtype, as XLA expands it, and lax's derivative
    ``g * (s * logistic(-x))``, which stays finite where exp overflows."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return 1 / (1 + torch.exp(-x))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        s = 1 / (1 + torch.exp(-x))
        return g * (s * (1 / (1 + torch.exp(x))))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * logistic(x)`` (``F.silu`` rounds once)."""
    return x * _Logistic.apply(x)


def _act(name: str):
    return {"gelu": _gelu, "silu": _silu, "relu": F.relu}[name]


def _normal(gen, shape: tuple, scale: float, device) -> torch.Tensor:
    """float32 normal draws times ``scale``, on ``gen``'s device (or
    ``device`` without a generator)."""
    dev = gen.device if gen is not None else device
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=dev) * scale


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _sdpa_block(cfg, qh, k, v, q_pos, kv_pos, window):
    """qh [B,c,KV,rep,hd]; k/v [B,S,KV,hd]; q_pos [c]; kv_pos [S]."""
    scores = torch.einsum("bskrh,btkh->bkrst", qh, k)
    scores = softcap(scores, cfg.attn_softcap)
    i = q_pos[:, None]
    jj = kv_pos[None, :]
    mask = jj <= i
    if window:
        mask = mask & (i - jj < window)
    scores = torch.where(mask[None, None, None], scores, NEG)
    w = torch.softmax(scores.float(), dim=-1).to(qh.dtype)
    return torch.einsum("bkrst,btkh->bskrh", w, v)


def _sdpa(cfg, qh, k, v, positions, window):
    """Exact attention; q-chunked above ATTN_CHUNK_THRESHOLD."""
    S = qh.shape[1]
    if S <= ATTN_CHUNK_THRESHOLD or S % ATTN_CHUNK:
        return _sdpa_block(cfg, qh, k, v, positions, positions, window)
    return torch.cat([
        _sdpa_block(cfg, qh[:, c:c + ATTN_CHUNK], k, v,
                    positions[c:c + ATTN_CHUNK], positions, window)
        for c in range(0, S, ATTN_CHUNK)], dim=1)


def attention(cfg, p, x: torch.Tensor, positions: torch.Tensor, window: int,
              kv_cache: dict | None = None, decode_pos: int | None = None):
    """GQA attention. x [B,S,D] -> (y [B,S,D], cache or None).

    Train: ``kv_cache`` None. Prefill: ``kv_cache`` is a layer's
    ``{"k", "v"}`` [B,Sc,KV,hd] to FILL with the last Sc positions (ring
    layout for a window). Decode: S == 1 at position ``decode_pos``; this
    token's K/V go into slot ``pos % Sc`` (window) or ``min(pos, Sc-1)``
    and the query attends to the cache. The cache is written in place and
    returned.
    """
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = H // KV

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    q = rope(q, positions, cfg.rope_theta)
    q = q * _round(hd ** -0.5, q.dtype)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if kv_cache is not None and decode_pos is not None:
        # ---- decode: write this token into the (ring) cache, attend to it
        ck, cv = kv_cache["k"], kv_cache["v"]
        Sc = ck.shape[1]
        pos = int(decode_pos)
        slot = pos % Sc if window else min(pos, Sc - 1)
        ck[:, slot:slot + 1] = k.to(ck.dtype)
        cv[:, slot:slot + 1] = v.to(cv.dtype)
        new_cache = kv_cache
        j = torch.arange(Sc, device=x.device)
        valid = (torch.ones_like(j, dtype=torch.bool)
                 if window and pos + 1 >= Sc else j <= pos)
        qh = q.reshape(B, S, KV, rep, hd)
        scores = torch.einsum("bskrh,bjkh->bkrsj", qh, ck.to(x.dtype))
        scores = softcap(scores, cfg.attn_softcap)
        scores = torch.where(valid, scores, NEG)
        w = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        o = torch.einsum("bkrsj,bjkh->bskrh", w, cv.to(x.dtype))
        o = o.reshape(B, S, H, hd)
    else:
        # ---- train/prefill: full (windowed-causal) self-attention
        if kv_cache is not None:
            # prefill: persist the last Sc positions (ring layout for windows)
            ck, cv = kv_cache["k"], kv_cache["v"]
            Sc = ck.shape[1]
            take = min(Sc, S)
            ks = k[:, S - take:].to(ck.dtype)
            vs = v[:, S - take:].to(cv.dtype)
            if window and S >= Sc:
                ks = torch.roll(ks, S % Sc, dims=1)
                vs = torch.roll(vs, S % Sc, dims=1)
            ck[:, :take] = ks
            cv[:, :take] = vs
            new_cache = kv_cache
        qh = q.reshape(B, S, KV, rep, hd)
        o = _sdpa(cfg, qh, k, v, positions, window)
        o = o.reshape(B, S, H, hd)

    y = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    return y, new_cache


def attention_params(cfg, gen=None, device="cpu") -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = D ** -0.5
    return {
        "wq": _normal(gen, (D, H, hd), s, device),
        "wk": _normal(gen, (D, KV, hd), s, device),
        "wv": _normal(gen, (D, KV, hd), s, device),
        "wo": _normal(gen, (H, hd, D), (H * hd) ** -0.5, device),
    }


# ---------------------------------------------------------------------------
# dense gated MLP
# ---------------------------------------------------------------------------

def mlp(cfg, p, x: torch.Tensor) -> torch.Tensor:
    act = _act(cfg.act)
    h = act(torch.einsum("bsd,df->bsf", x, p["w1"].to(x.dtype)))
    g = torch.einsum("bsd,df->bsf", x, p["w3"].to(x.dtype))
    return torch.einsum("bsf,fd->bsd", h * g, p["w2"].to(x.dtype))


def mlp_params(cfg, gen=None, device="cpu") -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "w1": _normal(gen, (D, F_), D ** -0.5, device),
        "w3": _normal(gen, (D, F_), D ** -0.5, device),
        "w2": _normal(gen, (F_, D), F_ ** -0.5, device),
    }


# ---------------------------------------------------------------------------
# MoE: dense all-expert baseline + ragged (sorted group-GEMM) dispatch
# ---------------------------------------------------------------------------

def top_k(x: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the k largest entries of the last axis, ties
    to the lower index (``jax.lax.top_k``'s order; ``torch.topk`` makes
    no such promise)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_router(p, x2d: torch.Tensor, top_k_: int):
    """Returns (gates [T,E] with zeros off the top-k, topk idx [T,k],
    topk weights [T,k])."""
    logits = x2d @ p["router"].to(x2d.dtype)
    topv, topi = top_k(logits, top_k_)
    topw = torch.softmax(topv.float(), dim=-1).to(x2d.dtype)
    gates = torch.zeros_like(logits).scatter(1, topi, topw)
    return gates, topi, topw


def moe_dense(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """Baseline: every token through every expert, gate-weighted combine
    (E/k x the active FLOPs of ``moe_ragged``)."""
    moe = cfg.moe
    act = _act(cfg.act)
    B, S, D = x.shape
    x2 = x.reshape(B * S, D)
    gates, _, _ = moe_router(p, x2, moe.top_k)              # [T, E]
    h = act(torch.einsum("td,edf->tef", x2, p["w1"].to(x.dtype)))
    g = torch.einsum("td,edf->tef", x2, p["w3"].to(x.dtype))
    hg = h * g * gates[:, :, None]                          # [T, E, F]
    y = torch.einsum("tef,efd->td", hg, p["w2"].to(x.dtype))
    return y.reshape(B, S, D)


def _ragged_dot(lhs: torch.Tensor, rhs: torch.Tensor, sizes: list):
    """``jax.lax.ragged_dot``: rows of ``lhs`` [M, K] in contiguous groups
    of ``sizes`` (one per expert), group e times ``rhs[e]`` [K, N]."""
    return torch.cat([part @ w for part, w in
                      zip(torch.split(lhs, sizes), rhs.unbind(0))], dim=0)


def moe_ragged(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """Sorted dropless dispatch: (token, expert) pairs sorted stably by
    expert, one product per expert over its contiguous rows, combined
    back per token with ``index_add``. Computes only top_k expert passes
    per token. The group sizes are read on the host (one sync a layer)."""
    moe = cfg.moe
    act = _act(cfg.act)
    B, S, D = x.shape
    T = B * S
    x2 = x.reshape(T, D)
    _, topi, topw = moe_router(p, x2, moe.top_k)            # [T,k]
    flat_e = topi.reshape(-1)                               # [T*k]
    order = torch.argsort(flat_e, stable=True)
    tok_of = order // moe.top_k
    xs = x2.index_select(0, tok_of)                         # [T*k, D] sorted
    sizes = torch.bincount(flat_e, minlength=moe.n_experts).tolist()
    h = act(_ragged_dot(xs, p["w1"].to(x.dtype), sizes))
    g = _ragged_dot(xs, p["w3"].to(x.dtype), sizes)
    y = _ragged_dot(h * g, p["w2"].to(x.dtype), sizes)
    w = topw.reshape(-1).index_select(0, order)[:, None].to(x.dtype)
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device).index_add(
        0, tok_of, y * w)
    return out.reshape(B, S, D)


def moe_params(cfg, gen=None, device="cpu") -> dict:
    moe = cfg.moe
    D, F_, E = cfg.d_model, moe.d_ff, moe.n_experts
    return {
        "router": _normal(gen, (D, E), D ** -0.5, device),
        "w1": _normal(gen, (E, D, F_), D ** -0.5, device),
        "w3": _normal(gen, (E, D, F_), D ** -0.5, device),
        "w2": _normal(gen, (E, F_, D), F_ ** -0.5, device),
    }


# assignments the expert-parallel body was routed and kept: "assigned"
# counts the (token, expert) pairs each position owns, "kept" those within
# its capacity (the rest are dropped, GShard-style); host ints, summed
# over calls until a caller zeroes them
EP_STATS = {"assigned": 0, "kept": 0}


def moe_ragged_ep(cfg, p, x: torch.Tensor, shard=None) -> torch.Tensor:
    """Expert-parallel ragged dispatch (``repro``'s MoE hillclimb).

    Inside ``shard_map`` over (dp x tp): each position routes its LOCAL
    tokens, keeps only the (token, expert) assignments owned by its tp
    shard (experts are tp-sharded), compacts them stably to a fixed
    capacity (1.25x the expected local count; overflow drops), parks the
    capacity padding in the last group (zeroed rows, weight 0), runs one
    grouped product per projection over its local experts, scatters back
    per token and ``psum``s the partial outputs over tp. ``shard`` is a
    ``ShardingPolicy``; without a mesh this is ``moe_ragged``, as in
    ``repro``. The group sizes are read on the host (one sync a layer and
    position)."""
    from repro_torch.distributed import shard_map as SM

    mesh = shard.mesh if shard is not None else None
    if mesh is None:
        return moe_ragged(cfg, p, x)
    moe = cfg.moe
    act = _act(cfg.act)
    B, S, D = x.shape
    dp_axes = shard.rules["dp"]
    tp_axes = shard.rules["tp"]
    tp_ax = tp_axes[0] if isinstance(tp_axes, tuple) else tp_axes
    tp_size = shard.axis_size("tp")
    dp_size = shard.axis_size("dp")
    if moe.n_experts % max(tp_size, 1):
        raise ValueError(f"{moe.n_experts} experts do not split over tp = "
                         f"{tp_size}")
    e_loc = moe.n_experts // max(tp_size, 1)
    t_loc = (B // max(dp_size, 1)) * S
    cap = max(8, int(math.ceil(t_loc * moe.top_k * e_loc / moe.n_experts
                               * 1.25 / 8.0)) * 8)

    def body(xb, router, w1, w3, w2):
        Bb, Ss, Dd = xb.shape
        T = Bb * Ss
        x2 = xb.reshape(T, Dd)
        logits = x2 @ router.to(x2.dtype)
        topv, topi = top_k(logits, moe.top_k)
        topw = torch.softmax(topv.float(), dim=-1).to(x2.dtype)
        my = SM.axis_index(tp_ax)
        flat_e = topi.reshape(-1)
        local = torch.div(flat_e, e_loc, rounding_mode="floor") == my
        le = torch.where(local, flat_e % e_loc, e_loc)  # e_loc = not mine
        order = torch.argsort(le, stable=True)[:cap]
        le_sel = le.index_select(0, order)
        valid = le_sel < e_loc
        tok = torch.div(order, moe.top_k, rounding_mode="floor")
        xs = x2.index_select(0, tok) * valid[:, None].to(x2.dtype)
        counts = torch.bincount(le, minlength=e_loc + 1).tolist()[:e_loc]
        # ``order`` is sorted by group and cut at ``cap``: group e keeps
        # what of its count still fits after the groups before it
        sizes, before = [], 0
        for c in counts:
            sizes.append(min(c, max(0, cap - before)))
            before += c
        EP_STATS["assigned"] += sum(counts)
        EP_STATS["kept"] += sum(sizes)
        # park the capacity padding in the last group
        sizes[-1] += order.shape[0] - sum(sizes)
        h = act(_ragged_dot(xs, w1.to(xs.dtype), sizes))
        g = _ragged_dot(xs, w3.to(xs.dtype), sizes)
        y = _ragged_dot(h * g, w2.to(xs.dtype), sizes)
        w = topw.reshape(-1).index_select(0, order) * valid.to(x2.dtype)
        out = torch.zeros((T, Dd), dtype=x2.dtype, device=x2.device
                          ).index_add(0, tok, y * w[:, None])
        out = SM.psum(out, tp_ax)
        return out.reshape(Bb, Ss, Dd)

    P = SM.P
    return SM.shard_map(
        body, mesh,
        in_specs=(P(dp_axes, None, None), P(None, None),
                  P(tp_ax, None, None), P(tp_ax, None, None),
                  P(tp_ax, None, None)),
        out_specs=P(dp_axes, None, None),
    )(x, p["router"], p["w1"], p["w3"], p["w2"])


def ffn(cfg, p, x: torch.Tensor, shard=None) -> torch.Tensor:
    """The layer's feed-forward: the gated MLP, or the MoE of
    ``cfg.moe.impl``; ``ragged_ep`` runs its expert-parallel body when
    ``shard`` (a ``ShardingPolicy``) has a mesh, ``moe_ragged`` without
    one, as ``repro`` does."""
    if cfg.moe is None:
        return mlp(cfg, p, x)
    if cfg.moe.impl == "ragged_ep":
        return moe_ragged_ep(cfg, p, x, shard)
    if cfg.moe.impl == "ragged":
        return moe_ragged(cfg, p, x)
    return moe_dense(cfg, p, x)


def ffn_params(cfg, gen=None, device="cpu") -> dict:
    return (moe_params(cfg, gen, device) if cfg.moe is not None
            else mlp_params(cfg, gen, device))
