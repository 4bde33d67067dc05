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

Partitioned (inside a ``shard_map`` body, ``shard`` a ``ShardingPolicy``
on the body's mesh carrying the global batch and the residual's sequence
parallelism, ``ShardingPolicy.body``): ``p`` holds this position's slabs,
laid out by ``transformer.param_specs``, and the counts come from them
(the local heads, ``d_ff / tp``, the local experts). The layouts are
``repro``'s constraint sites made explicit:

- attention in ``heads`` mode (``H % tp == 0``): the position's q heads,
  k/v either tp-split with them or ZeRO leaves gathered whole, each
  position taking its q heads' kv group; ``wo`` row-split, so the output
  is a partial sum over tp (``repro``'s ``y`` constraint: reduced to
  replicated, or reduce-scattered over the sequence under Megatron-SP);
- attention in ``seq`` mode (``H % tp != 0``): every weight a ZeRO leaf
  gathered whole, the query rows split over sp (``repro``'s ``qh`` and
  score constraints), masks and windows on the rows' global positions;
- decode against a cache split over sp (over ``flat`` at batch 1): the
  slot's owner writes the new K/V, every position scores its slice of
  the cache, and the softmax runs across positions (``pmax``, ``psum``);
- the MLP column-split ``w1``/``w3`` and row-split ``w2`` (its output a
  partial sum over tp), or ZeRO ``w1``/``w3`` gathered and ``w2`` whole;
- ``moe_dense`` with the experts over tp and the router replicated; the
  expert-parallel ``ragged_ep`` body runs in place.

A ZeRO gather happens inside the layer that uses the leaf, so the whole
leaf lives only there (under remat, ``shard_map.checkpoint`` replays it).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import shard_map as SM

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
    if torch.device(dev).type == "meta":      # shapes only: nothing to draw
        return torch.empty(shape, dtype=torch.float32, device=dev)
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


def _sdpa(cfg, qh, k, v, positions, window, q_pos=None):
    """Exact attention; q-chunked above ATTN_CHUNK_THRESHOLD. ``q_pos``
    (default ``positions``) are the query rows' positions."""
    q_pos = positions if q_pos is None else q_pos
    S = qh.shape[1]
    if S <= ATTN_CHUNK_THRESHOLD or S % ATTN_CHUNK:
        return _sdpa_block(cfg, qh, k, v, q_pos, positions, window)
    return torch.cat([
        _sdpa_block(cfg, qh[:, c:c + ATTN_CHUNK], k, v,
                    q_pos[c:c + ATTN_CHUNK], positions, window)
        for c in range(0, S, ATTN_CHUNK)], dim=1)


def _decode_valid(j: torch.Tensor, pos: int, Sc: int, window: int):
    """The cache slots ``j`` that a decode query at ``pos`` attends to,
    in a cache of ``Sc`` slots written at slot ``pos % Sc`` (window) or
    ``min(pos, Sc - 1)``: the slots written so far, and for a window
    layer only keys under ``window`` positions back. A ring (Sc <=
    window) holds only such keys; a full-length cache of a window layer
    (Sc > window, ``prefill_step(windowed_cache=False)``) is masked by
    each slot's position."""
    if window and pos + 1 >= Sc:
        valid = torch.ones_like(j, dtype=torch.bool)
    else:
        valid = j <= pos
    if window and Sc > window:
        valid = valid & ((pos - j) % Sc < window)
    return valid


def attention(cfg, p, x: torch.Tensor, positions: torch.Tensor, window: int,
              kv_cache: dict | None = None, decode_pos: int | None = None,
              shard=None):
    """GQA attention. x [B,S,D] -> (y [B,S,D], cache or None).

    Train: ``kv_cache`` None. Prefill: ``kv_cache`` is a layer's
    ``{"k", "v"}`` [B,Sc,KV,hd] to FILL with the last Sc positions (ring
    layout for a window). Decode: S == 1 at position ``decode_pos``; this
    token's K/V go into slot ``pos % Sc`` (window) or ``min(pos, Sc-1)``
    and the query attends to the cache. The cache is written in place and
    returned. Inside a body (``partitioned(shard)``), see the module
    docstring: ``x`` is in the residual's layout and so is ``y``.
    """
    if partitioned(shard):
        return _attention_part(cfg, p, x, positions, window, shard,
                               kv_cache, decode_pos)
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
        valid = _decode_valid(torch.arange(Sc, device=x.device), pos, Sc,
                              window)
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


def _even_sizes(total: int, n: int) -> list:
    """``total`` rows in ``n`` groups as evenly as they go: the group sizes
    of a shapes-only (meta) run, which has no routing to count. A ragged
    product's operations depend only on the total, so the count is
    exact."""
    return [total // n + (1 if e < total % n else 0) for e in range(n)]


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
    if flat_e.device.type == "meta":                # no data: T*k rows
        sizes = _even_sizes(flat_e.shape[0], moe.n_experts)
    else:
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
    mesh = shard.mesh if shard is not None else None
    if mesh is None:
        return moe_ragged(cfg, p, x)
    moe = cfg.moe
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
    # inside a body x is already this position's tokens
    t_loc = (B if SM.in_shard_map() else B // max(dp_size, 1)) * S
    cap = max(8, int(math.ceil(t_loc * moe.top_k * e_loc / moe.n_experts
                               * 1.25 / 8.0)) * 8)

    if SM.in_shard_map():
        # already inside a body: this position's tokens and experts
        return _ragged_ep_body(cfg, x, p["router"], p["w1"], p["w3"],
                               p["w2"], tp_ax, cap)

    def body(xb, router, w1, w3, w2):
        return _ragged_ep_body(cfg, xb, router, w1, w3, w2, tp_ax, cap)

    P = SM.P
    return SM.shard_map(
        body, mesh,
        in_specs=(P(dp_axes, None, None), P(None, None),
                  P(tp_ax, None, None), P(tp_ax, None, None),
                  P(tp_ax, None, None)),
        out_specs=P(dp_axes, None, None),
    )(x, p["router"], p["w1"], p["w3"], p["w2"])


def _ragged_ep_body(cfg, xb, router, w1, w3, w2, tp_ax, cap):
    """One position of ``moe_ragged_ep``: its tokens ``xb`` [B, S, D], the
    router whole, its experts' weights."""
    moe = cfg.moe
    act = _act(cfg.act)
    e_loc = w1.shape[0]
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
    if le.device.type == "meta":
        # no data: the capacity, the static bound of ``repro``'s compiled
        # cell, is every row the products run over
        sizes = _even_sizes(order.shape[0], e_loc)
    else:
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


def ffn(cfg, p, x: torch.Tensor, shard=None) -> torch.Tensor:
    """The layer's feed-forward: the gated MLP, or the MoE of
    ``cfg.moe.impl``; ``ragged_ep`` runs its expert-parallel body when
    ``shard`` (a ``ShardingPolicy``) has a mesh, ``moe_ragged`` without
    one, as ``repro`` does. Inside a body, the partitioned layers."""
    if partitioned(shard):
        return _ffn_part(cfg, p, x, shard)
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


# ---------------------------------------------------------------------------
# partitioned: one position's part inside a ``shard_map`` body
# ---------------------------------------------------------------------------

def partitioned(shard) -> bool:
    """True inside a ``shard_map`` body given a policy on a mesh: the
    layers then run on this position's slabs (module docstring)."""
    return shard is not None and shard.mesh is not None and \
        SM.in_shard_map()


def _size(axes: tuple) -> int:
    return SM.axis_size(axes) if axes else 1


def _index(axes: tuple) -> int:
    return SM.axis_index(axes) if axes else 0


def _batch_axis(shard):
    """``repro``'s ``"dp" if B > 1 else None`` (a batch of 1 is whole)."""
    return "dp" if shard.batch is None or shard.batch > 1 else None


def _zero(w: torch.Tensor, dim: int, full: int, shard) -> torch.Tensor:
    """A ZeRO leaf (split over dp along ``dim``) gathered whole for its
    product; a whole leaf as it is."""
    if w.shape[dim] == full:
        return w
    return SM.all_gather(w, shard.axes("dp"), axis=dim, tiled=True)


def rows_whole(x: torch.Tensor, shard) -> torch.Tensor:
    """The residual's rows [B, S, D] whole: gathered over sp under
    Megatron-SP, else as they are."""
    if not shard.sp:
        return x
    b = _batch_axis(shard)
    return shard.constrain(x, b, None, None, have=(b, "sp", None))


def rows_local(y: torch.Tensor, shard) -> torch.Tensor:
    """A complete [B, S, D] -> the residual's layout (this position's rows
    under Megatron-SP)."""
    if not shard.sp:
        return y
    b = _batch_axis(shard)
    return shard.constrain(y, b, "sp", None, have=(b, None, None))


def _reduce_rows(y: torch.Tensor, shard) -> torch.Tensor:
    """Partial sums over tp -> the residual's layout: reduce-scattered
    along the sequence under Megatron-SP, else ``psum``'d."""
    tp = shard.axes("tp")
    if _size(tp) == 1:
        return y
    if shard.sp:
        if tp != shard.axes("sp"):
            raise NotImplementedError("Megatron-SP wants sp on tp's axes")
        return SM.psum_scatter(y, tp, 1)
    return SM.psum(y, tp)


def _kv_groups(q, k, v, h0: int, kv0: int, rep: int) -> tuple:
    """(qh, k, v) for this position's q heads [h0, h0 + Hl): their kv
    groups out of k/v's heads [kv0, ...); a head per group when the local
    heads do not hold whole groups."""
    B, S, Hl, hd = q.shape
    if Hl % rep == 0:
        lo, n = h0 // rep - kv0, Hl // rep
        return (q.reshape(B, S, n, rep, hd), k[:, :, lo:lo + n],
                v[:, :, lo:lo + n])
    idx = (torch.arange(Hl, device=q.device) + h0) // rep - kv0
    return (q.reshape(B, S, Hl, 1, hd), k.index_select(2, idx),
            v.index_select(2, idx))


def _seq_axes(shard) -> tuple:
    """The mesh axes a KV cache's sequence is split over
    (``kv_cache.cache_logical_axes``: sp, flat at batch 1)."""
    return shard.axes("sp" if _batch_axis(shard) else "flat")


def _attention_part(cfg, p, x, positions, window, shard, kv_cache,
                    decode_pos):
    H, KV, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    rep = H // KV
    tp = shard.axes("tp")
    t = _index(tp)
    b = _batch_axis(shard)
    x = rows_whole(x, shard)
    B, S, _ = x.shape
    wq = _zero(p["wq"], 0, D, shard)
    wk = _zero(p["wk"], 0, D, shard)
    wv = _zero(p["wv"], 0, D, shard)
    wo = _zero(p["wo"], 2, D, shard)
    q = torch.einsum("bsd,dhk->bshk", x, wq.to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, wk.to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, wv.to(x.dtype))
    q = rope(q, positions, cfg.rope_theta)
    q = q * _round(hd ** -0.5, q.dtype)
    k = rope(k, positions, cfg.rope_theta)
    Hl, KVl = q.shape[2], k.shape[2]
    h0 = t * Hl if Hl < H else 0
    kv0 = t * KVl if KVl < KV else 0
    if kv_cache is not None:
        # the cache holds every kv head of a slice of the sequence
        k_all = k if KVl == KV else SM.all_gather(k, tp, axis=2, tiled=True)
        v_all = v if KVl == KV else SM.all_gather(v, tp, axis=2, tiled=True)
    if kv_cache is not None and decode_pos is not None:
        o = _decode_attention(cfg, q if Hl == H else SM.all_gather(
            q, tp, axis=2, tiled=True), k_all, v_all, kv_cache, window,
            int(decode_pos), shard)
        if Hl < H:
            y = torch.einsum("bshk,hkd->bsd", o[:, :, h0:h0 + Hl],
                             wo.to(x.dtype))
            return SM.psum(y, tp), kv_cache
        return torch.einsum("bshk,hkd->bsd", o, wo.to(x.dtype)), kv_cache
    if kv_cache is not None:
        _write_prefill_cache(kv_cache, k_all, v_all, window, shard)
    if H % _size(tp):
        # seq mode: this position's query rows against every key
        rows = shard.constrain(q, b, "sp", None, None,
                               have=(b, None, None, None))
        n = rows.shape[1]
        s0 = _index(shard.axes("sp")) * n
        o = _sdpa(cfg, rows.reshape(B, n, KV, rep, hd), k, v, positions,
                  window, q_pos=positions[s0:s0 + n])
        y = torch.einsum("bshk,hkd->bsd", o.reshape(B, n, H, hd),
                         wo.to(x.dtype))
        if shard.sp:
            return y, kv_cache
        return shard.constrain(y, b, None, None, have=(b, "sp", None)), \
            kv_cache
    qh, ku, vu = _kv_groups(q, k, v, h0, kv0, rep)
    o = _sdpa(cfg, qh, ku, vu, positions, window).reshape(B, S, Hl, hd)
    y = torch.einsum("bshk,hkd->bsd", o, wo.to(x.dtype))
    return (_reduce_rows(y, shard) if Hl < H else rows_local(y, shard),
            kv_cache)


def _write_prefill_cache(kv_cache, k_all, v_all, window, shard) -> None:
    """Write this position's slice [off, off + Sc_l) of the prefill cache
    (the last Sc positions, ring-rolled for a window)."""
    ck, cv = kv_cache["k"], kv_cache["v"]
    sx = _seq_axes(shard)
    Sc_l = ck.shape[1]
    Sc, off = Sc_l * _size(sx), _index(sx) * Sc_l
    S = k_all.shape[1]
    take = min(Sc, S)
    ks = k_all[:, S - take:].to(ck.dtype)
    vs = v_all[:, S - take:].to(cv.dtype)
    if window and S >= Sc:
        ks = torch.roll(ks, S % Sc, dims=1)
        vs = torch.roll(vs, S % Sc, dims=1)
    hi = min(off + Sc_l, take)
    if hi > off:
        ck[:, :hi - off] = ks[:, off:hi]
        cv[:, :hi - off] = vs[:, off:hi]


def _decode_attention(cfg, q, k, v, kv_cache, window, pos, shard):
    """One token against a cache split over the sequence: the slot's
    owner writes K/V, each position scores its slice, the softmax runs
    across positions. q [B,1,H,hd], k/v [B,1,KV,hd] -> o [B,1,H,hd]."""
    ck, cv = kv_cache["k"], kv_cache["v"]
    B, _, H, hd = q.shape
    KV = k.shape[2]
    sx = _seq_axes(shard)
    n_s = _size(sx)
    Sc_l = ck.shape[1]
    Sc, off = Sc_l * n_s, _index(sx) * Sc_l
    slot = pos % Sc if window else min(pos, Sc - 1)
    if off <= slot < off + Sc_l:
        ck[:, slot - off:slot - off + 1] = k.to(ck.dtype)
        cv[:, slot - off:slot - off + 1] = v.to(cv.dtype)
    valid = _decode_valid(off + torch.arange(Sc_l, device=q.device), pos,
                          Sc, window)
    qh = q.reshape(B, 1, KV, H // KV, hd)
    scores = torch.einsum("bskrh,bjkh->bkrsj", qh, ck.to(q.dtype))
    scores = softcap(scores, cfg.attn_softcap)
    scores = torch.where(valid, scores, NEG).float()
    if n_s > 1:
        e = torch.exp(scores - SM.pmax(scores.amax(-1, keepdim=True), sx))
        w = (e / SM.psum(e.sum(-1, keepdim=True), sx)).to(q.dtype)
    else:
        w = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bkrsj,bjkh->bskrh", w, cv.to(q.dtype))
    if n_s > 1:
        o = SM.psum(o, sx)
    return o.reshape(B, 1, H, hd)


def _mlp_part(cfg, p, x, shard):
    act = _act(cfg.act)
    w1 = p["w1"]
    if w1.shape[1] < cfg.d_ff:
        # column-split w1/w3, row-split w2: a partial sum over tp
        x = rows_whole(x, shard)
        h = act(torch.einsum("bsd,df->bsf", x, w1.to(x.dtype)))
        g = torch.einsum("bsd,df->bsf", x, p["w3"].to(x.dtype))
        y = torch.einsum("bsf,fd->bsd", h * g, p["w2"].to(x.dtype))
        return _reduce_rows(y, shard)
    # ZeRO w1/w3 gathered, w2 whole: every row complete where it lies
    D = cfg.d_model
    return mlp(cfg, {"w1": _zero(w1, 0, D, shard),
                     "w3": _zero(p["w3"], 0, D, shard), "w2": p["w2"]}, x)


def _moe_dense_part(cfg, p, x, shard):
    E = cfg.moe.n_experts
    El = p["w1"].shape[0]
    if El == E:
        return moe_dense(cfg, p, x)
    act = _act(cfg.act)
    x = rows_whole(x, shard)
    B, S, D = x.shape
    e0 = _index(shard.axes("tp")) * El
    x2 = x.reshape(B * S, D)
    gates, _, _ = moe_router(p, x2, cfg.moe.top_k)
    h = act(torch.einsum("td,edf->tef", x2, p["w1"].to(x.dtype)))
    g = torch.einsum("td,edf->tef", x2, p["w3"].to(x.dtype))
    hg = h * g * gates[:, e0:e0 + El, None]         # this position's experts
    y = torch.einsum("tef,efd->td", hg, p["w2"].to(x.dtype))
    return _reduce_rows(y.reshape(B, S, D), shard)


def _ffn_part(cfg, p, x, shard):
    if cfg.moe is None:
        return _mlp_part(cfg, p, x, shard)
    if cfg.moe.impl == "dense":
        return _moe_dense_part(cfg, p, x, shard)
    if p["w1"].shape[0] == cfg.moe.n_experts:
        return moe_ragged(cfg, p, x)            # whole experts, local rows
    if cfg.moe.impl != "ragged_ep":
        raise NotImplementedError("a ragged MoE with its experts over tp "
                                  "runs as ragged_ep")
    return rows_local(moe_ragged_ep(cfg, p, rows_whole(x, shard), shard),
                      shard)
