"""The port's decoder-LM family against ``repro.models``: the same numpy
params (``params_from_jax``) and inputs through both packages give the
same norm, RoPE, attention (train, prefill into a cache, ring-buffer
decode), MoE routing and dispatch, hidden states and loss, for the five
LM archs at ``tests/test_archs.py``'s reduced sizes in float32, and the
forward, loss, prefill and decode in bfloat16 as well."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.distributed.sharding import ShardingPolicy
from repro.models import kv_cache as JKV
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import kv_cache as KV
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

torch.set_num_threads(1)

LM_ARCHS = ("gemma2-9b", "gemma3-4b", "minicpm-2b", "granite-moe-1b-a400m",
            "olmoe-1b-7b")
MOE_ARCHS = ("granite-moe-1b-a400m", "olmoe-1b-7b")
SHARD = ShardingPolicy(None)
# forward values: f32 products reordered between XLA and PyTorch
RTOL, ATOL = 1e-5, 1e-5
# gradients: a backward pass through the blocks and the chunked loss
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# decode against a full forward (tests/test_archs.py's limit)
DECODE_TOL = 2e-3
# bfloat16 (the archs' configured dtype): repro is compiled with every op
# rounded to its dtype (XLA's excess precision off, so no fusion keeps a
# float32 intermediate), which is the port's arithmetic. The libraries'
# float32 sin, cos, exp, rsqrt and tanh still differ in the last place
# now and then (RoPE's angles most: 0.07% of elements), and a bfloat16
# result flips where that lands on a rounding boundary. Measured over 6
# seeds x the five archs at BF16_WIDTHS:
# - one op on the same bfloat16 inputs: attention 98.7-100% of elements
#   bit for bit (one decode step, 192 elements: 83.9%), the FFN, both
#   MoE dispatches and the real-vocabulary logits 99.4-100%, the
#   embedding 100%; a port computing each op in float32 and rounding
#   once matches 27-40% (embedding 74.5%, logits 58.7%).
# - the whole model at 3 layers (hidden, prefill logits and caches, one
#   decode step from repro's caches), where a flip spreads: mean
#   |port - repro| / mean |repro| at most 3.88e-3; the float32 port at
#   least 5.05e-3. The loss: at most 2.4e-4 apart, which does not tell
#   the two apart (the loss over the same hidden states does: below
#   1e-6 against at least 1.4e-5).
BF16_EQUAL_SHARE = 0.75      # one op: elements bit for bit equal
BF16_STEP = 2 ** -7          # ... the rest within one bfloat16 step
BF16_MODEL_REL = 4.5e-3      # the model: mean |error| / mean |repro|
BF16_LOSS_RTOL = 1e-3        # the model's loss
# bfloat16 cases take widths whose sqrt(d_model) and head_dim ** -0.5 are
# not powers of two, so each scale is rounded to bfloat16 and a port that
# skipped the rounding would show
BF16_WIDTHS = dict(d_model=96, head_dim=24)
EXACT = {"xla_allow_excess_precision": False}


def reduced_lm(get, arch, **over):
    """``tests/test_archs.py``'s reduced LM config, from either package's
    registry."""
    cfg = get(arch)
    kv = 2 if cfg.n_kv_heads < cfg.n_heads else 4
    kw = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=kv, head_dim=16,
              d_ff=128, vocab_size=128, loss_chunks=2, dtype="float32",
              attn_pattern=tuple(min(w, 8) if w else 0
                                 for w in cfg.attn_pattern))
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=4, top_k=2,
                                        d_ff=32)
    kw.update(over)
    return dataclasses.replace(cfg, **kw)


def pair(arch, seed=1, **over):
    """(jax cfg, jax params, port cfg, port model with the same weights).
    A bfloat16 pair takes ``BF16_WIDTHS``."""
    if over.get("dtype") == "bfloat16":
        over = {**BF16_WIDTHS, **over}
    jc = reduced_lm(jax_config, arch, **over)
    tc = reduced_lm(get_config, arch, **over)
    jp = JT.init_params(jc, jax.random.PRNGKey(seed))
    model = T.params_from_jax(tc, jax.tree.map(np.array, jp), device="cpu")
    return jc, jp, tc, model


def tokens_of(rng, B, S, vocab=128):
    return rng.integers(0, vocab, (B, S)).astype(np.int32)


def both_dtypes(archs):
    """(arch, dtype) cases: float32 under the arch's name, bfloat16 as
    ``<arch>-bf16``."""
    return pytest.mark.parametrize(
        "arch,dtype",
        [(a, "float32") for a in archs] + [(a, "bfloat16") for a in archs],
        ids=[*archs, *(f"{a}-bf16" for a in archs)])


def as_dtype(x: np.ndarray, dtype: str):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def close(got, want, what, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close_as(dtype, got, want, what, whole_model=False):
    """float32: ``close``. bfloat16, one op: at least ``BF16_EQUAL_SHARE``
    of the elements bit for bit and the rest within one bfloat16 step at
    the tensor's scale. bfloat16, the whole model: mean error within
    ``BF16_MODEL_REL`` of the mean magnitude, none past four steps."""
    if dtype == "float32":
        return close(got, want, what)
    got, want = np.asarray(_f32(got)), np.asarray(_f32(want))
    scale = float(np.abs(want).max())
    if whole_model:
        rel = float(np.abs(got - want).mean() / np.abs(want).mean())
        assert rel <= BF16_MODEL_REL, (what, rel)
        steps = 4
    else:
        share = float(np.mean(got == want))
        assert share >= BF16_EQUAL_SHARE, (what, share)
        steps = 1
    np.testing.assert_allclose(got, want, rtol=BF16_STEP,
                               atol=steps * BF16_STEP * scale, err_msg=what)


def caches_close(ct, cj, what, dtype="float32", whole_model=False):
    for s, (seg_t, seg_j) in enumerate(zip(ct, cj)):
        for k, (slot_t, slot_j) in enumerate(zip(seg_t, seg_j)):
            for kv in ("k", "v"):
                close_as(dtype, slot_t[kv], slot_j[kv],
                         f"{what} cache {s}/{k}/{kv}", whole_model)


def logits_close(dtype, got, want, vocab, what, whole_model=False):
    """The real vocabulary by ``close_as``; the padded tail, masked to
    -1e30, equal."""
    got, want = _f32(got), _f32(want)
    close_as(dtype, got[..., :vocab], want[..., :vocab], what, whole_model)
    assert np.array_equal(got[..., vocab:], want[..., vocab:]), what


def exact_jit(fn):
    """``fn`` under jit with every op rounded to its dtype, as JAX's
    op-by-op semantics (and the port) round it."""
    return jax.jit(fn, compiler_options=EXACT)


# ---------------------------------------------------------------------------
# primitives and layers
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope_match_repro():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32) * 3
    w = rng.normal(size=(16,)).astype(np.float32)
    close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
          JL.rms_norm(jnp.asarray(x), jnp.asarray(w)), "rms_norm")
    for pos in (np.arange(7), np.arange(1530, 1537)):
        for theta in (10_000.0, 1_000_000.0):
            close(L.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
                  JL.rope(jnp.asarray(x), jnp.asarray(pos), theta),
                  f"rope theta={theta} pos from {pos[0]}")
    close(L.softcap(torch.from_numpy(x), 30.0),
          JL.softcap(jnp.asarray(x), 30.0), "softcap")


def test_rms_norm_and_rope_keep_the_input_dtype():
    x = torch.randn(2, 5, 2, 8, generator=torch.Generator().manual_seed(0))
    xb = x.to(torch.bfloat16)
    assert L.rms_norm(xb, torch.zeros(8)).dtype == torch.bfloat16
    assert L.rope(xb, torch.arange(5), 1e4).dtype == torch.bfloat16
    # the norm runs in float32 and rounds once
    want = L.rms_norm(xb.float(), torch.zeros(8)).to(torch.bfloat16)
    assert torch.equal(L.rms_norm(xb, torch.zeros(8)), want)


@both_dtypes(LM_ARCHS)
def test_attention_modes_match_repro(arch, dtype):
    """Train, prefill into a cache (S past the window: the ring rolls)
    and decode, for each window of the arch's pattern; the caches take
    the activations' dtype."""
    jc, jp, tc, model = pair(arch, dtype=dtype)
    rng = np.random.default_rng(2)
    B, S, budget = 2, 13, 3
    x_j, x_t = as_dtype(rng.normal(size=(B, S, jc.d_model))
                        .astype(np.float32), dtype)
    pos = np.arange(S)
    p_j = jp["segments"][0][0]["attn"]
    p_j = {k: v[0] for k, v in p_j.items()}
    p_t = {k: torch.from_numpy(np.array(v)) for k, v in p_j.items()}
    for window in sorted(set(jc.attn_pattern)):
        y_j, _ = JL.attention(jc, p_j, x_j, jnp.asarray(pos), window, SHARD)
        y_t, _ = L.attention(tc, p_t, x_t, torch.from_numpy(pos), window)
        close_as(dtype, y_t, y_j, f"train window={window}")
        sc = JKV.cache_len(window, S + budget)
        assert KV.cache_len(window, S + budget) == sc
        shape = (B, sc, jc.n_kv_heads, jc.head_dim)
        c_j = {"k": jnp.zeros(shape, dtype), "v": jnp.zeros(shape, dtype)}
        c_t = {"k": torch.zeros(shape, dtype=x_t.dtype),
               "v": torch.zeros(shape, dtype=x_t.dtype)}
        y_j, c_j = JL.attention(jc, p_j, x_j, jnp.asarray(pos), window,
                                SHARD, kv_cache=c_j)
        y_t, c_t = L.attention(tc, p_t, x_t, torch.from_numpy(pos), window,
                               kv_cache=c_t)
        close_as(dtype, y_t, y_j, f"prefill window={window}")
        for kv in ("k", "v"):
            close_as(dtype, c_t[kv], c_j[kv],
                     f"prefill cache window={window} {kv}")
        for step in range(budget):
            xd_j, xd_t = as_dtype(rng.normal(size=(B, 1, jc.d_model))
                                  .astype(np.float32), dtype)
            p = S + step
            y_j, c_j = JL.attention(jc, p_j, xd_j, jnp.asarray([p]), window,
                                    SHARD, kv_cache=c_j,
                                    decode_pos=jnp.int32(p))
            y_t, c_t = L.attention(tc, p_t, xd_t, torch.tensor([p]), window,
                                   kv_cache=c_t, decode_pos=p)
            close_as(dtype, y_t, y_j, f"decode window={window} pos={p}")
            for kv in ("k", "v"):
                close_as(dtype, c_t[kv], c_j[kv],
                         f"decode cache window={window} {kv}")


@both_dtypes(MOE_ARCHS)
def test_router_ids_match_repro(arch, dtype):
    jc, jp, tc, model = pair(arch, dtype=dtype)
    rng = np.random.default_rng(3)
    x_j, x_t = as_dtype(rng.normal(size=(64, jc.d_model)).astype(np.float32),
                        dtype)
    p_j = {k: v[0] for k, v in jp["segments"][0][0]["ffn"].items()}
    p_t = {k: torch.from_numpy(np.array(v)) for k, v in p_j.items()}
    g_j, i_j, w_j = JL.moe_router(p_j, x_j, jc.moe.top_k)
    g_t, i_t, w_t = L.moe_router(p_t, x_t, tc.moe.top_k)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    close_as(dtype, w_t, w_j, "top-k weights")
    close_as(dtype, g_t, g_j, "gates")
    # exact ties: duplicate router columns give equal logits; both take
    # the lower expert id first
    r = p_j["router"]
    tied = {**p_j, "router": jnp.concatenate([r[:, :1]] * r.shape[1], 1)}
    _, i_j, _ = JL.moe_router(tied, x_j, jc.moe.top_k)
    _, i_t, _ = L.moe_router({k: torch.from_numpy(np.array(v))
                              for k, v in tied.items()}, x_t, tc.moe.top_k)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    assert (i_t.numpy() == np.arange(tc.moe.top_k)).all()


@both_dtypes(MOE_ARCHS)
def test_moe_ragged_and_dense_match_repro(arch, dtype):
    jc, jp, tc, model = pair(arch, dtype=dtype)
    rng = np.random.default_rng(4)
    x_j, x_t = as_dtype(rng.normal(size=(2, 16, jc.d_model))
                        .astype(np.float32), dtype)
    p_j = {k: v[0] for k, v in jp["segments"][0][0]["ffn"].items()}
    p_t = {k: torch.from_numpy(np.array(v)) for k, v in p_j.items()}
    dense = L.moe_dense(tc, p_t, x_t)
    ragged = L.moe_ragged(tc, p_t, x_t)
    close_as(dtype, dense, JL.moe_dense(jc, p_j, x_j, SHARD), "moe_dense")
    close_as(dtype, ragged, JL.moe_ragged(jc, p_j, x_j, SHARD), "moe_ragged")
    if dtype == "float32":
        close(ragged, dense.detach().numpy(), "ragged vs dense")
    # "ragged_ep" runs moe_ragged on one device, as repro's does
    ep = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                         impl="ragged_ep"))
    assert torch.equal(L.ffn(ep, p_t, x_t), ragged)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_embed_mlp_logits_and_loss_match_repro_in_bf16(arch):
    """Each bfloat16 op on the same inputs: the embedding (rows cast,
    then scaled by sqrt(d_model) rounded to bfloat16, as repro's
    ``forward`` does), the dense or MoE FFN, the padded-vocabulary logits
    and the chunked loss (float32 logsumexp)."""
    jc, jp, tc, model = pair(arch, dtype="bfloat16")
    rng = np.random.default_rng(9)
    toks = tokens_of(rng, 2, 20)
    want = (jnp.take(jp["embed"], jnp.asarray(toks), axis=0)
            .astype(jnp.bfloat16)
            * jnp.asarray(jc.d_model ** 0.5, jnp.bfloat16))
    np.testing.assert_array_equal(
        _f32(T._embed(model, torch.from_numpy(toks))), _f32(want), "embed")
    h_j, h_t = as_dtype(rng.normal(size=(2, 20, jc.d_model))
                        .astype(np.float32), "bfloat16")
    p_j = {k: v[0] for k, v in jp["segments"][0][0]["ffn"].items()}
    p_t = {k: torch.from_numpy(np.array(v)) for k, v in p_j.items()}
    close_as("bfloat16", L.ffn(tc, p_t, h_t), JL.ffn(jc, p_j, h_j, SHARD),
             "ffn")
    logits_close("bfloat16", T._logits(model, h_t), JT._logits(jc, jp, h_j),
                 jc.vocab_size, "logits")
    labels = np.roll(toks, -1, 1)
    lj = float(JT.lm_loss(jc, jp, h_j, jnp.asarray(labels), SHARD))
    with torch.no_grad():
        lt = float(T.lm_loss(model, h_t, torch.from_numpy(labels)))
    np.testing.assert_allclose(lt, lj, rtol=1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers,dtype", [(3, "float32"), (14, "float32"),
                                            (3, "bfloat16")],
                         ids=["3", "14", "3-bf16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_loss_match_repro(arch, n_layers, dtype):
    """Hidden states and the chunked loss; 14 layers make several reps
    per segment and a remainder segment (gemma3: 2 x 6 + 1 x 2), so the
    port's layer order must be repro's scan order. In bfloat16 (the
    archs' configured dtype) the scalars, casts and activations round
    where repro's ops round."""
    jc, jp, tc, model = pair(arch, n_layers=n_layers, dtype=dtype)
    rng = np.random.default_rng(5)
    toks = tokens_of(rng, 2, 20)
    hj = exact_jit(lambda p, t: JT.forward(jc, p, t, SHARD))(
        jp, jnp.asarray(toks))
    close_as(dtype, T.forward(model, torch.from_numpy(toks)), hj, "hidden",
             whole_model=True)
    b = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    lj = float(exact_jit(lambda p, bb: JT.loss_fn(jc, p, bb, SHARD))(
        jp, {k: jnp.asarray(v) for k, v in b.items()}))
    with torch.no_grad():
        lt = float(T.loss_fn(model, {k: torch.from_numpy(v)
                                     for k, v in b.items()}))
    np.testing.assert_allclose(
        lt, lj, rtol=RTOL if dtype == "float32" else BF16_LOSS_RTOL)
    # the padded vocabulary is masked: logits and their chunks agree
    logits_close(dtype,
                 T._logits(model, T.forward(model, torch.from_numpy(toks))),
                 exact_jit(lambda p, h: JT._logits(jc, p, h))(jp, hj),
                 jc.vocab_size, "logits", whole_model=True)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_scalars_round_as_jax_weak_types(arch):
    """The q scale, the embedding scale and GELU's constants, rounded on
    the host, equal jnp's weak-typed scalars at the arch's full widths."""
    cfg = get_config(arch)
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32)):
        for v in (cfg.head_dim ** -0.5, cfg.d_model ** 0.5, 0.044715,
                  math.sqrt(2 / math.pi)):
            want = float(jnp.ones((), jdt) * v)
            assert L._round(v, tdt) == want, (arch, tdt, v)


def test_activations_round_as_jax_nn():
    """GELU and SiLU bit for bit as ``jax.nn``'s in bfloat16 (in float32
    the libraries' tanh and exp differ in the last place); SiLU's
    gradient stays finite where exp(-x) overflows, as lax.logistic's."""
    x = torch.linspace(-12, 12, 4097)
    for name, fn in (("gelu", jax.nn.gelu), ("silu", jax.nn.silu)):
        want = exact_jit(fn)(jnp.asarray(x.numpy(), jnp.bfloat16))
        got = L._act(name)(x.to(torch.bfloat16)).float().numpy()
        assert np.array_equal(got, np.asarray(want, np.float32)), name
        close(L._act(name)(x), exact_jit(fn)(jnp.asarray(x.numpy())), name)
    far = torch.tensor([-200.0, -100.0, 0.5, 100.0], requires_grad=True)
    L._act("silu")(far).sum().backward()
    close(far.grad, jax.grad(lambda v: jax.nn.silu(v).sum())(
        jnp.asarray(far.detach().numpy())), "silu gradient")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_gradients_match_repro(arch):
    """Every parameter's gradient of the loss, 8 layers (gemma3: a
    remainder segment), with the blocks and loss chunks under checkpoint
    (``remat``) as ``repro`` has them."""
    jc, jp, tc, model = pair(arch, n_layers=8)
    assert tc.remat
    rng = np.random.default_rng(8)
    toks = tokens_of(rng, 2, 20)
    b = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jg = jax.grad(lambda p: JT.loss_fn(
        jc, p, {k: jnp.asarray(v) for k, v in b.items()}, SHARD))(jp)
    T.loss_fn(model, {k: torch.from_numpy(v) for k, v in b.items()}
              ).backward()
    for name, want in zip(model.jax_leaf_names(), jax.tree.leaves(jg)):
        got = torch.stack([p.grad for p in model.jax_leaf_params(name)])
        close(got.reshape(want.shape), want, name, rtol=GRAD_RTOL,
              atol=GRAD_ATOL)


def test_layer_order_and_tree_names():
    cfg = reduced_lm(get_config, "gemma3-4b", n_layers=14)
    assert T.segment_plan(cfg) == [(2, (8,) * 5 + (0,)), (1, (8, 8))]
    order = T.layer_order(cfg)
    assert [(s, k, r) for s, k, r, _ in order[:7]] == [
        (0, 0, 0), (0, 1, 0), (0, 2, 0), (0, 3, 0), (0, 4, 0), (0, 5, 0),
        (0, 0, 1)]
    assert [w for *_, w in order] == [cfg.window_for_layer(i)
                                      for i in range(14)]
    jc = reduced_lm(jax_config, "gemma3-4b", n_layers=14)
    jp = JT.init_params(jc, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    names = ["/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                      for k in path) for path, _ in flat]
    model = T.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert model.jax_leaf_names() == names
    assert [tuple(x.shape) for x in model.to_jax_leaves()] == [
        tuple(x.shape) for _, x in flat]
    assert T.padded_vocab(cfg) == JT.padded_vocab(jc)


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma3-4b", "minicpm-2b"])
def test_q_chunked_attention_matches_repro(arch, monkeypatch):
    """ATTN_CHUNK_THRESHOLD/ATTN_CHUNK made small in both packages: the
    q-chunked path gives repro's chunked result and the port's unchunked
    one."""
    jc, jp, tc, model = pair(arch)
    rng = np.random.default_rng(6)
    toks = tokens_of(rng, 2, 16)
    whole = T.forward(model, torch.from_numpy(toks)).detach()
    for mod in (JL, L):
        monkeypatch.setattr(mod, "ATTN_CHUNK_THRESHOLD", 8)
        monkeypatch.setattr(mod, "ATTN_CHUNK", 4)
    hj = JT.forward(jc, jp, jnp.asarray(toks), SHARD)
    ht = T.forward(model, torch.from_numpy(toks))
    close(ht, hj, "chunked hidden")
    close(ht, whole.numpy(), "chunked vs whole")
    b = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    lj = float(JT.loss_fn(jc, jp, {k: jnp.asarray(v) for k, v in b.items()},
                          SHARD))
    with torch.no_grad():
        lt = float(T.loss_fn(model, {k: torch.from_numpy(v)
                                     for k, v in b.items()}))
    np.testing.assert_allclose(lt, lj, rtol=RTOL)


@both_dtypes(LM_ARCHS)
def test_prefill_ring_roll_then_decode_matches_repro(arch, dtype):
    """Prefill of S=20 past the 8-token window (the ring rolls by S % 8)
    with a budget of 5, then 5 greedy decode steps (the ring wraps):
    logits and caches equal repro's after every step. In bfloat16 the
    caches take the compute dtype, and each step starts from repro's
    caches, so the check reads one step's error and not five steps'
    compounded flips."""
    jc, jp, tc, model = pair(arch, dtype=dtype)
    rng = np.random.default_rng(7)
    toks = tokens_of(rng, 2, 20)
    budget = 5
    V = jc.vocab_size
    prefill = exact_jit(lambda p, t: JT.prefill_step(
        jc, p, {"tokens": t}, SHARD, decode_budget=budget))
    decode = exact_jit(lambda p, c, t, i: JT.decode_step(jc, p, c, t, i,
                                                         SHARD))
    lj, cj = prefill(jp, jnp.asarray(toks))
    lt, ct = T.prefill_step(model, {"tokens": torch.from_numpy(toks)},
                            decode_budget=budget)
    logits_close(dtype, lt, lj, V, "prefill logits", whole_model=True)
    caches_close(ct, cj, "prefill", dtype, whole_model=True)
    assert ct[0][0]["k"].dtype == T.compute_dtype(tc)
    for step in range(budget):
        # repro's greedy token feeds both packages
        nxt = np.array(jnp.argmax(lj[:, -1], -1)[:, None], np.int32)
        pos = 20 + step
        if dtype == "bfloat16":
            ct = [[{kv: torch.from_numpy(_f32(slot[kv])).to(torch.bfloat16)
                    for kv in ("k", "v")} for slot in seg] for seg in cj]
        lj, cj = decode(jp, cj, jnp.asarray(nxt), jnp.int32(pos))
        lt, ct = T.decode_step(model, ct, torch.from_numpy(nxt), pos)
        logits_close(dtype, lt, lj, V, f"decode logits pos={pos}",
                     whole_model=True)
        caches_close(ct, cj, f"decode pos={pos}", dtype, whole_model=True)


# ---------------------------------------------------------------------------
# the port's own copies of tests/test_archs.py's LM checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_decode_matches_forward(arch):
    rng = np.random.default_rng(0)
    cfg = reduced_lm(get_config, arch)
    model = T.init_params(cfg, torch.Generator().manual_seed(1),
                          device="cpu")
    tokens = torch.from_numpy(tokens_of(rng, 2, 12, cfg.vocab_size))
    _, caches = T.prefill_step(model, {"tokens": tokens}, decode_budget=4)
    nxt = torch.full((2, 1), 5, dtype=torch.int32)
    logits_d, _ = T.decode_step(model, caches, nxt, 12)
    with torch.no_grad():
        full = T.forward(model, torch.cat([tokens, nxt], 1))
        ref = T._logits(model, full[:, -1:])
    np.testing.assert_allclose(logits_d.numpy(), ref.numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    assert logits_d.shape == (2, 1, T.padded_vocab(cfg))


def test_moe_ragged_matches_dense():
    rng = np.random.default_rng(0)
    cfg = reduced_lm(get_config, "olmoe-1b-7b")
    cfg_r = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, impl="ragged"))
    model = T.init_params(cfg, torch.Generator().manual_seed(2),
                          device="cpu")
    tokens = torch.from_numpy(tokens_of(rng, 2, 16))
    b = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    with torch.no_grad():
        l_dense = T.loss_fn(model, b)
        model.cfg = cfg_r
        l_ragged = T.loss_fn(model, b)
    np.testing.assert_allclose(float(l_dense), float(l_ragged), rtol=1e-3)


def test_moe_ragged_gradients_match_dense():
    """The sorted dispatch's backward (index_select, per-expert products,
    index_add) gives the dense baseline's gradients."""
    rng = np.random.default_rng(1)
    cfg = reduced_lm(get_config, "granite-moe-1b-a400m")
    tokens = torch.from_numpy(tokens_of(rng, 2, 16))
    b = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    grads = {}
    for impl in ("dense", "ragged"):
        model = T.init_params(cfg, torch.Generator().manual_seed(3),
                              device="cpu")
        model.cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, impl=impl))
        T.loss_fn(model, b).backward()
        grads[impl] = {n: p.grad for n, p in model.named_parameters()}
    for n, g in grads["dense"].items():
        torch.testing.assert_close(grads["ragged"][n], g, rtol=1e-4,
                                   atol=1e-6, msg=n)
