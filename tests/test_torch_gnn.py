"""The port's GNN family (``repro_torch.models.gnn``) against ``repro``'s on
the CPU: ``tests/test_gnn_so3.py``'s SO(3) checks (spherical harmonics,
Wigner blocks and their three applications, ``rotation_to_z`` on the
degenerate rows, ``m_indices``), the segment softmax, both edge plans and
``partition_edges``, the fanout sampler bit for bit, and every model
function and the forward pass of ``tests/test_archs.py``'s reduced
EquiformerV2 with the fused rotation off and on, float32 and bfloat16
messages, plus rotation invariance.

Inputs are numpy arrays drawn from ``np.random.default_rng(seed)`` and
given to both packages; ``repro``'s weights come from a fixed JAX key and
the port holds them bit for bit (``params_from_jax``). No test changes
process-wide state: no JAX flag, no torch default dtype, no hypothesis
profile, no global RNG."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.gnn import equiformer_v2 as JE
from repro.models.gnn import graph as JG
from repro.models.gnn import sampler as JSMP
from repro.models.gnn import so3 as JS
from repro_torch.configs import get_config
from repro_torch.models.gnn import equiformer_v2 as E
from repro_torch.models.gnn import graph as G
from repro_torch.models.gnn import sampler as SMP
from repro_torch.models.gnn import so3 as S

torch.set_num_threads(1)

# float32, one op or the 2-layer model: XLA and PyTorch reorder float32
# sums (einsum contractions, the segment sums). Observed: SH and Wigner
# blocks <= 3e-7 up to l_max 6, the forward <= 7.2e-7 on outputs ~3.
RTOL, ATOL = 1e-5, 1e-5
# rotation invariance of the l=0 outputs (tests/test_archs.py's limits)
INV_RTOL, INV_ATOL = 1e-3, 1e-4
# bfloat16 messages: repro jitted with every op rounded to its dtype
# (EXACT), as the port rounds it. A float32 product whose last bit differs
# between the two libraries flips a bfloat16 result now and then, and the
# flip spreads. Measured over 6 seeds at the reduced size: the model's
# mean |port - repro| / mean |repro| 4.7e-5 to 2.6e-4 (fused and unfused
# alike); a port keeping the messages float32 sits at 8.2e-4 to 1.8e-3.
# One interaction on the same inputs: see test_interaction_matches_repro.
BF16_MODEL_REL = 5e-4
BF16_STEP = 2 ** -7
EXACT = {"xla_allow_excess_precision": False}
N, EG, F, N_OUT = 24, 80, 10, 5


def exact_jit(fn):
    """``fn`` under jit with every op rounded to its dtype, as JAX's
    op-by-op semantics (and the port) round it."""
    return jax.jit(fn, compiler_options=EXACT)


def reduced(get, **over):
    """``tests/test_archs.py``'s ``reduced_gnn`` (2 layers, d 16, l_max 3,
    m_max 2, 4 heads, rbf 8, no remat) from either package's registry."""
    kw = dict(n_layers=2, d_hidden=16, l_max=3, m_max=2, n_heads=4,
              d_edge_rbf=8, remat=False)
    kw.update(over)
    return dataclasses.replace(get("equiformer-v2"), **kw)


@functools.lru_cache(maxsize=None)
def jax_params(seed: int, f: int = F, n_out: int = N_OUT) -> dict:
    """``repro``'s weights of the reduced model from ``PRNGKey(seed)``,
    as numpy (``msg_dtype`` and ``fused_rotation`` change no weight);
    jitted, one compile."""
    init = jax.jit(JE.init_params, static_argnums=(0, 2, 3))
    return jax.tree.map(np.array, init(reduced(jax_config),
                                       jax.random.PRNGKey(seed), f, n_out))


def both(seed=0, **over):
    """(port cfg, repro cfg, port model, repro params as numpy)."""
    cfg, jcfg = reduced(get_config, **over), reduced(jax_config, **over)
    jp = jax_params(seed)
    return cfg, jcfg, E.params_from_jax(cfg, jp, device="cpu"), jp


def graph_inputs(rng, n=N, e=EG, f=F):
    """src, dst (int32, self-loops included by chance), feat, pos."""
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    src[:2] = dst[:2]                      # two zero-length edges
    feat = rng.normal(size=(n, f)).astype(np.float32)
    pos = (rng.normal(size=(n, 3)) * 2).astype(np.float32)
    return src, dst, feat, pos


def plans(src, dst, n=N, mask=None):
    mask = np.ones(len(src), bool) if mask is None else mask
    return (G.LocalEdges(torch.as_tensor(src), torch.as_tensor(dst),
                         torch.as_tensor(mask), n),
            JG.LocalEdges(jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(mask), n))


def rotation(rng) -> np.ndarray:
    """A random proper rotation (``conftest.rand_rotation``'s recipe)."""
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def unit(rng, shape):
    v = rng.normal(size=shape + (3,))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def layer0(jp):
    return jax.tree.map(lambda a: a[0], jp["layers"])


def close(got, want, what, rtol=RTOL, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def bf16_close(got, want, what, rel=BF16_MODEL_REL):
    """Mean |got - want| / mean |want| within ``rel`` and every element
    within 8 bfloat16 steps of the largest magnitude."""
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = np.abs(want).mean()
    assert np.abs(got - want).mean() <= rel * scale, (
        what, np.abs(got - want).mean() / scale)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=8 * BF16_STEP * np.abs(want).max(),
                               err_msg=what)


# ---------------------------------------------------------------------------
# configs, SH and Wigner rotations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l_max", [1, 3, 6])
def test_sph_harm_matches_repro(l_max):
    v = unit(np.random.default_rng(l_max), (64,))
    close(S.sph_harm(torch.as_tensor(v), l_max),
          jax.jit(JS.sph_harm, static_argnums=1)(v, l_max),
          f"sph_harm l_max {l_max}")
    for fn in ("_k_norm", "_sample_dirs"):
        np.testing.assert_array_equal(getattr(S, fn)(l_max),
                                      getattr(JS, fn)(l_max))
    for got, want in zip(S._pinv_table(l_max)[0], JS._pinv_table(l_max)[0]):
        np.testing.assert_array_equal(got, want)


def test_sph_harm_orthonormal():
    """``test_gnn_so3.py``'s Monte-Carlo check, on the port."""
    v = np.random.default_rng(1).normal(size=(100_000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    Y = S.sph_harm(torch.as_tensor(v, dtype=torch.float32), 3).numpy()
    Gm = (Y.T @ Y) / len(v) * 4 * np.pi
    assert np.abs(Gm - np.eye(Gm.shape[0])).max() < 0.02   # MC noise bound


@pytest.mark.parametrize("l_max", [1, 2, 4, 6])
def test_wigner_blocks_match_repro(l_max):
    """Each D^l against ``repro``'s, and ``test_gnn_so3.py``'s property on
    the port: Y(R r) == D(R) Y(r), D orthogonal."""
    rng = np.random.default_rng(10 + l_max)
    R = np.stack([rotation(rng) for _ in range(4)]).astype(np.float32)
    r = unit(rng, (4,))
    blocks = S.wigner_blocks(torch.as_tensor(R), l_max)
    want_blocks = jax.jit(JS.wigner_blocks, static_argnums=1)(R, l_max)
    for l, (got, want) in enumerate(zip(blocks, want_blocks)):
        close(got, want, f"D^{l}")
    Yr = S.sph_harm(torch.as_tensor(np.einsum("bij,bj->bi", R, r)), l_max)
    Y0 = S.sph_harm(torch.as_tensor(r), l_max)
    for l, D in enumerate(blocks):
        lhs = Yr[:, l * l:(l + 1) ** 2]
        rhs = torch.einsum("bnm,bm->bn", D, Y0[:, l * l:(l + 1) ** 2])
        np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=5e-5)
        orth = torch.einsum("bnm,bkm->bnk", D, D).numpy()
        np.testing.assert_allclose(orth, np.broadcast_to(
            np.eye(2 * l + 1), orth.shape), atol=5e-5)


def test_wigner_composition():
    """D(R1 R2) == D(R1) D(R2) on the port (``test_gnn_so3.py``)."""
    rng = np.random.default_rng(2)
    R1, R2 = (torch.as_tensor(rotation(rng)[None], dtype=torch.float32)
              for _ in range(2))
    b12 = S.wigner_blocks(torch.einsum("bij,bjk->bik", R1, R2), 4)
    b1, b2 = S.wigner_blocks(R1, 4), S.wigner_blocks(R2, 4)
    for l in range(5):
        np.testing.assert_allclose(b12[l][0].numpy(),
                                   (b1[l][0] @ b2[l][0]).numpy(), atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_wigner_variants_match_repro(dtype):
    """``apply_wigner`` both ways, the fused truncation and expansion, on
    the same blocks and coefficients (cast as the model casts them); the
    fused pair equals take(keep) of the full rotation, and rotating back
    is the identity (``test_gnn_so3.py``'s round trip)."""
    rng = np.random.default_rng(3)
    lm, mm = 4, 2
    R = np.stack([rotation(rng) for _ in range(6)]).astype(np.float32)
    x = rng.normal(size=(6, 25, 8)).astype(np.float32)
    keep = S.m_indices(lm, mm)["keep"]
    t = rng.normal(size=(6, len(keep), 8)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    tb = [b.to(tdt) for b in S.wigner_blocks(torch.as_tensor(R), lm)]
    jb = [b.astype(jdt) for b in jax.jit(JS.wigner_blocks,
                                         static_argnums=1)(R, lm)]
    tx, jx = torch.as_tensor(x).to(tdt), jnp.asarray(x, jdt)
    tt, jt = torch.as_tensor(t).to(tdt), jnp.asarray(t, jdt)
    cases = {
        "apply": (S.apply_wigner(tb, tx),
                  exact_jit(JS.apply_wigner)(jb, jx)),
        "apply^T": (S.apply_wigner(tb, tx, transpose=True),
                    exact_jit(lambda b, c: JS.apply_wigner(
                        b, c, transpose=True))(jb, jx)),
        "trunc": (S.apply_wigner_trunc(tb, tx, lm, mm),
                  exact_jit(lambda b, c: JS.apply_wigner_trunc(
                      b, c, lm, mm))(jb, jx)),
        "expand": (S.apply_wigner_expand(tb, tt, lm, mm),
                   exact_jit(lambda b, c: JS.apply_wigner_expand(
                       b, c, lm, mm))(jb, jt)),
    }
    for name, (got, want) in cases.items():
        if dtype == "float32":
            close(got, want, name)
        else:   # one op on the same bf16 inputs: within one bf16 step
            close(got, want, name, rtol=BF16_STEP, atol=BF16_STEP)
    if dtype == "float32":
        full = S.apply_wigner(tb, tx)
        close(cases["trunc"][0], full[:, keep].numpy(), "trunc == take")
        back = S.apply_wigner(tb, full, transpose=True)
        np.testing.assert_allclose(back.numpy(), x, atol=1e-5)


_jax_rotation_to_z = jax.jit(JS.rotation_to_z)


@pytest.mark.parametrize("seed", range(30))
def test_rotation_to_z_degenerate_rows(seed):
    """``test_gnn_so3.py``'s property over 30 fixed seeds: R v_hat = z and
    det R = 1, with +z, -z and [1e-12, 0, 1] in every batch; R equals
    ``repro``'s."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(8, 3)).astype(np.float32)
    v[0] = [0, 0, 1]
    v[1] = [0, 0, -1]
    v[2] = [1e-12, 0, 1]              # near-degenerate
    R = S.rotation_to_z(torch.as_tensor(v)).numpy()
    close(R, _jax_rotation_to_z(v), f"seed {seed}")
    vn = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
    out = np.einsum("bij,bj->bi", R, vn)
    np.testing.assert_allclose(out, np.tile([0, 0, 1.0], (8, 1)), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)
    np.testing.assert_array_equal(R[0], np.eye(3))
    np.testing.assert_array_equal(R[1], np.diag([1.0, -1.0, -1.0]))


@pytest.mark.parametrize("l_max,m_max", [(6, 2), (3, 2), (4, 1), (2, 3)])
def test_m_indices_identical(l_max, m_max):
    a, b = S.m_indices(l_max, m_max), JS.m_indices(l_max, m_max)
    for k in ("keep", "m0"):
        np.testing.assert_array_equal(a[k], b[k])
    for k in ("cos", "sin"):
        assert a[k].keys() == b[k].keys()
        for m in a[k]:
            np.testing.assert_array_equal(a[k][m], b[k][m])
    assert S.n_keep(l_max, m_max) == JS.n_keep(l_max, m_max)
    if (l_max, m_max) == (6, 2):
        assert S.n_keep(6, 2) == 29 and len(a["m0"]) == 7
        assert (np.diff(a["keep"]) > 0).all() and a["keep"][-1] < 49


# ---------------------------------------------------------------------------
# segment ops and edge plans
# ---------------------------------------------------------------------------

def test_segment_softmax_matches_repro():
    """Masks, a segment whose edges are all masked and segments with no
    edge at all; weights and the gradient of a weighted sum of them."""
    rng = np.random.default_rng(4)
    n, e = 12, 50
    seg = rng.integers(0, 9, e).astype(np.int32)     # segments 9-11 empty
    seg[seg == 3] = 4
    seg[:3] = 3                                      # segment 3: all masked
    mask = rng.random(e) > 0.3
    mask[:3] = False
    scores = (rng.normal(size=(e, 4)) * 3).astype(np.float32)
    r = rng.normal(size=(e, 4)).astype(np.float32)
    ts = torch.as_tensor(scores).requires_grad_(True)
    w = G.segment_softmax(ts, torch.as_tensor(seg), n, torch.as_tensor(mask))
    (w * torch.as_tensor(r)).sum().backward()

    def jloss(s):
        wj = JG.segment_softmax(s, jnp.asarray(seg), n, jnp.asarray(mask))
        return jnp.sum(wj * r), wj
    (_, wj), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(scores))
    close(w, wj, "weights")
    close(ts.grad, gj, "d weights")
    sums = G.segment_sum(w.detach(), torch.as_tensor(seg), n).numpy()
    live = np.zeros(n, bool)
    live[seg[mask]] = True
    np.testing.assert_allclose(sums[live], 1.0, rtol=1e-6)
    assert (sums[~live] == 0).all() and (w.detach().numpy()[~mask] == 0).all()
    # no mask: every edge counts
    close(G.segment_softmax(torch.as_tensor(scores), torch.as_tensor(seg), n),
          jax.jit(lambda s: JG.segment_softmax(s, jnp.asarray(seg), n))(
              jnp.asarray(scores)), "unmasked")


def test_local_edges_match_repro():
    """Gathers, edge vectors and the masked aggregation (``valid`` and the
    plan's own mask), float32 and bfloat16 messages."""
    rng = np.random.default_rng(5)
    src, dst, _, pos = graph_inputs(rng)
    mask = rng.random(EG) > 0.2
    tp, jp_ = plans(src, dst, mask=mask)
    x = rng.normal(size=(N, 7, 3)).astype(np.float32)
    msgs = rng.normal(size=(EG, 7, 3)).astype(np.float32)
    valid = rng.random(EG) > 0.1
    np.testing.assert_array_equal(tp.gather_src(torch.as_tensor(x)).numpy(),
                                  np.asarray(jp_.gather_src(x)))
    np.testing.assert_array_equal(tp.gather_dst(torch.as_tensor(x)).numpy(),
                                  np.asarray(jp_.gather_dst(x)))
    np.testing.assert_array_equal(tp.recv_dvec(torch.as_tensor(pos)).numpy(),
                                  np.asarray(jp_.recv_dvec(pos)))
    for dt in ("float32", "bfloat16"):
        tm = torch.as_tensor(msgs).to(getattr(torch, dt))
        jm = jnp.asarray(msgs, dt)
        for v in (None, valid):
            got = tp.aggregate(tm, None if v is None else torch.as_tensor(v))
            want = exact_jit(lambda m: jp_.aggregate(
                m, None if v is None else jnp.asarray(v)))(jm)
            close(got, want, f"aggregate {dt} valid={v is not None}",
                  **({} if dt == "float32" else
                     dict(rtol=BF16_STEP, atol=BF16_STEP)))


def test_sharded_edges_one_shard_match_local():
    """``tests/test_archs.py``'s check on the port: the vertex-cut plan of
    one shard gives the plain COO plan's forward; ``partition_edges``'
    arrays equal ``repro``'s at 1, 2 and 3 shards (a cap that drops
    edges included); ``exchange`` across 2 shards raises outside a
    ``shard_map`` body, with or without the plan's axis names."""
    rng = np.random.default_rng(6)
    n, e = 16, 60
    src = rng.integers(0, n, e).astype(np.int64)
    dst = rng.integers(0, n, e).astype(np.int64)
    for shards, cap in ((1, None), (2, None), (3, 4)):
        got = G.partition_edges(src, dst, n, shards, cap)
        want = JG.partition_edges(src, dst, n, shards, cap)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert G.partition_edges(src, dst, n, 3, 4)["dropped"] > 0
    cfg, jcfg, model, jp = both()
    feat = rng.normal(size=(n, F)).astype(np.float32)
    pos = (rng.normal(size=(n, 3)) * 2).astype(np.float32)
    local = G.LocalEdges(torch.as_tensor(src), torch.as_tensor(dst),
                         torch.ones(e, dtype=torch.bool), n)
    parts = G.partition_edges(src, dst, n, 1)
    sharded = G.ShardedEdges(
        **{k: torch.as_tensor(parts[k][0]) for k in
           ("esrc", "edstg", "emask", "rdst", "rsrcg", "rmask")},
        n_local=n, shard_offset=0)
    with torch.no_grad():
        out_local = E.forward(cfg, model, local, torch.as_tensor(feat),
                              torch.as_tensor(pos))
        out_sharded = E.forward(cfg, model, sharded, torch.as_tensor(feat),
                                torch.as_tensor(pos))
    np.testing.assert_allclose(out_sharded.numpy(), out_local.numpy(),
                               rtol=RTOL, atol=ATOL)
    close(out_local, jax.jit(lambda p, f, ps: JE.forward(
        jcfg, p, JG.LocalEdges(jnp.asarray(src, jnp.int32),
                               jnp.asarray(dst, jnp.int32),
                               jnp.ones(e, bool), n), f, ps))(jp, feat, pos),
          "local vs repro")
    two = G.partition_edges(src, dst, n, 2)
    for axes, msg in (((), "2 shards needs the mesh axes"),
                      (("data",), "2 shards is an all_to_all over "
                                  r"\('data',\): call it inside a shard_map")):
        sh2 = G.ShardedEdges(
            **{k: torch.as_tensor(two[k][0]) for k in
               ("esrc", "edstg", "emask", "rdst", "rsrcg", "rmask")},
            n_local=8, shard_offset=0, axis_names=axes)
        with pytest.raises(RuntimeError, match=msg):
            sh2.exchange(torch.zeros(2, two["cap"], 3))


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampler_bit_for_bit(seed):
    """``random_graph``, ``CSRGraph.from_coo`` and ``sample_subgraph`` from
    one generator state: every array equal to ``repro``'s, and
    ``test_archs.py``'s sampler properties."""
    out = {}
    for name, mod in (("port", SMP), ("repro", JSMP)):
        rng = np.random.default_rng(seed)
        src, dst = mod.random_graph(500, 8, rng)
        g = mod.CSRGraph.from_coo(src, dst, 500)
        seeds = rng.choice(500, 32, replace=False)
        out[name] = (src, dst, g, seeds,
                     mod.sample_subgraph(g, seeds, (5, 3), rng))
    (src, dst, g, seeds, sub), (jsrc, jdst, jg, jseeds, jsub) = (
        out["port"], out["repro"])
    for a, b in ((src, jsrc), (dst, jdst), (g.indptr, jg.indptr),
                 (g.indices, jg.indices), (seeds, jseeds)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert sub.keys() == jsub.keys()
    for k in sub:
        np.testing.assert_array_equal(sub[k], jsub[k], err_msg=k)
    n, e = int(sub["node_mask"].sum()), int(sub["edge_mask"].sum())
    assert n >= 32 and 0 < e <= 32 * 5 + 32 * 5 * 3
    assert sub["src"][:e].max() < n and sub["dst"][:e].max() < n
    np.testing.assert_array_equal(sub["nodes"][:32], seeds)
    for k in range(min(e, 50)):
        u, v = sub["nodes"][sub["src"][k]], sub["nodes"][sub["dst"][k]]
        assert u in g.neighbors(v)
    for shape in ((1024, (15, 10)), (32, (5, 3))):
        assert SMP.max_subgraph_shape(*shape) == JSMP.max_subgraph_shape(
            *shape)
    assert SMP.max_subgraph_shape(1024, (15, 10)) == (169984, 168960)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_building_blocks_match_repro():
    """``eq_layernorm``, ``gate_act`` (over kept and full components),
    ``radial_gain`` (its RBF centres equal ``jnp.linspace``'s bit for
    bit), ``so2_conv``, ``per_l_linear``, ``ffn_block`` and
    ``embed_nodes``, float32, on layer 0's weights."""
    cfg, jcfg, model, jp = both()
    rng = np.random.default_rng(7)
    lp, jl = model.layers[0], layer0(jp)
    nk = S.n_keep(cfg.l_max, cfg.m_max)
    x = rng.normal(size=(N, 16, 16)).astype(np.float32)
    xk = rng.normal(size=(EG, nk, 16)).astype(np.float32)
    dist = np.abs(rng.normal(size=EG) * 4).astype(np.float32)
    tx, txk = torch.as_tensor(x), torch.as_tensor(xk)
    np.testing.assert_array_equal(E._rbf_centers(8, 8.0),
                                  np.asarray(jnp.linspace(0.0, 8.0, 8)))
    np.testing.assert_array_equal(E._rbf_centers(32, 8.0),
                                  np.asarray(jnp.linspace(0.0, 8.0, 32)))
    lof = E._meta(cfg.l_max, cfg.m_max, torch.device("cpu"))["lof"]
    lkeep = E._meta(cfg.l_max, cfg.m_max, torch.device("cpu"))["lkeep"]
    src, dst, feat, pos = graph_inputs(rng)
    tp, jpl = plans(src, dst)

    @jax.jit
    def jax_side(jl, jp, x, xk, dist, feat, pos):
        return {
            "eq_layernorm": JE.eq_layernorm(x, jl["ln1"] * 1.5, jcfg),
            "gate_act kept": JE.gate_act(xk, jl["gate_edge"],
                                         JE._l_of_keep(3, 2), jcfg),
            "gate_act full": JE.gate_act(x, jl["gate_ffn"],
                                         JE._l_of_comp(3), jcfg),
            "radial_gain": JE.radial_gain(jl["rad_src"], dist, jcfg),
            "so2_conv": JE.so2_conv(jl["conv_val"], xk, jcfg),
            "per_l_linear": JE.per_l_linear(jl["proj"], x, jcfg),
            "ffn_block": JE.ffn_block(jcfg, jl, x),
            "embed_nodes": JE.embed_nodes(jcfg, jp, jpl, feat, pos)}
    want = jax_side(jl, jp, x, xk, dist, feat, pos)
    cases = {
        "eq_layernorm": E.eq_layernorm(tx, lp["ln1"] * 1.5, cfg),
        "gate_act kept": E.gate_act(txk, lp["gate_edge"], lkeep, cfg),
        "gate_act full": E.gate_act(tx, lp["gate_ffn"], lof, cfg),
        "radial_gain": E.radial_gain(lp["rad_src"], torch.as_tensor(dist),
                                     cfg),
        "so2_conv": E.so2_conv(lp["conv_val"], txk, cfg),
        "per_l_linear": E.per_l_linear(lp["proj"], tx, cfg),
        "ffn_block": E.ffn_block(cfg, lp, tx),
        "embed_nodes": E.embed_nodes(cfg, model, tp, torch.as_tensor(feat),
                                     torch.as_tensor(pos))}
    for name, got in cases.items():
        close(got, want[name], name)


@pytest.mark.parametrize("fused", [False, True])
def test_interaction_matches_repro(fused):
    """One interaction layer, float32 and bfloat16 messages. bfloat16 on
    the same inputs, measured over 6 seeds: 95.9-100% of outputs bit for
    bit, the rest within 0.25% of the layer's largest update; held at 90%
    and one bfloat16 step (0.78%)."""
    rng = np.random.default_rng(8)
    src, dst, _, pos = graph_inputs(rng)
    x = rng.normal(size=(N, 16, 16)).astype(np.float32)
    for dt in ("float32", "bfloat16"):
        cfg, jcfg, model, jp = both(fused_rotation=fused, msg_dtype=dt)
        tp, jpl = plans(src, dst)
        with torch.no_grad():
            got = E.interaction(cfg, model.layers[0], tp, torch.as_tensor(x),
                                torch.as_tensor(pos))
        want = exact_jit(lambda p, xx, ps: JE.interaction(
            jcfg, p, jpl, xx, ps))(layer0(jp), x, pos)
        if dt == "float32":
            close(got, want, "interaction f32")
        else:
            want = np.asarray(want)
            upd = np.abs(want - x).max()
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=BF16_STEP * upd)
            assert np.mean(got.numpy() == want) >= 0.9


@pytest.mark.parametrize("msg_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
def test_forward_matches_repro(fused, msg_dtype):
    """The 2-layer model's forward with zero-length edges and a plan mask;
    float32 within RTOL/ATOL, bfloat16 messages within BF16_MODEL_REL of
    ``repro`` jitted EXACT (and the port's float32 forward farther)."""
    rng = np.random.default_rng(9)
    src, dst, feat, pos = graph_inputs(rng)
    mask = np.ones(EG, bool)
    mask[5:9] = False
    cfg, jcfg, model, jp = both(fused_rotation=fused, msg_dtype=msg_dtype)
    tp, jpl = plans(src, dst, mask=mask)
    with torch.no_grad():
        got = E.forward(cfg, model, tp, torch.as_tensor(feat),
                        torch.as_tensor(pos))
    want = exact_jit(lambda p, f, ps: JE.forward(jcfg, p, jpl, f, ps))(
        jp, feat, pos)
    assert got.shape == (N, N_OUT) and torch.isfinite(got).all()
    if msg_dtype == "float32":
        close(got, want, "forward f32")
        return
    bf16_close(got, want, "forward bf16")
    f32 = dataclasses.replace(cfg, msg_dtype="float32")
    with torch.no_grad():
        away = E.forward(f32, model, tp, torch.as_tensor(feat),
                         torch.as_tensor(pos)).numpy()
    want = np.asarray(want)
    assert (np.abs(away - want).mean()
            > BF16_MODEL_REL * np.abs(want).mean())


def test_fused_rotation_equals_unfused():
    """The fused truncation/expansion is exact: same forward (float32)."""
    rng = np.random.default_rng(10)
    src, dst, feat, pos = graph_inputs(rng)
    outs = []
    for fused in (False, True):
        cfg, _, model, _ = both(fused_rotation=fused)
        tp, _ = plans(src, dst)
        with torch.no_grad():
            outs.append(E.forward(cfg, model, tp, torch.as_tensor(feat),
                                  torch.as_tensor(pos)).numpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fused", [False, True])
def test_rotation_invariance(fused):
    """``tests/test_archs.py``'s check on the port: the l=0 outputs do not
    move under a global rotation of the positions."""
    rng = np.random.default_rng(11)
    n, e, f = 20, 60, 12
    cfg = reduced(get_config, fused_rotation=fused)
    model = E.init_params(cfg, f, N_OUT, torch.Generator().manual_seed(0),
                          device="cpu")
    src, dst, feat, pos = graph_inputs(rng, n, e, f)
    tp, _ = plans(src, dst, n)
    R = torch.as_tensor(rotation(rng), dtype=torch.float32)
    with torch.no_grad():
        out = E.forward(cfg, model, tp, torch.as_tensor(feat),
                        torch.as_tensor(pos))
        out_r = E.forward(cfg, model, tp, torch.as_tensor(feat),
                          torch.as_tensor(pos) @ R.T)
    np.testing.assert_allclose(out.numpy(), out_r.numpy(), rtol=INV_RTOL,
                               atol=INV_ATOL)
