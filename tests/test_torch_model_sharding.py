"""The explicit per-shard bodies of the model families on a 4-position CPU
mesh: ``lookup_shardmap``, the two-level top-k and ``retrieval_step``
over it, the expert-parallel ``moe_ragged_ep`` (alone and in a 2-layer
LM), the vertex-cut forward, loss and gradients at S = 4, and the cells
that run these bodies (the GNN minibatch cell at dp = tp = 2, the
vertex-cut cell at S = 4, the MoE LM's ``opt`` train cell) against
``repro``'s ``build_cell`` with a mesh.

``repro``'s references run in ONE subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, on inputs this
module makes with numpy from a seed (``repro``'s weights come back in
the ``.npz`` as leaves and load into the port's models bit for bit).

Tolerances: ids exact (ties break to the lower id in both); values rtol
1e-5, atol 1e-6; gradients rtol 1e-3, atol 1e-6; the GNN cells' bfloat16
messages and the train steps as ``tests/test_torch_cells_gnn.py`` and
``tests/test_torch_cells.py`` hold them."""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.distributed import shard_map as SM
from repro_torch.distributed.sharding import (Sharded, ShardingPolicy,
                                              device_put)
from repro_torch.launch import cells as TC
from repro_torch.launch import train as TR
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.gnn import equiformer_v2 as E
from repro_torch.models.gnn.graph import LocalEdges, partition_edges
from repro_torch.models.recsys import embedding as EMB
from repro_torch.models.recsys import nets as R
from repro_torch.kernels.maxsim.ref import top_k as sorted_top_k
from test_torch_cells import (NOISE_FLOOR, PARAM_LR_FRAC, STEP_RTOL,
                              _check_step, _gen)
from test_torch_cells_gnn import GNN_NOISE_REL, GNN_REL
from test_torch_gnn import reduced as gnn_reduced

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = dict(rtol=1e-5, atol=1e-6)
GTOL = dict(rtol=1e-3, atol=1e-6)
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}
LAYOUT = ((1201, 50, 2002), 8, 1000)      # big fields 0 and 2: 3203 rows
TOPK_CASES = [(m, k) for m in ("2x2", "1x4", "4x1") for k in (5, 20)]
MOE_CASES = ("2x2", "1x4", "4x1", "1x4_skewed")
MOE_ARCH = "granite-moe-1b-a400m"
GNN_S, GNN_N, GNN_E, GNN_F, GNN_OUT = 4, 24, 80, 10, 5
GNN_CAP = 16


def port_mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def weight(shape) -> np.ndarray:
    n = int(np.prod(shape))
    return np.cos(np.arange(n) * 0.7 + 0.3).astype(np.float32).reshape(shape)


def lm_cfg(get, reduce=TR.reduced_lm):
    """The reduced granite-moe (4 experts top 2) with ``ragged_ep``."""
    cfg = reduce(get(MOE_ARCH))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl="ragged_ep"))


def gnn_cfg(get):
    """The GNN tests' reduced config in float32 with remat on, so the
    vertex cut's exchange runs inside checkpointed layers."""
    return gnn_reduced(get, remat=True)


def gnn_cell_cfg(get):
    """The cells' config: one layer of the same (the cells add bfloat16
    messages and the train step)."""
    return gnn_reduced(get, remat=True, n_layers=1)


# ---------------------------------------------------------------------------
# inputs (numpy, from seeds)
# ---------------------------------------------------------------------------

def inputs() -> dict:
    r = np.random.default_rng(21)
    x = {}
    x["emb_idx"] = np.stack([r.integers(0, 1201, 32), r.integers(0, 50, 32),
                             r.integers(0, 2002, 32)], 1).astype(np.int32)
    x["topk_scores"] = r.integers(0, 6, 64).astype(np.float32)
    # the MoE layer: tokens and, for the skewed case, a router that sends
    # every token to expert 0 first (its owner drops past capacity)
    x["moe_x"] = r.normal(size=(4, 8, 128)).astype(np.float32)
    u = r.normal(size=128).astype(np.float32)
    x["moe_u"] = u / np.linalg.norm(u)
    x["lm_tokens"] = r.integers(0, 512, (4, 8)).astype(np.int32)
    x["lm_labels"] = r.integers(0, 512, (4, 8)).astype(np.int32)
    x["cell_tokens"] = r.integers(0, 512, (16, 8)).astype(np.int32)
    x["cell_labels"] = r.integers(0, 512, (16, 8)).astype(np.int32)
    # the vertex cut: 24 nodes, 80 edges over 4 shards
    src = r.integers(0, GNN_N, GNN_E).astype(np.int32)
    dst = r.integers(0, GNN_N, GNN_E).astype(np.int32)
    part = partition_edges(src, dst, GNN_N, GNN_S, cap=GNN_CAP)
    assert part["dropped"] == 0
    x.update({"vc_src": src, "vc_dst": dst,
              "vc_feat": r.normal(size=(GNN_N, GNN_F)).astype(np.float32),
              "vc_pos": r.uniform(-2, 2, (GNN_N, 3)).astype(np.float32),
              "vc_labels": r.integers(0, GNN_OUT, GNN_N).astype(np.int32),
              "vc_lmask": r.random(GNN_N) > 0.25})
    for k in ("esrc", "edstg", "emask", "rdst", "rsrcg", "rmask"):
        x["vc_" + k] = part[k]
    # the minibatch cell: 2 subgraphs of 28 nodes, each vertex-cut over 2
    mb = {k: [] for k in ("esrc", "edstg", "emask", "rdst", "rsrcg",
                          "rmask")}
    for _ in range(2):
        s, d = (r.integers(0, 28, 24).astype(np.int32) for _ in range(2))
        p = partition_edges(s, d, 28, 2, cap=16)
        assert p["dropped"] == 0
        for k in mb:
            mb[k].append(p[k])
    x.update({"mb_feat": r.normal(size=(2, 28, 10)).astype(np.float32),
              "mb_pos": r.uniform(-2, 2, (2, 28, 3)).astype(np.float32),
              "mb_labels": r.integers(0, 41, (2, 28)).astype(np.int32),
              "mb_lmask": r.random((2, 28)) > 0.25,
              **{"mb_" + k: np.stack(v) for k, v in mb.items()}})
    # the vertex-cut cell at S = 4 (the 24-node graph, 47 classes)
    x["vcc_labels"] = r.integers(0, 47, GNN_N).astype(np.int32)
    # the recsys candidate search: one dcn-v2 user, 512 candidates
    x["rs_sparse"] = r.integers(0, 50, (1, 26)).astype(np.int32)
    x["rs_dense"] = r.normal(size=(1, 13)).astype(np.float32)
    x["rs_cand"] = r.integers(0, 50, 512).astype(np.int32)
    x["rs_proxy"] = r.normal(size=(512, 16)).astype(np.float32)
    return x


def recsys_cfg(get):
    from test_torch_recsys import reduced
    return reduced(get, "dcn-v2")


_PRELUDE = r"""
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
sys.path.insert(0, os.path.dirname(sys.argv[3]))
from repro.configs import get_config, ShapeSpec
from repro.launch import cells as JC
from repro.launch.mesh import make_mesh
from repro.distributed.sharding import ShardingPolicy
from repro.models import layers as JL, transformer as JT
from repro.models.gnn import equiformer_v2 as JE
from repro.models.gnn.graph import ShardedEdges
from repro.models.recsys import embedding as JEMB, nets as JR
from repro.training import optimizer as JOPT
import test_torch_model_sharding as M
from test_torch_gnn import EXACT

assert len(jax.devices()) == 4
x = dict(np.load(sys.argv[1]))
out = {}
meshes = {k: make_mesh(*v) for k, v in M.MESHES.items()}
leaves = lambda t: [np.asarray(l) for l in jax.tree.leaves(t)]
def save_leaves(prefix, t):
    for i, l in enumerate(leaves(t)):
        out[f"{prefix}/{i}"] = l

from repro.launch.train import reduced_lm
lcfg = M.lm_cfg(get_config, reduced_lm)
lp = jax.jit(JT.init_params, static_argnums=0)(lcfg, jax.random.PRNGKey(6))
keys = ("esrc", "edstg", "emask", "rdst", "rsrcg", "rmask")

"""

# the two halves of the references, traced in two threads of the one
# subprocess (XLA compiles and runs them side by side; the cells take the
# most)
_PARTS = {"a": r"""# lookup_shardmap, mirroring tests/test_archs.py's lookup check
vocab, dim, thr = M.LAYOUT
layout = JEMB.EmbeddingLayout(vocab, dim, row_shard_threshold=thr)
idx = jnp.asarray(x["emb_idx"])
for mname, tp in (("1x4", 4), ("2x2", 2)):
    pol = ShardingPolicy(meshes[mname])
    params = JEMB.init_embedding(layout, jax.random.PRNGKey(3), n_shards=tp)
    f = jax.jit(lambda p: JEMB.lookup_shardmap(layout, p, idx, pol))
    y = f(params)
    w = jnp.asarray(M.weight(y.shape))
    g = jax.jit(jax.grad(lambda p: jnp.sum(f(p) * w)))(params)
    out[f"emb/{mname}/out"] = np.asarray(y)
    out[f"emb/{mname}/lookup"] = np.asarray(JEMB.lookup(layout, params, idx))
    for k in params:
        out[f"emb/{mname}/param/{k}"] = np.asarray(params[k])
        out[f"emb/{mname}/grad/{k}"] = np.asarray(g[k])

# the two-level top-k
sc = jnp.asarray(x["topk_scores"])
for mname, k in M.TOPK_CASES:
    pol = ShardingPolicy(meshes[mname])
    v, i = jax.jit(lambda s: JR._topk(s, k, pol, True))(sc)
    out[f"topk/{mname}/{k}/vals"], out[f"topk/{mname}/{k}/ids"] = \
        np.asarray(v), np.asarray(i)

# retrieval_step with two_level_topk over (2, 2)
rcfg = M.recsys_cfg(get_config)
rp = JR.init_params(rcfg, jax.random.PRNGKey(4))
save_leaves("rs/params", rp)
pol = ShardingPolicy(meshes["2x2"])
rb = {"sparse": jnp.asarray(x["rs_sparse"]), "dense": jnp.asarray(x["rs_dense"]),
      "candidates": jnp.asarray(x["rs_cand"])}
for stages, proxy in ((1, False), (2, False), (2, True)):
    b = dict(rb, cand_proxy=jnp.asarray(x["rs_proxy"])) if proxy else rb
    s, i = jax.jit(lambda p, bb: JR.retrieval_step(
        rcfg, p, bb, pol, stages=stages, prefetch_k=64, top_k=10,
        two_level_topk=True))(rp, b)
    out[f"rs/{stages}/{proxy}/scores"], out[f"rs/{stages}/{proxy}/ids"] = \
        np.asarray(s), np.asarray(i)

# moe_ragged_ep: output and gradients
mp = JL.moe_params(lcfg, jax.random.PRNGKey(5))
for case in M.MOE_CASES:
    mname = case.split("_")[0]
    p = dict(mp)
    xx = jnp.asarray(x["moe_x"])
    if case.endswith("skewed"):
        u = jnp.asarray(x["moe_u"])
        p["router"] = p["router"].at[:, 0].set(u * 8.0)
        xx = xx + 3.0 * u
    pol = ShardingPolicy(meshes[mname])
    f = lambda p, xx: JL.moe_ragged_ep(lcfg, p, xx, pol)
    y = jax.jit(f)(p, xx)
    w = jnp.asarray(M.weight(y.shape))
    gp, gx = jax.jit(jax.grad(lambda p, xx: jnp.sum(f(p, xx) * w),
                              argnums=(0, 1)))(p, xx)
    out[f"moe/{case}/out"] = np.asarray(y)
    out[f"moe/{case}/grad/x"] = np.asarray(gx)
    for k in p:
        out[f"moe/{case}/param/{k}"] = np.asarray(p[k])
        out[f"moe/{case}/grad/{k}"] = np.asarray(gp[k])

# the 2-layer LM's loss and gradients with ragged_ep over (2, 2)
save_leaves("lm/params", lp)
pol = ShardingPolicy(meshes["2x2"])
lb = {"tokens": jnp.asarray(x["lm_tokens"]), "labels": jnp.asarray(x["lm_labels"])}
loss, g = jax.jit(jax.value_and_grad(
    lambda p: JT.loss_fn(lcfg, p, lb, pol)))(lp)
out["lm/loss"] = np.asarray(loss)
save_leaves("lm/grads", g)

# the vertex cut at S = 4: forward (logits by shard), loss and gradients
gcfg = M.gnn_cfg(get_config)
gp = JE.init_params(gcfg, jax.random.PRNGKey(7), M.GNN_F, M.GNN_OUT)
save_leaves("vc/params", gp)
flat = ("data", "model")
n_local = -(-M.GNN_N // M.GNN_S)
def plan_of(e):
    idx = jax.lax.axis_index(flat)
    return ShardedEdges(*[a[0] for a in e], n_local=n_local,
                        shard_offset=idx * n_local, axis_names=flat)
def lossb(p, feat, pos, labels, lmask, *e):
    logits = JE.forward(gcfg, p, plan_of(e), feat, pos)
    logz = jax.nn.logsumexp(logits, axis=-1)
    gold = jnp.take_along_axis(logits, labels[:, None], axis=-1)[:, 0]
    m = lmask.astype(jnp.float32)
    num = jax.lax.psum(jnp.sum((logz - gold) * m), flat)
    den = jax.lax.psum(jnp.sum(m), flat)
    return num / jnp.maximum(den, 1.0), logits
E_ = [jnp.asarray(x["vc_" + k]) for k in keys]
args = (jnp.asarray(x["vc_feat"]), jnp.asarray(x["vc_pos"]))
def vloss(p):
    return shard_map(lambda f, ps, l, m, *e: lossb(p, f, ps, l, m, *e),
                     mesh=meshes["2x2"],
                     in_specs=(P(flat), P(), P(flat), P(flat)) + (P(flat),) * 6,
                     out_specs=(P(), P(flat)), check_rep=False)(
        *args, jnp.asarray(x["vc_labels"]), jnp.asarray(x["vc_lmask"]), *E_)
(l, lg), g = jax.jit(jax.value_and_grad(vloss, has_aux=True))(gp)
out["vc/logits"] = np.asarray(lg)
out["vc/loss"] = np.asarray(l)
save_leaves("vc/grads", g)
""",
          "b": r"""# the cells with a mesh: one train step each
def run_cell(name, jc, params, batch, jit):
    labels = JOPT.default_labels(params)
    st = JOPT.init_opt_state(params, labels)
    new, st, m = jit(jc.fn)(params, st, batch)
    save_leaves(f"cell/{name}/params", params)
    save_leaves(f"cell/{name}/new", new)
    states = jax.tree.leaves(st["per_leaf"], is_leaf=lambda t: isinstance(
        t, dict) and ("m" in t or "acc" in t))
    for i, s in enumerate(states):
        for k, v in s.items():
            out[f"cell/{name}/state/{i}/{k}"] = np.asarray(v)
    for k in ("loss", "grad_norm", "lr"):
        out[f"cell/{name}/m/{k}"] = np.asarray(m[k])
    out[f"cell/{name}/note"] = np.asarray(jc.note)

ccfg = M.gnn_cell_cfg(get_config)
JC.get_config = lambda arch: ccfg
exact = lambda fn: jax.jit(fn, compiler_options=EXACT)
shape = ShapeSpec("minibatch_lg", "minibatch",
                  dict(n_nodes=1000, n_edges=5000, batch_nodes=4,
                       fanout=(2, 2), d_feat=10))
jc = JC.build_gnn_cell("equiformer-v2", shape, meshes["2x2"])
cp = JE.init_params(dataclasses.replace(ccfg, msg_dtype="bfloat16"),
                    jax.random.PRNGKey(8), 10, 41)
run_cell("minibatch", jc, cp, {k: jnp.asarray(x["mb_" + k]) for k in (
    "feat", "pos", "labels", "lmask") + keys}, exact)
shape = ShapeSpec("ogb_products", "full_graph",
                  dict(n_nodes=M.GNN_N, n_edges=2_000_001, d_feat=M.GNN_F))
jc = JC.build_gnn_cell("equiformer-v2", shape, meshes["2x2"])
cp = JE.init_params(ccfg, jax.random.PRNGKey(9), M.GNN_F, 47)
b = {"feat": jnp.asarray(x["vc_feat"]), "pos": jnp.asarray(x["vc_pos"]),
     "labels": jnp.asarray(x["vcc_labels"]), "lmask": jnp.asarray(x["vc_lmask"]),
     **{k: jnp.asarray(x["vc_" + k]) for k in keys}}
run_cell("vertex_cut", jc, cp, b, exact)
JC.get_config = lambda arch: lcfg
shape = ShapeSpec("train_4k", "train", dict(seq_len=8, global_batch=16))
jc = JC.build_lm_cell(M.MOE_ARCH, shape, meshes["2x2"], "opt")
run_cell("lm_opt", jc, lp, {"tokens": jnp.asarray(x["cell_tokens"]),
                            "labels": jnp.asarray(x["cell_labels"])}, jax.jit)
"""}


def _script() -> str:
    """The reference script: the prelude, each half as a function run in
    a thread of its own, and the one ``.npz`` of both."""
    halves = "".join(f"def half_{k}():\n" + textwrap.indent(body, "    ")
                     for k, body in _PARTS.items())
    return _PRELUDE + halves + textwrap.dedent("""
        import threading
        errors = []
        def run(f):
            try:
                f()
            except BaseException as e:
                errors.append(e)
                raise
        threads = [threading.Thread(target=run, args=(f,))
                   for f in (half_a, half_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        np.savez(sys.argv[2], **out)
        print("MODEL_SHARDING_REF_OK")
        """)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("model_sharding_ref")
    x = inputs()
    np.savez(d / "in.npz", **x)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run(
        [sys.executable, "-c", _script(), str(d / "in.npz"),
         str(d / "out.npz"), os.path.abspath(__file__)],
        env=env, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0 and "MODEL_SHARDING_REF_OK" in p.stdout, \
        p.stderr[-3000:]
    return x, dict(np.load(d / "out.npz"))


def leaves_of(want: dict, prefix: str) -> list:
    n = sum(1 for k in want if k.startswith(prefix + "/"))
    return [want[f"{prefix}/{i}"] for i in range(n)]


def grads_by_leaf(model) -> list:
    """The port's gradients in ``repro``'s leaf order (a stacked leaf's
    layers stacked)."""
    out = []
    for name in model.jax_leaf_names():
        gs = [p.grad if p.grad is not None else torch.zeros_like(p)
              for p in model.jax_leaf_params(name)]
        out.append((torch.stack(gs) if model.jax_stacked(name)
                    else gs[0]).numpy())
    return out


# ---------------------------------------------------------------------------
# lookup_shardmap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mname,tp", [("1x4", 4), ("2x2", 2)])
def test_lookup_shardmap_matches_repro(ref, mname, tp):
    """The masked local take plus psum over tp: equal to the port's
    ``lookup`` bit for bit, to ``repro``'s ``lookup_shardmap`` and
    ``lookup``; the tables' gradients to ``jax.grad``'s; the big table
    padded to a multiple of the shards as ``repro`` pads it."""
    x, want = ref
    vocab, dim, thr = LAYOUT
    layout = EMB.EmbeddingLayout(vocab, dim, row_shard_threshold=thr)
    emb = EMB.init_embedding(layout, torch.Generator().manual_seed(0), "cpu",
                             n_shards=tp)
    with torch.no_grad():
        for k in ("big", "small"):
            w = want[f"emb/{mname}/param/{k}"]
            assert tuple(getattr(emb, k).shape) == w.shape
            getattr(emb, k).copy_(torch.from_numpy(w))
    assert emb.big.shape[0] % tp == 0 and emb.big.shape[0] == 3204
    idx = torch.from_numpy(x["emb_idx"])
    pol = ShardingPolicy(port_mesh(mname))
    got = EMB.lookup_shardmap(emb, idx, pol)
    assert torch.equal(got, EMB.lookup(emb, idx))
    np.testing.assert_allclose(got.detach().numpy(),
                               want[f"emb/{mname}/out"], **TOL)
    np.testing.assert_allclose(got.detach().numpy(),
                               want[f"emb/{mname}/lookup"], **TOL)
    (got * torch.from_numpy(weight(tuple(got.shape)))).sum().backward()
    for k in ("big", "small"):
        np.testing.assert_allclose(getattr(emb, k).grad.numpy(),
                                   want[f"emb/{mname}/grad/{k}"], **GTOL,
                                   err_msg=k)


def test_lookup_shardmap_zero_rows_outside_every_slab():
    """An id past the padded table gives a zero row (``repro``'s masked
    take), where ``lookup`` gives NaN (``jnp.take``)."""
    layout = EMB.EmbeddingLayout((6, 3), 4, row_shard_threshold=5)
    emb = EMB.init_embedding(layout, torch.Generator().manual_seed(0), "cpu",
                             n_shards=4)
    assert emb.big.shape[0] == 8
    idx = torch.tensor([[1, 0], [9, 2]])
    got = EMB.lookup_shardmap(emb, idx, ShardingPolicy(port_mesh("1x4")))
    assert torch.equal(got[0, 0], emb.big[1].detach())
    assert torch.equal(got[1, 0], torch.zeros(4))
    assert torch.isnan(EMB.lookup(emb, idx)[1, 0]).all()


# ---------------------------------------------------------------------------
# the two-level top-k and retrieval_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mname,k", TOPK_CASES)
def test_two_level_topk_matches_repro(ref, mname, k):
    """Per-shard top-k then the merge of S x k pairs: ids and values
    exactly ``repro``'s, and exactly the one-level top-k's (scores on a
    grid of 6 values: most are tied)."""
    x, want = ref
    s = torch.from_numpy(x["topk_scores"])
    v, i = R._topk(s, k, ShardingPolicy(port_mesh(mname)), True)
    np.testing.assert_array_equal(i.numpy(), want[f"topk/{mname}/{k}/ids"])
    np.testing.assert_array_equal(v.numpy(), want[f"topk/{mname}/{k}/vals"])
    v1, i1 = sorted_top_k(s, k)
    assert torch.equal(i, i1) and torch.equal(v, v1)


def test_two_level_topk_runs_per_shard(monkeypatch):
    """The merge sees only S x min(k, N/S) pairs, each shard's top-k of
    its own slab, selected inside ``shard_map``."""
    seen = []
    real = R.sorted_top_k

    def spy(scores, k):
        seen.append((SM.in_shard_map(), tuple(scores.shape)))
        return real(scores, k)
    monkeypatch.setattr(R, "sorted_top_k", spy)
    R._topk(torch.arange(64.0), 5, ShardingPolicy(port_mesh("2x2")), True)
    assert seen == [(True, (16,))] * 4 + [(False, (20,))]
    seen.clear()
    R._topk(torch.arange(62.0), 5, ShardingPolicy(port_mesh("2x2")), True)
    assert seen == [(False, (62,))]            # 4 does not divide 62


@pytest.mark.parametrize("stages,proxy", [(1, False), (2, False), (2, True)])
def test_retrieval_step_two_level_matches_repro(ref, stages, proxy):
    """``retrieval_step(two_level_topk=True)`` over (2, 2): ids exactly
    ``repro``'s (jitted) and the one-level step's, scores rtol 1e-5."""
    x, want = ref
    cfg = recsys_cfg(get_config)
    model = R.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model.load_jax_leaves(leaves_of(want, "rs/params"))
    b = {"sparse": torch.from_numpy(x["rs_sparse"]),
         "dense": torch.from_numpy(x["rs_dense"]),
         "candidates": torch.from_numpy(x["rs_cand"])}
    if proxy:
        b["cand_proxy"] = torch.from_numpy(x["rs_proxy"])
    kw = dict(stages=stages, prefetch_k=64, top_k=10)
    s, i = R.retrieval_step(cfg, model, b, two_level_topk=True,
                            shard=ShardingPolicy(port_mesh("2x2")), **kw)
    np.testing.assert_array_equal(i.numpy(),
                                  want[f"rs/{stages}/{proxy}/ids"])
    np.testing.assert_allclose(s.numpy(), want[f"rs/{stages}/{proxy}/scores"],
                               **TOL)
    s1, i1 = R.retrieval_step(cfg, model, b, **kw)
    assert torch.equal(i, i1)


# ---------------------------------------------------------------------------
# moe_ragged_ep
# ---------------------------------------------------------------------------

def _port_moe(want, case):
    cfg = lm_cfg(get_config)
    p = {k: torch.tensor(want[f"moe/{case}/param/{k}"], requires_grad=True)
         for k in ("router", "w1", "w3", "w2")}
    x = torch.from_numpy(inputs()["moe_x"])
    if case.endswith("skewed"):
        x = x + 3.0 * torch.from_numpy(inputs()["moe_u"])
    x.requires_grad_(True)
    L.EP_STATS.update(assigned=0, kept=0)
    y = L.moe_ragged_ep(cfg, p, x, ShardingPolicy(port_mesh(case[:3])))
    stats = dict(L.EP_STATS)
    (y * torch.from_numpy(weight(tuple(y.shape)))).sum().backward()
    return cfg, p, x, y, stats


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_ragged_ep_matches_repro(ref, case):
    """Output rtol 1e-5 and every gradient (x, router, w1, w3, w2) rtol
    1e-3 of ``repro``'s body; the skewed router fills expert 0's owner
    past capacity, and both drop the same assignments."""
    _, want = ref
    cfg, p, x, y, stats = _port_moe(want, case)
    np.testing.assert_allclose(y.detach().numpy(), want[f"moe/{case}/out"],
                               **TOL)
    np.testing.assert_allclose(x.grad.numpy(), want[f"moe/{case}/grad/x"],
                               **GTOL)
    for k, t in p.items():
        np.testing.assert_allclose(t.grad.numpy(),
                                   want[f"moe/{case}/grad/{k}"], **GTOL,
                                   err_msg=k)
    assert stats["assigned"] == 4 * 8 * cfg.moe.top_k
    if case.endswith("skewed"):
        assert stats["kept"] < stats["assigned"]
    else:
        assert stats["kept"] == stats["assigned"]
        with torch.no_grad():
            np.testing.assert_allclose(
                L.moe_ragged(cfg, p, x).numpy(), y.detach().numpy(), **TOL)


def test_ffn_ragged_ep_without_mesh_is_moe_ragged():
    cfg = lm_cfg(get_config)
    p = L.moe_params(cfg, torch.Generator().manual_seed(1))
    x = torch.randn(2, 4, 128, generator=torch.Generator().manual_seed(2))
    want = L.moe_ragged(cfg, p, x)
    assert torch.equal(L.ffn(cfg, p, x), want)
    assert torch.equal(L.ffn(cfg, p, x, ShardingPolicy(None)), want)


def test_lm_loss_with_ragged_ep_matches_repro(ref):
    """The reduced granite-moe (2 layers) with ``ragged_ep`` over (2, 2):
    loss rtol 1e-5 and every gradient rtol 1e-3 of ``jax.grad``."""
    x, want = ref
    cfg = lm_cfg(get_config)
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model.load_jax_leaves(leaves_of(want, "lm/params"))
    b = {"tokens": torch.from_numpy(x["lm_tokens"]),
         "labels": torch.from_numpy(x["lm_labels"])}
    loss = T.loss_fn(model, b, ShardingPolicy(port_mesh("2x2")))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want["lm/loss"]), rtol=1e-5)
    for name, g, w in zip(model.jax_leaf_names(), grads_by_leaf(model),
                          leaves_of(want, "lm/grads")):
        np.testing.assert_allclose(g, w, **GTOL, err_msg=name)


# ---------------------------------------------------------------------------
# the vertex cut at S = 4
# ---------------------------------------------------------------------------

def _vc_model(want):
    cfg = gnn_cfg(get_config)
    model = E.init_params(cfg, GNN_F, GNN_OUT,
                          torch.Generator().manual_seed(0), "cpu")
    model.load_jax_leaves(leaves_of(want, "vc/params"))
    return cfg, model


def _vc_edges(x):
    return [torch.from_numpy(x["vc_" + k]) for k in TC._EDGE_KEYS]


def test_vertex_cut_forward_matches_repro_and_local(ref):
    """Each shard's logits from its own nodes and the exchanged messages:
    ``repro``'s rtol 1e-5, and the one-device COO forward's."""
    x, want = ref
    cfg, model = _vc_model(want)
    mesh = port_mesh("2x2")
    n_local = GNN_N // GNN_S
    flat = ("data", "model")

    def body(feat, pos, *e):
        plan = TC._shard_plan(dict(zip(TC._EDGE_KEYS, e)), (0,), n_local,
                              SM.axis_index(flat) * n_local, flat)
        return E.forward(cfg, model, plan, feat, pos)
    feat, pos = torch.from_numpy(x["vc_feat"]), torch.from_numpy(x["vc_pos"])
    with torch.no_grad():
        got = SM.shard_map(body, mesh, (SM.P(flat), SM.P())
                           + (SM.P(flat),) * 6, SM.P(flat))(
            feat, pos, *_vc_edges(x))
        local = E.forward(cfg, model, LocalEdges(
            torch.from_numpy(x["vc_src"]).long(),
            torch.from_numpy(x["vc_dst"]).long(),
            torch.ones(GNN_E, dtype=torch.bool), GNN_N), feat, pos)
    np.testing.assert_allclose(got.numpy(), want["vc/logits"], **TOL)
    np.testing.assert_allclose(got.numpy(), local.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_vertex_cut_loss_and_grads_match_repro(ref):
    """The psum'd num/den loss over the flat axis and every gradient,
    through checkpointed layers whose exchange is replayed in the
    backward."""
    x, want = ref
    cfg, model = _vc_model(want)
    assert cfg.remat
    loss_fn = TC.vertex_cut_loss(cfg, port_mesh("2x2"), GNN_N // GNN_S,
                                 ("data", "model"))
    b = {"feat": torch.from_numpy(x["vc_feat"]),
         "pos": torch.from_numpy(x["vc_pos"]),
         "labels": torch.from_numpy(x["vc_labels"]),
         "lmask": torch.from_numpy(x["vc_lmask"]),
         **dict(zip(TC._EDGE_KEYS, _vc_edges(x)))}
    loss = loss_fn(model, b)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want["vc/loss"]), rtol=1e-5)
    for name, g, w in zip(model.jax_leaf_names(), grads_by_leaf(model),
                          leaves_of(want, "vc/grads")):
        np.testing.assert_allclose(g, w, **GTOL, err_msg=name)


def _mesh_loss(which, x):
    """A GNN mesh loss builder of ``launch/cells.py`` on the (2, 2) mesh,
    its model and its batch, from ``inputs()``."""
    if which == "vertex_cut":
        cfg = gnn_cfg(get_config)
        model = E.init_params(cfg, GNN_F, GNN_OUT,
                              torch.Generator().manual_seed(0), "cpu")
        loss = TC.vertex_cut_loss(cfg, port_mesh("2x2"), GNN_N // GNN_S,
                                  ("data", "model"))
        b = {"feat": x["vc_feat"], "pos": x["vc_pos"],
             "labels": x["vc_labels"], "lmask": x["vc_lmask"],
             **{k: x["vc_" + k] for k in TC._EDGE_KEYS}}
    else:
        cfg = gnn_cell_cfg(get_config)
        model = E.init_params(cfg, 10, 41, torch.Generator().manual_seed(0),
                              "cpu")
        loss = TC.minibatch_loss(cfg, port_mesh("2x2"), 14, ("data",),
                                 ("model",))
        b = {k: x["mb_" + k] for k in ("feat", "pos", "labels", "lmask")
             + TC._EDGE_KEYS}
    return loss, model, {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("which", ["vertex_cut", "minibatch"])
def test_gnn_mesh_losses_read_each_positions_parameters(monkeypatch, which):
    """The GNN bodies take the model's parameters as a ``P()`` argument:
    with every slab a copy, as on a mesh of separate cards, each position's
    model holds the copy handed to that position, never the model's own
    tensor; the loss equals that of the run without copies bit for bit,
    and the gradients within rtol 1e-5, atol 1e-6 (the copies' gradients
    sum back into the model in another order)."""
    x = inputs()
    loss_fn, model, b = _mesh_loss(which, x)
    want = loss_fn(model, b)
    want.backward()
    want_g = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    split, seen = SM.split, []
    monkeypatch.setattr(SM, "split", lambda t, mesh, spec, copy=False:
                        split(t, mesh, spec, copy=True))
    ce = TC.sharded_ce_loss
    monkeypatch.setattr(TC, "sharded_ce_loss",
                        lambda cfg, m, *a: seen.append(m) or ce(cfg, m, *a))
    got = loss_fn(model, b)
    got.backward()
    assert len(seen) == 4
    for name, p in model.named_parameters():
        held = [functools.reduce(getattr, name.split("."), m) for m in seen]
        assert all(t is not p and t.data_ptr() != p.data_ptr()
                   for t in held), name
        assert len({t.data_ptr() for t in held}) == 4, name
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   **TOL, err_msg=name)
    assert float(got) == float(want)


# ---------------------------------------------------------------------------
# the cells with a mesh against repro's build_cell(mesh)
# ---------------------------------------------------------------------------

def _cell_run(want, name, tc, batch):
    """One step of the port's cell from ``repro``'s weights, and
    ``repro``'s step as ``_check_step`` reads it."""
    tc.args[0].load_jax_leaves(leaves_of(want, f"cell/{name}/params"))
    m = tc.fn(tc.args[0], tc.args[1],
              {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    jm = {k: want[f"cell/{name}/m/{k}"] for k in ("loss", "grad_norm", "lr")}
    n = len(leaves_of(want, f"cell/{name}/new"))
    states = [{k: want[f"cell/{name}/state/{i}/{k}"] for k in ("m", "v",
                                                               "acc")
               if f"cell/{name}/state/{i}/{k}" in want} for i in range(n)]
    assert str(want[f"cell/{name}/note"]) == tc.note
    return m, jm, leaves_of(want, f"cell/{name}/new"), {"per_leaf": states}


def _patch(monkeypatch, cfg):
    monkeypatch.setattr(TC, "get_config", lambda arch: cfg)


def test_gnn_minibatch_cell_on_2x2_runs_as_repro(ref, monkeypatch):
    """The two-level minibatch cell at dp = tp = 2: two 28-node subgraphs,
    each vertex-cut over tp (cap 16), one step against ``repro``'s cell
    on a (2, 2) mesh."""
    x, want = ref
    _patch(monkeypatch, gnn_cell_cfg(get_config))
    shape = ShapeSpec("minibatch_lg", "minibatch",
                      dict(n_nodes=1000, n_edges=5000, batch_nodes=4,
                           fanout=(2, 2), d_feat=10))
    tc = TC.build_gnn_cell("equiformer-v2", shape, generator=_gen(),
                           mesh=port_mesh("2x2"))
    assert tc.note == "two-level dp=2 x tp=2, cap=16"
    batch = {k: x["mb_" + k] for k in ("feat", "pos", "labels", "lmask")
             + TC._EDGE_KEYS}
    _check_step(*_cell_run(want, "minibatch", tc, batch), tc, "minibatch",
                loss_rtol=GNN_REL, gn_rtol=GNN_REL, noise_rel=GNN_NOISE_REL)


def test_gnn_vertex_cut_cell_on_2x2_runs_as_repro(ref, monkeypatch):
    """The ogb_products-scale vertex-cut cell at S = 4 (built for
    2,000,001 edges, run on the 24-node graph at cap 16)."""
    x, want = ref
    _patch(monkeypatch, gnn_cell_cfg(get_config))
    shape = ShapeSpec("ogb_products", "full_graph",
                      dict(n_nodes=GNN_N, n_edges=2_000_001, d_feat=GNN_F))
    tc = TC.build_gnn_cell("equiformer-v2", shape, generator=_gen(),
                           mesh=port_mesh("2x2"))
    assert tc.note == "vertex-cut S=4 cap=156256"
    batch = {"feat": x["vc_feat"], "pos": x["vc_pos"],
             "labels": x["vcc_labels"], "lmask": x["vc_lmask"],
             **{k: x["vc_" + k] for k in TC._EDGE_KEYS}}
    _check_step(*_cell_run(want, "vertex_cut", tc, batch), tc, "vertex-cut",
                loss_rtol=GNN_REL, gn_rtol=GNN_REL, noise_rel=GNN_NOISE_REL)


def test_lm_opt_cell_on_2x2_runs_as_repro(ref, monkeypatch):
    """granite-moe's ``opt`` train cell (``ragged_ep`` over dp = tp = 2, 8
    checkpointed microbatches of 2), reduced, batch 16 x 8: partitioned,
    its arguments placed by ``repro``'s shardings, one step against
    ``repro``'s cell on a (2, 2) mesh."""
    x, want = ref
    cfg = lm_cfg(get_config)
    _patch(monkeypatch, cfg)
    shape = ShapeSpec("train_4k", "train", dict(seq_len=8, global_batch=16))
    tc = TC.build_lm_cell(MOE_ARCH, shape, variant="opt", generator=_gen(),
                          mesh=port_mesh("2x2"))
    params, opt, batch = tc.args
    names = T.template(cfg).jax_leaf_names()
    for n, leaf in zip(names, leaves_of(want, "cell/lm_opt/params")):
        placed = device_put(leaf, params[n].sharding, copy=True)
        with torch.no_grad():
            for dst, src in zip(params[n].slabs, placed.slabs):
                dst.copy_(src)
    b = {"tokens": torch.from_numpy(x["cell_tokens"]),
         "labels": torch.from_numpy(x["cell_labels"])}
    m = tc.fn(params, opt, device_put(b, {k: v.sharding for k, v in
                                          batch.items()}, copy=True))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(want[f"cell/lm_opt/m/{k}"]),
                                   rtol=STEP_RTOL, err_msg=k)
    lr = float(want["cell/lm_opt/m/lr"])
    np.testing.assert_allclose(float(m["lr"]), lr, rtol=1e-6)
    for i, (n, jnew) in enumerate(zip(names, leaves_of(want,
                                                        "cell/lm_opt/new"))):
        assert set(opt["per_leaf"][n]) == {"m", "v"}, n
        jm = want[f"cell/lm_opt/state/{i}/m"]
        noisy = np.abs(jm) / 0.1 < max(NOISE_FLOOR, 0.0)
        bound = np.where(noisy, 2 * lr, PARAM_LR_FRAC * lr) \
            + 2 * np.spacing(np.abs(jnew))
        got = params[n].gather().detach().numpy()
        assert np.all(np.abs(got - jnew) <= bound), n


@pytest.mark.parametrize("arch,shape_name,variant", [
    ("dcn-v2", "serve_p99", "base"), ("dlrm-mlperf", "train_batch", "base"),
    ("bert4rec", "serve_bulk", "opt"),
    ("equiformer-v2", "full_graph_sm", "opt"),
    ("dcn-v2", "train_batch", "base"), ("dcn-v2", "retrieval_cand", "base"),
    ("equiformer-v2", "full_graph_sm", "base")])
def test_formerly_refused_cells_build_on_a_mesh(arch, shape_name, variant):
    """The cells ``repro`` shards only through XLA partitioning (recsys
    tables row-split over tp, the small full graph's edges over flat)
    build on a 2x2 mesh: every tensor argument is a placed ``Sharded`` on
    that mesh, with no storage on ``meta``."""
    mesh = port_mesh("2x2")
    c = TC.build_cell(arch, shape_name, "meta", variant=variant, mesh=mesh)

    def leaves(a):
        if isinstance(a, dict):
            return [x for v in a.values() for x in leaves(v)]
        return [a]
    args = [x for a in c.args for x in leaves(a)]
    assert args and all(isinstance(a, Sharded) and a.sharding.mesh == mesh
                        for a in args)
    assert all(t.device.type == "meta" for t in TC.arg_tensors(c.args))


def test_every_cell_builds_on_a_mesh():
    """All of ``repro``'s 101 cells (every variant) build on ``meta`` with
    a 2x2 mesh; none raises."""
    from repro_torch.configs import ALL_ARCHS, get_cells
    mesh = port_mesh("2x2")
    built = [TC.build_cell(arch, shape, "meta", variant=v, mesh=mesh)
             for arch, shape in get_cells(ALL_ARCHS)
             for v in TC.variants(arch, shape)]
    assert len(built) == 101


def test_mesh_cells_build_on_the_mesh(monkeypatch):
    """The recsys ``opt`` candidate search pads its candidates to the
    mesh, places them over ``flat`` and runs the two-level top-k over
    them: its ids are the one-level search's over the same weights and
    candidates."""
    from test_torch_recsys import reduced
    cfg = reduced(get_config, "dcn-v2")
    monkeypatch.setattr(TC, "get_config", lambda arch: cfg)
    shape = ShapeSpec("retrieval_cand", "retrieval",
                      dict(n_candidates=1001, batch=1))
    c = TC.build_recsys_cell("dcn-v2", shape, variant="opt",
                             generator=_gen(), mesh=port_mesh("2x2"))
    params, batch = c.args
    assert batch["candidates"].shape == (1004,)
    assert batch["candidates"].slabs[0].shape == (251,)
    s, i = c.fn(*c.args)
    model = R.init_params(cfg, torch.Generator(), "cpu")
    model.load_jax_leaves([params[n].gather().detach()
                           for n in model.jax_leaf_names()])
    s1, i1 = R.retrieval_step(cfg, model, {k: v.gather() for k, v in
                                           batch.items()}, stages=2)
    assert torch.equal(i, i1)
