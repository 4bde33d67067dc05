"""The data-parallel partitioned cells on a 4-position CPU mesh against
``repro``'s ``jax.jit(cell.fn, in_shardings=cell.in_shardings)``: the
ColPali ``train_contrastive`` cell at 4x1 (global in-batch negatives:
its loss is ``repro``'s over the whole batch, and a loss over each
position's local negatives provably differs on these inputs), the
``index_1m`` cell at 4x1 (pooling through the ``pool.cu`` wrapper on
every position; its plain version here), and the GNN ``molecule`` cell
at 4x1 and 2x2 (replicated weights, graphs over dp).

``repro`` runs in ONE subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` on inputs this
module makes with numpy from a seed; the GNN references are jitted with
``xla_allow_excess_precision`` off, as ``tests/test_torch_cells_gnn.py``
runs them.

Tolerances: ColPali loss and grad_norm rtol 1e-4, parameters within
1e-2 lr (2 lr where the gradient is under 1e-7); index vectors as
``tests/test_torch_cells.py`` holds them (bfloat16 rtol 2^-7); the
molecule cell's bfloat16 messages as ``tests/test_torch_cells_gnn.py``
holds them (loss and grad_norm rtol 2^-8), elements whose gradient is
under 2^-5 x the leaf's largest held to 2 lr (``MOLECULE_NOISE_REL``);
with float32 messages the partitioned molecule step is the port's
one-device step within 1e-2 lr."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.distributed.sharding import device_put
from repro_torch.launch import cells as TC
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import late_interaction as LI
from test_torch_cells_gnn import GNN_REL
from test_torch_gnn import reduced as gnn_reduced
from test_torch_training import small_cfg as retriever_small

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}
B = 8
TRAIN = dict(global_batch=B)
INDEX = dict(pages_per_step=B, corpus=100)
MOLECULE = dict(n_nodes=6, n_edges=12, batch=B, d_feat=4)
MOLECULE_MESHES = ("4x1", "2x2")
STEP_RTOL, PARAM_LR_FRAC, NOISE = 1e-4, 1e-2, 1e-7
BF16_RTOL = 2 ** -7
# ``GNN_NOISE_REL`` for 8 graphs split over dp: one element of 2048, its
# gradient 2^-5.7 of its leaf's largest, took the other sign (its bfloat16
# messages summed over other graph groups than ``repro``'s); the same step
# with float32 messages matches the one-device step within 7.5e-9 (2.5e-3
# lr; ``test_molecule_mesh_step_is_the_one_device_step``)
MOLECULE_NOISE_REL = 2 ** -5


def retriever_cfg(get):
    return retriever_small(get)


def gnn_cfg(get):
    return gnn_reduced(get)


def port_mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices=["cpu"] * 4)


def inputs() -> dict:
    cfg = retriever_cfg(get_config)
    r = np.random.default_rng(50)
    Q = cfg.max_query_tokens
    qmask = np.ones((B, Q), bool)
    qmask[:, 10:] = False
    emask = np.ones((B, 12), bool)
    emask[1, :2] = False
    x = {"patches": r.normal(size=(B, cfg.n_patches, LI.D_PATCH)),
         "query_tokens": r.integers(0, cfg.query_vocab, (B, Q)),
         "query_mask": qmask,
         "index_patches": r.normal(size=(B, cfg.n_patches, LI.D_PATCH)),
         "feat": r.normal(size=(B, 6, 4)),
         "pos": r.uniform(-2.0, 2.0, (B, 6, 3)),
         "src": r.integers(0, 6, (B, 12)), "dst": r.integers(0, 6, (B, 12)),
         "emask": emask, "target": r.normal(size=(B,))}
    return {k: (v.astype(np.float32) if v.dtype == np.float64 else
                v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in x.items()}


RETRIEVER_BATCH = ("patches", "query_tokens", "query_mask")
MOLECULE_BATCH = ("feat", "pos", "src", "dst", "emask", "target")

_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, os.path.dirname(sys.argv[3]))
from repro.configs import get_config, ShapeSpec
from repro.launch import cells as JC
from repro.launch.mesh import make_mesh
from repro.models import late_interaction as JLI
from repro.models.gnn import equiformer_v2 as JE
from repro.training import optimizer as JOPT
import test_torch_partitioned_cells as M
from test_torch_gnn import EXACT

x = dict(np.load(sys.argv[1]))
out = {}
meshes = {k: make_mesh(*v) for k, v in M.MESHES.items()}

def path(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)

def save(prefix, tree):
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if leaf.dtype == jnp.bfloat16:          # npz keeps no bfloat16
            leaf = leaf.astype(jnp.float32)
        out["/".join(filter(None, (prefix, path(kp))))] = np.asarray(leaf)

def train(name, jc, p, batch, **jit):
    save(f"{name}/p", p)
    st = jax.jit(JOPT.init_opt_state)(p)
    new, st, m = jax.jit(jc.fn, in_shardings=jc.in_shardings, **jit)(
        p, st, batch)
    save(f"{name}/new", new)
    save(f"{name}/m", jax.tree.map(lambda s: s["m"], st["per_leaf"],
         is_leaf=lambda s: isinstance(s, dict) and "m" in s))
    save(f"{name}/metrics", m)

rcfg = M.retriever_cfg(get_config)
JC.get_config = lambda arch: rcfg
rp = jax.jit(JLI.init_params, static_argnums=0)(rcfg, jax.random.PRNGKey(0))
jc = JC.build_retriever_cell("colpali", ShapeSpec(
    "train_contrastive", "train", M.TRAIN), meshes["4x1"])
train("colpali", jc, rp, {k: jnp.asarray(x[k]) for k in M.RETRIEVER_BATCH})
jc = JC.build_retriever_cell("colpali", ShapeSpec(
    "index_1m", "index", M.INDEX), meshes["4x1"])
save("index", jax.jit(jc.fn, in_shardings=jc.in_shardings)(
    rp, jnp.asarray(x["index_patches"])))

gcfg = M.gnn_cfg(get_config)
JC.get_config = lambda arch: gcfg
gp = jax.jit(JE.init_params, static_argnums=(0, 2, 3))(
    gcfg, jax.random.PRNGKey(2), 4, 1)
for m in M.MOLECULE_MESHES:
    jc = JC.build_gnn_cell("equiformer-v2", ShapeSpec(
        "molecule", "batched_graphs", M.MOLECULE), meshes[m])
    train(f"molecule/{m}", jc, gp,
          {k: jnp.asarray(x[k]) for k in M.MOLECULE_BATCH},
          compiler_options=EXACT)
np.savez(sys.argv[2], **out)
print("PARTITIONED_CELLS_REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("partitioned_cells_ref")
    x = inputs()
    np.savez(d / "in.npz", **x)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(d / "in.npz"),
         str(d / "out.npz"), os.path.abspath(__file__)],
        env=env, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0 and "PARTITIONED_CELLS_REF_OK" in p.stdout, \
        p.stderr[-3000:]
    return x, dict(np.load(d / "out.npz"))


def load_placed(placed: dict, want: dict, prefix: str) -> None:
    """``repro``'s leaves (by path under ``prefix``) copied into the placed
    parameters, slab by slab."""
    for n, s in placed.items():
        src = device_put(want[f"{prefix}/{n}"], s.sharding, copy=True)
        with torch.no_grad():
            for dst, v in zip(s.slabs, src.slabs):
                dst.copy_(v)


def check_step(m, want, prefix, params, opt, rtol, noise_rel=0.0):
    """Metrics, and every placed parameter after the step within
    ``PARAM_LR_FRAC`` lr of ``repro``'s (2 lr where its gradient is under
    ``NOISE`` or ``noise_rel`` x the leaf's largest)."""
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]),
                                   float(want[f"{prefix}/metrics/{k}"]),
                                   rtol=rtol, err_msg=f"{prefix} {k}")
    lr = float(want[f"{prefix}/metrics/lr"])
    np.testing.assert_allclose(float(m["lr"]), lr, rtol=1e-6)
    for n, s in params.items():
        assert opt["per_leaf"][n]["m"].sharding == s.sharding
        g = np.abs(want[f"{prefix}/m/{n}"]) / 0.1
        noisy = g < max(NOISE, noise_rel * g.max(initial=0.0))
        jnew = want[f"{prefix}/new/{n}"]
        bound = np.where(noisy, 2 * lr, PARAM_LR_FRAC * lr) \
            + 2 * np.spacing(np.abs(jnew))
        got = s.gather().detach().numpy()
        bad = np.argwhere(np.abs(got - jnew) > bound)
        assert not len(bad), (
            f"{prefix} {n}: {len(bad)} of {got.size} off; first at "
            f"{tuple(bad[0])}: {np.abs(got - jnew)[tuple(bad[0])]:.3g} > "
            f"{bound[tuple(bad[0])]:.3g}, g {g[tuple(bad[0])]:.3g} of "
            f"max {g.max():.3g} (lr {lr:.3g})")


def _retriever_cell(monkeypatch, shape, mname="4x1"):
    cfg = retriever_cfg(get_config)
    monkeypatch.setattr(TC, "get_config", lambda arch: cfg)
    return cfg, TC.build_retriever_cell("colpali", shape, "cpu",
                                        generator=torch.Generator(),
                                        mesh=port_mesh(mname))


def test_colpali_train_keeps_global_negatives(ref, monkeypatch):
    """One step at 4x1, batch 8 (2 pages and queries per position): the
    loss is ``repro``'s over the [8, 8] score matrix, and differs from the
    mean of the four local [2, 2] losses; parameters replicated, updated
    as ``repro``'s."""
    x, want = ref
    cfg, cell = _retriever_cell(monkeypatch, ShapeSpec(
        "train_contrastive", "train", TRAIN))
    params, opt, batch = cell.args
    load_placed(params, want, "colpali/p")
    b = {k: torch.from_numpy(x[k]) for k in RETRIEVER_BATCH}
    # the loss over each position's own negatives only, on the same weights
    model = LI.init_params(cfg, torch.Generator(), "cpu")
    model.load_jax_leaves([want[f"colpali/p/{n}"]
                           for n in model.jax_leaf_names()])
    with torch.no_grad():
        local = np.mean([float(model.contrastive_loss(
            {k: v[i:i + 2] for k, v in b.items()})) for i in range(0, B, 2)])
        whole = float(model.contrastive_loss(b))
    m = cell.fn(params, opt, device_put(b, {k: v.sharding for k, v in
                                            batch.items()}, copy=True))
    np.testing.assert_allclose(float(m["loss"]), whole, rtol=1e-5)
    assert abs(local - float(m["loss"])) > 0.05 * abs(float(m["loss"]))
    check_step(m, want, "colpali", params, opt, STEP_RTOL)


def test_colpali_index_pools_on_every_position(ref, monkeypatch):
    """The index cell at 4x1: 8 pages, 2 a position, each position's
    pages encoded and pooled there; the vectors, pooled vectors and
    global vectors are ``repro``'s."""
    x, want = ref
    cfg, cell = _retriever_cell(monkeypatch, ShapeSpec("index_1m", "index",
                                                       INDEX))
    params, patches = cell.args
    load_placed(params, want, "colpali/p")
    assert patches.slabs[0].shape[0] == 2
    got = cell.fn(params, device_put(torch.from_numpy(x["index_patches"]),
                                     patches.sharding, copy=True))
    for i, (what, g) in enumerate(zip(("vectors", "pooled", "global"), got)):
        w = want[f"index/{i}"]
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(), w,
                                   rtol=BF16_RTOL, atol=1e-6, err_msg=what)


@pytest.mark.parametrize("mname", MOLECULE_MESHES)
def test_molecule_cell_data_parallel(ref, monkeypatch, mname):
    """The molecule cell's graphs over dp (2 or 4 a position), weights and
    moments replicated: one step against ``repro``'s partitioned cell."""
    x, want = ref
    cfg = gnn_cfg(get_config)
    monkeypatch.setattr(TC, "get_config", lambda arch: cfg)
    cell = TC.build_gnn_cell("equiformer-v2", ShapeSpec(
        "molecule", "batched_graphs", MOLECULE), "cpu",
        generator=torch.Generator(), mesh=port_mesh(mname))
    params, opt, batch = cell.args
    prefix = f"molecule/{mname}"
    load_placed(params, want, f"{prefix}/p")
    b = {k: torch.from_numpy(x[k]) for k in MOLECULE_BATCH}
    m = cell.fn(params, opt, device_put(b, {k: v.sharding for k, v in
                                            batch.items()}, copy=True))
    check_step(m, want, prefix, params, opt, GNN_REL, MOLECULE_NOISE_REL)
    ndp = MESHES[mname][0][0]
    assert batch["feat"].slabs[0].shape[0] == B // ndp
    assert all(tuple(s.shape) == p.shape for p in params.values()
               for s in p.slabs)


def test_cells_on_meta_are_placed_by_repros_shardings(monkeypatch):
    """Full configs on ``meta`` at 2x2: the ColPali train cell's batch is
    split over data, its parameters and moments replicated; the index
    cell's pages split over data; the molecule cell's graphs split over
    data; no storage anywhere."""
    m = port_mesh("2x2")
    c = TC.build_cell("colpali", "train_contrastive", "meta", mesh=m)
    params, opt, batch = c.args
    assert all(s.slabs[0].shape[0] == 128 for s in batch.values())
    assert all(tuple(s.slabs[0].shape) == s.shape for s in params.values())
    c = TC.build_cell("colpali", "index_1m", "meta", mesh=m)
    assert c.args[1].slabs[0].shape[0] == 128
    c = TC.build_cell("equiformer-v2", "molecule", "meta", mesh=m)
    assert all(s.slabs[0].shape[0] == s.shape[0] // 2
               for s in c.args[2].values())
    assert all(t.device.type == "meta" for t in TC.arg_tensors(c.args))


@pytest.mark.parametrize("mname", MOLECULE_MESHES)
def test_molecule_mesh_step_is_the_one_device_step(monkeypatch, mname):
    """With float32 messages (no bfloat16 rounding to reorder), the
    partitioned molecule step equals the port's one-device step on the
    same weights and graphs: loss and grad_norm rtol 1e-6, every
    parameter within 1e-2 lr, the moments rtol 1e-4 (atol 1e-6 of the
    leaf's largest: sums that cancel)."""
    from repro_torch.models.gnn import equiformer_v2 as E
    cfg = gnn_cfg(get_config)
    monkeypatch.setattr(TC, "get_config", lambda arch: cfg)
    monkeypatch.setattr(E, "_msg_dtype", lambda c: torch.float32)
    shape = ShapeSpec("molecule", "batched_graphs", MOLECULE)
    one = TC.build_gnn_cell("equiformer-v2", shape, "cpu",
                            generator=torch.Generator().manual_seed(4))
    placed = TC.build_gnn_cell("equiformer-v2", shape, "cpu",
                               generator=torch.Generator().manual_seed(4),
                               mesh=port_mesh(mname))
    params, opt, batch = placed.args
    m = placed.fn(params, opt, device_put(one.args[2], {
        k: v.sharding for k, v in batch.items()}, copy=True))
    m1 = one.fn(*one.args)
    for k in m1:
        np.testing.assert_allclose(float(m[k]), float(m1[k]), rtol=1e-6)
    model, lr = one.args[0], float(m1["lr"])
    names = {id(p): n for n, p in model.named_parameters()}
    for n, leaf in zip(model.jax_leaf_names(), model.to_jax_leaves()):
        got = params[n].gather().detach()
        assert (got - leaf).abs().max().item() <= PARAM_LR_FRAC * lr, n
        ps = model.jax_leaf_params(n)
        mom = [one.args[1]["per_leaf"][names[id(p)]]["m"] for p in ps]
        mom = torch.stack(mom) if model.jax_stacked(n) else mom[0]
        np.testing.assert_allclose(opt["per_leaf"][n]["m"].gather().numpy(),
                                   mom.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(mom.abs().max()),
                                   err_msg=n)
