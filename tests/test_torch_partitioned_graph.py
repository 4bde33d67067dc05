"""The small full-graph GNN cell partitioned over a 4-position CPU mesh:
``graph.FlatEdges`` (one position's block of the edges, every node
replicated; the node sums and the segment softmax taken across the
positions) against ``LocalEdges`` over the same edge list, and the
``full_graph_sm`` cell, base and opt (the fused rotation), on 4x1 and
2x2 against ``repro``'s ``jax.jit(cell.fn, in_shardings=...)`` (edges
padded to a multiple of the positions and split over ``flat``, nodes,
weights and moments replicated).

``repro`` runs in ONE subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` on inputs this
module makes with numpy from a seed, jitted with
``xla_allow_excess_precision`` off as ``tests/test_torch_cells_gnn.py``
runs it. The graph: 20 nodes, 62 edges padded to 64 (the 2 padding edges
masked out, 5 more masked), node 0 with no incoming edge, node 1's
incoming edges all inside the first position's block.

Tolerances: ``FlatEdges`` values rtol 1e-6, atol 1e-7 and gradients rtol
1e-5, atol 1e-7 of ``LocalEdges`` (float32 sums reordered; the max's
gradient, which cancels, is left out); the cells' bfloat16 messages as
``tests/test_torch_partitioned_cells.py`` holds the molecule cell (loss
and grad_norm rtol 2^-8, parameters within 1e-2 lr, 2 lr where the
gradient is under 2^-5 of the leaf's largest); with float32 messages the
partitioned step is the port's one-device step within 1e-2 lr."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.distributed import shard_map as SM
from repro_torch.distributed.sharding import device_put
from repro_torch.launch import cells as TC
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.gnn import equiformer_v2 as E
from repro_torch.models.gnn.graph import FlatEdges, LocalEdges
from test_torch_cells_gnn import GNN_REL
from test_torch_gnn import reduced as gnn_reduced
from test_torch_partitioned_cells import (MOLECULE_NOISE_REL, PARAM_LR_FRAC,
                                          check_step, load_placed)

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MESHES = {"4x1": ((4, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
N, E_REAL, F = 20, 62, 5
E_PAD = -(-E_REAL // 4) * 4
SHAPE = dict(n_nodes=N, n_edges=E_REAL, d_feat=F)
VARIANTS = ("base", "opt")


def gnn_cfg(get):
    return gnn_reduced(get)


def port_mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices=["cpu"] * 4)


def edges(r, n_nodes: int, n_edges: int, n_pad: int) -> tuple:
    """(src, dst, emask) of ``n_pad`` slots, the last ``n_pad - n_edges``
    padding (masked); no edge into node 0; node 1's incoming edges all in
    the first quarter of the slots; 5 real edges masked out."""
    src = r.integers(0, n_nodes, n_pad)
    dst = r.integers(2, n_nodes, n_pad)
    dst[:3] = 1
    emask = np.arange(n_pad) < n_edges
    emask[r.choice(n_edges, 5, replace=False)] = False
    emask[:3] = True
    return src.astype(np.int32), dst.astype(np.int32), emask


def inputs() -> dict:
    r = np.random.default_rng(70)
    src, dst, emask = edges(r, N, E_REAL, E_PAD)
    return {"feat": r.normal(size=(N, F)).astype(np.float32),
            "pos": r.uniform(-2.0, 2.0, (N, 3)).astype(np.float32),
            "src": src, "dst": dst, "emask": emask,
            "labels": r.integers(0, 47, N).astype(np.int32),
            "lmask": r.random(N) > 0.25}


_SCRIPT = r"""
import os, sys
from concurrent.futures import ThreadPoolExecutor
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, os.path.dirname(sys.argv[3]))
from repro.configs import get_config, ShapeSpec
from repro.launch import cells as JC
from repro.launch.mesh import make_mesh
from repro.models.gnn import equiformer_v2 as JE
from repro.training import optimizer as JOPT
import test_torch_partitioned_graph as M
from test_torch_gnn import EXACT

x = dict(np.load(sys.argv[1]))
out = {}
meshes = {k: make_mesh(*v) for k, v in M.MESHES.items()}

def path(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)

def save(prefix, tree):
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(filter(None, (prefix, path(kp))))] = np.asarray(leaf)

gcfg = M.gnn_cfg(get_config)
JC.get_config = lambda arch: gcfg
gp = jax.jit(JE.init_params, static_argnums=(0, 2, 3))(
    gcfg, jax.random.PRNGKey(3), M.F, 47)
save("p", gp)
batch = {k: jnp.asarray(v) for k, v in x.items()}

def run(mname, variant):
    name = f"{mname}/{variant}"
    jc = JC.build_gnn_cell("equiformer-v2", ShapeSpec(
        "full_graph_sm", "full_graph", M.SHAPE), meshes[mname], variant)
    assert jc.args[2]["src"].shape == (M.E_PAD,)
    st = jax.jit(JOPT.init_opt_state)(gp)
    new, st, m = jax.jit(jc.fn, in_shardings=jc.in_shardings,
                         compiler_options=EXACT)(gp, st, batch)
    save(f"{name}/new", new)
    save(f"{name}/m", jax.tree.map(lambda s: s["m"], st["per_leaf"],
         is_leaf=lambda s: isinstance(s, dict) and "m" in s))
    save(f"{name}/metrics", m)

# one thread a cell: XLA compiles them side by side
with ThreadPoolExecutor(4) as ex:
    for f in [ex.submit(run, m, v) for m in M.MESHES for v in M.VARIANTS]:
        f.result()
np.savez(sys.argv[2], **out)
print("PARTITIONED_GRAPH_REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("partitioned_graph_ref")
    x = inputs()
    np.savez(d / "in.npz", **x)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(d / "in.npz"),
         str(d / "out.npz"), os.path.abspath(__file__)],
        env=env, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0 and "PARTITIONED_GRAPH_REF_OK" in p.stdout, \
        p.stderr[-3000:]
    return x, dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("valid", [False, True], ids=["mask", "mask+valid"])
@pytest.mark.parametrize("mname", MESHES)
def test_flat_edges_match_local_edges(mname, valid):
    """``aggregate`` and ``softmax`` over 4 blocks of 11 edge slots (44:
    40 edges, 4 padding) against ``LocalEdges`` over the whole list:
    values and the gradients of a weighted sum of both into the messages
    and scores. Node 0 receives nothing, node 1 only from the first
    block; each softmax sums to 1 over a node's live edges."""
    r = np.random.default_rng(71)
    n, C, H = 12, 3, 2
    src, dst, emask = edges(r, n, 40, 44)
    msgs = torch.from_numpy(r.normal(size=(44, C)).astype(np.float32))
    scores = torch.from_numpy(3 * r.normal(size=(44, H)).astype(np.float32))
    ok = torch.from_numpy(r.random(44) > 0.2) if valid else None
    wa = torch.from_numpy(r.normal(size=(n, C)).astype(np.float32))
    ws = torch.from_numpy(r.normal(size=(44, H)).astype(np.float32))
    src, dst, emask = (torch.from_numpy(a) for a in (src, dst, emask))
    mesh = port_mesh(mname)
    flat = ("data", "model")
    P = SM.P

    def run(edge_fn):
        def fn(src_, dst_, em, m_, s_, ok_):
            plan = edge_fn(src_, dst_, em)
            return plan.aggregate(m_, ok_), plan.softmax(s_, ok_)
        return fn

    m1, s1 = msgs.clone().requires_grad_(), scores.clone().requires_grad_()
    a1, p1 = run(lambda s_, d_, e_: LocalEdges(s_, d_, e_, n))(
        src, dst, emask, m1, s1, ok)
    ((a1 * wa).sum() + (p1 * ws).sum()).backward()
    m2, s2 = msgs.clone().requires_grad_(), scores.clone().requires_grad_()
    body = run(lambda s_, d_, e_: FlatEdges(s_, d_, e_, n, flat))
    a2, p2 = SM.shard_map(body, mesh, (P(flat),) * 5 + (
        P(flat) if valid else P(),), (P(), P(flat)))(src, dst, emask, m2, s2,
                                                    ok)
    ((a2 * wa).sum() + (p2 * ws).sum()).backward()
    for what, got, want in (("aggregate", a2, a1), ("softmax", p2, p1)):
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=what)
    for what, got, want in (("msgs", m2.grad, m1.grad),
                            ("scores", s2.grad, s1.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=f"grad {what}")
    assert not a2[0].any() and a2[1].any()
    live = emask & (ok if valid else True)
    sums = torch.zeros(n, H).index_add(0, dst[live], p2.detach()[live])
    has = torch.zeros(n, dtype=torch.bool)
    has[dst[live]] = True
    np.testing.assert_allclose(sums[has].numpy(), 1.0, rtol=1e-6)
    assert not p2.detach()[~live].any()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mname", MESHES)
def test_full_graph_cell_matches_repro(ref, monkeypatch, mname, variant):
    """One step of ``full_graph_sm`` over the mesh: edges 16 a position,
    every node, weight and moment replicated; the step against
    ``repro``'s partitioned cell."""
    x, want = ref
    cfg = gnn_cfg(get_config)
    monkeypatch.setattr(TC, "get_config", lambda arch: cfg)
    c = TC.build_gnn_cell("equiformer-v2", ShapeSpec(
        "full_graph_sm", "full_graph", SHAPE), "cpu", variant,
        generator=torch.Generator(), mesh=port_mesh(mname))
    params, opt, batch = c.args
    assert batch["src"].slabs[0].shape == (E_PAD // 4,)
    assert batch["feat"].slabs[0].shape == (N, F)
    load_placed(params, want, "p")
    m = c.fn(params, opt, device_put(
        {k: torch.from_numpy(v) for k, v in x.items()},
        {k: v.sharding for k, v in batch.items()}, copy=True))
    check_step(m, want, f"{mname}/{variant}", params, opt, GNN_REL,
               MOLECULE_NOISE_REL)


@pytest.mark.parametrize("mname", MESHES)
def test_full_graph_mesh_step_is_the_one_device_step(monkeypatch, mname):
    """With float32 messages the partitioned step equals the port's
    one-device step on the same weights and graph (62 real edges, no
    padding there): loss and grad_norm rtol 1e-6, every parameter within
    1e-2 lr, the moments rtol 1e-4 (atol 1e-6 of the leaf's largest).
    Counting the replicated node work once per position instead of once
    would scale the gradients by 4."""
    cfg = gnn_cfg(get_config)
    monkeypatch.setattr(TC, "get_config", lambda arch: cfg)
    monkeypatch.setattr(E, "_msg_dtype", lambda c: torch.float32)
    x = inputs()
    shape = ShapeSpec("full_graph_sm", "full_graph", SHAPE)
    one = TC.build_gnn_cell("equiformer-v2", shape, "cpu",
                            generator=torch.Generator().manual_seed(4))
    placed = TC.build_gnn_cell("equiformer-v2", shape, "cpu",
                               generator=torch.Generator().manual_seed(4),
                               mesh=port_mesh(mname))
    params, opt, batch = placed.args
    b = {k: torch.from_numpy(v) for k, v in x.items()}
    m = placed.fn(params, opt, device_put(b, {k: v.sharding for k, v in
                                              batch.items()}, copy=True))
    m1 = one.fn(one.args[0], one.args[1],
                {k: (v[:E_REAL] if k in ("src", "dst", "emask") else v)
                 for k, v in b.items()})
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
