"""The port's GNN cells (``repro_torch.launch.cells.build_gnn_cell``) run
on the CPU at a small size against ``repro``'s: the molecule cell (base
and opt), a small full graph, the two-level minibatch cell and the
vertex-cut cell at one shard, one train step each from the same weights
and numpy inputs (``test_torch_cells.py`` holds every cell on ``meta``).

No test changes process-wide state (monkeypatch undoes every patch)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import cells as JC
from repro.launch.mesh import make_mesh
from repro.models.gnn import equiformer_v2 as JE
from repro_torch.configs import get_config
from repro_torch.launch import cells as TC
from repro_torch.models.gnn.graph import partition_edges
from test_torch_cells import (_check_step, _gen, _jshape, _patch, _run_train,
                              _shape_spec)
from test_torch_gnn import EXACT
from test_torch_gnn import reduced as gnn_reduced

torch.set_num_threads(1)

# the cells' bfloat16 messages against ``repro`` jitted EXACT: a float32
# product whose last bit differs flips a bfloat16 message and the flip
# spreads (test_torch_gnn.py); the forward's mean relative error stays
# small, but a loss of (energy - target)^2 over 3 graphs averages few
# outputs. Held within one bfloat16 unit roundoff; observed: loss 6.7e-4
# (molecule) and 0 (the other cells), grad_norm <= 1.5e-4
GNN_REL = 2 ** -8
# the same flips make a gradient element noisy at the bfloat16 precision
# of the leaf's largest terms: an element below 2^-6 x its leaf's largest
# |g| may take the other sign (observed: 0.2% of the elements, all below
# 1.02 x 2^-7 x the leaf's largest), so its AdamW update is held to 2 lr;
# every other element to a hundredth of lr
GNN_NOISE_REL = 2 ** -6


def _gnn(monkeypatch, f, n_out):
    tcfg, jcfg = gnn_reduced(get_config), gnn_reduced(jax_config)
    _patch(monkeypatch, tcfg, jcfg)
    init = jax.jit(JE.init_params, static_argnums=(0, 2, 3))
    return jax.tree.map(np.array, init(jcfg, jax.random.PRNGKey(0), f,
                                       n_out))


def _exact(fn):
    return jax.jit(fn, compiler_options=EXACT)


def _check_gnn(run, tc, what):
    _check_step(*run, tc, what, loss_rtol=GNN_REL, gn_rtol=GNN_REL,
                noise_rel=GNN_NOISE_REL)


def _pos(rng, shape):
    return rng.uniform(-2.0, 2.0, shape).astype(np.float32)


@pytest.mark.parametrize("variant", ["base", "opt"])
def test_gnn_molecule_cell_runs_as_repro(monkeypatch, variant):
    """3 graphs x 6 nodes x 12 edges (two masked): ``repro`` vmaps the
    graphs, the port runs them as one disjoint union."""
    jp = _gnn(monkeypatch, 4, 1)
    shape = _shape_spec("molecule", "batched_graphs",
                   dict(n_nodes=6, n_edges=12, batch=3, d_feat=4))
    jc = JC.build_gnn_cell("equiformer-v2", _jshape(shape), None, variant)
    tc = TC.build_gnn_cell("equiformer-v2", shape, "cpu", variant, _gen())
    rng = np.random.default_rng(3)
    emask = np.ones((3, 12), bool)
    emask[1, :2] = False
    batch = {"feat": rng.normal(size=(3, 6, 4)).astype(np.float32),
             "pos": _pos(rng, (3, 6, 3)),
             "src": rng.integers(0, 6, (3, 12)).astype(np.int32),
             "dst": rng.integers(0, 6, (3, 12)).astype(np.int32),
             "emask": emask,
             "target": rng.normal(size=(3,)).astype(np.float32)}
    _check_gnn(_run_train(jc, tc, jp, batch, jit=_exact), tc,
               f"molecule {variant}")


def test_gnn_full_graph_cell_runs_as_repro(monkeypatch):
    jp = _gnn(monkeypatch, 10, 47)
    shape = _shape_spec("full_graph_sm", "full_graph",
                   dict(n_nodes=24, n_edges=80, d_feat=10))
    jc = JC.build_gnn_cell("equiformer-v2", _jshape(shape), None)
    tc = TC.build_gnn_cell("equiformer-v2", shape, "cpu", generator=_gen())
    rng = np.random.default_rng(4)
    batch = {"feat": rng.normal(size=(24, 10)).astype(np.float32),
             "pos": _pos(rng, (24, 3)),
             "src": rng.integers(0, 24, 80).astype(np.int32),
             "dst": rng.integers(0, 24, 80).astype(np.int32),
             "emask": rng.random(80) > 0.1,
             "labels": rng.integers(0, 47, 24).astype(np.int32),
             "lmask": rng.random(24) > 0.25}
    _check_gnn(_run_train(jc, tc, jp, batch, jit=_exact), tc, "full_graph")


def _sharded(rng, n, e, cap, lead):
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    part = partition_edges(src, dst, n, 1, cap=cap)
    assert part["dropped"] == 0
    return {k: part[k].reshape(lead + (cap,))
            for k in ("esrc", "edstg", "emask", "rdst", "rsrcg", "rmask")}


def test_gnn_minibatch_cell_runs_as_repro(monkeypatch):
    """The two-level minibatch cell at dp = tp = 1: ``repro``'s
    ``shard_map`` on a 1 x 1 CPU mesh, the port's one ``ShardedEdges``
    shard; 4 seeds, fanout (2, 2): 28 nodes, 24 edges, cap 48."""
    jp = _gnn(monkeypatch, 10, 41)
    shape = _shape_spec("minibatch_lg", "minibatch",
                   dict(n_nodes=1000, n_edges=5000, batch_nodes=4,
                        fanout=(2, 2), d_feat=10))
    mesh = make_mesh((1, 1), ("data", "model"))
    jc = JC.build_gnn_cell("equiformer-v2", _jshape(shape), mesh)
    tc = TC.build_gnn_cell("equiformer-v2", shape, "cpu", generator=_gen())
    assert tc.note == jc.note == "two-level dp=1 x tp=1, cap=48"
    rng = np.random.default_rng(5)
    batch = {"feat": rng.normal(size=(1, 28, 10)).astype(np.float32),
             "pos": _pos(rng, (1, 28, 3)),
             "labels": rng.integers(0, 41, (1, 28)).astype(np.int32),
             "lmask": rng.random((1, 28)) > 0.25,
             **_sharded(rng, 28, 24, 48, (1, 1, 1))}
    _check_gnn(_run_train(jc, tc, jp, batch, jit=_exact), tc, "minibatch")


def test_gnn_vertex_cut_cell_runs_as_repro(monkeypatch):
    """The ogb_products-scale vertex-cut cell at one shard (S = 1).
    ``repro`` takes that path above 2,000,000 edges, so both cells are
    built for 2,000,001 edges (the port's own fill: cap 2,500,008) and
    run on a 24-node, 80-edge graph partitioned at cap 104; ``repro``'s
    ``shard_map`` runs on a 1 x 1 CPU mesh."""
    jp = _gnn(monkeypatch, 10, 47)
    shape = _shape_spec("ogb_products", "full_graph",
                   dict(n_nodes=24, n_edges=2_000_001, d_feat=10))
    mesh = make_mesh((1, 1), ("data", "model"))
    jc = JC.build_gnn_cell("equiformer-v2", _jshape(shape), mesh)
    tc = TC.build_gnn_cell("equiformer-v2", shape, "cpu", generator=_gen())
    assert tc.note == jc.note == "vertex-cut S=1 cap=2500008"
    rng = np.random.default_rng(6)
    batch = {"feat": rng.normal(size=(24, 10)).astype(np.float32),
             "pos": _pos(rng, (24, 3)),
             "labels": rng.integers(0, 47, 24).astype(np.int32),
             "lmask": rng.random(24) > 0.25,
             **_sharded(rng, 24, 80, 104, (1, 1))}
    _check_gnn(_run_train(jc, tc, jp, batch, jit=_exact), tc, "vertex-cut")
