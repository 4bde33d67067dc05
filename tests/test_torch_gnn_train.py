"""The GNN family's losses and training path against ``repro`` on the CPU:
``node_ce_loss`` and the molecule cell's batched ``graph_energy_loss`` (the
port's disjoint union against ``jax.vmap``) with every gradient against
``jax.grad``, ``tests/test_archs.py``'s two train steps (the port's eager
``make_train_step`` against ``repro``'s jitted one from the same weights,
AdamW on every leaf), weights across the packages and ``{"params",
"opt"}`` train states written by either package and restored by the
other bit for bit.

Inputs come from ``np.random.default_rng(seed)``; no test changes
process-wide state."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.gnn import equiformer_v2 as JE
from repro.models.gnn.graph import LocalEdges as JLocal
from repro.training import checkpoint as JCKPT
from repro.training import optimizer as JOPT
from repro.training.train_loop import make_train_step as jax_train_step
from repro_torch.configs import get_config
from repro_torch.models.gnn import equiformer_v2 as E
from repro_torch.models.gnn.graph import LocalEdges
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_state as TS
from repro_torch.training.train_loop import make_train_step
from test_torch_gnn import (EG, F, N, N_OUT, both, graph_inputs, jax_params,
                            reduced)

torch.set_num_threads(1)

# losses: float32 sums reordered between XLA and PyTorch
LOSS_RTOL = 1e-5
# gradients against jax.grad: the backward pass sums over edges and
# nodes; observed at most 8.9e-8 absolute on gradients up to 0.37, and
# the loss equal
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# test_archs.py's optimizer settings, two steps; parameters after each
STEP_RTOL, PARAM_ATOL = 1e-4, 1e-6
OC = dict(lr=1e-3, warmup=1, total_steps=10)


def node_batch():
    """The graph and batch every train test uses (one compile a jitted
    ``repro`` function)."""
    rng = np.random.default_rng(3)
    src, dst, feat, pos = graph_inputs(rng)
    labels = rng.integers(0, N_OUT, N).astype(np.int32)
    lmask = rng.random(N) > 0.25
    return src, dst, {"feat": feat, "pos": pos, "labels": labels,
                      "lmask": lmask}


def t(b: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in b.items()}


def port_node_loss(cfg, src, dst):
    plan = LocalEdges(torch.as_tensor(src), torch.as_tensor(dst),
                      torch.ones(EG, dtype=torch.bool), N)
    return lambda m, b: E.node_ce_loss(cfg, m, plan, b["feat"], b["pos"],
                                       b["labels"], b["lmask"])


@functools.lru_cache(maxsize=None)
def jax_fns():
    """``repro``'s jitted loss-and-gradient and train step over
    ``node_batch``'s graph, reduced config, AdamW on every leaf."""
    src, dst, _ = node_batch()
    jcfg = reduced(jax_config)
    plan = JLocal(jnp.asarray(src), jnp.asarray(dst), jnp.ones(EG, bool), N)

    def loss(p, b):
        return JE.node_ce_loss(jcfg, p, plan, b["feat"], b["pos"],
                               b["labels"], b["lmask"])
    jlab = JOPT.default_labels(jax_params(0))
    jstep = jax_train_step(loss, JOPT.OptConfig(**OC), labels=jlab,
                           donate=False)
    return jax.jit(jax.value_and_grad(loss)), jstep, jlab


def check_grads(model, jgrads, what):
    for name, want in zip(model.jax_leaf_names(), jax.tree.leaves(jgrads)):
        ps = model.jax_leaf_params(name)
        got = torch.stack([p.grad for p in ps]) if model.jax_stacked(
            name) else ps[0].grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"{what} grad {name}")


@pytest.mark.parametrize("fused,remat", [(False, False), (True, True)])
def test_node_ce_loss_and_grads_match_repro(fused, remat):
    """The loss over labelled nodes and every gradient against
    ``jax.grad`` of ``repro``'s unfused, unrematerialised loss (the fused
    rotation is exact and ``remat`` recomputes the same ops); ``remat``
    runs the port's per-layer checkpoint, whose gradients equal the
    plain backward's bit for bit."""
    cfg, _, model, jp = both(fused_rotation=fused, remat=remat)
    src, dst, b = node_batch()
    loss = port_node_loss(cfg, src, dst)(model, t(b))
    loss.backward()
    jl, jg = jax_fns()[0](jp, b)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    check_grads(model, jg, "node_ce")
    if remat:
        plain_cfg = dataclasses.replace(cfg, remat=False)
        plain = E.params_from_jax(plain_cfg, jp, device="cpu")
        port_node_loss(plain_cfg, src, dst)(plain, t(b)).backward()
        for (name, p), q in zip(model.named_parameters(),
                                plain.parameters()):
            assert torch.equal(p.grad, q.grad), name


def test_batched_graph_energy_loss_matches_vmap():
    """The molecule cell: G graphs as one disjoint union in the port, the
    mean of ``jax.vmap``'d ``graph_energy_loss`` in ``repro``
    (``launch/cells.py``'s loss); loss and every gradient. The union's
    loss is the mean of the port's ``graph_energy_loss`` over each graph
    alone. One layer (the reduced config's other widths): the vmapped
    gradient's compile is most of this test's time."""
    rng = np.random.default_rng(2)
    Gn, NN, EE, Fm = 4, 6, 10, 7
    cfg = reduced(get_config, n_layers=1)
    jcfg = reduced(jax_config, n_layers=1)
    jp = jax.tree.map(np.array, jax.jit(
        JE.init_params, static_argnums=(0, 2, 3))(
            jcfg, jax.random.PRNGKey(3), Fm, 1))
    model = E.params_from_jax(cfg, jp, device="cpu")
    b = {"feat": rng.normal(size=(Gn, NN, Fm)).astype(np.float32),
         "pos": (rng.normal(size=(Gn, NN, 3)) * 2).astype(np.float32),
         "src": rng.integers(0, NN, (Gn, EE)).astype(np.int32),
         "dst": rng.integers(0, NN, (Gn, EE)).astype(np.int32),
         "emask": rng.random((Gn, EE)) > 0.2,
         "target": rng.normal(size=Gn).astype(np.float32)}
    b["src"][:, 0] = b["dst"][:, 0]                  # a self-loop a graph

    def jloss(p, b):
        def one(feat, pos, src, dst, emask, target):
            plan = JLocal(src, dst, emask, NN)
            return JE.graph_energy_loss(jcfg, p, plan, feat, pos, target)
        return jnp.mean(jax.vmap(one)(b["feat"], b["pos"], b["src"],
                                      b["dst"], b["emask"], b["target"]))
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp, b)
    tb = t(b)
    loss = E.batched_graph_energy_loss(cfg, model, tb["feat"], tb["pos"],
                                       tb["src"], tb["dst"], tb["emask"],
                                       tb["target"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    check_grads(model, jg, "graph_energy")
    with torch.no_grad():
        alone = [E.graph_energy_loss(
            cfg, model, LocalEdges(tb["src"][g], tb["dst"][g],
                                   tb["emask"][g], NN),
            tb["feat"][g], tb["pos"][g], tb["target"][g]) for g in range(Gn)]
    np.testing.assert_allclose(float(torch.stack(alone).mean()),
                               float(loss.detach()), rtol=LOSS_RTOL)


def test_label_maps_match_repro():
    """Every leaf is AdamW in both packages (``embed`` is not ``emb``)."""
    _, _, model, jp = both()
    labels = OPT.default_labels(dict(model.named_parameters()))
    assert set(labels.values()) == {"adamw"}
    assert set(jax.tree.leaves(JOPT.default_labels(jp))) == {"adamw"}


def test_train_steps_match_repro():
    """``test_archs.py``'s ``test_equiformer_train_step``, port against
    ``repro``: two steps on one batch, loss, grad_norm and lr per step and
    every parameter after each step; the loss falls."""
    cfg, _, model, jp = both()
    src, dst, b = node_batch()
    _, jstep, jlab = jax_fns()
    jst = JOPT.init_opt_state(jp, jlab)
    named = dict(model.named_parameters())
    labels = OPT.default_labels(named)
    step = make_train_step(port_node_loss(cfg, src, dst),
                           OPT.OptConfig(**OC), labels=labels)
    st = OPT.init_opt_state(named, labels)
    losses = []
    for i in range(2):
        jp, jst, jm = jstep(jp, jst, b)
        m = step(model, st, t(b))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=STEP_RTOL,
                                       err_msg=f"step {i + 1} {key}")
        for name, got, want in zip(model.jax_leaf_names(),
                                   model.to_jax_leaves(), jax.tree.leaves(jp)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=STEP_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"step {i + 1} {name}")
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[1] < losses[0]


def test_params_round_trip():
    """``params_from_jax`` then ``to_jax_leaves`` gives ``repro``'s leaves
    bit for bit, in ``jax.tree.leaves`` order and with its shapes; a
    port-initialised model goes back through ``params_from_jax``."""
    cfg, _, model, jp = both()
    want = jax.tree.leaves(jp)
    got = E.to_jax_leaves(model)
    assert len(got) == len(want) == len(model.jax_leaf_names())
    for name, a, w in zip(model.jax_leaf_names(), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w), err_msg=name)
    paths = ["/".join(str(k.key) for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert model.jax_leaf_names() == paths
    fresh = E.init_params(cfg, F, N_OUT, torch.Generator().manual_seed(4),
                          device="cpu")
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jp),
        [x.numpy() for x in E.to_jax_leaves(fresh)])
    again = E.params_from_jax(cfg, tree, device="cpu")
    for a, w in zip(again.parameters(), fresh.parameters()):
        assert torch.equal(a, w)
    n_jax = sum(np.asarray(x).size for x in want)
    assert sum(p.numel() for p in model.parameters()) == n_jax


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_train_state_restores_across_packages(tmp_path, writer):
    """One step in one package, the ``{"params", "opt"}`` train state
    saved, restored in the other: bit for bit (moments, step,
    parameters, the layer stacks included), and step 2 there equals
    step 2 in the writer."""
    cfg, _, model, jp = both()
    src, dst, b = node_batch()
    _, jstep, jlab = jax_fns()
    jst = JOPT.init_opt_state(jp, jlab)
    named = dict(model.named_parameters())
    st = OPT.init_opt_state(named)
    step = make_train_step(port_node_loss(cfg, src, dst),
                           OPT.OptConfig(**OC))
    if writer == "repro":
        jp, jst, _ = jstep(jp, jst, b)
        JCKPT.save(str(tmp_path), 1, {"params": jp, "opt": jst})
        fresh = E.init_params(cfg, F, N_OUT, torch.Generator().manual_seed(5),
                              device="cpu")
        fst = OPT.init_opt_state(dict(fresh.named_parameters()))
        meta = TS.restore(str(tmp_path), fresh, fst, TS.LM_KEYS)
        assert meta["step"] == 1
        for got, want in zip(TS.leaves(fresh, fst),
                             jax.tree.leaves({"params": jp, "opt": jst})):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        model, st = fresh, fst
    else:
        step(model, st, t(b))
        TS.save(str(tmp_path), 1, model, st, keys=TS.LM_KEYS)
        saved = TS.leaves(model, st)
        restored, meta = JCKPT.restore(str(tmp_path),
                                       {"params": jp, "opt": jst})
        assert meta["leaf_names"] == TS.leaf_names(model, st, TS.LM_KEYS)
        assert "opt/per_leaf/layers/conv_src/w0/m" in meta["leaf_names"]
        for got, want in zip(jax.tree.leaves(restored), saved):
            np.testing.assert_array_equal(np.asarray(got), want.numpy())
        jp, jst = restored["params"], restored["opt"]
    jp, jst, jm = jstep(jp, jst, b)
    m = step(model, st, t(b))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=STEP_RTOL)
    for name, got, want in zip(model.jax_leaf_names(), model.to_jax_leaves(),
                               jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=STEP_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"resumed step 2 {name}")


def test_entry_points_raise_without_a_card():
    """``EquiformerV2``, ``init_params`` and ``params_from_jax`` run on the
    card by default and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg, _, _, jp = both()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.EquiformerV2(cfg, F, N_OUT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.init_params(cfg, F, N_OUT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.params_from_jax(cfg, jp)
