"""The partitioned step's mechanism on a 4-position CPU mesh:
``ShardingPolicy.constrain`` between ``P()``, ``P("data")``,
``P(None, "model")`` and ``P(("data", "model"))`` (values, and gradients
against the unsharded identity's), the all_to_all transition
(Megatron-SP's sequence <-> heads), ``psum_scatter`` and ``pmax``,
placed (``Sharded``) arguments taken as their own slabs, resharded, and
placed outputs, the placed ``global_norm``, and a placed AdamW step with
clipping active on 2x2, 1x4 and 4x1 against ``repro``'s
``jax.jit(step, in_shardings=...)``.

``repro``/JAX run in ONE subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` on inputs this
module makes with numpy from a seed. Tolerances: constrain values and
gradients exact; ``psum_scatter`` bit for bit ``psum``'s block, rtol 1e-6
against JAX's; the AdamW step rtol 1e-6 (f32), its moments rtol 1e-5,
atol 1e-9."""
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.distributed import shard_map as SM
from repro_torch.distributed.sharding import (NamedSharding, P, Sharded,
                                              ShardingPolicy, device_put)
from repro_torch.launch.mesh import make_mesh
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_loop as TL

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}
LAYOUTS = {"P()": (), "P(data)": ("data", None),
           "P(None,model)": (None, "model"),
           "P((data,model))": (("data", "model"), None)}
# the AdamW model: a column-split, a row-split and a replicated leaf, and
# one split over dp that the body gathers whole (a ZeRO leaf)
SPECS = {"w1": (None, "model"), "b1": ("model",), "w2": ("model", None),
         "ln": (), "zero": ("data", None)}
OC = dict(lr=1e-2, warmup=0, clip_norm=0.05, total_steps=10)


def port_mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices=["cpu"] * 4)


def inputs() -> dict:
    r = np.random.default_rng(40)
    x = {"w1": r.normal(size=(16, 12)), "b1": r.normal(size=12),
         "w2": r.normal(size=(12, 8)), "ln": r.normal(size=16) * 0.1,
         "zero": r.normal(size=(16, 8)) * 0.1, "x": r.normal(size=(8, 16)),
         "ps": r.normal(size=(4, 8, 6)), "ps_w": r.normal(size=(8, 6))}
    return {k: v.astype(np.float32) for k, v in x.items()}


_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map
sys.path.insert(0, os.path.dirname(sys.argv[3]))
from repro.launch.mesh import make_mesh
from repro.training import optimizer as JOPT
from repro.training.train_loop import make_train_step
import test_torch_partitioned as M

x = dict(np.load(sys.argv[1]))
out = {}

def loss(p, b):
    h = jnp.tanh((b["x"] * (1.0 + p["ln"])) @ p["w1"] + p["b1"])
    y = h @ p["w2"] + b["x"] @ p["zero"]
    return jnp.sum(y * y) / b["x"].shape[0]

for name, (shape, axes) in M.MESHES.items():
    mesh = make_mesh(shape, axes)
    p = {k: jnp.asarray(x[k]) for k in M.SPECS}
    sh = {k: NamedSharding(mesh, P(*v)) for k, v in M.SPECS.items()}
    st = JOPT.init_opt_state(p)
    osh = {"step": NamedSharding(mesh, P()),
           "per_leaf": {k: {"m": sh[k], "v": sh[k]} for k in sh}}
    bsh = {"x": NamedSharding(mesh, P("data", None))}
    step = make_train_step(loss, JOPT.OptConfig(**M.OC), jit=False)
    new, st, m = jax.jit(step, in_shardings=(sh, osh, bsh))(
        p, st, {"x": jnp.asarray(x["x"])})
    for k in M.SPECS:
        out[f"{name}/new/{k}"] = np.asarray(new[k])
        out[f"{name}/m/{k}"] = np.asarray(st["per_leaf"][k]["m"])
        out[f"{name}/v/{k}"] = np.asarray(st["per_leaf"][k]["v"])
    for k in ("loss", "grad_norm", "lr"):
        out[f"{name}/metrics/{k}"] = np.asarray(m[k])

# psum_scatter over "model" (tiled), its output and gradient
mesh = make_mesh((2, 2), ("data", "model"))
flat = ("data", "model")
f = shard_map(lambda a: jax.lax.psum_scatter(a[0], "model",
                                             scatter_dimension=0, tiled=True),
              mesh=mesh, in_specs=(P(flat),), out_specs=P(flat),
              check_rep=False)
ps = jnp.asarray(x["ps"])
y = jax.jit(f)(ps)
w = jnp.tile(jnp.asarray(x["ps_w"]), (2, 1))[: y.shape[0]]
g = jax.jit(jax.grad(lambda a: jnp.sum(f(a) * w)))(ps)
out["ps/out"], out["ps/grad"] = np.asarray(y), np.asarray(g)
np.savez(sys.argv[2], **out)
print("PARTITIONED_REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("partitioned_ref")
    x = inputs()
    np.savez(d / "in.npz", **x)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(d / "in.npz"),
         str(d / "out.npz"), os.path.abspath(__file__)],
        env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0 and "PARTITIONED_REF_OK" in p.stdout, \
        p.stderr[-3000:]
    return x, dict(np.load(d / "out.npz"))


# ---------------------------------------------------------------------------
# constrain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("have,want", list(itertools.product(LAYOUTS,
                                                             LAYOUTS)))
def test_constrain_moves_blocks_and_gradients(have, want):
    """From each layout to each: the assembled result is the tensor
    itself, and the gradient of ``sum(w * out)`` is ``w`` (the unsharded
    identity's), whichever mix of slices and gathers moved it."""
    mesh = port_mesh("2x2")
    pol = ShardingPolicy(mesh)
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.normal(size=(8, 8)).astype(np.float32))
    w = torch.from_numpy(r.normal(size=(8, 8)).astype(np.float32))
    x.requires_grad_(True)
    h, wt = LAYOUTS[have], LAYOUTS[want]
    f = SM.shard_map(lambda a: pol.constrain(a, *(wt or (None, None)),
                                             have=h or (None, None)),
                     mesh, (P(*h),), P(*wt))
    out = f(x)
    assert torch.equal(out, x)
    (out * w).sum().backward()
    assert torch.equal(x.grad, w)


def test_constrain_sequence_to_heads_is_one_all_to_all():
    """Megatron-SP's move: rows split over model -> heads split over model
    is one all_to_all (no gather), its gradient the inverse one; outside
    a body, and without a mesh, ``constrain`` is the identity."""
    mesh = port_mesh("1x4")
    pol = ShardingPolicy(mesh)
    r = np.random.default_rng(2)
    x = torch.from_numpy(r.normal(size=(2, 8, 4, 3)).astype(np.float32))
    w = torch.from_numpy(r.normal(size=(2, 8, 4, 3)).astype(np.float32))
    x.requires_grad_(True)
    for k in SM.TRAFFIC:
        SM.TRAFFIC[k] = 0
    f = SM.shard_map(lambda a: pol.constrain(a, None, None, "sp", None,
                                             have=(None, "sp", None, None)),
                     mesh, (P(None, "model"),), P(None, None, "model"))
    out = f(x)
    assert torch.equal(out, x)
    assert SM.TRAFFIC["all_to_all"] > 0 and SM.TRAFFIC["all_gather"] == 0
    (out * w).sum().backward()
    assert torch.equal(x.grad, w)
    assert pol.constrain(x, None, "sp", None, None) is x
    assert ShardingPolicy(None).constrain(x, "dp") is x


# ---------------------------------------------------------------------------
# psum_scatter, pmax
# ---------------------------------------------------------------------------

def test_psum_scatter_matches_jax_and_psum(ref):
    """Each position's block of the sum over model, in ``psum``'s order:
    bit for bit ``psum``'s block; JAX's ``psum_scatter`` output and
    gradient (an all_gather of the cotangents); counted in TRAFFIC."""
    x, want = ref
    mesh = port_mesh("2x2")
    flat = ("data", "model")
    ps = torch.from_numpy(x["ps"]).requires_grad_(True)
    for k in SM.TRAFFIC:
        SM.TRAFFIC[k] = 0
    f = SM.shard_map(lambda a: SM.psum_scatter(a[0], "model", 0), mesh,
                     (P(flat),), P(flat))
    y = f(ps)
    assert SM.TRAFFIC["psum_scatter"] == 4 * 8 * 6 * 4 // 2
    via_psum = SM.shard_map(
        lambda a: SM.psum(a[0], "model").narrow(
            0, SM.axis_index("model") * 4, 4), mesh, (P(flat),), P(flat))
    assert torch.equal(y, via_psum(ps.detach()))
    np.testing.assert_allclose(y.detach().numpy(), want["ps/out"], rtol=1e-6)
    w = torch.from_numpy(np.tile(x["ps_w"], (2, 1))[:y.shape[0]])
    (y * w).sum().backward()
    np.testing.assert_allclose(ps.grad.numpy(), want["ps/grad"], rtol=1e-6)


def test_pmax_is_the_maximum_across_positions():
    mesh = port_mesh("2x2")
    x = torch.arange(16.0).reshape(4, 4)
    y = SM.shard_map(lambda a: SM.pmax(a, "model"), mesh,
                     (P(("data", "model")),), P("data"))(x)
    assert torch.equal(y, torch.stack([x[1], x[3]]))


# ---------------------------------------------------------------------------
# placed arguments and outputs
# ---------------------------------------------------------------------------

def test_placed_arguments_enter_as_their_own_slabs():
    """A ``Sharded`` whose spec is its in_spec reaches each position as
    its slab (the same storage: a body may update it in place); one with
    another spec is resharded; a ``Placed`` out_spec leaves the output
    placed (every position's block, nothing assembled)."""
    mesh = port_mesh("2x2")
    x = torch.arange(32.0).reshape(8, 4)
    placed = device_put(x, NamedSharding(mesh, P("data", None)), copy=True)
    seen = []

    def body(a):
        seen.append(a.data_ptr())
        a.add_(1.0)                       # in place, on the placed slab
        return a * 2.0
    out = SM.shard_map(body, mesh, (P("data"),), SM.Placed("data"))(placed)
    assert seen == [s.data_ptr() for s in placed.slabs]
    assert torch.equal(placed.gather(), x + 1.0)
    assert isinstance(out, Sharded) and out.shape == (8, 4)
    assert torch.equal(out.gather(), (x + 1.0) * 2.0)
    got = SM.shard_map(lambda a: a.clone(), mesh, (P(None, "model"),),
                       P(None, "model"))(placed)
    assert torch.equal(got, x + 1.0)
    assert len({s.data_ptr() for s in placed.slabs}) == 4


def test_placed_global_norm_counts_each_block_once():
    """A replicated leaf counts once, a split one by its distinct blocks:
    the placed norm is the whole tree's."""
    mesh = port_mesh("2x2")
    r = np.random.default_rng(3)
    t = {k: torch.from_numpy(r.normal(size=(4, 4)).astype(np.float32))
         for k in ("rep", "dp", "tp", "both")}
    specs = {"rep": P(), "dp": P("data"), "tp": P(None, "model"),
             "both": P("data", "model")}
    placed = {k: device_put(t[k], NamedSharding(mesh, specs[k]), copy=True)
              for k in t}
    gn = SM.shard_map(lambda p: OPT.global_norm(
        [p[k] for k in p], specs=[specs[k] for k in p]), mesh,
        (specs,), P())(placed)
    np.testing.assert_allclose(float(gn), float(OPT.global_norm(t.values())),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the placed AdamW step
# ---------------------------------------------------------------------------

def _port_step(mesh):
    """(the leaves' shardings, the loss body) of the AdamW model."""
    pol = ShardingPolicy(mesh)

    def loss(p, b):
        x = b["x"]
        zero = SM.all_gather(p["zero"], "data", axis=0, tiled=True) \
            if p["zero"].shape[0] < 16 else p["zero"]
        h = torch.tanh((x * (1.0 + p["ln"])) @ p["w1"] + p["b1"])
        y = SM.psum(h @ p["w2"], "model") + x @ zero
        return SM.psum(torch.sum(y * y), "data") / 8
    return {k: pol.named(*v) for k, v in SPECS.items()}, loss


@pytest.mark.parametrize("mname", list(MESHES))
def test_placed_adamw_step_matches_repro(ref, mname):
    """One placed step with clipping active (clip 0.05): loss, grad_norm
    (each block counted once), lr, the parameters (rtol 1e-6) and both
    moments, placed on the parameters' shardings and updated in place,
    against ``repro``'s jitted step with the same in_shardings."""
    x, want = ref
    mesh = port_mesh(mname)
    sh, loss = _port_step(mesh)
    params = device_put({k: torch.from_numpy(x[k]) for k in SPECS}, sh,
                        copy=True)
    opt = OPT.init_opt_state(params)
    assert all(opt["per_leaf"][k]["m"].sharding == sh[k] for k in SPECS)
    bsh = {"x": ShardingPolicy(mesh).named("dp", None)}
    batch = device_put({"x": torch.from_numpy(x["x"])}, bsh, copy=True)
    oc = OPT.OptConfig(**OC)
    step = TL.make_train_step(loss, oc, mesh=mesh,
                              in_specs=(sh, SM.in_specs_of(opt), bsh))
    ptrs = [s.data_ptr() for k in SPECS for s in params[k].slabs]
    m = step(params, opt, batch)
    assert ptrs == [s.data_ptr() for k in SPECS for s in params[k].slabs]
    jm = {k: float(want[f"{mname}/metrics/{k}"]) for k in
          ("loss", "grad_norm", "lr")}
    assert jm["grad_norm"] > oc.clip_norm                # clipping acts
    for k in jm:
        np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-6, err_msg=k)
    for k in SPECS:
        np.testing.assert_allclose(params[k].gather().detach().numpy(),
                                   want[f"{mname}/new/{k}"], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        for mom in ("m", "v"):
            np.testing.assert_allclose(
                opt["per_leaf"][k][mom].gather().numpy(),
                want[f"{mname}/{mom}/{k}"], rtol=1e-5, atol=1e-9,
                err_msg=f"{k} {mom}")
    assert all(int(s) == 1 for s in opt["step"].slabs)
