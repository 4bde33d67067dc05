"""The single-controller ``shard_map`` and its collectives, the compressed
all-reduce, ``remesh``/``reshard_tree``, ``restore(shardings=)`` and the
spec functions: the port against ``repro`` and JAX.

``repro``'s 4-device references run in ONE subprocess (fake CPU devices
must exist before JAX starts: ``XLA_FLAGS=
--xla_force_host_platform_device_count=4``), on inputs this module makes
with numpy from a seed and hands over in an ``.npz``; the port runs the
same inputs on ``make_mesh(..., devices=["cpu"] * 4)``. Each collective
case is one body written once for both packages (an ``ops`` namespace
holds each side's collectives), run through ``shard_map`` on a (4,) or
(2, 2) mesh with ``check_rep=False``; its gradient is that of the sum of
the output times a fixed weight.

Tolerances: ids, specs, codes and int32 sums exact; values rtol 1e-5,
atol 1e-6; gradients rtol 1e-3, atol 1e-6. The pure spec functions run in
this process (no mesh is needed)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import kv_cache as JKV
from repro.models import transformer as JT
from repro.models.gnn import equiformer_v2 as JE
from repro.models.recsys import embedding as JEMB
from repro.training import optimizer as JOPT
from repro_torch.configs import get_config
from repro_torch.distributed import shard_map as SM
from repro_torch.distributed import sharding as TSH
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import kv_cache as TKV
from repro_torch.models import transformer as TT
from repro_torch.models.gnn import equiformer_v2 as TE
from repro_torch.models.recsys import embedding as TEMB
from repro_torch.training import checkpoint as TCK
from repro_torch.training import compression as TCMP
from repro_torch.training import elastic as TEL
from repro_torch.training import optimizer as TOPT

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = dict(rtol=1e-5, atol=1e-6)
GTOL = dict(rtol=1e-3, atol=1e-6)
LM_ARCHS = ("gemma2-9b", "gemma3-4b", "minicpm-2b", "granite-moe-1b-a400m",
            "olmoe-1b-7b")
MESHES = {"4": ((4,), ("data",)), "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}


def port_mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


# ---------------------------------------------------------------------------
# collective cases: one body for both packages
# ---------------------------------------------------------------------------

DA, MO, BOTH = "data", "model", ("data", "model")


def _sq_sum(o, b):
    return o.psum(o.sum(b * b), DA)


def _unreduced(o, b):
    return o.sum(b * b)


def _rep_in_sharded_out(o, b):
    return b * (1 + o.axis_index(DA))


def _rep_in_rep_out(o, b):
    return o.sum(b * b) * (1 + o.axis_index(DA))


def _psum_one_axis(o, b):
    return o.psum(o.sum(b * b, 0, True), MO)


def _psum_both(o, b):
    return o.psum(b * b, BOTH)


def _gather_tiled(o, b):
    return o.all_gather(b, DA, 0, True) * (1.0 + o.axis_index(DA))


def _gather_stacked(o, b):
    return o.all_gather(b, MO, 0, False) * (1.0 + o.axis_index(BOTH))


def _a2a(o, b):
    return o.all_to_all(b, DA, 0, 0)


def _a2a_cols(o, b):
    return o.all_to_all(b * (1.0 + o.axis_index(MO)), MO, 1, 0)


def _a2a_both(o, b):
    return o.sin(o.all_to_all(b * b, BOTH, 0, 0))


def _index_order(o, b):
    return b * (1 + o.axis_index((MO, DA))) + o.axis_size(BOTH)


def _psum_scalar(o, b):
    return o.psum(b * b, DA) / o.psum(1, DA) * (2.0 + o.axis_index(DA))


def _remat(o, b, c):
    def region(x, y):
        z = o.all_to_all(x * y, DA, 0, 0)
        return o.sin(z * z) * y
    return o.psum(o.sum(o.checkpoint(region)(b, c)), DA)


def _two_args(o, b, c):
    return o.psum(b * c, MO) + c * o.axis_index(DA)


# name -> (mesh, in specs, out specs, body, input shapes)
CASES = {
    "psum_sq_sum": ("4", ((DA,),), (), _sq_sum, [(8,)]),
    "unreduced_under_P()": ("4", ((DA,),), (), _unreduced, [(8,)]),
    "replicated_in_sharded_out": ("4", ((),), (DA,), _rep_in_sharded_out,
                                  [(8,)]),
    "replicated_in_and_out": ("4", ((),), (), _rep_in_rep_out, [(8,)]),
    "psum_one_axis_2x2": ("2x2", ((BOTH,),), (DA,), _psum_one_axis,
                          [(8, 3)]),
    "psum_both_axes_2x2": ("2x2", ((BOTH, None),), (BOTH, None), _psum_both,
                           [(8, 3)]),
    "all_gather_tiled": ("4", ((DA,),), (DA,), _gather_tiled, [(8,)]),
    "all_gather_stacked_2x2": ("2x2", ((BOTH, None),), (DA, None),
                               _gather_stacked, [(8, 2)]),
    "all_to_all": ("4", ((DA,),), (DA,), _a2a, [(16,)]),
    "all_to_all_cols_2x2": ("2x2", ((DA, MO),), (DA, MO), _a2a_cols,
                            [(4, 8)]),
    "all_to_all_both_axes_2x2": ("2x2", ((BOTH,),), (BOTH,), _a2a_both,
                                 [(32,)]),
    "axis_index_order_2x2": ("2x2", ((None, MO),), (DA, MO), _index_order,
                             [(3, 4)]),
    "psum_of_a_count": ("4", ((DA,),), (DA,), _psum_scalar, [(8,)]),
    "checkpoint_replays_collectives": ("4", ((DA,), (DA,)), (), _remat,
                                       [(16,), (16,)]),
    "two_args_2x2": ("2x2", ((DA, MO), (None, MO)), (DA, MO), _two_args,
                     [(4, 6), (2, 6)]),
}


def case_inputs(name) -> list:
    r = np.random.default_rng(sum(map(ord, name)))
    return [r.normal(size=s).astype(np.float32) for s in CASES[name][4]]


def weight(shape) -> np.ndarray:
    n = int(np.prod(shape))
    return np.cos(np.arange(n) * 0.7 + 0.3).astype(np.float32).reshape(shape)


class TorchOps:
    psum = staticmethod(SM.psum)
    axis_index = staticmethod(SM.axis_index)
    axis_size = staticmethod(SM.axis_size)
    sin = staticmethod(torch.sin)

    @staticmethod
    def sum(x, axis=None, keepdims=False):
        return x.sum() if axis is None else x.sum(axis, keepdim=keepdims)

    @staticmethod
    def all_gather(x, ax, axis, tiled):
        return SM.all_gather(x, ax, axis=axis, tiled=tiled)

    @staticmethod
    def all_to_all(x, ax, s, c):
        return SM.all_to_all(x, ax, s, c, tiled=True)

    @staticmethod
    def checkpoint(f):
        return lambda *a: SM.checkpoint(f, *a)


def port_case(name):
    """(output, gradients) of the port's run of a case."""
    mesh, ins, outs, body, _ = CASES[name]
    xs = [torch.tensor(a, requires_grad=True) for a in case_inputs(name)]
    f = SM.shard_map(lambda *b: body(TorchOps, *b), port_mesh(mesh),
                     in_specs=tuple(SM.P(*s) for s in ins),
                     out_specs=SM.P(*outs))
    out = f(*xs)
    (out * torch.from_numpy(weight(tuple(out.shape)))).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in xs]


# ---------------------------------------------------------------------------
# the other references' inputs
# ---------------------------------------------------------------------------

RESHARD_SPECS = {"w": (None, "tp"), "e": ("tp", None), "b": ("dp",),
                 "z": (("dp", "tp"), None), "step": ()}


def reshard_inputs() -> dict:
    r = np.random.default_rng(11)
    return {"w": r.normal(size=(8, 8)).astype(np.float32),
            "e": r.normal(size=(16, 4)).astype(np.float32),
            "b": r.normal(size=(8,)).astype(np.float32),
            "z": r.integers(-9, 9, size=(8, 2)).astype(np.int32),
            "step": np.asarray(7, np.int32)}


def grads_inputs() -> dict:
    r = np.random.default_rng(12)
    return {"g_a": (r.normal(size=(4, 5, 3)) * 3).astype(np.float32),
            "g_b": (r.normal(size=(4, 7)) * 1e-3).astype(np.float32),
            "r_a": (r.normal(size=(4, 5, 3)) * 1e-2).astype(np.float32),
            "r_b": (r.normal(size=(4, 7)) * 1e-5).astype(np.float32)}


REMESH = ((4, 2), (4, 4), (4, 1), (3, 2), (4, 3))

_REPRO_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map
sys.path.insert(0, os.path.dirname(sys.argv[3]))
from repro.launch.mesh import make_mesh
from repro.distributed.sharding import ShardingPolicy
from repro.training import compression as JC, elastic as JEL
from repro.training import checkpoint as JCK
from repro.models import transformer as JT
from repro.configs import get_config
import test_torch_shard_map as M

assert len(jax.devices()) == 4
out = {}
meshes = {k: make_mesh(*v) for k, v in M.MESHES.items()}

class JaxOps:
    psum = staticmethod(jax.lax.psum)
    axis_index = staticmethod(jax.lax.axis_index)
    sin = staticmethod(jnp.sin)
    checkpoint = staticmethod(jax.checkpoint)
    @staticmethod
    def axis_size(ax):
        return jax.lax.psum(1, ax)
    @staticmethod
    def sum(x, axis=None, keepdims=False):
        return jnp.sum(x, axis=axis, keepdims=keepdims)
    @staticmethod
    def all_gather(x, ax, axis, tiled):
        return jax.lax.all_gather(x, ax, axis=axis, tiled=tiled)
    @staticmethod
    def all_to_all(x, ax, s, c):
        return jax.lax.all_to_all(x, ax, s, c, tiled=True)

for name, (mesh, ins, outs, body, _) in M.CASES.items():
    xs = [jnp.asarray(a) for a in M.case_inputs(name)]
    f = shard_map(lambda *b, body=body: body(JaxOps, *b), mesh=meshes[mesh],
                  in_specs=tuple(P(*s) for s in ins), out_specs=P(*outs),
                  check_rep=False)
    y = jax.jit(f)(*xs)
    w = jnp.asarray(M.weight(y.shape))
    gs = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * w),
                          argnums=tuple(range(len(xs)))))(*xs)
    out[f"case/{name}/out"] = np.asarray(y)
    for i, g in enumerate(gs):
        out[f"case/{name}/grad{i}"] = np.asarray(g)

# psum_compressed on a dp = 4 mesh: each shard's own gradients
g = M.grads_inputs()
def body(ga, gb, ra, rb):
    grads, res = {"a": ga[0], "b": gb[0]}, {"a": ra[0], "b": rb[0]}
    avg, rs = JC.psum_compressed(grads, res, "data")
    qs, ss, _ = JC.compress_grads(grads, res)
    summed = {k: jax.lax.psum(q.astype(jnp.int32), "data")
              for k, q in qs.items()}
    lead = lambda t: {k: v[None] for k, v in t.items()}
    return lead(avg), lead(rs), lead(summed), lead(qs)
f = shard_map(body, mesh=meshes["4"], in_specs=(P("data"),) * 4,
              out_specs=P("data"), check_rep=False)
res = jax.jit(f)(*[jnp.asarray(g[k]) for k in ("g_a", "g_b", "r_a", "r_b")])
for part, t in zip(("avg", "rs", "summed", "codes"), res):
    for k, v in t.items():
        out[f"cmp/{part}/{k}"] = np.asarray(v)

# remesh: shapes
for n, mp in M.REMESH:
    m = JEL.remesh(n, mp, devices=jax.devices()[:n])
    out[f"remesh/{n}/{mp}"] = np.asarray([m.shape["data"], m.shape["model"]])

# reshard_tree and restore(shardings=): every position's slab
x = M.reshard_inputs()
for mname in ("2x2", "1x4", "4x1"):
    mesh = meshes[mname]
    placed = JEL.reshard_tree({k: jnp.asarray(v) for k, v in x.items()},
                              M.RESHARD_SPECS, mesh)
    pol = ShardingPolicy(mesh)
    names = list(x)
    shard_tree = [pol.named(*M.RESHARD_SPECS[k]) for k in names]
    restored, _ = JCK.restore(sys.argv[4], [x[k] for k in names],
                              shardings=shard_tree)
    for k, got in list(placed.items()) + [
            ("ckpt_" + k, v) for k, v in zip(names, restored)]:
        by_dev = {s.device: np.asarray(s.data) for s in got.addressable_shards}
        for r, d in enumerate(mesh.devices.flat):
            out[f"reshard/{mname}/{k}/{r}"] = by_dev[d]

# param_shardings at (2, 2): each leaf's spec, by path
for arch in M.LM_ARCHS:
    cfg = get_config(arch)
    sh = JT.param_shardings(cfg, ShardingPolicy(meshes["2x2"]))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        sh, is_leaf=lambda s: isinstance(s, NamedSharding))
    for path, s in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[f"pshard/{arch}/{key}"] = np.asarray(repr(tuple(s.spec)))
np.savez(sys.argv[2], **out)
print("SHARD_MAP_REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard_map_ref")
    x = reshard_inputs()
    TCK.save(str(d / "ckpt"), 3, [x[k] for k in x], meta={})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    got = subprocess.run(
        [sys.executable, "-c", _REPRO_SCRIPT, "-", str(d / "out.npz"),
         os.path.abspath(__file__), str(d / "ckpt")],
        env=env, capture_output=True, text=True, timeout=600)
    assert got.returncode == 0 and "SHARD_MAP_REF_OK" in got.stdout, \
        got.stderr[-3000:]
    return d, dict(np.load(d / "out.npz"))


# ---------------------------------------------------------------------------
# collectives: values and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_collective_value_matches_repro(ref, name):
    got, _ = port_case(name)
    want = ref[1][f"case/{name}/out"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_collective_grad_matches_jax_grad(ref, name):
    _, grads = port_case(name)
    for i, g in enumerate(grads):
        np.testing.assert_allclose(g, ref[1][f"case/{name}/grad{i}"], **GTOL,
                                   err_msg=f"{name} arg {i}")


def test_all_to_all_tiled_order():
    """Shard r's chunk j goes to shard j, concatenated by source: [0..15]
    over 4 shards becomes [0, 4, 8, 12, 1, 5, 9, 13, ...]."""
    out = SM.shard_map(lambda b: SM.all_to_all(b, "data", 0, 0, tiled=True),
                       port_mesh("4"), SM.P("data"), SM.P("data"))(
        torch.arange(16.0))
    assert out.tolist() == [float(4 * (i % 4) + i // 4) for i in range(16)]


def test_collectives_outside_shard_map_raise():
    for f in (lambda: SM.psum(torch.ones(2), "data"),
              lambda: SM.axis_index("data"),
              lambda: SM.all_to_all(torch.ones(4), "data", 0, 0, tiled=True)):
        with pytest.raises(RuntimeError, match="inside a shard_map body"):
            f()
    assert not SM.in_shard_map()


def test_failure_on_one_position_fails_the_call():
    """A position that raises, or that skips a collective the others
    wait at, fails the whole call; no thread is left waiting."""
    mesh = port_mesh("4")

    def raises(b):
        if SM.axis_index("data") == 2:
            raise ValueError("position 2 failed")
        return SM.psum(b, "data")

    def skips(b):
        return b if SM.axis_index("data") == 1 else SM.psum(b, "data")

    with pytest.raises(ValueError, match="position 2 failed"):
        SM.shard_map(raises, mesh, SM.P("data"), SM.P("data"))(torch.ones(4))
    with pytest.raises(RuntimeError, match="different collectives"):
        SM.shard_map(skips, mesh, SM.P("data"), SM.P("data"))(torch.ones(4))
    with pytest.raises(RuntimeError, match="inside a shard_map body"):
        SM.shard_map(lambda b: SM.shard_map(lambda c: c, mesh, SM.P(),
                                            SM.P())(b),
                     mesh, SM.P(), SM.P())(torch.ones(4))
    import threading
    assert threading.active_count() < 8


def test_grad_mode_reaches_every_position():
    mesh = port_mesh("2x2")
    seen = []

    def body(b):
        seen.append(torch.is_grad_enabled())
        return SM.psum(b, ("data", "model"))

    x = torch.ones(4, requires_grad=True)
    with torch.no_grad():
        y = SM.shard_map(body, mesh, SM.P(("data", "model")),
                         SM.P(("data", "model")))(x)
    assert seen == [False] * 4 and not y.requires_grad
    seen.clear()
    y = SM.shard_map(body, mesh, SM.P(("data", "model")),
                     SM.P(("data", "model")))(x)
    assert seen == [True] * 4 and y.requires_grad


def test_dict_arguments_and_outputs():
    """Trees of tensors split by a spec or a tree of specs, and outputs
    assembled per leaf."""
    mesh = port_mesh("4")
    x = {"a": torch.arange(8.0), "b": torch.arange(4.0)}
    out = SM.shard_map(lambda t: {"s": SM.psum(t["a"].sum(), "data"),
                                  "b": t["b"] * 2},
                       mesh, ({"a": SM.P("data"), "b": SM.P()},),
                       {"s": SM.P(), "b": SM.P()})(x)
    assert float(out["s"]) == 28.0
    assert out["b"].tolist() == [0.0, 2.0, 4.0, 6.0]


# ---------------------------------------------------------------------------
# psum_compressed
# ---------------------------------------------------------------------------

def _port_compressed():
    g = {k: torch.from_numpy(v) for k, v in grads_inputs().items()}

    def body(ga, gb, ra, rb):
        grads, res = {"a": ga[0], "b": gb[0]}, {"a": ra[0], "b": rb[0]}
        avg, rs = TCMP.psum_compressed(grads, res, "data")
        qs, _, _ = TCMP.compress_grads(grads, res)
        summed = {k: SM.psum(q.to(torch.int32), "data")
                  for k, q in qs.items()}

        def lead(t):
            return {k: v[None] for k, v in t.items()}
        return lead(avg), lead(rs), lead(summed), lead(qs)
    return SM.shard_map(body, port_mesh("4"), (SM.P("data"),) * 4,
                        SM.P("data"))(g["g_a"], g["g_b"], g["r_a"], g["r_b"])


@pytest.mark.parametrize("part", ["avg", "rs", "summed", "codes"])
def test_psum_compressed_matches_repro(ref, part):
    """Codes and their int32 sums exact; each shard's average (the sum
    times the shard's OWN scale, over n) and residual rtol 1e-5."""
    got = dict(zip(("avg", "rs", "summed", "codes"), _port_compressed()))
    for k in ("a", "b"):
        want = ref[1][f"cmp/{part}/{k}"]
        g = got[part][k].numpy()
        if part in ("summed", "codes"):
            assert g.dtype == want.dtype
            np.testing.assert_array_equal(g, want, err_msg=k)
        else:
            np.testing.assert_allclose(g, want, **TOL, err_msg=k)
    if part == "avg":           # differs per shard: each keeps its scale
        a = got["avg"]["a"]
        assert not all(torch.equal(a[0], a[i]) for i in range(1, 4))


# ---------------------------------------------------------------------------
# remesh, reshard_tree, restore(shardings=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,mp", REMESH)
def test_remesh_matches_repro(ref, n, mp):
    m = TEL.remesh(n, mp, devices=["cpu"] * n)
    assert m.axis_names == ("data", "model")
    assert [m.shape["data"], m.shape["model"]] == \
        ref[1][f"remesh/{n}/{mp}"].tolist()


def _slab_index(spec, mesh, r):
    c = TSH.mesh_coords(mesh)[r]
    return [TSH.linear_index(mesh, TSH.axes_of(e), c) for e in spec]


@pytest.mark.parametrize("mname", ["2x2", "1x4", "4x1"])
def test_reshard_tree_matches_repro(ref, mname):
    """Every leaf's slab at every position bit for bit ``repro``'s
    ``jax.device_put`` shard there, and each slab its own copy."""
    x = {k: torch.from_numpy(v) for k, v in reshard_inputs().items()}
    mesh = port_mesh(mname)
    # from a state already placed on another mesh, as an elastic restart
    first = TEL.reshard_tree(x, RESHARD_SPECS, port_mesh("4x1"))
    placed = TEL.reshard_tree(first, RESHARD_SPECS, mesh)
    for k, sh in placed.items():
        assert isinstance(sh, TSH.Sharded)
        assert sh.sharding.spec == TSH.ShardingPolicy(mesh).spec(
            *RESHARD_SPECS[k])
        for r, slab in enumerate(sh.slabs):
            want = ref[1][f"reshard/{mname}/{k}/{r}"]
            assert slab.dtype == x[k].dtype
            np.testing.assert_array_equal(slab.numpy(), want, err_msg=k)
            assert slab.data_ptr() != x[k].data_ptr() or slab.numel() == 0
        assert torch.equal(sh.gather(), x[k])


@pytest.mark.parametrize("mname", ["2x2", "1x4", "4x1"])
def test_restore_with_shardings_matches_repro(ref, mname):
    """A checkpoint restored with ``shardings=`` puts each leaf's slabs
    where ``repro``'s restore puts them, bit for bit."""
    d, want = ref
    x = reshard_inputs()
    pol = TSH.ShardingPolicy(port_mesh(mname))
    leaves, _ = TCK.restore(str(d / "ckpt"), shardings=[
        pol.named(*RESHARD_SPECS[k]) for k in x])
    for k, sh in zip(x, leaves):
        for r, slab in enumerate(sh.slabs):
            np.testing.assert_array_equal(
                slab.numpy(), want[f"reshard/{mname}/ckpt_{k}/{r}"])
        np.testing.assert_array_equal(sh.gather().numpy(), x[k])
    plain, _ = TCK.restore(str(d / "ckpt"))
    assert all(isinstance(t, torch.Tensor) for t in plain)


def test_device_put_and_split_share_one_rule():
    """``device_put``'s slabs, ``shard_map``'s blocks and the retrieval
    store's ``split_slabs`` are one splitting rule."""
    from repro_torch.retrieval.store import split_slabs, store_shardings
    mesh = port_mesh("2x2")
    x = torch.arange(48.0).reshape(8, 6)
    spec = SM.P(("data", "model"))
    put = TSH.device_put(x, TSH.NamedSharding(mesh, spec))
    seen = []
    SM.shard_map(lambda b: seen.append((SM.axis_index(("data", "model")),
                                        b.clone())) or b.sum(),
                 mesh, spec, SM.P())(x)
    for r, b in sorted(seen, key=lambda t: t[0]):
        assert torch.equal(b, put.slabs[r])
    slabs = split_slabs({"initial": x}, mesh)
    assert store_shardings(mesh, {"initial": x})["initial"] == tuple(spec)
    for r in range(4):
        assert torch.equal(slabs[r]["initial"], put.slabs[r])


# ---------------------------------------------------------------------------
# the spec functions (pure: no mesh)
# ---------------------------------------------------------------------------

def _tree_eq(a, b, what):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), what
        for k in b:
            _tree_eq(a[k], b[k], f"{what}/{k}")
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_eq(x, y, f"{what}/{i}")
    else:
        assert tuple(a) == tuple(b), (what, a, b)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_specs_exact(arch):
    """``param_specs`` and ``_layer_specs`` equal ``repro``'s at every tp,
    dp in {1, 2, 4, 16}, and name every leaf of the port's
    ``jax_leaf_names``."""
    tcfg, jcfg = get_config(arch), jax_config(arch)
    with torch.device("meta"):
        model = TT.DecoderLM(tcfg, None, "meta")
    for tp in (1, 2, 4, 16):
        for dp in (1, 2, 4, 16):
            got = TT.param_specs(tcfg, tp, dp)
            _tree_eq(got, JT.param_specs(jcfg, tp, dp), f"{arch} {tp} {dp}")
            _tree_eq(TT._layer_specs(tcfg, tp, dp),
                     JT._layer_specs(jcfg, tp, dp), f"{arch} layer")
            for name in model.jax_leaf_names():
                spec = TT._tree_get(got, name)
                leaf = model.jax_leaf_params(name)
                ndim = leaf[0].ndim + (1 if model.jax_stacked(name) else 0)
                assert len(spec) == ndim, (name, spec)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_shardings_match_repro(ref, arch):
    """``param_shardings`` on a (2, 2) mesh: each leaf's resolved spec is
    ``repro``'s ``NamedSharding`` spec."""
    tcfg = get_config(arch)
    sh = TT.param_shardings(tcfg, TSH.ShardingPolicy(port_mesh("2x2")))
    want = {k[len(f"pshard/{arch}/"):]: str(v) for k, v in ref[1].items()
            if k.startswith(f"pshard/{arch}/")}
    got = {}

    def walk(t, path):
        if isinstance(t, TSH.NamedSharding):
            got["/".join(path)] = repr(tuple(t.spec))
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + [k])
        else:
            for i, v in enumerate(t):
                walk(v, path + [str(i)])
    walk(sh, [])
    assert got == want
    assert TT.param_shardings(tcfg, TSH.ShardingPolicy(None)) is None


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("batch", [1, 8])
def test_kv_cache_specs_exact(arch, batch):
    tcfg, jcfg = get_config(arch), jax_config(arch)
    plan = TT.segment_plan(tcfg)
    assert plan == JT.segment_plan(jcfg)
    _tree_eq(TKV.cache_logical_axes(tcfg, plan, batch),
             JKV.cache_logical_axes(jcfg, plan, batch), arch)
    got = TKV.cache_specs(tcfg, plan, batch, 4096, torch.bfloat16)
    want = JKV.cache_specs(jcfg, plan, batch, 4096)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            for kv in ("k", "v"):
                assert g[kv].device.type == "meta"
                assert tuple(g[kv].shape) == tuple(w[kv].shape)
                assert str(g[kv].dtype).split(".")[1] == str(w[kv].dtype)


def test_opt_state_and_other_specs_exact():
    """``opt_state_specs`` (adamw and row-wise leaves), ``embedding_specs``
    and the GNN's replicated ``param_specs`` equal ``repro``'s."""
    specs = {"emb.big": ("tp", None), "mlp.0.w": (None, "tp"),
             "ln": (None,), "items": (("dp", "tp"), None)}
    labels = TOPT.default_labels(specs)
    jt = JOPT.opt_state_specs({k.replace(".", "/"): v
                               for k, v in specs.items()},
                              {k.replace(".", "/"): v
                               for k, v in labels.items()})
    got = TOPT.opt_state_specs(specs, labels)
    assert got["step"] == jt["step"] == ()
    for k in specs:
        assert got["per_leaf"][k] == jt["per_leaf"][k.replace(".", "/")]
    layout_args = ((120_000, 50, 200_000), 8)
    assert TEMB.embedding_specs(TEMB.EmbeddingLayout(*layout_args)) == \
        JEMB.embedding_specs(JEMB.EmbeddingLayout(*layout_args))
    assert TEMB.embedding_specs(TEMB.EmbeddingLayout((5, 7), 8)) == \
        JEMB.embedding_specs(JEMB.EmbeddingLayout((5, 7), 8))
    cfg = get_config("equiformer-v2")
    assert TE.param_specs(cfg) == JE.param_specs(jax_config(
        "equiformer-v2")) == "replicated"


def test_partition_spec_and_named_sharding():
    p = TSH.P("data", ("data", "model"), None, ("model",), ())
    assert tuple(p) == ("data", ("data", "model"), None, "model", None)
    assert p == ("data", ("data", "model"), None, "model", None)
    assert repr(TSH.P()) == "P()" and repr(TSH.P("a")) == "P('a')"
    mesh = port_mesh("2x2")
    pol = TSH.ShardingPolicy(mesh)
    assert pol.named("dp", None) == TSH.NamedSharding(mesh,
                                                      TSH.P("data", None))
    assert TSH.ShardingPolicy(None).named("dp") is None
    tree = pol.tree_shardings({"a": ("tp", None), "b": [("dp",), ()]})
    assert tree["a"].spec == ("model", None) and tree["b"][1].spec == ()
    with pytest.raises(ValueError, match="does not split"):
        TSH.device_put(torch.ones(3), pol.named("dp"))
    with pytest.raises(ValueError, match="names axis"):
        TSH.split(torch.ones(4), mesh, TSH.P("pod"))
