"""The mesh, the sharding policy's mapping half, the gathered top-k merges
and the sharded cascade over one raw store: the port against ``repro``.

``repro``'s 4-device references run in ONE subprocess (fake CPU devices
must exist before JAX starts: ``XLA_FLAGS=
--xla_force_host_platform_device_count=4``), on inputs this module makes
with numpy and hands over in an ``.npz``; the port runs the same inputs
on ``make_mesh((4,), ("data",), devices=["cpu"] * 4)``. Mirrors
``tests/test_segments.py::test_ragged_multi_shard_parity_subprocess`` and
``tests/test_dispatch.py::test_ragged_sharded_fused_subprocess``
(a ragged 21-document corpus over 4 shards), plus int8 stores and a
cascade whose k exceeds the live documents.

Tolerances: ids, -1 sentinels, specs and sizes exact; scores rtol 1e-5,
atol 1e-6. A 1-position mesh equals ``mesh=None`` bit for bit.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro.distributed import sharding as JSH
from repro.launch import mesh as JMESH
from repro_torch.core import multistage as TM
from repro_torch.distributed import sharding as TSH
from repro_torch.launch.mesh import (Mesh, home_device, make_mesh,
                                     make_production_mesh, n_devices)
from repro_torch.retrieval import engine as TE
from repro_torch.retrieval import topk as TT
from repro_torch.retrieval import store as TS
from repro_torch.retrieval.store import quantize_store, VectorStore

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = dict(rtol=1e-5, atol=1e-6)
N_DOCS, D, DP, DIM = 21, 4, 2, 8
S, N_LOCAL, K_TOP = 4, 6, 5


def mesh4():
    return make_mesh((S,), ("data",), devices=["cpu"] * S)


def _cascades(M):
    """The cascades both packages run, built from either package's
    ``multistage`` module ``M``: name -> (stages, int8 store?)."""
    one, two = M.one_stage(8), M.two_stage(8, 4)
    fused = M.with_rerank_policy(
        M.with_scan_policy(two, scan_topk=True, chunk=3), rerank_kernel=True)
    return {
        "one": (one, False),
        "two": (two, False),
        "three": (M.three_stage(12, 8, 4), False),
        "fused": (fused, False),
        "topk_one": (M.with_scan_policy(one, scan_topk=True, chunk=4), False),
        "wide": (M.two_stage(24, 22), False),       # k above the live docs
        "int8_one": (one, True),
        "int8_two": (two, True),
        "int8_fused": (fused, True),
    }


def _inputs() -> dict:
    r = np.random.default_rng(5)

    def unit(*s):
        x = r.normal(size=s).astype(np.float32)
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)

    ini = unit(N_DOCS, D, DIM)
    mask = r.random((N_DOCS, D)) > 0.25
    mask[:, 0] = True
    # scores on a coarse grid so that equal values sit in different shards
    scores = r.integers(0, 5, size=(3, S * N_LOCAL)).astype(np.float32)
    valid = r.random(S * N_LOCAL) > 0.2
    kp = 3
    return {
        "initial": ini, "initial_mask": mask,
        "mean_pooling": ini[:, :DP].copy(),
        "mean_pooling_mask": np.ones((N_DOCS, DP), bool),
        "global_pooling": unit(N_DOCS, DIM),
        "q": unit(3, 5, DIM), "qm": r.random((3, 5)) > 0.2,
        "scores": scores, "valid": valid,
        "m_vals": np.sort(r.integers(0, 4, size=(3, S, kp)), axis=-1)[
            ..., ::-1].reshape(3, S * kp).astype(np.float32),
        "m_ids": r.permutation(S * 40)[:3 * S * kp].reshape(
            3, S * kp).astype(np.int32),
    }


VEC_KEYS = ("initial", "initial_mask", "mean_pooling", "mean_pooling_mask",
            "global_pooling")

_REPRO_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
sys.path.insert(0, os.path.dirname(sys.argv[3]))
from repro.core import multistage as MST
from repro.launch.mesh import make_mesh
from repro.retrieval import topk as JT
from repro.retrieval.engine import make_search_fn
from repro.retrieval.store import VectorStore, quantize_store
from test_torch_mesh import _cascades, VEC_KEYS, N_DOCS, N_LOCAL, K_TOP

x = dict(np.load(sys.argv[1]))
out = {}
mesh = make_mesh((4,), ("data",))
assert len(jax.devices()) == 4

def ag(s, v):
    i = jax.lax.axis_index("data")
    return JT.allgather_topk(s, K_TOP, "data", i, N_LOCAL, valid_local=v,
                             seg_offset=10)
f = shard_map(ag, mesh=mesh, in_specs=(P(None, "data"), P("data")),
              out_specs=(P(), P()), check_rep=False)
v, i = jax.jit(f)(jnp.asarray(x["scores"]), jnp.asarray(x["valid"]))
out["ag_vals"], out["ag_ids"] = np.asarray(v), np.asarray(i)
g = shard_map(lambda a, b: JT.gathered_merge_topk(a, b, K_TOP, "data"),
              mesh=mesh, in_specs=(P(None, "data"), P(None, "data")),
              out_specs=(P(), P()), check_rep=False)
v, i = jax.jit(g)(jnp.asarray(x["m_vals"]), jnp.asarray(x["m_ids"]))
out["gm_vals"], out["gm_ids"] = np.asarray(v), np.asarray(i)

store = {k: jnp.asarray(x[k]) for k in VEC_KEYS}
st8 = quantize_store(VectorStore(store, N_DOCS, "float32"),
                     names=("mean_pooling", "initial"),
                     stages=MST.one_stage(8)).vectors
for k, a in st8.items():
    out["int8/" + k] = np.asarray(a)
q, qm = jnp.asarray(x["q"]), jnp.asarray(x["qm"])
for name, (stages, int8) in _cascades(MST).items():
    s, i = make_search_fn(mesh, stages, N_DOCS)(st8 if int8 else store, q, qm)
    out[name + "/scores"], out[name + "/ids"] = np.asarray(s), np.asarray(i)
np.savez(sys.argv[2], **out)
print("MESH_REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_ref")
    x = _inputs()
    np.savez(d / "in.npz", **x)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    got = subprocess.run(
        [sys.executable, "-c", _REPRO_SCRIPT, str(d / "in.npz"),
         str(d / "out.npz"), os.path.abspath(__file__)],
        env=env, capture_output=True, text=True, timeout=600)
    assert got.returncode == 0 and "MESH_REF_OK" in got.stdout, \
        got.stderr[-3000:]
    return x, dict(np.load(d / "out.npz"))


# ---------------------------------------------------------------------------
# the mesh and the policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", [((1,), ("data",)),
                                        ((4,), ("data",)),
                                        ((2, 2), ("data", "model"))])
def test_make_mesh_shape_and_axes(shape, axes):
    m = make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))
    assert isinstance(m, Mesh)
    assert m.devices.shape == shape and m.axis_names == axes
    assert dict(m.shape) == dict(zip(axes, shape))
    assert n_devices(m) == JMESH.n_devices(m) == int(np.prod(shape))
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert m == make_mesh(shape, axes, devices=["cpu"] * m.size)
    assert hash(m) == hash(make_mesh(shape, axes, devices=["cpu"] * m.size))
    assert home_device(m) == torch.device("cpu")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh(multi_pod):
    n = 512 if multi_pod else 256
    m = make_production_mesh(["cpu"] * n, multi_pod=multi_pod)
    want = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    assert dict(m.shape) == want
    assert m.axis_names == tuple(want)
    assert n_devices(m) == JMESH.n_devices(m) == n


def test_make_mesh_defaults_to_cuda_devices():
    """Without ``devices`` a mesh takes the first CUDA devices and never
    the CPU: fewer cards than positions raise."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have >= S:
        assert mesh_types(make_mesh((S,), ("data",))) == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make_mesh((S,), ("data",))
    with pytest.raises(ValueError):
        make_mesh((S,), ("data",), devices=["cpu"] * (S - 1))
    # a meta mesh is all meta (shapes only, the dry run's); a mesh never
    # mixes meta with a real device
    with pytest.raises(ValueError):
        make_mesh((2,), ("data",), devices=["meta", "cpu"])
    assert mesh_types(make_mesh((2,), ("data",),
                                devices=["meta"] * 2)) == {"meta"}
    with pytest.raises(ValueError):
        home_device(mesh4(), "meta")


def mesh_types(m) -> set:
    return {d.type for d in m.devices.flat}


_MESHES = {
    "none": None,
    "1": ((1,), ("data",)),
    "4": ((4,), ("data",)),
    "2x2": ((2, 2), ("data", "model")),
    "pod": ((2, 16, 16), ("pod", "data", "model")),
}
_LOGICAL = ["dp", "tp", "sp", "flat", None, "model", ("dp", "tp"),
            ("dp", None), ("flat",), (None, None), "other"]


def _outcome(f, *a):
    """f(*a), or the type of what it raised."""
    try:
        return f(*a)
    except Exception as e:             # the same failure on both sides
        return type(e)


@pytest.mark.parametrize("which", list(_MESHES))
def test_sharding_policy_matches_repro(which):
    """``spec`` gives the tuple ``repro``'s ``PartitionSpec`` holds and
    ``axis_size`` its size, for every logical axis, default rules and
    overrides (``repro``'s policy reads a mesh through ``axis_names`` and
    ``shape`` only, so it runs on the port's mesh)."""
    spec = _MESHES[which]
    m = None if spec is None else make_mesh(
        *spec, devices=["cpu"] * int(np.prod(spec[0])))
    for over in (None, {"tp": ("data", "model"), "sp": ()}):
        tp, jp = TSH.ShardingPolicy(m, overrides=over), \
            JSH.ShardingPolicy(m, overrides=over)
        assert tp.rules == jp.rules
        assert TSH.rules_for_mesh(m) == JSH.rules_for_mesh(m)
        for ax in _LOGICAL:
            assert tp.spec(ax) == tuple(jp.spec(ax)), ax
            assert _outcome(tp.axis_size, ax) == _outcome(jp.axis_size, ax)
        assert tp.spec("dp", "tp", None) == tuple(jp.spec("dp", "tp", None))
    for n, k in ((8, 4), (6, 4), (0, 3), (3, 0)):
        assert TSH.divisible(n, k) == JSH.divisible(n, k)


def test_store_shardings_match_repro():
    """The per-key layout: routing companions replicated, the rest split
    over every mesh axis, as ``repro``'s ``store_shardings`` specs; and
    ``split_slabs`` lays a store out by exactly these specs."""
    from repro.retrieval import engine as JE
    jm = JMESH.make_mesh((1,), ("data",))
    keys = {k: np.zeros((4, 2)) for k in ("initial", "doc_valid",
                                          "ivf_centroids", "ivf_members")}
    want = {k: tuple(v.spec) for k, v in JE.store_shardings(jm, keys).items()}
    tm = make_mesh((1,), ("data",), devices=["cpu"])
    assert TS.store_shardings(tm, keys) == want
    assert TS.store_shardings(None, keys) is None
    vecs = {k: torch.arange(8 * 2).reshape(8, 2) for k in keys}
    specs = TS.store_shardings(mesh4(), vecs)
    for r, slab in enumerate(TS.split_slabs(vecs, mesh4())):
        for k, v in slab.items():
            want_v = vecs[k][2 * r:2 * r + 2] if specs[k] else vecs[k]
            assert torch.equal(v, want_v), (r, k)


# ---------------------------------------------------------------------------
# gathered top-k merges
# ---------------------------------------------------------------------------

def test_allgather_topk_matches_repro(ref):
    """Per-shard select then the gathered merge, dead slots NEGed, ties
    across shards broken to the lower shard (mesh order), ids shifted by
    ``seg_offset``: exact."""
    x, out = ref
    s = torch.from_numpy(x["scores"])
    v = torch.from_numpy(x["valid"])
    parts = list(s.split(N_LOCAL, dim=1))
    valid = list(v.split(N_LOCAL))
    gv, gi = TT.allgather_topk(parts, K_TOP, N_LOCAL, valid_local=valid,
                               seg_offset=10)
    np.testing.assert_array_equal(gi.numpy(), out["ag_ids"])
    np.testing.assert_array_equal(gv.numpy(), out["ag_vals"])
    # there were ties across shards to break
    assert any(len(set(r)) < len(r) for r in out["ag_vals"].tolist())


def test_gathered_merge_topk_matches_repro(ref):
    x, out = ref
    kp = x["m_vals"].shape[1] // S
    vals = list(torch.from_numpy(x["m_vals"]).split(kp, dim=1))
    ids = list(torch.from_numpy(x["m_ids"]).split(kp, dim=1))
    gv, gi = TT.gathered_merge_topk(vals, ids, K_TOP)
    np.testing.assert_array_equal(gi.numpy(), out["gm_ids"])
    np.testing.assert_array_equal(gv.numpy(), out["gm_vals"])


# ---------------------------------------------------------------------------
# the sharded cascade over one raw (ragged) store
# ---------------------------------------------------------------------------

def _port_stores(x, out) -> tuple:
    store = {k: torch.from_numpy(x[k]) for k in VEC_KEYS}
    st8 = {k[len("int8/"):]: torch.from_numpy(v) for k, v in out.items()
           if k.startswith("int8/")}
    return store, st8


@pytest.mark.parametrize("name", list(_cascades(TM)))
def test_search_fn_mesh4_matches_repro(ref, name):
    """``make_search_fn`` on 4 shards over 21 documents (ragged: the last
    shard's slab is padded) gives ``repro``'s 4-device ids exactly (-1
    filler included) and its scores within rtol 1e-5, atol 1e-6, for the
    1-, 2- and 3-stage cascades, the streamed scan top-k, the fused
    candidate path and int8 codes (scan and rerank)."""
    x, out = ref
    store, st8 = _port_stores(x, out)
    stages, int8 = _cascades(TM)[name]
    q, qm = torch.from_numpy(x["q"]), torch.from_numpy(x["qm"])
    s, i = TE.make_search_fn(stages, N_DOCS, mesh4())(st8 if int8 else store,
                                                      q, qm)
    np.testing.assert_array_equal(i.numpy(), out[name + "/ids"])
    np.testing.assert_allclose(s.numpy(), out[name + "/scores"], **TOL)
    if name == "wide":                    # the filler is the sentinel
        assert (i.numpy() == -1).any()


def test_int8_store_is_the_ports_own(ref):
    """The int8 references' codes and scales are the port's own
    ``quantize_store`` output bit for bit (so the cascades above hold the
    mesh path, not a quantiser)."""
    x, out = ref
    store, st8 = _port_stores(x, out)
    own = quantize_store(VectorStore(store, N_DOCS, "float32"),
                         names=("mean_pooling", "initial"),
                         stages=TM.one_stage(8)).vectors
    assert set(own) == set(st8)
    for k in own:
        assert torch.equal(own[k], st8[k]), k


@pytest.mark.parametrize("name", list(_cascades(TM)))
def test_search_fn_one_position_mesh_is_no_mesh(ref, name):
    """A 1-position mesh runs the sharded body and gives ``mesh=None``'s
    result bit for bit: every score, and every id whose score is live
    (the sharded body drops a non-owned filler's id to -1)."""
    x, out = ref
    store, st8 = _port_stores(x, out)
    stages, int8 = _cascades(TM)[name]
    vecs = st8 if int8 else store
    q, qm = torch.from_numpy(x["q"]), torch.from_numpy(x["qm"])
    m1 = make_mesh((1,), ("data",), devices=["cpu"])
    s1, i1 = TE.make_search_fn(stages, N_DOCS, m1)(vecs, q, qm)
    s0, i0 = TE.make_search_fn(stages, N_DOCS)(vecs, q, qm)
    live = s0 > TE.NEG / 2
    assert torch.equal(s1, s0)
    assert torch.equal(i1[live], i0[live])


def test_capacity_must_divide_by_shards():
    with pytest.raises(ValueError, match="not divisible"):
        TE.make_segmented_search_fn(TM.one_stage(4), (21,), mesh4())
    with pytest.raises(ValueError, match="split"):
        fn = TE.make_segmented_search_fn(TM.one_stage(4), (24,), mesh4())
        fn(({"initial": torch.zeros(21, 2, 4)},), torch.zeros(1, 1, 4),
           torch.ones(1, 1, dtype=torch.bool))


def test_mesh_shards_count():
    assert TE._mesh_shards(None) == 1
    assert TE._mesh_shards(mesh4()) == S
    ns = types.SimpleNamespace
    assert n_devices(ns(axis_names=("a", "b"), shape={"a": 2, "b": 3})) == 6
