"""The partitioned decoder-LM cells on a 4-position CPU mesh against
``repro``'s ``jax.jit(cell.fn, in_shardings=cell.in_shardings)``.

Configs (``launch.train.reduced_lm``, vocabulary 500 so 12 padded rows
are masked by global index): minicpm-2b (full attention, d_ff split over
tp), gemma3-4b with windows of 8 (ring caches), granite-moe (``moe_dense``
with the experts over tp; ``opt``: ``ragged_ep``), and a 3-head, 1-kv-head
gemma2-9b with d_ff 255 and windows of 8, which on tp = 2 and 4 forces
ZeRO leaves (gathered inside checkpointed layers) and ``seq`` attention
(query rows over sp, windows on global positions). Each runs on 2x2, 1x4
and 4x1: one train step (loss, ``grad_norm``, ``lr``, every leaf's first
moment, which is 0.1 x the clip-scaled gradient, and the gathered
parameters), a prefill (last logits and the caches), 6 decode steps from
``repro``'s prefill caches at batch 4 (the ring wraps and its slots
change owner) and 6 at batch 1 from random caches (split over ``flat``).
``repro``'s references run on its 2x2 mesh (GSPMD's numbers are the
unsharded step's on any mesh, up to the order of float sums), except the
granite ``opt`` step, whose capacity drops depend on the mesh. On
``meta``, every slab of every LM cell (5 archs x 4 shapes x 2 variants on
2x2 and 1x4) has ``repro``'s ``shard_shape``, exactly.

``repro`` runs in ONE subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (its references
traced in three threads), on inputs made with numpy from a seed.

Tolerances: loss rtol 1e-5; grad_norm rtol 1e-5; moments (gradients)
rtol 1e-3, atol 1e-7; parameters within 1e-2 lr (2 lr where the
gradient is under 1e-7, where Adam's first step is a sign); logits and
caches rtol 1e-5, atol 1e-5."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.distributed import placement as PL
from repro_torch.distributed.sharding import (ShardingPolicy, device_put,
                                              shard_shape)
from repro_torch.launch import cells as TC
from repro_torch.launch import train as TR
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import kv_cache as KV
from repro_torch.models import transformer as T

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}
CONFIGS = {
    "minicpm": ("minicpm-2b", {}),
    "gemma3": ("gemma3-4b", {"attn_pattern": (8,) * 5 + (0,)}),
    "granite": ("granite-moe-1b-a400m", {}),
    "zero_seq": ("gemma2-9b", {"n_heads": 3, "n_kv_heads": 1, "d_ff": 255,
                               "attn_pattern": (8, 0)}),
}
TRAIN = dict(seq_len=16, global_batch=32)
PREFILL = dict(seq_len=12, global_batch=4)
DECODE_POS = {4: list(range(12, 18)), 1: list(range(5, 11))}
OPT_CASES = [("minicpm", m) for m in MESHES] + [("granite", "2x2")]
# the mesh of each opt reference: minicpm's step is the unsharded one on
# any mesh, granite's ragged_ep drops by the mesh's capacities
OPT_REF = {"minicpm": "2x2", "granite": "2x2"}
META_ARCHS = ("minicpm-2b", "gemma2-9b", "gemma3-4b", "granite-moe-1b-a400m",
              "olmoe-1b-7b")
LOSS_RTOL, GN_RTOL = 1e-5, 1e-5
GTOL = dict(rtol=1e-3, atol=1e-7)
LTOL = dict(rtol=1e-5, atol=1e-5)
PARAM_LR_FRAC, NOISE = 1e-2, 1e-7


def lm_cfg(get, reduce, name):
    arch, over = CONFIGS[name]
    return dataclasses.replace(reduce(get(arch)), vocab_size=500, **over)


def port_mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices=["cpu"] * 4)


def inputs() -> dict:
    r = np.random.default_rng(30)
    x = {"train_tokens": r.integers(0, 500, (32, 16)),
         "train_labels": r.integers(0, 500, (32, 16)),
         "prefill_tokens": r.integers(0, 500, (4, 12))}
    for b in DECODE_POS:
        x[f"dec{b}_tokens"] = r.integers(0, 500, (len(DECODE_POS[b]), b, 1))
    return {k: v.astype(np.int32) for k, v in x.items()}


_SCRIPT = r"""
import os, sys, json, dataclasses, threading
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, os.path.dirname(sys.argv[3]))
from repro.configs import get_config, ShapeSpec
from repro.launch import cells as JC
from repro.launch.mesh import make_mesh
from repro.launch.train import reduced_lm
from repro.models import transformer as JT
from repro.training import optimizer as JOPT
import test_torch_partitioned_lm as M

assert len(jax.devices()) == 4
x = dict(np.load(sys.argv[1]))
out, lock = {}, threading.Lock()
meshes = {k: make_mesh(*v) for k, v in M.MESHES.items()}
CFGS = {c: M.lm_cfg(get_config, reduced_lm, c) for c in M.CONFIGS}

def path(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)

def save(prefix, tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    with lock:
        for kp, leaf in flat:
            out["/".join(filter(None, (prefix, path(kp))))] = \
                np.asarray(leaf)

def run_config(c):
    cfg = CFGS[c]
    p = jax.jit(JT.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(1))
    save(f"{c}/p", p)
    b = {"tokens": jnp.asarray(x["train_tokens"]),
         "labels": jnp.asarray(x["train_labels"])}
    runs = [("base", "2x2")] + ([("opt", M.OPT_REF[c])] if c in M.OPT_REF
                                else [])
    for v, m in runs:
        with lock:
            JC.get_config = lambda arch: cfg
            jc = JC.build_lm_cell(M.CONFIGS[c][0], ShapeSpec(
                "train_4k", "train", M.TRAIN), meshes[m], v)
        st = jax.jit(JOPT.init_opt_state)(p)
        new, st, mt = jax.jit(jc.fn, in_shardings=jc.in_shardings)(p, st, b)
        save(f"{c}/train/{v}/{m}/new", new)
        save(f"{c}/train/{v}/{m}/m", jax.tree.map(lambda s: s["m"],
             st["per_leaf"], is_leaf=lambda s: isinstance(s, dict)
             and "m" in s))
        save(f"{c}/train/{v}/{m}/metrics", mt)
    with lock:
        JC.get_config = lambda arch: cfg
        jc = JC.build_lm_cell(M.CONFIGS[c][0], ShapeSpec(
            "prefill_32k", "prefill", M.PREFILL), meshes["2x2"])
        dc = {B: JC.build_lm_cell(M.CONFIGS[c][0], ShapeSpec(
            "decode_32k", "decode", dict(seq_len=M.PREFILL["seq_len"],
                                         global_batch=B)), meshes["2x2"])
              for B in M.DECODE_POS}
    logits, caches = jax.jit(jc.fn, in_shardings=jc.in_shardings)(
        p, {"tokens": jnp.asarray(x["prefill_tokens"])})
    save(f"{c}/prefill/logits", logits)
    save(f"{c}/prefill/caches", caches)
    r = np.random.default_rng(31)
    for B, steps in M.DECODE_POS.items():
        f = jax.jit(dc[B].fn, in_shardings=dc[B].in_shardings)
        if B == 1:
            caches = jax.tree.map(lambda s: jnp.asarray(
                r.normal(size=s.shape).astype(np.float32)), dc[B].args[1])
            save(f"{c}/dec1/caches0", caches)
        for i, pos in enumerate(steps):
            caches = jax.device_put(caches, dc[B].in_shardings[1])
            lg, caches = f(p, caches, jnp.asarray(x[f"dec{B}_tokens"][i]),
                           jnp.int32(pos))
            save(f"{c}/dec{B}/logits/{i}", lg)
        save(f"{c}/dec{B}/caches", caches)

def shard_shapes():
    shapes = {}
    for arch in M.META_ARCHS:
        for sname in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            for v in ("base", "opt"):
                for m in ("2x2", "1x4"):
                    jc = JC.build_cell(arch, sname, meshes[m], v)
                    got = {}
                    for i, (a, s) in enumerate(zip(jc.args, jc.in_shardings)):
                        fa = jax.tree_util.tree_flatten_with_path(a)[0]
                        fs = jax.tree.leaves(s)
                        for (kp, leaf), sh in zip(fa, fs):
                            got["/".join(filter(None, (str(i), path(kp))))] = list(
                                sh.shard_shape(leaf.shape))
                    shapes[f"{arch}/{sname}/{v}/{m}"] = got
    return shapes

shapes = {}
def part_a():
    run_config("minicpm")
    run_config("gemma3")

def part_b():
    run_config("granite")

def part_c():
    run_config("zero_seq")
    with lock:
        JC.get_config = get_config
        shapes.update(shard_shapes())

errors = []
def run(f):
    try:
        f()
    except BaseException as e:
        errors.append(e)
        raise
threads = [threading.Thread(target=run, args=(f,))
           for f in (part_a, part_b, part_c)]
for t in threads:
    t.start()
for t in threads:
    t.join()
assert not errors, errors
out["shapes"] = np.asarray(json.dumps(shapes))
np.savez(sys.argv[2], **out)
print("PARTITIONED_LM_REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("partitioned_lm_ref")
    x = inputs()
    np.savez(d / "in.npz", **x)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(d / "in.npz"),
         str(d / "out.npz"), os.path.abspath(__file__)],
        env=env, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0 and "PARTITIONED_LM_REF_OK" in p.stdout, \
        p.stderr[-3000:]
    return x, dict(np.load(d / "out.npz"))


def tree_of(want: dict, prefix: str):
    """``repro``'s tree under ``prefix`` rebuilt from its '/'-joined leaf
    paths (lists where the keys are indices)."""
    flat = {k[len(prefix) + 1:]: v for k, v in want.items()
            if k.startswith(prefix + "/")}
    root = {}
    for k, v in flat.items():
        node, parts = root, k.split("/")
        for a in parts[:-1]:
            node = node.setdefault(a, {})
        node[parts[-1]] = v

    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}
    return lists(root)


def _patch(monkeypatch, name):
    cfg = lm_cfg(get_config, TR.reduced_lm, name)
    monkeypatch.setattr(TC, "get_config", lambda arch: cfg)
    return cfg


def _placed_ok(placed: dict, mesh):
    """Every slab has its sharding's shard shape: no position holds a
    whole leaf that its spec splits."""
    for n, s in placed.items():
        want = shard_shape(s.sharding, s.shape)
        for slab in s.slabs:
            assert tuple(slab.shape) == want, n


def _load_params(cell, want, name, pol):
    """The cell's placed parameters replaced by ``repro``'s, placed from
    numpy straight into slabs (``params_from_jax(shard=)``)."""
    cfg = TC.get_config(None)
    placed = T.params_from_jax(cfg, tree_of(want, f"{name}/p"), shard=pol)
    for n, s in placed.items():
        assert s.sharding == cell.args[0][n].sharding, n
        for dst, src in zip(cell.args[0][n].slabs, s.slabs):
            with torch.no_grad():
                dst.copy_(src)
    _placed_ok(cell.args[0], pol.mesh)


def _check_train(cell, want, prefix, what):
    params, opt = cell.args[0], cell.args[1]
    jm = {k: float(want[f"{prefix}/metrics/{k}"]) for k in
          ("loss", "grad_norm", "lr")}
    m = cell.fn(*cell.args)
    np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=LOSS_RTOL,
                               err_msg=f"{what} loss")
    np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"],
                               rtol=GN_RTOL, err_msg=f"{what} grad_norm")
    np.testing.assert_allclose(float(m["lr"]), jm["lr"], rtol=1e-6)
    assert all(int(s) == 1 for s in opt["step"].slabs)
    lr = jm["lr"]
    for n, s in params.items():
        jmom = want[f"{prefix}/m/{n}"]
        mom = opt["per_leaf"][n]["m"]
        assert mom.sharding == s.sharding, n
        np.testing.assert_allclose(mom.gather().numpy(), jmom, **GTOL,
                                   err_msg=f"{what} moment {n}")
        got = s.gather().detach().numpy()
        jnew = want[f"{prefix}/new/{n}"]
        noisy = np.abs(jmom / 0.1) < NOISE
        bound = np.where(noisy, 2 * lr, PARAM_LR_FRAC * lr) \
            + 2 * np.spacing(np.abs(jnew))
        assert np.all(np.abs(got - jnew) <= bound), f"{what} param {n}"
    _placed_ok(params, None)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("mname", list(MESHES))
def test_train_step_matches_repro(ref, monkeypatch, name, mname):
    """One base train step (Megatron-SP where batch and sequence allow)
    against ``repro``'s partitioned step."""
    x, want = ref
    _patch(monkeypatch, name)
    mesh = port_mesh(mname)
    cell = TC.build_lm_cell(CONFIGS[name][0], ShapeSpec(
        "train_4k", "train", TRAIN), "cpu", generator=torch.Generator(),
        mesh=mesh)
    _load_params(cell, want, name, ShardingPolicy(mesh))
    b = {"tokens": torch.from_numpy(x["train_tokens"]),
         "labels": torch.from_numpy(x["train_labels"])}
    cell.args = cell.args[:2] + (device_put(b, {
        k: v.sharding for k, v in cell.args[2].items()}, copy=True),)
    _check_train(cell, want, f"{name}/train/base/2x2", f"{name} {mname}")


@pytest.mark.parametrize("name,mname", OPT_CASES)
def test_opt_train_step_matches_repro(ref, monkeypatch, name, mname):
    """The ``opt`` step: no Megatron-SP, 8 checkpointed microbatches taken
    as ``repro``'s rows (an all_to_all over dp), granite's ``ragged_ep``
    inside the body."""
    x, want = ref
    _patch(monkeypatch, name)
    mesh = port_mesh(mname)
    cell = TC.build_lm_cell(CONFIGS[name][0], ShapeSpec(
        "train_4k", "train", TRAIN), "cpu", "opt", torch.Generator(),
        mesh=mesh)
    _load_params(cell, want, name, ShardingPolicy(mesh))
    b = {"tokens": torch.from_numpy(x["train_tokens"]),
         "labels": torch.from_numpy(x["train_labels"])}
    cell.args = cell.args[:2] + (device_put(b, {
        k: v.sharding for k, v in cell.args[2].items()}, copy=True),)
    _check_train(cell, want, f"{name}/train/opt/{OPT_REF[name]}",
                 f"{name} opt")


def _close_caches(got, want, prefix, what):
    for si, seg in enumerate(got):
        for ki, slot in enumerate(seg):
            for kv in ("k", "v"):
                np.testing.assert_allclose(
                    slot[kv].gather().numpy(),
                    want[f"{prefix}/{si}/{ki}/{kv}"], **LTOL,
                    err_msg=f"{what} cache {si}/{ki}/{kv}")


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("mname", list(MESHES))
def test_prefill_matches_repro(ref, monkeypatch, name, mname):
    """Prefill: the last position's logits (vocab over tp) and the caches,
    placed by ``cache_logical_axes``."""
    x, want = ref
    cfg = _patch(monkeypatch, name)
    mesh = port_mesh(mname)
    pol = ShardingPolicy(mesh)
    cell = TC.build_lm_cell(CONFIGS[name][0], ShapeSpec(
        "prefill_32k", "prefill", PREFILL), "cpu", generator=torch.Generator(),
        mesh=mesh)
    _load_params(cell, want, name, pol)
    b = device_put({"tokens": torch.from_numpy(x["prefill_tokens"])},
                   {"tokens": cell.args[1]["tokens"].sharding}, copy=True)
    logits, caches = cell.fn(cell.args[0], b)
    np.testing.assert_allclose(logits.numpy(), want[f"{name}/prefill/logits"],
                               **LTOL)
    csh = KV.cache_shardings(cfg, T.segment_plan(cfg), 4, pol)
    for seg, sseg in zip(caches, csh):
        for slot, sslot in zip(seg, sseg):
            for kv in ("k", "v"):
                assert slot[kv].sharding == sslot[kv]
                assert slot[kv].slabs[0].shape == shard_shape(
                    sslot[kv], slot[kv].shape)
    _close_caches(caches, want, f"{name}/prefill/caches", f"{name} prefill")


@pytest.mark.parametrize("B", list(DECODE_POS))
@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("mname", list(MESHES))
def test_decode_matches_repro(ref, monkeypatch, name, mname, B):
    """6 decode steps: at batch 4 from ``repro``'s prefill caches (the ring
    of 8 wraps at the 5th step, its slots change owner), at batch 1 from
    random caches split over ``flat`` (every position a slice); the
    logits each step and the caches after the last."""
    x, want = ref
    _patch(monkeypatch, name)
    mesh = port_mesh(mname)
    cell = TC.build_lm_cell(CONFIGS[name][0], ShapeSpec(
        "decode_32k", "decode", dict(seq_len=PREFILL["seq_len"],
                                     global_batch=B)), "cpu",
        generator=torch.Generator(), mesh=mesh)
    _load_params(cell, want, name, ShardingPolicy(mesh))
    params, caches, tok, pos = cell.args
    seq_axes = ("model",) if B > 1 else ("data", "model")
    assert tuple(np.atleast_1d(caches[0][0]["k"].sharding.spec[2])) == \
        seq_axes
    start = tree_of(want, f"{name}/prefill/caches" if B > 1
                    else f"{name}/dec1/caches0")
    caches = device_put(start, [[{k: v.sharding for k, v in slot.items()}
                                 for slot in seg] for seg in caches],
                        copy=True)
    for i, p in enumerate(DECODE_POS[B]):
        t = device_put(torch.from_numpy(x[f"dec{B}_tokens"][i]),
                       tok.sharding, copy=True)
        ps = device_put(torch.tensor(p, dtype=torch.int32), pos.sharding,
                        copy=True)
        logits = cell.fn(params, caches, t, ps)
        np.testing.assert_allclose(logits.numpy(),
                                   want[f"{name}/dec{B}/logits/{i}"], **LTOL,
                                   err_msg=f"{name} {mname} step {i}")
    _close_caches(caches, want, f"{name}/dec{B}/caches", f"{name} decode")


def _port_shapes(cell) -> dict:
    """{argument path: slab shape} in ``repro``'s path format."""
    out = {}

    def walk(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{prefix}/{i}", v)
        else:
            out[prefix] = [list(s.shape) for s in x.slabs]
    for i, a in enumerate(cell.args):
        walk(str(i), a)
    return out


@pytest.mark.parametrize("arch", META_ARCHS)
def test_meta_slabs_are_repros_shard_shapes(ref, arch):
    """Full configs on ``meta``: every slab of every argument of the four
    LM cells, both variants, on 2x2 and 1x4, has ``repro``'s
    ``in_shardings[i].shard_shape``, exactly (parameters by leaf name,
    moments, step, batch, caches, token, position)."""
    _, want = ref
    shapes = json.loads(str(want["shapes"]))
    for sname in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        for v in ("base", "opt"):
            for m in ("2x2", "1x4"):
                cell = TC.build_cell(arch, sname, "meta", v,
                                     mesh=port_mesh(m))
                got = _port_shapes(cell)
                jw = shapes[f"{arch}/{sname}/{v}/{m}"]
                assert set(got) == set(jw), (arch, sname, v, m)
                for k, slabs in got.items():
                    assert all(s == jw[k] for s in slabs), (
                        arch, sname, v, m, k, slabs[0], jw[k])
                assert all(s.device.type == "meta"
                           for t in TC.arg_tensors(cell.args) for s in [t])


def test_placed_leaves_from_numpy_never_whole(monkeypatch):
    """``params_from_jax(shard=)`` splits each numpy leaf on the host: the
    split leaves' slabs are smaller than the leaf, every slab its own
    storage."""
    cfg = _patch(monkeypatch, "zero_seq")
    pol = ShardingPolicy(port_mesh("2x2"))
    with torch.device("meta"):
        tmpl = T.template(cfg)
    r = np.random.default_rng(0)
    leaves = {n: r.normal(size=s).astype(np.float32)
              for n, s in PL.leaf_shapes(tmpl).items()}
    tree = tree_of({f"p/{k}": v for k, v in leaves.items()}, "p")
    placed = T.params_from_jax(cfg, tree, shard=pol)
    split = 0
    for n, s in placed.items():
        ptrs = {slab.data_ptr() for slab in s.slabs}
        assert len(ptrs) == 4, n
        if any(s.sharding.spec):
            split += 1
            assert s.slabs[0].numel() < leaves[n].size, n
        np.testing.assert_array_equal(s.gather().numpy(), leaves[n])
    assert split >= 8
