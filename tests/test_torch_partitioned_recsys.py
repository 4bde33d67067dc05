"""The recsys cells partitioned over a 4-position CPU mesh (2x2 and 1x4)
against ``repro``'s ``jax.jit(cell.fn, in_shardings=cell.in_shardings)``:
one train step, ``serve_p99``, ``serve_bulk`` with a chunk that splits it,
and ``retrieval_cand`` base and opt, for dcn-v2, autoint, dlrm-mlperf and
bert4rec. The big embedding table (bert4rec's item table) and its
row-wise Adagrad accumulator are row slabs over tp, the batch is split
over dp, the candidates and ``cand_proxy`` over ``flat``.

The CTR configs are ``test_torch_recsys.reduced``'s with field 2 (the
item field) at 120001 rows, so the big table exists and its rows are
padded to the tp shards; dlrm-mlperf's embedding is 16 wide (its
``cand_proxy`` is). ``retrieval_step``'s defaults are cut to a prefetch
of 32 and a top 10 of 301 candidates (padded to 304, 76 a position), so
the two-level merge selects; CTR candidates are scored 32 at a time.

``repro`` runs in ONE subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` on inputs this
module makes with numpy from a seed. It also gives the shard shape of
every argument of every recsys cell at the full configs, which the
port's cells on ``meta`` must have exactly.

Tolerances: loss, grad_norm rtol 1e-4 (lr 1e-6); every parameter after
the step within 1e-2 lr of ``repro``'s, 2 lr where its gradient is under
1e-7 (as ``tests/test_torch_partitioned_cells.py``), the row-wise
accumulators rtol 1e-3 (atol 1e-6 of the leaf's largest); serve outputs
and candidate scores rtol 1e-5, atol 1e-6; candidate ids exactly
``repro``'s; the partitioned lookup bit for bit the whole one."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeSpec, get_config, get_shapes
from repro_torch.distributed import placement as PL
from repro_torch.distributed import shard_map as SM
from repro_torch.distributed.sharding import (Sharded, ShardingPolicy,
                                              device_put)
from repro_torch.launch import cells as TC
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.recsys import embedding as EMB
from repro_torch.models.recsys import nets as R
from test_torch_recsys import reduced

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
ARCHS = ("dcn-v2", "autoint", "dlrm-mlperf", "bert4rec")
B_TRAIN, B_P99, B_BULK, CHUNK = 16, 8, 32, 8
N_CAND, PREFETCH, TOP, CAND_CHUNK = 301, 32, 10, 32
OC_LR = 1e-3
STEP_RTOL, PARAM_LR_FRAC, NOISE = 1e-4, 1e-2, 1e-7
TOL = dict(rtol=1e-5, atol=1e-6)


def cfg_of(get, arch):
    """The tests' reduced config, the item field at 120001 rows (not a
    multiple of the shards)."""
    if arch == "bert4rec":
        return reduced(get, arch)
    cfg = reduced(get, arch, mixed=True)
    vocab = list(cfg.vocab_sizes)
    vocab[2] = 120_001
    cfg = dataclasses.replace(cfg, vocab_sizes=tuple(vocab))
    if arch == "dlrm-mlperf":
        cfg = dataclasses.replace(cfg, embed_dim=16, bot_mlp=(32, 16))
    return cfg


def port_mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices=["cpu"] * 4)


def shape_of(kind):
    return {"train": ShapeSpec("train_batch", "train", {"batch": B_TRAIN}),
            "p99": ShapeSpec("serve_p99", "serve", {"batch": B_P99}),
            "bulk": ShapeSpec("serve_bulk", "serve", {"batch": B_BULK}),
            "ret": ShapeSpec("retrieval_cand", "retrieval",
                             {"batch": 1, "n_candidates": N_CAND})}[kind]


def _ctr_rows(cfg, r, B):
    sparse = np.stack([r.integers(0, v, B) for v in cfg.vocab_sizes], 1)
    sparse[B // 2:B // 2 + 4] = sparse[:4]         # rows summed in grads
    b = {"sparse": sparse}
    if cfg.n_dense:
        b["dense"] = r.normal(size=(B, cfg.n_dense))
    return b


def _b4r_rows(cfg, r, B):
    S = cfg.seq_len
    seq = r.integers(0, cfg.n_items, (B, S))
    seq[:, 5] = cfg.n_items                              # [MASK]
    lens = r.integers(1, S + 1, B)
    lens[0] = S
    return {"seq": seq, "seq_mask": np.arange(S)[None] < lens[:, None]}


def inputs() -> dict:
    """Per arch (``{arch}/{kind}/{key}``): the train batch, the two serve
    batches, the query and 304 candidates (13 of them repeats of others)
    with a 16-wide proxy table."""
    x = {}
    for a, arch in enumerate(ARCHS):
        cfg = cfg_of(get_config, arch)
        r = np.random.default_rng(60 + a)
        if arch == "bert4rec":
            M, K = 3, 32
            tr = _b4r_rows(cfg, r, B_TRAIN)
            tr.update(mlm_positions=r.integers(0, cfg.seq_len, (B_TRAIN, M)),
                      mlm_labels=r.integers(0, cfg.n_items, (B_TRAIN, M)),
                      mlm_mask=r.random((B_TRAIN, M)) > 0.2,
                      neg_samples=r.integers(0, cfg.n_items, K))
            serve = {k: dict(_b4r_rows(cfg, r, B), slate=r.integers(
                0, cfg.n_items, (B, 7))) for k, B in (("p99", B_P99),
                                                      ("bulk", B_BULK))}
            q = _b4r_rows(cfg, r, 1)
            rows = cfg.n_items
        else:
            tr = dict(_ctr_rows(cfg, r, B_TRAIN),
                      labels=r.integers(0, 2, B_TRAIN).astype(np.float64))
            serve = {k: _ctr_rows(cfg, r, B) for k, B in (("p99", B_P99),
                                                          ("bulk", B_BULK))}
            q = _ctr_rows(cfg, r, 1)
            rows = cfg.vocab_sizes[R._item_field(cfg)]
        n = -(-N_CAND // 4) * 4
        cand = r.integers(0, rows, n)
        cand[200:213] = cand[:13]                        # duplicates
        q.update(candidates=cand, cand_proxy=r.normal(size=(n, 16)))
        for kind, b in (("train", tr), ("p99", serve["p99"]),
                        ("bulk", serve["bulk"]), ("ret", q)):
            for k, v in b.items():
                x[f"{arch}/{kind}/{k}"] = v
    return {k: (v.astype(np.float32) if v.dtype == np.float64 else
                v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in x.items()}


def batch_of(x, arch, kind, keys=None) -> dict:
    pre = f"{arch}/{kind}/"
    return {k[len(pre):]: v for k, v in x.items() if k.startswith(pre)
            and (keys is None or k[len(pre):] in keys)}


_SCRIPT = r"""
import os, sys
from concurrent.futures import ThreadPoolExecutor
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, os.path.dirname(sys.argv[3]))
from repro.configs import get_config, get_shapes, ShapeSpec
from repro.launch import cells as JC
from repro.launch.mesh import make_mesh
from repro.models.recsys import nets as JR
from repro.training import optimizer as JOPT
import test_torch_partitioned_recsys as M

x = dict(np.load(sys.argv[1]))
out = {}
meshes = {k: make_mesh(*v) for k, v in M.MESHES.items()}

def path(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)

def save(prefix, tree):
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(filter(None, (prefix, path(kp))))] = np.asarray(leaf)

# the shard shape of every argument of every recsys cell, full configs
for arch in M.ARCHS:
    for shape in get_shapes(arch).values():
        for variant in ("base", "opt"):
            for mname, mesh in meshes.items():
                jc = JC.build_recsys_cell(arch, shape, mesh, variant)
                for i, (a, sh) in enumerate(zip(jc.args, jc.in_shardings)):
                    shs = jax.tree.leaves(sh)
                    for (kp, leaf), s in zip(
                            jax.tree_util.tree_flatten_with_path(a)[0], shs):
                        out[f"meta/{arch}/{shape.name}/{variant}/{mname}/"
                            f"{i}/{path(kp)}"] = np.asarray(
                                s.shard_shape(leaf.shape), np.int64)

# the reduced cells, run: one thread an arch (XLA compiles them side by
# side)
JR.serve_step.__defaults__ = (M.CHUNK,)
JR.retrieval_step.__kwdefaults__.update(prefetch_k=M.PREFETCH, top_k=M.TOP)
JC.get_config = lambda arch: M.cfg_of(get_config, arch)

def run(a, arch):
    cfg = JC.get_config(arch)
    for mname, mesh in meshes.items():
        pre = f"{arch}/{mname}"
        tp = M.MESHES[mname][0][1]
        p = jax.jit(JR.init_params, static_argnums=(0, 2))(
            cfg, jax.random.PRNGKey(a), tp)
        save(f"{pre}/p", p)
        jc = JC.build_recsys_cell(arch, M.shape_of("train"), mesh)
        st = jax.jit(JOPT.init_opt_state)(p)
        b = {k: jnp.asarray(v) for k, v in M.batch_of(x, arch, "train").items()}
        new, st, m = jax.jit(jc.fn, in_shardings=jc.in_shardings)(p, st, b)
        save(f"{pre}/new", new)
        save(f"{pre}/st", st["per_leaf"])
        save(f"{pre}/metrics", m)
        for kind in ("p99", "bulk"):
            jc = JC.build_recsys_cell(arch, M.shape_of(kind), mesh)
            b = {k: jnp.asarray(v) for k, v in
                 M.batch_of(x, arch, kind).items()}
            out[f"{pre}/{kind}"] = np.asarray(jax.jit(
                jc.fn, in_shardings=jc.in_shardings)(p, b))
        for variant in ("base", "opt"):
            jc = JC.build_recsys_cell(arch, M.shape_of("ret"), mesh, variant)
            keys = set(jc.args[1])
            b = {k: jnp.asarray(v) for k, v in
                 M.batch_of(x, arch, "ret", keys).items()}
            s, i = jax.jit(jc.fn, in_shardings=jc.in_shardings)(p, b)
            out[f"{pre}/{variant}/scores"] = np.asarray(s)
            out[f"{pre}/{variant}/ids"] = np.asarray(i)

with ThreadPoolExecutor(len(M.ARCHS)) as ex:
    for f in [ex.submit(run, a, arch) for a, arch in enumerate(M.ARCHS)]:
        f.result()
np.savez(sys.argv[2], **out)
print("PARTITIONED_RECSYS_REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("partitioned_recsys_ref")
    x = inputs()
    np.savez(d / "in.npz", **x)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(d / "in.npz"),
         str(d / "out.npz"), os.path.abspath(__file__)],
        env=env, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0 and "PARTITIONED_RECSYS_REF_OK" in p.stdout, \
        p.stderr[-3000:]
    return x, dict(np.load(d / "out.npz"))


@pytest.fixture
def small(monkeypatch):
    """``cells.get_config`` at the reduced configs; the serve chunk, the
    candidate chunk and the prefetch and top-k cut as in the reference."""
    monkeypatch.setattr(TC, "get_config",
                        lambda arch: cfg_of(get_config, arch))
    monkeypatch.setattr(R.serve_step.__wrapped__, "__defaults__",
                        (CHUNK, None))
    monkeypatch.setattr(R, "CAND_CHUNK", CAND_CHUNK)
    kw = dict(R.retrieval_step.__wrapped__.__kwdefaults__,
              prefetch_k=PREFETCH, top_k=TOP)
    monkeypatch.setattr(R.retrieval_step.__wrapped__, "__kwdefaults__", kw)


def cell(arch, kind, mname, variant="base"):
    return TC.build_recsys_cell(arch, shape_of(kind), "cpu", variant,
                                generator=torch.Generator(),
                                mesh=port_mesh(mname))


def load(params: dict, want: dict, prefix: str) -> None:
    """``repro``'s leaves copied into the placed parameters."""
    for n, s in params.items():
        src = device_put(want[f"{prefix}/{n}"], s.sharding, copy=True)
        with torch.no_grad():
            for dst, v in zip(s.slabs, src.slabs):
                dst.copy_(v)


def placed_batch(x, arch, kind, like: dict) -> dict:
    b = batch_of(x, arch, kind, set(like))
    return device_put({k: torch.from_numpy(v) for k, v in b.items()},
                      {k: v.sharding for k, v in like.items()}, copy=True)


@pytest.mark.parametrize("mname", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_repro(ref, small, arch, mname):
    """One step: metrics, every parameter and the row-wise accumulators
    of the tables after it against ``repro``'s partitioned step; the
    tables' slabs and accumulators are 1/tp of their rows a position."""
    x, want = ref
    pre = f"{arch}/{mname}"
    c = cell(arch, "train", mname)
    params, opt, batch = c.args
    load(params, want, f"{pre}/p")
    m = c.fn(params, opt, placed_batch(x, arch, "train", batch))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]),
                                   float(want[f"{pre}/metrics/{k}"]),
                                   rtol=STEP_RTOL, err_msg=f"{pre} {k}")
    lr = float(want[f"{pre}/metrics/lr"])
    np.testing.assert_allclose(float(m["lr"]), lr, rtol=1e-6)
    tp = MESHES[mname][0][1]
    for n, s in params.items():
        st = opt["per_leaf"][n]
        if "acc" in st:
            jacc = want[f"{pre}/st/{n}/acc"]
            np.testing.assert_allclose(st["acc"].gather().numpy(), jacc,
                                       rtol=1e-3,
                                       atol=1e-6 * float(jacc.max()),
                                       err_msg=f"{pre} {n} acc")
            if {"big", "items"} & set(n.split("/")):       # row slabs
                assert st["acc"].slabs[0].shape[0] == s.shape[0] // tp
                assert s.slabs[0].shape[0] == s.shape[0] // tp, n
            g = np.full(s.shape, np.inf)
        else:
            g = np.abs(want[f"{pre}/st/{n}/m"]) / 0.1
        jnew = want[f"{pre}/new/{n}"]
        bound = np.where(g < NOISE, 2 * lr, PARAM_LR_FRAC * lr) \
            + 2 * np.spacing(np.abs(jnew))
        got = s.gather().detach().numpy()
        bad = np.argwhere(np.abs(got - jnew) > bound)
        assert not len(bad), (f"{pre} {n}: {len(bad)} of {got.size} off, "
                              f"first at {tuple(bad[0])}")


@pytest.mark.parametrize("mname", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cells_match_repro(ref, small, arch, mname):
    """``serve_p99`` (8 rows) and ``serve_bulk`` (32 rows in chunks of 8:
    ``repro`` maps 4 chunks of the global batch, each position chunks its
    own 16 or 32 rows) against ``repro``'s partitioned cells."""
    x, want = ref
    pre = f"{arch}/{mname}"
    for kind in ("p99", "bulk"):
        c = cell(arch, kind, mname)
        params, batch = c.args
        load(params, want, f"{pre}/p")
        got = c.fn(params, placed_batch(x, arch, kind, batch))
        w = want[f"{pre}/{kind}"]
        assert tuple(got.shape) == w.shape
        np.testing.assert_allclose(got.numpy(), w, **TOL,
                                   err_msg=f"{pre} {kind}")


@pytest.mark.parametrize("variant", ["base", "opt"])
@pytest.mark.parametrize("mname", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_cells_match_repro(ref, small, arch, mname, variant):
    """``retrieval_cand`` over 301 candidates padded to 304 (76 a
    position, 13 repeats): base scores every candidate where it lies and
    takes one top-k of the gathered scores; opt reads its co-placed
    ``cand_proxy`` block, merges each position's top-32 and reranks the
    32 prefetched ids exactly. Ids exactly ``repro``'s."""
    x, want = ref
    pre = f"{arch}/{mname}"
    c = cell(arch, "ret", mname, variant)
    params, batch = c.args
    load(params, want, f"{pre}/p")
    assert batch["candidates"].slabs[0].shape == (76,)
    s, i = c.fn(params, placed_batch(x, arch, "ret", batch))
    np.testing.assert_array_equal(i.numpy(), want[f"{pre}/{variant}/ids"])
    np.testing.assert_allclose(s.numpy(), want[f"{pre}/{variant}/scores"],
                               **TOL)


@pytest.mark.parametrize("mname", MESHES)
def test_opt_scores_reach_topk_in_blocks(small, monkeypatch, mname):
    """The opt cell's candidate scores reach ``_topk`` as each position's
    block of N/S = 76 scores inside the body; no whole score vector is
    made anywhere."""
    seen = []
    real = R._topk

    def spy(scores, k, shard=None, two_level=False):
        seen.append((SM.in_shard_map(), tuple(scores.shape), two_level))
        return real(scores, k, shard, two_level)
    monkeypatch.setattr(R, "_topk", spy)
    tops = []
    top = R.sorted_top_k
    monkeypatch.setattr(R, "sorted_top_k", lambda s, k: (
        tops.append(tuple(s.shape)), top(s, k))[1])
    for arch in ("dcn-v2", "bert4rec"):
        seen.clear()
        tops.clear()
        c = cell(arch, "ret", mname, "opt")
        c.fn(*c.args)
        assert seen == [(True, (76,), True)] * 4
        assert (304,) not in tops and tops.count((76,)) == 4


@pytest.mark.parametrize("rows", ["dp", "flat"])
@pytest.mark.parametrize("mname", MESHES)
def test_partitioned_lookup_is_lookup_bit_for_bit(mname, rows):
    """``lookup`` inside a body on the big table's row slabs (ids split
    over dp: a psum over tp; over flat: gathered over tp, then a
    psum_scatter) equals the whole ``lookup`` bit for bit, negative ids
    wrapping and ids off the table giving NaN rows."""
    tp = MESHES[mname][0][1]
    layout = EMB.EmbeddingLayout((1201, 50, 2002), 8, row_shard_threshold=1000)
    emb = EMB.init_embedding(layout, torch.Generator().manual_seed(5), "cpu",
                             n_shards=tp)
    r = np.random.default_rng(6)
    idx = np.stack([r.integers(-1201, 1201, 32), r.integers(0, 50, 32),
                    r.integers(0, 2002, 32)], 1)
    idx[3, 0], idx[9, 2] = 5000, -9000            # off the padded table
    idx = torch.from_numpy(idx.astype(np.int32))
    mesh = port_mesh(mname)
    pol = ShardingPolicy(mesh)
    body_pol = R.rows_over(pol, pol.axes(rows))
    tmpl = EMB.init_embedding(layout, None, "meta", n_shards=tp)
    P = SM.P
    spec = P(pol.axes(rows), None)

    def body(tables, ids):
        got = EMB.lookup(PL.bind_params(tmpl, tables), ids, body_pol)
        assert got.shape[0] == 32 // pol.axis_size(rows)
        return got

    got = SM.shard_map(body, mesh, ({"big": P("model", None), "small": P()},
                                    spec), P(pol.axes(rows), None, None))(
        {"big": emb.big.detach(), "small": emb.small.detach()}, idx)
    want = EMB.lookup(emb, idx).detach()
    assert torch.isnan(want[3, 0]).all() and torch.isnan(want[9, 2]).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("mname", MESHES)
def test_cells_on_meta_have_repros_shard_shapes(ref, mname):
    """Full configs on ``meta``: every slab of every argument of every
    recsys cell (4 shapes x base and opt) has ``repro``'s
    ``in_shardings[i].shard_shape`` exactly, the same keys, and no
    position holds a whole table or accumulator its spec splits."""
    _, want = ref
    mesh = port_mesh(mname)
    tp = MESHES[mname][0][1]

    def flat(a, prefix=""):
        if isinstance(a, dict):
            return {k2: v2 for k, v in a.items()
                    for k2, v2 in flat(v, f"{prefix}{k}/").items()}
        return {prefix[:-1]: a}

    n = 0
    for arch in ARCHS:
        for shape in get_shapes(arch):
            for variant in ("base", "opt"):
                c = TC.build_cell(arch, shape, "meta", variant=variant,
                                  mesh=mesh)
                for i, a in enumerate(c.args):
                    pre = f"meta/{arch}/{shape}/{variant}/{mname}/{i}/"
                    got = flat(a)
                    keys = {k[len(pre):] for k in want if k.startswith(pre)}
                    assert set(got) == keys, (pre, set(got) ^ keys)
                    for k, s in got.items():
                        assert isinstance(s, Sharded) and s.slabs[0].device \
                            .type == "meta"
                        w = tuple(int(v) for v in want[pre + k])
                        assert all(tuple(t.shape) == w for t in s.slabs), \
                            (pre + k, tuple(s.slabs[0].shape), w)
                        if "big" in k.split("/") or "items" in k.split("/"):
                            assert s.slabs[0].shape[0] * tp == s.shape[0]
                        n += 1
    assert n > 0
