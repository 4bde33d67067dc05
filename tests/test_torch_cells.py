"""The port's single-device cells (``repro_torch.launch.cells``) against
``repro.launch.cells``:

(a) every cell ``repro`` builds (its ``get_cells(ALL_ARCHS)`` x the
    variants), built on ``meta``: ``model_flops`` equal with ``==``, the
    note and ``donate`` equal, the inputs' keys, shapes and dtypes equal,
    the parameter and optimizer-state element counts equal;
(b) one cell of every kind run on the CPU at a small size (the family
    tests' reduced configs, patched into both ``cells`` modules) against
    ``repro``'s cell from the same weights and the same numpy inputs;
    the GNN cells are in ``test_torch_cells_gnn.py``.

Inputs come from ``np.random.default_rng(seed)``; no test changes
process-wide state (monkeypatch undoes every patch)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as J_ALL_ARCHS
from repro.configs import get_cells as jax_cells
from repro.configs import get_config as jax_config
from repro.configs import get_shapes as jax_shapes
from repro.kernels.maxsim.ops import quantize_int8 as jax_quantize
from repro.launch import cells as JC
from repro.launch import train as JTR
from repro.models import late_interaction as JLI
from repro.models import transformer as JT
from repro.models.recsys import nets as JR
from repro.training import optimizer as JOPT
from repro_torch.configs import ALL_ARCHS, get_config, get_shapes
from repro_torch.launch import cells as TC
from repro_torch.launch import train as TR
from test_torch_recsys import reduced as recsys_reduced
from test_torch_training import small_cfg as retriever_small

torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# tolerances
# ---------------------------------------------------------------------------

# train-step metrics (loss, grad_norm, lr): XLA's fused jitted step against
# eager PyTorch in float32 (the LM, recsys and retriever train tests' limit)
STEP_RTOL = 1e-4
# parameters after one step, held to a hundredth of the step's learning
# rate (3e-6 or 1e-5 at step 1, so a state left unchanged, an update of the
# wrong sign or the wrong rule for a leaf is off by about lr) plus two
# float32 spacings of the parameter (p - lr * u rounds to the grid of p)
PARAM_LR_FRAC = 1e-2
# a ``repro`` gradient element below this is within the float32 noise of
# the sums that make it (test_torch_lm_train.py's NOISE_FLOOR): AdamW
# divides by its size, so the two updates may differ by up to 2 lr; such
# elements (and rows of a row-wise table whose accumulator is below it)
# are held to 2 lr instead
NOISE_FLOOR = 1e-7
# forward outputs (logits, caches, serve and retrieval scores) in float32
RTOL, ATOL = 1e-5, 1e-6
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-5       # test_torch_lm.py's logits
# bfloat16 outputs of float32 work: one rounding apart at most
BF16_RTOL = 2 ** -7
# the search cells: scores as the engine tests hold them, ids equal apart
# from scores tied within 1e-5
TIE = 1e-5
# dtypes the port's cells give otherwise than ``repro``'s, by design: none
DTYPE_BY_DESIGN = {}

# ---------------------------------------------------------------------------
# (a) every cell on meta
# ---------------------------------------------------------------------------


def _variants(arch, shape):
    return ("base", "opt") + (
        ("stage1",) if jax_shapes(arch)[shape].kind == "search" else ())


CELLS = [(a, s, v) for a, s in jax_cells(J_ALL_ARCHS)
         for v in _variants(a, s)]


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.dtype(x.dtype).name


def _sig(x) -> tuple:
    return tuple(int(s) for s in x.shape), _dtype(x)


def _n_elems(leaves) -> int:
    return sum(int(np.prod(x.shape)) for x in leaves)


def _same_inputs(got, want, what: str) -> None:
    """Keys, shapes and dtypes of a batch, a cache tree, a store or one
    array, in ``repro``'s order."""
    if isinstance(want, dict):
        assert list(got) == list(want) or set(got) == set(want), (
            what, sorted(got), sorted(want))
        for k in want:
            _same_inputs(got[k], want[k], f"{what}/{k}")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same_inputs(g, w, f"{what}/{i}")
        return
    shape, dt = _sig(got)
    want_shape, want_dt = _sig(want)
    assert shape == want_shape, (what, shape, want_shape)
    assert DTYPE_BY_DESIGN.get(what, want_dt) == dt, (what, dt, want_dt)


def test_every_cell_of_repro_is_listed():
    assert len(CELLS) == 101
    assert ALL_ARCHS == J_ALL_ARCHS
    assert [(a, s) for a, s, _ in CELLS if _ == "base"] == [
        (a, s) for a in ALL_ARCHS for s in get_shapes(a)]
    assert [v for a, s, v in CELLS if (a, s) == ("colpali", "search_1m")] \
        == list(TC.variants("colpali", "search_1m"))


@pytest.mark.parametrize("arch,shape,variant", CELLS,
                         ids=[f"{a}-{s}-{v}" for a, s, v in CELLS])
def test_meta_cell_matches_repro(arch, shape, variant):
    want = JC.build_cell(arch, shape, None, variant)
    got = TC.build_cell(arch, shape, "meta", variant)
    assert (got.arch, got.shape) == (want.arch, want.shape)
    assert got.model_flops == want.model_flops
    assert got.note == want.note
    assert got.donate == want.donate
    assert len(got.args) == len(want.args)
    assert all(t.device.type == "meta" for t in TC.arg_tensors(got.args))
    kind = get_shapes(arch)[shape].kind
    if kind == "search":                       # (store, q, q_mask)
        _same_inputs(list(got.args), list(want.args), "search")
        assert TC.arg_bytes(got) == sum(
            int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
            for x in jax.tree.leaves(want.args))
        return
    model, rest = got.args[0], got.args[1:]
    assert sum(p.numel() for p in model.parameters()) == _n_elems(
        jax.tree.leaves(want.args[0]))
    if got.donate == (0, 1):                   # (params, opt state, batch)
        opt, jopt = rest[0], want.args[1]
        assert set(opt) == set(jopt) == {"step", "per_leaf"}
        _same_inputs(opt["step"], jopt["step"], "opt/step")
        assert _n_elems(TC.arg_tensors(opt["per_leaf"])) == _n_elems(
            jax.tree.leaves(jopt["per_leaf"]))
        assert {_dtype(x) for x in TC.arg_tensors(opt["per_leaf"])} == {
            _dtype(x) for x in jax.tree.leaves(jopt["per_leaf"])}
        rest = rest[1:]
        want_rest = want.args[2:]
    else:
        want_rest = want.args[1:]
    _same_inputs(list(rest), list(want_rest), f"{arch}/{shape}")
    assert TC.arg_bytes(got) == sum(
        int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
        for x in jax.tree.leaves(want.args))


def test_flop_helpers_match_repro():
    """The FLOP formulas at sizes no cell uses: equal with ``==``."""
    for arch in ("minicpm-2b", "olmoe-1b-7b"):
        for tokens, train in ((1, True), (12345, False)):
            assert TC._lm_batch_flops(get_config(arch), tokens, train) == \
                JC._lm_batch_flops(jax_config(arch), tokens, train)
    g, jg = get_config("equiformer-v2"), jax_config("equiformer-v2")
    for e in (1, 977):
        assert TC._gnn_layer_flops(g, e) == JC._gnn_layer_flops(jg, e)
        for train in (True, False):
            assert TC._gnn_flops(g, e, train) == JC._gnn_flops(jg, e, train)
    for arch in ("dcn-v2", "autoint", "bert4rec", "dlrm-mlperf"):
        assert TC._recsys_dense_flops(get_config(arch), 37) == \
            JC._recsys_dense_flops(jax_config(arch), 37)


def test_search_stage1_counts_the_rerank_as_repro_does():
    """``repro``'s search ``model_flops`` counts the 2-stage rerank for
    the 1-stage variant too; the port keeps the number."""
    a = TC.build_cell("colpali", "search_1m", "meta", "stage1")
    b = TC.build_cell("colpali", "search_1m", "meta", "base")
    assert a.model_flops == b.model_flops
    assert a.note == "stages=['initial']"


def test_meta_cells_allocate_nothing():
    c = TC.build_cell("colpali", "search_1m", "meta", "opt")
    assert TC.arg_bytes(c) > 270e9
    assert all(t.is_meta for t in TC.arg_tensors(c.args))
    c = TC.build_cell("gemma2-9b", "train_4k", "meta", "base")
    assert all(t.is_meta for t in TC.arg_tensors(c.args))


def test_build_cell_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        TC.build_cell("dcn-v2", "serve_p99", "mps")


# ---------------------------------------------------------------------------
# (b) one cell of every kind, run on the CPU against repro's
# ---------------------------------------------------------------------------

def _patch(monkeypatch, tcfg, jcfg):
    monkeypatch.setattr(TC, "get_config", lambda arch: tcfg)
    monkeypatch.setattr(JC, "get_config", lambda arch: jcfg)


def _tree_get(tree, name: str):
    for k in name.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def _load(model, jp) -> None:
    """``repro``'s weights (numpy) into the cell's model, bit for bit."""
    model.load_jax_leaves([_tree_get(jp, n) for n in model.jax_leaf_names()])


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.detach().float().numpy()


def _torch(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _run_train(jc, tc, jp, batch, jit=jax.jit):
    """One step of each package's cell from ``repro``'s weights ``jp``:
    (port metrics, repro metrics, repro's new params, repro's new
    optimizer state)."""
    _load(tc.args[0], jp)
    labels = JOPT.default_labels(jp)
    jst = JOPT.init_opt_state(jp, labels)
    jnew, jst, jm = jit(jc.fn)(jax.tree.map(jnp.asarray, jp), jst,
                               {k: jnp.asarray(v) for k, v in batch.items()})
    m = tc.fn(tc.args[0], tc.args[1], _torch(batch))
    assert int(tc.args[1]["step"]) == 1
    return m, jm, jnew, jst


def _leaf_states(jst) -> list:
    """``repro``'s per-leaf optimizer states ({"m", "v"} or {"acc"}) in
    the params tree's leaf order."""
    return jax.tree.leaves(jst["per_leaf"], is_leaf=lambda x: isinstance(
        x, dict) and ("m" in x or "acc" in x))


def _noisy(state: dict, shape, rel: float) -> np.ndarray:
    """Elements whose step-1 ``repro`` gradient g (clip-scaled) is below
    ``NOISE_FLOOR`` or below ``rel`` x the leaf's largest |g|: AdamW's m
    is (1 - b1) g; a row-wise table's accumulator is the row's mean of
    g^2."""
    if "acc" in state:
        rms = np.sqrt(np.asarray(state["acc"]))
        small = rms < max(NOISE_FLOOR, rel * rms.max(initial=0.0))
        return np.broadcast_to(small.reshape(
            rms.shape + (1,) * (len(shape) - 1)), shape)
    g = np.abs(np.asarray(state["m"]) / (1.0 - JOPT.OptConfig().betas[0]))
    return g < max(NOISE_FLOOR, rel * g.max(initial=0.0))


def _check_step(m, jm, jnew, jst, tc, what, loss_rtol=STEP_RTOL,
                gn_rtol=STEP_RTOL, noise_rel=0.0):
    """The step's metrics, each leaf's optimizer rule (the port's state
    has ``repro``'s keys), and every parameter after the update within
    ``PARAM_LR_FRAC`` of the learning rate (2 lr where ``_noisy``)."""
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=loss_rtol, err_msg=f"{what} loss")
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=gn_rtol, err_msg=f"{what} grad_norm")
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6,
                               err_msg=f"{what} lr")
    lr = float(jm["lr"])
    model, per_leaf = tc.args[0], tc.args[1]["per_leaf"]
    names = {id(p): n for n, p in model.named_parameters()}
    leaves = zip(model.jax_leaf_names(), model.to_jax_leaves(),
                 jax.tree.leaves(jnew), _leaf_states(jst))
    for name, got, want, state in leaves:
        for p in model.jax_leaf_params(name):
            assert set(per_leaf[names[id(p)]]) == set(state), (what, name)
        got, want = got.numpy(), np.asarray(want)
        noisy = _noisy(state, want.shape, noise_rel)
        bound = np.where(noisy, 2 * lr, PARAM_LR_FRAC * lr) \
            + 2 * np.spacing(np.abs(want))
        err = np.abs(got - want)
        bad = np.argwhere(err > bound)
        assert not len(bad), (f"{what} {name}: {len(bad)} of {err.size} "
                              f"off; first at {tuple(bad[0])}: "
                              f"{err[tuple(bad[0])]:.3g} > "
                              f"{bound[tuple(bad[0])]:.3g} (lr {lr:.3g})")


def _shape_spec(name, kind, dims):
    from repro_torch.configs import ShapeSpec
    return ShapeSpec(name, kind, dims)


def _jshape(shape):
    from repro.configs import ShapeSpec
    return ShapeSpec(shape.name, shape.kind, dict(shape.dims))


def _ids_match(ids, jids, jscores, what):
    """Ids equal apart from positions whose ``repro`` score ties a
    neighbour's within ``TIE``."""
    ids, jids, jscores = (np.asarray(ids), np.asarray(jids),
                          np.asarray(jscores, np.float32))
    for r, j in zip(*np.nonzero(ids != jids)):
        near = [abs(jscores[r, j] - jscores[r, jj]) <= TIE
                for jj in (j - 1, j + 1) if 0 <= jj < jscores.shape[1]]
        assert any(near), (what, r, j, ids[r, j], jids[r, j])


def _gen():
    """The port cells' own fills (replaced here by ``repro``'s weights and
    the tests' numpy inputs)."""
    return torch.Generator().manual_seed(0)


# ---- LM ------------------------------------------------------------------

def _lm(monkeypatch, arch):
    tcfg, jcfg = TR.reduced_lm(get_config(arch)), JTR.reduced_lm(
        jax_config(arch))
    _patch(monkeypatch, tcfg, jcfg)
    jp = jax.tree.map(np.array, jax.jit(JT.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)))
    return tcfg, jcfg, jp


@pytest.mark.parametrize("variant", ["base", "opt"])
def test_lm_train_cell_runs_as_repro(monkeypatch, variant):
    """granite-moe (dense MoE in base, the ragged dispatch and 8
    checkpointed microbatches in opt), reduced, batch 8 x 16."""
    arch = "granite-moe-1b-a400m"
    tcfg, _, jp = _lm(monkeypatch, arch)
    shape = _shape_spec("train_4k", "train", dict(seq_len=16, global_batch=8))
    jc = JC.build_lm_cell(arch, _jshape(shape), None, variant)
    tc = TC.build_lm_cell(arch, shape, "cpu", variant, _gen())
    assert tc.args[0].cfg.moe.impl == ("ragged_ep" if variant == "opt"
                                       else "dense")
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, tcfg.vocab_size, (8, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    _check_step(*_run_train(jc, tc, jp, batch), tc, f"lm train {variant}")


def test_lm_prefill_and_decode_cells_run_as_repro(monkeypatch):
    """gemma3-4b reduced (windows of 16, a ring at seq 24): the prefill's
    logits and caches, then the decode cell on those caches."""
    arch = "gemma3-4b"
    tcfg, _, jp = _lm(monkeypatch, arch)
    pre = _shape_spec("prefill_32k", "prefill", dict(seq_len=24, global_batch=2))
    dec = _shape_spec("decode_32k", "decode", dict(seq_len=24, global_batch=2))
    jpre = JC.build_lm_cell(arch, _jshape(pre), None)
    tpre = TC.build_lm_cell(arch, pre, "cpu", generator=_gen())
    jdec = JC.build_lm_cell(arch, _jshape(dec), None)
    tdec = TC.build_lm_cell(arch, dec, "cpu", generator=_gen())
    _load(tpre.args[0], jp)
    _load(tdec.args[0], jp)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 24)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, jp)
    jl, jcache = jax.jit(jpre.fn)(jparams, {"tokens": jnp.asarray(tokens)})
    logits, caches = tpre.fn(tpre.args[0], {"tokens": torch.from_numpy(
        tokens)})
    np.testing.assert_allclose(_np(logits), _np(jl), rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL, err_msg="prefill logits")
    for got, want in zip(TC.arg_tensors(caches), jax.tree.leaves(jcache)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    # decode one token at the last position on the prefill's caches
    tok = rng.integers(0, tcfg.vocab_size, (2, 1)).astype(np.int32)
    _same_inputs(TC.arg_tensors(caches), TC.arg_tensors(tdec.args[1]),
                 "decode caches")
    assert int(tdec.args[3]) == 23
    jl2, jc2 = jax.jit(jdec.fn)(jparams, jcache, jnp.asarray(tok),
                                jnp.int32(23))
    l2, c2 = tdec.fn(tdec.args[0], caches, torch.from_numpy(tok),
                     tdec.args[3])
    np.testing.assert_allclose(_np(l2), _np(jl2), rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL, err_msg="decode logits")
    for got, want in zip(TC.arg_tensors(c2), jax.tree.leaves(jc2)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


# ---- recsys --------------------------------------------------------------

def _recsys(monkeypatch, arch):
    tcfg = recsys_reduced(get_config, arch, mixed=arch != "bert4rec")
    jcfg = recsys_reduced(jax_config, arch, mixed=arch != "bert4rec")
    _patch(monkeypatch, tcfg, jcfg)
    jp = jax.tree.map(np.array, JR.init_params(jcfg, jax.random.PRNGKey(0)))
    return tcfg, jp


def _ctr_batch(cfg, rng, B, labels=True):
    b = {"sparse": np.stack([rng.integers(0, v, B) for v in cfg.vocab_sizes],
                            1).astype(np.int32)}
    if labels:
        b["labels"] = rng.integers(0, 2, B).astype(np.float32)
    if cfg.n_dense:
        b["dense"] = rng.normal(size=(B, cfg.n_dense)).astype(np.float32)
    return b


@pytest.mark.parametrize("arch", ["dcn-v2", "bert4rec"])
def test_recsys_train_cell_runs_as_repro(monkeypatch, arch):
    cfg, jp = _recsys(monkeypatch, arch)
    shape = _shape_spec("train_batch", "train", dict(batch=16))
    jc = JC.build_recsys_cell(arch, _jshape(shape), None)
    tc = TC.build_recsys_cell(arch, shape, "cpu", generator=_gen())
    rng = np.random.default_rng(7)
    if arch == "bert4rec":
        S, M = cfg.seq_len, 40
        mask = np.ones((16, S), bool)
        mask[3, 8:] = False
        batch = {"seq": rng.integers(0, cfg.n_items, (16, S)).astype(
                     np.int32),
                 "seq_mask": mask,
                 "mlm_positions": rng.integers(0, S, (16, M)).astype(
                     np.int32),
                 "mlm_labels": rng.integers(0, cfg.n_items, (16, M)).astype(
                     np.int32),
                 "mlm_mask": rng.random((16, M)) > 0.3,
                 "neg_samples": rng.integers(0, cfg.n_items, 256).astype(
                     np.int32)}
    else:
        batch = _ctr_batch(cfg, rng, 16)
    _check_step(*_run_train(jc, tc, jp, batch), tc, f"{arch} train")


def test_recsys_serve_cell_runs_as_repro(monkeypatch):
    cfg, jp = _recsys(monkeypatch, "dcn-v2")
    shape = _shape_spec("serve_p99", "serve", dict(batch=32))
    jc = JC.build_recsys_cell("dcn-v2", _jshape(shape), None)
    tc = TC.build_recsys_cell("dcn-v2", shape, "cpu", generator=_gen())
    _load(tc.args[0], jp)
    batch = _ctr_batch(cfg, np.random.default_rng(8), 32, labels=False)
    _same_inputs(tc.args[1], jc.args[1], "serve batch")
    want = jax.jit(jc.fn)(jax.tree.map(jnp.asarray, jp),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    got = tc.fn(tc.args[0], _torch(batch))
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", ["base", "opt"])
def test_recsys_retrieval_cell_runs_as_repro(monkeypatch, variant):
    """1000 candidates: base scores all of them (1 stage), opt prefetches
    256 by a 16-dim ``cand_proxy`` and reranks (``repro``'s two-level
    top-k over one device)."""
    cfg, jp = _recsys(monkeypatch, "dcn-v2")
    shape = _shape_spec("retrieval_cand", "retrieval",
                   dict(batch=1, n_candidates=1000))
    jc = JC.build_recsys_cell("dcn-v2", _jshape(shape), None, variant)
    tc = TC.build_recsys_cell("dcn-v2", shape, "cpu", variant, _gen())
    _load(tc.args[0], jp)
    rng = np.random.default_rng(9)
    batch = _ctr_batch(cfg, rng, 1, labels=False)
    item = cfg.vocab_sizes[int(np.argmax(cfg.vocab_sizes))]
    batch["candidates"] = rng.integers(0, item, 1000).astype(np.int32)
    if variant == "opt":
        batch["cand_proxy"] = rng.normal(size=(1000, 16)).astype(np.float32)
    _same_inputs(tc.args[1], jc.args[1], "retrieval batch")
    js, ji = jax.jit(jc.fn)(jax.tree.map(jnp.asarray, jp),
                            {k: jnp.asarray(v) for k, v in batch.items()})
    s, i = tc.fn(tc.args[0], _torch(batch))
    assert tuple(i.shape) == (100,)
    _ids_match(i.numpy()[None], np.asarray(ji)[None], np.asarray(js)[None],
               f"retrieval {variant}")
    np.testing.assert_allclose(_np(s), _np(js), rtol=RTOL, atol=ATOL)


# ---- retrievers ----------------------------------------------------------

def _retriever(monkeypatch, **over):
    tcfg = dataclasses.replace(retriever_small(get_config), **over)
    jcfg = dataclasses.replace(retriever_small(jax_config), **over)
    _patch(monkeypatch, tcfg, jcfg)
    jp = jax.tree.map(np.array, JLI.init_params(jcfg, jax.random.PRNGKey(0)))
    return tcfg, jp


def test_retriever_train_cell_runs_as_repro(monkeypatch):
    cfg, jp = _retriever(monkeypatch)
    shape = _shape_spec("train_contrastive", "train", dict(global_batch=4))
    jc = JC.build_retriever_cell("colpali", _jshape(shape), None)
    tc = TC.build_retriever_cell("colpali", shape, "cpu", generator=_gen())
    rng = np.random.default_rng(10)
    Q = cfg.max_query_tokens
    qmask = np.ones((4, Q), bool)
    qmask[:, 10:] = False
    batch = {"patches": rng.normal(size=(4, cfg.n_patches, 64)).astype(
                 np.float32),
             "query_tokens": rng.integers(0, cfg.query_vocab, (4, Q)).astype(
                 np.int32),
             "query_mask": qmask}
    _check_step(*_run_train(jc, tc, jp, batch), tc, "retriever train")


def test_retriever_index_cell_runs_as_repro(monkeypatch):
    """encode -> hygiene -> pooling (the port's cell through
    ``pool_pages_fused``, whose plain version runs on the CPU; ``repro``'s
    through ``pool_ref``) -> bf16 vectors, pooled vectors, global vector."""
    cfg, jp = _retriever(monkeypatch)
    shape = _shape_spec("index_1m", "index", dict(pages_per_step=3, corpus=10))
    jc = JC.build_retriever_cell("colpali", _jshape(shape), None)
    tc = TC.build_retriever_cell("colpali", shape, "cpu", generator=_gen())
    _load(tc.args[0], jp)
    patches = np.random.default_rng(11).normal(
        size=(3, cfg.n_patches, 64)).astype(np.float32)
    want = jax.jit(jc.fn)(jax.tree.map(jnp.asarray, jp), jnp.asarray(patches))
    with torch.no_grad():
        got = tc.fn(tc.args[0], torch.from_numpy(patches))
    for what, g, w in zip(("vectors", "pooled", "global"), got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=BF16_RTOL,
                                   atol=1e-6, err_msg=what)


def _store(cfg, rng, n):
    from repro_torch.retrieval.store import mask_key

    def unit(shape):
        x = rng.normal(size=shape)
        x = x / np.linalg.norm(x, axis=-1, keepdims=True)
        return jnp.asarray(x, jnp.bfloat16)

    d = cfg.out_dim
    store = {"initial": unit((n, cfg.n_patches, d)),
             mask_key("initial"): rng.random((n, cfg.n_patches)) > 0.05,
             "mean_pooling": unit((n, cfg.n_pooled, d)),
             mask_key("mean_pooling"): np.ones((n, cfg.n_pooled), bool),
             "global_pooling": unit((n, d))}
    return store


@pytest.mark.parametrize("variant", ["stage1", "base", "opt"])
def test_retriever_search_cell_runs_as_repro(monkeypatch, variant):
    """300 pages, 4 queries of 32 tokens (6 masked), prefetch 40, top 10;
    opt scans ``repro``'s int8 codes of ``mean_pooling``. Ids equal apart
    from ties within 1e-5; scores rtol 1e-5, atol 1e-6."""
    from repro_torch.retrieval.store import codes_key, scale_key
    cfg, _ = _retriever(monkeypatch, out_dim=32)
    shape = _shape_spec("search_1m", "search", dict(query_batch=4, corpus=300,
                                               prefetch_k=40, top_k=10))
    jc = JC.build_retriever_cell("colpali", _jshape(shape), None, variant)
    tc = TC.build_retriever_cell("colpali", shape, "cpu", variant, _gen())
    assert tc.note == jc.note
    rng = np.random.default_rng(12)
    store = _store(cfg, rng, 300)
    if variant == "opt":
        codes, scales = jax_quantize(store["mean_pooling"])
        store[codes_key("mean_pooling")] = codes
        store[scale_key("mean_pooling")] = scales
    q = rng.normal(size=(4, 32, 32))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    qm = np.ones((4, 32), np.float32)
    qm[:, 26:] = 0.0
    _same_inputs([tc.args[0], tc.args[1], tc.args[2]],
                 [{k: np.asarray(v) for k, v in store.items()}, q, qm],
                 "search inputs")
    js, ji = jc.fn({k: jnp.asarray(v) for k, v in store.items()},
                   jnp.asarray(q), jnp.asarray(qm))
    tstore = {k: torch.from_numpy(np.array(jnp.asarray(v, jnp.float32))
                                  ).to(torch.bfloat16)
              if v.dtype == jnp.bfloat16 else torch.from_numpy(np.array(v))
              for k, v in store.items()}
    s, i = tc.fn(tstore, torch.from_numpy(q), torch.from_numpy(qm))
    assert tuple(i.shape) == (4, 10)
    _ids_match(i.numpy(), np.asarray(ji), np.asarray(js), variant)
    np.testing.assert_allclose(_np(s), _np(js), rtol=RTOL, atol=ATOL)
