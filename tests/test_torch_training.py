"""The port's training substrate against ``repro.training``: schedules,
the label-routed AdamW / row-wise Adagrad, the train step on the ColX
encoder, int8 gradient compression, the straggler tools, train-state
checkpoints that resume across packages, and the training example."""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.distributed.sharding import ShardingPolicy
from repro.models import late_interaction as JLI
from repro.training import checkpoint as JCKPT
from repro.training import compression as JC
from repro.training import optimizer as JOPT
from repro.training.train_loop import make_train_step as jax_train_step
from repro_torch.configs import get_config
from repro_torch.models import late_interaction as LI
from repro_torch.training import compression as C
from repro_torch.training import elastic as EL
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_state as TS
from repro_torch.training.train_loop import make_train_step, train_many

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHARD = ShardingPolicy(None)
# three steps: XLA's fused jitted step against eager PyTorch, f32
STEP_RTOL, PARAM_ATOL = 1e-4, 1e-4
# the same update rule, elementwise, op for op
UPD_RTOL, UPD_ATOL = 1e-6, 1e-7


# ---------------------------------------------------------------------------
# counterparts of tests/test_training.py
# ---------------------------------------------------------------------------

def test_wsd_schedule_shape():
    lr = OPT.wsd_schedule(1.0, warmup=10, stable=50, decay=40)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1.0) < 1e-6
    assert abs(float(lr(40)) - 1.0) < 1e-6       # stable plateau
    assert float(lr(100)) <= 0.11                # decayed to floor
    assert float(lr(80)) > float(lr(100))


def test_cosine_schedule():
    lr = OPT.cosine_schedule(2.0, warmup=5, total=105)
    assert float(lr(5)) == 2.0
    assert float(lr(105)) < 1e-6


def test_adamw_converges_quadratic():
    p = {"w": torch.tensor([5.0, -3.0])}
    labels = OPT.default_labels(p)
    st = OPT.init_opt_state(p, labels)
    oc = OPT.OptConfig(lr=0.3, weight_decay=0.0, schedule="const",
                       clip_norm=0)
    for _ in range(150):
        OPT.apply_updates(p, {"w": 2 * p["w"]}, st, oc, labels=labels)
    assert float(p["w"].abs().max()) < 0.05


def test_rowwise_adagrad_state_is_tiny():
    p = {"emb.big": torch.ones((1000, 64))}
    labels = OPT.default_labels(p)
    st = OPT.init_opt_state(p, labels)
    assert st["per_leaf"]["emb.big"]["acc"].shape == (1000,)


def test_deterministic_batch_seed():
    s1 = EL.deterministic_batch_seed(7, 100, 3)
    s2 = EL.deterministic_batch_seed(7, 100, 3)
    s3 = EL.deterministic_batch_seed(7, 100, 4)
    assert s1 == s2 != s3


def test_straggler_watchdog():
    dog = EL.StragglerWatchdog(tolerance=2.0)
    flagged = [dog.record(0.1) for _ in range(10)]
    assert not any(flagged)
    assert dog.record(0.5)          # 5x median -> straggler


def test_int8_compression_roundtrip_accuracy():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
    q, s = C.quantize_int8(g)
    deq = q.float() * s
    rel = float((deq - g).abs().max() / g.abs().max())
    assert rel < 0.02               # 1/127 quantisation grid


# ---------------------------------------------------------------------------
# the same numbers as repro
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_schedules_match_repro(schedule):
    oc = OPT.OptConfig(lr=3e-4, warmup=20, total_steps=200,
                       schedule=schedule)
    joc = JOPT.OptConfig(**dataclasses.asdict(oc))
    steps = np.arange(0, 230, dtype=np.int32)
    got = OPT.make_schedule(oc)(torch.from_numpy(steps)).numpy()
    want = np.asarray(JOPT.make_schedule(joc)(jnp.asarray(steps)))
    # cos of a vector: XLA's and PyTorch's differ by an ulp in places
    np.testing.assert_allclose(got, want, rtol=UPD_RTOL, atol=1e-6 * oc.lr)
    assert abs(float(OPT.make_schedule(oc)(37))
               - float(JOPT.make_schedule(joc)(37))) < 1e-10


def test_compression_matches_repro():
    """Codes and residuals bit for bit with ``repro``'s op-by-op path over
    two steps of error feedback (scales: real divisions by 127)."""
    rng = np.random.default_rng(1)
    shapes = {"a": (16, 8), "b": (32,), "c": (4, 4, 4)}
    tp = {k: torch.zeros(s) for k, s in shapes.items()}
    res, jres = C.init_residuals(tp), JC.init_residuals(
        {k: jnp.zeros(s) for k, s in shapes.items()})
    for _ in range(2):
        g = {k: (rng.normal(size=s) * 3).astype(np.float32)
             for k, s in shapes.items()}
        qs, ss, res = C.compress_grads({k: torch.from_numpy(v)
                                        for k, v in g.items()}, res)
        jqs, jss, jres = JC.compress_grads({k: jnp.asarray(v)
                                            for k, v in g.items()}, jres)
        for k in shapes:
            np.testing.assert_array_equal(qs[k].numpy(), np.asarray(jqs[k]))
            assert qs[k].dtype == torch.int8
            np.testing.assert_array_equal(ss[k].numpy(), np.asarray(jss[k]))
            np.testing.assert_array_equal(res[k].numpy(),
                                          np.asarray(jres[k]))
        deq, jdeq = C.decompress_grads(qs, ss), JC.decompress_grads(jqs, jss)
        for k in shapes:
            np.testing.assert_array_equal(deq[k].numpy(),
                                          np.asarray(jdeq[k]))


def small_cfg(get):
    return dataclasses.replace(get("colpali"), d_model=64, n_layers=2,
                               n_heads=4, d_ff=128, grid_h=8, grid_w=8,
                               query_vocab=128)


def test_default_labels_match_repro():
    """Exact component match: ``text_embed`` and ``special_embed`` are
    adamw; a component named ``emb``/``big`` makes a leaf rowwise."""
    cfg = small_cfg(jax_config)
    jlab = jax.tree.leaves(JOPT.default_labels(
        JLI.init_params(cfg, jax.random.PRNGKey(0))))
    model = LI.init_params(small_cfg(get_config), device="cpu")
    labels = OPT.default_labels(dict(model.named_parameters()))
    assert set(labels.values()) == set(jlab) == {"adamw"}
    tree = {"emb": {"big": jnp.ones((3, 2))}, "embed": jnp.ones(2),
            "items_x": jnp.ones(2), "small": [jnp.ones(2)]}
    want = jax.tree_util.tree_flatten_with_path(JOPT.default_labels(tree))[0]
    got = OPT.default_labels({"emb.big": 0, "embed": 0, "items_x": 0,
                              "small.0": 0})
    assert [lab for _, lab in want] == [got[n] for n in
                                        ("emb.big", "embed", "items_x",
                                         "small.0")]


def test_apply_updates_matches_repro():
    """A mixed adamw/rowwise tree over 5 steps with clipping active (the
    gradients' global norm is far above ``clip_norm``)."""
    rng = np.random.default_rng(2)
    init = {"dense.b": rng.normal(size=(4,)),
            "dense.w": rng.normal(size=(8, 4)),
            "emb.big": rng.normal(size=(20, 8))}
    init = {k: v.astype(np.float32) for k, v in init.items()}
    jp = {"dense": {"b": jnp.asarray(init["dense.b"]),
                    "w": jnp.asarray(init["dense.w"])},
          "emb": {"big": jnp.asarray(init["emb.big"])}}
    tp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    oc = OPT.OptConfig(lr=1e-2, warmup=2, total_steps=10, clip_norm=1.0)
    joc = JOPT.OptConfig(**dataclasses.asdict(oc))
    jlab = JOPT.default_labels(jp)
    labels = OPT.default_labels(tp)
    assert labels == {"dense.b": "adamw", "dense.w": "adamw",
                      "emb.big": "rowwise"}
    jst, st = JOPT.init_opt_state(jp, jlab), OPT.init_opt_state(tp, labels)
    for _ in range(5):
        g = {k: (rng.normal(size=v.shape) * 10).astype(np.float32)
             for k, v in init.items()}
        want_gn = float(OPT.global_norm(torch.from_numpy(x)
                                        for x in g.values()))
        assert want_gn > 10
        jg = {"dense": {"b": jnp.asarray(g["dense.b"]),
                        "w": jnp.asarray(g["dense.w"])},
              "emb": {"big": jnp.asarray(g["emb.big"])}}
        jp, jst = JOPT.apply_updates(jp, jg, jst, joc, labels=jlab)
        gn = OPT.apply_updates(tp, {k: torch.from_numpy(v)
                                    for k, v in g.items()},
                               st, oc, labels=labels)
        assert float(gn) == want_gn
    assert int(st["step"]) == int(jst["step"]) == 5
    flat = {"dense.b": jp["dense"]["b"], "dense.w": jp["dense"]["w"],
            "emb.big": jp["emb"]["big"]}
    pl = jst["per_leaf"]
    jstate = {"dense.b": pl["dense"]["b"], "dense.w": pl["dense"]["w"],
              "emb.big": pl["emb"]["big"]}
    for k in init:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(flat[k]),
                                   rtol=UPD_RTOL, atol=UPD_ATOL, err_msg=k)
        for s, v in st["per_leaf"][k].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jstate[k][s]),
                                       rtol=UPD_RTOL, atol=UPD_ATOL,
                                       err_msg=f"{k}/{s}")


# ---------------------------------------------------------------------------
# the train step on the encoder, and checkpoints across packages
# ---------------------------------------------------------------------------

OC = dict(lr=1e-3, warmup=2, total_steps=10)


def batches(n, cfg, seed=3, B=4, Q=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        qmask = np.ones((B, Q), bool)
        qmask[0, 6:] = False
        out.append({"patches": rng.normal(size=(B, cfg.n_patches,
                                                LI.D_PATCH))
                    .astype(np.float32),
                    "query_tokens": rng.integers(0, cfg.query_vocab, (B, Q))
                    .astype(np.int32),
                    "query_mask": qmask})
    return out


def jax_setup(cfg):
    params = JLI.init_params(cfg, jax.random.PRNGKey(0))
    labels = JOPT.default_labels(params)
    step = jax_train_step(lambda p, b: JLI.contrastive_loss(cfg, p, b, SHARD),
                          JOPT.OptConfig(**OC), labels=labels, donate=False)
    return params, JOPT.init_opt_state(params, labels), step


def port_setup(params=None):
    cfg = small_cfg(get_config)
    if params is None:
        model = LI.init_params(cfg, torch.Generator().manual_seed(9),
                               device="cpu")
    else:
        model = LI.params_from_jax(cfg, jax.tree.map(np.array, params),
                                   device="cpu")
    named = dict(model.named_parameters())
    labels = OPT.default_labels(named)
    step = make_train_step(lambda m, b: m.contrastive_loss(b),
                           OPT.OptConfig(**OC), labels=labels)
    return model, OPT.init_opt_state(named, labels), step


def as_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def check_metrics(m, jm, what):
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=STEP_RTOL, err_msg=f"{what} {k}")


def check_params(model, jparams, what):
    for name, got, want in zip(model.jax_leaf_names(),
                               model.to_jax_leaves(),
                               jax.tree.leaves(jparams)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=PARAM_ATOL, err_msg=f"{what} {name}")


def test_train_steps_match_repro():
    """3 eager steps of the port equal 3 jitted ``repro`` steps: loss,
    grad_norm and lr per step (rtol 1e-4), the params after (atol 1e-4:
    each step moves a weight by up to ~lr = 1e-3)."""
    cfg = small_cfg(jax_config)
    jp, jst, jstep = jax_setup(cfg)
    model, st, step = port_setup(jp)
    for i, b in enumerate(batches(3, cfg)):
        jp, jst, jm = jstep(jp, jst, as_jax(b))
        m = step(model, st, as_torch(b))
        check_metrics(m, jm, f"step {i + 1}")
    assert int(st["step"]) == 3
    check_params(model, jp, "after 3 steps")


def test_train_many_logs_every_step_with_a_callback():
    cfg = small_cfg(get_config)
    model, st, step = port_setup()
    seen = []
    log = train_many(step, model, st, [as_torch(b) for b in batches(3, cfg)],
                     log_every=10, callback=lambda i, m: seen.append(i))
    assert seen == [0, 1, 2] and [r["step"] for r in log] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in log)
    assert abs(log[-1]["lr"] - float(OPT.make_schedule(
        OPT.OptConfig(**OC))(3))) < 1e-12


def jax_state_names(tree) -> tuple:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return (["/".join(k.key for k in path) for path, _ in flat],
            [tuple(x.shape) for _, x in flat])


def test_train_state_leaves_follow_jax_tree_order():
    cfg = small_cfg(jax_config)
    jp, jst, _ = jax_setup(cfg)
    model, st, _ = port_setup(jp)
    names, shapes = jax_state_names({"p": jp, "o": jst})
    assert TS.leaf_names(model, st) == names
    assert [tuple(x.shape) for x in TS.leaves(model, st)] == shapes
    got = TS.leaves(model, st)
    assert got[names.index("o/step")].dtype == torch.int32


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    """2 steps in one package, checkpoint ``{"p", "o"}``, restore in the
    other: the restored state equals the saved one bit for bit, and step 3
    there equals step 3 in the writer."""
    cfg = small_cfg(jax_config)
    bs = batches(3, cfg, seed=4)
    jp, jst, jstep = jax_setup(cfg)
    model, st, step = port_setup(jp)
    if writer == "repro":
        for b in bs[:2]:
            jp, jst, _ = jstep(jp, jst, as_jax(b))
        JCKPT.save(str(tmp_path), 1, {"p": jp, "o": jst})
        fresh, fst, fstep = port_setup()
        meta = TS.restore(str(tmp_path), fresh, fst)
        assert meta["step"] == 1
        saved = jax.tree.leaves({"p": jp, "o": jst})
        for got, want in zip(TS.leaves(fresh, fst), saved):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        jp, jst, jm = jstep(jp, jst, as_jax(bs[2]))
        m = fstep(fresh, fst, as_torch(bs[2]))
        check_metrics(m, jm, "resumed step 3")
        check_params(fresh, jp, "resumed step 3")
        return
    for b in bs[:2]:
        step(model, st, as_torch(b))
    TS.save(str(tmp_path), 1, model, st)
    saved = [x.clone() for x in TS.leaves(model, st)]
    tmpl_p = JLI.init_params(cfg, jax.random.PRNGKey(1))
    tmpl = {"p": tmpl_p, "o": JOPT.init_opt_state(
        tmpl_p, JOPT.default_labels(tmpl_p))}
    restored, meta = JCKPT.restore(str(tmp_path), tmpl)
    assert meta["step"] == 1 and meta["leaf_names"] == TS.leaf_names(model,
                                                                      st)
    for got, want in zip(jax.tree.leaves(restored), saved):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())
    jp, jst, jm = jstep(restored["p"], restored["o"], as_jax(bs[2]))
    m = step(model, st, as_torch(bs[2]))
    check_metrics(m, jm, "resumed step 3")
    check_params(model, jp, "resumed step 3")


def test_restore_refuses_another_config(tmp_path):
    model, st, _ = port_setup()
    TS.save(str(tmp_path), 0, model, st)
    cfg = dataclasses.replace(small_cfg(get_config), d_ff=96)
    other = LI.init_params(cfg, device="cpu")
    ost = OPT.init_opt_state(dict(other.named_parameters()))
    with pytest.raises(ValueError, match="shape"):
        TS.restore(str(tmp_path), other, ost)


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------

def load_example():
    spec = importlib.util.spec_from_file_location(
        "train_retriever_torch", ROOT / "examples" / "train_retriever_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_trains_checkpoints_and_resumes(tmp_path, capsys):
    """``--small --device cpu``: 50 steps write checkpoint 49, and a second
    call with ``--steps 53`` resumes from LATEST and runs 3 more."""
    ex = load_example()
    argv = ["--small", "--batch", "4", "--device", "cpu", "--ckpt-dir",
            str(tmp_path)]
    first = ex.main(argv + ["--steps", "50"])
    out = capsys.readouterr().out
    assert "[init] colpali-style retriever" in out and "step   40 loss=" in out
    assert first["start"] == 0 and np.isfinite(first["last_loss"])
    assert (tmp_path / "LATEST").read_text() == "step_00000049"
    second = ex.main(argv + ["--steps", "53"])
    out = capsys.readouterr().out
    assert "[resume] step 50" in out and "final loss" in out
    assert second["start"] == 50 and second["steps_run"] == 3


def test_example_batches_are_repro_s():
    """``synth_batch`` is ``train_retriever.py``'s, value for value."""
    ex = load_example()
    spec = importlib.util.spec_from_file_location(
        "train_retriever", ROOT / "examples" / "train_retriever.py")
    jex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jex)
    for arch in ("colpali", "colqwen"):
        cfg = dataclasses.replace(get_config(arch), grid_h=4, grid_w=4,
                                  query_vocab=1024)
        jcfg = dataclasses.replace(jax_config(arch), grid_h=4, grid_w=4,
                                   query_vocab=1024)
        got = ex.synth_batch(np.random.default_rng(6), cfg, 3)
        want = jex.synth_batch(np.random.default_rng(6), jcfg, 3)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_example_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_example().main(["--small", "--steps", "1", "--ckpt-dir",
                             str(tmp_path)])
