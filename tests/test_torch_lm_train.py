"""The port's LM training path against ``repro``: the configs, three train
steps from the same weights, the ``{"params", "opt"}`` train-state tree,
and the launcher (``launch/train.py``), whose checkpoints resume across
the two packages in both directions."""
import contextlib
import dataclasses
import io
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.configs import get_config as jax_config
from repro.distributed.sharding import ShardingPolicy
from repro.launch import train as JTR
from repro.models import transformer as JT
from repro.training import optimizer as JOPT
from repro.training.train_loop import make_train_step as jax_train_step
from repro_torch.configs import LM_ARCHS, LM_SHAPES, get_config
from repro_torch.configs import base as B
from repro_torch.launch import train as TR
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_state as TS
from repro_torch.training.train_loop import make_train_step

torch.set_num_threads(1)

SHARD = ShardingPolicy(None)
# three steps: XLA's fused jitted step against eager PyTorch, f32
STEP_RTOL, PARAM_ATOL = 1e-4, 1e-6
# each step's gradients (test_torch_lm.py's limits against jax.grad)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# a reference gradient below this is within the float32 noise of the sums
# that make it (~5e-8 here; see test_train_steps_match_repro)
NOISE_FLOOR = 1e-7
# launcher losses, printed to 4 decimals by both packages
LAUNCH_RTOL = 1e-4


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_match_repro(arch):
    got, want = get_config(arch), jax_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.family == want.family == "lm"
    assert got.n_params() == want.n_params()
    assert got.n_active_params() == want.n_active_params()
    assert [got.window_for_layer(i) for i in range(got.n_layers)] == [
        want.window_for_layer(i) for i in range(want.n_layers)]
    red = TR.reduced_lm(got)
    assert dataclasses.asdict(red) == dataclasses.asdict(
        JTR.reduced_lm(want))
    assert red.n_params() == JTR.reduced_lm(want).n_params()


def test_config_classes_match_repro():
    for cls, jcls in ((B.LMConfig, JB.LMConfig), (B.MoESpec, JB.MoESpec),
                      (B.ShapeSpec, JB.ShapeSpec)):
        assert [(f.name, f.default) for f in dataclasses.fields(cls)] == [
            (f.name, f.default) for f in dataclasses.fields(jcls)]
    assert [(s.name, s.kind, s.dims, s.seq_len) for s in LM_SHAPES] == [
        (s.name, s.kind, s.dims, s.seq_len) for s in JB.LM_SHAPES]
    # head_dim 0 -> d_model // n_heads, and the GQA check
    kw = dict(name="x", n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
              d_ff=8, vocab_size=10)
    assert B.LMConfig(**kw).head_dim == JB.LMConfig(**kw).head_dim == 16
    with pytest.raises(AssertionError):
        B.LMConfig(**dict(kw, n_kv_heads=4))


# ---------------------------------------------------------------------------
# train steps from the same weights
# ---------------------------------------------------------------------------

def launcher_cfgs(arch):
    return (TR.reduced_lm(get_config(arch)),
            JTR.reduced_lm(jax_config(arch)))


def opt_config(arch, steps=10):
    return dict(lr=3e-4, schedule="wsd" if "minicpm" in arch else "cosine",
                warmup=10, total_steps=steps)


def batch_np(cfg, step, B=2, S=16, seed=0):
    b = TR.make_batch(cfg, seed, step, B, S, "cpu")
    return {k: v.numpy() for k, v in b.items()}


def test_default_labels_match_repro():
    """Every LM leaf is adamw in both packages: ``embed`` is not the
    rowwise component ``emb``."""
    cfg, jcfg = launcher_cfgs("granite-moe-1b-a400m")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = T.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    labels = OPT.default_labels(dict(model.named_parameters()))
    assert set(jax.tree.leaves(JOPT.default_labels(jp))) == {"adamw"}
    assert set(labels.values()) == {"adamw"} and labels["embed"] == "adamw"


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_steps_match_repro(arch):
    """3 eager steps of the port equal 3 jitted ``repro`` steps from the
    same weights on the launcher's batches: loss, grad_norm and lr per
    step (rtol 1e-4), every gradient at every step (rtol 1e-4, atol
    1e-6), and every parameter after (rtol 1e-4, atol 1e-6).

    One class of parameter elements is held to a bound instead: where
    ``repro``'s gradient of an element is below ``NOISE_FLOOR`` at some
    step, the two gradients differ by float32 noise of the gradient's own
    size, and AdamW divides by that size, so the two updates may differ by
    up to a learning rate a step (one gemma3 w1 element with a step-1
    gradient of -1.04e-8 moved 1.84e-6 apart). Such elements must lie
    within 2 x the sum of the three learning rates. An element with a
    gradient above the floor is never exempt, and its gradient is held at
    every step."""
    cfg, jcfg = launcher_cfgs(arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jlab = JOPT.default_labels(jp)
    jst = JOPT.init_opt_state(jp, jlab)
    jloss = lambda p, b: JT.loss_fn(jcfg, p, b, SHARD)   # noqa: E731
    jstep = jax_train_step(jloss, JOPT.OptConfig(**opt_config(arch)),
                           labels=jlab, donate=False)
    jgrad = jax.jit(jax.grad(jloss))
    model = T.params_from_jax(cfg, jax.tree.map(np.array, jp), device="cpu")
    named = dict(model.named_parameters())
    labels = OPT.default_labels(named)
    st = OPT.init_opt_state(named, labels)
    step = make_train_step(T.loss_fn, OPT.OptConfig(**opt_config(arch)),
                           labels=labels)
    names = model.jax_leaf_names()
    noisy = [np.zeros(x.shape, bool) for x in model.to_jax_leaves()]
    lrs = []
    for i in range(3):
        b = batch_np(cfg, i)
        bj = {k: jnp.asarray(v) for k, v in b.items()}
        jg = jax.tree.leaves(jgrad(jp, bj))
        jp, jst, jm = jstep(jp, jst, bj)
        m = step(model, st, {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=STEP_RTOL,
                                       err_msg=f"step {i + 1} {key}")
        lrs.append(float(m["lr"]))
        for j, name in enumerate(names):
            g = torch.stack([p.grad for p in model.jax_leaf_params(name)])
            g = g.reshape(noisy[j].shape).numpy()
            want = np.asarray(jg[j])
            np.testing.assert_allclose(g, want, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL,
                                       err_msg=f"step {i + 1} grad {name}")
            noisy[j] |= np.abs(want) < NOISE_FLOOR
    for name, mask, got, want in zip(names, noisy, model.to_jax_leaves(),
                                     jax.tree.leaves(jp)):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got[~mask], want[~mask], rtol=STEP_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)
        assert (np.abs(got[mask] - want[mask]) <= 2 * sum(lrs)).all(), name


def test_train_state_leaves_follow_jax_tree_order():
    cfg, jcfg = launcher_cfgs("gemma3-4b")
    cfg = dataclasses.replace(cfg, n_layers=8)
    jcfg = dataclasses.replace(jcfg, n_layers=8)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tree = {"params": jp, "opt": JOPT.init_opt_state(
        jp, JOPT.default_labels(jp))}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    names = ["/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                      for k in path) for path, _ in flat]
    model = T.params_from_jax(cfg, jax.tree.map(np.array, jp), device="cpu")
    st = OPT.init_opt_state(dict(model.named_parameters()))
    assert TS.leaf_names(model, st, TS.LM_KEYS) == names
    assert names[0] == "opt/per_leaf/embed/m"
    assert "params/segments/1/1/ffn/w3" in names
    got = TS.leaves(model, st)
    assert [tuple(x.shape) for x in got] == [tuple(x.shape) for _, x in flat]
    assert got[names.index("opt/step")].dtype == torch.int32
    with pytest.raises(ValueError, match="sort before"):
        TS.leaf_names(model, st, ("a", "opt"))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

STEP_LINE = re.compile(r"step +(\d+) loss=([0-9.]+) lr=([0-9.e+-]+)")


def run_repro(argv) -> str:
    old = sys.argv
    sys.argv = ["train"] + argv
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            JTR.main()
    finally:
        sys.argv = old
    return buf.getvalue()


def run_port(argv) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        log = TR.main(argv + ["--device", "cpu"])
    return buf.getvalue(), log


def printed(out: str) -> dict:
    return {int(s): (float(l), float(r)) for s, l, r in STEP_LINE.findall(out)}


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_launcher_checkpoints_resume_across_packages(tmp_path, writer):
    """21 steps with one checkpoint after step 10 (``--ckpt-every 11``) in
    one package; the other package relaunched on the same directory with
    the same flags resumes from step 10, and its printed losses at steps
    15 and 20 follow the writer's uninterrupted run."""
    argv = ["--arch", "minicpm-2b", "--reduced", "--steps", "21", "--batch",
            "2", "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every",
            "11"]
    if writer == "repro":
        first = run_repro(argv)
        out, log = run_port(argv)
        assert [r["step"] for r in log] == list(range(11, 21))
    else:
        first, log = run_port(argv)
        assert [r["step"] for r in log] == list(range(21))
        out = run_repro(argv)
    assert "[resume] from step 10" in out
    want, got = printed(first), printed(out)
    # every 5th step is printed, and any step the watchdog flags
    assert {0, 5, 10, 15, 20} <= set(want) and {15, 20} <= set(got)
    assert min(got) > 10
    for s in (15, 20):
        np.testing.assert_allclose(got[s][0], want[s][0], rtol=LAUNCH_RTOL,
                                   err_msg=f"step {s} loss")
        assert got[s][1] == want[s][1], f"step {s} lr"


def test_launcher_resumes_its_own_run(tmp_path):
    """The port resumed from its checkpoint continues its own run: every
    metric of steps 11-20 equals the uninterrupted run's."""
    argv = ["--arch", "gemma3-4b", "--reduced", "--steps", "21", "--batch",
            "2", "--seq", "24", "--ckpt-dir", str(tmp_path / "a"),
            "--ckpt-every", "11"]
    _, whole = run_port(argv)
    out, resumed = run_port(argv)
    assert "[resume] from step 10" in out
    for a, b in zip(resumed, whole[11:], strict=True):
        assert a["step"] == b["step"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
        assert a["lr"] == b["lr"]


def test_launcher_batches_match_repro():
    cfg = TR.reduced_lm(get_config("minicpm-2b"))
    from repro.training.elastic import deterministic_batch_seed
    rng = np.random.default_rng(deterministic_batch_seed(3, 7, 0))
    tokens = np.asarray(jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 9)),
                                    jnp.int32))
    b = TR.make_batch(cfg, 3, 7, 2, 9, "cpu")
    np.testing.assert_array_equal(b["tokens"].numpy(), tokens)
    np.testing.assert_array_equal(b["labels"].numpy(),
                                  np.roll(tokens, -1, axis=1))
    assert b["tokens"].dtype == torch.int32


def test_launcher_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.main(["--reduced", "--steps", "1"])
    with pytest.raises(ValueError, match="LM family"):
        TR.build("colpali", 1, device="cpu")
