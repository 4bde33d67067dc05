"""The recsys family's training path against ``repro`` on the CPU:
``test_archs.py``'s ``test_recsys_train_step`` mirrored (5 steps of the
port's eager ``make_train_step`` against ``repro``'s jitted one from the
same weights, row-wise Adagrad on the tables and AdamW elsewhere), the
label maps, and ``{"params", "opt"}`` train states written by either
package and restored by the other bit for bit."""
import jax
import numpy as np
import pytest
import torch

from repro.training import checkpoint as JCKPT
from repro.training import optimizer as JOPT
from repro.training.train_loop import make_train_step as jax_train_step
from repro.models.recsys import nets as JR
from repro_torch.models.recsys import nets as R
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_state as TS
from repro_torch.training.train_loop import make_train_step
from test_torch_recsys import (CTR, SHARD, as_jax, as_torch, batch_for,
                               both)

torch.set_num_threads(1)

OC = dict(lr=1e-2, warmup=1, total_steps=20)    # test_recsys_train_step's
# five steps: XLA's fused jitted step against the eager PyTorch one, f32
STEP_RTOL, PARAM_ATOL = 1e-4, 1e-6
# each step's gradients (test_torch_recsys.py's limits against jax.grad)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# a parameter element whose gradient differs from repro's by more than this
# (relative) at some step is held to EXEMPT_LR x the summed learning rates
# instead (see test_train_steps_match_repro)
NOISE_REL, EXEMPT_LR = 1e-5, 1e-2


def setup(arch):
    cfg, jcfg, model, jp = both(arch, mixed=arch != "bert4rec")
    jlab = JOPT.default_labels(jp)
    jstep = jax_train_step(lambda p, b: JR.loss_fn(jcfg, p, b, SHARD),
                           JOPT.OptConfig(**OC), labels=jlab, donate=False)
    named = dict(model.named_parameters())
    labels = OPT.default_labels(named)
    step = make_train_step(lambda m, b: R.loss_fn(cfg, m, b),
                           OPT.OptConfig(**OC), labels=labels)
    return (cfg, model, OPT.init_opt_state(named, labels), step,
            jp, JOPT.init_opt_state(jp, jlab), jstep, jcfg)


@pytest.mark.parametrize("arch", CTR + ("bert4rec",))
def test_label_maps_match_repro(arch):
    """Leaf for leaf: the tables (``emb/big``, ``emb/small``, ``items``)
    are row-wise, every other leaf AdamW."""
    _, _, model, jp = both(arch, mixed=arch != "bert4rec")
    labels = OPT.default_labels(dict(model.named_parameters()))
    got = [labels[n.replace("/", ".")] for n in model.jax_leaf_names()]
    assert got == jax.tree.leaves(JOPT.default_labels(jp))
    rowwise = {n for n, lab in labels.items() if lab == "rowwise"}
    assert rowwise == ({"items"} if arch == "bert4rec"
                       else {"emb.big", "emb.small"})


@pytest.mark.parametrize("arch", CTR + ("bert4rec",))
def test_train_steps_match_repro(arch):
    """5 steps on one batch: loss, grad_norm and lr per step (rtol 1e-4),
    every gradient at every step (rtol 1e-4, atol 1e-6) and every
    parameter after each step (rtol 1e-4, atol 1e-6) against ``repro``'s;
    the loss falls (``test_recsys_train_step``'s check).

    One class of elements is held to a bound instead, as in
    ``test_torch_lm_train.py``: AdamW divides a gradient by its own size,
    so a relative gradient error becomes the same relative error of an
    lr-sized update, and ``m`` cancelling over steps of opposite sign
    magnifies it (a dcn-v2 ``cross/0/w`` element with a step-1 gradient of
    1.4e-8 moved 6.5e-5 apart at lr 1e-2; one whose gradients differed by
    7.9e-5 relative moved 1.08e-6 apart after 5 steps). An element whose
    gradient differs from ``repro``'s by more than ``NOISE_REL`` relative
    at some step must lie within ``EXEMPT_LR`` x the sum of the learning
    rates so far (the largest such move is 6.5e-3 x, at step 1). Every
    gradient is held at every step.
    """
    cfg, model, st, step, jp, jst, jstep, jcfg = setup(arch)
    b = batch_for(cfg, np.random.default_rng(11))
    jgrad = jax.jit(jax.grad(lambda p, bb: JR.loss_fn(jcfg, p, bb, SHARD)))
    names = model.jax_leaf_names()
    noisy = [np.zeros(x.shape, bool) for x in model.to_jax_leaves()]
    losses, lrs = [], []
    for i in range(5):
        jg = jax.tree.leaves(jgrad(jp, as_jax(b)))
        jp, jst, jm = jstep(jp, jst, as_jax(b))
        m = step(model, st, as_torch(b))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=STEP_RTOL,
                                       err_msg=f"step {i + 1} {key}")
        lrs.append(float(m["lr"]))
        for j, name in enumerate(names):
            want = np.asarray(jg[j])
            got = model.jax_leaf_params(name)[0].grad.numpy()
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL,
                                       err_msg=f"step {i + 1} grad {name}")
            noisy[j] |= np.abs(got - want) > NOISE_REL * np.abs(want)
        for name, mask, got, want in zip(names, noisy, model.to_jax_leaves(),
                                         jax.tree.leaves(jp)):
            got, want = got.numpy(), np.asarray(want)
            np.testing.assert_allclose(got[~mask], want[~mask],
                                       rtol=STEP_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"step {i + 1} {name}")
            assert (np.abs(got[mask] - want[mask])
                    <= EXEMPT_LR * sum(lrs)).all(), f"step {i + 1} {name}"
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("writer", ["repro", "port"])
@pytest.mark.parametrize("arch", ["dcn-v2", "bert4rec"])
def test_train_state_restores_across_packages(tmp_path, arch, writer):
    """2 steps in one package, the ``{"params", "opt"}`` train state saved,
    restored in the other: bit for bit (row-wise accumulators, moments,
    step, parameters), and step 3 there equals step 3 in the writer."""
    cfg, model, st, step, jp, jst, jstep, _ = setup(arch)
    rng = np.random.default_rng(12)
    bs = [batch_for(cfg, rng) for _ in range(3)]
    if writer == "repro":
        for b in bs[:2]:
            jp, jst, _ = jstep(jp, jst, as_jax(b))
        JCKPT.save(str(tmp_path), 1, {"params": jp, "opt": jst})
        fresh = R.init_params(cfg, torch.Generator().manual_seed(5),
                              device="cpu")
        fst = OPT.init_opt_state(dict(fresh.named_parameters()))
        meta = TS.restore(str(tmp_path), fresh, fst, TS.LM_KEYS)
        assert meta["step"] == 1
        for got, want in zip(TS.leaves(fresh, fst),
                             jax.tree.leaves({"params": jp, "opt": jst})):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        model, st = fresh, fst
    else:
        for b in bs[:2]:
            step(model, st, as_torch(b))
        TS.save(str(tmp_path), 1, model, st, keys=TS.LM_KEYS)
        saved = TS.leaves(model, st)
        restored, meta = JCKPT.restore(str(tmp_path),
                                       {"params": jp, "opt": jst})
        assert meta["leaf_names"] == TS.leaf_names(model, st, TS.LM_KEYS)
        assert "opt/per_leaf/emb/big/acc" in meta["leaf_names"] or (
            "opt/per_leaf/items/acc" in meta["leaf_names"])
        for got, want in zip(jax.tree.leaves(restored), saved):
            np.testing.assert_array_equal(np.asarray(got), want.numpy())
        jp, jst = restored["params"], restored["opt"]
    jp, jst, jm = jstep(jp, jst, as_jax(bs[2]))
    m = step(model, st, as_torch(bs[2]))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=STEP_RTOL)
    for name, got, want in zip(model.jax_leaf_names(), model.to_jax_leaves(),
                               jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=STEP_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"resumed step 3 {name}")
