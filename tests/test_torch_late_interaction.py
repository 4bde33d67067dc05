"""The port's ColX encoder against ``repro.models.late_interaction``: the
same numpy params (``params_from_jax``) and inputs through both packages
give the same page and query vectors, loss and gradients on the three
geometries (grid, tiles, dynamic + patch merger)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_config
from repro.distributed.sharding import ShardingPolicy
from repro.models import late_interaction as JLI
from repro_torch.configs import get_config
from repro_torch.models import late_interaction as LI

torch.set_num_threads(1)

ARCHS = ("colpali", "colsmol", "colqwen")
SHARD = ShardingPolicy(None)
B, Q = 4, 8
# forward values: f32 products reordered between XLA and PyTorch
RTOL, ATOL = 1e-5, 1e-6
# gradients: a backward pass through 2 blocks of softmax attention
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def small(get, arch):
    """``tests/test_archs.py``'s reduced retriever config."""
    return dataclasses.replace(get(arch), d_model=64, n_layers=2, n_heads=4,
                               d_ff=128, grid_h=8, grid_w=8, n_tiles=3,
                               tile_patches=16, max_rows=8, query_vocab=128)


def jax_params(cfg, seed=0):
    return JLI.init_params(cfg, jax.random.PRNGKey(seed))


def port_model(arch, params):
    return LI.params_from_jax(small(get_config, arch),
                              jax.tree.map(np.array, params), device="cpu")


def make_batch(cfg, seed=1, masked_rows=()):
    rng = np.random.default_rng(seed)
    n_raw = cfg.n_patches * (4 if cfg.geometry == "dynamic" else 1)
    qmask = np.ones((B, Q), bool)
    qmask[1, 5:] = False                 # a ragged query
    for r in masked_rows:
        qmask[r] = False
    return {"patches": rng.normal(size=(B, n_raw, LI.D_PATCH))
            .astype(np.float32),
            "query_tokens": rng.integers(0, cfg.query_vocab, (B, Q))
            .astype(np.int32),
            "query_mask": qmask}


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_encode_and_loss_match_repro(arch):
    cfg = small(jax_config, arch)
    params = jax_params(cfg)
    model = port_model(arch, params)
    batch = make_batch(cfg)
    jb, tb = as_jax(batch), as_torch(batch)
    with torch.no_grad():
        vecs, types = model.encode_pages(tb["patches"])
        qv = model.encode_queries(tb["query_tokens"], tb["query_mask"])
        loss = model.contrastive_loss(tb)
    jv, jt = JLI.encode_pages(cfg, params, jb["patches"], SHARD)
    assert tuple(vecs.shape) == (B, cfg.seq_len, cfg.out_dim)
    np.testing.assert_array_equal(types.numpy(), np.asarray(jt))
    close(vecs, jv, what="page vectors")
    close(qv, JLI.encode_queries(cfg, params, jb["query_tokens"],
                                 jb["query_mask"], SHARD),
          what="query vectors")
    assert float(qv[1, 5:].abs().max()) == 0.0      # masked tokens zeroed
    close(loss, JLI.contrastive_loss(cfg, params, jb, SHARD), what="loss")


def grad_leaves(model) -> list:
    """The port's gradients as ``repro``'s leaves (blocks stacked)."""
    return [torch.stack([p.grad for p in model.jax_leaf_params(n)])
            if n.startswith("blocks/") else model.jax_leaf_params(n)[0].grad
            for n in model.jax_leaf_names()]


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch):
    cfg = small(jax_config, arch)
    params = jax_params(cfg)
    model = port_model(arch, params)
    batch = make_batch(cfg, seed=2)
    model.contrastive_loss(as_torch(batch)).backward()
    jg = jax.grad(lambda p: JLI.contrastive_loss(cfg, p, as_jax(batch),
                                                 SHARD))(params)
    names = model.jax_leaf_names()
    want = jax.tree.leaves(jg)
    assert len(names) == len(want)
    for name, g, w in zip(names, grad_leaves(model), want):
        assert bool(torch.isfinite(g).all()), name
        close(g, w, GRAD_RTOL, GRAD_ATOL, what=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_leaves_round_trip_in_jax_order(arch):
    cfg = small(jax_config, arch)
    params = jax_params(cfg, seed=3)
    model = port_model(arch, params)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    names = ["/".join(k.key for k in path) for path, _ in flat]
    assert model.jax_leaf_names() == names
    for got, (_, want) in zip(model.to_jax_leaves(), flat):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bad = [np.array(x) for _, x in flat]
    bad[-1] = bad[-1][:, :-1]
    with pytest.raises(ValueError, match="text_embed: shape"):
        model.load_jax_leaves(bad)


def test_random_init_scales_and_seed():
    """``repro``'s init scales (``shape[0] ** -0.5``, pos_embed 0.02, norms
    and biases zero); one generator seed gives one model."""
    cfg = small(get_config, "colqwen")
    a = LI.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = LI.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    std = float(a.blocks[0].w1.detach().std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert abs(float(a.pos_embed.detach().std()) - 0.02) < 0.002
    for p in (a.ln_f, a.blocks[1].ln2, a.blocks[0].b1, a.merger.b):
        assert float(p.abs().max()) == 0.0


def test_gelu_is_the_tanh_approximation():
    """``jax.nn.gelu`` defaults to the tanh form; the exact erf form, which
    ``F.gelu`` gives by default, is 1e-4 off in places and fails here."""
    x = np.linspace(-5, 5, 2001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = LI._gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    erf = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


def test_norm_matches_repro():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(3, 5, 64)) * 3 + 1).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    close(LI._norm(torch.from_numpy(x), torch.from_numpy(w)),
          JLI._norm(jnp.asarray(x), jnp.asarray(w)))


def test_fully_masked_query_row_stays_finite():
    """A query whose every token is masked attends uniformly (keys at
    -1e30, not -inf) and comes out as zeros; the loss and its gradients
    stay finite, and equal ``repro``'s."""
    cfg = small(jax_config, "colpali")
    params = jax_params(cfg)
    model = port_model("colpali", params)
    batch = make_batch(cfg, seed=5, masked_rows=(2,))
    tb, jb = as_torch(batch), as_jax(batch)
    x = F.embedding(tb["query_tokens"].long(), model.text_embed)
    h = model._backbone(x, tb["query_mask"])
    assert bool(torch.isfinite(h).all())
    qv = model.encode_queries(tb["query_tokens"], tb["query_mask"])
    assert bool(torch.isfinite(qv).all()) and float(qv[2].abs().max()) == 0
    loss = model.contrastive_loss(tb)
    loss.backward()
    assert np.isfinite(float(loss))
    assert all(bool(torch.isfinite(p.grad).all())
               for p in model.parameters())
    close(loss, JLI.contrastive_loss(cfg, params, jb, SHARD))


def test_training_path_recomputes_each_block():
    """Under autograd each block runs inside ``torch.utils.checkpoint`` (the
    forward runs again in the backward pass); under ``no_grad`` once."""
    cfg = small(get_config, "colpali")
    model = LI.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    calls = []
    model.blocks[0].register_forward_pre_hook(lambda *a: calls.append(1))
    batch = as_torch(make_batch(cfg))
    with torch.no_grad():
        model.encode_queries(batch["query_tokens"], batch["query_mask"])
    assert len(calls) == 1
    calls.clear()
    model.encode_queries(batch["query_tokens"],
                         batch["query_mask"]).sum().backward()
    assert len(calls) == 2


def test_encoder_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LI.ColXEncoder(small(get_config, "colpali"))
