"""The port's recsys family (``repro_torch.models.recsys``) against
``repro``'s on the CPU: ``take_rows``' wrap and NaN semantics, ``lookup``
over big and small tables, ``bag_lookup``, the four archs' forward passes,
losses and every gradient, ``serve_step``'s chunked and one-call paths,
``retrieval_step``'s 1- and 2-stage cascades, and weights across the two
packages. Inputs are numpy arrays drawn from a seed and given to both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.distributed.sharding import ShardingPolicy
from repro.models.recsys import embedding as JEMB
from repro.models.recsys import nets as JR
from repro_torch.configs import get_config
from repro_torch.models.recsys import embedding as EMB
from repro_torch.models.recsys import nets as R

torch.set_num_threads(1)

SHARD = ShardingPolicy(None)
CTR = ("dcn-v2", "autoint", "dlrm-mlperf")
# forward outputs, losses and serve/retrieval scores: float32 sums
# reordered between XLA and PyTorch
RTOL, ATOL = 1e-5, 1e-6
# gradients against jax.grad: a backward pass sums more terms (table rows
# shared by the batch, the cross and attention products)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


# ---------------------------------------------------------------------------
# configs and inputs
# ---------------------------------------------------------------------------

def reduced(get, arch, mixed=False):
    """``tests/test_archs.py``'s ``reduced_recsys`` sizes (every field 50
    rows; bert4rec 300 items, seq 12, d 16). ``mixed`` gives field 2
    120000 rows, so the ``big`` table exists and is the item field."""
    cfg = get(arch)
    if arch == "bert4rec":
        return dataclasses.replace(cfg, n_items=300, seq_len=12,
                                   embed_dim=16)
    vocab = [50] * len(cfg.vocab_sizes)
    if mixed:
        vocab[2] = 120_000
    over = dict(vocab_sizes=tuple(vocab))
    if arch == "dcn-v2":
        over["mlp"] = (64, 32)
    if arch == "dlrm-mlperf":
        over.update(bot_mlp=(32, 16, 8), top_mlp=(64, 32, 1), embed_dim=8)
    return dataclasses.replace(cfg, **over)


def both(arch, mixed=False, seed=0):
    """(port cfg, repro cfg, port model, repro params) from one JAX key:
    the port holds ``repro``'s weights bit for bit."""
    cfg, jcfg = reduced(get_config, arch, mixed), reduced(jax_config, arch,
                                                          mixed)
    jp = JR.init_params(jcfg, jax.random.PRNGKey(seed))
    model = R.params_from_jax(cfg, jax.tree.map(np.array, jp), device="cpu")
    return cfg, jcfg, model, jp


def ctr_batch(cfg, rng, B=16):
    """Ids per field (rows 0-3 repeated as rows 4-7, so the tables' rows
    are summed in the gradient), dense features, labels."""
    sparse = np.stack([rng.integers(0, v, B) for v in cfg.vocab_sizes], 1)
    sparse[4:8] = sparse[0:4]
    b = {"sparse": sparse.astype(np.int32),
         "labels": rng.integers(0, 2, B).astype(np.float32)}
    if cfg.n_dense:
        b["dense"] = rng.normal(size=(B, cfg.n_dense)).astype(np.float32)
    return b


def b4r_batch(cfg, rng, B=4, M=3, K=64):
    """Sequences with masked tails (row 0 full, row 3 one item), [MASK]
    ids in them, MLM positions with a masked-out slot, shared negatives."""
    S = cfg.seq_len
    seq = rng.integers(0, cfg.n_items, (B, S)).astype(np.int32)
    seq[:, 5] = cfg.n_items                                   # [MASK]
    lens = np.array([S, S - 4, 7, 1])[:B]
    mask = np.arange(S)[None] < lens[:, None]
    mlm_mask = np.ones((B, M), bool)
    mlm_mask[1, 2] = mlm_mask[3, 0] = False
    return {"seq": seq, "seq_mask": mask,
            "mlm_positions": rng.integers(0, S, (B, M)).astype(np.int32),
            "mlm_labels": rng.integers(0, cfg.n_items, (B, M)).astype(
                np.int32),
            "mlm_mask": mlm_mask,
            "neg_samples": rng.integers(0, cfg.n_items, K).astype(np.int32)}


def batch_for(cfg, rng):
    return b4r_batch(cfg, rng) if cfg.name == "bert4rec" else ctr_batch(
        cfg, rng)


def as_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_torch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# lookups
# ---------------------------------------------------------------------------

def test_take_rows_wraps_and_fills_as_jnp_take():
    """Ids in [-n, 0) wrap once, ids outside [-n, n) give NaN rows, as
    ``jnp.take`` gives them; no gradient reaches a table from a NaN row,
    and repeated ids sum theirs."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(5, 3)).astype(np.float32)
    ids = np.array([[0, 4, -1, -5], [5, -6, 2, 2]], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
    t = torch.from_numpy(table).requires_grad_()
    got = EMB.take_rows(t, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert np.isnan(want[1, :2]).all() and not np.isnan(want[0]).any()
    jg = jax.grad(lambda x: jnp.nansum(jnp.take(x, jnp.asarray(ids),
                                                axis=0)))(jnp.asarray(table))
    torch.nansum(got).backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
    assert t.grad[2].tolist() == [2.0] * 3


def test_lookup_big_and_small_tables_match_numpy_and_repro():
    """The one-device part of ``test_sharded_embedding_lookup_matches``:
    fields of 120000 and 200000 rows share ``big``, the 50-row field is
    ``small``; every field's rows equal the table rows at its offset."""
    rng = np.random.default_rng(1)
    layout = EMB.EmbeddingLayout((120_000, 50, 200_000), 8,
                                 row_shard_threshold=100_000)
    jlayout = JEMB.EmbeddingLayout((120_000, 50, 200_000), 8,
                                   row_shard_threshold=100_000)
    assert (layout.big_fields, layout.small_fields) == ((0, 2), (1,))
    for f in (layout.big_fields, layout.small_fields):
        o, t = layout.offsets(f)
        jo, jt = jlayout.offsets(f)
        np.testing.assert_array_equal(o, jo)
        assert t == jt
    assert layout.padded_rows(320_001, 4) == jlayout.padded_rows(320_001, 4)
    jp = JEMB.init_embedding(jlayout, jax.random.PRNGKey(0), n_shards=1)
    emb = EMB.init_embedding(layout, torch.Generator().manual_seed(0))
    with torch.no_grad():
        emb.big.copy_(torch.from_numpy(np.array(jp["big"])))
        emb.small.copy_(torch.from_numpy(np.array(jp["small"])))
    idx = np.stack([rng.integers(0, 120_000, 32), rng.integers(0, 50, 32),
                    rng.integers(0, 200_000, 32)], 1).astype(np.int32)
    with torch.no_grad():
        got = EMB.lookup(emb, torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        JEMB.lookup(jlayout, jp, jnp.asarray(idx))))
    big, small = np.asarray(jp["big"]), np.asarray(jp["small"])
    np.testing.assert_array_equal(got[:, 0], big[idx[:, 0]])
    np.testing.assert_array_equal(got[:, 1], small[idx[:, 1]])
    np.testing.assert_array_equal(got[:, 2], big[idx[:, 2] + 120_000])


@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("with_valid", [False, True])
def test_bag_lookup_matches_repro(mode, with_valid):
    rng = np.random.default_rng(2)
    table = rng.normal(size=(40, 8)).astype(np.float32)
    idx = rng.integers(-1, 45, (6, 5)).astype(np.int32)   # -1 and past the end
    idx[0] = -1                                           # an empty bag
    valid = rng.random((6, 5)) < 0.7 if with_valid else None
    want = JEMB.bag_lookup(jnp.asarray(table), jnp.asarray(idx),
                           None if valid is None else jnp.asarray(valid), mode)
    got = EMB.bag_lookup(torch.from_numpy(table), torch.from_numpy(idx),
                         None if valid is None else torch.from_numpy(valid),
                         mode)
    close(got, want, f"bag_lookup {mode}")


# ---------------------------------------------------------------------------
# forward, losses, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mixed", [False, True], ids=["small", "mixed"])
@pytest.mark.parametrize("arch", CTR)
def test_ctr_forward_matches_repro(arch, mixed):
    cfg, jcfg, model, jp = both(arch, mixed)
    b = ctr_batch(cfg, np.random.default_rng(3))
    want = JR.ctr_forward(jcfg, jp, as_jax(b), SHARD)
    with torch.no_grad():
        got = R.ctr_forward(cfg, model, as_torch(b))
    assert got.shape == (16,)
    close(got, want, f"{arch} logits")


def test_bert4rec_encode_and_query_match_repro():
    """Hidden states of every valid position, and the query vector at the
    last valid one, for sequences masked to 12, 8, 7 and 1 items."""
    cfg, jcfg, model, jp = both("bert4rec")
    b = b4r_batch(cfg, np.random.default_rng(4))
    seq, mask = jnp.asarray(b["seq"]), jnp.asarray(b["seq_mask"])
    want_h = np.asarray(JR.bert4rec_encode(jcfg, jp, seq, mask, SHARD))
    want_q = JR.bert4rec_query(jcfg, jp, seq, mask, SHARD)
    tb = as_torch(b)
    with torch.no_grad():
        got_h = R.bert4rec_encode(cfg, model, tb["seq"], tb["seq_mask"])
        got_q = R.bert4rec_query(cfg, model, tb["seq"], tb["seq_mask"])
    close(got_h.numpy()[b["seq_mask"]], want_h[b["seq_mask"]],
          "hidden states")
    close(got_q, want_q, "query vectors")


@pytest.mark.parametrize("arch", CTR + ("bert4rec",))
def test_loss_and_every_gradient_match_repro(arch):
    """Loss and the gradient of every leaf against ``jax.grad``, tables
    included (repeated ids in the batch sum their rows' gradients)."""
    cfg, jcfg, model, jp = both(arch, mixed=arch != "bert4rec")
    b = batch_for(cfg, np.random.default_rng(5))
    jloss, jgrads = jax.value_and_grad(
        lambda p: JR.loss_fn(jcfg, p, as_jax(b), SHARD))(jp)
    loss = R.loss_fn(cfg, model, as_torch(b))
    loss.backward()
    close(loss.item(), float(jloss), f"{arch} loss")
    names = model.jax_leaf_names()
    jleaves = jax.tree.leaves(jgrads)
    assert len(names) == len(jleaves)
    for name, want in zip(names, jleaves):
        got = model.jax_leaf_params(name)[0].grad
        close(got, want, f"{arch} grad {name}", GRAD_RTOL, GRAD_ATOL)


def test_bce_loss_matches_repro_at_large_logits():
    z = np.array([-80.0, -51.0, -3.0, 0.5, 52.0, 90.0], np.float32)
    y = np.array([0, 1, 1, 0, 0, 1], np.float32)
    jl, jg = jax.value_and_grad(JR.bce_loss)(jnp.asarray(z), jnp.asarray(y))
    t = torch.from_numpy(z).requires_grad_()
    loss = R.bce_loss(t, torch.from_numpy(y))
    loss.backward()
    assert np.isfinite(loss.item())
    close(loss.item(), float(jl), "bce loss")
    close(t.grad, jg, "bce grad")


def test_bert4rec_mlm_loss_with_masked_slots_matches_repro():
    """Masked-out MLM slots add nothing; an all-masked batch divides by 1."""
    cfg, jcfg, model, jp = both("bert4rec")
    b = b4r_batch(cfg, np.random.default_rng(6))
    for mlm_mask in (b["mlm_mask"], np.zeros_like(b["mlm_mask"])):
        bb = dict(b, mlm_mask=mlm_mask)
        want = JR.bert4rec_mlm_loss(jcfg, jp, as_jax(bb), SHARD)
        with torch.no_grad():
            got = R.bert4rec_mlm_loss(cfg, model, as_torch(bb))
        close(got.item(), float(want), "mlm loss")


# ---------------------------------------------------------------------------
# serving and candidate search
# ---------------------------------------------------------------------------

def serve_batch(cfg, rng, B):
    if cfg.name == "bert4rec":
        b = b4r_batch(cfg, rng, B=4)
        rep = -(-B // 4)
        return {"seq": np.tile(b["seq"], (rep, 1))[:B],
                "seq_mask": np.tile(b["seq_mask"], (rep, 1))[:B],
                "slate": rng.integers(0, cfg.n_items, (B, 7)).astype(
                    np.int32)}
    b = ctr_batch(cfg, rng, B)
    b.pop("labels")
    return b


@pytest.mark.parametrize("B", [16, 9], ids=["chunked", "one_call"])
@pytest.mark.parametrize("arch", ["dlrm-mlperf", "bert4rec"])
def test_serve_step_matches_repro(arch, B):
    """B = 2 x chunk runs chunk by chunk (``repro``'s ``lax.map``), B =
    chunk + 1 in one call; CTR probabilities and bert4rec slate scores."""
    cfg, jcfg, model, jp = both(arch)
    b = serve_batch(cfg, np.random.default_rng(7), B)
    want = JR.serve_step(jcfg, jp, as_jax(b), SHARD, chunk=8)
    got = R.serve_step(cfg, model, as_torch(b), chunk=8)
    assert tuple(got.shape) == tuple(want.shape)
    close(got, want, f"{arch} serve B={B}")
    if B == 16:            # the first chunk is a direct call on its rows
        first = R.serve_step(cfg, model, {k: v[:8] for k, v in
                                          as_torch(b).items()}, chunk=8)
        np.testing.assert_array_equal(got[:8].numpy(), first.numpy())


def jax_retrieval(jcfg, jp, b, **kw):
    """``repro``'s ``retrieval_step`` jitted, as its cells run it: eager,
    XLA scores two copies of a candidate up to 1 ulp apart (row-dependent
    blocking), jitted it scores them equal, as the port does."""
    return jax.jit(lambda p, bb: JR.retrieval_step(jcfg, p, bb, SHARD, **kw)
                   )(jp, as_jax(b))


def retrieval_batch(cfg, rng, N):
    if cfg.name == "bert4rec":
        b = b4r_batch(cfg, rng, B=4)
        b = {"seq": b["seq"][1:2], "seq_mask": b["seq_mask"][1:2]}
    else:
        b = ctr_batch(cfg, rng, 1)
        b.pop("labels")
    fld_rows = (cfg.n_items if cfg.name == "bert4rec"
                else cfg.vocab_sizes[R._item_field(cfg)])
    cand = rng.permutation(fld_rows)[:N - 40]
    # 40 duplicates: equal scores, kept in candidate order by top_k
    b["candidates"] = np.concatenate([cand, cand[:40]]).astype(np.int32)
    return b


@pytest.mark.parametrize("stages,proxy", [(1, False), (2, False), (2, True)],
                         ids=["1-stage", "2-stage", "2-stage-cand_proxy"])
@pytest.mark.parametrize("arch", CTR + ("bert4rec",))
def test_retrieval_step_matches_repro(arch, stages, proxy):
    """1- and 2-stage search over 300 candidates (40 of them duplicates),
    the 2-stage one with the item rows' prefixes or a ``cand_proxy`` table
    as its proxy: ids exactly ``repro``'s, scores within rtol 1e-5."""
    cfg, jcfg, model, jp = both(arch, mixed=arch != "bert4rec")
    rng = np.random.default_rng(8)
    b = retrieval_batch(cfg, rng, 300)
    if proxy:
        width = min(16, cfg.embed_dim)
        b["cand_proxy"] = rng.normal(size=(300, width)).astype(np.float32)
    kw = dict(stages=stages, prefetch_k=64, top_k=20)
    js, ji = jax_retrieval(jcfg, jp, b, **kw)
    s, i = R.retrieval_step(cfg, model, as_torch(b), **kw)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    close(s, js, f"{arch} {stages}-stage scores")


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("arch", ["autoint", "dlrm-mlperf"])
def test_candidates_scored_in_chunks_match_repro(monkeypatch, arch, stages):
    """The port scores candidates ``CAND_CHUNK`` at a time (``repro`` all at
    once): with chunks of 64, 300 candidates (4 full chunks and a ragged
    one) and a 2-stage rerank of 128 give ``repro``'s ids exactly."""
    monkeypatch.setattr(R, "CAND_CHUNK", 64)
    cfg, jcfg, model, jp = both(arch, mixed=True)
    b = retrieval_batch(cfg, np.random.default_rng(10), 300)
    kw = dict(stages=stages, prefetch_k=128, top_k=30)
    js, ji = jax_retrieval(jcfg, jp, b, **kw)
    s, i = R.retrieval_step(cfg, model, as_torch(b), **kw)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    close(s, js, f"{arch} {stages}-stage scores in chunks")


@pytest.mark.parametrize("arch", CTR + ("bert4rec",))
def test_two_stage_with_full_prefetch_equals_one_stage(arch):
    """``test_bert4rec_train_and_retrieval``'s check for every arch: with
    prefetch_k = N the 2-stage ids equal the exact 1-stage ids, in both
    packages."""
    cfg, jcfg, model, jp = both(arch, mixed=arch != "bert4rec")
    b = retrieval_batch(cfg, np.random.default_rng(9), 300)
    s1, i1 = R.retrieval_step(cfg, model, as_torch(b), stages=1, top_k=10)
    s2, i2 = R.retrieval_step(cfg, model, as_torch(b), stages=2,
                              prefetch_k=300, top_k=10)
    _, ji = jax_retrieval(jcfg, jp, b, stages=1, top_k=10)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(s1.numpy(), s2.numpy())


def test_item_field_is_the_largest_vocabulary():
    for arch in CTR:
        assert R._item_field(get_config(arch)) == JR._item_field(
            jax_config(arch))
    assert R._item_field(get_config("dcn-v2")) == 2
    assert R._item_field(get_config("dlrm-mlperf")) == 19
    capped = dataclasses.replace(get_config("dlrm-mlperf"), vocab_sizes=tuple(
        min(v, 4_194_304) for v in get_config("dlrm-mlperf").vocab_sizes))
    assert R._item_field(capped) == 0


# ---------------------------------------------------------------------------
# weights across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", CTR + ("bert4rec",))
def test_weights_round_trip_across_packages(arch):
    """``params_from_jax`` holds ``repro``'s tree bit for bit and
    ``to_jax_leaves`` gives it back in ``jax.tree.leaves`` order; a port
    init goes to a ``repro`` tree and back unchanged."""
    cfg, jcfg, model, jp = both(arch, mixed=arch != "bert4rec")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    names = ["/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                      for k in path) for path, _ in flat]
    assert model.jax_leaf_names() == names
    for got, (_, want) in zip(R.to_jax_leaves(model), flat):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fresh = R.init_params(cfg, torch.Generator().manual_seed(3),
                          device="cpu")
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jp),
        [x.numpy() for x in fresh.to_jax_leaves()])
    back = R.params_from_jax(cfg, tree, device="cpu")
    for a, b in zip(back.to_jax_leaves(), fresh.to_jax_leaves()):
        assert torch.equal(a, b)
    for p in model.named_parameters():
        assert p[1].dtype == torch.float32
    with pytest.raises(ValueError, match="shape"):
        R.params_from_jax(dataclasses.replace(cfg, embed_dim=4), tree,
                          device="cpu")
