"""EmbeddingBag: the port's ``embed_bag`` op (its CPU path: the plain
version ``embed_bag_ref``) against ``repro``'s ``embed_bag`` through its
jnp reference and its Pallas kernel in interpret mode, at the shapes
``tests/test_kernels.py`` uses; both modes, padding, an explicit ``valid``
mask, a bf16 table and out-of-range ids.

Tolerance: rtol=1e-5, atol=1e-5 (the kernel tests' own), f32 sums over L
in another order. On the CPU the op launches nothing, so no launch is
counted (``tests/test_torch_counters.py`` holds the count on a real
launch).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.embed_bag import embed_bag as jax_embed_bag
from repro_torch.kernels import dispatch as DSP
from repro_torch.kernels.embed_bag import embed_bag, embed_bag_ref

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(100, 16, 8, 4), (1000, 32, 16, 7), (50, 128, 3, 12)]


def _inputs(seed, V, d, B, L, lo=-1, hi=None):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, d)).astype(np.float32)
    idx = rng.integers(lo, V if hi is None else hi, size=(B, L)).astype(
        np.int32)
    return rng, table, idx


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **TOL)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("V,d,B,L", SHAPES)
def test_embed_bag_matches_repro(V, d, B, L, mode, impl):
    _, table, idx = _inputs(V + d, V, d, B, L)
    want = jax_embed_bag(jnp.asarray(table), jnp.asarray(idx), mode=mode,
                         impl=impl)
    got = embed_bag(torch.from_numpy(table), torch.from_numpy(idx),
                    mode=mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, d)
    _close(got, want)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_all_padding_is_zero(mode):
    _, table, _ = _inputs(1, 10, 8, 2, 3)
    idx = np.full((2, 3), -1, np.int32)
    got = embed_bag(torch.from_numpy(table), torch.from_numpy(idx),
                    mode=mode)
    want = jax_embed_bag(jnp.asarray(table), jnp.asarray(idx), mode=mode,
                         impl="pallas")
    _close(got, want)
    assert not got.any()


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_explicit_valid_mask(mode):
    """``valid`` replaces ``indices >= 0``: masked-out ids in range do not
    count, and a -1 that ``valid`` keeps reads row 0 (the clipped id)."""
    rng, table, idx = _inputs(2, 40, 16, 6, 5)
    valid = rng.random((6, 5)) > 0.3
    want = jax_embed_bag(jnp.asarray(table), jnp.asarray(idx),
                         jnp.asarray(valid), mode=mode, impl="ref")
    got = embed_bag(torch.from_numpy(table), torch.from_numpy(idx),
                    torch.from_numpy(valid), mode=mode)
    _close(got, want)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bf16_table(mode):
    _, table, idx = _inputs(3, 200, 32, 9, 6)
    jt = jnp.asarray(table, jnp.bfloat16)
    tt = torch.from_numpy(np.array(jt).view(np.uint16)).view(
        torch.bfloat16)
    assert np.array_equal(np.asarray(jt.astype(jnp.float32)),
                          tt.float().numpy())          # same table bits
    for impl in ("ref", "pallas"):
        want = jax_embed_bag(jt, jnp.asarray(idx), mode=mode, impl=impl)
        got = embed_bag(tt, torch.from_numpy(idx), mode=mode)
        assert got.dtype == torch.float32
        _close(got, want)


def test_out_of_range_ids_are_clipped():
    """Ids above V-1 read row V-1 (they are valid: >= 0); negative ids are
    padding unless ``valid`` says otherwise."""
    _, table, idx = _inputs(4, 30, 8, 5, 4, lo=-3, hi=60)
    want = jax_embed_bag(jnp.asarray(table), jnp.asarray(idx), impl="ref")
    got = embed_bag(torch.from_numpy(table), torch.from_numpy(idx))
    _close(got, want)
    t = torch.from_numpy(table)
    one = embed_bag(t, torch.tensor([[59, -2]]))
    _close(one, table[29][None])


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        embed_bag(torch.zeros((4, 8)),
                  torch.zeros((1, 2), dtype=torch.int64), mode="max")


@pytest.mark.parametrize("table,idx", [
    (torch.zeros((4, 8, 2)), torch.zeros((1, 2), dtype=torch.int64)),
    (torch.zeros((4, 8)), torch.zeros((2,), dtype=torch.int64))])
def test_malformed_shapes_raise(table, idx):
    with pytest.raises(ValueError, match=r"\[V, d\]"):
        embed_bag(table, idx)


def test_plain_version_is_take_then_weighted_sum():
    rng, table, idx = _inputs(5, 20, 8, 4, 3, lo=0)
    w = rng.random((4, 3)).astype(np.float32)
    got = embed_bag_ref(torch.from_numpy(table), torch.from_numpy(idx),
                        torch.from_numpy(w))
    _close(got, np.einsum("bl,bld->bd", w, table[idx]))


def test_criteo_vocabs_are_repro_s():
    """The port's copy of the Criteo-1TB cardinalities, which size the
    largest ``embed_bag`` table the card is checked at."""
    from repro.configs.base import CRITEO_TB_VOCABS as JV
    from repro_torch.configs import CRITEO_TB_VOCABS as TV
    assert TV == JV and max(TV) == 39_979_771


def test_cpu_call_counts_no_launch():
    DSP.reset_counts()
    _, table, idx = _inputs(6, 50, 16, 4, 3)
    embed_bag(torch.from_numpy(table), torch.from_numpy(idx))
    assert all(DSP.launch_count(k) == 0 for k in DSP.KERNELS)


def _non_finite_inputs(seed):
    """A table whose row 0 (where -1 padding points once clipped) holds
    inf, -inf and NaN, and whose row 7 holds inf; ids with -1 padding and
    a ``valid`` mask that masks out slots pointing at row 7."""
    rng, table, idx = _inputs(seed, 40, 16, 12, 6, lo=1)
    table[0, :3] = (np.inf, -np.inf, np.nan)
    table[7, 3] = np.inf
    idx[rng.random(idx.shape) < 0.25] = -1
    idx[::3, 2] = 7
    valid = idx >= 0
    valid[::3, 2] = False                  # masked-out slots on row 7
    valid[1, 1] = True                     # a kept -1: reads row 0 at w=1
    return table, idx, valid


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("with_valid", [False, True])
def test_non_finite_rows_under_zero_weight_slots(impl, mode, with_valid):
    """A zero-weight slot still adds 0 * row, as repro's kernel and
    reference do: inf or NaN in a row under padded or masked-out slots
    makes those bags' columns NaN in the same places; every other entry
    agrees at the usual tolerance. The plain version and the op agree."""
    table, idx, valid = _non_finite_inputs(9)
    vv = valid if with_valid else None
    want = np.asarray(jax_embed_bag(
        jnp.asarray(table), jnp.asarray(idx),
        None if vv is None else jnp.asarray(vv), mode=mode, impl=impl),
        np.float32)
    got = embed_bag(torch.from_numpy(table), torch.from_numpy(idx),
                    None if vv is None else torch.from_numpy(vv),
                    mode=mode).numpy()
    assert np.isnan(want).any() and not np.isnan(want).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)
    # the plain version on the op's weights and clipped ids
    w = torch.from_numpy((idx >= 0) if vv is None else vv).float()
    if mode == "mean":
        w = w / w.sum(-1, keepdim=True).clamp_min(1.0)
    ref = embed_bag_ref(torch.from_numpy(table),
                        torch.from_numpy(idx).clamp(0, 39), w).numpy()
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(want))
    np.testing.assert_allclose(ref, want, equal_nan=True, **TOL)
