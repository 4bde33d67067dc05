"""The full-length (non-ring) KV cache: ``kv_cache.cache_len``,
``init_cache`` and ``cache_specs`` with ``windowed=False``, and
``transformer.prefill_step(windowed_cache=False)``, for gemma3-4b reduced
(``tests/test_archs.py``'s sizes: 8-token windows in a 5:1 local:global
pattern) in float32.

A window layer over a full-length cache masks its keys by position, so
its decode logits are the ring cache's (rtol 1e-5, atol 1e-5). Against
``repro`` (``windowed_cache=False``): the caches and the prefill logits,
and every decode step while no key lies a window or more back. Past
that, ``repro``'s decode over a full-length cache attends to every
earlier position, which its own ring does not: a difference by design,
shown here with ``repro`` against itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kv_cache as JKV
from repro.models import transformer as JT
from repro_torch.models import kv_cache as KV
from repro_torch.models import transformer as T
from test_torch_lm import (SHARD, caches_close, close, logits_close, pair,
                           tokens_of)

torch.set_num_threads(1)

ARCH = "gemma3-4b"


def _jax_steps(jc):
    prefill = jax.jit(lambda p, t, b, w: JT.prefill_step(
        jc, p, {"tokens": t}, SHARD, windowed_cache=w, decode_budget=b),
        static_argnums=(2, 3))
    decode = jax.jit(lambda p, c, t, i: JT.decode_step(jc, p, c, t, i,
                                                       SHARD))
    return prefill, decode


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("window,seq", [(8, 5), (8, 30), (0, 30), (32, 30)])
def test_cache_len_and_specs_match_repro(windowed, window, seq):
    assert KV.cache_len(window, seq, windowed) == \
        JKV.cache_len(window, seq, windowed)
    jc, _, tc, _ = pair(ARCH)
    plan = T.segment_plan(tc)
    assert plan == JT.segment_plan(jc)
    got = KV.cache_specs(tc, plan, 2, seq, windowed=windowed)
    want = JKV.cache_specs(jc, plan, 2, seq, windowed=windowed)
    made = KV.init_cache(tc, plan, 2, seq, device="cpu", windowed=windowed)
    for gs, ws, ms in zip(got, want, made):
        for g, w, m in zip(gs, ws, ms):
            assert tuple(g["k"].shape) == tuple(w["k"].shape) \
                == tuple(m["k"].shape)
            assert g["k"].device.type == "meta"


def test_prefill_and_decode_within_the_window_match_repro():
    """Prefill of 4 tokens with a budget of 6: the window layers' caches
    hold 10 slots (the ring 8). Decode at positions 4-7, where every key
    lies inside the window: logits and caches equal ``repro``'s with
    ``windowed_cache=False``, and the logits equal the ring's."""
    jc, jp, tc, model = pair(ARCH)
    toks = tokens_of(np.random.default_rng(3), 2, 4)
    prefill, decode = _jax_steps(jc)
    lj, cj = prefill(jp, jnp.asarray(toks), 6, False)
    lt, ct = T.prefill_step(model, {"tokens": torch.from_numpy(toks)},
                            decode_budget=6, windowed_cache=False)
    lr, cr = T.prefill_step(model, {"tokens": torch.from_numpy(toks)},
                            decode_budget=6)
    assert ct[0][0]["k"].shape[2] == 10 and cr[0][0]["k"].shape[2] == 8
    logits_close("float32", lt, lj, jc.vocab_size, "prefill logits")
    caches_close(ct, cj, "prefill")
    close(lt, lr.numpy(), "prefill full vs ring")
    for pos in range(4, 8):
        nxt = np.array(jnp.argmax(lj[:, -1], -1)[:, None], np.int32)
        lj, cj = decode(jp, cj, jnp.asarray(nxt), jnp.int32(pos))
        lt, ct = T.decode_step(model, ct, torch.from_numpy(nxt), pos)
        lr, cr = T.decode_step(model, cr, torch.from_numpy(nxt), pos)
        logits_close("float32", lt, lj, jc.vocab_size, f"decode pos={pos}")
        caches_close(ct, cj, f"decode pos={pos}")
        close(lt, lr.numpy(), f"decode full vs ring pos={pos}")


@pytest.mark.parametrize("seq,budget", [(4, 10), (20, 6)])
def test_full_cache_decodes_as_the_ring(seq, budget):
    """Decode past the window (from 4 tokens, and after a prefill of 20
    that rolled the ring): the full-length cache masks keys a window or
    more back by position and gives the ring's logits, and the ring's
    are ``repro``'s."""
    jc, jp, tc, model = pair(ARCH)
    toks = tokens_of(np.random.default_rng(4), 2, seq)
    prefill, decode = _jax_steps(jc)
    lj, cj = prefill(jp, jnp.asarray(toks), budget, True)
    lt, ct = T.prefill_step(model, {"tokens": torch.from_numpy(toks)},
                            decode_budget=budget, windowed_cache=False)
    _, cr = T.prefill_step(model, {"tokens": torch.from_numpy(toks)},
                           decode_budget=budget)
    for pos in range(seq, seq + budget):
        nxt = np.array(jnp.argmax(lj[:, -1], -1)[:, None], np.int32)
        lj, cj = decode(jp, cj, jnp.asarray(nxt), jnp.int32(pos))
        lt, ct = T.decode_step(model, ct, torch.from_numpy(nxt), pos)
        lr, cr = T.decode_step(model, cr, torch.from_numpy(nxt), pos)
        close(lt, lr.numpy(), f"full vs ring pos={pos}")
        logits_close("float32", lr, lj, jc.vocab_size, f"ring pos={pos}")


def test_repro_full_cache_attends_past_the_window():
    """The difference by design: ``repro``'s full-length decode at a
    position a window or more past the first key differs from its own
    ring decode (the port's full-length decode does not)."""
    jc, jp, tc, model = pair(ARCH)
    toks = tokens_of(np.random.default_rng(5), 2, 12)
    prefill, decode = _jax_steps(jc)
    nxt = jnp.full((2, 1), 3, jnp.int32)
    _, c_full = prefill(jp, jnp.asarray(toks), 2, False)
    _, c_ring = prefill(jp, jnp.asarray(toks), 2, True)
    l_full, _ = decode(jp, c_full, nxt, jnp.int32(12))
    l_ring, _ = decode(jp, c_ring, nxt, jnp.int32(12))
    assert not np.allclose(np.asarray(l_full), np.asarray(l_ring),
                           rtol=1e-3, atol=1e-3)
    _, ct = T.prefill_step(model, {"tokens": torch.from_numpy(toks)},
                           decode_budget=2, windowed_cache=False)
    lt, _ = T.decode_step(model, ct, torch.from_numpy(np.array(nxt)), 12)
    logits_close("float32", lt, l_ring, jc.vocab_size, "port full vs ring")
