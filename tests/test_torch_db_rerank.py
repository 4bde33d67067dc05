"""The double-buffered scan's tensor route and the tensor-route rerank, on
the CPU.

Both CUDA kernels run only on the card (``csrc/maxsim_scan_db.cu``
launches the scan's ``wg::scan_wgmma_kernel``; ``csrc/maxsim_rerank.cu``
has its own wgmma kernel). What they compute and what they are given are
held here:

- the db scan's arithmetic on the tensor route is the scan's: ``split_ref``
  of ``tests/test_torch_split_scan.py`` (exact bf16 products of the
  documents with q_hi and q_lo, f32 sums, the int8 scale after the
  product, NEG/2 floor per valid token) against ``repro``'s
  ``maxsim_pallas_db`` in interpret mode, bf16 and int8, ragged N and D,
  dead ``doc_valid`` slots, a fully masked document and a broadcast mask;
- ``split_rerank_ref`` below is the rerank kernel's arithmetic (the same
  products, no floor, the valid tokens summed in passes of 16), held
  against ``repro``'s ``maxsim_rerank_pallas`` in interpret mode: bf16 and
  int8, a fully masked candidate (Qv * NEG), clipped rows, a broadcast
  mask, the Matryoshka prefix and a query of more than one pass;
- through a stand-in library: both wrappers ask the scan library for the
  route (``maxsim_scan_route``, the rule's one statement), the tensor
  route gets the packed operand (and, for the db scan, the token cap)
  unchanged, and misaligned documents, another batch's operand and a
  query above the cap are refused before any launch.

Tolerance: rtol=1e-5, atol=1e-4 on scores of unit-vector tokens, the
scan's (the split query carries f32 to within 2^-16 relative).
"""
import contextlib
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import maxsim as JK
from repro.kernels.maxsim import ops as JOPS
from repro_torch.kernels import build
from repro_torch.kernels import dispatch as DSP
from repro_torch.kernels.maxsim import ops as KOPS
from repro_torch.kernels.maxsim.ref import NEG
from test_torch_split_scan import _Recorder, split_ref

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)


def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _inputs(seed, kind, B=5, Q=12, N=23, D=37, d=32):
    """numpy query, mask and document mask; the documents as the JAX
    array of ``kind`` (int8: codes of unit vectors, with their scales)
    and as the same values in torch."""
    rng = np.random.default_rng(seed)
    q = _unit(rng, (B, Q, d))
    qm = (rng.random((B, Q)) > 0.3).astype(np.float32)
    qm[1] = 0.0                                   # a query with no token
    x = _unit(rng, (N, D, d))
    dm = rng.random((N, D)) > 0.1
    dm[2] = False                                 # a fully masked document
    if kind == "int8":
        jd, js = JK.quantize_int8(jnp.asarray(x))
        td = torch.from_numpy(np.array(jd))
        ts = torch.from_numpy(np.array(js, np.float32))
    else:
        jd, js = jnp.asarray(x, jnp.bfloat16), None
        td = torch.from_numpy(np.array(jd.astype(jnp.float32))).to(
            torch.bfloat16)
        ts = None
    return rng, q, qm, dm, (jd, js), (td, ts)


def _close(got, want):
    got = torch.as_tensor(np.array(got, np.float32))
    want = torch.as_tensor(np.array(want, np.float32))
    sent = want <= -1e20
    assert torch.equal(got <= -1e20, sent)
    torch.testing.assert_close(got[~sent], want[~sent], **TOL)
    # sentinel sums (Qv * NEG, Qv * NEG/2) agree in the leading digits
    torch.testing.assert_close(got[sent], want[sent], rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# the db scan's tensor route: the scan's split arithmetic vs maxsim_pallas_db
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("N,D", [(23, 37), (17, 70)])
@pytest.mark.parametrize("mask", ["full", "broadcast"])
def test_db_tensor_route_arithmetic_matches_pallas_db(kind, N, D, mask):
    rng, q, qm, dm, (jd, js), (td, ts) = _inputs(N + D, kind, N=N, D=D)
    if mask == "broadcast":
        dm = dm[:1] | True
        dm[0, :5] = False
    valid = rng.random(N) > 0.2
    op = KOPS.scan_query_operand(torch.from_numpy(q), torch.from_numpy(qm))
    got = split_ref(op, td, torch.from_numpy(dm), ts)
    got = got.masked_fill(~torch.from_numpy(valid)[None, :], NEG)
    jdm = np.broadcast_to(dm, (N, D)).astype(np.float32)
    want = JOPS.maxsim_scores_pipelined(
        jnp.asarray(q), jd, jnp.asarray(qm), jnp.asarray(jdm), js,
        jnp.asarray(valid), chunk=8, interpret=True)
    _close(got, want)
    assert bool((got[1][torch.from_numpy(valid)] == 0).all())   # no token
    # the port's chunked scan (its plain version on the CPU) agrees
    _close(KOPS.maxsim_scores_chunked(
        torch.from_numpy(q), td, torch.from_numpy(qm), torch.from_numpy(dm),
        torch.from_numpy(valid), chunk=8, scales=ts), want)


# ---------------------------------------------------------------------------
# the rerank's tensor route: its split arithmetic vs maxsim_rerank_pallas
# ---------------------------------------------------------------------------

def split_rerank_ref(operand: tuple, docs: torch.Tensor, rows: torch.Tensor,
                     doc_mask: torch.Tensor | None = None,
                     scales: torch.Tensor | None = None) -> torch.Tensor:
    """The tensor-route rerank's arithmetic in plain PyTorch: [B, L]
    scores from a ``scan_query_operand`` and bf16 documents or int8 codes
    at in-range ``rows``. Each similarity is docs . q_hi + docs . q_lo
    (exact bf16 products, f32 sums), times the int8 row scale after the
    product; masked rows score NEG; no floor, so a fully masked candidate
    sums Qv NEG maxima. The valid tokens are summed in passes of 16, as
    the kernel takes them."""
    qpack, qstart, qcount = operand
    hi, lo = qpack[:, 0].float(), qpack[:, 1].float()
    B, L = rows.shape
    out = torch.zeros((B, L), dtype=torch.float32)
    for b in range(B):
        s0, c = int(qstart[b]), int(qcount[b])
        ids = rows[b].long()
        cand = docs[ids].float()                            # [L, D, d]
        sim = (torch.einsum("ljd,td->ltj", cand, hi[s0:s0 + c])
               + torch.einsum("ljd,td->ltj", cand, lo[s0:s0 + c]))
        if scales is not None:
            sim = sim * scales[ids].float()[:, None, :]
        if doc_mask is not None:
            dm = doc_mask if doc_mask.shape[0] == 1 else doc_mask[ids]
            sim.masked_fill_(~(dm > 0)[:, None, :], NEG)
        best = sim.amax(dim=-1)                             # [L, c]
        for p in range(0, c, 16):
            out[b] += best[:, p:p + 16].sum(dim=-1)
    return out


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("mask", ["full", "broadcast", "none"])
@pytest.mark.parametrize("Q,prefix", [(12, 0), (40, 0), (12, 32)])
def test_rerank_tensor_route_arithmetic_matches_pallas(kind, mask, Q,
                                                       prefix):
    """Candidate 0 of every query is the fully masked document 2 (Qv *
    NEG where the mask is full); rows hold -1 and N + 3, which both
    packages clip. Q = 40 takes three passes of 16 tokens; prefix 32
    stores 32-dim documents under a 64-dim query (the Matryoshka case:
    the query's first 32 dims score)."""
    N, D = 19, 37
    rng, q, qm, dm, (jd, js), (td, ts) = _inputs(
        Q + prefix, kind, Q=Q, N=N, D=D, d=64 if prefix else 32)
    if prefix:
        x = _unit(rng, (N, D, prefix))
        if kind == "int8":
            jd, js = JK.quantize_int8(jnp.asarray(x))
            td = torch.from_numpy(np.array(jd))
            ts = torch.from_numpy(np.array(js, np.float32))
        else:
            jd = jnp.asarray(x, jnp.bfloat16)
            td = torch.from_numpy(np.array(jd.astype(jnp.float32))).to(
                torch.bfloat16)
    if mask == "broadcast":
        dm = dm[:1] | True
        dm[0, 3:7] = False
    rows = rng.integers(0, N, size=(q.shape[0], 9)).astype(np.int32)
    rows[:, 0] = 2
    rows[0, 3], rows[2, 4] = -1, N + 3
    jdm = None if mask == "none" else jnp.asarray(dm, jnp.float32)
    want = JOPS.maxsim_rerank(
        jnp.asarray(q), jd, jnp.asarray(rows), jnp.asarray(qm), jdm, js,
        impl="pallas", block_d=D, interpret=True)
    tq = torch.from_numpy(q)[..., :prefix] if prefix else torch.from_numpy(q)
    op = KOPS.scan_query_operand(tq.contiguous(), torch.from_numpy(qm))
    trows = torch.from_numpy(rows).clamp(0, N - 1)
    got = split_rerank_ref(op, td, trows,
                           None if mask == "none" else torch.from_numpy(dm),
                           ts)
    _close(got, want)
    qv = torch.from_numpy(qm).sum(-1)
    if mask == "full":
        torch.testing.assert_close(got[:, 0], qv * NEG, rtol=1e-6, atol=0)
    assert bool((got[1] == 0).all())                 # a query with no token
    # the port's rerank (its plain version on the CPU) agrees
    _close(KOPS.maxsim_rerank(
        torch.from_numpy(q), td, torch.from_numpy(rows), torch.from_numpy(qm),
        None if mask == "none" else torch.from_numpy(dm), scales=ts), want)


# ---------------------------------------------------------------------------
# the wrappers and the launchers' arguments, through a stand-in library
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_card(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(DSP, "on_cuda", lambda t: True)
    monkeypatch.setattr(build, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    DSP.reset_counts()
    yield lib
    DSP.reset_counts()


def _args(dtype, seed=3, Q=12, d=32):
    _, q, qm, dm, _, _ = _inputs(seed, "bf16", Q=Q, d=d)
    x = torch.from_numpy(_unit(np.random.default_rng(seed), (23, 37, d)))
    dv, sc = KOPS.quantize_int8(x) if dtype == "int8" else \
        (x.to(dtype), None)
    rows = torch.randint(0, 23, (q.shape[0], 6),
                         generator=torch.Generator().manual_seed(seed))
    return (torch.from_numpy(q), dv, torch.from_numpy(qm),
            torch.from_numpy(dm), sc, rows)


def _call(wrapper, q, dv, qm, dm, sc, rows, operand=None):
    if wrapper == "db":
        KOPS.maxsim_scores_pipelined(q, dv, qm, dm, chunk=8, scales=sc,
                                     operand=operand)
        return "maxsim_scan_db_launch", slice(13, 16)
    KOPS.maxsim_rerank(q, dv, rows, qm, dm, scales=sc, operand=operand)
    return "maxsim_rerank_launch", slice(14, 17)


@pytest.mark.parametrize("wrapper", ["db", "rerank"])
@pytest.mark.parametrize("route", [1, 0])
@pytest.mark.parametrize("dtype,code", [(torch.bfloat16, 1), ("int8", 2),
                                        (torch.float32, 0)])
def test_route_is_the_scan_librarys(fake_card, wrapper, route, dtype, code):
    """Both wrappers ask the scan library's ``maxsim_scan_route`` for (type
    code, D, d) and take its answer: the tensor route passes the packed
    operand (the db scan also the token cap the library gave; the rerank
    asks for no cap), the warp route null pointers."""
    fake_card.route = route
    q, dv, qm, dm, sc, rows = _args(dtype)
    entry, ops = _call(wrapper, q, dv, qm, dm, sc, rows)
    assert fake_card.queries[0] == ("route", (code, 37, 32))
    (name, args), = fake_card.args
    assert name == entry
    if route:
        assert all(args[ops])
        if wrapper == "db":
            assert fake_card.queries[1:] == [("cap", (code, 32))]
            assert args[16] == fake_card.cap
        else:
            assert len(fake_card.queries) == 1
    else:
        assert len(fake_card.queries) == 1
        assert not any(args[ops])
        if wrapper == "db":
            assert args[16] == 0
    counter = {"db": "maxsim_scan_db"}.get(
        wrapper, "maxsim_rerank_int8" if sc is not None else "maxsim_rerank")
    assert DSP.launch_count(counter) == 1


@pytest.mark.parametrize("wrapper", ["db", "rerank"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, "int8"])
def test_given_operand_is_launched_unchanged(fake_card, wrapper, dtype):
    q, dv, qm, dm, sc, rows = _args(dtype)
    op = KOPS.scan_query_operand(q, qm)
    _, ops = _call(wrapper, q, dv, qm, dm, sc, rows, operand=op)
    (_, args), = fake_card.args
    assert args[ops] == tuple(t.data_ptr() for t in op)


@pytest.mark.parametrize("wrapper", ["db", "rerank"])
@pytest.mark.parametrize("kind", ["fewer queries", "more tokens",
                                  "another dim", "f32 rows"])
def test_operand_of_another_batch_is_refused(fake_card, wrapper, kind):
    q, dv, qm, dm, sc, rows = _args(torch.bfloat16)
    B = q.shape[0]
    if kind == "fewer queries":
        op = KOPS.scan_query_operand(q[:B - 1], qm[:B - 1])
    elif kind == "more tokens":
        op = KOPS.scan_query_operand(torch.cat([q, q], 1),
                                     torch.cat([qm, qm], 1))
    elif kind == "another dim":
        op = KOPS.scan_query_operand(q[..., :16], qm)
    else:
        qpack, qstart, qcount = KOPS.scan_query_operand(q, qm)
        op = (qpack.float(), qstart, qcount)
    with pytest.raises(ValueError, match="not a scan_query_operand"):
        _call(wrapper, q, dv, qm, dm, sc, rows, operand=op)
    assert fake_card.args == []
    assert all(DSP.launch_count(k) == 0 for k in DSP.KERNELS)


@pytest.mark.parametrize("wrapper", ["db", "rerank"])
def test_tensor_route_refuses_docs_not_16_byte_aligned(fake_card, wrapper):
    """int8 codes 8 bytes into a buffer pass the warp kernels' 8-byte
    loads but not the tensor route's 16-byte copies."""
    q, dv, qm, dm, sc, rows = _args("int8")
    buf = torch.zeros(dv.numel() + 32, dtype=torch.int8)
    base = (8 - buf.data_ptr()) % 16
    view = buf[base:base + dv.numel()].view(dv.shape)
    view.copy_(dv)
    assert view.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte aligned"):
        _call(wrapper, q, view, qm, dm, sc, rows)
    assert fake_card.args == []
    fake_card.route = 0
    _call(wrapper, q, view, qm, dm, sc, rows)
    assert len(fake_card.args) == 1


def test_db_refuses_a_query_above_the_token_cap(fake_card):
    """The db scan's tensor route holds a query's Q token slots up to the
    library's cap, as the scan's does: one more slot is refused."""
    fake_card.cap = 64
    q, dv, qm, dm, sc, rows = _args(torch.bfloat16, Q=64)
    _call("db", q, dv, qm, dm, sc, rows)
    assert len(fake_card.args) == 1
    q, dv, qm, dm, sc, rows = _args(torch.bfloat16, Q=65)
    with pytest.raises(ValueError, match="exceed"):
        _call("db", q, dv, qm, dm, sc, rows)
    assert len(fake_card.args) == 1


def test_rerank_tensor_route_takes_any_query_length(fake_card):
    """The rerank's tensor route takes a query in passes of 16 tokens, so
    it has no token cap: 600 token slots at d = 128 launch there, while
    the warp route (query in shared memory, 448 slots at d = 128) refuses
    them before a launch."""
    q, dv, qm, dm, sc, rows = _args(torch.bfloat16, Q=600, d=128)
    _call("rerank", q, dv, qm, dm, sc, rows)
    assert len(fake_card.args) == 1
    assert [k for k, _ in fake_card.queries] == ["route"]
    fake_card.route = 0
    with pytest.raises(ValueError, match="exceed"):
        _call("rerank", q, dv, qm, dm, sc, rows)
    assert len(fake_card.args) == 1
