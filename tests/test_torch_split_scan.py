"""The tensor-core scan's host side and arithmetic, on the CPU.

The CUDA kernel (``csrc/maxsim_wgmma.cuh``) runs only on the card. What it
is given and what it computes are held here:

- ``split_bf16``: q_hi + q_lo equals q to within 2^-16 relative;
- ``scan_query_operand``: the valid tokens' hi and lo rows in query
  order, each query's first row and count, as a loop over the mask;
- ``split_ref`` below (the kernel's arithmetic: exact bf16 products, f32
  sums, the int8 scale after the product) stays within the scan's stated
  tolerance, rtol=1e-5 and atol=1e-4 on scores of unit-vector tokens, of
  ``maxsim_ref`` and of ``repro``'s ``maxsim_scores(impl="pallas")``
  (``maxsim_pallas`` in interpret mode), with the same sentinels;
- the wrapper and the launcher's arguments: the route and the token cap
  are the scan library's answers (stood in for here; ``chip_smoke.py``
  prints the real ones), the tensor route gets the packed operand and the
  warp route null pointers, and an operand of another batch or documents
  that are not 16-byte aligned are refused before any launch.
"""
import contextlib
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.maxsim import ops as JOPS
from repro_torch.kernels import build
from repro_torch.kernels import dispatch as DSP
from repro_torch.kernels.maxsim import ops as KOPS
from repro_torch.kernels.maxsim.ref import NEG, maxsim_ref

torch.set_num_threads(1)

SCAN_TOL = dict(rtol=1e-5, atol=1e-4)


def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _inputs(seed, B=6, Q=12, N=9, D=34, d=32):
    rng = np.random.default_rng(seed)
    q = _unit(rng, (B, Q, d))
    qm = (rng.random((B, Q)) > 0.3).astype(np.float32)
    qm[1] = 0.0                                   # a query with no token
    docs = _unit(rng, (N, D, d))
    dm = rng.random((N, D)) > 0.1
    dm[2] = False                                 # a fully masked document
    return q, qm, docs, dm


def test_split_bf16_is_within_2e_minus_16():
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4096,)).astype(np.float32))
    hi, lo = KOPS.split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (hi.float() + lo.float() - x).abs()
    assert bool((err <= x.abs() * 2.0 ** -16).all())


@pytest.mark.parametrize("seed", [0, 1, 2, 4])
@pytest.mark.parametrize("B", [2, 9])
def test_query_operand_equals_a_loop(seed, B):
    """Row r of the operand holds the r-th valid token's (q_hi, q_lo) in
    (query, token) order, and query b's rows are qstart[b] ..
    qstart[b] + qcount[b] - 1 (the rows after the last are never read):
    the same as a loop over the mask."""
    q, qm, _, _ = _inputs(seed, B=B)
    qpack, qstart, qcount = KOPS.scan_query_operand(torch.from_numpy(q),
                                                    torch.from_numpy(qm))
    assert qpack.shape == (B * q.shape[1] + 1, 2, q.shape[2])
    row = 0
    for b in range(B):
        assert int(qstart[b]) == row
        for t in range(q.shape[1]):
            if qm[b, t] > 0:
                hi, lo = KOPS.split_bf16(torch.from_numpy(q[b, t]))
                assert torch.equal(qpack[row, 0], hi)
                assert torch.equal(qpack[row, 1], lo)
                row += 1
        assert int(qcount[b]) == row - int(qstart[b])


def split_ref(operand: tuple, docs: torch.Tensor,
              doc_mask: torch.Tensor | None = None,
              scales: torch.Tensor | None = None) -> torch.Tensor:
    """The tensor route's arithmetic in plain PyTorch: [B, N] scores from
    a ``scan_query_operand`` and bf16 documents or int8 codes. Each
    similarity is docs . q_hi + docs . q_lo with exact bf16 products and
    f32 sums, times the int8 row scale after the product; masked rows
    score NEG, each valid token's max is floored at NEG/2."""
    qpack, qstart, qcount = operand
    df = docs.float()                                  # bf16 / int8 exact
    hi, lo = qpack[:, 0].float(), qpack[:, 1].float()
    sim = (torch.einsum("njd,td->ntj", df, hi)
           + torch.einsum("njd,td->ntj", df, lo))      # [N, rows, D]
    if scales is not None:
        sim = sim * scales.float()[:, None, :]
    if doc_mask is not None:
        sim.masked_fill_(~(doc_mask > 0)[:, None, :], NEG)
    best = sim.amax(dim=-1).clamp_min(NEG / 2)         # [N, rows]
    out = torch.zeros((qstart.shape[0], docs.shape[0]), dtype=torch.float32)
    for b, (s0, c) in enumerate(zip(qstart.tolist(), qcount.tolist())):
        out[b] = best[:, s0:s0 + c].sum(dim=-1)
    return out


def _close(got, want):
    sent = want <= -1e20
    assert torch.equal(got <= -1e20, sent)
    torch.testing.assert_close(got[~sent], want[~sent], **SCAN_TOL)


@pytest.mark.parametrize("D", [34, 70])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("seed", [5, 8])
def test_split_arithmetic_within_scan_tolerance(D, kind, seed):
    q, qm, docs, dm = _inputs(seed, D=D)
    tq, tqm = torch.from_numpy(q), torch.from_numpy(qm)
    td, tdm = torch.from_numpy(docs), torch.from_numpy(dm)
    if kind == "bf16":
        dv, sc = td.to(torch.bfloat16), None
    else:
        dv, sc = KOPS.quantize_int8(td)
    op = KOPS.scan_query_operand(tq, tqm)
    got = split_ref(op, dv, tdm, sc)
    _close(got, maxsim_ref(tq, tqm, dv, tdm, sc))
    assert bool((got[1] == 0).all())              # no valid token: 0
    # repro's Pallas scan kernel (interpret mode) on the same inputs
    jd = jnp.asarray(dv.float().numpy()).astype(jnp.bfloat16) \
        if kind == "bf16" else jnp.asarray(dv.numpy())
    js = JOPS.maxsim_scores(
        jnp.asarray(q), jd, jnp.asarray(qm), jnp.asarray(dm, jnp.float32),
        None if sc is None else jnp.asarray(sc.numpy()), impl="pallas",
        block_n=8, block_d=32)
    _close(got, torch.from_numpy(np.array(js, np.float32)))


class _Recorder:
    """A stand-in scan library: answers the route and token-cap queries
    with ``route`` and ``cap`` (recording them) and records every launch's
    arguments."""

    def __init__(self, route: int = 1, cap: int = 384):
        self.route, self.cap = route, cap
        self.args, self.queries = [], []

    def maxsim_scan_route(self, *args):
        self.queries.append(("route", args))
        return self.route

    def maxsim_scan_token_cap(self, *args):
        self.queries.append(("cap", args))
        return self.cap

    def __getattr__(self, entry):
        def launch(*args):
            self.args.append((entry, args))
            return 0
        return launch


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


def _scan_args(dtype, seed=6, **kw):
    q, qm, docs, dm = _inputs(seed, d=32, **kw)
    td = torch.from_numpy(docs)
    dv, sc = KOPS.quantize_int8(td) if dtype == "int8" else \
        (td.to(dtype), None)
    return torch.from_numpy(q), dv, torch.from_numpy(qm), \
        torch.from_numpy(dm), sc


@pytest.mark.parametrize("route", [1, 0])
@pytest.mark.parametrize("dtype,code", [(torch.bfloat16, 1), ("int8", 2),
                                        (torch.float32, 0)])
def test_scan_route_rule(fake_card, dtype, code, route):
    """The wrapper asks the library for the route of (type code, D, d) and
    takes it: the tensor route passes the packed operand and the token cap
    the library gave, the warp route null pointers and no cap."""
    fake_card.route = route
    q, dv, qm, dm, sc = _scan_args(dtype)
    KOPS.maxsim_scores(q, dv, qm, dm, scales=sc)
    assert fake_card.queries[0] == ("route", (code, 34, 32))
    (entry, args), = fake_card.args
    assert entry == "maxsim_scan_launch"
    if route:
        assert fake_card.queries[1] == ("cap", (code, 32))
        assert all(args[13:16]) and args[16] == fake_card.cap
    else:
        assert len(fake_card.queries) == 1
        assert args[13:17] == (0, 0, 0, 0)
    assert DSP.launch_count("maxsim_scan_int8" if sc is not None
                            else "maxsim_scan") == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, "int8"])
def test_launcher_gets_the_operand_on_the_tensor_route(fake_card, dtype):
    """A given operand is the one launched, unchanged."""
    q, dv, qm, dm, sc = _scan_args(dtype)
    op = KOPS.scan_query_operand(q, qm)
    KOPS.maxsim_scores(q, dv, qm, dm, scales=sc, operand=op)
    (_, args), = fake_card.args
    assert args[13:16] == tuple(t.data_ptr() for t in op)


def _other_operand(kind, q, qm):
    B, Q, d = q.shape
    if kind == "fewer queries":
        return KOPS.scan_query_operand(q[:B - 1], qm[:B - 1])
    if kind == "more tokens":
        return KOPS.scan_query_operand(torch.cat([q, q], 1),
                                       torch.cat([qm, qm], 1))
    if kind == "another dim":
        return KOPS.scan_query_operand(q[..., :16], qm)
    qpack, qstart, qcount = KOPS.scan_query_operand(q, qm)
    if kind == "f32 rows":
        return qpack.float(), qstart, qcount
    return qpack, qstart.long(), qcount                 # int64 starts


@pytest.mark.parametrize("kind", ["fewer queries", "more tokens",
                                  "another dim", "f32 rows", "int64 starts"])
def test_operand_of_another_batch_is_refused(fake_card, kind):
    """The kernel reads every query's start and count and the rows they
    point at: an operand not built for this query is refused, not
    launched."""
    q, dv, qm, dm, _ = _scan_args(torch.bfloat16)
    with pytest.raises(ValueError, match="not a scan_query_operand"):
        KOPS.maxsim_scores(q, dv, qm, dm,
                           operand=_other_operand(kind, q, qm))
    assert fake_card.args == []
    assert DSP.launch_count("maxsim_scan") == 0


def test_tensor_route_refuses_docs_not_16_byte_aligned(fake_card):
    """int8 codes 8 bytes into a buffer pass the warp kernels' alignment
    but not the tensor route's 16-byte copies: a ValueError, no launch."""
    q, dv, qm, dm, sc = _scan_args("int8")
    N, D, d = dv.shape
    buf = torch.zeros(N * D * d + 32, dtype=torch.int8)
    base = (8 - buf.data_ptr()) % 16
    view = buf[base:base + N * D * d].view(N, D, d)
    view.copy_(dv)
    assert view.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte aligned"):
        KOPS.maxsim_scores(q, view, qm, dm, scales=sc)
    assert fake_card.args == []
    fake_card.route = 0                  # the warp route reads 8-byte rows
    KOPS.maxsim_scores(q, view, qm, dm, scales=sc)
    assert len(fake_card.args) == 1


def test_streamed_topk_packs_the_query_once(fake_card, monkeypatch):
    calls = []
    real = KOPS.scan_query_operand
    monkeypatch.setattr(KOPS, "scan_query_operand",
                        lambda *a: calls.append(1) or real(*a))
    q, qm, docs, dm = _inputs(7, N=40, d=32)
    KOPS.maxsim_topk_chunked(
        torch.from_numpy(q), torch.from_numpy(docs).to(torch.bfloat16),
        torch.from_numpy(qm), torch.from_numpy(dm), k=5, chunk=8)
    assert len(calls) == 1
    assert len(fake_card.args) == DSP.launch_count("maxsim_scan") == 5
    assert len({a[13] for _, a in fake_card.args}) == 1   # one operand
