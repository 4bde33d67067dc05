"""The port's op audit layer (``repro_torch.analysis.op_audit``), held to
``repro.analysis.jaxpr_audit``: the seeded violations of
``tests/test_analysis.py`` in torch twins on the same shapes give the
same verdicts, symbols and byte counts; a value-branching body fails D4;
the six real scenarios run clean on the CPU with ``repro``'s corpus
rows; the CLI's op layer needs a card unless told the CPU."""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.jaxpr_audit import audit_jaxpr, run_jaxpr_audit

from repro_torch.analysis import op_audit as OA
from repro_torch.analysis.op_audit import OpAuditor, audit_body

torch.set_num_threads(1)


def rules_of(findings):
    return sorted({f.rule for f in findings})


def _audit(fn, *args, corpus_rows=10**9, budget=1 << 30, alt=None):
    fs, m, _ = audit_body(fn, args, label="seeded", corpus_rows=corpus_rows,
                          budget_bytes=budget, args_alt=alt)
    return fs, m


# ---------------------------------------------------------------------
# D1-D3: the seeded twins of repro's J1-J3 tests, same shapes
# ---------------------------------------------------------------------


def test_full_corpus_int8_upcast_gives_repros_symbol():
    n, d = 64, 8

    def bad_jax(codes, scales, q):
        v = codes.astype(jnp.float32) * scales[:, None, None]
        return jnp.einsum("qd,njd->nqj", q, v).sum()

    closed = jax.make_jaxpr(bad_jax)(
        jnp.zeros((n, 4, d), jnp.int8), jnp.ones((n,), jnp.float32),
        jnp.ones((3, d), jnp.float32))
    rf, _ = audit_jaxpr(closed, label="seeded", corpus_rows=n,
                        budget_bytes=1 << 30)

    def bad(codes, scales, q):
        v = codes.float() * scales[:, None, None]
        return torch.einsum("qd,njd->nqj", q, v).sum()

    pf, _ = _audit(bad, torch.zeros((n, 4, d), dtype=torch.int8),
                   torch.ones(n), torch.ones(3, d), corpus_rows=n)
    assert rules_of(rf) == ["J1"] and rules_of(pf) == ["D1"]
    assert [f.symbol for f in rf] == [f.symbol for f in pf] \
        == ["int8_upcast:(64, 4, 8)"]


def test_chunked_dequant_passes_as_in_repro():
    n, chunk, d = 64, 8, 8

    def ok_jax(codes, scales, q):
        def one(i):
            blk = jax.lax.dynamic_slice_in_dim(codes, i * chunk, chunk)
            sc = jax.lax.dynamic_slice_in_dim(scales, i * chunk, chunk)
            v = blk.astype(jnp.float32) * sc[:, None, None]
            return jnp.einsum("qd,njd->nqj", q, v).sum()
        return sum(one(i) for i in range(n // chunk))

    closed = jax.make_jaxpr(ok_jax)(
        jnp.zeros((n, 4, d), jnp.int8), jnp.ones((n,), jnp.float32),
        jnp.ones((3, d), jnp.float32))
    rf, _ = audit_jaxpr(closed, label="seeded", corpus_rows=n,
                        budget_bytes=1 << 30)

    def ok(codes, scales, q):
        return sum(torch.einsum("qd,njd->nqj", q,
                                codes[i:i + chunk].float()
                                * scales[i:i + chunk, None, None]).sum()
                   for i in range(0, n, chunk))

    pf, _ = _audit(ok, torch.zeros((n, 4, d), dtype=torch.int8),
                   torch.ones(n), torch.ones(3, d), corpus_rows=n)
    assert [f for f in rf if f.rule == "J1"] == []
    assert [f for f in pf if f.rule == "D1"] == []


def test_oversized_broadcast_flagged_with_repros_byte_count():
    def blowup_jax(q, docs):
        return jnp.einsum("bqd,njd->bnqj", q, docs).max(-1).sum(-1)

    closed = jax.make_jaxpr(blowup_jax)(jnp.ones((4, 8, 16), jnp.float32),
                                        jnp.ones((128, 32, 16), jnp.float32))
    rf, rm = audit_jaxpr(closed, label="seeded", corpus_rows=10**9,
                         budget_bytes=256 << 10)

    def blowup(q, docs):
        return torch.einsum("bqd,njd->bnqj", q, docs).amax(-1).sum(-1)

    pf, pm = _audit(blowup, torch.ones(4, 8, 16), torch.ones(128, 32, 16),
                    budget=256 << 10)
    assert "J2" in rules_of(rf) and "D2" in rules_of(pf)
    assert pm["max_live_bytes"] == rm["max_live_bytes"] == 4 * 128 * 8 * 32 * 4
    assert f"materialises {4 * 128 * 8 * 32 * 4} bytes" in " ".join(
        f.message for f in pf if f.rule == "D2")


def test_item_is_a_host_wait_where_repro_flags_a_host_callback():
    def cb(x):
        return jax.pure_callback(
            lambda v: np.asarray(v) * 2,
            jax.ShapeDtypeStruct((4,), np.float32), x)

    rf, _ = audit_jaxpr(jax.make_jaxpr(cb)(jnp.ones((4,), jnp.float32)),
                        label="seeded", corpus_rows=10**9,
                        budget_bytes=1 << 30)
    pf, pm = _audit(lambda x: x * x.sum().item(), torch.ones(4))
    assert "J3" in rules_of(rf)
    assert rules_of(pf) == ["D3"] and pm["syncs"] == 1
    assert [f.symbol for f in pf] == ["sync:_local_scalar_dense"]


def test_data_shaped_ops_are_host_waits():
    x = torch.arange(8.0)
    for fn in (lambda t: t[t > 3], lambda t: torch.nonzero(t),
               lambda t: torch.unique(t),
               lambda t: torch.repeat_interleave(t.long())):
        pf, _ = _audit(fn, x)
        assert rules_of(pf) == ["D3"], fn
    # a long index and an output_size keep shapes static
    pf, _ = _audit(lambda t: t[torch.tensor([1, 2])] + torch.repeat_interleave(
        t[:2], torch.tensor([1, 1]), output_size=2), x)
    assert pf == []


def test_blocking_copies_between_host_and_card_are_host_waits():
    # stand-ins carry only devices: the rule reads nothing else
    cpu, cuda = (types.SimpleNamespace(device=torch.device(d))
                 for d in ("cpu", "cuda"))
    hw = OpAuditor._host_wait
    assert "blocking copy cuda -> cpu" in hw("_to_copy", (cuda,), {}, [],
                                             [cpu])
    assert hw("copy_", (cuda, cpu), {}, [], [cuda]) is not None
    assert hw("_to_copy", (cpu,), {"non_blocking": True}, [], [cuda]) is None
    assert hw("copy_", (cuda, cpu, True), {}, [], [cuda]) is None
    assert hw("_to_copy", (cpu,), {}, [], [cpu]) is None


# ---------------------------------------------------------------------
# D4: the twin of repro's J4 (a retrace axis), on the same contract
# ---------------------------------------------------------------------


def test_value_branching_body_flagged_d4_clean_body_not():
    closed = jax.make_jaxpr(lambda x, y: x * y)(jnp.ones((4,), jnp.float32),
                                                2.0)
    rf, _ = audit_jaxpr(closed, label="seeded", corpus_rows=10**9,
                        budget_bytes=1 << 30)
    assert "J4" in rules_of(rf)

    def branchy(x):
        if bool((x > 0).all()):
            return x * 2
        return x.exp()

    pf, _ = _audit(branchy, torch.ones(4), alt=(-torch.ones(4),))
    assert "D4" in rules_of(pf)
    assert any(f.symbol.startswith("value_dependent:") for f in pf)
    pf, _ = _audit(lambda x: torch.where(x > 0, x * 2, x.exp()),
                   torch.ones(4), alt=(-torch.ones(4),))
    assert pf == []


def test_a_build_inside_the_body_is_flagged_d4():
    from repro_torch.retrieval import tracing

    def rebuilding(x):
        tracing.record_trace("rebuilding")
        return x + 1

    pf, _ = _audit(rebuilding, torch.ones(2), alt=(torch.zeros(2),))
    assert [f.symbol for f in pf] == ["rebuilt:1"]


# ---------------------------------------------------------------------
# the six real scenarios on the CPU, beside repro's
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_audit():
    return OA.run_op_audit(device="cpu")


@pytest.fixture(scope="module")
def repro_metrics():
    return run_jaxpr_audit()[1]


@pytest.mark.parametrize("name", sorted(OA.SCENARIOS))
def test_real_scenario_clean_on_cpu(name, port_audit, repro_metrics):
    findings, metrics = port_audit
    m = metrics[name]
    assert [f for f in findings if f.path == f"<ops:{name}>"] == []
    assert m["corpus_rows"] == repro_metrics[name]["corpus_rows"] == 256
    assert m["syncs"] == 0 and m["launches"] == {} and m["n_ops"] > 0
    # the budget rule: 1.5x the largest op output, below the 40 MiB
    # [B, N, Q, D] sim tensor of this geometry
    assert 1.5 * m["max_live_bytes"] <= m["budget_bytes"] < 40 << 20


def test_scenarios_take_the_kernels_only_on_the_card():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    plain, card = OA._stages(cpu), OA._stages(cuda)
    assert not plain[0].use_kernel and plain[0].scan_topk
    assert card[0].use_kernel and card[0].chunk == 16
    assert not card[1].rerank_kernel
    fused = OA._stages(cpu, scan_kernel=True, rerank_kernel=True)
    assert fused[0].use_kernel and fused[1].rerank_kernel
    routed = OA._stages(cpu, routing=True)
    assert (routed[0].n_probe, routed[0].n_clusters) == (2, 4)


def test_op_layer_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OA.run_op_audit(names=["tiered"])


def test_cli_green_on_cpu_with_op_metrics(tmp_path, port_audit):
    from repro_torch.analysis.__main__ import main
    report = tmp_path / "r.json"
    assert main(["--check", "--device", "cpu", "--report",
                 str(report)]) == 0
    rep = json.loads(report.read_text())
    assert rep["n_gated"] == 0
    assert sorted(rep["op_metrics"]) == sorted(OA.SCENARIOS)
    assert rep["op_metrics"]["routed"]["max_live_bytes"] == \
        port_audit[1]["routed"]["max_live_bytes"]
