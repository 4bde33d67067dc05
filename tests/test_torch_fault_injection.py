"""Fault injection and graceful degradation in the port, mirroring the 14
tests of ``tests/test_faults.py``, plus the decision parity of the two
packages' injectors and the serve CLI's graceful shutdown.

- **faults are deterministic**: a ``FaultPlan`` is seeded and
  counter-keyed, and the port's ``FaultInjector`` makes ``repro``'s
  decision at every ``(site, n)``;
- **transient failures are invisible**: injected transfer failures
  inside the retry budget recover (``stats["retries"]``) and results stay
  bit for bit the fully resident search; failures past the budget
  surface as ``TierError`` (never a hang), and the engine serves bit for
  bit again once the fault clears;
- **worker death is survivable**: ``WorkerKilled`` (a BaseException)
  kills the worker thread, the supervisor restarts it and waiters
  complete;
- **degradation is exact-or-flagged**: under a deadline the engine skips
  cold segments (``degraded=True`` + skip count) and the degraded answer
  is bit for bit the resident search over the scanned segments;
- **snapshots fail loudly, never wrongly**: a writer killed mid-step
  leaves ``.tmp`` debris only, a flipped bit raises ``CheckpointCorrupt``
  naming ``seg<i>/<key>``;
- **recovery keeps residency discipline** under any seeded fault
  schedule (hypothesis, bounded examples).

Searches are the port's alone here (``test_torch_tiering`` holds the
tiered search against ``repro``'s); the deadline tests pace transfers on
an emulated link (``link_bw``), as ``repro``'s do.
"""
import os

import numpy as np
import pytest
import torch

from repro.retrieval import faults as JFLT
from repro_torch.core import multistage as TM
from repro_torch.launch import serve
from repro_torch.retrieval import faults as FLT
from repro_torch.retrieval import tiering as TIER
from repro_torch.retrieval.retriever import Retriever
from repro_torch.retrieval.store import VectorStore
from repro_torch.retrieval.tiering import DegradePolicy, TierError
from repro_torch.training import checkpoint as CKPT

torch.set_num_threads(1)

D_FULL, D_POOL, DIM = 6, 2, 16
CAP = 64
TWO = (TM.Stage("mean_pooling", 8), TM.Stage("initial", 4))
ONE = (TM.Stage("mean_pooling", 4),)


def batch(n, seed=0):
    r = np.random.default_rng(seed)
    full = r.normal(size=(n, D_FULL, DIM)).astype(np.float32)
    return VectorStore({
        "initial": torch.from_numpy(full),
        "mean_pooling": torch.from_numpy(
            full.reshape(n, D_POOL, D_FULL // D_POOL, DIM).mean(2)),
    }, n, "float32")


def queries(seed=9, b=2, q=4):
    return np.random.default_rng(seed).normal(size=(b, q, DIM)).astype(
        np.float32)


def multi_segment_retriever(n_segs=4):
    r = Retriever(batch(CAP, 0), capacity=CAP, device="cpu")
    for s in range(1, n_segs):
        r.upsert(batch(CAP, s))
    r.delete([1, CAP + 2])
    assert len(r.store.segments) == n_segs
    return r


def assert_bitwise(got, want):
    gs, gi = got
    ws, wi = want
    assert torch.equal(gs, ws), "scores differ"
    np.testing.assert_array_equal(gi, wi)


def pins_clear(eng):
    assert not eng._pins or not any(eng._pins.values()), \
        f"leaked pins: {eng._pins}"


# ----------------------------------------------------------------------
# the injector itself
# ----------------------------------------------------------------------


def test_fault_plan_parse():
    p = FLT.FaultPlan.parse(
        "transfer_fail_rate=0.05,kill_worker_at=3+9,seed=7,"
        "transfer_fail_burst=2,oom_at=1,snapshot_bitflip_leaf=4")
    assert p.transfer_fail_rate == 0.05
    assert p.kill_worker_at == (3, 9)
    assert p.seed == 7 and p.transfer_fail_burst == 2
    assert p.oom_at == (1,) and p.snapshot_bitflip_leaf == 4
    assert FLT.FaultPlan.parse("") == FLT.FaultPlan()
    with pytest.raises(ValueError, match="unknown fault-plan field"):
        FLT.FaultPlan.parse("warp_factor=9")
    with pytest.raises(ValueError, match="not k=v"):
        FLT.FaultPlan.parse("seed")
    with pytest.raises(TypeError):
        FLT.as_injector(object())


SITES = ("h2d", "d2h", "h2d", "h2d", "d2h", "worker", "worker", "h2d",
         "d2h", "h2d")


def drive(inj, sites=SITES):
    log = []
    for site in sites:
        try:
            inj.fire(site)
            log.append((site, None))
        except BaseException as e:              # includes WorkerKilled
            log.append((site, type(e).__name__))
    return log, list(inj.events)


def test_injector_deterministic_and_counter_keyed():
    plan = FLT.FaultPlan(seed=3, transfer_fail_rate=0.4,
                         slow_transfer_rate=0.3, slow_transfer_s=0.0,
                         oom_at=(2,), kill_worker_at=(1,))
    a = drive(FLT.FaultInjector(plan))
    b = drive(FLT.FaultInjector(plan))
    assert a == b, "same plan + same op sequence must replay identically"
    # a different seed reshuffles the rate-drawn faults but the explicit
    # schedules stay pinned to their op indices
    log_c, _ = drive(FLT.FaultInjector(
        FLT.FaultPlan(seed=4, transfer_fail_rate=0.4, oom_at=(2,),
                      kill_worker_at=(1,))))
    assert log_c[6] == ("worker", "WorkerKilled")
    kinds = [k for s, k in a[0] if s == "h2d"]
    assert "DeviceOOM" in kinds, "explicit oom_at index never fired"


@pytest.mark.parametrize("spec", [
    "seed=3,transfer_fail_rate=0.4,slow_transfer_rate=0.3,oom_at=2,"
    "kill_worker_at=1",
    "seed=7,transfer_fail_rate=0.05,snapshot_bitflip_leaf=3",
    "seed=11,transfer_fail_rate=0.5,transfer_fail_burst=3,"
    "transfer_fail_ops=0+4",
    "seed=0,transfer_fail_rate=0.9,slow_transfer_rate=0.9,oom_at=1+5,"
    "kill_worker_at=0+2"])
def test_injector_decisions_match_repro(spec):
    """The port's injector makes ``repro``'s decision at every (site, n):
    the same fault kinds in the same places and the same event log, over
    a long mixed op sequence; the parsed plans are equal field by
    field."""
    plan, jplan = FLT.FaultPlan.parse(spec), JFLT.FaultPlan.parse(spec)
    assert {f: getattr(plan, f) for f in plan.__dataclass_fields__} == \
        {f: getattr(jplan, f) for f in jplan.__dataclass_fields__}
    sites = tuple(np.random.default_rng(5).choice(
        ["h2d", "d2h", "worker"], size=200))
    assert drive(FLT.FaultInjector(plan), sites) == \
        drive(JFLT.FaultInjector(jplan), sites)
    # the snapshot hooks: the same leaf flipped, the same bit, the same kill
    inj, jinj = FLT.FaultInjector(plan), JFLT.FaultInjector(jplan)
    a = np.arange(12, dtype=np.float32)
    for i in range(6):
        np.testing.assert_array_equal(inj.corrupt_snapshot_leaf(i, a),
                                      jinj.corrupt_snapshot_leaf(i, a))


def test_disarm_keeps_counters_aligned():
    plan = FLT.FaultPlan(transfer_fail_ops=(0, 2))
    inj = FLT.FaultInjector(plan)
    inj.disarm()
    inj.fire("h2d")                               # op 0: scheduled, armed off
    inj.armed = True
    inj.fire("h2d")                               # op 1: clean
    with pytest.raises(FLT.TransientTransferError):
        inj.fire("h2d")                           # op 2: still aligned
    assert inj.counts() == {"transfer_fail": 1}


# ----------------------------------------------------------------------
# transient failures: retried inside the engine, invisible to results
# ----------------------------------------------------------------------


def test_transient_transfer_failures_retry_bitwise():
    r = multi_segment_retriever()
    q = queries()
    want = r.search(q, stages=TWO)
    seg_bytes = r.store.segments[0].nbytes
    # every 3rd transfer op fails once; burst=1 < retry budget, so every
    # failure recovers on the next attempt
    plan = FLT.FaultPlan(transfer_fail_ops=tuple(range(0, 30, 3)))
    with r.tiered(seg_bytes + 1, faults=plan) as eng:
        got = eng.search(q, stages=TWO, overlap=False)
        assert_bitwise(got, want)
        assert eng.stats["retries"] > 0, "no injected failure was retried"
        assert eng.stats["transfer_errors"] == 0
        assert not got.degraded
        pins_clear(eng)


def test_permanent_failure_is_typed_then_recovers():
    r = multi_segment_retriever()
    q = queries()
    want = r.search(q, stages=TWO)
    seg_bytes = r.store.segments[0].nbytes
    with r.tiered(seg_bytes + 1, max_retries=2) as eng:
        eng.search(q, stages=TWO, overlap=False)     # warm + settle LRU
        # burst far beyond the retry budget: the failure is permanent
        # while armed and must surface as a typed TierError, not a hang
        eng.arm(FLT.FaultPlan(transfer_fail_rate=1.0,
                              transfer_fail_burst=10 ** 6))
        with pytest.raises(TierError, match="failed after 3 attempts"):
            eng.search(q, stages=TWO, overlap=False)
        assert eng.stats["transfer_errors"] >= 1
        pins_clear(eng)
        # the fault clears -> the SAME engine serves bit for bit again
        eng.arm(None)
        assert_bitwise(eng.search(q, stages=TWO, overlap=False), want)
        pins_clear(eng)


def test_oom_on_promotion_evicts_and_recovers():
    r = multi_segment_retriever()
    q = queries()
    want = r.search(q, stages=TWO)
    seg_bytes = r.store.segments[0].nbytes
    plan = FLT.FaultPlan(oom_at=(0, 3))
    with r.tiered(2 * seg_bytes + 1, faults=plan) as eng:
        got = eng.search(q, stages=TWO, overlap=False)
        assert_bitwise(got, want)
        assert eng.stats["oom_evictions"] >= 1, \
            "injected DeviceOOM never forced an eviction"
        pins_clear(eng)


# ----------------------------------------------------------------------
# worker death: the supervisor restarts, waiters never hang
# ----------------------------------------------------------------------


def test_worker_kill_supervisor_restarts_bitwise():
    r = multi_segment_retriever()
    q = queries()
    want = r.search(q, stages=TWO)
    seg_bytes = r.store.segments[0].nbytes
    # the first two worker items die mid-flight: one kills a prefetch the
    # search is about to wait on, the restart's re-enqueued op survives
    plan = FLT.FaultPlan(kill_worker_at=(0, 2))
    with r.tiered(seg_bytes + 1, faults=plan) as eng:
        for _ in range(3):
            eng.prefetch([2])
            got = eng.search(q, stages=TWO, overlap=True)
            assert_bitwise(got, want)
        assert eng.stats["worker_restarts"] >= 1, \
            "worker died but the supervisor never restarted it"
        assert eng._worker.is_alive()
        pins_clear(eng)
    eng._worker.join(timeout=10)
    assert not eng._worker.is_alive(), "close() left the worker running"


# ----------------------------------------------------------------------
# deadlines: exact-or-flagged degradation
# ----------------------------------------------------------------------


def test_deadline_degrades_exact_or_flagged():
    r = multi_segment_retriever()
    q = queries()
    seg_bytes = r.store.segments[0].nbytes
    n = len(r.store.segments)
    with r.tiered(seg_bytes + 1, link_bw=seg_bytes / 0.05) as eng, \
            r.tiered((n + 1) * seg_bytes) as oracle:
        eng.search(q, stages=TWO, scope=[0], overlap=False)  # 0 resident
        # an impossible budget: every cold promotion (50ms on the
        # emulated link) gets skipped; the resident segment still serves
        res = eng.search(q, stages=TWO, deadline_ms=1.0)
        assert res.degraded and res.skipped_segments == n - 1
        assert eng.stats["deadline_skips"] >= n - 1
        assert eng.stats["degraded"] >= 1
        # partial but never wrong: the degraded answer IS the resident
        # answer over the segments actually scanned
        assert_bitwise(res, oracle.search(q, stages=TWO, scope=[0]))
        # a generous budget: nothing skipped -> NOT degraded, and bit for
        # bit the full search (the exact-or-flagged invariant)
        res = eng.search(q, stages=TWO, deadline_ms=60_000.0)
        assert not res.degraded and res.skipped_segments == 0
        assert_bitwise(res, oracle.search(q, stages=TWO))
        pins_clear(eng)


def test_degrade_policy_min_segments_forces_answers():
    r = multi_segment_retriever()
    q = queries()
    seg_bytes = r.store.segments[0].nbytes
    n = len(r.store.segments)
    with r.tiered(seg_bytes + 1, link_bw=seg_bytes / 0.05) as eng, \
            r.tiered((n + 1) * seg_bytes) as oracle:
        eng.search(q, stages=TWO, scope=[3], overlap=False)  # 3 resident
        res = eng.search(q, stages=TWO, deadline_ms=1.0,
                         degrade=DegradePolicy(min_segments=2))
        # segment 3 was a resident hit; the policy floor forced ONE
        # skipped segment in (scope order: 0) despite the blown budget
        assert res.degraded and res.skipped_segments == n - 2
        assert_bitwise(res, oracle.search(q, stages=TWO, scope=[3, 0]))
        pins_clear(eng)


def test_degraded_stage_fallback_on_blown_arrival():
    r = multi_segment_retriever()
    q = queries()
    with r.tiered(10 * r.store.segments[0].nbytes) as eng:
        policy = DegradePolicy(skip_cold=False, stages_degraded=ONE)
        res = eng.search(q, stages=TWO, deadline_ms=1e-9, degrade=policy)
        # nothing was skipped, but the cheaper cascade answered — the
        # result must still carry the degraded flag
        assert res.degraded and res.skipped_segments == 0
        assert_bitwise(res, eng.search(q, stages=ONE))


def test_frontend_flags_degraded_and_never_caches_them():
    """The frontend's tiered dispatch: a micro-batch carries its request's
    remaining budget into the engine; the degraded answer is flagged on
    the handle, counted in ``stats["degraded"]`` and kept out of the
    result cache, while an exact answer is cached as before."""
    r = multi_segment_retriever()
    q = queries()
    want = r.search(q, stages=TWO)
    seg_bytes = r.store.segments[0].nbytes
    with r.tiered(seg_bytes + 1, link_bw=seg_bytes / 0.05) as eng:
        eng.search(q, stages=TWO, scope=[0], overlap=False)  # 0 resident
        fe = r.frontend(TWO, max_batch=4, max_q=8, min_q=2, cache_size=8,
                        engine=eng, degrade=DegradePolicy(),
                        clock=lambda: 0.0)
        pr = fe.submit(q[0], deadline_ms=1.0)
        fe.flush()
        assert pr.done() and pr.error is None and pr.degraded
        assert fe.stats["degraded"] == 1 and not fe._cache
        live = pr.ids[pr.ids >= 0]
        assert live.size and (live < CAP).all(), "id outside segment 0"
        # the same query without a deadline: exact, and cached
        s, i = fe.search(q[0])
        np.testing.assert_array_equal(i[0], want[1][0])
        assert len(fe._cache) == 1 and fe.stats["degraded"] == 1
        pins_clear(eng)


# ----------------------------------------------------------------------
# snapshot integrity: crash debris, bit flips, GC discipline
# ----------------------------------------------------------------------


def test_snapshot_midwrite_kill_falls_back_bitwise(tmp_path):
    r = multi_segment_retriever()
    q = queries()
    want = r.search(q, stages=TWO)
    TIER.snapshot(r.store, str(tmp_path), step=1)
    with pytest.raises(FLT.SnapshotKilled):
        TIER.snapshot(r.store, str(tmp_path), step=2,
                      faults=FLT.FaultPlan(snapshot_kill_after_leaf=2))
    # the kill left only .tmp debris: LATEST still names step 1
    assert any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    assert CKPT.latest_step(str(tmp_path)) == 1
    r2 = Retriever.from_snapshot(str(tmp_path), device="cpu")
    assert_bitwise(r2.search(q, stages=TWO), want)
    # the next COMPLETE step sweeps the dead writer's debris
    TIER.snapshot(r.store, str(tmp_path), step=3)
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    assert CKPT.latest_step(str(tmp_path)) == 3


def test_snapshot_bitflip_detected_and_named(tmp_path):
    r = multi_segment_retriever()
    q = queries()
    want = r.search(q, stages=TWO)
    TIER.snapshot(r.store, str(tmp_path), step=1)
    TIER.snapshot(r.store, str(tmp_path), step=2,
                  faults=FLT.FaultPlan(snapshot_bitflip_leaf=3))
    with pytest.raises(CKPT.CheckpointCorrupt, match=r"seg\d+/\w+"):
        TIER.restore_store(str(tmp_path), device="cpu")
    # the damage is step-local: the previous step restores bit for bit
    store = TIER.restore_store(str(tmp_path), step=1, device="cpu")
    got = Retriever(store, device="cpu").search(q, stages=TWO)
    assert_bitwise(got, want)


def test_gc_never_deletes_newest_complete(tmp_path):
    leaves = [np.arange(8, dtype=np.float32)]
    for step in (1, 2, 3):
        CKPT.save(str(tmp_path), step, leaves, keep=2)
    names = sorted(d for d in os.listdir(tmp_path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    assert names == ["step_00000002", "step_00000003"]
    # keep=0 must still floor at the newest complete step, .tmp debris
    # notwithstanding
    os.makedirs(tmp_path / "step_00000001.tmp")
    CKPT.save(str(tmp_path), 4, leaves, keep=0)
    names = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert "step_00000004" in names
    assert "step_00000001.tmp" not in names, "stale debris survived GC"
    restored, _ = CKPT.restore(str(tmp_path))
    np.testing.assert_array_equal(restored[0].numpy(), leaves[0])


# ----------------------------------------------------------------------
# property: ANY seeded fault schedule leaves the engine coherent
# ----------------------------------------------------------------------


def test_fault_recovery_invariants_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    r = multi_segment_retriever(n_segs=4)
    q = queries()
    want = r.search(q, stages=TWO)
    seg_bytes = r.store.segments[0].nbytes

    def lru_state_ok(eng, budget):
        resident = eng.resident()
        by_tier = {i for i, s in enumerate(r.store.segments)
                   if s.tier == "device"}
        assert set(resident) == by_tier
        assert eng.resident_bytes == sum(r.store.segments[i].nbytes
                                         for i in resident)
        if eng.resident_bytes > budget:
            assert eng.stats["overflow"] > 0

    @given(seed=st.integers(0, 2 ** 16),
           rate=st.sampled_from([0.0, 0.3, 0.9]),
           kills=st.lists(st.integers(0, 5), max_size=2, unique=True),
           oom=st.lists(st.integers(0, 5), max_size=1),
           cap_segs=st.integers(1, 3))
    @settings(deadline=None, max_examples=12)
    def prop(seed, rate, kills, oom, cap_segs):
        plan = FLT.FaultPlan(seed=seed, transfer_fail_rate=rate,
                             transfer_fail_burst=2,
                             kill_worker_at=tuple(kills),
                             oom_at=tuple(oom))
        budget = cap_segs * seg_bytes + 1
        with r.tiered(budget, max_retries=2) as eng:
            eng.arm(plan)
            for i, ov in ((1, False), (3, True), (0, False), (2, True)):
                try:
                    if ov:
                        eng.prefetch([i])
                    eng.search(q, stages=TWO, scope=[i, (i + 1) % 4],
                               overlap=ov)
                except TierError:
                    pass            # permanent-failure surfacing is legal
                lru_state_ok(eng, budget)
                pins_clear(eng)
            # the storm passes: the engine must serve bit for bit again
            eng.arm(None)
            got = eng.search(q, stages=TWO, overlap=False)
            assert_bitwise(got, want)
            lru_state_ok(eng, budget)
            pins_clear(eng)

    prop()


# ----------------------------------------------------------------------
# the serve CLI's graceful shutdown and tiered mode
# ----------------------------------------------------------------------


def test_serve_graceful_exit_drains_and_snapshots(tmp_path):
    """The SIGTERM/SIGINT path: the frontend's queued requests complete,
    the engine's counters are reported and closed, and a final snapshot
    of the corpus restores bit for bit."""
    import argparse
    r = multi_segment_retriever()
    q = queries()
    want = r.search(q, stages=TWO)
    eng = r.tiered(r.store.segments[0].nbytes + 1)
    fe = r.frontend(TWO, max_batch=4, max_q=8, min_q=2, engine=eng)
    pending = [fe.submit(q[b]) for b in range(2)]
    live = {"frontend": fe, "engine": eng, "retriever": r}
    args = argparse.Namespace(snapshot_dir=str(tmp_path))
    out = serve._graceful_exit(args, live, "SIGTERM")
    assert all(p.done() and p.error is None for p in pending)
    for b, p in enumerate(pending):
        np.testing.assert_array_equal(p.ids[0], want[1][b])
    assert out["frontend"]["degraded"] == 0 and "engine" in out
    assert not eng._worker.is_alive()
    r2 = Retriever.from_snapshot(str(tmp_path), device="cpu")
    assert_bitwise(r2.search(q, stages=TWO), want)


def test_serve_tiered_mode(tmp_path):
    """``serve.py``'s tiered mode (``--hbm-budget --fault-plan
    --deadline-ms --degrade``) over a snapshot-restored corpus: the
    ranking metrics of the resident search, 0 builds after warm-up, no
    degradation under a generous deadline, promotions counted; and the
    CLI's tiered and snapshot flags run on the card by default, raising
    without one."""
    import argparse
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import evaluate_ranking, make_benchmark
    from repro_torch.retrieval.ingest import IngestPipeline
    cfg = dataclasses.replace(get_config("colpali"), grid_h=4, grid_w=4,
                              out_dim=16)
    bench = make_benchmark(cfg, (8, 8, 8), (2, 2, 2), n_topics_per_ds=2)
    pipe = IngestPipeline.for_config(cfg, device="cpu")
    r = Retriever(pipe.index(bench.pages[:12], bench.token_types),
                  capacity=12, device="cpu")
    r.upsert(pipe.index(bench.pages[12:], bench.token_types))
    assert len(r.store.segments) == 2
    stages = TM.two_stage(8, 4)
    _, ids = r.search(bench.queries, bench.query_mask, stages=stages)
    want = evaluate_ranking(ids, bench.qrels, ks=(5, 10))
    r.snapshot(str(tmp_path))
    r = Retriever.from_snapshot(str(tmp_path), device="cpu")
    args = argparse.Namespace(
        hbm_budget=r.store.segments[0].nbytes + 1, deadline_ms=60_000.0,
        degrade=True, fault_plan="transfer_fail_rate=0.05,seed=7")
    live = {}
    out = serve._run_tiered(args, bench, r, stages, live)
    assert out["metrics"] == want
    assert out["builds_overlap"] == 0 and out["builds_sync"] == 0
    assert out["deadline"] == {"degraded": False, "skipped": 0}
    assert out["stats"]["promotions"] > 0 and "engine" not in live
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--pages", "30", "--queries", "10",
                        "--snapshot-dir", str(tmp_path / "s"),
                        "--hbm-budget", "1000", "--degrade",
                        "--deadline-ms", "5", "--fault-plan", "seed=1"])
