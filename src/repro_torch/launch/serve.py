"""Serving launcher: index a corpus, run batched multi-stage search.

    PYTHONPATH=src python -m repro_torch.launch.serve --pages 4096 \
        --stages 2 --use-kernel --rerank-kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --pages 4096 \
        --stages 1 --use-kernel --chunk 256 --int8 [--scan-topk]
    PYTHONPATH=src python -m repro_torch.launch.serve --pages 4096 \
        --stages 2 --n-clusters 64 --n-probe 8 --use-kernel --rerank-kernel

Builds the synthetic benchmark for ``--arch``, indexes it through the
``IngestPipeline``'s fused ingest (``--use-kernel`` also routes the
pooling to the fused CUDA kernel), serves it with a ``Retriever`` and
prints QPS and NDCG/Recall@5/10 for one cascade. ``--use-kernel`` scores
the scan stage with the CUDA MaxSim scan kernel, ``--rerank-kernel`` the
rerank stages with the fused gather + MaxSim kernel. ``--chunk`` bounds
the plain scan's per-call corpus tile; with ``--use-kernel`` it selects
the double-buffered scan kernel (one launch). ``--int8`` quantises the
scan stage's vector at index time and drops its float copy when no later
stage reranks on it; ``--scan-topk`` streams a running top-k across scan
chunks instead of assembling the [B, N] scores. ``--n-clusters`` clusters
the corpus for IVF routing and ``--n-probe`` routes the scan stage
through that many clusters per query (with ``--use-kernel``: the scan
kernel on the centroids, the gather-rerank kernel on the probed members).
Runs on ``--device cuda`` (the default; without a card it raises) or
``--device cpu``, where every kernel wrapper takes its plain PyTorch
version.

Dynamic-corpus mode (``--ingest-batches N --ingest-batch-size B``):
starts from a capacity-padded corpus and measures steady-state live
ingestion: pages/s, search-after-ingest QPS and the steady-state build
count (``retrieval.tracing``; expected 0 after warm-up). With
``--ingest-pipeline`` raw pages go through the fused ``Retriever.ingest``
(index + one full-bucket copy per array into segment headroom); without
it, through host-driven ``build_store`` + ``upsert``.

Streaming-traffic mode (``--traffic N``): replays an open-loop Poisson
arrival process of N single RAGGED queries (each a benchmark query cut
to a random prefix of its valid tokens) through the shape-bucketed,
micro-batching ``ServingFrontend`` (``--max-batch``, ``--flush-ms``,
``--result-cache``, ``--deadline-ms``: queued requests past their
deadline are shed). Prints p50/p95/p99 latency, QPS against the
fixed-shape static QPS, dispatches, padded rows and the steady-state
build count. ``--arrival-rate 0`` offers 0.8x the static QPS.

Multi-tenant mode (``--tenants T``, with static or traffic mode): the
corpus is split round-robin across T tenants (each batch stamped with its
tenant id) and every request is scoped to one tenant with a
``FilterSpec``; ``--tenant-quota`` bounds the queued rows per tenant in
the frontend (excess submits are rejected at admission). Page ids are
reassigned in ingest order, so ranking metrics do not apply there.

Snapshot and tiered mode (static mode; two runs):

    PYTHONPATH=src python -m repro_torch.launch.serve --pages 4096 \
        --stages 2 --use-kernel --rerank-kernel --snapshot-dir DIR
    PYTHONPATH=src python -m repro_torch.launch.serve --pages 4096 \
        --stages 2 --use-kernel --rerank-kernel --snapshot-dir DIR \
        --hbm-budget 400000000

``--snapshot-dir`` persists the indexed corpus there (``Retriever.snapshot``)
or, when the directory already holds a snapshot, cold-starts from it
without indexing (``Retriever.from_snapshot``: bit for bit the saved
corpus). ``--hbm-budget`` serves through a ``TieredEngine``: device-resident
segment bytes capped at the budget, cold segments in pinned host memory,
QPS with async prefetch and with synchronous fetch. ``--fault-plan`` arms
the deterministic fault injector (a ``FaultPlan.parse`` spec, e.g.
``transfer_fail_rate=0.05,kill_worker_at=3,seed=7``) on the engine's
transfer and worker sites; ``--deadline-ms`` gives a tiered search a wall
budget, under which ``--degrade`` serves from resident segments only
(results flagged degraded) instead of blocking on cold promotions. On
SIGTERM/SIGINT the launcher drains the frontend's queued requests, takes
a final generation-stamped snapshot (with ``--snapshot-dir``), prints the
shed/degraded/retry counters and exits 0.
"""
from __future__ import annotations

import argparse
import signal
import threading
import time

import numpy as np
import torch


class _Shutdown(BaseException):
    """Raised inside the serving loop by the signal handler; unwinds to
    ``main``'s graceful-exit path. A ``BaseException`` on purpose: the
    frontend's per-cohort recovery catches ``Exception`` so one bad
    cohort cannot take the server down, and a kill signal must pass
    through that net."""


def _install_signals() -> dict:
    """Route SIGTERM/SIGINT into ``_Shutdown``; returns the previous
    handlers (``main`` puts them back). Signals reach only the main
    thread, so elsewhere nothing is installed."""
    if threading.current_thread() is not threading.main_thread():
        return {}

    def handler(signum, frame):
        raise _Shutdown(signal.Signals(signum).name)

    return {s: signal.signal(s, handler)
            for s in (signal.SIGTERM, signal.SIGINT)}


def _graceful_exit(args, live: dict, reason: str) -> dict:
    """Drain, snapshot, report: a SIGTERM'd server finishes the work it
    admitted and leaves a corpus the next process cold-starts from."""
    print(f"\n{reason}: graceful shutdown")
    out = {"shutdown": reason}
    fe = live.get("frontend")
    if fe is not None:
        served = fe.drain()
        st = fe.stats
        print(f"  drained {served} queued request(s); stats: "
              f"shed={st['shed']} degraded={st['degraded']} "
              f"errors={st['errors']} rejected={st['rejected']}")
        out["frontend"] = dict(st)
    eng = live.get("engine")
    if eng is not None:
        st = eng.stats
        print(f"  engine: retries={st['retries']} "
              f"transfer_errors={st['transfer_errors']} "
              f"worker_restarts={st['worker_restarts']} "
              f"degraded={st['degraded']} "
              f"deadline_skips={st['deadline_skips']}")
        out["engine"] = dict(st)
    retriever = live.get("retriever")
    if retriever is not None and args.snapshot_dir:
        # generation-stamped: snapshot() defaults its step to the store
        # generation, so the drained final state lands under its own step
        path = retriever.snapshot(args.snapshot_dir)
        print(f"  final snapshot -> {path}")
        out["snapshot"] = path
    if eng is not None:
        eng.close()
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _static_qps(retriever, bench, stages, filter=None) -> float:
    """QPS of the whole query set in one search call (warmed once, timed
    three times, raw slot ids)."""
    q, qm = bench.queries, bench.query_mask
    dev = retriever.device
    retriever.search(q, qm, stages=stages, filter=filter)      # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(3):
        # time raw dispatch (slot ids on the device); translate once below
        retriever.search(q, qm, stages=stages, translate_ids=False,
                         filter=filter)
    _sync(dev)
    return len(q) / ((time.perf_counter() - t0) / 3)


def _run_static(args, bench, retriever, stages, int8_on: bool,
                live: dict) -> dict:
    """Time the cascade over the whole query set and score the ranking;
    prints and returns QPS and the metrics (through the tiered engine
    with ``--hbm-budget``)."""
    from repro_torch.data.synthetic import evaluate_ranking

    if args.tenants > 1:
        return _run_static_tenants(args, bench, retriever, stages)
    live["retriever"] = retriever
    if args.hbm_budget > 0:
        return _run_tiered(args, bench, retriever, stages, live)
    qps = _static_qps(retriever, bench, stages)
    _, ids = retriever.search(bench.queries, bench.query_mask,
                              stages=stages)
    metrics = evaluate_ranking(ids, bench.qrels, ks=(5, 10))
    scan = ("kernel" if args.use_kernel else "ref") + \
        (f"/chunk={args.chunk}" if args.chunk else "") + \
        ("/int8" if int8_on else "") + \
        ("/scan-topk" if args.scan_topk else "") + \
        (f"/n-probe={args.n_probe}of{args.n_clusters}" if args.n_probe
         else "") + \
        ("/rerank-kernel" if args.rerank_kernel else "")
    print(f"{args.stages}-stage [{scan}] on {retriever.device}: "
          f"QPS={qps:.1f}  " +
          "  ".join(f"{k}={v:.3f}" for k, v in metrics.items()))
    return dict(qps=qps, **metrics)


def _run_tiered(args, bench, retriever, stages, live: dict) -> dict:
    """Static QPS through the tiered residency engine: device-resident
    segment bytes capped at ``--hbm-budget``, cold segments in host
    memory, async-prefetch overlap and synchronous fetch both timed (each
    warmed once, timed three times, ended by a synchronising copy of the
    ids). Scores the ranking of the overlap run."""
    from repro_torch.data.synthetic import evaluate_ranking
    from repro_torch.retrieval import tracing
    from repro_torch.retrieval.faults import FaultPlan
    from repro_torch.retrieval.tiering import DegradePolicy

    store = retriever.store
    store_bytes = sum(s.nbytes for s in store.segments)
    q, qm = bench.queries, bench.query_mask
    plan = FaultPlan.parse(args.fault_plan) if args.fault_plan else None
    out = {}
    with retriever.tiered(args.hbm_budget, faults=plan) as eng:
        live["engine"] = eng
        for overlap in (True, False):
            eng.search(q, qm, stages=stages, overlap=overlap)     # warm
            warm = tracing.trace_count()
            t0 = time.perf_counter()
            for _ in range(3):
                res = eng.search(q, qm, stages=stages, overlap=overlap)
            qps = 3 * len(q) / (time.perf_counter() - t0)
            mode = "overlap" if overlap else "sync"
            out[mode] = qps
            out[f"builds_{mode}"] = tracing.trace_count() - warm
            print(f"tiered [{mode}, budget {args.hbm_budget / 1e6:.0f}MB / "
                  f"corpus {store_bytes / 1e6:.0f}MB] on {retriever.device}:"
                  f" QPS={qps:.1f}  resident={len(eng.resident())}/"
                  f"{len(store.segments)} segments")
            if overlap:
                out["metrics"] = evaluate_ranking(res.ids, bench.qrels,
                                                  ks=(5, 10))
        if args.deadline_ms > 0:
            res = eng.search(
                q, qm, stages=stages, deadline_ms=args.deadline_ms,
                degrade=DegradePolicy() if args.degrade
                else DegradePolicy(skip_cold=False))
            out["deadline"] = dict(degraded=res.degraded,
                                   skipped=res.skipped_segments)
            print(f"  deadline {args.deadline_ms:.0f}ms: "
                  f"degraded={res.degraded} "
                  f"skipped_segments={res.skipped_segments}")
        st = eng.stats
        print("  " + "  ".join(f"{k}={v:.3f}" for k, v in
                               out["metrics"].items()))
        print(f"  promotions={st['promotions']} demotions="
              f"{st['demotions']} h2d={st['bytes_h2d'] / 1e6:.0f}MB "
              f"hit-rate={st['hits'] / max(st['hits'] + st['misses'], 1):.2f}"
              f" wait={st['wait_s'] * 1e3:.1f}ms retries={st['retries']} "
              f"transfer_errors={st['transfer_errors']} "
              f"worker_restarts={st['worker_restarts']}")
        out["stats"] = dict(st)
        live.pop("engine")
    return out


def _run_static_tenants(args, bench, retriever, stages) -> dict:
    """Static mode over a tenant-partitioned corpus: per-tenant scoped
    searches; tenant filters are data, so one search function serves
    every tenant (asserted with the build counter)."""
    from repro_torch.retrieval import tracing
    from repro_torch.retrieval.store import FilterSpec

    _static_qps(retriever, bench, stages, FilterSpec(tenant=0))   # warm
    warm = tracing.trace_count()
    per_tenant = [_static_qps(retriever, bench, stages, FilterSpec(tenant=t))
                  for t in range(args.tenants)]
    builds = tracing.trace_count() - warm
    qps = ", ".join(f"t{t}={v:.1f}" for t, v in enumerate(per_tenant))
    print(f"{args.stages}-stage x {args.tenants} tenants "
          f"[{retriever.n_docs} docs total]: scoped QPS {qps}  "
          f"tenant-swap builds={builds} (expect 0)")
    return dict(qps=per_tenant, builds=builds)


def _ragged_requests(bench, n_req: int, rng, min_tokens: int = 3) -> list:
    """Single-query requests with RAGGED token counts: each request cuts a
    benchmark query to a random prefix of its valid tokens."""
    reqs = []
    for _ in range(n_req):
        j = int(rng.integers(len(bench.queries)))
        q_len = int(bench.query_mask[j].sum())
        keep = int(rng.integers(min(min_tokens, q_len), q_len + 1))
        reqs.append((bench.queries[j, :keep], bench.query_mask[j, :keep]))
    return reqs


def _run_traffic(args, bench, retriever, stages, live: dict) -> dict:
    """Open-loop Poisson traffic of ragged single queries through the
    shape-bucketed micro-batching frontend; tail latency and QPS."""
    from repro_torch.retrieval import tracing
    from repro_torch.retrieval.frontend import replay_open_loop
    from repro_torch.retrieval.store import FilterSpec

    static_qps = _static_qps(retriever, bench, stages)
    fe = retriever.frontend(stages, max_batch=args.max_batch,
                            max_q=bench.queries.shape[1],
                            flush_ms=args.flush_ms,
                            cache_size=args.result_cache,
                            tenant_quota=args.tenant_quota,
                            deadline_ms=args.deadline_ms)
    live["frontend"] = fe
    live["retriever"] = retriever
    n_warm = fe.warm()
    rate = args.arrival_rate or 0.8 * static_qps
    rng = np.random.default_rng(17)
    reqs = _ragged_requests(bench, args.traffic, rng)
    if args.tenants > 1:
        # scope every request to a random tenant — filters are data, so
        # the mixed-tenant stream reuses the warmed search function
        tenant_of = rng.integers(0, args.tenants, size=len(reqs))
        reqs = [(rq, rm, FilterSpec(tenant=int(t)))
                for (rq, rm), t in zip(reqs, tenant_of)]
    warm_builds = tracing.trace_count()
    served, wall = replay_open_loop(fe, reqs, rate, seed=18)
    builds = tracing.trace_count() - warm_builds

    ok = [p for p in served if p.error is None]
    lat_ms = np.asarray([p.latency for p in ok]) * 1e3
    qps = len(ok) / wall
    p50, p95, p99 = np.percentile(lat_ms, (50, 95, 99))
    st = fe.stats
    tenants = f", {args.tenants} tenants" if args.tenants > 1 else ""
    print(f"traffic [{args.traffic} ragged req, Poisson {rate:.0f}/s, "
          f"buckets B<={fe.max_batch} Q<={fe.max_q} ({n_warm} warmed), "
          f"flush {args.flush_ms:.1f}ms{tenants}] on {retriever.device}:")
    print(f"  p50={p50:.2f}ms  p95={p95:.2f}ms  p99={p99:.2f}ms  "
          f"QPS={qps:.1f} (static fixed-shape QPS={static_qps:.1f}, "
          f"ratio {qps / static_qps:.2f}x)")
    print(f"  dispatches={st['dispatches']}  rows/dispatch="
          f"{st['rows_real'] / max(st['dispatches'], 1):.1f}  "
          f"padded rows={st['rows_padded']}  "
          f"cache hits={st['cache_hits']}  rejected={st['rejected']}  "
          f"shed={st['shed']}  errors={st['errors']}  "
          f"steady-state builds={builds} (expect 0)")
    return dict(p50=p50, p95=p95, p99=p99, qps=qps, static_qps=static_qps,
                builds=builds, stats=dict(st))


def _run_ingest(args, cfg, bench, retriever, stages, quantize) -> dict:
    """Steady-state live-corpus run: ingest batches into preallocated
    segment headroom, search after every batch, count builds.
    ``--ingest-pipeline``: raw pages through the fused
    ``Retriever.ingest``; otherwise ``build_store`` + ``upsert``. The
    timed region starts from the batch's pages in host memory (making
    them is set-up) and ends when the card is done."""
    from repro_torch.retrieval import tracing
    from repro_torch.retrieval.store import build_store, quantize_store

    bs = args.ingest_batch_size
    dev = retriever.device
    q, qm = bench.queries, bench.query_mask
    rng = np.random.default_rng(13)
    tt = bench.token_types

    def make_pages():
        # fresh pages with the same geometry (resampled, jittered real
        # pages stand in for newly ingested PDFs)
        sel = rng.integers(0, len(bench.pages), size=bs)
        return (bench.pages[sel] + 0.05 * rng.normal(
            size=bench.pages[sel].shape)).astype(np.float32)

    def ingest_batch(pages):
        if args.ingest_pipeline:
            return retriever.ingest(pages, tt)            # fused path
        batch = build_store(cfg, pages, tt, device=dev)
        if quantize:
            batch = quantize_store(batch, names=quantize, stages=stages)
        return retriever.upsert(batch)

    # warm-up: one ingest + delete + search
    ids = ingest_batch(make_pages())
    retriever.delete(ids[: max(1, bs // 8)])
    retriever.search(q, qm, stages=stages)
    _sync(dev)
    warm = tracing.trace_count()
    up_dt, search_dt = [], []
    for _ in range(args.ingest_batches):
        pages = make_pages()          # set-up: the host's new pages
        t0 = time.perf_counter()
        ids = ingest_batch(pages)
        _sync(dev)
        up_dt.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        retriever.search(q, qm, stages=stages)
        search_dt.append(time.perf_counter() - t0)
    retriever.delete(ids[: max(1, bs // 8)])
    retriever.search(q, qm, stages=stages)
    builds = tracing.trace_count() - warm
    mode = "fused pipeline" if args.ingest_pipeline else "host build_store"
    pps = bs / np.mean(up_dt)
    qps = len(q) / np.mean(search_dt)
    print(f"ingest [{args.ingest_batches} x {bs} pages into capacity "
          f"{retriever.store.total_capacity}, {mode}] on {dev}: "
          f"{pps:.0f} pages/s, search-after-ingest QPS={qps:.1f}, "
          f"live docs={retriever.n_docs}, "
          f"segments={retriever.store.capacities}, "
          f"steady-state builds={builds} (expect 0)")
    return dict(pages_per_s=pps, qps=qps, builds=builds)


def main(argv=None) -> dict:
    """Parse ``argv``, run one mode, return its numbers. A SIGTERM/SIGINT
    during the run ends in the graceful shutdown (its report returned),
    and the previous signal handlers are put back either way."""
    previous = _install_signals()
    live: dict = {}
    try:
        return _main(argv, live)
    except _Shutdown as e:
        args = live.get("args")
        if args is None:
            raise
        return _graceful_exit(args, live, str(e))
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)


def _main(argv, live: dict) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import multistage as MST
    from repro_torch.data.synthetic import make_benchmark
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.retrieval.ingest import (PRODUCED_NDIM, IngestPipeline,
                                              batch_bucket)
    from repro_torch.retrieval.retriever import Retriever
    from repro_torch.retrieval.segments import bucket_capacity
    from repro_torch.training.checkpoint import latest_step

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="colpali")
    ap.add_argument("--pages", type=int, default=300)
    ap.add_argument("--queries", type=int, default=60)
    ap.add_argument("--stages", type=int, default=2, choices=(1, 2, 3))
    ap.add_argument("--prefetch-k", type=int, default=256)
    ap.add_argument("--top-k", type=int, default=100)
    ap.add_argument("--use-kernel", action="store_true",
                    help="score the scan stage with the CUDA MaxSim scan "
                         "kernel and pool with the fused pooling kernel")
    ap.add_argument("--rerank-kernel", action="store_true",
                    help="score rerank stages with the fused gather + "
                         "MaxSim kernel (no [B, L, D, d] candidate copy)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="scan-stage corpus chunk (0 = unchunked)")
    ap.add_argument("--scan-topk", action="store_true",
                    help="stream a running per-query top-k across scan "
                         "chunks instead of assembling the [B, N] score "
                         "matrix")
    ap.add_argument("--int8", action="store_true",
                    help="int8-quantise the scan-stage vectors")
    ap.add_argument("--n-clusters", type=int, default=0,
                    help="enable IVF centroid routing: cluster each "
                         "segment's routing vectors into this many "
                         "clusters (k-means at index time, maintained "
                         "through every write, delete and compact)")
    ap.add_argument("--n-probe", type=int, default=0,
                    help="clusters probed per query by the routed scan "
                         "stage (requires --n-clusters; n-probe == "
                         "n-clusters recovers the exhaustive candidates)")
    ap.add_argument("--ingest-batches", type=int, default=0,
                    help="dynamic-corpus mode: ingest this many batches "
                         "into preallocated headroom, measuring steady-"
                         "state ingestion and search-after-ingest")
    ap.add_argument("--ingest-batch-size", type=int, default=32)
    ap.add_argument("--ingest-pipeline", action="store_true",
                    help="ingest raw pages through the fused "
                         "Retriever.ingest instead of host-driven "
                         "build_store + upsert")
    ap.add_argument("--capacity", type=int, default=0,
                    help="preallocated corpus capacity (0 = bucketed "
                         "power of two over the expected total)")
    ap.add_argument("--traffic", type=int, default=0,
                    help="streaming-traffic mode: replay this many Poisson-"
                         "arriving ragged single queries through the "
                         "micro-batching frontend; p50/p95/p99 latency")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="offered load in req/s (0 = 0.8x the measured "
                         "fixed-shape static QPS)")
    ap.add_argument("--flush-ms", type=float, default=2.0,
                    help="micro-batch deadline: flush when the oldest "
                         "queued request has waited this long")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="micro-batch row cap (= largest batch bucket)")
    ap.add_argument("--result-cache", type=int, default=0,
                    help="LRU result-cache entries (0 = off)")
    ap.add_argument("--tenants", type=int, default=0,
                    help="multi-tenant mode: split the corpus round-robin "
                         "across this many tenants and scope requests "
                         "with FilterSpec")
    ap.add_argument("--tenant-quota", type=int, default=0,
                    help="max queued rows per tenant in the traffic "
                         "frontend (0 = unlimited)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request wall budget: queued traffic requests "
                         "past it are shed; a tiered search over it serves "
                         "resident segments only with --degrade "
                         "(0 = no deadline)")
    ap.add_argument("--snapshot-dir", default="",
                    help="persist the indexed corpus here, or cold-start "
                         "from the snapshot it already holds (no "
                         "re-ingest; static mode)")
    ap.add_argument("--hbm-budget", type=int, default=0,
                    help="tiered mode (static): cap device-resident "
                         "segment bytes at this budget, spill cold "
                         "segments to pinned host memory, report QPS with "
                         "async prefetch and with synchronous fetch")
    ap.add_argument("--degrade", action="store_true",
                    help="with --deadline-ms and --hbm-budget: skip cold "
                         "segments under deadline pressure (results "
                         "flagged degraded) instead of blocking on them")
    ap.add_argument("--fault-plan", default="",
                    help="arm the deterministic fault injector on the "
                         "tiered engine (FaultPlan.parse spec, e.g. "
                         "'transfer_fail_rate=0.05,kill_worker_at=3,"
                         "seed=7')")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    live["args"] = args

    cfg = get_config(args.arch)
    per = max(args.pages // 3, 30)
    qper = max(args.queries // 3, 10)
    bench = make_benchmark(cfg, (per, per, per), (qper, qper, qper))

    stages = {1: MST.one_stage(args.top_k),
              2: MST.two_stage(args.prefetch_k, args.top_k),
              3: MST.three_stage(4 * args.prefetch_k, args.prefetch_k,
                                 args.top_k)}[args.stages]
    stages = MST.with_scan_policy(stages, use_kernel=args.use_kernel,
                                  chunk=args.chunk, scan_topk=args.scan_topk)
    stages = MST.with_rerank_policy(stages,
                                    rerank_kernel=args.rerank_kernel)
    if args.n_probe > 0:
        if args.n_clusters <= 0:
            ap.error("--n-probe needs --n-clusters")
        stages = MST.with_routing_policy(stages, n_probe=args.n_probe,
                                         n_clusters=args.n_clusters)
    quantize = ()
    if args.int8:
        # quantise the vector the scan stage scores; a single-vector scan
        # (3-stage global_pooling) has nothing worth quantising. Passing
        # the stages drops the float copy when no later stage reranks
        # with the scan vector, so int8 shrinks that vector's bytes
        scan_vec = stages[0].vector
        if PRODUCED_NDIM[scan_vec] == 3:
            quantize = (scan_vec,)
        else:
            print(f"--int8: scan stage '{scan_vec}' is single-vector; "
                  "skipping quantisation")

    static = (args.traffic == 0 and args.ingest_batches == 0
              and args.tenants <= 1)
    if static and args.snapshot_dir and \
            latest_step(args.snapshot_dir) is not None:
        t0 = time.perf_counter()
        retriever = Retriever.from_snapshot(args.snapshot_dir,
                                            device=device)
        _sync(device)
        print(f"cold-start: restored {retriever.n_docs} pages from "
              f"{args.snapshot_dir} in {time.perf_counter() - t0:.2f}s "
              "(bit for bit the saved corpus; no re-ingest)")
        return _run_static(args, bench, retriever, stages, bool(quantize),
                           live)
    n = len(bench.pages)
    total = n
    if args.ingest_batches > 0:
        # the warm-up batch and the timed ones, and a full bucket of tail
        # room for the fused path's bucket-wide copy
        total += (args.ingest_batches + 1) * args.ingest_batch_size + \
            batch_bucket(args.ingest_batch_size)
    t0 = time.perf_counter()
    pipe = IngestPipeline.for_config(
        cfg, use_kernel=args.use_kernel, quantize=quantize,
        stages=stages if quantize else None, device=device)
    # tenant t owns pages t, t+T, ... (one tenant: every page); each
    # tenant's pages go in 256-page batches through the fused ingest
    n_tenants = max(args.tenants, 1)
    step = 256
    retriever = None
    for tenant in range(n_tenants):
        part = bench.pages[tenant::n_tenants]
        for i in range(0, len(part), step):
            pages = part[i:i + step]
            if retriever is None:                 # seed batch = tenant 0
                # --chunk is also the retriever's default scan chunk, as
                # in repro's traffic and ingest modes (the stages set it
                # already, so results do not change)
                retriever = Retriever(
                    pipe.index(pages, bench.token_types),
                    capacity=args.capacity or bucket_capacity(total),
                    device=device, routing=args.n_clusters or None,
                    ingest=pipe, scan_chunk=args.chunk)
            else:
                retriever.ingest(pages, bench.token_types, tenant=tenant)
    _sync(device)
    print(f"indexed {retriever.n_docs} pages in {time.perf_counter()-t0:.2f}s"
          f" (named vectors: {sorted(retriever.store.dims())}, pooling "
          f"{pipe.pool_path})")
    if args.traffic > 0:
        return _run_traffic(args, bench, retriever, stages, live)
    if args.ingest_batches > 0:
        return _run_ingest(args, cfg, bench, retriever, stages, quantize)
    if args.snapshot_dir:
        t0 = time.perf_counter()
        path = retriever.snapshot(args.snapshot_dir)
        print(f"snapshot -> {path} ({time.perf_counter() - t0:.2f}s; "
              "run again with the same --snapshot-dir to cold-start from "
              "it)")
    return _run_static(args, bench, retriever, stages, bool(quantize), live)


if __name__ == "__main__":
    main()
