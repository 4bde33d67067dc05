"""Serving launcher: index a corpus, run batched multi-stage search.

    PYTHONPATH=src python -m repro_torch.launch.serve --pages 4096 \
        --stages 2 --use-kernel --rerank-kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --pages 4096 \
        --stages 1 --use-kernel --chunk 256 --int8 [--scan-topk]
    PYTHONPATH=src python -m repro_torch.launch.serve --pages 4096 \
        --stages 2 --n-clusters 64 --n-probe 8 --use-kernel --rerank-kernel

Builds the synthetic benchmark for ``--arch``, indexes it through the
``IngestPipeline`` (``--use-kernel`` also routes the pooling to the fused
CUDA kernel), serves it with a ``Retriever`` and prints QPS and
NDCG/Recall@5/10 for one cascade. ``--use-kernel`` scores the scan stage
with the CUDA MaxSim scan kernel, ``--rerank-kernel`` the rerank stages
with the fused gather + MaxSim kernel. ``--chunk`` bounds the plain scan's
per-call corpus tile; with ``--use-kernel`` it selects the double-buffered
scan kernel (one launch). ``--int8`` quantises the scan stage's vector at
index time and drops its float copy when no later stage reranks on it;
``--scan-topk`` streams a running top-k across scan chunks instead of
assembling the [B, N] scores. ``--n-clusters`` clusters the corpus for
IVF routing and ``--n-probe`` routes the scan stage through that many
clusters per query (with ``--use-kernel``: the scan kernel on the
centroids, the gather-rerank kernel on the probed members). Runs on
``--device cuda`` (the default; without a card it raises) or ``--device
cpu``, where every kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import argparse
import time

import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_static(args, bench, retriever, stages, int8_on: bool) -> dict:
    """Time the cascade over the whole query set (one search call, warmed
    once, timed three times) and score the ranking; prints and returns
    QPS and the metrics."""
    from repro_torch.data.synthetic import evaluate_ranking

    q, qm = bench.queries, bench.query_mask
    dev = retriever.device
    retriever.search(q, qm, stages=stages)                    # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(3):
        # time raw dispatch (slot ids on the device); translate once below
        retriever.search(q, qm, stages=stages, translate_ids=False)
    _sync(dev)
    qps = len(q) / ((time.perf_counter() - t0) / 3)
    _, ids = retriever.search(q, qm, stages=stages)
    metrics = evaluate_ranking(ids, bench.qrels, ks=(5, 10))
    scan = ("kernel" if args.use_kernel else "ref") + \
        (f"/chunk={args.chunk}" if args.chunk else "") + \
        ("/int8" if int8_on else "") + \
        ("/scan-topk" if args.scan_topk else "") + \
        (f"/n-probe={args.n_probe}of{args.n_clusters}" if args.n_probe
         else "") + \
        ("/rerank-kernel" if args.rerank_kernel else "")
    print(f"{args.stages}-stage [{scan}] on {dev}: QPS={qps:.1f}  " +
          "  ".join(f"{k}={v:.3f}" for k, v in metrics.items()))
    return dict(qps=qps, **metrics)


def main(argv=None) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import multistage as MST
    from repro_torch.data.synthetic import make_benchmark
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.retrieval.ingest import PRODUCED_NDIM, IngestPipeline
    from repro_torch.retrieval.retriever import Retriever
    from repro_torch.retrieval.segments import bucket_capacity

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
                         "through upsert and delete)")
    ap.add_argument("--n-probe", type=int, default=0,
                    help="clusters probed per query by the routed scan "
                         "stage (requires --n-clusters; n-probe == "
                         "n-clusters recovers the exhaustive candidates)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

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

    t0 = time.perf_counter()
    pipe = IngestPipeline(cfg, use_kernel=args.use_kernel, quantize=quantize,
                          stages=stages if quantize else None, device=device)
    step = 256
    n = len(bench.pages)
    retriever = Retriever(pipe.index(bench.pages[:step], bench.token_types),
                          capacity=bucket_capacity(n), device=device,
                          routing=args.n_clusters or None)
    for i in range(step, n, step):
        pipe.ingest(retriever.store, bench.pages[i:i + step],
                    bench.token_types)
    _sync(device)
    print(f"indexed {retriever.n_docs} pages in {time.perf_counter()-t0:.2f}s"
          f" (named vectors: {sorted(retriever.store.dims())})")
    return _run_static(args, bench, retriever, stages, bool(quantize))


if __name__ == "__main__":
    main()
