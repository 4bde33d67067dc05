"""Serve a randomly initialised retriever's corpus with batched requests
through the port's ``Retriever`` facade, including the Matryoshka
stage-1 variant (a beyond-paper lever), on ColQwen geometry.

    PYTHONPATH=src python examples/serve_multistage_torch.py      # on cuda
    PYTHONPATH=src python examples/serve_multistage_torch.py --device cpu

``examples/serve_multistage.py`` on ``repro_torch``. The facade owns the
segmented corpus and caches one search function per stages config; each
cascade asks for the scan and gather-rerank kernels (the CUDA kernels on
the card, their plain versions on the CPU), and each timed loop ends in
``torch.cuda.synchronize()`` on the card.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.core import multistage as MST
from repro_torch.core.matryoshka import add_truncated_stage
from repro_torch.data.synthetic import evaluate_ranking, make_benchmark
from repro_torch.retrieval.retriever import Retriever
from repro_torch.retrieval.store import VectorStore, build_store


def bench_config(name, stages, retriever, q, qm, qrels) -> dict:
    stages = MST.with_rerank_policy(
        MST.with_scan_policy(stages, use_kernel=True), rerank_kernel=True)
    retriever.search(q, qm, stages=stages)            # warm-up
    sync = (torch.cuda.synchronize if retriever.device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(3):
        # time raw dispatch (device slot ids); translate once for metrics
        retriever.search(q, qm, stages=stages, translate_ids=False)
    sync()
    dt = (time.perf_counter() - t0) / 3
    _, ids = retriever.search(q, qm, stages=stages)
    m = evaluate_ranking(ids, qrels, ks=(5, 10))
    print(f"{name:28s} QPS={len(q)/dt:7.1f}  "
          + "  ".join(f"{k}={v:.3f}" for k, v in m.items()))
    return m


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config("colqwen")
    bench = make_benchmark(cfg, (150, 120, 100), (30, 30, 30), seed=7)
    store = build_store(cfg, bench.pages, bench.token_types,
                        device=args.device)
    q, qm = bench.queries, bench.query_mask
    # add a truncated (Matryoshka) prefetch vector alongside the named set
    vecs = add_truncated_stage(store.vectors, "mean_pooling", 32)
    retriever = Retriever(VectorStore(vecs, store.n_docs, store.store_dtype),
                          device=args.device)

    print(f"corpus: {retriever.n_docs} pages ({cfg.name} geometry) on "
          f"{retriever.device}")
    out = {}
    for name, stages in (
            ("1-stage exact", MST.one_stage(10)),
            ("2-stage pooled", MST.two_stage(128, 10)),
            ("3-stage cascade", MST.three_stage(256, 128, 10)),
            ("2-stage pooled+MRL32 (ours)",
             (MST.Stage("mean_pooling_mrl32", 128), MST.Stage("initial", 10)))):
        out[name] = bench_config(name, stages, retriever, q, qm, bench.qrels)
    return out


if __name__ == "__main__":
    main()
