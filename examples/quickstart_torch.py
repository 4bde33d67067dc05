"""Quickstart on the PyTorch/CUDA port: index synthetic pages, run 1-/2-/3-
stage visual retrieval.

    PYTHONPATH=src python examples/quickstart_torch.py             # on cuda
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

``examples/quickstart.py`` step for step, on ``repro_torch``: synthetic
pages (with blank margins + special/padding tokens) -> cropping -> token
hygiene -> model-aware pooling -> named-vector store -> multi-stage
MaxSim search through the ``Retriever`` facade -> metrics — then mutates
the live corpus (upsert + delete into preallocated segment headroom)
without building a new search function. The cascades ask for the scan
and gather-rerank kernels: on the card they launch the CUDA kernels, on
the CPU the wrappers run their plain PyTorch versions.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import multistage as MST
from repro_torch.core.cropping import crop_box
from repro_torch.data.synthetic import (evaluate_ranking, make_benchmark,
                                        make_page_image)
from repro_torch.retrieval import tracing
from repro_torch.retrieval.retriever import Retriever
from repro_torch.retrieval.segments import bucket_capacity
from repro_torch.retrieval.store import build_store


def kernels(stages: tuple) -> tuple:
    """``stages`` through the scan and gather-rerank kernel wrappers."""
    return MST.with_rerank_policy(
        MST.with_scan_policy(stages, use_kernel=True), rerank_kernel=True)


CASCADES = (("1-stage exact", kernels(MST.one_stage(10))),
            ("2-stage (K=128)", kernels(MST.two_stage(128, 10))),
            ("3-stage cascade", kernels(MST.three_stage(256, 128, 10))))


def split(total: int, shares=(120, 100, 80)) -> tuple:
    """``total`` split over three datasets in the quickstart's 120:100:80
    proportion (exactly (120, 100, 80) for 300)."""
    first = [total * s // sum(shares) for s in shares[:-1]]
    return tuple(first) + (total - sum(first),)


def main(argv=None) -> dict:
    """Run the quickstart; returns {cascade name: metrics}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--pages", type=int, default=300,
                    help="corpus size, split 120:100:80 over 3 datasets")
    ap.add_argument("--queries", type=int, default=75,
                    help="queries, split evenly over the 3 datasets")
    args = ap.parse_args(argv)
    dev = args.device
    rng = np.random.default_rng(0)

    # 1. preprocessing demo: empty-region cropping on a rendered page
    img, true_box = make_page_image(rng)
    box = crop_box(img, std_thresh=0.02, page_number_strip=0.05)
    print(f"[crop] content box {box} (true margins {true_box})")

    # 2. build a 3-dataset corpus + queries with known relevance
    cfg = get_config("colpali")
    nq = args.queries // 3
    bench = make_benchmark(cfg, n_pages_per_ds=split(args.pages),
                           queries_per_ds=(nq, nq, args.queries - 2 * nq))
    print(f"[data] {bench.pages.shape[0]} pages x {bench.pages.shape[1]} "
          f"tokens, {len(bench.queries)} queries")

    # 3. index: hygiene + model-aware pooling into named vectors, owned by
    #    a Retriever with ingestion headroom (capacity-padded segment)
    store = build_store(cfg, bench.pages, bench.token_types, device=dev)
    retriever = Retriever(store, capacity=bucket_capacity(args.pages + 32),
                          device=dev)
    print(f"[index] named vectors: "
          + ", ".join(f"{k}[D={v}]" for k, v in retriever.store.dims().items())
          + f"; capacity {retriever.store.total_capacity}")

    # 4. search: 1-stage exact vs 2-stage (pooled prefetch) vs 3-stage
    q, qm = bench.queries, bench.query_mask
    results = {}
    for name, stages in CASCADES:
        _, ids = retriever.search(q, qm, stages=stages)
        m = evaluate_ranking(ids, bench.qrels, ks=(5, 10))
        results[name] = m
        print(f"[search] {name:18s} " +
              "  ".join(f"{k}={v:.3f}" for k, v in m.items()))

    # 5. live corpus: upsert new pages / delete old ones — the layout is
    #    capacity-stable, so the search function is reused, not rebuilt
    def batch_of(seed):
        extra = bench.pages[:16] + 0.05 * np.random.default_rng(
            seed).normal(size=bench.pages[:16].shape)
        return build_store(cfg, extra.astype(np.float32), bench.token_types,
                           device=dev)

    two = CASCADES[1][1]
    ids = retriever.upsert(batch_of(1))          # warm the write path
    retriever.delete(ids[:8])
    retriever.search(q, qm, stages=two)
    traces = tracing.trace_count()
    ids = retriever.upsert(batch_of(2))          # steady state
    retriever.delete(ids[:8])
    retriever.search(q, qm, stages=two)
    print(f"[mutate] upserted 2x16, deleted 2x8 -> {retriever.n_docs} live "
          f"docs; steady-state retraces: {tracing.trace_count() - traces}")
    return results


if __name__ == "__main__":
    main()
