"""Corpus-size scaling study on the port (paper §5: the 2x -> 4x QPS
trend).

1-stage cost grows linearly with N; 2-stage rerank is capped at K. This
sweeps N and reports the measured speedup alongside the Eq.-1 prediction.

    PYTHONPATH=src python examples/scaling_study_torch.py         # on cuda
    PYTHONPATH=src python examples/scaling_study_torch.py --device cpu

``examples/scaling_study.py`` on ``repro_torch``: the raw-store search
function ``make_search_fn`` with the scan and gather-rerank kernels, timed
with ``torch.cuda.synchronize()`` around the loop on the card.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.core import multistage as MST
from repro_torch.data.synthetic import make_benchmark
from repro_torch.retrieval.engine import make_search_fn
from repro_torch.retrieval.store import build_store


def qps(fn, vectors, q, qm) -> float:
    sync = (torch.cuda.synchronize if q.device.type == "cuda"
            else lambda: None)
    fn(vectors, q, qm)                                  # warm-up
    sync()
    t0 = time.perf_counter()
    for _ in range(3):
        fn(vectors, q, qm)
    sync()
    return len(q) / ((time.perf_counter() - t0) / 3)


def kernels(stages: tuple) -> tuple:
    return MST.with_rerank_policy(
        MST.with_scan_policy(stages, use_kernel=True), rerank_kernel=True)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--sizes", type=int, nargs="+", default=(40, 80, 160),
                    help="pages per dataset (3 datasets) of each corpus")
    args = ap.parse_args(argv)
    cfg = get_config("colpali")
    print(f"{'N pages':>8s} {'1-stage QPS':>12s} {'2-stage QPS':>12s} "
          f"{'speedup':>8s} {'Eq.1 pred':>9s}")
    rows = []
    for per_ds in args.sizes:
        bench = make_benchmark(cfg, (per_ds,) * 3, (20, 20, 20), seed=11)
        store = build_store(cfg, bench.pages, bench.token_types,
                            device=args.device)
        q = torch.as_tensor(bench.queries).to(store.device)
        qm = torch.as_tensor(bench.query_mask).to(store.device)
        n = store.n_docs
        k = 64
        q1 = qps(make_search_fn(kernels(MST.one_stage(10)), n),
                 store.vectors, q, qm)
        q2 = qps(make_search_fn(kernels(MST.two_stage(k, 10)), n),
                 store.vectors, q, qm)
        dims = store.dims()
        pred = (n * dims["initial"]) / (n * dims["mean_pooling"]
                                        + k * dims["initial"])
        print(f"{n:8d} {q1:12.1f} {q2:12.1f} {q2/q1:8.2f} {pred:9.2f}")
        rows.append((n, q1, q2, pred))
    return rows


if __name__ == "__main__":
    main()
