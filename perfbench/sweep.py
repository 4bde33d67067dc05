"""The open-loop cell's rate sweep: the highest rate the system sustains,
found once on the card; the cell's traffic file then fixes its rate at
about four fifths of it.

    python3 perfbench/sweep.py --workload <open cell> --seed 7 \
        --rates 100,200,300 --seconds 10

One set-up, then each rate for ``--seconds``: completed requests a
second, p50 and p95 latency from the scheduled arrival, and the median
latency of the last fifth of the arrivals over that of the middle fifth
(a growing backlog reads well above 1).
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness as H                  # noqa: E402


def main(argv) -> int:
    import argparse
    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    H.prepare_env()
    from perfbench import corpus as C
    from perfbench import trace as T
    from perfbench import traffic as TR
    cell = H.load_cell(args.workload)
    tr = cell.traffic
    dev = torch.device("cuda", 0)
    retriever, spec, tab = H.build(cell, args.seed, dev, T.Spans(False))
    queries = C.queries(spec, args.seed, tab, int(tr["pool"]),
                        int(tr["q_slots"]), tuple(tr["q_valid"]))
    fe = retriever.frontend(H.program_stages(tr), **tr["frontend"])
    fe.warm()
    qn = queries.q.cpu().numpy()
    lens = queries.lengths.cpu().numpy()
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        arr = TR.arrivals(args.seed + i, rate, args.seconds)
        fe.stats = {k: 0 for k in fe.stats}
        t0 = time.perf_counter()
        pend, span, late = H.open_loop(fe, qn, lens, arr, T.Spans(False))
        lat = np.array([p.t_done - p.t_submit for p in pend])
        n = len(lat)
        mid = np.median(lat[2 * n // 5:3 * n // 5])
        last = np.median(lat[4 * n // 5:])
        print(json.dumps({
            "rate": rate, "requests": n, "served_per_s": n / span,
            "p50_ms": 1e3 * TR.nearest_rank(lat, 0.5),
            "p95_ms": 1e3 * TR.nearest_rank(lat, 0.95),
            "last_over_mid": float(last / mid),
            "rows_per_dispatch": fe.stats["rows_real"]
            / max(fe.stats["dispatches"], 1),
            "late_max_ms": 1e3 * float(np.max(late)),
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
