"""Readings for a cell's correctness limits: the program's and the
control's, over many seeds in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,13 \
        --seconds 2 [--control 3]

Each seed is a whole run at the cell's sizes and load with a short
window (set-up, window, the reference over the sampled answers); the
first ``--control`` seeds also run the control: the reference in the
program's place with its operands rounded to TF32. Prints one JSON line
a seed, then the largest program reading and the smallest control
reading of each compared number. ``limits/<cell>.json`` is set from
these, between the two, as PERF.md records.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness as H                  # noqa: E402
from perfbench.reference import NUMBERS             # noqa: E402


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    H.prepare_env()
    cell = H.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    prog, ctrl = {n: [] for n in NUMBERS}, {n: [] for n in NUMBERS}
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        out = H.run_cell(cell, seed, args.seconds, False, t0,
                         control=i < args.control)
        line = {"seed": seed,
                "program": {n: out["checks"][n]["value"] for n in NUMBERS},
                "unanswered": out["checks"]["unanswered"]["value"],
                "control": out.get("control"),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        for n in NUMBERS:
            prog[n].append(line["program"][n])
            if line["control"]:
                ctrl[n].append(line["control"][n])
    print(json.dumps({"program_max": {n: max(v) for n, v in prog.items()},
                      "control_min": {n: min(v) if v else None
                                      for n, v in ctrl.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
