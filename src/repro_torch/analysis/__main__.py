"""CLI for the port's static contract auditor.

    PYTHONPATH=src python -m repro_torch.analysis --check [--device cpu]

Exit code 0 when every finding is baselined (the shipped baseline is
empty), 1 when any non-baselined finding exists, 2 without ``--check``.
The op layer runs on the card by default and raises without one;
``--device cpu`` runs the plain versions, ``--no-ops`` the AST layer
alone (no device). The JSON report is written regardless of outcome,
by default to ``build/repro_torch/contract_audit.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import apply_baseline, load_baseline
from repro_torch.analysis.astlint import lint_tree


def _repo_root() -> Path:
    # src/repro_torch/analysis/__main__.py -> repo root
    return Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST lint + op audit of the port's serving contracts")
    ap.add_argument("--check", action="store_true",
                    help="run both layers and gate against the baseline")
    ap.add_argument("--no-ops", action="store_true",
                    help="skip the op audit layer (AST only, no device)")
    ap.add_argument("--src", default=None,
                    help="source root holding the repro_torch package "
                         "(default: <repo>/src)")
    ap.add_argument("--baseline", default=None,
                    help="allowlist JSON (default: analysis/baseline.json)")
    ap.add_argument("--report", default=None,
                    help="where to write the findings JSON (default: "
                         "build/repro_torch/contract_audit.json)")
    ap.add_argument("--device", default="cuda",
                    help="device of the op audit's scenarios: cuda "
                         "(default; the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)
    if not args.check:
        ap.print_help()
        return 2

    root = _repo_root()
    src = Path(args.src) if args.src else root / "src"
    baseline_path = Path(args.baseline) if args.baseline else \
        Path(__file__).parent / "baseline.json"
    report_path = Path(args.report) if args.report else \
        root / "build" / "repro_torch" / "contract_audit.json"

    findings = lint_tree(src, repo_root=root)
    metrics: dict = {}
    if not args.no_ops:
        from repro_torch.analysis.op_audit import run_op_audit
        of, metrics = run_op_audit(device=args.device)
        findings.extend(of)

    allow = load_baseline(baseline_path)
    gated, baselined = apply_baseline(findings, allow)

    report = {
        "gated": [f.to_json() for f in gated],
        "baselined": [f.to_json() for f in baselined],
        "op_metrics": metrics,
        "n_gated": len(gated),
        "n_baselined": len(baselined),
    }
    report_path.parent.mkdir(parents=True, exist_ok=True)
    report_path.write_text(json.dumps(report, indent=2, sort_keys=True))

    for f in gated:
        loc = f"{f.path}:{f.line}" if f.line else f.path
        print(f"FAIL {f.rule} {loc} [{f.symbol}]\n     {f.message}")
    for f in baselined:
        print(f"allow {f.rule} {f.path} [{f.symbol}]")
    for name, m in sorted(metrics.items()):
        print(f"ops {name}: max_live={m['max_live_bytes'] / 2**20:.2f}MiB "
              f"({m['max_live_op']}) budget="
              f"{m['budget_bytes'] / 2**20:.0f}MiB ops={m['n_ops']} "
              f"syncs={m['syncs']}")
    print(f"contract audit: {len(gated)} gated finding(s), "
          f"{len(baselined)} baselined -> {report_path}")
    return 1 if gated else 0


if __name__ == "__main__":
    sys.exit(main())
