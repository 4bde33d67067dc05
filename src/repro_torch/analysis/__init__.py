"""Static contract auditor of the port: the serving contracts that the
tests and ``chip_smoke.py`` check only where they happen to run, checked
over the whole package and over the built serving bodies.

The port's serving stack rests on the contracts of the JAX package,
translated to eager PyTorch:

- **no steady-state builds** — every body builder (a function that
  builds and returns a serving or ingest closure: ``engine``'s search
  builders, cached by ``Retriever.search_fn`` and
  ``tiering.TieredEngine``) calls
  ``repro_torch.retrieval.tracing.record_trace()``, so the runtime
  counter sees each build;
- **observed kernel launches** — every wrapper that launches a CUDA
  kernel calls ``repro_torch.kernels.dispatch.record(name)`` with a name
  of ``dispatch.KERNELS``, so a run can show its path went through the
  kernels;
- **no host waits and int8/memory discipline** — a serving body never
  makes the host wait for the device, the quantised corpus is never
  shadowed by a full-corpus float copy, and scan intermediates stay
  chunked.

Two layers check them:

- ``astlint`` + ``rules`` — AST rules R1–R5 over ``src/repro_torch/``:
  builder -> ``record_trace`` reachability, launch -> ``record``
  coverage, host-sync idioms in body scope and serving modules, vector-key
  suffix literals, import-time tensor construction.
- ``op_audit`` — runs each representative scenario's real body once
  under a ``TorchDispatchMode`` and walks every ATen op: full-corpus int8
  upcasts (D1), op outputs over a bytes budget (D2), host waits (D3), and
  a second call on other values that must build nothing and dispatch the
  same ops (D4).

Findings are stable fingerprints gated against ``baseline.json`` (an
explicit allowlist, empty by policy). CLI::

    PYTHONPATH=src python -m repro_torch.analysis --check --device cpu

Inline exemptions: a ``# audit: allow-R3 <reason>`` comment on the
finding's line (or the line above) suppresses that rule there; the
reason is part of the review surface.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class Finding:
    """One contract violation.

    ``fingerprint`` is the gate identity: rule + path + a stable symbol
    anchor (qualname / literal / op), NOT the line number — so a baseline
    entry survives unrelated edits to the file.
    """
    rule: str      # "R1".."R5" (AST) or "D1".."D4" (op audit)
    path: str      # repo-relative path, or "<ops:scenario>" pseudo-path
    line: int      # 1-based; 0 when the anchor is not a source line
    symbol: str    # stable anchor within (rule, path)
    message: str

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.path}:{self.symbol}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "symbol": self.symbol, "message": self.message,
                "fingerprint": self.fingerprint}


def dedupe(findings: list) -> list:
    seen, out = set(), []
    for f in findings:
        key = (f.fingerprint, f.line)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def load_baseline(path: Path | str) -> set:
    """The allowlist: a JSON file ``{"allow": [fingerprint, ...]}``."""
    p = Path(path)
    if not p.exists():
        return set()
    data = json.loads(p.read_text())
    return set(data.get("allow", []))


def apply_baseline(findings: list, allow: set) -> tuple:
    """Split findings into (gated, baselined). Gated findings fail the
    check; baselined ones are reported but allowed."""
    gated = [f for f in findings if f.fingerprint not in allow]
    baselined = [f for f in findings if f.fingerprint in allow]
    return gated, baselined
