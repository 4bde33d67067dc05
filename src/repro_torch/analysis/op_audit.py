"""Op audit layer: run the real serving and ingest bodies once under a
``TorchDispatchMode`` and walk every ATen op, for what no AST rule sees.

The AST layer proves call-graph properties; this layer checks what the
bodies actually ask the device for. It builds what ``Retriever``,
``tiering.TieredEngine`` and ``IngestPipeline`` serve — small
representative scenarios on the builders' own code paths — runs each
body under the op counter's mode (``launch.op_analysis._Mode``, the one
op walker of the port) and checks every op:

D1  an int8 tensor converted to f32/f64 (``_to_copy``, ``copy_`` into a
    float tensor, or any op mixing an int8 input into a float output)
    with >= 2 dims and a leading dimension >= the corpus rows — the
    full-corpus shadow of the quantised store. The chunked dequant
    (``chunk`` rows at a time) passes.
D2  an op's output bytes (a new storage; views and in-place results make
    none) over the scenario's budget — a ``[B, N, Q, D]``-style
    broadcast blow-up.
D3  a host wait inside the body: ``_local_scalar_dense`` (``.item()``,
    ``int()``/``bool()`` of a tensor), an op whose output shape depends
    on data (``nonzero``, ``masked_select``, ``unique*``, a bool index,
    ``repeat_interleave`` without ``output_size``), or on the card a
    blocking copy between the host and the card.
D4  a second call on inputs that differ only in values (another query
    batch; another segment offset for the tiered body) must add 0 to
    ``tracing.trace_count()`` and dispatch the same op sequence: a
    Python branch on a tensor value changes it.

A kernel's ctypes launch is invisible to the mode; the torch ops around
it, and the allocation of its outputs, are not. On the CPU the wrappers
run their plain versions; on the card (``device="cuda"``) the scenarios
take the kernels: the scan stages ``use_kernel`` and the rerank stages
``rerank_kernel`` where noted, and ingest the pooling kernel.

Each scenario also reports its ``max_live_bytes`` (the largest single op
output) so budget drift shows in the report while under budget.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from dataclasses import dataclass

import torch

from repro_torch.analysis import Finding
from repro_torch.kernels import dispatch as DSP
from repro_torch.launch.op_analysis import _Mode, _nbytes, _storage, _tensors
from repro_torch.retrieval import tracing

_UPCAST = (torch.float32, torch.float64)
# ops whose output shape depends on data: the host reads a count back
_DATA_SHAPED = ("nonzero", "masked_select", "_unique", "_unique2", "unique",
                "unique_dim", "unique_consecutive", "unique_dim_consecutive")
_COPIES = ("_to_copy", "copy_")


def _shapes(ts) -> list:
    return [tuple(int(s) for s in t.shape) for t in ts]


class OpAuditor:
    """Walks the ops of one body call (``with OpAuditor(...):``), checks
    D1-D3 as they run and keeps the op sequence for D4."""

    def __init__(self, label: str, corpus_rows: int, budget_bytes: int):
        self.label = label
        self.corpus_rows = corpus_rows
        self.budget_bytes = budget_bytes
        self.path = f"<ops:{label}>"
        self.findings: list = []
        self.ops: list = []
        self.max_live, self.max_desc = 0, ""
        self.syncs = 0
        self._mode = None

    def __enter__(self):
        self._mode = _Mode(self, None)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        return False

    def _find(self, rule: str, symbol: str, message: str) -> None:
        self.findings.append(Finding(rule, self.path, 0, symbol, message))

    def _op(self, func, args, kwargs, out, position) -> None:
        name = func._overloadpacket.__name__
        self.ops.append(str(func))
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_st = {id(s) for s in map(_storage, ins) if s is not None}
        new = [] if func.is_view else [
            t for t in outs if (s := _storage(t)) is not None
            and id(s) not in in_st]
        out_bytes = sum(_nbytes(t) for t in new)
        if out_bytes > self.max_live:
            self.max_live = out_bytes
            self.max_desc = f"{func}{_shapes(new)}"
        # D1: an int8 operand lifted to f32/f64 at full-corpus shape
        if any(t.dtype == torch.int8 for t in ins):
            for t in outs:
                if t.dtype in _UPCAST and t.dim() >= 2 \
                        and int(t.shape[0]) >= self.corpus_rows:
                    shape = tuple(int(s) for s in t.shape)
                    self._find(
                        "D1", f"int8_upcast:{shape}",
                        f"{self.label}: {func} makes {t.dtype} {shape} from "
                        f"an int8 operand at full-corpus shape (corpus_rows"
                        f"={self.corpus_rows}) — the float shadow of the "
                        "quantised store")
        # D2: an oversized op output
        if out_bytes > self.budget_bytes:
            self._find(
                "D2", f"oversized:{name}:{_shapes(new)}",
                f"{self.label}: {func} materialises {out_bytes} bytes "
                f"{_shapes(new)} — over the {self.budget_bytes}-byte "
                "scenario budget (broadcast blow-up?)")
        # D3: host waits
        why = self._host_wait(name, args, kwargs, ins, outs)
        if why:
            self.syncs += 1
            self._find("D3", f"sync:{name}",
                       f"{self.label}: {func} inside a serving body — "
                       f"{why}")

    @staticmethod
    def _host_wait(name, args, kwargs, ins, outs) -> str | None:
        if name == "_local_scalar_dense":
            return "a value read back to the host"
        if name in _DATA_SHAPED:
            return "output shape depends on data (a count read back)"
        if name in ("index", "index_put", "index_put_") and any(
                t.dtype == torch.bool for t in _tensors(args[1:2])):
            return "a bool index: output shape depends on data"
        if name == "repeat_interleave" and isinstance(args[0], torch.Tensor) \
                and kwargs.get("output_size") is None \
                and (len(args) < 4 or args[3] is None):
            return "repeat_interleave without output_size reads its sum back"
        if name in _COPIES:
            src, dst = (args[0], outs[0]) if name == "_to_copy" \
                else (args[1], args[0])
            blocking = not (kwargs.get("non_blocking")
                            or (name == "copy_" and len(args) > 2
                                and args[2]))
            kinds = {src.device.type, dst.device.type}
            if blocking and kinds == {"cpu", "cuda"}:
                return (f"a blocking copy {src.device.type} -> "
                        f"{dst.device.type}: the host waits for the queue")
        return None

    def metrics(self) -> dict:
        return {"label": self.label, "n_ops": len(self.ops),
                "max_live_bytes": self.max_live,
                "max_live_op": self.max_desc,
                "budget_bytes": self.budget_bytes,
                "corpus_rows": self.corpus_rows, "syncs": self.syncs}


def audit_body(body, args: tuple, *, label: str, corpus_rows: int,
               budget_bytes: int, args_alt: tuple | None = None) -> tuple:
    """Run ``body(*args)`` once under the auditor (D1-D3) and, with
    ``args_alt``, a second time on those inputs (D4). Returns (findings,
    metrics, the first call's output)."""
    with OpAuditor(label, corpus_rows, budget_bytes) as a:
        out = body(*args)
    findings = list(a.findings)
    m = a.metrics()
    if args_alt is not None:
        before = tracing.trace_count()
        with OpAuditor(label, corpus_rows, budget_bytes) as b:
            body(*args_alt)
        built = tracing.trace_count() - before
        if built:
            findings.append(Finding(
                "D4", a.path, 0, f"rebuilt:{built}",
                f"{label}: a second call on other values built {built} "
                "time(s) — "
                + ", ".join(tracing.traced_names(since=before))))
        if b.ops != a.ops:
            i = next((j for j, (x, y) in enumerate(zip(a.ops, b.ops))
                      if x != y), min(len(a.ops), len(b.ops)))
            x = a.ops[i] if i < len(a.ops) else "<end>"
            y = b.ops[i] if i < len(b.ops) else "<end>"
            findings.append(Finding(
                "D4", a.path, 0, f"value_dependent:{x}|{y}",
                f"{label}: a second call on other values dispatched "
                f"another op sequence ({len(a.ops)} vs {len(b.ops)} ops, "
                f"first difference at op {i}: {x} vs {y}) — a Python "
                "branch on a tensor value"))
    return findings, m, out


# --- representative scenarios ---------------------------------------------

# The JAX package's geometry: 240 pages (make_benchmark (100, 80, 60) at
# seed 7) in a 256-slot segment, the ColPali grid (D = 1024 patch vectors
# of d = 128, 34 mean-pooled), query batches of B = 4 with Q = 10 tokens,
# a chunk = 16 streamed scan, two_stage(prefetch_k=8, top_k=4).
#
# Budgets, by the JAX package's rule: at least 1.5x the largest
# legitimate op output at this geometry and below the cheapest
# full-corpus blow-up: the [B, N, Q, D] f32 sim tensor (4 x 256 x 10 x
# 1024 x 4 B = 40 MiB, the JAX auditor's figure too) and a whole-corpus
# f32 dequant of ``initial`` (256 x 1024 x 128 x 4 B = 128 MiB; the JAX
# auditor's comment says 135, the count in MB rounded up). Maxima of the
# CPU's plain versions (``python -m repro_torch.analysis --check --device
# cpu``): serving 8912896 B (8.5 MiB), the routed stage's per-query
# gather of 512 probed member rows of ``mean_pooling`` converted to f32
# ([512, 34, 128]; the rerank's per-query [8, 1024, 128] f32 dequant is
# 4 MiB); ingest 4218880 B (4.02 MiB, the [8, 1030, 128] f32 pages times
# the hygiene mask). The eager plain versions convert per query what
# XLA's fused graph leaves in bf16 for all queries at once, so the JAX
# auditor's maxima (17 MiB serving, its routed [4, 512, 34, 128] bf16
# gather; 4 MiB ingest) and budgets (24 and 16 MiB) are its own; these
# are 13 MiB (1.53x) and 7 MiB (1.74x).
_N_PAGES = (100, 80, 60)
_N_QUERIES = (6, 6, 4)
_SEED = 7
_CAPACITY = 256
_CHUNK = 16
_B = 4
_SERVE_BUDGET = 13 << 20
_INGEST_BUDGET = 7 << 20


@dataclass
class Scenario:
    """One body to audit: ``body(*args)``; ``args_alt`` differ from
    ``args`` only in values (D4); ``key(out)`` is the tensor a card run
    is compared on (ids, or the ingest's int8 codes); ``kernels`` the
    launch counters its path shows on the card."""
    label: str
    body: object
    args: tuple
    args_alt: tuple
    corpus_rows: int
    budget_bytes: int
    key: object
    kernels: tuple


@functools.lru_cache(maxsize=1)
def _corpus():
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_benchmark
    cfg = get_config("colpali")
    return cfg, make_benchmark(cfg, _N_PAGES, _N_QUERIES, seed=_SEED)


@functools.lru_cache(maxsize=2)
def _cpu_segmented(kind: str):
    """The scenario corpus as a one-segment ``SegmentedStore`` on the
    CPU. ``"routed"`` is the JAX package's store: ``initial`` quantised
    beside its float copy, IVF routing over 4 clusters. ``"int8"`` keeps
    codes only for the two vectors the cascade reads (``mean_pooling``,
    the scan's, and ``initial``, the rerank's): the JAX package's store
    keeps every float copy, so no op of its cascades reads a code; here
    the scan and the rerank read the codes, which is what D1 and the
    card's int8 kernels exercise."""
    from repro_torch.core import multistage as MST
    from repro_torch.retrieval.retriever import Retriever
    from repro_torch.retrieval.store import build_store, quantize_store
    cfg, bench = _corpus()
    store = build_store(cfg, bench.pages, bench.token_types, device="cpu")
    if kind == "routed":
        store = quantize_store(store, names=("initial",))
        r = Retriever(store, capacity=_CAPACITY, routing=4, device="cpu")
    else:
        store = quantize_store(store, names=("initial", "mean_pooling"),
                               stages=MST.one_stage())
        r = Retriever(store, capacity=_CAPACITY, device="cpu")
    return r.store


def _retriever(kind: str, device):
    """A ``Retriever`` over the scenario corpus on ``device``: the CPU
    store itself, or a copy of it (same bits, same clusters) on the
    card, so both devices score the same corpus."""
    from repro_torch.retrieval.retriever import Retriever
    store = _cpu_segmented(kind)
    if device.type != "cpu":
        store = _copy_store(store, device)
    return Retriever(store, device=device)


def _copy_store(store, device):
    out = copy.copy(store)
    out.segments = [dataclasses.replace(seg, slabs=tuple(
        {k: v.to(device) for k, v in slab.items()} for slab in seg.slabs))
        for seg in store.segments]
    out._slot_ids = None
    return out


def _queries(device, alt: bool = False) -> tuple:
    _, bench = _corpus()
    lo = _B if alt else 0
    q = torch.as_tensor(bench.queries[lo:lo + _B]).to(device)
    qm = torch.as_tensor(bench.query_mask[lo:lo + _B]).to(device).bool()
    return q, qm


def _stages(device, *, scan_kernel=False, rerank_kernel=False,
            routing=False):
    """two_stage(prefetch_k=8, top_k=4) with the streamed chunk-16 scan;
    on the card the scan takes its kernel and, where ``rerank_kernel``,
    the rerank its fused kernel."""
    from repro_torch.core import multistage as MST
    on_card = device.type == "cuda"
    stages = MST.with_scan_policy(MST.two_stage(prefetch_k=8, top_k=4),
                                  chunk=_CHUNK, scan_topk=True)
    if scan_kernel or on_card:
        stages = MST.with_scan_policy(stages, use_kernel=True)
    if rerank_kernel:
        stages = MST.with_rerank_policy(stages, rerank_kernel=True)
    if routing:
        stages = MST.with_routing_policy(stages, n_probe=2, n_clusters=4)
    return stages


def _search(label, device, kind, stages, kernels) -> Scenario:
    r = _retriever(kind, device)
    fn = r.search_fn(stages)
    stores = r.store.stores()
    q, qm = _queries(device)
    qa, qma = _queries(device, alt=True)
    return Scenario(label, lambda s, qq, qqm: fn(s, qq, qqm, None),
                    (stores, q, qm), (stores, qa, qma), _CAPACITY,
                    _SERVE_BUDGET, lambda out: out[1], kernels)


def scenario_scan_int8(device) -> Scenario:
    """The streamed int8 scan + the plain rerank (int8 codes gathered and
    dequantised per query) — the default serving cascade."""
    return _search("scan_int8", device, "int8", _stages(device),
                   ("maxsim_scan_int8",))


def scenario_rerank_fused(device) -> Scenario:
    """The scan kernel policy + the fused gather-rerank path."""
    return _search("rerank_fused", device, "int8",
                   _stages(device, scan_kernel=True, rerank_kernel=True),
                   ("maxsim_rerank_int8",))


def scenario_routed(device) -> Scenario:
    """IVF-routed stage 0 (centroid scores, then the probed member rows
    scored as candidates) over the JAX package's store."""
    return _search("routed", device, "routed",
                   _stages(device, routing=True), ("ivf_route",))


def scenario_ingest(device) -> Scenario:
    """The ingest pipeline's index body (hygiene -> pool -> quantise) on
    one minimum bucket of pages."""
    from repro_torch.retrieval.ingest import INGEST_BUCKET_MIN, IngestPipeline
    from repro_torch.retrieval.store import codes_key
    cfg, bench = _corpus()
    pipe = IngestPipeline.for_config(cfg, quantize=("initial",),
                                     use_kernel=True, device=device)
    n = INGEST_BUCKET_MIN
    tt = torch.as_tensor(bench.token_types).to(device)
    pages = torch.as_tensor(bench.pages[:n]).to(device)
    alt = torch.as_tensor(bench.pages[n:2 * n]).to(device)
    key = codes_key("initial")
    return Scenario("ingest", lambda p, t: pipe._index_arrays(p, t, None),
                    (pages, tt), (alt, tt), _CAPACITY, _INGEST_BUDGET,
                    lambda out: out[key], ("pooling",))


def scenario_tiered(device) -> Scenario:
    """The tiered per-segment scan body (``engine.make_segment_scan_fn``),
    what ``tiering.TieredEngine`` calls once per scope segment. Same
    budget as the joint cascade: streaming per segment must not cost
    intermediates the joint body does not. The second call moves the
    segment's offset too: segment identity rides as a plain argument,
    never a build."""
    from repro_torch.retrieval import engine
    r = _retriever("int8", device)
    store = r.store.segments[0].vectors
    body = engine.make_segment_scan_fn(_stages(device), _CAPACITY)
    q, qm = _queries(device)
    qa, qma = _queries(device, alt=True)
    return Scenario("tiered", body, (store, q, qm, None, 0),
                    (store, qa, qma, None, _CAPACITY), _CAPACITY,
                    _SERVE_BUDGET, lambda out: out[1],
                    ("maxsim_scan_int8",))


def scenario_degraded(device) -> Scenario:
    """The degraded-serving fold ``TieredEngine`` runs: per-segment scan
    bodies folded by ``_merge_pair``, per-segment rerank scores combined
    by ``_max_scores`` and closed by ``_select_stage``, as one body over
    a two-segment scope. Degradation only changes WHICH segments are
    visited, so the fold must fit the same budget and checks."""
    from repro_torch.retrieval import engine, tiering
    r = _retriever("int8", device)
    stages = _stages(device, rerank_kernel=device.type == "cuda")
    store = r.store.segments[0].vectors
    seg_scan = engine.make_segment_scan_fn(stages, _CAPACITY)
    seg_rerank = engine.make_segment_rerank_fn(stages, 1, _CAPACITY)

    def fold(s, qq, qm, ft, o):
        v1, i1 = seg_scan(s, qq, qm, ft, o)
        v2, i2 = seg_scan(s, qq, qm, ft, o)
        vals, cand = tiering._merge_pair(v1, i1, v2, i2, 8)
        s1 = seg_rerank(s, qq, qm, ft, o, cand)
        s2 = seg_rerank(s, qq, qm, ft, o, cand)
        sm = tiering._max_scores(s1, s2)
        return tiering._select_stage(sm, cand, 4)

    q, qm = _queries(device)
    qa, qma = _queries(device, alt=True)
    return Scenario("degraded", fold, (store, q, qm, None, 0),
                    (store, qa, qma, None, 0), _CAPACITY, _SERVE_BUDGET,
                    lambda out: out[1],
                    ("maxsim_scan_int8", "maxsim_rerank_int8"))


SCENARIOS = {
    "scan_int8": scenario_scan_int8,
    "rerank_fused": scenario_rerank_fused,
    "routed": scenario_routed,
    "ingest": scenario_ingest,
    "tiered": scenario_tiered,
    "degraded": scenario_degraded,
}


def audit_scenario(sc: Scenario) -> tuple:
    """Audit one built scenario: (findings, metrics, first output). The
    metrics carry the launches of the first call by counter."""
    before = {k: DSP.launch_count(k) for k in DSP.KERNELS}
    with torch.no_grad():
        findings, m, out = audit_body(
            sc.body, sc.args, label=sc.label, corpus_rows=sc.corpus_rows,
            budget_bytes=sc.budget_bytes, args_alt=sc.args_alt)
    m["launches"] = {k: DSP.launch_count(k) - before[k] for k in DSP.KERNELS
                     if DSP.launch_count(k) != before[k]}
    return findings, m, out


def run_op_audit(names=None, device="cuda") -> tuple:
    """Build and audit every scenario (or ``names``) on ``device``
    ("cuda" by default; it raises without a card). Returns (findings,
    metrics by scenario)."""
    dev = DSP.resolve_device(device)
    findings, metrics = [], {}
    for name in (names or SCENARIOS):
        f, m, _ = audit_scenario(SCENARIOS[name](dev))
        findings.extend(f)
        metrics[name] = m
    return findings, metrics
