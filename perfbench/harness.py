"""The generic runner: one run of one cell of ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``: the retriever's
index geometry, the page count and the corpus generator's parameters) and
a traffic mix (``traffic/<mix>.json``: the cascade, the loop, the batch
or arrival rate, the query lengths, the frontend's knobs). Its
correctness limits are ``limits/<cell>.json``; each metric is read by
``metrics/<metric>.py``, or, where that file is missing, by the reader of
its name without the last dotted part (``device_idle_share.open`` by
``device_idle_share.py``). Nothing here names a cell, a configuration, a
mix or a metric.

A run: set-up (kernel libraries loaded from the build cache inside the
checkout; the corpus made on the device from the seed, chunk by chunk,
indexed through the port's ``IngestPipeline.index`` and upserted into ONE
segment preallocated at the corpus size; the cell's own shapes warmed),
then the measured window of ``seconds``, then, with the program's state
freed, the plain reference over a sample of the served answers drawn
from the seed.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
METRICS = HERE / "metrics"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
MISSING = math.inf
INDEX_CHUNK = 512        # pages made and indexed at a time in set-up
WARM_BATCHES = 3         # search batches of the cell's shape in set-up
SAMPLE = 64              # served answers the reference judges a run
# no encoder runs (the traffic is query embeddings): the index and search
# path reads none of the encoder's sizes that ``RetrieverConfig`` requires
NO_ENCODER = dict(d_model=0, n_layers=0, n_heads=0, d_ff=0)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def prepare_env() -> None:
    """Every cache in the checkout at a fixed path; the port on the path."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules(modules=None) -> list:
    """Whole top-level names of ``FORBIDDEN`` among the loaded modules
    (``sys.modules`` by default)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the cell, from data
# ---------------------------------------------------------------------------

@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict | None
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Path = BENCHMARK) -> Cell:
    b = json.loads(bench.read_text())
    w = next((w for w in b["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in {bench.name}")
    cfg = next(c for c in b["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / cfg["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    lim = HERE / "limits" / f"{name}.json"
    limits = json.loads(lim.read_text()) if lim.exists() else None
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in b["end_to_end"] if _applies(m, name)],
                [m for m in b["per_layer"] if _applies(m, name)])


def reader(metric: str):
    path = METRICS / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = METRICS / f"{metric.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# what the readers read
# ---------------------------------------------------------------------------

@dataclass
class Work:
    """Counts of the work the window's calls needed (traced runs)."""
    scan: list = field(default_factory=list)     # (ops, bytes) a call
    rerank: list = field(default_factory=list)   # (ops, bytes) a call
    other_flops: float = 0.0                     # one-vector stages


@dataclass
class Run:
    cell: Cell
    seed: int
    traced: bool
    setup_s: float
    window_s: float
    completed: int = 0            # queries served in the window
    latencies: list = field(default_factory=list)   # s, inf = failed
    spans: dict = field(default_factory=dict)
    stats: dict = field(default_factory=dict)       # frontend counters
    trace: object = None                            # trace.Trace
    work: Work | None = None
    peaks: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------

def program_stages(traffic: dict) -> tuple:
    from repro_torch.core.multistage import Stage
    return tuple(
        Stage(c["vector"], int(c["k"]), use_kernel=True)
        if i == 0 else Stage(c["vector"], int(c["k"]), rerank_kernel=True)
        for i, c in enumerate(traffic["cascade"]))


def ref_stages(traffic: dict) -> tuple:
    from perfbench.reference import RefStage
    q8 = set(traffic.get("int8", ()))
    return tuple(RefStage(c["vector"], int(c["k"]), c["vector"] in q8)
                 for c in traffic["cascade"])


def build(cell: Cell, seed: int, dev, spans):
    """The corpus, indexed through the port into one preallocated
    segment: (retriever, corpus spec, corpus tables)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RetrieverConfig
    from repro_torch.retrieval.ingest import IngestPipeline
    from repro_torch.retrieval.retriever import Retriever
    from perfbench import corpus as C

    spec = C.CorpusSpec.of(cell.config)
    tab = C.tables(spec, seed, dev)
    rcfg = RetrieverConfig(**NO_ENCODER, **cell.config["retriever"])
    stages = program_stages(cell.traffic)
    quant = tuple(cell.traffic.get("int8", ()))
    pipe = IngestPipeline(rcfg, store_dtype=torch.bfloat16,
                          quantize=quant,
                          stages=stages if quant else None, device=dev)
    # on the host: the pipeline checks the layout there without a wait
    tt = C.token_types(spec.geo)
    retriever = None
    for lo, hi in C.page_chunks(spec, INDEX_CHUNK):
        ids = torch.arange(lo, hi, device=dev)
        with spans.span("generate"):
            raw = C.pages(spec, seed, tab, ids)
        with spans.span("index"):
            batch = pipe.index(raw, tt, h_eff=tab.h_eff[ids]
                               if spec.h_eff is not None else None)
            del raw
            if retriever is None:
                retriever = Retriever(batch, capacity=spec.pages,
                                      device=dev)
            else:
                retriever.upsert(batch)
            del batch
    store = retriever.store
    if len(store.segments) != 1 or store.n_valid != spec.pages:
        raise RuntimeError("the corpus did not land in one full segment")
    # stable ids are the generator's page numbers, in slot order
    if not np.array_equal(store.slot_doc_ids(), np.arange(spec.pages)):
        raise RuntimeError("slot order is not page order")
    return retriever, spec, tab


# ---------------------------------------------------------------------------
# the traced run's work counts
# ---------------------------------------------------------------------------

class RerankLog:
    """Holds the arguments of the rerank kernel's calls (the kernel
    layer's ``maxsim_rerank``) made while it is entered."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.kernels.maxsim import ops
        self._ops, self._orig = ops, ops.maxsim_rerank
        orig, calls = self._orig, self.calls

        def observed(q, docs, rows, q_mask=None, doc_mask=None, ok=None,
                     **kw):
            calls.append((docs.shape[1], docs.element_size(),
                          kw.get("scales") is not None, rows, ok, q_mask))
            return orig(q, docs, rows, q_mask, doc_mask, ok, **kw)

        ops.maxsim_rerank = observed
        return self

    def __exit__(self, *exc):
        self._ops.maxsim_rerank = self._orig


def rerank_work(retriever, stages, queries, B: int, batches: list, spec,
                tab, traffic) -> list:
    """(ops, bytes) of every rerank call of a closed window, in its order.
    The window runs unobserved: once it has closed, each distinct batch it
    searched is searched once more with the rerank calls observed, and
    those calls are counted before the next batch (a batch's candidates do
    not depend on when it is searched)."""
    per_batch = {}
    for b in sorted(set(batches)):
        sl = slice(b * B, (b + 1) * B)
        with RerankLog() as rlog:
            retriever.search(queries.q[sl], queries.mask[sl], stages=stages)
        per_batch[b] = rerank_counts(rlog.calls, spec, tab, traffic)
    return [w for b in batches for w in per_batch[b]]


def valid_vectors(spec, tab, D: int):
    """[N] valid stored vectors a page of a stage with D vectors a page."""
    import torch
    geo = spec.geo
    h = tab.h_eff
    if D == geo.n_vis:
        return h * geo.row_w
    if D == geo.n_pooled:
        if geo.kind == "dynamic":
            return h.clamp_max(geo.max_rows)
        return torch.full_like(h, D)
    raise ValueError(f"no stage of {D} vectors a page")


def count_work(spec, tab, traffic, q_valid_calls, rerank) -> Work:
    """Operations and bytes of the window's calls (``counts``): the scans
    from each call's (queries, valid tokens), the reranks as counted."""
    from perfbench import counts as K
    w = Work(rerank=list(rerank))
    d, N = spec.geo.dim, spec.pages
    first = traffic["cascade"][0]["vector"]
    if first == "global_pooling":
        for n_q, qv in q_valid_calls:
            w.other_flops += K.single_vector_ops(n_q, qv, N, d)
    else:
        D = spec.geo.n_vis if first == "initial" else spec.geo.n_pooled
        vv = int(valid_vectors(spec, tab, D).sum())
        q8 = first in traffic.get("int8", ())
        for n_q, qv in q_valid_calls:
            w.scan.append((K.scan_ops(qv, vv, d),
                           K.scan_bytes(N, D, d, 1 if q8 else 2,
                                        4 if q8 else 0, n_q * int(
                                            traffic["q_slots"]))))
    return w


def rerank_counts(calls, spec, tab, traffic) -> list:
    """(ops, bytes) of observed rerank calls (``RerankLog.calls``), in
    order: a call's operations over its candidates' valid vectors, its
    bytes over the distinct candidates (a sorted row, its steps)."""
    import torch
    from perfbench import counts as K
    d, slots = spec.geo.dim, int(traffic["q_slots"])
    out = []
    for D, esize, scaled, rows, ok, q_mask in calls:
        rows = rows.long()
        okb = torch.ones_like(rows, dtype=torch.bool) if ok is None \
            else ok.bool()
        qv = q_mask.float().sum(1) if q_mask is not None else \
            torch.full((rows.shape[0],), float(slots), device=rows.device)
        vv = valid_vectors(spec, tab, D).to(rows.device)
        per_q = torch.where(okb, vv[rows], 0).sum(1).float()     # [B]
        srt = torch.sort(torch.where(okb, rows, -1).flatten()).values
        first = torch.ones_like(srt, dtype=torch.bool)
        first[1:] = srt[1:] != srt[:-1]
        first &= srt >= 0
        out.append((2.0 * d * float((per_q * qv).sum()), K.rerank_bytes(
            int(torch.where(first, vv[srt.clamp_min(0)], 0).sum()),
            int(first.sum()), D, d, esize, 4 if scaled else 0,
            rows.numel(), rows.shape[0] * slots)))
    return out


# ---------------------------------------------------------------------------
# the windows
# ---------------------------------------------------------------------------

def closed_loop(retriever, stages, queries, traffic, seconds, spans):
    """Back-to-back ``Retriever.search`` on the cell's batches: (served
    [(batch, scores, ids)], window seconds, per-call (queries, valid
    tokens))."""
    B = int(traffic["batch"])
    nb = queries.q.shape[0] // B
    Q = queries.q.view(nb, B, *queries.q.shape[1:])
    M = queries.mask.view(nb, B, -1)
    qv = M.sum(2).tolist()
    served, calls = [], []
    t0 = time.perf_counter()
    with spans.span("window"):
        it = 0
        while True:
            b = it % nb
            with spans.span("search"):
                scores, ids = retriever.search(Q[b], M[b], stages=stages)
            served.append((b, scores, ids))
            calls.append((B, int(sum(qv[b]))))
            it += 1
            if time.perf_counter() - t0 >= seconds:
                break
    return served, time.perf_counter() - t0, calls


def open_loop(fe, qn, lens, arrivals, spans):
    """Single ragged queries at their scheduled arrivals through the
    frontend's ``submit``/``pump``, then drained: (PendingResults, window
    seconds, lateness of the generator [s])."""
    clock = fe.clock
    n, pool = len(arrivals), qn.shape[0]
    pend = [None] * n
    late = []
    t0 = clock()
    with spans.span("window"):
        i = 0
        while True:
            now = clock()
            while i < n and t0 + arrivals[i] <= now:
                qi = i % pool
                with spans.span("submit"):
                    pend[i] = fe.submit(qn[qi, :lens[qi]],
                                        t_submit=t0 + arrivals[i])
                late.append(now - (t0 + arrivals[i]))
                i += 1
            if i >= n and not fe.pending:
                break
            nd = fe.next_deadline()
            if fe.pending >= fe.max_batch or (nd is not None
                                              and clock() >= nd):
                d0 = fe.stats["dispatches"]
                t1 = time.perf_counter()
                with spans.span("pump"):
                    fe.pump()
                dt = time.perf_counter() - t1
                k = fe.stats["dispatches"] - d0
                # a pump that found a backlog dispatches several blocks
                for _ in range(k):
                    spans.add("dispatch", dt / k)
                continue
            waits = [] if i >= n else [t0 + arrivals[i] - clock()]
            if nd is not None:
                waits.append(nd - clock())
            wait = min(waits)
            if wait > 0.001:
                with spans.span("wait"):
                    time.sleep(wait - 0.0005)
    return pend, clock() - t0, late


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             t_proc: float, device: str = "cuda",
             control: bool = False) -> dict:
    """Run the cell once and return the result line (a dict); with
    ``control`` the result carries the control's readings too."""
    import numpy as np
    import torch
    from perfbench import corpus as C
    from perfbench import counts as K
    from perfbench import reference as R
    from perfbench import trace as T
    from perfbench import traffic as TR

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats()
    traffic = cell.traffic
    spans = T.Spans(traced=False)
    phases = [("start", time.perf_counter())]
    retriever, spec, tab = build(cell, seed, dev, spans)
    sync()
    phases.append(("corpus", time.perf_counter()))
    stages = program_stages(traffic)
    queries = C.queries(spec, seed, tab, int(traffic["pool"]),
                        int(traffic["q_slots"]), tuple(traffic["q_valid"]))
    open_ = traffic["loop"] == "open"
    B = int(traffic.get("batch", 1))
    if open_:
        fe = retriever.frontend(stages, **traffic["frontend"])
        fe.warm()
        qn = queries.q.cpu().numpy()
        lens = queries.lengths.cpu().numpy()
        arr = TR.arrivals(seed, float(traffic["rate"]), seconds)
    else:
        nb = int(traffic["pool"]) // B
        for b in range(WARM_BATCHES):
            sl = slice(b % nb * B, (b % nb + 1) * B)
            retriever.search(queries.q[sl], queries.mask[sl], stages=stages)
    sync()
    phases.append(("warm", time.perf_counter()))
    builds0 = retriever.trace_count()
    gen_s = sum(spans.durations.get("generate", ()))
    idx_s = sum(spans.durations.get("index", ()))

    spans = T.Spans(traced=traced)
    prof = None
    for attempt in range(3 if traced else 1):
        if traced:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + \
                ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()
        setup_s = time.perf_counter() - t_proc
        try:
            if open_:
                pend, window_s, late = open_loop(fe, qn, lens, arr, spans)
            else:
                served, window_s, calls = closed_loop(
                    retriever, stages, queries, traffic, seconds, spans)
            sync()
        finally:
            if traced:
                prof.__exit__(None, None, None)
        if not traced:
            break
        tr = T.read_trace(prof, spans.durations)
        if not cuda or T.busy_s(tr) > 0:
            break
        log(f"[trace] the profiler recorded no device time (try "
            f"{attempt + 1} of 3); the window runs again")
        spans = T.Spans(traced=True)
    builds = retriever.trace_count() - builds0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    run = Run(cell, seed, traced, setup_s, window_s,
              spans=spans.durations, peaks=K.peaks())
    if open_:
        run.latencies = [MISSING if (p is None or p.error is not None
                                     or not p.done())
                         else p.t_done - p.t_submit for p in pend]
        run.completed = sum(1 for x in run.latencies if x < MISSING)
        run.stats = dict(fe.stats)
        attempted = len(pend)
        failed = attempted - run.completed
        log(f"[traffic] {attempted} requests at {traffic['rate']} req/s over"
            f" {arr[-1]:.3f} s; latency p50 "
            f"{1e3 * TR.nearest_rank(run.latencies, 0.5):.4f} ms, p99 "
            f"{1e3 * TR.nearest_rank(run.latencies, 0.99):.4f} ms; "
            "generator late mean "
            f"{1e3 * float(np.mean(late)):.4f} ms, max "
            f"{1e3 * float(np.max(late)):.4f} ms; frontend {run.stats}")
    else:
        run.completed = len(served) * B
        attempted, failed = run.completed, 0
        log(f"[traffic] {len(served)} batches of {B} in {window_s:.4f} s")
    marks = [(n, t1 - t0) for (_, t0), (n, t1) in zip(phases, phases[1:])]
    log(f"[setup] {setup_s:.4f} s: to run_cell "
        f"{phases[0][1] - t_proc:.4f} s, " + ", ".join(
            f"{n} {v:.4f} s" for n, v in marks) +
        f" (host time of generate {gen_s:.4f} s, index and upsert "
        f"{idx_s:.4f} s); builds in the window {builds}")
    if traced:
        run.trace = tr
        t_rw = time.perf_counter()
        rerank = [] if open_ else rerank_work(
            retriever, stages, queries, B, [b for b, _, _ in served], spec,
            tab, traffic)
        run.work = count_work(spec, tab, traffic, [] if open_ else calls,
                              rerank)
        log(f"[trace] {len(rerank)} rerank calls counted in "
            f"{time.perf_counter() - t_rw:.4f} s after the window; idle by "
            "host span: " + json.dumps(T.idle_by_span(tr)))

    kind = "end_to_end" if not traced else "per_layer"
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = reader(m["name"])(run)
        if v is None:
            if not traced:
                raise RuntimeError(f"{kind} metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # ---- correctness, once the window has closed and the peak is read
    n_avail = len(pend) if open_ else len(served) * B
    pick = TR.sample(seed, n_avail, SAMPLE)
    never = 0
    ids_l, sc_l, qidx = [], [], []
    k_last = int(traffic["cascade"][-1]["k"])
    for j in pick.tolist():
        if open_:
            p = pend[j]
            qidx.append(j % qn.shape[0])
            if p is None or p.error is not None or not p.done():
                never += 1
                ids_l.append(np.full(k_last, -1, np.int64))
                sc_l.append(np.zeros(k_last, np.float32))
            else:
                ids_l.append(np.asarray(p.ids[0], np.int64))
                sc_l.append(np.asarray(p.scores[0], np.float32))
        else:
            it, r = divmod(j, B)
            b, sc, ids = served[it]
            qidx.append(b * B + r)
            ids_l.append(np.asarray(ids[r], np.int64))
            sc_l.append(sc[r].float().cpu().numpy())
    served_ids = torch.as_tensor(np.stack(ids_l))
    served_sc = torch.as_tensor(np.stack(sc_l))
    qi = torch.as_tensor(qidx, device=dev)
    q, qm = queries.q[qi], queries.mask[qi]
    topic = queries.topic[qi].tolist()
    anchor = queries.anchor[qi].tolist()
    del retriever, queries
    if open_:
        del fe, pend
    else:
        del served
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    res = R.cascade(spec, seed, tab, ref_stages(traffic), q, qm,
                    [R.Served(served_ids, served_sc)], control=control)
    ref_s = time.perf_counter() - t_ref
    ndcg, rec = C.ndcg_recall_at(served_ids.numpy(), topic, anchor,
                                 tab.topic_of.cpu().numpy())
    log(f"[quality] {len(pick)} sampled answers: NDCG@10 {ndcg:.4f}, "
        f"Recall@10 {rec:.4f}; reference {ref_s:.4f} s")
    readings = res["readings"][0]
    log(f"[check] parts of select_gap: below a cut {readings.get('cut')!r},"
        f" below the r-th best {readings.get('rank')!r}")
    limits = cell.limits or {}
    correct = bool(limits) and never == 0 and all(
        readings[n] <= limits[n] for n in R.NUMBERS)
    if not limits:
        log(f"[check] no limits file for {cell.name}")
    if never:
        log(f"[check] {never} sampled requests never got an answer")
    checks = {n: {"value": readings[n], "limit": limits.get(n)}
              for n in R.NUMBERS}
    checks["unanswered"] = {"value": never, "limit": 0}
    for n, c in checks.items():
        log(f"[check] {n} {c['value']!r} limit {c['limit']!r}")

    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics,
           "device": device_info}
    if traced:
        lo, hi = tr.window
        device_info["busy_s"] = T.busy_s(tr)
        device_info["window_s"] = (hi - lo) / 1e9
        out["breakdown"] = T.breakdown(tr)
    if control:
        out["control"] = res["readings"][1]
    out["checks"] = checks
    return out


def main(argv, t_proc: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_env()
    cell = load_cell(args.workload)
    import torch
    torch.set_num_threads(1)        # one host thread of load
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"[device] {cell.name} needs {cell.chips} CUDA device(s): "
            "no result")
        return 3
    return finish(run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           t_proc))


def finish(out: dict) -> int:
    """Print the result line, unless the process now holds JAX or the JAX
    package: the gate comes after everything the run loaded (the window,
    the metric readers, the reference)."""
    found = forbidden_modules()
    if found:
        log(f"[imports] the process holds {found}: no result")
        return 4
    print(json.dumps(out), flush=True)
    return 0
