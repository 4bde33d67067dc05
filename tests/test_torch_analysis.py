"""The port's static contract auditor, AST layer and CLI
(``repro_torch.analysis``), held to ``repro.analysis``: the finding and
baseline helpers give ``repro``'s outputs on the same lists, every AST
fixture of ``tests/test_analysis.py`` has a torch-idiom twin that the
port's rule judges as ``repro``'s twin rule judges the original, the
port's tree is clean, and the CLI gates as ``repro``'s does."""
import json
from pathlib import Path

import pytest
import torch

import repro.analysis as RA
from repro.analysis.__main__ import main as repro_main
from repro.analysis.astlint import lint_sources as repro_lint

import repro_torch.analysis as TA
from repro_torch.analysis import rules as R
from repro_torch.analysis.__main__ import main as port_main
from repro_torch.analysis.astlint import Analyzer, lint_sources, lint_tree

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def rules_of(findings):
    return sorted({f.rule for f in findings})


# ---------------------------------------------------------------------
# Finding, dedupe, load_baseline, apply_baseline: repro's outputs
# ---------------------------------------------------------------------

_ROWS = [("R1", "a.py", 1, "x", "m"), ("R3", "b.py", 2, "y", "n"),
         ("R1", "a.py", 1, "x", "m"), ("R1", "a.py", 7, "x", "m"),
         ("J1", "<jaxpr:s>", 0, "int8_upcast:(4, 2)", "k")]


def test_finding_fingerprint_and_json_match_repro():
    for row in _ROWS:
        a, b = TA.Finding(*row), RA.Finding(*row)
        assert a.fingerprint == b.fingerprint
        assert a.to_json() == b.to_json()


def test_dedupe_matches_repro():
    got = [f.to_json() for f in TA.dedupe([TA.Finding(*r) for r in _ROWS])]
    want = [f.to_json() for f in RA.dedupe([RA.Finding(*r) for r in _ROWS])]
    assert got == want and len(got) == 4


def test_load_baseline_matches_repro(tmp_path):
    p = tmp_path / "b.json"
    assert TA.load_baseline(p) == RA.load_baseline(p) == set()
    p.write_text(json.dumps({"allow": ["R1:a.py:x", "R3:b.py:y"]}))
    assert TA.load_baseline(p) == RA.load_baseline(p) == {"R1:a.py:x",
                                                          "R3:b.py:y"}


def test_apply_baseline_matches_repro():
    allow = {"R3:b.py:y"}
    tg, tb = TA.apply_baseline([TA.Finding(*r) for r in _ROWS], allow)
    rg, rb = RA.apply_baseline([RA.Finding(*r) for r in _ROWS], allow)
    assert [f.to_json() for f in tg] == [f.to_json() for f in rg]
    assert [f.to_json() for f in tb] == [f.to_json() for f in rb]


# ---------------------------------------------------------------------
# fixture twins: repro's source, the port's torch-idiom twin, the verdict
# both rules must give
# ---------------------------------------------------------------------

_R1_BUILDER_BAD = """
def make(n):
    def body(x):
        return x * 2
    return body
fn = make(3)
"""

TWINS = {
    # R1: a serving body that never records its build / trace
    "r1_bad": ({"repro.retrieval.fake": """
import jax
def make(n):
    def body(x):
        return x * 2
    return body
fn = jax.jit(make(3))
"""}, {"repro_torch.retrieval.fake": _R1_BUILDER_BAD}, ["R1"]),
    "r1_ok": ({"repro.retrieval.fake": """
import jax
from repro.retrieval.tracing import record_trace
def make(n):
    def body(x):
        record_trace()
        return x * 2
    return body
fn = jax.jit(make(3))
"""}, {"repro_torch.retrieval.fake": """
from repro_torch.retrieval.tracing import record_trace
def make(n):
    record_trace()
    def body(x):
        return x * 2
    return body
fn = make(3)
"""}, []),
    "r1_decorator_method_bad": ({"repro.retrieval.seg": """
import jax
@jax.jit
def write(x):
    return x + 1
"""}, {"repro_torch.retrieval.seg": """
class Engine:
    def build(self, n):
        def write(x):
            return x + 1
        return write
"""}, ["R1"]),
    "r1_decorator_method_ok": ({"repro.retrieval.seg": """
import jax
from repro.retrieval import tracing
@jax.jit
def write(x):
    tracing.record_trace()
    return x + 1
"""}, {"repro_torch.retrieval.seg": """
from repro_torch.retrieval import tracing
class Engine:
    def build(self, n):
        tracing.record_trace()
        def write(x):
            return x + 1
        return write
"""}, []),
    "r1_out_of_scope": ({"repro.models.fake": """
import jax
def make(n):
    def body(x):
        return x * 2
    return body
fn = jax.jit(make(3))
"""}, {"repro_torch.models.fake": _R1_BUILDER_BAD}, []),
    # R2: a kernel dispatch that never records
    "r2_bad": ({"repro.kernels.fam.ops": """
from repro.kernels import dispatch as DSP
def scores(q, v, *, impl="ref"):
    return q @ v
"""}, {"repro_torch.kernels.fam.ops": """
from repro_torch.kernels import build
from repro_torch.kernels import dispatch as DSP
def scores(q, v):
    lib = build.library("fam")
    rc = lib.fam_launch(q.data_ptr(), v.data_ptr())
    build.check(rc, "fam")
    return q @ v
"""}, ["R2"]),
    "r2_ok_through_helper": ({"repro.kernels.fam.ops": """
from repro.kernels import dispatch as DSP
def _inner(q, v, impl):
    DSP.record("fam", impl)
    return q @ v
def scores(q, v, *, impl="ref"):
    return _inner(q, v, impl)
"""}, {"repro_torch.kernels.fam.ops": """
from repro_torch.kernels import build
from repro_torch.kernels import dispatch as DSP
def _done(name):
    DSP.record(name)
def scores(q, v):
    lib = build.library("fam")
    lib.fam_launch(q.data_ptr(), v.data_ptr())
    _done("fam")
    return q @ v
"""}, []),
    # R2's registry half: repro's register() outside discovery; the
    # port's registry is dispatch.KERNELS, a record() of another name
    "r2_registry_bad": ({"repro.kernels.stray": """
from repro.kernels import dispatch as DSP
DSP.register(None)
"""}, {"repro_torch.kernels.dispatch": """
KERNELS = ("fam",)
def record(name):
    pass
""", "repro_torch.kernels.fam.ops": """
from repro_torch.kernels import build
from repro_torch.kernels import dispatch as DSP
def scores(q):
    lib = build.library("fam")
    lib.fam_launch(q.data_ptr())
    DSP.record("maf")
"""}, ["R2"]),
    "r2_registry_ok": ({"repro.kernels.fam.ops": """
from repro.kernels import dispatch as DSP
DSP.register(None)
"""}, {"repro_torch.kernels.dispatch": """
KERNELS = ("fam",)
def record(name):
    pass
""", "repro_torch.kernels.fam.ops": """
from repro_torch.kernels import build
from repro_torch.kernels import dispatch as DSP
def scores(q):
    lib = build.library("fam")
    lib.fam_launch(q.data_ptr())
    DSP.record("fam")
"""}, []),
    # R3: host syncs in traced / body scope and serving modules
    "r3_item_in_body": ({"repro.retrieval.hot": """
import jax
from repro.retrieval.tracing import record_trace
@jax.jit
def body(x):
    record_trace()
    return x.item()
"""}, {"repro_torch.retrieval.hot": """
from repro_torch.retrieval.tracing import record_trace
def make():
    record_trace()
    def body(x):
        return x.item()
    return body
"""}, ["R3"]),
    "r3_host_side_clean": ({"repro.retrieval.hot": """
import numpy as np
def admit(x):
    return np.asarray(x)   # host-side, outside any traced body
"""}, {"repro_torch.retrieval.hot": """
def admit(x):
    return x.cpu().numpy()   # host-side, outside any body
"""}, []),
    "r3_sync_in_callee": ({"repro.retrieval.hot": """
import jax
import numpy as np
from repro.retrieval.tracing import record_trace
def helper(v):
    return np.asarray(v)
@jax.jit
def body(x):
    record_trace()
    return helper(x)
"""}, {"repro_torch.retrieval.hot": """
from repro_torch.retrieval.tracing import record_trace
def helper(v):
    return v.numpy()
def make():
    record_trace()
    def body(x):
        return helper(x)
    return body
"""}, ["R3"]),
    "r3_branch_on_param": ({"repro.retrieval.hot": """
import jax
from repro.retrieval.tracing import record_trace
@jax.jit
def body(x, flag):
    record_trace()
    if flag:
        return x
    return -x
"""}, {"repro_torch.retrieval.hot": """
from repro_torch.retrieval.tracing import record_trace
def make():
    record_trace()
    def body(x, flag):
        if flag:
            return x
        return -x
    return body
"""}, ["R3"]),
    "r3_branch_on_static_clean": ({"repro.retrieval.hot": """
import jax
from functools import partial
from repro.retrieval.tracing import record_trace
@partial(jax.jit, static_argnames=("flag",))
def body(x, flag):
    record_trace()
    if flag:
        return x
    return -x
"""}, {"repro_torch.retrieval.hot": """
from repro_torch.retrieval.tracing import record_trace
def make(flag):
    record_trace()
    def body(x):
        if flag:
            return x
        return -x
    return body
"""}, []),
    "r3_wait_in_serving_module": ({"repro.retrieval.loop": """
import jax
def drain(xs):
    return [jax.block_until_ready(x) for x in xs]
"""}, {"repro_torch.retrieval.loop": """
import torch
def drain(xs):
    torch.cuda.synchronize()
    return xs
"""}, ["R3"]),
    "r3_pragma": ({"repro.retrieval.loop": """
import jax
def drain(xs):
    # audit: allow-R3 latency probe needs a sync point
    return [jax.block_until_ready(x) for x in xs]
"""}, {"repro_torch.retrieval.loop": """
import torch
def drain(xs):
    # audit: allow-R3 latency probe needs a sync point
    torch.cuda.synchronize()
    return xs
"""}, []),
    # R5: import-time eager computation
    "r5_module_level": ({"repro.core.tables": """
import jax.numpy as jnp
TABLE = jnp.arange(1024)
"""}, {"repro_torch.core.tables": """
import torch
TABLE = torch.arange(1024)
"""}, ["R5"]),
    "r5_in_function_clean": ({"repro.core.tables": """
import jax.numpy as jnp
def table():
    return jnp.arange(1024)
"""}, {"repro_torch.core.tables": """
import torch
def table():
    return torch.arange(1024)
"""}, []),
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_fixture_twin_same_verdict_as_repro(name):
    repro_src, port_src, want = TWINS[name]
    assert rules_of(repro_lint(repro_src)) == want
    assert rules_of(lint_sources(port_src)) == want


# R4 has no JAX in it: both linters take the same source
R4_CASES = {
    "suffix_outside_store": ("retrieval.other", 'KEY = "vec" + "_int8"\n',
                             ["R4"]),
    "semantic_mask_key": ("models.recsys", 'KEY = "seq_mask"\n', []),
    "store_owns_it": ("retrieval.store", '_INT8 = "_int8"\n', []),
}


@pytest.mark.parametrize("name", sorted(R4_CASES))
def test_r4_same_rule_and_symbol_as_repro(name):
    mod, src, want = R4_CASES[name]
    rf = repro_lint({f"repro.{mod}": src})
    pf = lint_sources({f"repro_torch.{mod}": src})
    assert rules_of(rf) == rules_of(pf) == want
    assert [f.symbol for f in rf] == [f.symbol for f in pf]


# ---------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------


def test_r1_builder_returned_only_by_a_recording_builder_is_clean():
    # engine._mesh_search's shape: a helper builder that only a recording
    # builder calls, returning its result
    src = """
from repro_torch.retrieval.tracing import record_trace
def _inner(n):
    def body(x):
        return x * n
    return body
def make(n):
    record_trace()
    return _inner(n)
"""
    assert lint_sources({"repro_torch.retrieval.e": src}) == []
    stray = src + "\ndef other():\n    return _inner(2)\n"
    fs = lint_sources({"repro_torch.retrieval.e": stray})
    assert rules_of(fs) == ["R1"]
    assert {f.symbol for f in fs} == {"_inner:builder", "other:builder"}


def test_r2_launch_outside_ops_and_record_names_through_call_sites():
    disp = 'KERNELS = ("scan", "scan_int8")\ndef record(name):\n    pass\n'
    ops = """
from repro_torch.kernels import build
from repro_torch.kernels import dispatch as DSP
def _launch(entry, counter, q):
    lib = build.library(entry)
    getattr(lib, entry + "_launch")(q.data_ptr())
    DSP.record(counter)
def scores(q, int8):
    return _launch("scan", "scan_int8" if int8 else "scan", q)
def routed(q):
    return _launch("scan", "route", q)
"""
    fs = lint_sources({"repro_torch.kernels.dispatch": disp,
                       "repro_torch.kernels.fam.ops": ops})
    assert [(f.rule, f.symbol) for f in fs] == [("R2", "_launch:record(route)")]
    stray = """
from repro_torch.kernels import build
def go(q):
    lib = build.library("scan")
    lib.scan_launch(q.data_ptr())
"""
    fs = lint_sources({"repro_torch.retrieval.x": stray})
    assert [(f.rule, f.symbol) for f in fs] == [("R2", "go:launch")]
    # an entry that answers a question launches nothing
    query = stray.replace("scan_launch", "scan_route")
    assert lint_sources({"repro_torch.kernels.fam.ops": query}) == []


def test_r3_casts_tensor_constructors_and_host_values_in_body_scope():
    src = """
import torch
from repro_torch.retrieval.tracing import record_trace
def helper(x, n: int, flag: bool):
    a = int(x.shape[0]) + int(n) + int(flag) + len(x)
    return a
def make():
    record_trace()
    def body(x, off: int):
        return helper(x, off, True)
    return body
"""
    assert lint_sources({"repro_torch.retrieval.h": src}) == []
    bad = src.replace("return a", "return a + int((x > 0).sum())")
    fs = lint_sources({"repro_torch.retrieval.h": bad})
    assert [f.symbol for f in fs] == ["helper:int(x)"]
    bad = src.replace("return a", "return torch.tensor(a, device=x.device)")
    fs = lint_sources({"repro_torch.retrieval.h": bad})
    assert [f.symbol for f in fs] == ["helper:torch.tensor"]
    bad = src.replace("return a", "return torch.nonzero(x)")
    assert rules_of(lint_sources({"repro_torch.retrieval.h": bad})) == ["R3"]


def test_r3_body_roots_and_exempt_host_modules():
    # the ingest body is a root without a builder; tiering's host side
    # may wait, its combine steps may not
    ingest = """
class IngestPipeline:
    def _index_arrays(self, pages, tt, h):
        return pages.cpu()
"""
    fs = lint_sources({"repro_torch.retrieval.ingest": ingest})
    assert [f.symbol for f in fs] == ["IngestPipeline._index_arrays:.cpu"]
    tiering = """
def _merge_pair(a, b, c, d, k):
    return a.tolist()
def promote(e):
    e.synchronize()
"""
    fs = lint_sources({"repro_torch.retrieval.tiering": tiering})
    assert [f.symbol for f in fs] == ["_merge_pair:.tolist"]


def test_r5_class_bodies_and_defaults_run_at_import():
    src = """
import torch
class K:
    ONES = torch.ones(4)
def f(x=torch.zeros(2), y=None):
    return torch.randn(3)
"""
    fs = lint_sources({"repro_torch.core.k": src})
    assert sorted(f.symbol for f in fs) == ["<module>:torch.ones",
                                            "<module>:torch.zeros"]


def test_rule_docs_name_every_rule_and_its_repro_counterpart():
    assert sorted(R.RULE_DOCS) == ["D1", "D2", "D3", "D4",
                                   "R1", "R2", "R3", "R4", "R5"]
    for rule, doc in R.RULE_DOCS.items():
        assert "JAX package's" in doc, rule
    assert "no counterpart" in R.RULE_DOCS["R2"]


# ---------------------------------------------------------------------
# the real tree
# ---------------------------------------------------------------------


def test_port_tree_is_clean_with_the_shipped_baseline():
    base = SRC / "repro_torch" / "analysis" / "baseline.json"
    assert json.loads(base.read_text())["allow"] == []
    gated, _ = TA.apply_baseline(
        lint_tree(SRC, package="repro_torch", repo_root=ROOT),
        TA.load_baseline(base))
    assert gated == []


def test_port_tree_rules_see_the_builders_launches_and_bodies():
    """The clean verdict is not vacuous: the engine's builders, the four
    launching wrappers and the search bodies are all in the rules'
    sight."""
    sources = {}
    for py in sorted((SRC / "repro_torch").rglob("*.py")):
        name = ".".join(py.relative_to(SRC).with_suffix("").parts)
        sources[name.removesuffix(".__init__")] = py.read_text()
    a = Analyzer(sources)
    eng = "repro_torch.retrieval.engine:"
    for b in ("make_segmented_search_fn", "make_segment_scan_fn",
              "make_segment_rerank_fn", "make_search_fn", "_mesh_search"):
        assert eng + b in a.builder_ok()
    launching = {fid for fid, fi in a.funcs.items() if fi.launches}
    assert launching == {
        "repro_torch.kernels.maxsim.ops:_scan_launch",
        "repro_torch.kernels.maxsim.ops:_rerank_cuda",
        "repro_torch.kernels.pooling.ops:_pool_cuda",
        "repro_torch.kernels.embed_bag.ops:_embed_bag_cuda"}
    assert launching <= a.provides_record
    for fid in (eng + "_segment_stage0", eng + "_score_candidates",
                "repro_torch.kernels.maxsim.ops:maxsim_rerank",
                "repro_torch.retrieval.store:as_filter_arrays",
                "repro_torch.retrieval.ingest:IngestPipeline._index_arrays"):
        assert fid in a.body, fid
    assert "repro_torch.retrieval.retriever:Retriever.search" not in a.body


def test_analysis_modules_are_in_the_import_check():
    from test_torch_imports import PORT_FILES, _BANNED, _imported_modules
    pkg = SRC / "repro_torch" / "analysis"
    files = sorted(pkg.glob("*.py"))
    assert {p.name for p in files} == {"__init__.py", "__main__.py",
                                       "astlint.py", "op_audit.py",
                                       "rules.py"}
    assert (pkg / "baseline.json").is_file()
    for p in files:
        assert p in PORT_FILES
        assert not [m for _, m in _imported_modules(p) if _BANNED.match(m)]


# ---------------------------------------------------------------------
# the CLI gate, beside repro's
# ---------------------------------------------------------------------


def _fake_tree(tmp_path, pkg: str, body: str) -> Path:
    d = tmp_path / pkg / "src" / pkg / "retrieval"
    d.mkdir(parents=True)
    for p in (d.parent, d):
        (p / "__init__.py").write_text("")
    (d / "bad.py").write_text(body)
    return tmp_path / pkg / "src"


def _gate_sequence(main, src: Path, tmp: Path, extra: list) -> list:
    report, baseline = tmp / "report.json", tmp / "baseline.json"
    baseline.write_text(json.dumps({"allow": []}))
    argv = ["--check", *extra, "--src", str(src), "--baseline",
            str(baseline), "--report", str(report)]
    rcs = [main(argv)]
    rep = json.loads(report.read_text())
    assert rep["n_gated"] == 1 and rep["gated"][0]["rule"] == "R1"
    baseline.write_text(json.dumps(
        {"allow": [rep["gated"][0]["fingerprint"]]}))
    rcs.append(main(argv))
    assert json.loads(report.read_text())["n_baselined"] == 1
    rcs.append(main(argv[1:]))            # no --check: help, exit 2
    return rcs


def test_cli_exit_codes_as_repro(tmp_path):
    rsrc = _fake_tree(tmp_path, "repro", "import jax\n@jax.jit\n"
                      "def body(x):\n    return x + 1\n")
    psrc = _fake_tree(tmp_path, "repro_torch", "def make():\n"
                      "    def body(x):\n        return x + 1\n"
                      "    return body\n")
    want = _gate_sequence(repro_main, rsrc, rsrc.parent, ["--no-jaxpr"])
    got = _gate_sequence(port_main, psrc, psrc.parent, ["--no-ops"])
    assert got == want == [1, 0, 2]


def test_cli_report_defaults_under_build(tmp_path, monkeypatch):
    import repro_torch.analysis.__main__ as M
    monkeypatch.setattr(M, "_repo_root", lambda: tmp_path)
    assert port_main(["--check", "--no-ops", "--src", str(SRC)]) == 0
    rep = json.loads((tmp_path / "build" / "repro_torch"
                      / "contract_audit.json").read_text())
    assert set(rep) == {"gated", "baselined", "op_metrics", "n_gated",
                        "n_baselined"}
    assert rep["n_gated"] == 0 and rep["op_metrics"] == {}
    assert not (tmp_path / "benchmarks").exists()
    assert [p.name for p in tmp_path.iterdir()] == ["build"]
