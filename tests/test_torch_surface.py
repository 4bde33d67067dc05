"""The port covers ``repro``'s surface: a static check over both packages'
sources with ``ast`` (neither package is imported).

1. Every public top-level name (function, class, constant) and every
   public method of a public class of a module of ``src/repro/`` has a
   counterpart of the same name in the same module of
   ``src/repro_torch/``.
2. A named set of entry points takes every parameter of ``repro``'s
   counterpart.

Each exception is listed below with its reason, and an exception that no
longer applies (the name now exists in the port, or no longer in
``repro``) fails the check, so the list cannot go stale.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1] / "src"
REPRO, PORT = ROOT / "repro", ROOT / "repro_torch"

_PALLAS = "the Pallas kernel; its CUDA counterpart is under csrc/"
_REGISTRY = ("the JAX package's kernel registry, resolving Pallas, "
             "interpret mode or the reference per op; the port's wrappers "
             "take the kernel for a CUDA tensor and the plain version for "
             "a CPU one, and count launches in kernels.dispatch (record, "
             "launch_count, reset_counts)")
_PROBE = ("a JAX trace counter or Pallas probe; the port has no probe "
          "(the device rule) and counts launches in kernels.dispatch")
_MODULE_METHOD = ("a method of the port's nn.Module (ColXEncoder) rather "
                  "than a function of (cfg, params)")
_SPECS = ("per-layer sharding specs folded into "
          "transformer._layer_specs/param_specs")
_BUCKET = ("a padded bucket that keeps a jitted shape static; eager "
           "PyTorch indexes the exact rows")

# module (relative to the package) -> reason it has no file in the port
MISSING_MODULES = {
    "analysis/jaxpr_audit.py": "audits jaxprs; the port's op-level audit "
                               "is analysis/op_audit.py",
    "kernels/embed_bag/embed_bag.py": _PALLAS + " (embed_bag.cu)",
    "kernels/maxsim/maxsim.py": _PALLAS + " (maxsim_scan.cu, "
                                "maxsim_scan_db.cu, maxsim_rerank.cu)",
    "kernels/pooling/pooling.py": _PALLAS + " (pool.cu)",
    "kernels/pooling/ref.py": "pool_ref lives in kernels/pooling/ops.py, "
                              "beside its kernel's wrapper",
    "launch/hlo_analysis.py": "reads XLA's HLO text; the port counts with "
                              "launch/op_analysis.py's dispatch mode",
}

# (module, name) -> reason the port's module has no such public name
MISSING_NAMES = {
    ("analysis/astlint.py", "JitSite"):
        "R1's unit in the port is the body builder: PyTorch has no jit "
        "site",
    ("analysis/astlint.py", "Analyzer.jit_targets"):
        "as JitSite: the port resolves body builders instead",
    ("analysis/rules.py", "DISPATCH_REGISTER"):
        "R2's register() half: the port has no registry "
        "(DISPATCH_KERNELS names the counters)",
    ("analysis/rules.py", "R3_HOST_SYNC_CALLS"):
        "JAX's host syncs; the port's are R3_SYNC_CALLS/R3_SYNC_METHODS",
    ("analysis/rules.py", "R5_JNP_MODULES"):
        "jax.numpy at import time; the port's R5 uses R5_TENSOR_CTORS",
    ("core/pooling.py", "pool_pages"):
        "a jax.vmap of pool_page; pool_pages_batch is the batched form "
        "in both packages",
    ("kernels/dispatch.py", "KernelOp"): _REGISTRY,
    ("kernels/dispatch.py", "available"): _REGISTRY,
    ("kernels/dispatch.py", "default_interpret"): _REGISTRY,
    ("kernels/dispatch.py", "dispatch_count"): _REGISTRY,
    ("kernels/dispatch.py", "get"): _REGISTRY,
    ("kernels/dispatch.py", "kernel_dispatch_count"): _REGISTRY,
    ("kernels/dispatch.py", "op_names"): _REGISTRY,
    ("kernels/dispatch.py", "register"): _REGISTRY,
    ("kernels/dispatch.py", "registration_modules"): _REGISTRY,
    ("kernels/dispatch.py", "resolve"): _REGISTRY,
    ("kernels/maxsim/ops.py", "fused_rerank_trace_count"): _PROBE,
    ("kernels/maxsim/ops.py", "pallas_available"): _PROBE,
    ("kernels/maxsim/ops.py", "rerank_pallas_available"): _PROBE,
    ("kernels/pooling/ops.py", "fused_pool_trace_count"): _PROBE,
    ("kernels/pooling/ops.py", "pallas_available"): _PROBE,
    ("launch/dryrun.py", "COLLECTIVE_OPS"):
        "in launch/op_analysis.py, whose OpCounter keeps the counts",
    ("launch/dryrun.py", "collective_bytes"):
        "parses HLO text; the port's OpCounter is told each collective "
        "(sharding.OBSERVERS)",
    ("models/late_interaction.py", "contrastive_loss"): _MODULE_METHOD,
    ("models/late_interaction.py", "encode_pages"): _MODULE_METHOD,
    ("models/late_interaction.py", "encode_queries"): _MODULE_METHOD,
    ("models/late_interaction.py", "patch_merger"): _MODULE_METHOD,
    ("models/layers.py", "ATTN_SPECS"): _SPECS,
    ("models/layers.py", "MLP_SPECS"): _SPECS,
    ("models/layers.py", "MOE_SPECS"): _SPECS,
    ("models/layers.py", "ffn_specs"): _SPECS,
    ("models/recsys/nets.py", "init_autoint"):
        "nets.init_params builds the port's RecsysModel for every arch",
    ("models/recsys/nets.py", "init_bert4rec"):
        "nets.init_params builds the port's RecsysModel for every arch",
    ("models/recsys/nets.py", "init_dcn"):
        "nets.init_params builds the port's RecsysModel for every arch",
    ("models/recsys/nets.py", "init_dlrm"):
        "nets.init_params builds the port's RecsysModel for every arch",
    ("retrieval/engine.py", "store_shardings"):
        "in retrieval/store.py, beside split_slabs",
    ("retrieval/routing.py", "ASSIGN_BUCKET_MIN"): _BUCKET,
    ("retrieval/segments.py", "DELETE_BUCKET_MIN"): _BUCKET,
}

# entry points that must take every parameter of repro's counterpart:
# (module, qualified name) -> {parameter: reason it is not taken}
ENTRY_POINTS = {
    ("retrieval/retriever.py", "Retriever.__init__"): {},
    ("retrieval/retriever.py", "Retriever.from_snapshot"): {},
    ("retrieval/engine.py", "make_search_fn"): {},
    ("retrieval/engine.py", "make_segmented_search_fn"): {},
    ("retrieval/ingest.py", "IngestPipeline.__init__"): {
        "impl": "picks Pallas or its twin; the port picks by device",
        "interpret": "Pallas interpret mode; the port has none"},
    ("retrieval/ingest.py", "IngestPipeline.for_config"): {
        "impl": "picks Pallas or its twin; the port picks by device",
        "interpret": "Pallas interpret mode; the port has none"},
    ("retrieval/tiering.py", "restore_store"): {},
    ("models/transformer.py", "prefill_step"): {
        "cfg": "the port's DecoderLM (``model``) carries its config",
        "params": "the port's DecoderLM (``model``) carries its "
                  "parameters"},
    ("models/kv_cache.py", "cache_len"): {},
    ("models/kv_cache.py", "init_cache"): {},
    ("models/kv_cache.py", "cache_specs"): {},
    ("launch/cells.py", "build_retriever_cell"): {},
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def surface(path: pathlib.Path) -> set:
    """Public top-level names and ``Class.method`` names of a module."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and _public(node.name):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and _public(m.name)}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets
                    if isinstance(t, ast.Name) and _public(t.id)}
        elif isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name) and _public(node.target.id):
            out.add(node.target.id)
    return out


def parameters(path: pathlib.Path, qualname: str) -> list:
    body = ast.parse(path.read_text()).body
    node = None
    for part in qualname.split("."):
        node = next(n for n in body if isinstance(
            n, (ast.FunctionDef, ast.ClassDef)) and n.name == part)
        body = node.body
    a = node.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


MODULES = sorted(str(p.relative_to(REPRO)) for p in REPRO.rglob("*.py"))


def test_every_module_has_a_counterpart():
    missing = {m for m in MODULES if not (PORT / m).exists()}
    assert missing == set(MISSING_MODULES), sorted(
        missing ^ set(MISSING_MODULES))


@pytest.mark.parametrize("module", [m for m in MODULES
                                    if m not in MISSING_MODULES])
def test_every_public_name_has_a_counterpart(module):
    want, got = surface(REPRO / module), surface(PORT / module)
    excused = {n for m, n in MISSING_NAMES if m == module}
    missing = want - got
    assert missing <= excused, sorted(missing - excused)
    # an exception must still be one: in repro and absent from the port
    assert excused <= missing, sorted(excused - missing)


def test_every_exception_has_a_reason():
    for reason in (*MISSING_MODULES.values(), *MISSING_NAMES.values(),
                   *(r for d in ENTRY_POINTS.values() for r in d.values())):
        assert isinstance(reason, str) and len(reason) > 20, reason
    assert {m for m, _ in MISSING_NAMES} <= set(MODULES)


@pytest.mark.parametrize("module,qualname", list(ENTRY_POINTS),
                         ids=[q for _, q in ENTRY_POINTS])
def test_entry_point_takes_every_repro_parameter(module, qualname):
    want = parameters(REPRO / module, qualname)
    got = parameters(PORT / module, qualname)
    excused = ENTRY_POINTS[(module, qualname)]
    missing = [p for p in want if p not in got]
    assert set(missing) == set(excused), (missing, sorted(excused))
