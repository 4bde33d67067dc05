"""Rule definitions and scoping for the port's AST lint layer.

Each rule is repo-specific — generic lint (undefined names, syntax-level
errors) is ruff's job (see ``pyproject.toml``); this file only carries
contracts ruff cannot know about. The scopes are module-name prefixes /
regexes over the ``repro_torch.*`` dotted names derived from ``src/``.
The JAX package's auditor has one rule of the same number for each of
these; ``RULE_DOCS`` names it in prose.
"""
from __future__ import annotations

import re

# --- anchors the rules key on -------------------------------------------
TRACING_RECORD = "repro_torch.retrieval.tracing:record_trace"
DISPATCH_RECORD = "repro_torch.kernels.dispatch:record"
DISPATCH_MODULE = "repro_torch.kernels.dispatch"
DISPATCH_KERNELS = "KERNELS"          # the tuple of counter names there
BUILD_LIBRARY = "repro_torch.kernels.build:library"

# R1: a port has no jit site; what is built once and then served is a
# BODY: a closure that a builder function in these modules defines and
# returns (``engine.make_segmented_search_fn`` and its per-segment twins,
# cached by ``Retriever.search_fn`` and ``tiering.TieredEngine``). Every
# builder must reach record_trace() (or be returned, only, by one that
# does), so the runtime counter sees each build.
R1_SCOPE = ("repro_torch.retrieval.",)

# R2: in the kernel ops modules, every function that calls a launching
# entry of a library loaded through ``kernels.build.library`` must reach
# dispatch.record(), with a name of ``dispatch.KERNELS``. The C interface
# names every launching entry ``<name>_launch`` (``build.SIGNATURES``);
# the other entries (``maxsim_scan_route``, ``maxsim_scan_token_cap``)
# answer a question and launch nothing. A launch outside these modules
# is a finding too: the rule could not see it.
R2_OPS_MODULE = re.compile(r"^repro_torch\.kernels\.[A-Za-z0-9_]+\.ops$")
R2_LAUNCH_SUFFIX = "_launch"

# R3: host-sync idioms. An explicit synchronize flags anywhere in the
# serving modules (host-side serving loops must stay asynchronous); the
# rest only flag in BODY SCOPE: the closures R1's builders return, the
# functions in R3_BODY_ROOTS, and every port function they call.
R3_SERVING_SCOPE = ("repro_torch.retrieval.",)
# Modules whose HOST-SIDE code is legitimately synchronous: the tiered
# residency manager's whole job is host<->device transfers and waits on
# its copy stream's events (promote/evict/prefetch run OFF the query's
# critical path by design — a thread, not async dispatch). Scoped by
# MODULE, not pragma comments, so the exemption is one auditable list;
# body scope inside these modules is still fully enforced.
R3_HOST_EXEMPT_MODULES = ("repro_torch.retrieval.tiering",
                          # the fault injector emulates slow/failed
                          # transfers with host sleeps by construction
                          "repro_torch.retrieval.faults")
# Bodies that no builder returns: the ingest pipeline's device bodies and
# the tiered fold's combine steps, which stand where the JAX package
# jits its ingest index/write bodies and its tiered combine steps.
R3_BODY_ROOTS = (
    "repro_torch.retrieval.ingest:IngestPipeline._index_arrays",
    "repro_torch.retrieval.ingest:IngestPipeline._write_body",
    "repro_torch.retrieval.tiering:_merge_pair",
    "repro_torch.retrieval.tiering:_max_scores",
    "repro_torch.retrieval.tiering:_select_stage",
)
# calls that wait for the device, or whose result shape depends on data
# (the host must read a count back first)
R3_SYNC_CALLS = {
    "torch.cuda.synchronize": "waits for every queued kernel",
    # builds from host data: on the card a blocking copy that waits for
    # the queue, made below the dispatcher (the op audit cannot see it)
    "torch.tensor": "copies host data to the device, waiting for the "
                    "queue",
    "torch.nonzero": "output shape depends on data (a count read back)",
    "torch.unique": "output shape depends on data (a count read back)",
    "torch.masked_select": "output shape depends on data (a count read "
                           "back)",
    "torch.argwhere": "output shape depends on data (a count read back)",
}
R3_SYNC_METHODS = {
    "item": "reads a value back to the host",
    "tolist": "reads the tensor back to the host",
    "cpu": "copies to the host, waiting for the device",
    "numpy": "needs the tensor on the host",
    "synchronize": "waits for the device (Event/Stream.synchronize)",
    "nonzero": "output shape depends on data (a count read back)",
    "unique": "output shape depends on data (a count read back)",
    "masked_select": "output shape depends on data (a count read back)",
}
# flagged anywhere in the serving modules, host side included
R3_SERVING_SYNC = {"torch.cuda.synchronize"}
R3_SERVING_SYNC_METHODS = {"synchronize"}
R3_NUMPY_ON_PARAM = {"numpy.asarray", "numpy.array"}
R3_CAST_BUILTINS = {"float", "int", "bool"}
# a parameter annotated with one of these holds no tensor
R3_HOST_ANNOTATIONS = {"int", "float", "bool", "str", "bytes", "tuple",
                       "dict", "list", "set", "None"}
# attributes of a tensor that are host values: a cast of them reads
# nothing back
R3_HOST_ATTRS = {"shape", "ndim", "dtype", "device", "numel", "size", "dim",
                 "element_size", "data_ptr", "stride", "is_contiguous",
                 "nbytes", "itemsize", "is_cuda", "requires_grad"}

# R4: the vector-key suffix convention belongs to the typed VectorSchema
# in retrieval/store.py — a bare suffix literal anywhere else is a
# stringly leak.
R4_SUFFIXES = ("_mask", "_int8", "_scale")
R4_OWNER_MODULE = "repro_torch.retrieval.store"
R4_EXEMPT_PREFIXES = ("repro_torch.analysis",)   # the rules themselves

# R5: module-level (or class-body, or default-argument) eager tensor
# construction allocates at import time, before any caller has chosen a
# device.
R5_TENSOR_CTORS = {"torch.tensor", "torch.zeros", "torch.ones",
                   "torch.empty", "torch.full", "torch.arange",
                   "torch.linspace", "torch.eye", "torch.from_numpy",
                   "torch.as_tensor"}
R5_TENSOR_PREFIXES = ("torch.rand",)      # rand, randn, randint, randperm

RULE_DOCS = {
    "R1": "body builder on the serving/ingest path never calls "
          "tracing.record_trace() — its builds are invisible to the "
          "no-retrace counter (stands for the JAX package's R1, a jit "
          "body that never records its trace)",
    "R2": "kernel launch that never reaches dispatch.record(), records a "
          "name outside dispatch.KERNELS, or sits outside the "
          "repro_torch kernels ops modules (stands for the JAX package's "
          "R2; its other half, register() calls outside the registry's "
          "discovery, has no counterpart: the port has no registry and "
          "dispatch.KERNELS is the one list of names)",
    "R3": "host-sync idiom in body scope, or an explicit synchronize in a "
          "serving module (host-side code in R3_HOST_EXEMPT_MODULES is "
          "exempt; body scope never is) (stands for the JAX package's "
          "R3: host syncs in traced scope, block_until_ready in serving "
          "modules)",
    "R4": "stringly vector-key suffix literal outside the VectorSchema "
          "(the JAX package's R4, unchanged)",
    "R5": "module-level eager tensor construction at import time "
          "(stands for the JAX package's R5, eager jnp computation at "
          "import time)",
    "D1": "int8 tensor converted to f32/f64 at full-corpus shape (the JAX "
          "package's J1)",
    "D2": "an op's output exceeds the scenario bytes budget (the JAX "
          "package's J2)",
    "D3": "host wait inside a serving body: a scalar read back, an op "
          "whose output shape depends on data, or a blocking copy between "
          "the host and the card (the JAX package's J3, a host callback)",
    "D4": "a second call on other values builds something or dispatches "
          "another op sequence: a value-dependent Python branch (the JAX "
          "package's J4, a weak-typed input that splits the executable "
          "cache)",
}
