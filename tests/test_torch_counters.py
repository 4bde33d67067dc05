"""Launch counters: a kernel wrapper counts one launch exactly when it
launched its kernel, never for an empty input that launches nothing and
never for a launch that returned an error.

The CUDA side is stood in for on the CPU: ``on_cuda`` reports True, and
``build.library`` hands back a library whose every entry point returns
the given CUDA status without touching memory, and whose scan route is
the warp route, as the real one's for these small shapes. The wrappers'
own argument checks, early returns and counting run as they do on the
card.
"""
import contextlib
import types

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import dispatch as DSP
from repro_torch.kernels.embed_bag import embed_bag
from repro_torch.kernels.maxsim import ops as MOPS
from repro_torch.kernels.maxsim.ops import quantize_int8
from repro_torch.kernels.pooling import ops as POPS

torch.set_num_threads(1)


class _FakeLibrary:
    def __init__(self, rc: int):
        self.rc = rc
        self.calls = 0
        self.entries = []

    def maxsim_scan_route(self, docs_type, D, d):
        return 0               # the warp route, as for these small shapes

    def __getattr__(self, entry):
        def launch(*args):
            self.calls += 1
            self.entries.append(entry)
            return self.rc
        return launch


@pytest.fixture
def fake_card(monkeypatch):
    """Returns a function that installs a fake library with status ``rc``
    and gives it back."""
    def install(rc: int) -> _FakeLibrary:
        lib = _FakeLibrary(rc)
        monkeypatch.setattr(DSP, "on_cuda", lambda t: True)
        monkeypatch.setattr(build, "library", lambda name: lib)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda dev: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda: types.SimpleNamespace(cuda_stream=0))
        return lib
    DSP.reset_counts()
    yield install
    DSP.reset_counts()


def _scan_inputs(B, N, dtype, D=8, Q=4, d=16):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, Q, d, generator=g)
    docs = torch.randn(N, D, d, generator=g)
    if dtype == "int8":
        codes, scales = quantize_int8(docs)
        return q, codes, scales
    return q, docs.to(dtype), None


def _call(wrapper, B, N, dtype):
    """Run ``wrapper`` on a [B, ., .] batch against an N-document corpus
    and return the counter it should move."""
    q, docs, scales = _scan_inputs(B, N, dtype)
    if wrapper == "scan":
        MOPS.maxsim_scores(q, docs, scales=scales)
        return "maxsim_scan_int8" if scales is not None else "maxsim_scan"
    if wrapper == "scan_db":
        MOPS.maxsim_scores_pipelined(q, docs, chunk=4, scales=scales)
        return "maxsim_scan_db"
    rows = torch.zeros((B, 3 if N else 0), dtype=torch.int64)
    MOPS.maxsim_rerank(q, docs, rows, scales=scales)
    return "maxsim_rerank_int8" if scales is not None else "maxsim_rerank"


WRAPPERS = [(w, t) for w in ("scan", "scan_db", "rerank")
            for t in (torch.float32, torch.bfloat16, "int8")]


@pytest.mark.parametrize("wrapper,dtype", WRAPPERS)
@pytest.mark.parametrize("B,N", [(0, 16), (2, 0)])
def test_empty_input_launches_and_counts_nothing(fake_card, wrapper, dtype,
                                                 B, N):
    lib = fake_card(0)
    _call(wrapper, B, N, dtype)
    assert lib.calls == 0
    assert all(DSP.launch_count(k) == 0 for k in DSP.KERNELS)


@pytest.mark.parametrize("wrapper,dtype", WRAPPERS)
def test_one_launch_counts_once_on_its_own_counter(fake_card, wrapper,
                                                   dtype):
    lib = fake_card(0)
    name = _call(wrapper, 2, 16, dtype)
    assert lib.calls == 1
    assert {k: DSP.launch_count(k) for k in DSP.KERNELS} == {
        k: int(k == name) for k in DSP.KERNELS}


@pytest.mark.parametrize("wrapper,dtype", WRAPPERS)
def test_failed_launch_raises_and_counts_nothing(fake_card, wrapper, dtype):
    fake_card(700)                       # cudaErrorIllegalAddress
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        _call(wrapper, 2, 16, dtype)
    assert all(DSP.launch_count(k) == 0 for k in DSP.KERNELS)


@pytest.mark.parametrize("rc,B,launched", [(0, 2, 1), (0, 0, 0), (700, 2, 0)])
def test_pooling_counts_only_real_launches(fake_card, rc, B, launched):
    fake_card(rc)
    x = torch.randn(B, 6, 16)
    mask = torch.ones(B, 6)
    pool_mat = torch.full((3, 6), 0.5)
    if rc:
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            POPS.pool_pages_fused(x, mask, pool_mat)
    else:
        POPS.pool_pages_fused(x, mask, pool_mat)
    assert DSP.launch_count("pooling") == launched


@pytest.mark.parametrize("rc,B,L,launched", [
    (0, 4, 3, 1), (0, 0, 3, 0), (0, 4, 0, 0), (700, 4, 3, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embed_bag_counts_only_real_launches(fake_card, rc, B, L, launched,
                                             dtype):
    """An empty batch returns zeros and launches nothing; a failed launch
    raises and counts nothing."""
    lib = fake_card(rc)
    table = torch.randn(10, 8).to(dtype)
    idx = torch.zeros((B, L), dtype=torch.int64)
    if rc:
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            embed_bag(table, idx)
    else:
        out = embed_bag(table, idx)
        assert tuple(out.shape) == (B, 8)
        if not launched:
            assert not out.any()
    assert lib.calls == launched + (1 if rc else 0)
    assert {k: DSP.launch_count(k) for k in DSP.KERNELS} == {
        k: int(k == "embed_bag") * launched for k in DSP.KERNELS}


def test_embed_bag_refuses_a_table_type_the_kernel_lacks(fake_card):
    lib = fake_card(0)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        embed_bag(torch.zeros((4, 8), dtype=torch.float64),
                  torch.zeros((1, 2), dtype=torch.int64))
    assert lib.calls == 0


@pytest.mark.parametrize("rc,B,launched", [(0, 2, 1), (0, 0, 0),
                                           (700, 2, 0)])
def test_centroid_scores_counts_as_ivf_route(fake_card, rc, B, launched):
    """On the card ``centroid_scores`` is one launch of the scan kernel's
    entry point over the K one-vector documents, counted as ``ivf_route``
    and never as ``maxsim_scan``."""
    lib = fake_card(rc)
    q, cents = torch.zeros((B, 5, 16)), torch.zeros((7, 16))
    if rc:
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            MOPS.centroid_scores(q, cents)
    else:
        assert tuple(MOPS.centroid_scores(q, cents).shape) == (B, 7)
    assert lib.entries == ["maxsim_scan_launch"] * (launched + (rc > 0))
    assert {k: DSP.launch_count(k) for k in DSP.KERNELS} == {
        k: int(k == "ivf_route") * launched for k in DSP.KERNELS}


class _FakeEntry:
    argtypes = restype = None


class _FakeCDLL:
    def __init__(self, path):
        self.path = path

    def __getattr__(self, entry):
        return _FakeEntry()


def test_library_load_counts_one_build(monkeypatch):
    """A cache miss of ``build.library`` (a load) counts one build in
    ``retrieval.tracing``, named after the library; a hit counts none."""
    from repro_torch.retrieval import tracing
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_lib_path", lambda name: build.CSRC)
    monkeypatch.setattr(build.ctypes, "CDLL", _FakeCDLL)
    before = tracing.trace_count()
    lib = build.library("pool")
    assert tracing.trace_count() == before + 1
    assert tracing.traced_names(since=before) == (
        "repro_torch.kernels.build.library:pool",)
    with tracing.no_retrace("a loaded library"):
        assert build.library("pool") is lib


def test_kernel_layer_imports_nothing_above_it():
    """The kernels (build, dispatch, ops) never import the retrieval
    layer; ``retrieval.tracing`` reads ``build.LOADED`` instead."""
    import ast
    import pathlib
    root = pathlib.Path(build.__file__).resolve().parent
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""]
                    if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert not m.startswith(("repro_torch.retrieval",
                                         "repro_torch.launch")), (path, m)
