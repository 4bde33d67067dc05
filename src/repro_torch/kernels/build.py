"""Build the CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``nvcc -shared -Xcompiler -fPIC``, target ``sm_90a``),
loaded with ``ctypes``. All missing libraries build in parallel, one
``nvcc`` process per source, started together. A library is keyed by a
hash of its source, the shared headers and the flags, under
``build/repro_torch/`` at the repository root, so an edited source
rebuilds and an unchanged one loads at once.

Nothing here runs at import: the CPU tests import every module, and this
host may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

# C entry points: name -> argtypes. docs_type is 0 for f32, 1 for bf16
# and 2 for int8 codes (which read scales [N, D] f32; the other types
# take a null pointer there). Every entry point returns the
# cudaError_t of its launch (0 = launched).
SIGNATURES = {
    "maxsim_scan": {
        # q, q_mask, docs, docs_type, scales, doc_mask, doc_mask_stride,
        # out, B, Q, N, D, d, then the tensor route's packed query: qpack,
        # qstart, qcount, TP; stream
        "maxsim_scan_launch": [_P, _P, _P, _I, _P, _P, _I64, _P,
                               _I, _I, _I, _I, _I, _P, _P, _P, _I, _P],
        # docs_type, D, d -> 1 tensor-core route, 0 warp route
        "maxsim_scan_route": [_I, _I, _I],
        # docs_type, d -> query tokens per group on the tensor route
        "maxsim_scan_token_cap": [_I, _I],
    },
    "maxsim_scan_db": {
        # the scan's arguments: q, q_mask, docs, docs_type, scales,
        # doc_mask, doc_mask_stride, out, B, Q, N, D, d, qpack, qstart,
        # qcount, TP, stream
        "maxsim_scan_db_launch": [_P, _P, _P, _I, _P, _P, _I64, _P,
                                  _I, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    },
    "maxsim_rerank": {
        # rows, q, q_mask, docs, docs_type, scales, doc_mask,
        # doc_mask_stride, out, B, L, Q, D, d, then the tensor route's
        # packed query: qpack, qstart, qcount; stream
        "maxsim_rerank_launch": [_P, _P, _P, _P, _I, _P, _P, _I64, _P,
                                 _I, _I, _I, _I, _I, _P, _P, _P, _P],
    },
    "pool": {
        # x, x_page_stride, mask [B, S4], pool_mat [n_out, S4], out,
        # B, S, S4, d, n_out, l2_norm, stream
        "pool_launch": [_P, _I64, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _P],
    },
    "embed_bag": {
        # table, table_type (0 f32, 1 bf16, 2 f16), idx, w, out, B, L, d,
        # stream
        "embed_bag_launch": [_P, _I, _P, _P, _P, _I, _I, _I, _P],
    },
}

_LIBS: dict = {}
BUILD_LOG: dict = {}          # name -> compiler output of the last build
LOADED: list = []             # name per cache miss of library(), in order


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (CUDA_HOME or nvcc on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build_all() -> float:
    """Compile every library that is not built yet, in parallel. Returns
    the seconds spent; raises with the compiler's output on failure."""
    t0 = time.perf_counter()
    pending = []
    for name in SIGNATURES:
        out = _lib_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in pending:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (building all libraries first if any is
    missing), with ``argtypes``/``restype`` set on its entry points. A
    cache miss (a build or a load) appends ``name`` to ``LOADED``, which
    ``retrieval.tracing`` counts."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    LOADED.append(name)
    path = _lib_path(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
