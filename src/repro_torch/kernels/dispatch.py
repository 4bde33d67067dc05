"""Kernel dispatch: the device rule, launch counters and device resolution.

The rule every kernel wrapper follows: a CUDA tensor launches the
hand-written kernel (or the launch raises), a CPU tensor runs the kernel's
plain PyTorch version. There is no availability probe and no fallback from
a failed launch to the plain version.

Each wrapper calls ``record(name)`` right after it launches its kernel and
nowhere else, so ``launch_count`` counts real kernel launches: a run can
show that its main path went through the kernels by zeroing the counters
(``reset_counts``) before it and reading them after.

Counters: ``maxsim_scan`` and ``maxsim_rerank`` (f32/bf16 documents),
``maxsim_scan_int8`` and ``maxsim_rerank_int8`` (the same kernels' int8
variants), ``maxsim_scan_db`` (the double-buffered chunk scan, any
document type), ``pooling``, ``embed_bag`` (the EmbeddingBag kernel) and
``ivf_route`` (the scan kernel launched on a D=1 view of an IVF centroid
table by ``centroid_scores``, counted under the routing op's name).

Shapes only: inside ``costing(sink)`` (the dry run's counting context,
``launch.op_analysis``) a wrapper given ``meta`` tensors launches
nothing and runs no plain version. It returns empty meta outputs of its
result shape and hands ``sink(name, flops, nbytes, inputs)`` its
kernel's cost and the tensors the kernel reads,
from the ``cost`` function beside the wrapper (the operations and bytes
of the kernel's bound; on meta, with no data, every mask entry is taken
as set and every candidate or slot id as distinct). Outside that context
a meta tensor still raises (``on_cuda``).
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

KERNELS = ("maxsim_scan", "maxsim_scan_int8", "maxsim_scan_db",
           "maxsim_rerank", "maxsim_rerank_int8", "pooling", "embed_bag",
           "ivf_route")

_COUNTS = {name: 0 for name in KERNELS}


_SINK = []                   # the active cost sink, at most one


@contextmanager
def costing(sink):
    """Within this context, kernel wrappers given ``meta`` tensors record
    their kernel's cost with ``sink(name, flops, nbytes, inputs)`` and
    return
    empty meta outputs (module docstring)."""
    _SINK.append(sink)
    try:
        yield sink
    finally:
        _SINK.remove(sink)


def shapes_only(t: torch.Tensor) -> bool:
    """True for a ``meta`` tensor inside ``costing``: the wrapper records
    its cost and returns shapes (``record_cost``)."""
    return t.device.type == "meta" and bool(_SINK)


def record_cost(name: str, flops: float, nbytes: float,
                inputs: tuple = ()) -> None:
    """Hand one kernel call's cost, and the tensors it reads, to the
    active sink."""
    _SINK[-1](name, float(flops), float(nbytes),
              tuple(t for t in inputs if isinstance(t, torch.Tensor)))


def on_cuda(t: torch.Tensor) -> bool:
    """True when ``t`` lives on a CUDA device (launch the kernel); False
    for CPU tensors (run the plain version). Any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device} (expected cuda or cpu)")


def record(name: str) -> None:
    """Count one launch of kernel ``name`` (called by its wrapper right
    after a successful launch)."""
    _COUNTS[name] += 1


def launch_count(name: str) -> int:
    """Launches of kernel ``name`` since the last ``reset_counts``."""
    return _COUNTS[name]


def reset_counts(name: str | None = None) -> None:
    """Zero the launch counters (one kernel, or all)."""
    for k in (KERNELS if name is None else (name,)):
        _COUNTS[k] = 0


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``cuda`` (the default of every
    entry point) requires a card: without one this raises instead of
    carrying on on the CPU. ``meta`` builds tensors of the right shapes
    and dtypes with no storage (what ``launch/cells.py`` sizes cells
    with, ``jax.eval_shape``'s counterpart); a kernel wrapper given a
    meta tensor raises (``on_cuda``), except inside the dry run's
    ``costing``, where it returns shapes."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev} (expected cuda, cpu or "
                         "meta)")
    return dev


def full_f32() -> None:
    """Keep float32 products in full float32 on the card. The plain
    versions call this before their matrix products: with TF32 on, cuBLAS
    and cuDNN round float32 inputs to a 10-bit mantissa and the plain
    path would no longer be the float32 reference the kernels are held
    against."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
