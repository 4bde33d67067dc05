"""The dry run: every cell sized on the production meshes, nothing
allocated (the port of ``repro.launch.dryrun``).

``repro`` lowers and compiles each (arch x shape) cell onto the 16 x 16
and 2 x 16 x 16 meshes and reads the per-device program: memory
analysis, dot FLOPs with loop trip counts, collective result bytes. The
port builds the same cell on a mesh of ``meta`` devices
(``cells.build_cell(arch, shape, "meta", variant, mesh=mesh)``), runs its
step once under ``op_analysis.OpCounter``, and reads the same figures
for one position: ``shard_map`` runs each body once, as position 0 (a
512-position mesh costs what an 8-position one does), every collective
returns an empty tensor of its result shape, and each hand-written
kernel records its cost instead of launching. Where a size would depend
on data, the dry run takes the static bound of ``repro``'s compiled
cell: the ragged MoE's capacity ``cap`` (its rows split evenly over the
experts, which leaves the products' FLOPs exact), the search's
``cap_slots`` candidates a shard.

A result has ``repro``'s keys where they carry over: ``memory``
(``argument_bytes``: a position's bytes of the arguments the step reads;
``held_bytes``: of all it holds; ``output_bytes``: of the step's
outputs, whose donated arguments are updated in place; ``peak_bytes``:
the held bytes plus the most the step's own storages took at once),
``struct`` (``flops``, ``bytes_written``, ``collective_bytes``,
``collective_total``), ``collectives`` (``bytes``, ``counts``), and
``kernels`` (calls, FLOPs and bytes of each hand-written kernel);
``fits`` holds ``peak_bytes`` against one device's bytes.

Usage (no card needed; nothing is allocated on any device):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \\
      --device-bytes 85017493504    # 16 x 16; an H100 80GB's total_memory
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi ...  # 2x16^2
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh tiny ...   # 2 x 4
  ... --arch olmoe-1b-7b --shape train_4k [--variant opt] [--force]

``--variant`` defaults to ``all``: every cell at each of its variants
(``cells.variants``), the 101 cells; ``base``, ``opt`` or ``stage1`` runs
every cell at that one, as ``repro``'s flag does. ``--device-bytes``
defaults to the card's ``total_memory`` where a card is present and
must be given where none is. Results go to
``build/repro_torch/dryrun/dryrun_<mesh>[_<variant>].json`` (or
``--out``), keyed ``arch|shape|variant``; a cell that fails is reported
with its error and the run exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.launch.op_analysis import OpCounter, position_tensors

RESULTS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..", "build",
    "repro_torch", "dryrun"))


def meta_mesh(name: str):
    """The named mesh of ``meta`` devices: "single" (16 x 16), "multi" (2
    x 16 x 16), or "tiny" (2 x 4, for debugging), as ``repro`` names
    them."""
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    if name == "tiny":
        return make_mesh((2, 4), ("data", "model"), devices=["meta"] * 8)
    multi = name == "multi"
    return make_production_mesh(["meta"] * (512 if multi else 256),
                                multi_pod=multi)


def _output_bytes(counter: OpCounter, out) -> int:
    return sum(counter.block_bytes(t) for t in position_tensors(out))


def count_cell(cell) -> dict:
    """A built cell's step run once under the counter: the ``memory``,
    ``struct``, ``collectives`` and ``kernels`` of one position (module
    docstring)."""
    counter = OpCounter()
    counter.add_arguments(position_tensors(cell.args))
    with counter:
        out = cell.fn(*cell.args)
    return {
        "model_flops": cell.model_flops,
        "note": cell.note,
        "memory": {
            "argument_bytes": counter.argument_bytes,
            "held_bytes": counter.held_bytes,
            "output_bytes": _output_bytes(counter, out),
            "peak_bytes": counter.peak_bytes,
        },
        "struct": counter.struct(),
        "collectives": counter.collectives(),
        "kernels": counter.kernels,
        "ops": counter.ops,
    }


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             variant: str = "base", device_bytes: int | None = None) -> dict:
    """One cell on ``mesh`` (a meta mesh), built and run once under the
    counter; ``repro``'s result keys (module docstring)."""
    from repro_torch.launch.cells import build_cell
    t0 = time.time()
    cell = build_cell(arch, shape_name, "meta", variant, mesh=mesh)
    res = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "variant": variant, "ok": True, **count_cell(cell)}
    if device_bytes is not None:
        res["device_bytes"] = int(device_bytes)
        res["fits"] = res["memory"]["peak_bytes"] <= device_bytes
    res["seconds"] = round(time.time() - t0, 3)
    return res


def failed(arch: str, shape_name: str, mesh_name: str, variant: str,
           e: BaseException) -> dict:
    """A cell that raised, reported as ``repro`` reports it."""
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "variant": variant, "ok": False,
            "error": f"{type(e).__name__}: {e}",
            "trace": traceback.format_exc()[-2000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "tiny"])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--family", default=None,
                    help="only archs of this family (lm|gnn|recsys|retriever)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--variant", default="all",
                    help="all (every cell at each of its variants, "
                         "cells.variants: the 101 cells) | base | opt | "
                         "stage1 (see cells.build_cell)")
    ap.add_argument("--force", action="store_true",
                    help="recompute cells already in the results file")
    ap.add_argument("--device-bytes", type=int, default=None,
                    help="one device's bytes (default: the card's "
                         "total_memory; required without a card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import ALL_ARCHS, get_config, get_shapes
    from repro_torch.launch.cells import variants

    device_bytes = args.device_bytes
    if device_bytes is None:
        if not torch.cuda.is_available():
            ap.error("--device-bytes is required without a CUDA device")
        device_bytes = torch.cuda.get_device_properties(0).total_memory
    mesh = meta_mesh(args.mesh)
    suffix = "" if args.variant == "all" else f"_{args.variant}"
    out_path = args.out or os.path.join(RESULTS_DIR,
                                        f"dryrun_{args.mesh}{suffix}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    results = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)

    archs = [args.arch] if args.arch else list(ALL_ARCHS)
    if args.family:
        archs = [a for a in archs if get_config(a).family == args.family]
    t_all = time.time()
    for arch in archs:
        shapes = [args.shape] if args.shape else list(get_shapes(arch))
        for shape_name, variant in [
                (sh, v) for sh in shapes
                for v in (variants(arch, sh) if args.variant == "all"
                          else (args.variant,))]:
            key = f"{arch}|{shape_name}|{variant}"
            if key in results and results[key].get("ok") and not args.force:
                print(f"[skip] {key} (cached)")
                continue
            print(f"[dryrun] {arch} x {shape_name} ({variant}) on "
                  f"{args.mesh} ...", flush=True)
            try:
                res = run_cell(arch, shape_name, mesh, args.mesh, variant,
                               device_bytes)
                m = res["memory"]
                print(f"  ok: args={m['argument_bytes'] / 1e6:.0f}MB "
                      f"held={m['held_bytes'] / 1e6:.0f}MB "
                      f"peak={m['peak_bytes'] / 1e6:.0f}MB "
                      f"flops/dev={res['struct']['flops']:.3g} "
                      f"coll/dev={res['struct']['collective_total'] / 1e6:.1f}"
                      f"MB fits={res['fits']} ({res['seconds']}s)",
                      flush=True)
            except Exception as e:  # noqa: BLE001 - report per-cell failure
                res = failed(arch, shape_name, args.mesh, variant, e)
                print(f"  FAIL: {res['error'][:200]}", flush=True)
            results[key] = res
            with open(out_path, "w") as f:
                json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results.values() if r.get("ok"))
    n_fit = sum(1 for r in results.values() if r.get("fits"))
    print(f"\n{n_ok}/{len(results)} cells OK, {n_fit} fit one device of "
          f"{device_bytes} bytes ({time.time() - t_all:.1f}s) -> {out_path}")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
