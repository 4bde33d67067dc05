"""The port stands alone: no JAX and nothing of ``repro`` in
``src/repro_torch``, ``examples/*_torch.py`` or ``chip_smoke.py``, and its
entry points refuse to run on a missing card instead of carrying on on the
CPU."""
import ast
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples").glob("*_torch.py")) + [ROOT / "chip_smoke.py"]
_BANNED = re.compile(r"^(jax|jaxlib|repro)(\.|$)")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and _BANNED.match(node.value)
              and " " not in node.value):
            # module names handed to importlib
            yield node.lineno, node.value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax_and_no_repro(path):
    bad = [(ln, m) for ln, m in _imported_modules(path) if _BANNED.match(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_encoder_and_training_modules_are_checked():
    """The AST rule above covers the encoder, the training modules, the
    recsys and GNN families, the cells, the mesh and the sharding policy,
    and the training example (the glob reaches every new file)."""
    checked = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for rel in ("src/repro_torch/models/late_interaction.py",
                "src/repro_torch/training/optimizer.py",
                "src/repro_torch/training/train_loop.py",
                "src/repro_torch/training/compression.py",
                "src/repro_torch/training/elastic.py",
                "src/repro_torch/training/train_state.py",
                "src/repro_torch/models/recsys/embedding.py",
                "src/repro_torch/models/recsys/nets.py",
                "src/repro_torch/models/gnn/so3.py",
                "src/repro_torch/models/gnn/graph.py",
                "src/repro_torch/models/gnn/sampler.py",
                "src/repro_torch/models/gnn/equiformer_v2.py",
                "src/repro_torch/launch/cells.py",
                "src/repro_torch/launch/mesh.py",
                "src/repro_torch/launch/op_analysis.py",
                "src/repro_torch/launch/dryrun.py",
                "src/repro_torch/distributed/sharding.py",
                "src/repro_torch/distributed/shard_map.py",
                "examples/train_retriever_torch.py"):
        assert rel in checked, rel
        assert not [m for _, m in _imported_modules(ROOT / rel)
                    if _BANNED.match(m)], rel


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 15          # every module imported


def test_dry_run_loads_neither_jax_nor_repro_nor_the_card():
    """The dry run of a cell on the 16 x 16 meta mesh, in a fresh
    process: no ``jax`` or ``repro`` module is loaded, no CUDA state is
    touched, nothing is allocated on any device."""
    code = (
        "import sys, torch\n"
        "from repro_torch.launch import dryrun as DR\n"
        "r = DR.run_cell('dcn-v2', 'train_batch', DR.meta_mesh('single'),"
        " 'single')\n"
        "assert r['ok'] and r['memory']['argument_bytes'] > 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('DRY_OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0 and "DRY_OK" in out.stdout, out.stderr


def _tiny_store_inputs():
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_benchmark
    cfg = dataclasses.replace(get_config("colpali"), grid_h=4, grid_w=4,
                              out_dim=16)
    bench = make_benchmark(cfg, (4, 4, 4), (2, 2, 2), n_topics_per_ds=2)
    return cfg, bench


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.retrieval.ingest import IngestPipeline
    from repro_torch.retrieval.retriever import Retriever
    from repro_torch.retrieval.store import build_store, from_numpy
    from repro_torch.launch import serve
    cfg, bench = _tiny_store_inputs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_store(cfg, bench.pages, bench.token_types)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IngestPipeline(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_numpy({"x": np.zeros((2, 3), np.float32)})
    store = build_store(cfg, bench.pages, bench.token_types, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Retriever(store)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--pages", "30", "--queries", "10"])
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "minicpm-2b", "--reduced", "--steps", "1"])
    from repro_torch.configs import get_config
    from repro_torch.models.recsys import nets
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nets.init_params(get_config("dcn-v2"))
    from repro_torch.launch import cells
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cells.build_cell("dcn-v2", "serve_p99")


def test_serving_entry_points_raise_without_a_card():
    """The fused ingest, the frontend, the raw-store search, the serve
    CLI's traffic and ingest modes and the examples run on the card by
    default; each raises without one, and runs when given the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    import importlib.util
    from repro_torch.core import multistage as MST
    from repro_torch.launch import serve
    from repro_torch.retrieval.engine import make_search_fn
    from repro_torch.retrieval.frontend import ServingFrontend
    from repro_torch.retrieval.ingest import IngestPipeline
    from repro_torch.retrieval.retriever import Retriever
    from repro_torch.retrieval.store import build_store
    cfg, bench = _tiny_store_inputs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IngestPipeline.for_config(cfg)
    for argv in (["--traffic", "5"], ["--ingest-batches", "2",
                                      "--ingest-pipeline"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--pages", "30", "--queries", "10"] + argv)
    for name in ("quickstart_torch", "serve_multistage_torch",
                 "scaling_study_torch"):
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])
    # given the CPU, the same entry points run
    pipe = IngestPipeline.for_config(cfg, device="cpu")
    store = pipe.index(bench.pages[:4], bench.token_types)
    r = Retriever(store, capacity=64, ingest=pipe, device="cpu")
    assert len(r.ingest(bench.pages[4:9], bench.token_types)) == 5
    fe = ServingFrontend(r, MST.two_stage(4, 2), max_batch=2, max_q=16)
    s, i = fe.search(bench.queries[0], bench.query_mask[0])
    assert i.shape == (1, 2)
    s, i = make_search_fn(MST.one_stage(3), 4)(store.vectors,
                                                bench.queries[:2])
    assert tuple(i.shape) == (2, 3)
    out = serve.main(["--pages", "30", "--queries", "10", "--traffic", "5",
                      "--device", "cpu"])
    assert out["builds"] == 0
    assert build_store(cfg, bench.pages[:2], bench.token_types,
                       device="cpu").n_docs == 2


def test_kernel_wrappers_take_the_plain_version_only_on_cpu():
    """A CPU tensor runs the plain version and counts no launch; a tensor
    on any other device (``meta`` included) is refused, never silently
    served."""
    from repro_torch.kernels import dispatch as DSP
    from repro_torch.kernels.maxsim import maxsim_rerank, maxsim_scores
    from repro_torch.kernels.pooling import pool_pages_fused
    DSP.reset_counts()
    q = torch.zeros((1, 3, 8))
    docs = torch.zeros((4, 5, 8))
    maxsim_scores(q, docs)
    maxsim_rerank(q, docs, torch.zeros((1, 2), dtype=torch.int32))
    pool_pages_fused(torch.zeros((1, 4, 8)), torch.ones((1, 4)),
                     torch.ones((2, 4)))
    assert all(DSP.launch_count(k) == 0 for k in DSP.KERNELS)
    with pytest.raises(ValueError, match="unsupported device"):
        maxsim_scores(q, docs.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        maxsim_rerank(q.to("meta"), docs.to("meta"),
                      torch.zeros((1, 2), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        pool_pages_fused(torch.zeros((1, 4, 8), device="meta"),
                         torch.ones((1, 4), device="meta"),
                         torch.ones((2, 4), device="meta"))
    # ``meta`` is for construction only (shapes and bytes, nothing runs)
    assert DSP.resolve_device("meta").type == "meta"
    with pytest.raises(ValueError, match="unsupported device"):
        DSP.resolve_device("mps")
    assert all(DSP.launch_count(k) == 0 for k in DSP.KERNELS)
