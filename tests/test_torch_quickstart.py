"""``examples/quickstart_torch.py`` on the CPU against the same steps
through ``repro`` (``examples/quickstart.py``'s steps, at a 60-page
corpus): the ``[crop]``, ``[data]`` and ``[search]`` lines are equal (the
metrics to the 3 printed decimals), and the ``[mutate]`` line reports no
build in steady state."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.configs import get_config
from repro.core import multistage as JM
from repro.core.cropping import crop_box
from repro.data.synthetic import (evaluate_ranking, make_benchmark,
                                  make_page_image)
from repro.retrieval import Retriever
from repro.retrieval.store import build_store

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PAGES, QUERIES = 60, 15


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _repro_lines(per_ds: tuple) -> list:
    """The quickstart's printed lines, made by ``repro`` (steps 1-4)."""
    rng = np.random.default_rng(0)
    img, true_box = make_page_image(rng)
    box = crop_box(img, std_thresh=0.02, page_number_strip=0.05)
    lines = [f"[crop] content box {box} (true margins {true_box})"]
    cfg = get_config("colpali")
    nq = QUERIES // 3
    bench = make_benchmark(cfg, n_pages_per_ds=per_ds,
                           queries_per_ds=(nq, nq, QUERIES - 2 * nq))
    lines.append(f"[data] {bench.pages.shape[0]} pages x "
                 f"{bench.pages.shape[1]} tokens, {len(bench.queries)} "
                 "queries")
    store = build_store(cfg, jnp.asarray(bench.pages),
                        jnp.asarray(bench.token_types))
    r = Retriever(store, capacity=512)
    q, qm = jnp.asarray(bench.queries), jnp.asarray(bench.query_mask)
    for name, stages in [("1-stage exact", JM.one_stage(10)),
                         ("2-stage (K=128)", JM.two_stage(128, 10)),
                         ("3-stage cascade", JM.three_stage(256, 128, 10))]:
        _, ids = r.search(q, qm, stages=stages)
        m = evaluate_ranking(np.asarray(ids), bench.qrels, ks=(5, 10))
        lines.append(f"[search] {name:18s} " +
                     "  ".join(f"{k}={v:.3f}" for k, v in m.items()))
    return lines


def test_quickstart_torch_equals_repro_on_the_cpu(capsys):
    qs = _example("quickstart_torch")
    assert qs.split(300) == (120, 100, 80)
    assert qs.split(PAGES) == (24, 20, 16)
    results = qs.main(["--device", "cpu", "--pages", str(PAGES),
                       "--queries", str(QUERIES)])
    out = capsys.readouterr().out.splitlines()
    want = _repro_lines(qs.split(PAGES))
    got = [ln for ln in out if ln.split(" ")[0] in ("[crop]", "[data]",
                                                    "[search]")]
    assert got == want
    assert set(results) == {name for name, _ in qs.CASCADES}
    index = [ln for ln in out if ln.startswith("[index]")]
    assert len(index) == 1 and "capacity 128" in index[0]
    mutate = [ln for ln in out if ln.startswith("[mutate]")]
    assert mutate == [f"[mutate] upserted 2x16, deleted 2x8 -> {PAGES + 16} "
                      "live docs; steady-state retraces: 0"]


def test_quickstart_torch_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example("quickstart_torch").main(["--pages", "30"])
