"""Whole runs of every cell on the CPU at a tiny size, with the harness's
look for a card skipped: an honest run is correct and its control is not;
the timed path broken underneath (an answer altered where it is produced,
half of the batch left out, the state returned unchanged) makes
``correct`` false. Also the count, trace and exit rules."""
import json
import subprocess
import sys
import time

import pytest
import torch

from perfbench import counts as K
from perfbench import harness as H
from perfbench import reference as R
from perfbench import trace as T

torch.set_num_threads(1)

CELLS = [w["name"] for w in json.loads(H.BENCHMARK.read_text())
         ["workloads"]]
SEED = 2 ** 31 + 99
CHECK = H.forbidden_modules         # before the fixture below replaces it


def tiny(name: str) -> H.Cell:
    """The cell at a size a test run holds: 64 pages, 16 queries, small
    k."""
    cell = H.load_cell(name)
    cell.config["corpus_pages"] = 64
    cell.config["generator"]["topics"] = 4
    t = cell.traffic
    t["pool"] = 16
    if t["loop"] == "closed":
        t["batch"] = 8
    else:
        t["rate"] = 100.0
    ks = (32, 16, 8)[-len(t["cascade"]):]
    for st, k in zip(t["cascade"], ks):
        st["k"] = k
    return cell


@pytest.fixture(autouse=True)
def _own_module_table(monkeypatch):
    """The harness refuses a result when the process holds JAX or the
    JAX package; a test worker holds them from the repository's other
    tests, so these runs check a table of the harness's own imports."""
    base = set(sys.modules)
    real = H.forbidden_modules
    monkeypatch.setattr(H, "forbidden_modules", lambda: real(
        [m for m in sys.modules if m not in base]))


def run(cell, seconds=0.3, traced=False, control=False):
    return H.run_cell(cell, SEED, seconds, traced, time.perf_counter(),
                      device="cpu", control=control)


@pytest.mark.parametrize("name", CELLS)
def test_an_honest_run_is_correct_and_its_control_is_not(name):
    cell = tiny(name)
    out = run(cell, control=True)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    for m in cell.end_to_end:
        assert out["metrics"][m["name"]]["value"] > 0
    assert any(out["control"][n] > cell.limits[n] for n in R.NUMBERS), \
        out["control"]


def _broken(kind):
    """A ``Retriever.search`` broken underneath the harness."""
    from repro_torch.retrieval.retriever import Retriever
    orig = Retriever.search
    last = {}

    def search(self, q, q_mask=None, **kw):
        scores, ids = orig(self, q, q_mask, **kw)
        as_np = not isinstance(ids, torch.Tensor)
        ids = torch.as_tensor(ids).clone()
        scores = scores.clone()
        if kind == "altered":
            scores[0, 0] += 1e-3
        elif kind == "half_batch":
            h = -(-ids.shape[0] // 2)
            ids[h:] = ids[:ids.shape[0] - h]
            scores[h:] = scores[:ids.shape[0] - h]
        elif kind == "stale":
            prev = last.get(tuple(ids.shape))
            last[tuple(ids.shape)] = (scores, ids)
            if prev is not None:
                scores, ids = prev
        return scores, ids.numpy() if as_np else ids

    return search


@pytest.mark.parametrize("name,kind", [
    ("colsmol.2stage.b64", "altered"), ("colsmol.2stage.b64", "half_batch"),
    ("colsmol.2stage.b64", "stale"), ("colqwen.3stage.b64", "altered"),
    ("colqwen.3stage.b64", "half_batch"),
    ("colsmol.2stage-int8.b64", "stale"),
    ("colsmol.2stage.open", "altered"), ("colsmol.2stage.open", "stale")])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, kind):
    from repro_torch.retrieval.retriever import Retriever
    monkeypatch.setattr(Retriever, "search", _broken(kind))
    cell = tiny(name)
    out = run(cell, seconds=0.6)
    assert not out["correct"], (kind, out["checks"])


def test_a_traced_run_reads_the_layers_it_can():
    cell = tiny("colqwen.3stage.b64")
    out = run(cell, traced=True)
    assert out["correct"]
    assert out["metrics"]["search_call_ms"]["value"] > 0
    assert out["device"]["window_s"] > 0
    assert len(out["breakdown"]["idle_gaps"]) <= 10


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    p = subprocess.run(
        [sys.executable, str(H.HERE / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=H.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_are_named_by_whole_top_level_name():
    table = ["torch", "repro_torch.core", "repro_torchish", "numpy"]
    assert CHECK(table) == []
    assert CHECK(table + ["jax.numpy", "reproduce"]) == ["jax"]
    assert CHECK(["repro.core", "flax", "jaxlib.xla"]) == \
        ["flax", "jaxlib", "repro"]


def test_counts_by_hand():
    pk = {"bf16_dense_flops": 1e12, "hbm_bytes_per_s": 1e9}
    # 2 queries of 3 and 5 valid tokens, 10 pages of 4 vectors, d 8
    assert K.scan_ops(8, 40, 8) == 2 * 8 * 40 * 8
    assert K.scan_bytes(10, 4, 8, 2, 0, 2 * 6) == 10 * 4 * 17 + 12 * 8 * 4
    assert K.scan_bytes(10, 4, 8, 1, 4, 0) == 10 * 4 * (8 + 4 + 1)
    assert K.single_vector_ops(2, 8, 10, 8) == 2 * 8 * (8 + 20)
    assert K.rerank_ops([3, 5], [7, 11], 8) == 2 * 8 * (21 + 55)
    assert K.rerank_bytes(9, 3, 4, 8, 2, 0, 6, 12) == \
        9 * 16 + 3 * 4 + 6 * 4 + 12 * 8 * 4
    assert K.bound_s(2e12, 1e9, pk) == 2.0
    assert K.bound_s(1e12, 3e9, pk) == 3.0


def test_rerank_counts_take_each_distinct_candidate_once():
    spec = H.load_cell("colqwen.3stage.b64").config
    from perfbench import corpus as C
    spec["corpus_pages"] = 8
    spec["generator"]["topics"] = 2
    cs = C.CorpusSpec.of(spec)
    tab = C.Tables(torch.zeros(2, 128), torch.zeros(8, dtype=torch.long),
                   torch.tensor([20, 21, 22, 23, 24, 25, 26, 27]))
    rows = torch.tensor([[0, 1, 1], [1, 2, 7]])
    ok = torch.tensor([[True, True, True], [True, True, False]])
    qm = torch.tensor([[True] * 3 + [False] * 29, [True] * 5 + [False] * 27])
    traffic = {"cascade": [{"vector": "global_pooling"}], "q_slots": 32}
    counted = H.rerank_counts([(784, 2, False, rows, ok, qm)], cs, tab,
                              traffic)
    w = H.count_work(cs, tab, traffic, [], counted)
    vv = [h * 28 for h in (20, 21, 22)]
    ops = 2 * 128 * (3 * (vv[0] + 2 * vv[1]) + 5 * (vv[1] + vv[2]))
    nbytes = K.rerank_bytes(sum(vv), 3, 784, 128, 2, 0, 6, 2 * 32)
    assert w.rerank == [(ops, nbytes)]


def test_rerank_work_counts_every_window_call_outside_the_window(
        monkeypatch):
    """The window runs with the rerank kernel unobserved; afterwards each
    distinct batch is searched once more and its counts stand for every
    search of it, in the window's order."""
    from repro_torch.kernels.maxsim import ops
    from perfbench import corpus as C
    cell = tiny("colqwen.3stage.b64")
    orig = ops.maxsim_rerank
    seen = []
    real_loop = H.closed_loop

    def loop(*a, **kw):
        seen.append(ops.maxsim_rerank is orig)
        return real_loop(*a, **kw)

    monkeypatch.setattr(H, "closed_loop", loop)
    assert run(cell, traced=True)["correct"]
    assert seen == [True] and ops.maxsim_rerank is orig

    dev = torch.device("cpu")
    retriever, spec, tab = H.build(cell, SEED, dev, T.Spans(traced=False))
    t = cell.traffic
    stages = H.program_stages(t)
    qs = C.queries(spec, SEED, tab, t["pool"], t["q_slots"],
                   tuple(t["q_valid"]))
    B = t["batch"]
    work = H.rerank_work(retriever, stages, qs, B, [1, 0, 1], spec, tab, t)
    per_search = len(t["cascade"]) - 1
    assert len(work) == 3 * per_search
    assert work[:per_search] == work[2 * per_search:]
    with H.RerankLog() as rlog:
        retriever.search(qs.q[:B], qs.mask[:B], stages=stages)
    assert H.rerank_counts(rlog.calls, spec, tab, t) == \
        work[per_search:2 * per_search]
    assert all(o > 0 and b > 0 for o, b in work)


def test_a_reader_that_loads_jax_leaves_no_result(monkeypatch, tmp_path,
                                                  capsys):
    """The gate on JAX and the JAX package comes after everything the run
    loads, the metric readers and the reference included."""
    for f in H.METRICS.glob("*.py"):
        (tmp_path / f.name).write_text(f.read_text())
    (tmp_path / "probe_ms.py").write_text(
        "import sys\nimport types\n\n\ndef read(run):\n"
        "    sys.modules.setdefault('jax._perfbench_probe',\n"
        "                           types.ModuleType('jax._perfbench_probe'))"
        "\n    return 1.0\n")
    monkeypatch.setattr(H, "METRICS", tmp_path)
    monkeypatch.delitem(sys.modules, "jax._perfbench_probe", raising=False)
    cell = tiny(CELLS[0])
    clean = run(cell)
    assert H.finish(clean) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads(json.dumps(clean))
    cell.end_to_end.append({"name": "probe_ms", "unit": "ms"})
    out = run(cell)
    assert out["metrics"]["probe_ms"]["value"] == 1.0
    assert H.finish(out) != 0
    got = capsys.readouterr()
    assert got.out == "" and "jax" in got.err
    sys.modules.pop("jax._perfbench_probe", None)


def test_a_suffixed_metric_falls_back_to_its_reader():
    assert H.reader("device_idle_share.open").__code__.co_filename == \
        str(H.METRICS / "device_idle_share.py")
    with pytest.raises(FileNotFoundError):
        H.reader("no_such_metric.open")


def test_trace_busy_and_gaps():
    tr = T.Trace(device=[("k1", 10, 20), ("k2", 15, 30), ("k3", 50, 60)],
                 host=[("window", 0, 100), ("search", 5, 45),
                       ("pump", 70, 90)], window=(0, 100))
    assert T.merged(tr.device, 0, 100) == [(10, 30), (50, 60)]
    assert T.busy_s(tr) == 30e-9
    assert T.kernel_s(tr, ("k2",)) == 15e-9
    g = T.gaps(tr)
    assert g[0] == ("pump", 40e-9) and ("search", 20e-9) in g
    assert ("search", 10e-9) in g
    b = T.breakdown(tr)
    assert b["device_ops"][0] == ["k2", 15e-9]
