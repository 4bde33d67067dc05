"""The dry run's counter and shortcut, no ``repro`` needed:

- the peak tracker on a hand-counted toy step (storages made, kept,
  freed; views and in-place ops make none);
- each kernel ``cost`` against the counter's count of its plain version
  on a small CPU input (scan, rerank, pool), and the wrappers on ``meta``
  inside the counting context (no launch, the cost recorded);
- a ``meta`` tensor given to a kernel wrapper outside it still raises;
- a meta mesh's single position-0 run against position 0 of a real run
  on a (2, 2) CPU mesh under the same counter (FLOPs, collective bytes
  by kind, argument bytes): a dp-only cell (``molecule``), a tp cell
  (an LM train step) and an explicit-body cell (the two-level
  minibatch), at the reduced configs;
- the CLI: results under its ``--out``, ``--device-bytes`` required
  without a card, a failing cell reported and exit code 1;
- the repaired microbatch split: with more dp positions than
  microbatches (the production meshes) the partitioned ``opt`` LM step
  equals the one-device step.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.distributed.sharding import is_meta_mesh
from repro_torch.kernels import dispatch as DSP
from repro_torch.kernels.embed_bag import ops as EOPS
from repro_torch.kernels.maxsim import ops as KOPS
from repro_torch.kernels.maxsim.ref import maxsim_ref
from repro_torch.kernels.pooling import ops as POPS
from repro_torch.launch import cells as TC
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.op_analysis import OpCounter, position_tensors
from test_torch_gnn import reduced as gnn_reduced

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the peak tracker
# ---------------------------------------------------------------------------

def test_peak_tracker_is_exact_on_a_hand_counted_step():
    """x [1024] f32 held (4096 B). y = x * 2 and z = y + 1 are made (4096
    each: 8192 at once), y freed, a view and an in-place add on z make
    nothing, w = z.sum() makes 4; 8192 is the most the step's own
    storages took, on top of the 4096 held."""
    x = torch.empty(1024, device="meta")
    c = OpCounter()
    c.add_arguments([x])
    with c:
        y = x * 2
        z = y + 1
        del y
        v = z.view(32, 32)
        v.add_(1)
        w = z.sum()
        kept = [w]
        del z, v
    assert c.held_bytes == c.argument_bytes == 4096
    assert c.peak_extra == 8192
    assert c.peak_bytes == 4096 + 8192
    # the results of mul, add, add_ and sum; the view writes nothing
    assert c.bytes_written == 4096 * 3 + 4
    assert c.ops == 5 and c.flops == 0 and kept


def test_unread_arguments_are_held_not_argument_bytes():
    """An argument no op reads counts in ``held_bytes`` only (XLA leaves
    it out of ``argument_size_in_bytes``); a matmul's FLOPs follow the
    dot rule."""
    a = torch.empty(8, 16, device="meta")
    b = torch.empty(16, 4, device="meta")
    unused = torch.empty(100, device="meta")
    c = OpCounter()
    c.add_arguments([a, b, unused])
    with c:
        out = a @ b
    assert c.held_bytes == (128 + 64 + 100) * 4
    assert c.argument_bytes == (128 + 64) * 4
    assert c.flops == 2 * 8 * 4 * 16
    assert c.block_bytes(out) == 8 * 4 * 4


# ---------------------------------------------------------------------------
# kernel costs
# ---------------------------------------------------------------------------

def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(2, 3, 8, generator=g)
    qm = torch.ones(2, 3)
    docs = torch.randn(5, 4, 8, generator=g)
    dm = torch.ones(5, 4)
    return q, qm, docs, dm


def _plain_flops(fn, *args) -> float:
    c = OpCounter()
    with c:
        fn(*args)
    return c.flops


def test_scan_cost_counts_the_plain_versions_flops():
    q, qm, docs, dm = _inputs()
    assert KOPS.scan_cost(q, qm, docs, dm)[0] == \
        _plain_flops(maxsim_ref, q, qm, docs, dm) == 2 * 6 * 20 * 8


def test_rerank_cost_counts_the_plain_versions_flops():
    q, qm, docs, dm = _inputs()
    rows = torch.tensor([[0, 3, 3], [4, 1, 2]], dtype=torch.int32)
    flops, nbytes = KOPS.rerank_cost(q, qm, docs, rows, dm)
    assert flops == _plain_flops(KOPS._rerank_ref, q, docs, rows, qm, dm) \
        == 2 * 2 * 3 * 3 * 4 * 8
    # the distinct candidates (0, 1, 2, 3, 4) once: 5 x D x (d x 4 + 1)
    assert nbytes == 6 * 4 + 2 * 2 * 3 * 4 + 5 * 4 * 33 + 6 * 4


def test_pool_cost_counts_the_plain_versions_flops():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 6, 8, generator=g)
    mask = torch.ones(3, 6)
    pm = torch.rand(4, 6, generator=g) + 0.1       # no structural zero
    assert POPS.pool_cost(x, mask, pm)[0] == \
        _plain_flops(POPS.pool_ref, x, mask, pm) == 2 * 3 * 24 * 9


def test_wrappers_on_meta_record_their_cost_inside_the_counter():
    """Inside the counter a meta tensor launches nothing and runs no
    plain version: each wrapper returns its result's shape and records
    its kernel's cost (every mask entry set, every candidate distinct)."""
    q, qm, docs, dm = (t.to("meta") for t in _inputs())
    rows = torch.empty(2, 3, dtype=torch.int32, device="meta")
    x, pm = torch.empty(3, 6, 8, device="meta"), torch.empty(4, 6,
                                                              device="meta")
    table = torch.empty(50, 8, device="meta")
    idx = torch.empty(4, 3, dtype=torch.int64, device="meta")
    DSP.reset_counts()
    c = OpCounter()
    with c:
        s = KOPS.maxsim_scores(q, docs, qm, dm)
        s_db = KOPS.maxsim_scores_chunked(q, docs, qm, dm, chunk=2)
        r = KOPS.maxsim_rerank(q, docs, rows, qm, dm)
        p = POPS.pool_pages_fused(x, torch.empty(3, 6, device="meta"), pm)
        b = EOPS.embed_bag(table, idx)
    assert [tuple(t.shape) for t in (s, s_db, r, p, b)] == [
        (2, 5), (2, 5), (2, 3), (3, 4, 8), (4, 8)]
    assert all(t.device.type == "meta" for t in (s, s_db, r, p, b))
    assert {k: v["calls"] for k, v in c.kernels.items()} == {
        "maxsim_scan": 1, "maxsim_scan_db": 1, "maxsim_rerank": 1,
        "pooling": 1, "embed_bag": 1}
    assert c.kernels["maxsim_scan"]["flops"] == 2 * 6 * 20 * 8
    assert c.kernels["maxsim_rerank"]["flops"] == 2 * 2 * 3 * 3 * 4 * 8
    assert c.kernels["pooling"]["flops"] == 2 * 3 * 24 * 9
    assert c.kernels["embed_bag"]["flops"] == 2 * 12 * 8
    assert all(DSP.launch_count(k) == 0 for k in DSP.KERNELS)


def test_meta_outside_the_counter_still_raises():
    """The device rule stands outside the dry run's counting context."""
    q, qm, docs, dm = (t.to("meta") for t in _inputs())
    rows = torch.empty(2, 3, dtype=torch.int32, device="meta")
    for call in (lambda: KOPS.maxsim_scores(q, docs, qm, dm),
                 lambda: KOPS.maxsim_scores_pipelined(q, docs, qm, dm,
                                                      chunk=2),
                 lambda: KOPS.maxsim_rerank(q, docs, rows, qm, dm),
                 lambda: POPS.pool_pages_fused(
                     torch.empty(1, 4, 8, device="meta"),
                     torch.ones(1, 4, device="meta"),
                     torch.ones(2, 4, device="meta")),
                 lambda: EOPS.embed_bag(
                     torch.empty(5, 8, device="meta"),
                     torch.zeros(2, 2, dtype=torch.int64, device="meta"))):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


# ---------------------------------------------------------------------------
# the shortcut: one meta position against position 0 of a real run
# ---------------------------------------------------------------------------

def _lm_cfg(get):
    from repro_torch.launch import train as TR
    return dataclasses.replace(TR.reduced_lm(get("minicpm-2b")),
                               vocab_size=500)


def _gnn_cfg(get):
    return gnn_reduced(get)


SHORTCUT = {
    "dp-only molecule": (
        "equiformer-v2", _gnn_cfg,
        ShapeSpec("molecule", "batched_graphs",
                  dict(n_nodes=6, n_edges=12, batch=8, d_feat=4))),
    "tp LM train": (
        "minicpm-2b", _lm_cfg,
        ShapeSpec("train_4k", "train", dict(seq_len=16, global_batch=4))),
    "explicit-body minibatch": (
        "equiformer-v2", _gnn_cfg,
        ShapeSpec("minibatch_lg", "minibatch",
                  dict(n_nodes=1000, n_edges=5000, batch_nodes=4,
                       fanout=(2, 2), d_feat=10))),
}


def _count(cell) -> OpCounter:
    c = OpCounter()
    c.add_arguments(position_tensors(cell.args))
    with c:
        cell.fn(*cell.args)
    return c


@pytest.mark.parametrize("name", sorted(SHORTCUT))
def test_one_meta_position_is_position_zero_of_a_real_run(monkeypatch,
                                                          name):
    arch, cfg_of, shape = SHORTCUT[name]
    cfg = cfg_of(get_config)
    monkeypatch.setattr(TC, "get_config", lambda a: cfg)
    build = {"equiformer-v2": TC.build_gnn_cell,
             "minicpm-2b": TC.build_lm_cell}[arch]
    real = build(arch, shape, "cpu", mesh=make_mesh(
        (2, 2), ("data", "model"), devices=["cpu"] * 4))
    meta_mesh = make_mesh((2, 2), ("data", "model"), devices=["meta"] * 4)
    assert is_meta_mesh(meta_mesh)
    meta = build(arch, shape, "meta", mesh=meta_mesh)
    got, want = _count(meta), _count(real)
    assert got.flops == want.flops > 0
    assert got.coll_bytes == want.coll_bytes
    assert sum(got.coll_bytes.values()) > 0
    assert got.argument_bytes == want.argument_bytes > 0
    assert got.held_bytes == want.held_bytes


def test_meta_mesh_runs_one_position():
    """On a meta mesh a body runs once, as position 0, and collectives
    give position 0's result shape; nothing is allocated."""
    from repro_torch.distributed import shard_map as SM
    mesh = make_mesh((2, 4), ("data", "model"), devices=["meta"] * 8)
    seen = []

    def body(x):
        seen.append((SM.axis_index("data"), SM.axis_index("model"),
                     SM.axis_size(("data", "model"))))
        g = SM.all_gather(x, "model", axis=1, tiled=True)
        s = SM.psum_scatter(g, "data", scatter_dimension=0)
        a = SM.all_to_all(s, "model", split_axis=1, concat_axis=0,
                          tiled=True)
        return SM.psum(a, ("data", "model"))

    c = OpCounter()
    with c:
        out = SM.shard_map(body, mesh, SM.P("data", "model"),
                           SM.P("data", "model"))(
            torch.empty(16, 32, device="meta"))
    assert seen == [(0, 0, 8)]
    # block [8, 8] -> gather [8, 32] -> scatter [4, 32] -> a2a [16, 8]
    assert tuple(out.shape) == (32, 32) and out.device.type == "meta"
    assert c.coll_bytes == {"all-gather": 8 * 32 * 4,
                            "all-reduce": 16 * 8 * 4,
                            "reduce-scatter": 4 * 32 * 4,
                            "all-to-all": 16 * 8 * 4,
                            "collective-permute": 0}
    with pytest.raises(ValueError, match="all meta"):
        make_mesh((2,), ("data",), devices=["meta", "cpu"])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_writes_its_results_and_reports_failures(tmp_path, monkeypatch):
    out = tmp_path / "dry.json"
    rc = DR.main(["--mesh", "tiny", "--arch", "dcn-v2", "--shape",
                  "serve_p99", "--device-bytes", str(80 * 10 ** 9),
                  "--out", str(out)])
    res = json.loads(out.read_text())
    assert rc == 0 and list(res) == ["dcn-v2|serve_p99|base",
                                     "dcn-v2|serve_p99|opt"]
    r = res["dcn-v2|serve_p99|base"]
    assert r["ok"] and r["fits"] and r["memory"]["argument_bytes"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            DR.main(["--mesh", "tiny", "--arch", "dcn-v2", "--shape",
                     "serve_p99", "--out", str(tmp_path / "x.json")])

    def broken(*a, **k):
        raise RuntimeError("planted")
    monkeypatch.setattr(TC, "build_cell", broken)
    bad = tmp_path / "bad.json"
    rc = DR.main(["--mesh", "tiny", "--arch", "dcn-v2", "--shape",
                  "serve_p99", "--variant", "base", "--device-bytes", "1",
                  "--out", str(bad)])
    res = json.loads(bad.read_text())
    assert rc == 1
    assert res["dcn-v2|serve_p99|base"]["ok"] is False
    assert "planted" in res["dcn-v2|serve_p99|base"]["error"]


def test_results_default_under_build():
    import os
    assert os.path.normpath(DR.RESULTS_DIR).endswith(
        os.path.join("build", "repro_torch", "dryrun"))


# ---------------------------------------------------------------------------
# the repaired microbatch split
# ---------------------------------------------------------------------------

def test_microbatches_split_over_more_dp_positions(monkeypatch):
    """8 microbatches over dp = 16 (the production meshes' dp): each
    position's rows lie in one microbatch, so the batch is gathered and
    each keeps its rows of every microbatch. The partitioned opt step
    equals the one-device opt step (f32)."""
    cfg = dataclasses.replace(
        get_config("minicpm-2b"), n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=4, head_dim=8, d_ff=64, vocab_size=64, loss_chunks=2,
        dtype="float32")
    monkeypatch.setattr(TC, "get_config", lambda a: cfg)
    shape = ShapeSpec("train_4k", "train", dict(seq_len=8,
                                                global_batch=128))
    one = TC.build_lm_cell("minicpm-2b", shape, "cpu", "opt")
    want = one.fn(*one.args)
    mesh = make_mesh((16, 1), ("data", "model"), devices=["cpu"] * 16)
    part = TC.build_lm_cell("minicpm-2b", shape, "cpu", "opt", mesh=mesh)
    got = part.fn(*part.args)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
