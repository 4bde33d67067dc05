"""The dry run against ``repro``'s on the 2 x 4 mesh, the GNN and
retriever cells at full config (``tests/test_torch_dryrun.py`` holds the
recsys and LM cells and says what is held): the molecule and two-level
minibatch GNN cells, the ColSmol index cell (pooling through the
``pool.cu`` wrapper, its cost recorded), the ColPali 2-stage search over
the sharded corpus (the scan and rerank kernels' costs) and the ColQwen
train cell.

``minibatch_lg``'s body is written by hand in ``repro``: its reshard of
the edge buckets from dp x tp to dp (the all-gather of the four id arrays
and the receive mask the body reads; the send mask is never read, and
neither package gathers or counts it) and its all-reduces (the loss's
two psums and the replicated weights' gradients) are held equal."""
import pytest
import torch

from test_torch_dryrun import (check_argument_bytes, check_collectives,
                               check_flops, port_dryrun, repro_dryrun)

torch.set_num_threads(1)

CELLS = ("equiformer-v2|molecule|base", "equiformer-v2|minibatch_lg|base",
         "colsmol|index_1m|base", "colpali|search_1m|base",
         "colqwen|train_contrastive|base")
DIFF = {}
COLLECTIVES = {"equiformer-v2|minibatch_lg|base": ("all-gather",
                                                   "all-reduce")}


@pytest.fixture(scope="module")
def both():
    return port_dryrun(CELLS), repro_dryrun(CELLS)


@pytest.mark.parametrize("key", CELLS)
def test_argument_bytes_and_model_flops_equal_repros(both, key):
    port, ref = both
    assert port[key]["ok"]
    check_argument_bytes(port[key], ref[key])


@pytest.mark.parametrize("key", CELLS)
def test_struct_flops_within_two_percent(both, key):
    port, ref = both
    check_flops(key, port[key], ref[key], DIFF)


@pytest.mark.parametrize("key", sorted(COLLECTIVES))
def test_hand_written_collectives_equal_repros(both, key):
    port, ref = both
    check_collectives(key, port[key], ref[key], COLLECTIVES)


def test_kernel_costs_on_the_card_path(both):
    """The index cell pools through ``pool.cu``'s wrapper once and the
    2-stage search scans and reranks through the kernels' wrappers once
    a position: each records its cost (no launch, no plain version), and
    the search's FLOPs are the kernels'."""
    port, _ = both
    k = port["colsmol|index_1m|base"]["kernels"]
    assert k["pooling"]["calls"] == 1 and k["pooling"]["flops"] > 0
    s = port["colpali|search_1m|base"]
    assert {n: v["calls"] for n, v in s["kernels"].items()} == {
        "maxsim_scan": 1, "maxsim_rerank": 1}
    assert s["struct"]["flops"] == sum(v["flops"]
                                       for v in s["kernels"].values())
    assert s["memory"]["held_bytes"] > s["memory"]["argument_bytes"]


def test_search_gathers_its_stages_lists(both):
    """The 2-stage search all-gathers each stage's (score, id) lists, as
    ``repro``'s body does: four gathers."""
    port, ref = both
    c = port["colpali|search_1m|base"]["collectives"]
    assert c["counts"]["all-gather"] == ref["colpali|search_1m|base"][
        "collectives"]["counts"]["all-gather"] == 4
