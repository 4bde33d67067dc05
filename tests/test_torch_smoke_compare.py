"""``chip_smoke.py``'s ranking comparison, on the CPU: a kernel's top k is
held against the plain ranking one deeper (k + 1), so a tie of the k-th
with the (k+1)-th plain score lets the kernel return the (k+1)-th
document at rank k, while a swap without a tie still fails the run and
names the rank."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


K = 10


def plain_ranking(tied_at_cutoff: bool):
    """Plain ids 0..10 with descending scores; the 10th and 11th scores
    equal when ``tied_at_cutoff``."""
    sc = np.linspace(1.0, 0.5, K + 1).astype(np.float32)[None]
    if tied_at_cutoff:
        sc[0, K] = sc[0, K - 1]
    return np.arange(K + 1)[None], sc


def test_a_cutoff_tie_passes(smoke):
    ids_p, sc_p = plain_ranking(tied_at_cutoff=True)
    ids_k = ids_p[:, :K].copy()
    ids_k[0, K - 1] = K                    # the (k+1)-th document at rank k
    sc_k = sc_p[:, :K].copy()
    assert smoke.compare_rankings(ids_k, sc_k, ids_p, sc_p, "cutoff") == 1
    # the same with exact ties only
    assert smoke.compare_rankings(ids_k, sc_k, ids_p, sc_p, "cutoff",
                                  tie=0.0) == 1


def test_a_near_cutoff_tie_passes_within_tie(smoke):
    ids_p, sc_p = plain_ranking(tied_at_cutoff=True)
    sc_p[0, K] -= 5e-5
    ids_k = ids_p[:, :K].copy()
    ids_k[0, K - 1] = K
    assert smoke.compare_rankings(ids_k, sc_p[:, :K].copy(), ids_p, sc_p,
                                  "near cutoff") == 1
    with pytest.raises(SystemExit):
        smoke.compare_rankings(ids_k, sc_p[:, :K].copy(), ids_p, sc_p,
                               "near cutoff", tie=0.0)


def test_a_swap_without_a_tie_fails_and_names_the_rank(smoke, capsys):
    ids_p, sc_p = plain_ranking(tied_at_cutoff=False)
    ids_k = ids_p[:, :K].copy()
    ids_k[0, K - 1] = K                    # no tie at the cutoff
    with pytest.raises(SystemExit):
        smoke.compare_rankings(ids_k, sc_p[:, :K].copy(), ids_p, sc_p,
                               "no tie")
    assert f"query 0 rank {K - 1} id {K} != {K - 1} without a tie" in \
        capsys.readouterr().err
    # inside the top k as well
    ids_k = ids_p[:, :K].copy()
    ids_k[0, [3, 4]] = ids_k[0, [4, 3]]
    with pytest.raises(SystemExit):
        smoke.compare_rankings(ids_k, sc_p[:, :K].copy(), ids_p, sc_p,
                               "inner swap")
    assert "rank 3" in capsys.readouterr().err


def test_an_inner_tie_swap_passes(smoke):
    ids_p, sc_p = plain_ranking(tied_at_cutoff=False)
    sc_p[0, 4] = sc_p[0, 3]
    ids_k = ids_p[:, :K].copy()
    ids_k[0, [3, 4]] = ids_k[0, [4, 3]]
    assert smoke.compare_rankings(ids_k, sc_p[:, :K].copy(), ids_p, sc_p,
                                  "inner tie") == 2


def test_the_plain_ranking_must_be_one_deeper(smoke, capsys):
    """A plain ranking of only k results cannot show a cutoff tie: the
    check refuses it, so every repaired phase must pass k + 1."""
    ids_p, sc_p = plain_ranking(tied_at_cutoff=True)
    with pytest.raises(SystemExit):
        smoke.compare_rankings(ids_p[:, :K], sc_p[:, :K], ids_p[:, :K],
                               sc_p[:, :K], "k deep")
    assert "not one deeper" in capsys.readouterr().err


def test_scores_are_held_to_the_plain_top_k(smoke):
    ids_p, sc_p = plain_ranking(tied_at_cutoff=False)
    sc_k = sc_p[:, :K].copy()
    sc_k[0, 2] += 1e-3
    with pytest.raises(SystemExit):
        smoke.compare_rankings(ids_p[:, :K].copy(), sc_k, ids_p, sc_p,
                               "scores")


def test_plus_one_deepens_the_last_stage(smoke):
    from repro_torch.core import multistage as MST
    two = MST.with_scan_policy(MST.two_stage(256, 10), use_kernel=False,
                               chunk=256)
    deeper = smoke.plus_one(two)
    assert [s.k for s in deeper] == [256, 11]
    assert deeper[0] == two[0] and deeper[1].vector == two[1].vector
    assert [s.k for s in smoke.plus_one(MST.one_stage(10))] == [11]
