"""``rerank_overcommit`` on the retrieval mesh: a shard scores at most
``cap_slots = min(L, ceil(L / S) * rerank_overcommit)`` of a stage's L
candidates, and a shard that owns more keeps the FIRST ones it owns in
``repro``'s candidate order (a stable owned-first compaction).

The port on a 4-position CPU mesh against ``repro``'s 4-device mesh (ONE
subprocess with ``--xla_force_host_platform_device_count=4``, as
``tests/test_torch_mesh_retrieval.py`` runs it) at overcommit 1, 2 and 8,
for rerank stages (2- and 3-stage cascades, plain and fused) and routed
stage 0 (``n_probe`` 2 and full), over three corpora: ``skewed`` puts
every query's best pages in shard 0's slab, so at overcommit 1 and 2
shard 0 owns more than ``cap_slots`` of every row's candidates and drops
some (the result then holds -1 sentinels); ``random`` drops on some rows
only; ``routed`` clusters a random corpus.

Tolerances: ids and -1 sentinels exact; scores rtol 1e-5, atol 1e-6.
Against the port itself: overcommit 8 (the default) is bit for bit the
retriever built without the argument.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.core import multistage as TM
from repro_torch.launch.mesh import make_mesh
from repro_torch.retrieval import store as TS
from repro_torch.retrieval.retriever import Retriever

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = dict(rtol=1e-5, atol=1e-6)
D, DP, DIM = 4, 2, 8
OVERCOMMITS = (1, 2, 8)
U = np.ones((DIM,), np.float32) / np.sqrt(DIM)
# a second direction at 45 degrees to U: queries rank its pages next
V = (U + np.resize([1.0, -1.0], DIM).astype(np.float32) / np.sqrt(DIM))
V = V / np.linalg.norm(V)


def _arrays(n: int, seed: int, skew: int = 0, second: int = 0) -> dict:
    """n random pages; the first ``second`` of them point along ``V`` at
    twice the norm, the next ``skew`` along ``U`` at three times, so every
    query (which leans on ``U``) ranks the ``U`` pages first and the ``V``
    pages next."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, D, DIM)).astype(np.float32)
    ini = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)
    ini[:second] = 2.0 * (V + 0.3 * ini[:second])
    lead = slice(second, second + skew)
    ini[lead] = 3.0 * (U + 0.3 * ini[lead])
    mask = r.random((n, D)) > 0.2
    mask[:, 0] = True
    return {"initial": ini, "initial_mask": mask,
            "mean_pooling": ini[:, :DP].copy(),
            "mean_pooling_mask": np.ones((n, DP), bool),
            "global_pooling": ini.mean(1)}


def _queries():
    r = np.random.default_rng(9)
    q = r.normal(size=(3, 5, DIM)).astype(np.float32) + 2.0 * U
    qm = r.random((3, 5)) > 0.2
    qm[:, 0] = True
    return q, qm


def corpora() -> dict:
    """name -> (pages, seed, (skew, second), capacity, routing): routing
    is None, a cluster count, or (clusters, member width C).
    ``routed_tight``'s K * C equals the capacity, so n_probe 2 gives each
    query R = 2C = 32 probed rows, and a shard may score ceil(R / 4) *
    overcommit of them. Shard 0 (slots 0-15) holds the ``V`` pages (0-7)
    and the ``U`` pages (8-15), two clusters that every query probes, U's
    first: at overcommit 1 shard 0 owns 16 rows, may score 8, and keeps
    the first 8 in ``repro``'s row order (cluster rank, then member), the
    ``U`` pages, not the 8 lowest slots."""
    return {"skewed": (32, 0, (8, 0), 32, None),
            "random": (40, 1, (0, 0), 48, None),
            "routed": (56, 2, (0, 0), 64, 4),
            "routed_skewed": (32, 3, (8, 0), 32, 2),
            "routed_tight": (64, 4, (8, 8), 64, (4, 16))}


def cascades(M, routed: bool) -> dict:
    two = M.two_stage(8, 4)
    if routed:
        n_k = 4
        return {"probe2": M.with_routing_policy(two, n_probe=2,
                                                n_clusters=n_k),
                "full": M.with_routing_policy(two, n_probe=n_k,
                                              n_clusters=n_k),
                "full_k12": M.with_routing_policy(M.two_stage(12, 6),
                                                  n_probe=n_k,
                                                  n_clusters=n_k),
                # stage 0 alone, k over the probed rows: every row a shard
                # keeps comes back, so the kept SET is compared
                "probe2_all": M.with_routing_policy(
                    (M.Stage("mean_pooling", 64),), n_probe=2,
                    n_clusters=n_k)}
    return {"two": two,
            "two_k12": M.two_stage(12, 10),
            "three": M.three_stage(16, 8, 4),
            "fused": M.with_rerank_policy(
                M.with_scan_policy(two, scan_topk=True, chunk=5),
                rerank_kernel=True)}


def cases():
    return [(c, name, oc) for c, spec in corpora().items()
            for name in cascades(TM, spec[4] is not None)
            for oc in OVERCOMMITS]


def port_pkg(mesh):
    from repro_torch.retrieval.routing import RoutingPolicy
    q, qm = _queries()

    def batch(n, seed, skew):
        return TS.VectorStore({k: torch.from_numpy(v) for k, v in
                               _arrays(n, seed, *skew).items()}, n, "float32")

    def search(r, stages):
        s, i = r.search(torch.from_numpy(q), torch.from_numpy(qm),
                        stages=stages)
        return s.numpy(), np.asarray(i)

    return types.SimpleNamespace(
        Retriever=lambda b, **kw: Retriever(b, mesh=mesh, **kw),
        batch=batch, M=TM, search=search, RoutingPolicy=RoutingPolicy)


def repro_pkg(mesh):
    import jax.numpy as jnp
    from repro.core import multistage as MST
    from repro.retrieval.retriever import Retriever as JRetriever
    from repro.retrieval.routing import RoutingPolicy
    from repro.retrieval.store import VectorStore
    q, qm = _queries()

    def search(r, stages):
        s, i = r.search(jnp.asarray(q), jnp.asarray(qm), stages=stages)
        return np.asarray(s), np.asarray(i)

    return types.SimpleNamespace(
        Retriever=lambda b, **kw: JRetriever(b, mesh=mesh, **kw),
        batch=lambda n, seed, skew: VectorStore(
            {k: jnp.asarray(v) for k, v in _arrays(n, seed, *skew).items()},
            n, "float32"),
        M=MST, search=search, RoutingPolicy=RoutingPolicy)


def _policy(P, routing):
    if isinstance(routing, tuple):
        return P.RoutingPolicy(n_clusters=routing[0],
                               cluster_capacity=routing[1])
    return routing


def recipe(P) -> dict:
    """(corpus, cascade, overcommit) -> (scores, ids)."""
    out = {}
    for cname, (n, seed, skew, cap, routing) in corpora().items():
        for oc in OVERCOMMITS:
            r = P.Retriever(P.batch(n, seed, skew), capacity=cap,
                            routing=_policy(P, routing),
                            rerank_overcommit=oc)
            for name, st in cascades(P.M, routing is not None).items():
                out[(cname, name, oc)] = P.search(r, st)
    return out


_REPRO_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax
sys.path.insert(0, os.path.dirname(sys.argv[3]))
from repro.launch.mesh import make_mesh
import test_torch_overcommit as T

mesh = make_mesh((4,), ("data",))
assert len(jax.devices()) == 4
out = {}
for (c, name, oc), (s, i) in T.recipe(T.repro_pkg(mesh)).items():
    out[f"{c}/{name}/{oc}/scores"], out[f"{c}/{name}/{oc}/ids"] = s, i
np.savez(sys.argv[2], **out)
print("OVERCOMMIT_REF_OK")
"""


def mesh4():
    return make_mesh((4,), ("data",), devices=["cpu"] * 4)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("overcommit")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    got = subprocess.run(
        [sys.executable, "-c", _REPRO_SCRIPT, "", str(d / "out.npz"),
         os.path.abspath(__file__)],
        env=env, capture_output=True, text=True, timeout=600)
    assert got.returncode == 0 and "OVERCOMMIT_REF_OK" in got.stdout, \
        got.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def port():
    return recipe(port_pkg(mesh4()))


@pytest.mark.parametrize("corpus,cascade,oc", cases())
def test_overcommit_matches_repro(ref, port, corpus, cascade, oc):
    s, i = port[(corpus, cascade, oc)]
    key = f"{corpus}/{cascade}/{oc}"
    np.testing.assert_array_equal(i, ref[key + "/ids"])
    np.testing.assert_allclose(s, ref[key + "/scores"], **TOL)


@pytest.mark.parametrize("oc", [1, 2])
def test_skewed_corpus_keeps_first_owned_candidates(port, oc):
    """The case the test is for: shard 0 owns all 8 of every row's
    stage-0 candidates and may score ``cap_slots = 2 * oc`` of them, so
    it keeps the first ``2 * oc`` in stage 0's order and drops the rest;
    no other shard has a live candidate, so the row is padded with -1
    sentinels up to k = 4."""
    P = port_pkg(mesh4())
    r = P.Retriever(P.batch(32, 0, (8, 0)), capacity=32)
    first = P.search(r, (TM.Stage("mean_pooling", 8),))[1]
    assert (first < 8).all()                 # all in shard 0's slab
    ids = port[("skewed", "two", oc)][1]
    full = port[("skewed", "two", 8)][1]
    assert (full >= 0).all()
    for row, cand in zip(ids, first):
        kept = row[row >= 0]
        assert sorted(kept) == sorted(cand[: 2 * oc])
        assert (row[len(kept):] == -1).all()
    assert not np.array_equal(ids, full)


def test_routed_corpora_drop_owned_rows(port):
    """After routed stage 0 at full probe over the skewed corpus, the
    rerank stage's 8 candidates all lie in shard 0, which at overcommit 1
    may score 2: -1 sentinels come back where overcommit 8 returns pages.
    Over ``routed_tight`` the routed stage itself drops: at overcommit 1
    shard 0 keeps the ``U`` pages (8-15, the first-ranked cluster) of the
    16 it owns, not the lowest 8 slots."""
    assert (port[("routed_skewed", "full", 8)][1] >= 0).all()
    assert (port[("routed_skewed", "full", 1)][1] < 0).any()
    full = port[("routed_tight", "probe2_all", 8)][1]
    tight = port[("routed_tight", "probe2_all", 1)][1]
    for a, b in zip(tight, full):
        assert set(range(16)) <= set(b)
        assert set(a) & set(range(16)) == set(range(8, 16))


def test_default_overcommit_is_eight():
    """Overcommit 8 (the default) is bit for bit the retriever built
    without the argument, for every corpus and cascade."""
    P = port_pkg(mesh4())
    for cname, (n, seed, skew, cap, routing) in corpora().items():
        a = P.Retriever(P.batch(n, seed, skew), capacity=cap,
                        routing=_policy(P, routing))
        b = P.Retriever(P.batch(n, seed, skew), capacity=cap,
                        routing=_policy(P, routing), rerank_overcommit=8)
        assert a.rerank_overcommit == 8
        for st in cascades(TM, routing is not None).values():
            sa, ia = P.search(a, st)
            sb, ib = P.search(b, st)
            np.testing.assert_array_equal(sa, sb)
            np.testing.assert_array_equal(ia, ib)


def test_overcommit_is_part_of_the_cache_key():
    """Changing a retriever's overcommit builds a new search function
    rather than reusing the one built for the old value."""
    P = port_pkg(mesh4())
    r = P.Retriever(P.batch(32, 0, (8, 0)), capacity=32)
    st = TM.two_stage(8, 4)
    f8 = r.search_fn(st)
    r.rerank_overcommit = 1
    f1 = r.search_fn(st)
    assert f1 is not f8
    assert (P.search(r, st)[1] < 0).any()
