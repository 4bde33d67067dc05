"""The retrieval mesh path end to end: ``Retriever(mesh=...)`` over a
segmented store placed on a 4-shard mesh, against ``repro``'s 4-device
mesh, and against the port itself.

``repro``'s side runs in ONE subprocess (``XLA_FLAGS=
--xla_force_host_platform_device_count=4``) that replays the same
recipes on the same numpy batches and writes every result to an
``.npz``; the port replays them on ``make_mesh((4,), ("data",),
devices=["cpu"] * 4)``. Mirrors ``tests/test_segments.py:297`` (upsert,
delete, a new segment, ``compact``), ``tests/test_filters.py:616``
(tenant and tag filters across shard boundaries),
``tests/test_routing.py:309`` (routed, full probe and ``n_probe`` 2),
``tests/test_dispatch.py:282`` (no duplicate page when k exceeds the
live candidates) and ``tests/test_tiering.py:325`` (tiered search and
snapshots on the mesh; here snapshots also cross between the packages:
the port's restores in ``repro`` on its 4-device mesh and ``repro``'s on
the port's mesh and on one device).

Against the port itself: a 1-position mesh equals ``mesh=None`` bit for
bit (``tests/test_retrieval.py:129``, ``tests/test_dispatch.py:158,202``),
so does a raw store dict split over the mesh on each call
(``make_search_fn(mesh=)``); a placed store without its mesh raises; the
fused ingest onto a
mesh store equals ``index`` + ``add_pages`` on the same mesh bit for
bit; tiered search equals the resident mesh search bit for bit; the
frontend's micro-batched answers equal its per-request ones bit for
bit; steady-state mutation and filter swaps build nothing.

Tolerances: ids, -1 sentinels, masks, capacities and ``n_shards`` exact;
scores rtol 1e-5, atol 1e-6.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.base import RetrieverConfig
from repro_torch.core import multistage as TM
from repro_torch.core.hygiene import SPECIAL, VISUAL
from repro_torch.launch.mesh import make_mesh
from repro_torch.retrieval import tracing
from repro_torch.retrieval import store as TS
from repro_torch.retrieval.frontend import ServingFrontend
from repro_torch.retrieval.ingest import IngestPipeline
from repro_torch.retrieval.retriever import Retriever
from repro_torch.retrieval.segments import SegmentedStore
from repro_torch.training import checkpoint as CKPT

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = dict(rtol=1e-5, atol=1e-6)
D, DP, DIM = 4, 2, 8
NEG = -1e30


def _arrays(n: int, seed: int) -> dict:
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, D, DIM)).astype(np.float32)
    ini = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)
    mask = r.random((n, D)) > 0.2
    mask[:, 0] = True
    return {"initial": ini, "initial_mask": mask,
            "mean_pooling": ini[:, :DP].copy(),
            "mean_pooling_mask": np.ones((n, DP), bool),
            "global_pooling": ini.mean(1)}


def _queries():
    r = np.random.default_rng(9)
    q = r.normal(size=(3, 5, DIM)).astype(np.float32)
    qm = r.random((3, 5)) > 0.2
    qm[:, 0] = True
    return q, qm


def _cascades(M) -> dict:
    two = M.two_stage(8, 4)
    return {
        "one": M.one_stage(6),
        "two": two,
        "three": M.three_stage(12, 8, 4),
        "fused": M.with_rerank_policy(
            M.with_scan_policy(two, scan_topk=True, chunk=5),
            rerank_kernel=True),
    }


def _tier_stages(M) -> dict:
    st = (M.Stage("mean_pooling", 6), M.Stage("initial", 3))
    return {"st": st,
            "rt": M.with_routing_policy(st, n_probe=2, n_clusters=2)}


def port_pkg(mesh=None):
    """The recipes' view of the port: its Retriever, batches, stages,
    filters and a search that returns numpy."""
    q, qm = _queries()

    def batch(n, seed):
        return TS.VectorStore({k: torch.from_numpy(v) for k, v in
                               _arrays(n, seed).items()}, n, "float32")

    def search(r, stages, spec=None):
        s, i = r.search(torch.from_numpy(q), torch.from_numpy(qm),
                        stages=stages, filter=spec)
        return s.numpy(), np.asarray(i)

    def retriever(b, **kw):
        return Retriever(b, mesh=mesh, device=None if mesh else "cpu", **kw)

    def valid(seg):
        return seg.tensor("doc_valid").numpy()

    return types.SimpleNamespace(Retriever=retriever, batch=batch, M=TM,
                                 FilterSpec=TS.FilterSpec, search=search,
                                 valid=valid)


def repro_pkg(mesh=None):
    """The same view of ``repro`` (on its own mesh, or one device)."""
    import jax.numpy as jnp
    from repro.core import multistage as MST
    from repro.retrieval.retriever import Retriever as JRetriever
    from repro.retrieval.store import FilterSpec, VectorStore
    q, qm = _queries()

    def search(r, stages, spec=None):
        s, i = r.search(jnp.asarray(q), jnp.asarray(qm), stages=stages,
                        filter=spec)
        return np.asarray(s), np.asarray(i)

    return types.SimpleNamespace(
        Retriever=lambda b, **kw: JRetriever(b, mesh=mesh, **kw),
        batch=lambda n, seed: VectorStore(
            {k: jnp.asarray(v) for k, v in _arrays(n, seed).items()}, n,
            "float32"),
        M=MST, FilterSpec=FilterSpec, search=search,
        valid=lambda seg: np.asarray(seg.vectors["doc_valid"]))


# ---------------------------------------------------------------------------
# recipes, replayed by both packages: name -> (scores, ids), and state
# ---------------------------------------------------------------------------

def _state(P, store) -> dict:
    return {"capacities": np.asarray(store.capacities),
            "n_shards": np.asarray(store.n_shards),
            "doc_ids": np.concatenate([s.doc_ids for s in store.segments]),
            "doc_valid": np.concatenate([P.valid(s) for s in store.segments]),
            "nbytes": np.asarray([s.nbytes for s in store.segments])}


def recipe_mutation(P) -> tuple:
    C = _cascades(P.M)
    r = P.Retriever(P.batch(13, 0), capacity=32)
    res = {"start/two": P.search(r, C["two"])}
    r.upsert(P.batch(7, 1))
    r.upsert(P.batch(20, 2))            # past the headroom: a new segment
    r.delete([2, 15, 30])
    for name, st in C.items():
        res["mut/" + name] = P.search(r, st)
    st_mut = _state(P, r.store)
    r.compact()
    res["compact/two"] = P.search(r, C["two"])
    return res, {"mut": st_mut, "compact": _state(P, r.store)}


def filter_specs(P) -> dict:
    F = P.FilterSpec
    return {"none": None, "t0": F(tenant=0), "t1": F(tenant=1),
            "t1_req2": F(tenant=1, require_tags=(2,)),
            "any_2_40": F(any_tags=(2, 40))}


def recipe_filters(P) -> dict:
    # 21 docs in one 24-slot segment: tenant boundaries cross shards
    r = P.Retriever(P.batch(9, 0), capacity=24, filter_words=2)
    r.upsert(P.batch(7, 1), tenant=1, tags=(2,))
    r.upsert(P.batch(5, 2), tenant=1, tags=(40,))
    r.delete([3, 11])
    two = P.M.two_stage(8, 4)
    return {name: P.search(r, two, spec)
            for name, spec in filter_specs(P).items()}


def routed_stages(M) -> dict:
    two = M.two_stage(8, 4)
    return {"exhaustive": two,
            "full": M.with_routing_policy(two, n_probe=4, n_clusters=4),
            "probe2": M.with_routing_policy(two, n_probe=2, n_clusters=4)}


def recipe_routed(P) -> dict:
    r = P.Retriever(P.batch(30, 0), capacity=64, routing=4)
    r.upsert(P.batch(9, 1), tenant=1)
    r.delete([2, 17, 31])
    return {f"{name}/{fn}": P.search(r, st, spec)
            for name, st in routed_stages(P.M).items()
            for fn, spec in (("all", None),
                             ("t1", P.FilterSpec(tenant=1)))}


def recipe_dup(P) -> dict:
    r = P.Retriever(P.batch(8, 3), capacity=8)
    r.upsert(P.batch(4, 4))
    r.delete(list(range(6)))                      # 6 live docs, 2 segments
    # 3 stages: a filler copy that kept a live id would be rescored by
    # its owner in the last stage and come back a duplicate with a real
    # score
    return {"k_over_live": P.search(r, P.M.two_stage(12, 10)),
            "k_over_live3": P.search(r, P.M.three_stage(12, 10, 8))}


def recipe_tiered(P):
    """``tests/test_tiering.py:325``'s store: 3 segments of 16, routing,
    tenants, two deletes."""
    r = P.Retriever(P.batch(16, 0), capacity=16, routing=2)
    for s in (1, 2):
        r.upsert(P.batch(16, s), tenant=s % 2)
    r.delete([2, 21])
    return r


def tiered_searches(P, r) -> dict:
    return {f"{sn}/{fn}": P.search(r, st, spec)
            for sn, st in _tier_stages(P.M).items()
            for fn, spec in (("all", None),
                             ("t1", P.FilterSpec(tenant=1)))}


_REPRO_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax
sys.path.insert(0, os.path.dirname(sys.argv[3]))
from repro.launch.mesh import make_mesh
from repro.retrieval.retriever import Retriever
import test_torch_mesh_retrieval as T

mesh = make_mesh((4,), ("data",))
assert len(jax.devices()) == 4
P = T.repro_pkg(mesh)
out = {}
def put(prefix, res):
    for name, (s, i) in res.items():
        out[f"{prefix}/{name}/scores"], out[f"{prefix}/{name}/ids"] = s, i
res, states = T.recipe_mutation(P)
put("mutation", res)
for when, st in states.items():
    for k, v in st.items():
        out[f"state/{when}/{k}"] = v
put("filters", T.recipe_filters(P))
put("routed", T.recipe_routed(P))
put("dup", T.recipe_dup(P))
# the port's 4-shard snapshot, restored onto this 4-device mesh
r = Retriever.from_snapshot(sys.argv[4], mesh=mesh)
assert r.store.n_shards == 4
assert r.store.segments[0].vectors["ivf_centroids"].sharding \
    .is_fully_replicated
put("port_snapshot", T.tiered_searches(P, r))
# this package's own 4-shard store and its snapshot
r = T.recipe_tiered(P)
put("tiered", T.tiered_searches(P, r))
r.snapshot(sys.argv[5])
np.savez(sys.argv[2], **out)
print("MESH_RETRIEVAL_REF_OK")
"""


def mesh4():
    return make_mesh((4,), ("data",), devices=["cpu"] * 4)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Writes the port's 4-shard snapshot, then runs ``repro``'s side
    once: every recipe, the restore of that snapshot, and ``repro``'s own
    snapshot. Returns (results, port snapshot dir, repro snapshot
    dir)."""
    d = tmp_path_factory.mktemp("mesh_retrieval")
    port_snap, repro_snap = d / "port_snap", d / "repro_snap"
    recipe_tiered(port_pkg(mesh4())).snapshot(str(port_snap))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    got = subprocess.run(
        [sys.executable, "-c", _REPRO_SCRIPT, "", str(d / "out.npz"),
         os.path.abspath(__file__), str(port_snap), str(repro_snap)],
        env=env, capture_output=True, text=True, timeout=600)
    assert got.returncode == 0 and "MESH_RETRIEVAL_REF_OK" in got.stdout, \
        got.stderr[-3000:]
    return dict(np.load(d / "out.npz")), str(port_snap), str(repro_snap)


def _same_as_repro(got: tuple, out: dict, key: str) -> None:
    s, i = got
    np.testing.assert_array_equal(i, out[key + "/ids"])
    np.testing.assert_allclose(s, out[key + "/scores"], **TOL)


def _bitwise(a: tuple, b: tuple) -> None:
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


# ---------------------------------------------------------------------------
# against repro's 4-device mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mutation():
    return recipe_mutation(port_pkg(mesh4()))


@pytest.mark.parametrize("key", ["start/two"] + [
    f"mut/{n}" for n in _cascades(TM)] + ["compact/two"])
def test_mutation_matches_repro(ref, mutation, key):
    """Upserts (one past the headroom: a new segment), deletes and
    ``compact`` on 4 shards: ``repro``'s page ids and scores for the 1-,
    2- and 3-stage cascades and the fused candidate path."""
    out = ref[0]
    _same_as_repro(mutation[0][key], out, "mutation/" + key)


@pytest.mark.parametrize("when", ["mut", "compact"])
def test_mutation_state_matches_repro(ref, mutation, when):
    """Capacities (multiples of 4), ``n_shards``, the slot map, the
    validity masks gathered from the slabs and each segment's bytes (the
    whole segment, as ``repro``'s global arrays count it): exact."""
    out = ref[0]
    got = mutation[1][when]
    for k, v in got.items():
        np.testing.assert_array_equal(v, out[f"state/{when}/{k}"], err_msg=k)
    assert (got["capacities"] % 4 == 0).all() and int(got["n_shards"]) == 4


@pytest.mark.parametrize("name", list(filter_specs(port_pkg())))
def test_filters_match_repro(ref, name):
    """Tenant and tag filters over a corpus whose tenant boundaries cross
    shard boundaries: ``repro``'s ids and scores; no id outside the
    filter."""
    got = recipe_filters(port_pkg(mesh4()))[name]
    _same_as_repro(got, ref[0], "filters/" + name)
    if name.startswith("t0"):
        assert set(got[1][got[1] >= 0]) <= set(range(9))


@pytest.mark.parametrize("key", [f"{n}/{f}" for n in routed_stages(TM)
                                 for f in ("all", "t1")])
def test_routed_matches_repro(ref, key):
    """Routed search on 4 shards (one clustering of the whole segment,
    the same centroids and member lists on every shard), at full probe
    and at ``n_probe`` 2, with and without a tenant filter: ``repro``'s
    ids and scores."""
    got = recipe_routed(port_pkg(mesh4()))
    _same_as_repro(got[key], ref[0], "routed/" + key)


def test_routed_full_probe_is_exhaustive():
    got = recipe_routed(port_pkg(mesh4()))
    for f in ("all", "t1"):
        _bitwise(got[f"full/{f}"], got[f"exhaustive/{f}"])


def test_routing_index_is_replicated():
    """One clustering over the whole segment, copied whole to every
    shard; equal to the single-device store's index."""
    r4 = port_pkg(mesh4()).Retriever(port_pkg().batch(30, 0), capacity=64,
                                     routing=4)
    r1 = port_pkg().Retriever(port_pkg().batch(30, 0), capacity=64,
                              routing=4)
    for key in ("ivf_centroids", "ivf_members"):
        slabs = r4.store.segments[0].slabs
        assert len(slabs) == 4
        for slab in slabs:
            assert torch.equal(slab[key], r1.store.segments[0].vectors[key])
        assert slabs[1][key].data_ptr() != slabs[0][key].data_ptr()


def test_repro_store_placed_on_port_mesh(mutation):
    """A ``repro`` store (one device, upserts past its headroom and
    deletes) carried across with ``SegmentedStore.from_numpy(mesh=)``:
    placed on the port's 4 shards it answers as the port's own mesh store
    after the same mutations."""
    J = repro_pkg()
    jr = J.Retriever(J.batch(13, 0), capacity=32)
    jr.upsert(J.batch(7, 1))
    jr.upsert(J.batch(20, 2))
    jr.delete([2, 15, 30])
    ts = SegmentedStore.from_numpy(jr.store, mesh=mesh4())
    assert ts.n_shards == 4 and all(len(g.slabs) == 4 for g in ts.segments)
    r = Retriever(ts, mesh=mesh4())
    P = port_pkg(mesh4())
    for name, st in _cascades(TM).items():
        got = P.search(r, st)
        want = mutation[0]["mut/" + name]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], **TOL)


@pytest.mark.parametrize("key", ["k_over_live", "k_over_live3"])
def test_no_duplicate_ids_when_k_exceeds_live(ref, key):
    """k above the live candidates: the filler is -1, never a second copy
    of a live page; ids equal ``repro``'s."""
    got = recipe_dup(port_pkg(mesh4()))[key]
    _same_as_repro(got, ref[0], "dup/" + key)
    ids = got[1]
    for row in ids:
        live = row[row >= 0]
        assert len(live) == len(set(live)), row
    assert (ids == -1).any()


# ---------------------------------------------------------------------------
# snapshots across the packages, tiering on the mesh
# ---------------------------------------------------------------------------

def test_port_snapshot_restores_in_repro_mesh(ref):
    """The port's 4-shard snapshot (``n_shards`` 4 in its meta) restored
    by ``repro`` onto its 4-device mesh answers as the port's store."""
    out, port_snap, _ = ref
    assert CKPT.load_meta(port_snap)["meta"]["n_shards"] == 4
    P = port_pkg(mesh4())
    mine = tiered_searches(P, recipe_tiered(P))
    for key, got in mine.items():
        _same_as_repro(got, out, "port_snapshot/" + key)


def test_repro_snapshot_restores_on_port_mesh(ref):
    """``repro``'s 4-shard snapshot restored onto the port's mesh answers
    as ``repro``'s store; restored onto one device it gives the same ids
    (the same store, searched unsharded)."""
    out, _, repro_snap = ref
    P = port_pkg(mesh4())
    r = Retriever.from_snapshot(repro_snap, mesh=mesh4())
    assert r.store.n_shards == 4 and r.store.mesh == mesh4()
    for seg in r.store.segments:
        slabs = seg.slabs
        assert len(slabs) == 4 and all(
            torch.equal(s["ivf_members"], slabs[0]["ivf_members"])
            for s in slabs)
    on_mesh = tiered_searches(P, r)
    for key, got in on_mesh.items():
        _same_as_repro(got, out, "tiered/" + key)
    r1 = Retriever.from_snapshot(repro_snap, device="cpu")
    assert r1.store.n_shards == 4 and r1.store.mesh is None
    for key, got in tiered_searches(port_pkg(), r1).items():
        np.testing.assert_array_equal(got[1], on_mesh[key][1])
        np.testing.assert_allclose(got[0], on_mesh[key][0], **TOL)


def test_snapshot_round_trip_on_mesh_is_bitwise(tmp_path):
    """A 4-shard store snapshotted and restored onto the mesh: the same
    slabs bit for bit and the same answers bit for bit."""
    P = port_pkg(mesh4())
    r = recipe_tiered(P)
    r.snapshot(str(tmp_path))
    r2 = Retriever.from_snapshot(str(tmp_path), mesh=mesh4())
    for a, b in zip(r.store.segments, r2.store.segments):
        for sa, sb in zip(a.slabs, b.slabs):
            assert set(sa) == set(sb)
            for k in sa:
                assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k],
                                                                  sb[k])
    want = tiered_searches(P, r)
    for key, got in tiered_searches(P, r2).items():
        _bitwise(got, want[key])


def test_tiered_mesh_equals_resident_mesh_bitwise():
    """A budget of one segment: promotions and demotions slab by slab,
    every scope run as one joint sharded cascade, bit for bit the
    resident mesh search."""
    P = port_pkg(mesh4())
    r = recipe_tiered(P)
    want = tiered_searches(P, r)
    seg_bytes = r.store.segments[0].nbytes
    q, qm = _queries()
    with r.tiered(seg_bytes + 1) as eng:
        for key, (st, spec) in {
                f"{sn}/{fn}": (st, sp)
                for sn, st in _tier_stages(TM).items()
                for fn, sp in (("all", None),
                               ("t1", TS.FilterSpec(tenant=1)))}.items():
            s, i = eng.search(q, qm, stages=st, filter=spec)
            _bitwise((s.numpy(), i), want[key])
        assert eng.stats["demotions"] > 0 and eng.stats["promotions"] > 0
        assert all(len(seg.slabs) == 4 for seg in r.store.segments)
        # a scope of one segment answers as a resident search of it
        s, i = eng.search(q, qm, stages=_tier_stages(TM)["st"], scope=(1,))
        assert set(i[i >= 0]) <= set(r.store.segments[1].doc_ids)


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------

def _all_searches(P) -> dict:
    """The mutation recipe's searches plus routed and filtered ones."""
    res, _ = recipe_mutation(P)
    res.update({"routed/" + k: v for k, v in recipe_routed(P).items()})
    res.update({"filters/" + k: v for k, v in recipe_filters(P).items()})
    res.update({"dup/" + k: v for k, v in recipe_dup(P).items()})
    return res


def test_one_position_mesh_is_no_mesh_bitwise():
    """Every recipe on a 1-position mesh gives ``mesh=None``'s ids and
    scores bit for bit."""
    m1 = make_mesh((1,), ("data",), devices=["cpu"])
    one = _all_searches(port_pkg(m1))
    none = _all_searches(port_pkg())
    assert one.keys() == none.keys()
    for k in one:
        _bitwise(one[k], none[k])


def test_raw_store_split_per_call_equals_placed_bitwise():
    """``make_search_fn(mesh=)`` on a raw 21-row store dict pads it to 24
    rows and splits it over the mesh on each call: the answers of the
    same rows placed on the mesh by a ``Retriever`` (page id = row) bit
    for bit."""
    from repro_torch.retrieval.engine import make_search_fn
    P = port_pkg(mesh4())
    batch = P.batch(21, 0)
    placed = P.Retriever(batch, capacity=24)
    assert [len(g.slabs) for g in placed.store.segments] == [4]
    q, qm = _queries()
    for st in _cascades(TM).values():
        s, i = make_search_fn(st, 21, mesh=mesh4())(
            batch.vectors, torch.from_numpy(q), torch.from_numpy(qm))
        _bitwise((s.numpy(), i.numpy()), P.search(placed, st))


def test_placed_store_without_mesh_raises():
    """A store placed on 4 shards handed to a ``Retriever`` without a
    mesh raises a ValueError that names the placement, rather than
    failing inside the single-device engine."""
    placed = port_pkg(mesh4()).Retriever(port_pkg().batch(21, 0),
                                         capacity=24).store
    J = repro_pkg()
    carried = SegmentedStore.from_numpy(
        J.Retriever(J.batch(21, 0), capacity=24).store, mesh=mesh4())
    for store in (placed, carried):
        with pytest.raises(ValueError, match="placed on a mesh of 4"):
            Retriever(store, device="cpu")


def test_indivisible_capacity_raises():
    store = SegmentedStore.from_store(port_pkg().batch(21, 0), capacity=30)
    with pytest.raises(ValueError, match="not divisible"):
        Retriever(store, mesh=mesh4())


def test_steady_state_builds_nothing():
    """Upserts into headroom, deletes and filter swaps on the mesh build
    no search function once warm."""
    P = port_pkg(mesh4())
    r = P.Retriever(P.batch(9, 0), capacity=64, filter_words=2)
    two = TM.two_stage(8, 4)
    P.search(r, two)
    before = tracing.trace_count()
    for s in range(1, 4):
        r.upsert(P.batch(5, s), tenant=s % 2, tags=(s,))
        r.delete([s])
        for spec in (None, TS.FilterSpec(tenant=1),
                     TS.FilterSpec(any_tags=(2,))):
            P.search(r, two, spec)
    assert tracing.trace_count() == before


_MINI = RetrieverConfig(name="mini-grid", geometry="grid", grid_h=8,
                        grid_w=8, smooth="conv1d", d_model=64, n_layers=1,
                        n_heads=1, d_ff=64, out_dim=16, n_special=3,
                        max_query_tokens=8)


def test_ingest_onto_mesh_equals_index_and_add_pages():
    """The fused ingest into a 4-shard store (the pooled batch indexed
    once, its rows split onto the slabs) leaves every slab bit for bit
    what ``index`` + ``add_pages`` leave on the same mesh, and the
    gathered segments equal a single-device ingest's."""
    cfg = _MINI
    r = np.random.default_rng(3)
    x = r.normal(size=(40, cfg.seq_len, cfg.out_dim)).astype(np.float32)
    pages = x / np.linalg.norm(x, axis=-1, keepdims=True)
    tt = np.asarray([SPECIAL] * cfg.n_special + [VISUAL] * cfg.n_patches,
                    np.int32)
    pipe = IngestPipeline.for_config(cfg, device="cpu")
    seed = pipe.index(pages[:8], tt)
    fused = Retriever(seed, mesh=mesh4(), capacity=64, ingest=pipe)
    legacy = Retriever(seed, mesh=mesh4(), capacity=64)
    single = Retriever(seed, device="cpu", capacity=64, ingest=pipe)
    for lo, hi, kw in ((8, 19, dict(tenant=2, tags=(3,))), (19, 40, {})):
        ids = fused.ingest(pages[lo:hi], tt, **kw)
        np.testing.assert_array_equal(
            ids, legacy.upsert(pipe.index(pages[lo:hi], tt), **kw))
        single.ingest(pages[lo:hi], tt, **kw)
    for a, b, c in zip(fused.store.segments, legacy.store.segments,
                       single.store.segments):
        np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
        assert len(a.slabs) == 4
        for sa, sb in zip(a.slabs, b.slabs):
            assert set(sa) == set(sb)
            for k in sa:
                assert torch.equal(sa[k], sb[k]), k
        for k, v in c.vectors.items():
            assert torch.equal(a.tensor(k), v), k
    q = torch.from_numpy(r.normal(size=(3, 4, cfg.out_dim)).astype(
        np.float32))
    st = TM.two_stage(16, 5)
    _bitwise(*[tuple(np.asarray(t) for t in rr.search(q, stages=st))
               for rr in (fused, legacy)])


def test_frontend_on_mesh_bitwise():
    """The frontend over a 4-shard retriever: micro-batched answers (with
    padded rows) equal per-request dispatches bit for bit, and the
    retriever's own search on the unpadded query (ids equal, scores to
    1e-6: the plain path sums the padded token slots in another
    order)."""
    P = port_pkg(mesh4())
    r = P.Retriever(P.batch(24, 0), capacity=24)
    stages = _cascades(TM)["two"]
    fe = ServingFrontend(r, stages, max_batch=4, max_q=8, min_q=2,
                         flush_ms=1.0)
    fe.warm()
    rng = np.random.default_rng(5)
    reqs = [rng.normal(size=(b, int(rng.integers(1, 9)), DIM)).astype(
        np.float32) for b in [1] * 7 + [2]]
    pending = [fe.submit(q) for q in reqs]
    fe.drain()
    assert fe.stats["dispatches"] < len(reqs) and fe.stats["rows_padded"] > 0
    for q, pr in zip(reqs, pending):
        s1, i1 = fe.search(q)
        np.testing.assert_array_equal(pr.scores, s1)
        np.testing.assert_array_equal(pr.ids, i1)
        s2, i2 = r.search(q, stages=stages)
        np.testing.assert_allclose(pr.scores, s2.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(pr.ids, i2)
