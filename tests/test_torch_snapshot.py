"""Store snapshots across the two packages: the port writes
``repro.training.checkpoint``'s format, so

- a snapshot written by ``repro`` (``repro.retrieval.tiering.snapshot``)
  restores in ``repro_torch`` and one written by ``repro_torch`` restores
  in ``repro``; in both directions every segment array comes back bit
  for bit the writer's (bf16 vectors, int8 codes and f32 scales, bool
  masks, the tag words — uint32 in ``repro``, their int32 bit patterns
  in the port — and the IVF centroids and members), with the same
  capacities, fills, slot maps, ``RouteState``, router policy, next id,
  filter width and generation;
- searching the restored store gives the writer's ids (exhaustive,
  filtered and routed at full probe), scores within rtol=1e-5,
  atol=1e-5 (f32 sums in another order);
- a bit flipped on disk raises ``CheckpointCorrupt`` in the port naming
  the same ``seg<i>/<key>`` leaf that ``repro`` names, whichever package
  wrote the snapshot.
"""
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import multistage as JM
from repro.retrieval import faults as JFLT
from repro.retrieval import store as JS
from repro.retrieval import tiering as JTIER
from repro.retrieval.retriever import Retriever as JRetriever
from repro.training import checkpoint as JCKPT
from repro_torch.core import multistage as TM
from repro_torch.retrieval import faults as FLT
from repro_torch.retrieval import store as TS
from repro_torch.retrieval import tiering as TIER
from repro_torch.retrieval.retriever import Retriever
from repro_torch.training import checkpoint as CKPT

torch.set_num_threads(1)

D_FULL, D_POOL, DIM, CAP = 6, 2, 16, 64
TOL = dict(rtol=1e-5, atol=1e-5)
TWO = (TM.Stage("mean_pooling", 8), TM.Stage("initial", 4))
JTWO = (JM.Stage("mean_pooling", 8), JM.Stage("initial", 4))
RT = TM.with_routing_policy(TWO, n_probe=4, n_clusters=4)
JRT = JM.with_routing_policy(JTWO, n_probe=4, n_clusters=4)
FILTERS = ((None, None), (TS.FilterSpec(tenant=1), JS.FilterSpec(tenant=1)),
           (TS.FilterSpec(any_tags=(31, 40)),
            JS.FilterSpec(any_tags=(31, 40))))


def _arrays(n, seed):
    """bf16-exact float vectors (values on the bf16 grid), a per-token
    mask with dead tokens, ``mean_pooling`` without a mask."""
    r = np.random.default_rng(seed)
    full = r.normal(size=(n, D_FULL, DIM)).astype(np.float32)
    full = torch.from_numpy(full).bfloat16().float().numpy()
    mask = r.random((n, D_FULL)) > 0.2
    mask[:, 0] = True
    pooled = full.reshape(n, D_POOL, D_FULL // D_POOL, DIM).mean(2)
    pooled = torch.from_numpy(pooled).bfloat16().float().numpy()
    return {"initial": full * mask[..., None], "initial_mask": mask,
            "mean_pooling": pooled}


def _port_batch(n, seed):
    vs = TS.VectorStore({k: torch.from_numpy(v).bfloat16()
                         if v.dtype == np.float32 else torch.from_numpy(v)
                         for k, v in _arrays(n, seed).items()}, n, "bfloat16")
    return TS.quantize_store(vs, names=("initial",))


def _repro_batch(n, seed):
    vs = JS.VectorStore({k: jnp.asarray(v, jnp.bfloat16)
                         if v.dtype == np.float32 else jnp.asarray(v)
                         for k, v in _arrays(n, seed).items()}, n, "bfloat16")
    return JS.quantize_store(vs, names=("initial",))


def _build(port: bool, n_segs=3):
    """Three CAP-row segments with tenants, tags in two filter words (tag
    31 sets a word's sign bit), deletes and IVF routing over 4 clusters."""
    mk = _port_batch if port else _repro_batch
    kw = dict(capacity=CAP, filter_words=2, routing=4)
    r = (Retriever(mk(CAP, 0), device="cpu", **kw) if port
         else JRetriever(mk(CAP, 0), **kw))
    for s in range(1, n_segs):
        r.upsert(mk(CAP, s), tenant=s % 2, tags=(31 if s == 1 else 40, s))
    r.delete([2, CAP + 5, 2 * CAP + 7])
    return r


def _np(v):
    """A segment array as comparable numpy bits (bf16 as uint16, the tag
    words as uint32) from either package."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16)
        return v.numpy()
    a = np.asarray(v)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_same_store(got, want):
    """Every segment array and all the host bookkeeping equal bit for bit
    (the tag words compared as their uint32 bits)."""
    assert got.store_dtype == want.store_dtype
    assert got.next_id == want.next_id
    assert got.filter_words == want.filter_words
    assert got.generation == want.generation
    assert (got.router is None) == (want.router is None)
    if want.router is not None:
        for f in ("n_clusters", "cluster_capacity", "iters",
                  "drift_threshold"):
            assert getattr(got.router, f) == getattr(want.router, f)
    assert len(got.segments) == len(want.segments)
    for sg, sw in zip(got.segments, want.segments):
        assert sg.capacity == sw.capacity and sg.n_docs == sw.n_docs
        np.testing.assert_array_equal(sg.doc_ids, sw.doc_ids)
        np.testing.assert_array_equal(sg.routing.fills, sw.routing.fills)
        assert sg.routing.drift == sw.routing.drift
        assert set(sg.vectors) == set(sw.vectors)
        for k in sw.vectors:
            a, b = _np(sg.vectors[k]), _np(sw.vectors[k])
            if k == TS.FILTER_KEY:
                a, b = a.view(np.uint32), b.view(np.uint32)
            assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=k)


def _searches(r, port: bool):
    q = np.random.default_rng(9).normal(size=(3, 4, DIM)).astype(np.float32)
    if port:
        out = [r.search(q, stages=TWO, filter=f) for f, _ in FILTERS]
        out.append(r.search(q, stages=RT))
        return [(s.float().numpy(), i) for s, i in out]
    q = jnp.asarray(q)
    out = [r.search(q, stages=JTWO, filter=f) for _, f in FILTERS]
    out.append(r.search(q, stages=JRT))
    return [(np.asarray(s, np.float32), np.asarray(i)) for s, i in out]


def assert_same_results(got, want):
    for (gs, gi), (ws, wi) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, **TOL)


def test_repro_snapshot_restores_in_the_port(tmp_path):
    jr = _build(port=False)
    JTIER.snapshot(jr.store, str(tmp_path))
    r = Retriever.from_snapshot(str(tmp_path), device="cpu")
    assert_same_store(r.store, jr.store)
    assert r.store.segments[0].vectors["initial"].dtype == torch.bfloat16
    assert r.store.segments[0].vectors["initial_int8"].dtype == torch.int8
    assert r.store.segments[0].vectors[TS.FILTER_KEY].dtype == torch.int32
    assert_same_results(_searches(r, port=True), _searches(jr, port=False))


def test_port_snapshot_restores_in_repro(tmp_path):
    r = _build(port=True)
    r.snapshot(str(tmp_path))
    meta = JCKPT.load_meta(str(tmp_path))
    names = meta["leaf_names"]
    dtypes = dict(zip(names, meta["dtypes"]))
    assert dtypes["seg0/initial"] == "bfloat16"
    assert dtypes[f"seg0/{TS.FILTER_KEY}"] == "uint32"
    jr = JRetriever.from_snapshot(str(tmp_path))
    assert_same_store(jr.store, r.store)
    assert_same_results(_searches(jr, port=False), _searches(r, port=True))


def test_round_trips_agree_both_ways(tmp_path):
    """repro -> port -> repro and port -> repro -> port: the arrays that
    come back are the first writer's, bit for bit."""
    jr = _build(port=False)
    JTIER.snapshot(jr.store, str(tmp_path / "a"))
    r = Retriever.from_snapshot(str(tmp_path / "a"), device="cpu")
    r.snapshot(str(tmp_path / "b"))
    assert_same_store(JTIER.restore_store(str(tmp_path / "b")), jr.store)
    pr = _build(port=True)
    pr.snapshot(str(tmp_path / "c"))
    JTIER.snapshot(JTIER.restore_store(str(tmp_path / "c")),
                   str(tmp_path / "d"))
    assert_same_store(TIER.restore_store(str(tmp_path / "d"),
                                         device="cpu"), pr.store)


def _corrupt_label(exc_info) -> str:
    m = re.search(r"array '([^']+)'", str(exc_info.value))
    assert m, str(exc_info.value)
    return m.group(1)


@pytest.mark.parametrize("writer", ["repro", "port"])
@pytest.mark.parametrize("leaf", [0, 5, 11])
def test_bitflip_names_the_same_leaf(tmp_path, writer, leaf):
    plan = dict(snapshot_bitflip_leaf=leaf)
    if writer == "repro":
        JTIER.snapshot(_build(port=False).store, str(tmp_path),
                       faults=JFLT.FaultPlan(**plan))
    else:
        TIER.snapshot(_build(port=True).store, str(tmp_path),
                      faults=FLT.FaultPlan(**plan))
    with pytest.raises(CKPT.CheckpointCorrupt) as ours:
        TIER.restore_store(str(tmp_path), device="cpu")
    with pytest.raises(JCKPT.CheckpointCorrupt) as theirs:
        JTIER.restore_store(str(tmp_path))
    label = _corrupt_label(ours)
    assert label == _corrupt_label(theirs)
    assert label == JCKPT.load_meta(str(tmp_path))["leaf_names"][leaf]
    assert re.fullmatch(r"seg\d+/\w+", label)


def _flip_on_disk(step_dir: str, index: int) -> None:
    """Flip one bit in the middle of member ``leaf_<index>.npy`` of the
    step's archive, in place (media corruption under the zip's CRC)."""
    import os
    import struct
    import zipfile
    path = os.path.join(step_dir, "arrays.npz")
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo(f"leaf_{index}.npy")
    with open(path, "r+b") as f:
        f.seek(info.header_offset + 26)
        n_name, n_extra = struct.unpack("<HH", f.read(4))
        pos = info.header_offset + 30 + n_name + n_extra \
            + info.file_size // 2
        f.seek(pos)
        b = f.read(1)[0]
        f.seek(pos)
        f.write(bytes([b ^ 1]))


def test_bit_flipped_on_disk_names_the_leaf(tmp_path):
    """A bit flipped in the file after a clean write: the archive's own
    CRC-32 catches it on read, and the port raises ``CheckpointCorrupt``
    naming the leaf (``repro`` surfaces the zip's error as it is)."""
    r = _build(port=True)
    path = r.snapshot(str(tmp_path))
    names = CKPT.load_meta(str(tmp_path))["leaf_names"]
    leaf = names.index("seg1/initial")
    _flip_on_disk(path, leaf)
    with pytest.raises(CKPT.CheckpointCorrupt, match="'seg1/initial'"):
        Retriever.from_snapshot(str(tmp_path), device="cpu")
