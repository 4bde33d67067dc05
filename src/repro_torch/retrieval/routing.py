"""IVF cluster routing over the segmented corpus (PLAID-style).

The scan stage reads the whole corpus for every query. This module keeps
a coarse cluster index over each segment's pooled/global routing vectors,
so the engine can score a query against the centroids, probe the top
``n_probe`` clusters and score only their members: the read drops from
O(N * Q * d) to O((K + N * n_probe / K) * Q * d).

Two companion tensors per segment (reserved keys owned by
``repro_torch.retrieval.store``), sized so membership is data, not a
shape:

- ``ivf_centroids`` [K, d] f32 — cluster centroids of the routing vectors;
- ``ivf_members``   [K, C] int32 — per-cluster member SLOT lists, padded
  with -1. ``C`` is a power of two with K * C >= 4 * capacity, so an add
  always finds a cluster with room.

Every live slot appears in exactly one member list, so probing all K
clusters recovers the exhaustive candidate set (``n_probe == K``).

Maintenance:

- **clustering** (``cluster_segment``) — deterministic greedy k-means++
  init (start from the first live row, then repeatedly the live row
  farthest from the chosen set) and a few Lloyd iterations in which an
  empty cluster keeps its centroid; the assignment runs in chunks of
  ``KMEANS_CHUNK`` rows, bounding the [chunk, K] distance block. Ties
  break to the lower index (``argmin``/``argmax``), as in JAX. The
  products are plain float32 matrix products (TF32 off, ``full_f32``);
  the Lloyd sums are one-hot products, which add in a fixed order on the
  card too (an atomic scatter-add would not).
- **add** (``on_commit``) — new slots go to the nearest centroid WITH
  ROOM (a walk down the stable ``argsort`` of their distances) and are
  written into the member lists.
- **delete** — nothing moves: dead members are masked by
  ``effective_validity`` at query time. The drift counter ticks.
- **drift** — ``RouteState.drift`` counts mutations since the last
  clustering; past ``drift_threshold`` of the segment's fill (and at
  least ``MIN_DRIFT``) the segment re-clusters at the same shapes.

The JAX package counts the retraces of these steps (``record_trace``);
eager PyTorch does not retrace, and these steps build no kernel library
and no search function, so they count nothing in the port's
``retrieval.tracing`` (``enable_routing`` changes the segment layout:
the next search builds its function once).

Layering: this module sits between ``store`` (whose key schema owns the
companion names) and ``segments`` (which calls the hooks below). The
store objects passed in are used through one attribute, ``router``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.dispatch import full_f32
from repro_torch.retrieval.store import (CENTROIDS_KEY, MEMBERS_KEY,
                                         ROUTING_KEYS, VALIDITY_KEY,
                                         VectorSchema, rerank_arrays)

KMEANS_ITERS = 8
KMEANS_CHUNK = 16384       # bounds the [chunk, K] assignment intermediate
MIN_DRIFT = 64             # re-cluster at most once per MIN_DRIFT mutations


@dataclass(frozen=True)
class RoutingPolicy:
    """Store-side IVF policy (the query-side knob, ``Stage.n_probe``, is
    on the cascade, see ``core.multistage``).

    n_clusters        K, clamped per segment to its capacity
    cluster_capacity  member-list width C; 0 = auto (a power of two with
                      K * C >= 4 * capacity)
    iters             Lloyd iterations after the k-means++ style init
    drift_threshold   fraction of the segment's high-water fill whose
                      mutations trigger a re-cluster (at least
                      ``MIN_DRIFT``)
    """
    n_clusters: int
    cluster_capacity: int = 0
    iters: int = KMEANS_ITERS
    drift_threshold: float = 0.5


@dataclass
class RouteState:
    """Host-side per-segment cluster bookkeeping (the tensors live in the
    segment's vectors dict under the reserved routing keys)."""
    fills: np.ndarray          # [K] occupied member-list entries
    drift: int = 0             # mutations since the last clustering


def segment_clusters(policy: RoutingPolicy, capacity: int) -> int:
    return max(1, min(int(policy.n_clusters), capacity))


def member_width(policy: RoutingPolicy, capacity: int, k: int) -> int:
    """Member-list width C: a power of two with K * C >= 4 * capacity.

    Occupied entries never exceed the high-water fill (slots are assigned
    once per life; deletes leave them until the next re-cluster), so any
    headroom >= 1x lets the assign-with-room walk terminate; 4x the mean
    fill keeps spills into the emptiest cluster rare on heavy-tailed
    cluster sizes."""
    if policy.cluster_capacity:
        c = int(policy.cluster_capacity)
        if k * c < capacity:
            raise ValueError(
                f"cluster_capacity {c} too small: {k} clusters x {c} < "
                f"segment capacity {capacity}")
        return c
    target = max(1, -(-4 * capacity // k))
    return 1 << (target - 1).bit_length()


def _source_record(schema: VectorSchema):
    """The named vector routing clusters over: ``global_pooling`` when
    present, else any single-vector name, else the pooled multi-vector
    (``mean_pooling`` preferred) reduced to its masked token mean."""
    singles = sorted((nv for nv in schema if nv.role == "single"),
                     key=lambda nv: (nv.name != "global_pooling", nv.name))
    if singles:
        return singles[0]
    multis = sorted(schema,
                    key=lambda nv: (nv.name != "mean_pooling", nv.name))
    if not multis:
        raise ValueError("store has no named vectors to route over")
    return multis[0]


def routing_dim(vectors: dict) -> int:
    """Embedding dim of the routing source (sizes fresh centroid arrays
    before any data exists)."""
    return _source_record(VectorSchema.infer(vectors)).vec_dim


def routing_source(vectors: dict) -> torch.Tensor:
    """[N, d] f32 routing vectors for every row of ``vectors`` (dead rows
    included — callers weight them out). Single-vector sources are used
    as they are (dequantised when the float copy was dropped);
    multi-vector sources reduce to their masked token mean."""
    nv = _source_record(VectorSchema.infer(vectors))
    vecs, mask, scales = rerank_arrays(vectors, nv.name)
    v = vecs.float()
    if scales is not None:
        v = v * scales[..., None].float()
    if nv.role == "single":
        return v
    if mask is None:
        return v.mean(dim=1)
    m = mask.float()
    return ((v * m[..., None]).sum(dim=1)
            / m.sum(dim=1).clamp_min(1.0)[..., None])


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

def _dist2(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """[n, K] squared L2 distances without ||x||² (constant per row under
    an argmin or a sort)."""
    c2 = (cents * cents).sum(dim=-1)[None, :]
    return c2 - 2.0 * (x @ cents.T)


def _nearest(x: torch.Tensor, cents: torch.Tensor,
             chunk: int = KMEANS_CHUNK) -> torch.Tensor:
    """[N] nearest centroid by L2 (int64), ``chunk`` rows at a time so the
    [chunk, K] distance block, not [N, K], is the live intermediate."""
    full_f32()
    n = x.shape[0]
    if chunk <= 0 or chunk >= n:
        return torch.argmin(_dist2(x, cents), dim=1)
    return torch.cat([torch.argmin(_dist2(x[i:i + chunk], cents), dim=1)
                      for i in range(0, n, chunk)])


def _cluster_sums(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                  k: int, chunk: int = KMEANS_CHUNK) -> tuple:
    """Per-cluster weighted sums [K, d] and weights [K]: one-hot products
    over ``chunk`` rows at a time."""
    sums = x.new_zeros((k, x.shape[1]))
    cnt = x.new_zeros((k,))
    step = chunk if chunk > 0 else max(x.shape[0], 1)
    for i in range(0, x.shape[0], step):
        oh = torch.nn.functional.one_hot(a[i:i + step], k).to(x.dtype)
        wb = w[i:i + step]
        sums += oh.T @ (x[i:i + step] * wb[:, None])
        cnt += oh.T @ wb
    return sums, cnt


def _kmeans(x: torch.Tensor, w: torch.Tensor, k: int,
            iters: int) -> torch.Tensor:
    """x [N, d] f32, w [N] f32 row weights (0 = dead slot) -> [K, d] f32.

    Init is the deterministic greedy form of k-means++: start from the
    first live row, then repeatedly take the live row farthest (weighted
    min-distance) from the chosen set — argmax where D²-sampling would
    draw. Lloyd then refines; empty clusters keep their centroid."""
    full_f32()
    c0 = x[torch.argmax(w)]                   # first live row
    cents = x.new_zeros((k, x.shape[1]))
    cents[0] = c0
    d2 = ((x - c0[None, :]) ** 2).sum(dim=-1) * w
    for i in range(1, k):
        c = x[torch.argmax(d2)]
        cents[i] = c
        d2 = torch.minimum(d2, ((x - c[None, :]) ** 2).sum(dim=-1) * w)
    for _ in range(iters):
        sums, cnt = _cluster_sums(x, w, _nearest(x, cents), k)
        new = sums / cnt.clamp_min(1.0)[:, None]
        cents = torch.where(cnt[:, None] > 0, new, cents)
    return cents


def _rank(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """[m, K] cluster ids by ascending distance (a stable sort: equal
    distances keep the lower cluster id first) — the assign-with-room
    walk's order when the nearest cluster's list is full."""
    full_f32()
    return torch.argsort(_dist2(x, cents), dim=1, stable=True)


# ---------------------------------------------------------------------------
# clustering + host-side member packing
# ---------------------------------------------------------------------------

def _pack_members(assign: np.ndarray, live: np.ndarray, k: int,
                  c: int) -> tuple:
    """Assignment [N] + liveness [N] -> (-1-padded members [K, C] int32,
    fills [K]). Rows sort by cluster, position = rank within the cluster;
    the rare overflow rows (a cluster k-means filled past C) spill to the
    emptiest list."""
    members = np.full((k, c), -1, np.int32)
    rows = np.flatnonzero(live)
    if rows.size == 0:
        return members, np.zeros((k,), np.int64)
    a = assign[rows]
    order = np.argsort(a, kind="stable")
    rows, a = rows[order], a[order]
    starts = np.searchsorted(a, np.arange(k))
    pos = np.arange(rows.size) - starts[a]
    fit = pos < c
    members[a[fit], pos[fit]] = rows[fit]
    fills = np.bincount(a[fit], minlength=k).astype(np.int64)
    for s in rows[~fit]:
        cid = int(np.argmin(fills))
        members[cid, fills[cid]] = s
        fills[cid] += 1
    return members, fills


def cluster_segment(vectors: dict, policy: RoutingPolicy,
                    capacity: int) -> tuple:
    """Full (re-)cluster of one segment: (centroids [K, d] f32, members
    [K, C] int32, fills [K]). Shapes depend only on (policy, capacity,
    routing dim)."""
    k = segment_clusters(policy, capacity)
    c = member_width(policy, capacity, k)
    x = routing_source(vectors)
    valid = vectors[VALIDITY_KEY]
    cents = _kmeans(x, valid.float(), k, int(policy.iters))
    assign = _nearest(x, cents).cpu().numpy()
    members, fills = _pack_members(assign, valid.cpu().numpy(), k, c)
    return cents, torch.from_numpy(members).to(x.device), fills


def alloc_arrays(policy: RoutingPolicy, like_vectors: dict, capacity: int,
                 device) -> tuple:
    """Zero-state routing tensors for a FRESH segment: all-zero centroids
    (early adds land via the ranked with-room walk, spreading over the
    lists) and empty member lists. The drift counter then schedules the
    first real clustering once enough rows exist."""
    k = segment_clusters(policy, capacity)
    c = member_width(policy, capacity, k)
    d = routing_dim(like_vectors)
    return ({CENTROIDS_KEY: torch.zeros((k, d), dtype=torch.float32,
                                        device=device),
             MEMBERS_KEY: torch.full((k, c), -1, dtype=torch.int32,
                                     device=device)},
            RouteState(fills=np.zeros((k,), np.int64)))


# ---------------------------------------------------------------------------
# maintenance hooks (called by SegmentedStore)
# ---------------------------------------------------------------------------

def recluster(store, seg) -> None:
    """Re-cluster one segment (same shapes — data, not layout). On a
    mesh the whole segment is clustered once, gathered from its slabs,
    and every shard gets the same centroids and member lists, so every
    shard derives the identical routed rows (never one index per
    shard)."""
    cents, members, fills = cluster_segment(seg.gathered(), store.router,
                                            seg.capacity)
    seg.set_replicated(CENTROIDS_KEY, cents)
    seg.set_replicated(MEMBERS_KEY, members)
    seg.routing = RouteState(fills=fills)


def maybe_recluster(store, seg) -> bool:
    """Re-cluster when accumulated drift passes the policy threshold."""
    st = seg.routing
    if st is None or store.router is None:
        return False
    limit = max(MIN_DRIFT,
                int(store.router.drift_threshold * max(seg.n_docs, 1)))
    if st.drift < limit:
        return False
    recluster(store, seg)
    return True


def on_commit(store, seg, slots: np.ndarray) -> None:
    """Assign freshly written tail slots to their nearest cluster with
    room and write them into the member lists."""
    st = seg.routing
    m = int(slots.size)
    if st is None or m == 0:
        return
    first = seg.slabs[0]
    c = first[MEMBERS_KEY].shape[1]
    # routing source of just the new rows: gather them from every per-doc
    # tensor (across the slabs on a mesh), then reduce — O(m), not
    # O(capacity)
    sub = {kk: seg.take(kk, slots) for kk in first if kk not in ROUTING_KEYS}
    ranked = _rank(routing_source(sub), first[CENTROIDS_KEY])
    ranked = ranked.cpu().numpy()
    cids = np.empty((m,), np.int64)
    pos = np.empty((m,), np.int64)
    for i in range(m):
        for cid in ranked[i]:
            if st.fills[cid] < c:
                cids[i] = cid
                pos[i] = st.fills[cid]
                st.fills[cid] += 1
                break
        else:                                  # K * C >= capacity
            raise AssertionError("no cluster with room — invariant broken")
    # every shard holds the same member lists: the same write on each
    for slab in seg.slabs:
        members = slab[MEMBERS_KEY]
        dev = members.device
        members[torch.from_numpy(cids).to(dev),
                torch.from_numpy(pos).to(dev)] = torch.from_numpy(
                    slots.astype(np.int32)).to(dev)
    st.drift += m
    maybe_recluster(store, seg)


def on_delete(store, seg, n_deleted: int) -> None:
    """Deletes move no data (``effective_validity`` masks dead members at
    query time, exactly like the exhaustive scan) — only drift ticks."""
    if seg.routing is None or n_deleted <= 0:
        return
    seg.routing.drift += int(n_deleted)
    maybe_recluster(store, seg)
