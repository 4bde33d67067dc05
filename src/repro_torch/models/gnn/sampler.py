"""Fanout neighbour sampler (GraphSAGE-style) for the minibatch_lg cell: a
copy of ``repro.models.gnn.sampler``, so the same ``np.random.Generator``
state gives the same subgraph bit for bit.

A real sampler, not a stub: host-side numpy over a CSR adjacency, uniform
without-replacement per-hop fanouts (e.g. 15-10), producing a fixed-shape
padded subgraph ready for device transfer. The subgraph keeps the seed nodes
first so the training loss can index them directly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray       # [N+1]
    indices: np.ndarray      # [nnz] neighbour ids
    n_nodes: int

    @staticmethod
    def from_coo(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> "CSRGraph":
        order = np.argsort(dst, kind="stable")
        s, d = src[order], dst[order]
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.add.at(indptr, d + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CSRGraph(indptr, s.astype(np.int64), n_nodes)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]


def max_subgraph_shape(batch_nodes: int, fanout: tuple) -> tuple[int, int]:
    """(max nodes, max edges) for padding: seeds + per-hop expansion."""
    n, e, frontier = batch_nodes, 0, batch_nodes
    for f in fanout:
        e += frontier * f
        frontier = frontier * f
        n += frontier
    return n, e


def sample_subgraph(g: CSRGraph, seeds: np.ndarray, fanout: tuple,
                    rng: np.random.Generator):
    """Uniform fanout sampling; returns padded fixed-shape arrays.

    Returns dict(nodes [Nmax], node_mask, src [Emax], dst [Emax], edge_mask,
    n_seeds). Edge endpoints are LOCAL indices into `nodes`; seeds occupy
    positions [0, len(seeds)).
    """
    n_max, e_max = max_subgraph_shape(len(seeds), fanout)
    local_of = {int(v): i for i, v in enumerate(seeds)}
    nodes = list(int(v) for v in seeds)
    esrc, edst = [], []
    frontier = list(int(v) for v in seeds)
    for f in fanout:
        nxt = []
        for v in frontier:
            nbrs = g.neighbors(v)
            if len(nbrs) == 0:
                continue
            take = min(f, len(nbrs))
            picks = rng.choice(nbrs, size=take, replace=False)
            for u in picks:
                u = int(u)
                if u not in local_of:
                    local_of[u] = len(nodes)
                    nodes.append(u)
                    nxt.append(u)
                # message flows u -> v
                esrc.append(local_of[u])
                edst.append(local_of[v])
        frontier = nxt
    n, e = len(nodes), len(esrc)
    out_nodes = np.zeros(n_max, np.int64)
    out_nodes[:n] = nodes
    node_mask = np.zeros(n_max, bool)
    node_mask[:n] = True
    src = np.zeros(e_max, np.int32)
    dst = np.zeros(e_max, np.int32)
    emask = np.zeros(e_max, bool)
    src[:e], dst[:e], emask[:e] = esrc, edst, True
    return dict(nodes=out_nodes, node_mask=node_mask, src=src, dst=dst,
                edge_mask=emask, n_seeds=len(seeds))


def random_graph(n_nodes: int, avg_degree: int, rng: np.random.Generator):
    """Synthetic power-law-ish COO graph for tests/examples."""
    e = n_nodes * avg_degree
    src = rng.integers(0, n_nodes, e)
    # mild preferential attachment: square a uniform to skew dst
    dst = (rng.random(e) ** 2 * n_nodes).astype(np.int64)
    keep = src != dst
    return src[keep], dst[keep]
