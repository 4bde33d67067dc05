"""The benchmark's own counts of the work its inputs need, and the
rooflines they give: what a scan, a rerank and a whole search must
compute and read, whatever implements them.

- A multi-vector MaxSim stage needs 2 * d operations per (valid query
  token, valid page vector) pair (the paper's Eq. 1 in multiply-adds,
  twice). A one-vector stage collapses the query's valid tokens into one
  sum first, so it needs 2 * d per page (and 2 * d per valid token for
  the sum).
- A scan reads every scanned page vector once a call (the stored
  elements, the f32 scale of an int8 vector, a mask byte) and the f32
  query once.
- A rerank reads each DISTINCT candidate's valid vectors (and scales)
  and its mask row once a call, the int32 candidate rows and the f32
  query once: a candidate that several queries of the batch share counts
  once.

The bound of a call is the larger of operations at the dense bf16 peak
and bytes at the memory peak (``peaks.json``); a share of the roofline is
the bound over the measured kernel time, which no honest kernel can
beat. ``launch/cells.py``'s ``model_flops`` and
``core/multistage.cascade_hbm_bytes`` are not used: the first bills the
rerank whatever the stages and every query slot, valid or not; the
second bills every query's rerank gather and the [B, N] score write, so a
kernel that reads shared candidates once could read over 100% against it.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def peaks() -> dict:
    return json.loads(PEAKS_FILE.read_text())


def scan_ops(q_valid: int, vec_valid: int, d: int) -> float:
    """Operations of one multi-vector scan: ``q_valid`` valid query tokens
    of the batch in all, ``vec_valid`` valid page vectors scanned."""
    return 2.0 * q_valid * vec_valid * d


def scan_bytes(n_pages: int, D: int, d: int, elem_bytes: int,
               scale_bytes: int, q_slots: int) -> float:
    """Bytes of one scan: every stored vector of the n_pages (elements,
    int8 scale, mask byte) and the f32 query [B * Q slots, d] once."""
    return float(n_pages * D * (d * elem_bytes + scale_bytes + 1)
                 + q_slots * d * 4)


def single_vector_ops(n_queries: int, q_valid: int, n_pages: int,
                      d: int) -> float:
    """Operations of one one-vector stage over ``n_pages`` for a batch:
    the token sums, then one product a (query, page)."""
    return 2.0 * d * (q_valid + n_queries * n_pages)


def rerank_ops(q_valid_per_query, cand_vecs_per_query, d: int) -> float:
    """Operations of one rerank: sum over queries of (valid tokens x the
    valid vectors of its candidates) x 2d."""
    return 2.0 * d * sum(q * v for q, v in zip(q_valid_per_query,
                                               cand_vecs_per_query))


def rerank_bytes(distinct_vecs: int, distinct: int, D: int, d: int,
                 elem_bytes: int, scale_bytes: int, n_rows: int,
                 q_slots: int) -> float:
    """Bytes of one rerank: the distinct candidates' valid vectors (and
    scales) and mask rows once, the int32 rows, the f32 query."""
    return float(distinct_vecs * (d * elem_bytes + scale_bytes)
                 + distinct * D + n_rows * 4 + q_slots * d * 4)


def bound_s(ops: float, nbytes: float, pk: dict) -> float:
    """The least time the card could take: operations at the dense bf16
    peak or bytes at the memory peak, the larger."""
    return max(ops / pk["bf16_dense_flops"], nbytes / pk["hbm_bytes_per_s"])
