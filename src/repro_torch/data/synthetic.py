"""Synthetic ViDoRe-analogue corpus with planted spatial relevance.

No ViDoRe download is possible offline, so the paper's evaluation protocol
(§3) is rebuilt on synthetic data whose structure exercises exactly what the
paper's technique depends on:

- pages are patch-grid embeddings whose topic signal is concentrated in a
  CONTIGUOUS spatial region (rows of the grid) — spatial pooling preserves
  such signals; unstructured noise would not favour pooling and planting
  signal everywhere would make pooling trivially lossless;
- each page additionally carries special/prompt/padding tokens, so token
  hygiene (§2.1) has real work to do (padding tokens are low-norm but
  nonzero => spurious attractors without hygiene);
- three topically-disjoint "datasets" (ESG/Bio/Econ-style) enable the
  per-dataset vs union (distractor) scopes of §3;
- queries are noisy token bundles around a page's topic; the page(s) sharing
  that topic are the relevant set (graded: primary page rel=2, same-topic
  pages rel=1) so NDCG@k / Recall@k are measurable.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticBenchmark:
    pages: np.ndarray          # [N, S, d]  raw page vectors (pre-hygiene)
    token_types: np.ndarray    # [S]
    queries: np.ndarray        # [Nq, Q, d]
    query_mask: np.ndarray     # [Nq, Q]
    qrels: list                # per query: {doc_id: relevance}
    dataset_of_page: np.ndarray   # [N] int
    dataset_of_query: np.ndarray  # [Nq] int


def make_benchmark(cfg, n_pages_per_ds=(160, 120, 90), queries_per_ds=(40, 40, 30),
                   n_topics_per_ds: int = 24, q_tokens: int = 10,
                   signal: float = 1.0, noise: float = 0.55,
                   seed: int = 0) -> SyntheticBenchmark:
    """cfg: RetrieverConfig (geometry determines the patch layout)."""
    rng = np.random.default_rng(seed)
    d = cfg.out_dim
    n_vis = cfg.n_patches
    S = n_vis + cfg.n_special
    grid_h = cfg.grid_h if cfg.geometry != "tiles" else cfg.n_tiles
    row_w = n_vis // grid_h

    pages, qvecs, qmasks, qrels = [], [], [], []
    ds_of_page, ds_of_query = [], []
    topic_bank = []
    page_topics = []

    for ds, (npg, nq) in enumerate(zip(n_pages_per_ds, queries_per_ds)):
        topics = rng.normal(size=(n_topics_per_ds, d))
        topics /= np.linalg.norm(topics, axis=1, keepdims=True)
        topic_bank.append(topics)
        for p in range(npg):
            t = int(rng.integers(n_topics_per_ds))
            page = rng.normal(size=(n_vis, d))
            page /= np.linalg.norm(page, axis=1, keepdims=True)   # unit noise
            page *= noise
            # plant the topic in a contiguous band of grid rows
            r0 = int(rng.integers(0, max(grid_h - 3, 1)))
            rows = slice(r0 * row_w, min((r0 + 3) * row_w, n_vis))
            n_sig = page[rows].shape[0]
            jitter = rng.normal(size=(n_sig, d))
            jitter /= np.linalg.norm(jitter, axis=1, keepdims=True)
            page[rows] += signal * (topics[t][None] + 0.15 * jitter)
            page /= np.maximum(np.linalg.norm(page, axis=1, keepdims=True),
                               1e-9)
            # prepend specials (moderate-norm junk: hygiene must catch them)
            spec = rng.normal(size=(cfg.n_special, d)) * 0.9
            spec /= np.maximum(np.linalg.norm(spec, axis=1, keepdims=True), 1e-9)
            full = np.concatenate([spec, page], axis=0)
            pages.append(full)
            ds_of_page.append(ds)
            page_topics.append((ds, t))

    pages = np.stack(pages).astype(np.float32)
    N = len(pages)

    for ds, (npg, nq) in enumerate(zip(n_pages_per_ds, queries_per_ds)):
        topics = topic_bank[ds]
        ds_pages = [i for i in range(N) if page_topics[i][0] == ds]
        for _ in range(nq):
            # anchor on a random page's topic so every query has >=1 relevant
            anchor = int(rng.choice(ds_pages))
            t = page_topics[anchor][1]
            qn = rng.normal(size=(q_tokens, d))
            qn /= np.linalg.norm(qn, axis=1, keepdims=True)
            q = topics[t][None] + 0.35 * qn
            q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-9)
            qv = np.zeros((max(q_tokens, 16), d), np.float32)
            qv[:q_tokens] = q
            qm = np.zeros(max(q_tokens, 16), bool)
            qm[:q_tokens] = True
            rel = {anchor: 2}
            for i in ds_pages:
                if i != anchor and page_topics[i][1] == t:
                    rel[i] = 1
            qvecs.append(qv)
            qmasks.append(qm)
            qrels.append(rel)
            ds_of_query.append(ds)

    token_types = np.concatenate([
        np.full(cfg.n_special, 1, np.int32),        # SPECIAL
        np.zeros(n_vis, np.int32)])                 # VISUAL
    return SyntheticBenchmark(pages, token_types, np.stack(qvecs),
                              np.stack(qmasks), qrels,
                              np.asarray(ds_of_page), np.asarray(ds_of_query))


# ---------------------------------------------------------------------------
# metrics (NDCG@k, Recall@k) — the paper's Table 1/2 metrics
# ---------------------------------------------------------------------------

def ndcg_at_k(ranked_ids: np.ndarray, qrel: dict, k: int) -> float:
    gains = np.asarray([qrel.get(int(i), 0) for i in ranked_ids[:k]], float)
    disc = 1.0 / np.log2(np.arange(2, len(gains) + 2))
    dcg = float(np.sum((2 ** gains - 1) * disc))
    ideal = sorted(qrel.values(), reverse=True)[:k]
    idisc = 1.0 / np.log2(np.arange(2, len(ideal) + 2))
    idcg = float(np.sum((2 ** np.asarray(ideal, float) - 1) * idisc))
    return dcg / idcg if idcg > 0 else 0.0


def recall_at_k(ranked_ids: np.ndarray, qrel: dict, k: int) -> float:
    rel = {i for i, g in qrel.items() if g > 0}
    if not rel:
        return 0.0
    hit = len(rel & {int(i) for i in ranked_ids[:k]})
    return hit / len(rel)


def evaluate_ranking(all_ranked: np.ndarray, qrels: list,
                     ks=(5, 10, 100)) -> dict:
    out = {}
    for k in ks:
        out[f"ndcg@{k}"] = float(np.mean(
            [ndcg_at_k(r, q, k) for r, q in zip(all_ranked, qrels)]))
        out[f"recall@{k}"] = float(np.mean(
            [recall_at_k(r, q, k) for r, q in zip(all_ranked, qrels)]))
    return out


# ---------------------------------------------------------------------------
# synthetic page IMAGES (for the cropping pipeline §2.2)
# ---------------------------------------------------------------------------

def make_page_image(rng: np.random.Generator, h: int = 256, w: int = 192,
                    margin: float = 0.15, page_number: bool = True):
    """White page with content block, blank margins, optional page number."""
    img = np.ones((h, w), np.float32)
    mt, mb = int(h * margin), int(h * (1 - margin))
    ml, mr = int(w * margin), int(w * (1 - margin))
    img[mt:mb, ml:mr] = rng.random((mb - mt, mr - ml)) * 0.8
    if page_number:
        img[int(h * 0.97):, int(w * 0.45):int(w * 0.55)] = 0.2
    return img, (mt, mb, ml, mr)
