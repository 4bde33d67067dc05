"""Named-vector page store + the typed ``VectorSchema`` that describes it.

Each page is stored under named vectors (paper §2.4):
  initial        [N, D, d]   full multi-vector set
  mean_pooling   [N, D', d]  model-aware pooled
  global_pooling [N, d]      one vector per page

A named vector may carry a per-token validity mask ([N, D] bool), and a
segmented store carries the per-document liveness mask ``doc_valid``
([N] bool: capacity padding, deletes). All live in the flat ``vectors``
dict under reserved keys; the key convention is owned by this module and
every other consumer goes through the accessors below.

Token hygiene (§2.1) is applied at index time: the masks mark visual
tokens only, and masked slots are zeroed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device

# ---------------------------------------------------------------------------
# key-suffix schema — the one place these strings exist
# ---------------------------------------------------------------------------

VALIDITY_KEY = "doc_valid"           # [N] bool, per-document liveness
STORE_COMPANIONS = (VALIDITY_KEY,)
_MASK = "_mask"


def mask_key(name: str) -> str:
    """Key of ``name``'s per-token validity mask ([N, D] bool)."""
    return name + _MASK


def is_companion(key: str) -> bool:
    """True for keys that describe another vector (masks) or the store
    itself (``doc_valid``) rather than naming a vector."""
    return key in STORE_COMPANIONS or key.endswith(_MASK)


def is_store_companion(key: str) -> bool:
    """True for the per-document store-level companions — the arrays a
    segment allocates and owns itself, as opposed to the batch payload."""
    return key in STORE_COMPANIONS


# ---------------------------------------------------------------------------
# typed schema
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NamedVector:
    """One named vector's layout record.

    role      "multi" ([N, D, d] per-token sets) or "single" ([N, d])
    vec_dim   stored embedding dim d
    n_vecs    vectors per page D (1 for role == "single")
    has_mask  a per-token validity mask is indexed with it
    """
    name: str
    role: str
    vec_dim: int
    n_vecs: int
    has_mask: bool = False


@dataclass(frozen=True)
class VectorSchema:
    """Typed description of a raw ``vectors`` dict: which named vectors
    exist, their geometry, and whether the store tracks liveness."""
    vectors: tuple          # NamedVector records, sorted by name
    has_validity: bool = False

    @classmethod
    def infer(cls, vectors: dict) -> "VectorSchema":
        out = []
        for k in sorted(vectors):
            if is_companion(k):
                continue
            v = vectors[k]
            out.append(NamedVector(
                name=k,
                role="multi" if v.ndim == 3 else "single",
                vec_dim=v.shape[-1],
                n_vecs=v.shape[1] if v.ndim == 3 else 1,
                has_mask=mask_key(k) in vectors))
        return cls(tuple(out), has_validity=VALIDITY_KEY in vectors)

    def __getitem__(self, name: str) -> NamedVector:
        for nv in self.vectors:
            if nv.name == name:
                return nv
        raise KeyError(name)

    @property
    def names(self) -> tuple:
        return tuple(nv.name for nv in self.vectors)

    def dims(self) -> dict:
        """Vectors-per-page D per named vector (1 for single-vector)."""
        return {nv.name: nv.n_vecs for nv in self.vectors}

    def vec_dims(self) -> dict:
        """Stored embedding dim per named vector."""
        return {nv.name: nv.vec_dim for nv in self.vectors}


# ---------------------------------------------------------------------------
# dict accessors (all schema consumers funnel through these)
# ---------------------------------------------------------------------------

def validity(vectors: dict):
    """The per-document liveness mask ([N] bool), or None for an
    always-live (non-segmented) store."""
    return vectors.get(VALIDITY_KEY)


def effective_validity(vectors: dict):
    """The one [N] bool mask the cascade threads through every stage (or
    None when the store has no validity notion). Tenant and tag filters
    fold in here once they are ported; today it is ``doc_valid``."""
    return validity(vectors)


def scan_arrays(vectors: dict, name: str) -> tuple:
    """The scan stage's arrays for ``name``: (vecs, mask or None)."""
    return vectors[name], vectors.get(mask_key(name))


def rerank_arrays(vectors: dict, name: str) -> tuple:
    """A rerank stage's arrays for ``name``: (vecs, mask or None)."""
    return vectors[name], vectors.get(mask_key(name))


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

@dataclass
class VectorStore:
    vectors: dict
    n_docs: int
    store_dtype: str = "bfloat16"

    def schema(self) -> VectorSchema:
        return VectorSchema.infer(self.vectors)

    def dims(self) -> dict:
        return self.schema().dims()

    def vec_dims(self) -> dict:
        return self.schema().vec_dims()

    @property
    def device(self) -> torch.device:
        return next(iter(self.vectors.values())).device


def _to_tensor(a) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16, which is what ``np.asarray``
    of a JAX bf16 array gives) -> torch, bit-exact."""
    a = np.array(a)                   # a writable copy (JAX's are read-only)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_numpy(vectors: dict, n_docs: int | None = None,
               store_dtype: str = "bfloat16",
               device="cuda") -> VectorStore:
    """A ``VectorStore`` on ``device`` from numpy arrays — e.g. a JAX
    ``VectorStore``'s arrays taken with ``np.asarray``. Values and dtypes
    carry over bit for bit; ``n_docs`` defaults to the leading dim."""
    dev = resolve_device(device)
    out = {k: _to_tensor(v).to(dev) for k, v in vectors.items()}
    if n_docs is None:
        n_docs = next(iter(out.values())).shape[0]
    return VectorStore(out, int(n_docs), store_dtype)


def build_store(cfg, page_embeds, token_types,
                store_dtype=torch.bfloat16, device="cuda") -> VectorStore:
    """Index a batch of encoded pages into named vectors on ``device``.

    page_embeds [N, S, d] raw encoder output (special tokens included);
    token_types [S] or [N, S]. Hygiene strips non-visual tokens; pooling
    is model-aware per cfg (the functional ``core.pooling`` reference,
    i.e. ``IngestPipeline(use_kernel=False)``).
    """
    # store -> ingest layering: ingest builds on the store types defined
    # here, so the wrapper imports it at call time (no import cycle)
    from repro_torch.retrieval.ingest import IngestPipeline
    pipe = IngestPipeline(cfg, store_dtype=store_dtype, use_kernel=False,
                          device=device)
    return pipe.index(page_embeds, token_types)
