"""Named-vector page store + the typed ``VectorSchema`` that describes it.

Each page is stored under named vectors (paper §2.4):
  initial        [N, D, d]   full multi-vector set
  mean_pooling   [N, D', d]  model-aware pooled
  global_pooling [N, d]      one vector per page

A named vector may carry a per-token validity mask ([N, D] bool) and
int8 codes with per-vector scales (``quantize_store``; the float copy may
then be dropped), and a segmented store carries the per-document liveness
mask ``doc_valid`` ([N] bool: capacity padding, deletes). All live in the
flat ``vectors`` dict under reserved keys; the key convention is owned by
this module and every other consumer goes through the accessors below.

Token hygiene (§2.1) is applied at index time: the masks mark visual
tokens only, and masked slots are zeroed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.maxsim.ops import quantize_int8

# ---------------------------------------------------------------------------
# key-suffix schema — the one place these strings exist
# ---------------------------------------------------------------------------

VALIDITY_KEY = "doc_valid"           # [N] bool, per-document liveness
STORE_COMPANIONS = (VALIDITY_KEY,)
_MASK, _INT8, _SCALE = "_mask", "_int8", "_scale"


def mask_key(name: str) -> str:
    """Key of ``name``'s per-token validity mask ([N, D] bool)."""
    return name + _MASK


def codes_key(name: str) -> str:
    """Key of ``name``'s int8 quantised codes (same shape, int8)."""
    return name + _INT8


def scale_key(name: str) -> str:
    """Key of ``name``'s per-vector dequantisation scales ([N, D] f32)."""
    return name + _SCALE


def is_companion(key: str) -> bool:
    """True for keys that describe another vector (masks, codes, scales)
    or the store itself (``doc_valid``) rather than naming a vector."""
    return (key in STORE_COMPANIONS or key.endswith(_MASK)
            or key.endswith(_SCALE) or key.endswith(_INT8))


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
    quantized int8 codes + scales indexed alongside (or instead of) floats
    has_float the float/bf16 copy is present (False once
              ``quantize_store(stages=...)`` dropped a dead copy)
    has_mask  a per-token validity mask is indexed with it
    """
    name: str
    role: str
    vec_dim: int
    n_vecs: int
    quantized: bool = False
    has_float: bool = True
    has_mask: bool = False

    @property
    def key(self) -> str:
        """Key of the representative array (the float copy when present,
        otherwise the int8 codes)."""
        return self.name if self.has_float else codes_key(self.name)


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
                if not k.endswith(_INT8) or k[:-len(_INT8)] in vectors:
                    continue
                name, has_float = k[:-len(_INT8)], False  # float dropped
            else:
                name, has_float = k, True
            v = vectors[k]
            out.append(NamedVector(
                name=name,
                role="multi" if v.ndim == 3 else "single",
                vec_dim=v.shape[-1],
                n_vecs=v.shape[1] if v.ndim == 3 else 1,
                quantized=codes_key(name) in vectors,
                has_float=has_float,
                has_mask=mask_key(name) in vectors))
        return cls(tuple(sorted(out, key=lambda nv: nv.name)),
                   has_validity=VALIDITY_KEY in vectors)

    def __iter__(self):
        return iter(self.vectors)

    def __contains__(self, name: str) -> bool:
        return any(nv.name == name for nv in self.vectors)

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
        """Stored embedding dim per named vector (int8 codes report the
        name they quantise)."""
        return {nv.name: nv.vec_dim for nv in self.vectors}

    def keys_for(self, name: str) -> tuple:
        """Every dict key belonging to ``name`` (representative + mask +
        codes + scales), in a stable order."""
        nv = self[name]
        keys = [nv.name] if nv.has_float else []
        if nv.has_mask:
            keys.append(mask_key(nv.name))
        if nv.quantized:
            keys += [codes_key(nv.name), scale_key(nv.name)]
        return tuple(keys)


# ---------------------------------------------------------------------------
# dict accessors (all schema consumers funnel through these)
# ---------------------------------------------------------------------------

def base_vectors(vectors: dict) -> dict:
    """Collapse a raw vectors dict to {base name: representative array}:
    skips companion arrays and folds int8 codes onto the name they quantise
    (the float copy wins when both exist)."""
    return {nv.name: vectors[nv.key] for nv in VectorSchema.infer(vectors)}


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
    """The scan stage's arrays for ``name``: (vecs, mask, scales).

    int8 codes + per-vector scales are preferred when indexed (the scan
    streams the whole corpus, and codes are half the bytes of bf16); the
    float array is used only when there are no codes. Masks and scales
    are None when absent."""
    mask = vectors.get(mask_key(name))
    if codes_key(name) in vectors:
        return vectors[codes_key(name)], mask, vectors[scale_key(name)]
    return vectors[name], mask, None


def rerank_arrays(vectors: dict, name: str) -> tuple:
    """A rerank stage's arrays for ``name``: (vecs, mask, scales).

    The float copy when it exists (``scales`` None); when
    ``quantize_store(stages=...)`` dropped it, the int8 codes and their
    scales, which every rerank path dequantises per gathered row."""
    if name in vectors:
        return vectors[name], vectors.get(mask_key(name)), None
    return (vectors[codes_key(name)], vectors.get(mask_key(name)),
            vectors[scale_key(name)])


def quantize_vectors(vectors: dict, names: tuple,
                     stages: tuple | None = None) -> dict:
    """Add int8 codes + scales for ``names``; with ``stages`` given, drop
    the float copy of every quantised name that no later (rerank) stage
    scores. The policy behind ``quantize_store`` and the ingest
    pipeline's ``quantize=`` option."""
    vecs = dict(vectors)
    rerank_names = {s.vector for s in (stages or ())[1:]}
    for name in names:
        codes, scales = quantize_int8(vecs[name])
        vecs[codes_key(name)] = codes
        vecs[scale_key(name)] = scales
        if stages is not None and name not in rerank_names:
            del vecs[name]                   # dead float copy: scan reads
    return vecs


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


def quantize_store(store: VectorStore, names=("initial",),
                   stages: tuple | None = None) -> VectorStore:
    """Add int8 codes + scales for the given named vectors.

    The scan always prefers the codes once they exist (``scan_arrays``),
    which makes the float copy dead weight unless a rerank stage still
    scores it. Pass the cascade as ``stages`` to drop the float copy of
    every quantised name that no later stage scores (that is what halves,
    rather than grows, the vector's device bytes). ``stages=None`` keeps
    the float copy, for the ``multistage.search`` oracle and for stores
    shared across cascades."""
    return VectorStore(quantize_vectors(store.vectors, names, stages),
                       store.n_docs, store.store_dtype)


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
    carry over bit for bit (bf16 vectors, int8 codes, f32 scales, bool
    masks); ``n_docs`` defaults to the leading dim."""
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
