"""Named-vector page store + the typed ``VectorSchema`` that describes it.

Each page is stored under named vectors (paper §2.4):
  initial        [N, D, d]   full multi-vector set
  mean_pooling   [N, D', d]  model-aware pooled
  global_pooling [N, d]      one vector per page

A named vector may carry a per-token validity mask ([N, D] bool) and
int8 codes with per-vector scales (``quantize_store``; the float copy may
then be dropped). A segmented store carries STORE-LEVEL companions that
describe each document row rather than any one vector:

  doc_valid   [N]     bool   per-document liveness (capacity padding,
                             deletes)
  doc_tenant  [N]     int32  owning tenant id (0 = default namespace)
  doc_filter  [N, W]  int32  packed metadata-tag bitset, 32 tags per word
                             (tag j lives at word j // 32, bit j % 32)

and, with IVF routing on, two per-CLUSTER companions (``ivf_centroids``
[K, d] f32, ``ivf_members`` [K, C] int32; ``retrieval.routing``). All live
in the flat ``vectors`` dict under reserved keys; the key convention is
owned by this module and every other consumer goes through the accessors
below.

torch has no full uint32 arithmetic, so the tag words are held as int32
BIT PATTERNS of the uint32 words ``pack_tags`` builds (tag 31 of a word
is the sign bit). The filters only AND and compare words, which give the
same answers on the two types. A request's ``FilterSpec`` is packed to the
same words and ``effective_validity`` folds all three terms into the one
[N] mask the cascade threads through every stage.

Token hygiene (§2.1) is applied at index time: the masks mark visual
tokens only, and masked slots are zeroed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.distributed.sharding import split
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.maxsim.ops import quantize_int8

# ---------------------------------------------------------------------------
# key-suffix schema — the one place these strings exist
# ---------------------------------------------------------------------------

VALIDITY_KEY = "doc_valid"           # [N] bool, per-document liveness
TENANT_KEY = "doc_tenant"            # [N] int32, owning tenant id
FILTER_KEY = "doc_filter"            # [N, W] int32 bit patterns of uint32
# IVF routing companions (``repro_torch.retrieval.routing``): per-CLUSTER
# arrays, not per-document — the centroids of the segment's routing
# vectors and the -1-padded member-slot lists, so cluster membership is
# data rather than a shape. Store companions (segment-owned, never part
# of a batch payload).
CENTROIDS_KEY = "ivf_centroids"      # [K, d] f32, cluster centroids
MEMBERS_KEY = "ivf_members"          # [K, C] int32 member slots, -1 padded
ROUTING_KEYS = (CENTROIDS_KEY, MEMBERS_KEY)
STORE_COMPANIONS = (VALIDITY_KEY, TENANT_KEY, FILTER_KEY) + ROUTING_KEYS
TAGS_PER_WORD = 32
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
    or the store itself (``doc_valid``/``doc_tenant``/``doc_filter`` and
    the routing arrays) rather than naming a vector."""
    return (key in STORE_COMPANIONS or key.endswith(_MASK)
            or key.endswith(_SCALE) or key.endswith(_INT8))


def is_store_companion(key: str) -> bool:
    """True for the store-level companions (liveness, tenant id, packed
    filter bitset, routing arrays) — the arrays a segment allocates and
    owns itself, as opposed to the batch payload."""
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


def tenant_ids(vectors: dict):
    """The per-document tenant-id array ([N] int32), or None for a store
    without tenant scoping."""
    return vectors.get(TENANT_KEY)


def filter_bits(vectors: dict):
    """The packed per-document metadata-tag bitset ([N, W] int32 bit
    patterns), or None for a store without filter metadata."""
    return vectors.get(FILTER_KEY)


def filter_words(vectors: dict) -> int:
    """The store's packed tag-bitset width W (0 = no filter metadata)."""
    f = vectors.get(FILTER_KEY)
    return 0 if f is None else f.shape[1]


def routing_arrays(vectors: dict):
    """The IVF routing companions ``(centroids [K, d] f32, members [K, C]
    int32)``, or None when the store carries no cluster index. Member
    lists are -1-padded; a slot id appears in exactly one list, so probing
    all K clusters recovers the exhaustive candidate set."""
    c = vectors.get(CENTROIDS_KEY)
    if c is None:
        return None
    return c, vectors[MEMBERS_KEY]


def store_shardings(mesh, store_vectors: dict) -> dict | None:
    """Each key's layout on ``mesh`` as ``repro``'s ``PartitionSpec``
    tuple: ``()`` (replicated) for the routing companions, whose member
    slots index the whole store, and rows split over every mesh axis for
    the rest (``(axes,)``, or ``(name,)`` on a one-axis mesh, as
    ``PartitionSpec`` stores it); None without a mesh. ``split_slabs``
    lays a store out by these specs."""
    if mesh is None:
        return None
    axes = tuple(mesh.axis_names)
    rows = (axes if len(axes) > 1 else axes[0],)
    return {k: () if k in ROUTING_KEYS else rows for k in store_vectors}


def split_slabs(vectors: dict, mesh, copy: bool = False) -> tuple:
    """A store dict laid out over ``mesh`` by ``store_shardings``: one
    dict per mesh position, in mesh order. Shard r holds rows ``[r *
    n_local, (r + 1) * n_local)`` of every row-split tensor on the r-th
    device, with ``n_local = N // S``; a replicated tensor goes whole to
    every shard. ``copy`` gives every slab its own storage; a slab on the
    tensor's own device is otherwise a view. The rows split by
    ``distributed.sharding.split``, the rule ``shard_map`` splits by."""
    specs = store_shardings(mesh, vectors)
    per_key = {k: split(v, mesh, specs[k], copy=copy)
               for k, v in vectors.items()}
    return tuple({k: slabs[r] for k, slabs in per_key.items()}
                 for r in range(mesh.size))


# ---------------------------------------------------------------------------
# request-scoped filters
# ---------------------------------------------------------------------------

def pack_tags(tags, n_words: int) -> np.ndarray:
    """Pack integer metadata tags into ``n_words`` uint32 bitset words
    (tag j -> word j // 32, bit j % 32), on the host."""
    words = np.zeros((max(n_words, 1),), np.uint32)
    for t in tags:
        t = int(t)
        if not 0 <= t < n_words * TAGS_PER_WORD:
            raise ValueError(
                f"tag {t} outside [0, {n_words * TAGS_PER_WORD}) — the "
                f"store was allocated with filter_words={n_words}")
        words[t // TAGS_PER_WORD] |= np.uint32(1 << (t % TAGS_PER_WORD))
    return words


def words_tensor(words: np.ndarray, device=None) -> torch.Tensor:
    """uint32 tag words as the int32 bit patterns the store holds, made
    on ``device`` by fills: a copy from the host would make the host
    wait for the device's queue (a blocking copy synchronises the
    stream), and this runs inside serving and ingest bodies."""
    bits = np.ascontiguousarray(words, np.uint32).view(np.int32)
    out = torch.zeros(bits.shape, dtype=torch.int32, device=device)
    flat = out.view(-1)
    for j in np.flatnonzero(bits):
        flat[int(j)].fill_(int(bits.flat[j]))
    return out


@dataclass(frozen=True)
class FilterSpec:
    """A request-scoped retrieval filter.

    tenant        scope to one tenant id (-1 = any tenant)
    require_tags  metadata tags a page must ALL carry
    any_tags      at least one of these tags must be present (empty = no
                  constraint)

    Tag tuples are canonicalised (sorted, deduplicated, int-cast), so
    equal predicates compare and hash equal."""
    tenant: int = -1
    require_tags: tuple = ()
    any_tags: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "tenant", int(self.tenant))
        object.__setattr__(self, "require_tags",
                           tuple(sorted({int(t) for t in self.require_tags})))
        object.__setattr__(self, "any_tags",
                           tuple(sorted({int(t) for t in self.any_tags})))

    @property
    def is_null(self) -> bool:
        """True for the match-everything spec (no tenant, no tags)."""
        return (self.tenant < 0 and not self.require_tags
                and not self.any_tags)


NULL_FILTER = FilterSpec()


def as_filter_arrays(spec, n_words: int, device=None) -> tuple:
    """Normalise a request filter to the triple ``effective_validity``
    takes: ``(tenant () int32, require [W] int32, any [W] int32)``, the
    words as int32 bit patterns, on ``device``. Accepts a ``FilterSpec``,
    an already-packed triple (returned unchanged), or None (the null
    filter: tenant -1, zero words). W is clamped to >= 1."""
    if isinstance(spec, tuple) and len(spec) == 3:
        return spec
    if spec is None:
        spec = NULL_FILTER
    w = max(n_words, 1)
    return (torch.full((), spec.tenant, dtype=torch.int32, device=device),
            words_tensor(pack_tags(spec.require_tags, w), device),
            words_tensor(pack_tags(spec.any_tags, w), device))


def effective_validity(vectors: dict, fspec: tuple | None = None):
    """Combine ``doc_valid`` with a request's tenant/filter terms into the
    one [N] bool mask the cascade threads everywhere (or None when the
    store has no validity notion and no filter was given).

    ``fspec`` is the ``as_filter_arrays`` triple; every term is evaluated
    elementwise on the store's device:

    - tenant: ``tenant < 0`` (any) or ``doc_tenant == tenant``;
    - require: every set bit present — ``(bits & require) == require``;
    - any: at least one set bit present, skipped when the any-words are
      all zero.

    Stores without the tenant/filter companions skip those terms. Shared
    by the engine and the ``multistage`` oracle."""
    ok = vectors.get(VALIDITY_KEY)
    if fspec is None:
        return ok
    tenant, require, any_ = fspec
    t = tenant_ids(vectors)
    if t is not None:
        t_ok = (tenant < 0) | (t == tenant)
        ok = t_ok if ok is None else ok & t_ok
    bits = filter_bits(vectors)
    if bits is not None:
        req = require[None, :]
        f_ok = ((bits & req) == req).all(dim=1)
        has_any = (any_ != 0).any()
        f_ok = f_ok & (~has_any | ((bits & any_[None, :]) != 0).any(dim=1))
        ok = f_ok if ok is None else ok & f_ok
    return ok


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


def snapshot_entries(vectors: dict) -> tuple:
    """Deterministic persistence order for a segment's vectors dict: every
    tensor (named vectors, their mask/codes/scales companions, the
    doc-level validity/tenant/filter triple, the IVF routing companions)
    as ``(key, tensor)`` pairs sorted by key — the enumeration
    ``retrieval.tiering.snapshot`` flattens a ``SegmentedStore`` with, and
    ``repro``'s, so snapshots cross packages."""
    return tuple(sorted(vectors.items()))


def companion_entries(vectors: dict, source: str, name: str) -> dict:
    """Companion arrays a vector DERIVED from ``source`` (same [N, D]
    geometry, e.g. a Matryoshka dim-truncation) should be indexed with,
    re-keyed for ``name``."""
    out = {}
    if mask_key(source) in vectors:
        out[mask_key(name)] = vectors[mask_key(source)]
    return out


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
    if a.dtype == np.uint32:          # tag words: int32 bit patterns
        return torch.from_numpy(a.view(np.int32))
    return torch.from_numpy(a)


def from_numpy(vectors: dict, n_docs: int | None = None,
               store_dtype: str = "bfloat16",
               device="cuda") -> VectorStore:
    """A ``VectorStore`` on ``device`` from numpy arrays — e.g. a JAX
    ``VectorStore``'s or segment's arrays taken with ``np.asarray``.
    Values and dtypes carry over bit for bit (bf16 vectors, int8 codes,
    f32 scales, bool masks, int32 tenants, routing centroids and members),
    except the uint32 tag words, which become their int32 bit patterns;
    ``n_docs`` defaults to the leading dim."""
    dev = resolve_device(device)
    out = {k: _to_tensor(v).to(dev) for k, v in vectors.items()}
    if n_docs is None:
        n_docs = next(iter(out.values())).shape[0]
    return VectorStore(out, int(n_docs), store_dtype)


def build_store(cfg, page_embeds, token_types, h_eff=None,
                store_dtype=torch.bfloat16,
                experimental_smooth: str | None = None,
                device="cuda") -> VectorStore:
    """Index a batch of encoded pages into named vectors on ``device``.

    page_embeds [N, S, d] raw encoder output (special tokens included);
    token_types [S] or [N, S]; ``h_eff`` [N] int, the effective grid
    height of each page (dynamic geometry; None = the full grid).
    Hygiene strips non-visual tokens; pooling is model-aware per cfg (the
    functional ``core.pooling`` reference, i.e. the shared
    ``IngestPipeline.for_config(use_kernel=False)``).
    ``experimental_smooth`` adds the ``experimental`` vector: the pooling
    stack again with that smoothing kind.
    """
    # store -> ingest layering: ingest builds on the store types defined
    # here, so the wrapper imports it at call time (no import cycle)
    from repro_torch.retrieval.ingest import IngestPipeline
    pipe = IngestPipeline.for_config(
        cfg, store_dtype=store_dtype, use_kernel=False,
        experimental_smooth=experimental_smooth, device=device)
    return pipe.index(page_embeds, token_types, h_eff=h_eff)
