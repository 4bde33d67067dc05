"""Config dataclasses: the paper's late-interaction retrievers
(``RetrieverConfig``), the decoder-only LM family (``LMConfig``, dense
and MoE), the GNN family (``GNNConfig``) and the recsys family
(``RecsysConfig``), copies of ``repro.configs.base``'s.

Pure data: importing a config touches no device state.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell assigned to an architecture."""

    name: str            # e.g. "train_4k"
    kind: str            # train | prefill | decode | serve | retrieval |
                         # full_graph | minibatch | batched_graphs
    dims: dict = field(default_factory=dict)

    def __getattr__(self, item):
        try:
            return self.dims[item]
        except KeyError as e:  # pragma: no cover - attribute protocol
            raise AttributeError(item) from e


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden size
    # "dense" (all-expert masked) | "ragged" (sorted dispatch); on one
    # device "ragged_ep" runs "ragged" (``models.layers.ffn``)
    impl: str = "dense"


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    # attention pattern: length-P list cycled over layers; entries are
    # 0 (global/full) or a window size (sliding-window local attention).
    attn_pattern: tuple = (0,)
    attn_softcap: float = 0.0              # gemma-2 style tanh soft capping
    final_softcap: float = 0.0
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    act: str = "gelu"                      # mlp activation (gated)
    tie_embeddings: bool = True
    moe: Optional[MoESpec] = None
    # runtime knobs
    remat: bool = True                     # each block under checkpoint
    loss_chunks: int = 8                   # chunked cross-entropy
    dtype: str = "bfloat16"                # compute dtype; params stay f32
    # Megatron-SP residual stream: a sharding constraint in ``repro``,
    # the identity on one device (kept so configs compare field by field)
    sp_activations: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % self.n_kv_heads == 0

    @property
    def family(self) -> str:
        return "lm"

    def window_for_layer(self, layer: int) -> int:
        return self.attn_pattern[layer % len(self.attn_pattern)]

    def n_params(self) -> int:
        """Approximate parameter count (dense-equivalent; MoE counts all experts)."""
        d, hd = self.d_model, self.head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.moe is not None:
            ff = self.moe.n_experts * 3 * d * self.moe.d_ff + d * self.moe.n_experts
        else:
            ff = 3 * d * self.d_ff
        per_layer = attn + ff + 2 * d
        return self.n_layers * per_layer + self.vocab_size * d + d

    def n_active_params(self) -> int:
        """Active parameters per token (for 6·N_active·D model FLOPs)."""
        d, hd = self.d_model, self.head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.moe is not None:
            ff = self.moe.top_k * 3 * d * self.moe.d_ff + d * self.moe.n_experts
        else:
            ff = 3 * d * self.d_ff
        per_layer = attn + ff + 2 * d
        return self.n_layers * per_layer + self.vocab_size * d + d


LM_SHAPES = (
    ShapeSpec("train_4k", "train", dict(seq_len=4096, global_batch=256)),
    ShapeSpec("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
    ShapeSpec("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
    ShapeSpec("long_500k", "decode", dict(seq_len=524288, global_batch=1)),
)


# ---------------------------------------------------------------------------
# Retriever family (the paper's own models)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RetrieverConfig:
    """ColX-style late-interaction retriever.

    ``geometry`` keys the paper's model-aware pooling:
      - "tiles":   ColSmol — n_tiles tile groups of P patches + 1 global tile
      - "grid":    ColPali — fixed grid_h × grid_w patch grid
      - "dynamic": ColQwen — variable H_eff×W_eff grid after 2×2 PatchMerger
    """

    name: str
    geometry: str
    d_model: int
    n_layers: int
    n_heads: int
    d_ff: int
    out_dim: int = 128
    grid_h: int = 32
    grid_w: int = 32
    tile_patches: int = 64        # P, patches per tile (tiles geometry)
    n_tiles: int = 13             # incl. global tile
    max_rows: int = 32            # adaptive pooling target T
    n_special: int = 6            # non-visual tokens emitted by processor
    max_query_tokens: int = 32
    query_vocab: int = 32768
    pool: str = "rows"            # rows | tiles | adaptive
    smooth: str = "none"          # none | conv1d | gaussian | triangular
    dtype: str = "bfloat16"

    @property
    def family(self) -> str:
        return "retriever"

    @property
    def n_patches(self) -> int:
        if self.geometry == "tiles":
            return self.n_tiles * self.tile_patches
        return self.grid_h * self.grid_w

    @property
    def seq_len(self) -> int:
        return self.n_patches + self.n_special

    @property
    def n_pooled(self) -> int:
        """Static pooled-vector count (dynamic geometry pads to max_rows
        with a validity mask; pages with H_eff < T are not upsampled)."""
        if self.geometry == "tiles":
            return self.n_tiles
        if self.geometry == "dynamic":
            return self.max_rows
        if self.smooth == "conv1d":
            return self.grid_h + 2
        return self.grid_h


RETRIEVER_SHAPES = (
    ShapeSpec("index_1m", "index", dict(pages_per_step=256, corpus=1_000_000)),
    ShapeSpec("search_1m", "search", dict(query_batch=64, corpus=1_000_000,
                                          prefetch_k=256, top_k=100)),
    ShapeSpec("train_contrastive", "train", dict(global_batch=256)),
)


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int
    d_hidden: int                 # sphere channels
    l_max: int
    m_max: int
    n_heads: int
    d_feat_default: int = 128
    d_edge_rbf: int = 32          # radial basis size
    d_attn_hidden: int = 64
    norm_eps: float = 1e-5
    remat: bool = True
    dtype: str = "bfloat16"
    msg_dtype: str = "float32"    # per-edge pipeline dtype (bf16 at pod scale)
    fused_rotation: bool = False  # fuse rotate+truncate / expand+rotate-back

    @property
    def family(self) -> str:
        return "gnn"

    @property
    def n_sph(self) -> int:
        """Number of real spherical-harmonic coefficients, (l_max+1)^2."""
        return (self.l_max + 1) ** 2

    @property
    def n_sph_m(self) -> int:
        """Coefficients retained under the eSCN m<=m_max truncation."""
        return sum(min(2 * self.m_max + 1, 2 * l + 1) for l in range(self.l_max + 1))


GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "full_graph",
              dict(n_nodes=2708, n_edges=10556, d_feat=1433)),
    ShapeSpec("minibatch_lg", "minibatch",
              dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                   fanout=(15, 10), d_feat=602)),
    ShapeSpec("ogb_products", "full_graph",
              dict(n_nodes=2449029, n_edges=61859140, d_feat=100)),
    ShapeSpec("molecule", "batched_graphs",
              dict(n_nodes=30, n_edges=64, batch=128, d_feat=16)),
)


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

# Criteo-Kaggle categorical cardinalities (26 fields) — used by dcn-v2/autoint.
CRITEO_KAGGLE_VOCABS = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
)
# Criteo-1TB MLPerf cardinalities (26 fields) — used by dlrm-mlperf;
# ``chip_smoke.py`` also sizes its largest ``embed_bag`` table from the
# largest field.
CRITEO_TB_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771, 25641295,
    39664984, 585935, 12972, 108, 36,
)


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    interaction: str              # cross | self_attn | bidir_seq | dot
    n_dense: int = 0
    n_sparse: int = 0
    embed_dim: int = 16
    vocab_sizes: tuple = ()
    # interaction-specific
    n_cross_layers: int = 0
    n_attn_layers: int = 0
    n_heads: int = 0
    d_attn: int = 0
    seq_len: int = 0              # bert4rec history length
    n_items: int = 0              # bert4rec item vocab
    n_blocks: int = 0
    bot_mlp: tuple = ()
    top_mlp: tuple = ()
    mlp: tuple = ()
    table_optimizer: str = "rowwise_adagrad"
    dtype: str = "float32"

    @property
    def family(self) -> str:
        return "recsys"

    def n_params(self) -> int:
        n = sum(self.vocab_sizes) * self.embed_dim
        n += self.n_items * self.embed_dim
        return n  # embedding-dominated; dense params counted at runtime


RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", dict(batch=65536)),
    ShapeSpec("serve_p99", "serve", dict(batch=512)),
    ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
    ShapeSpec("retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000)),
)
