"""The retriever config dataclass (the paper's late-interaction models).

Pure data: importing a config touches no device state.
"""
from __future__ import annotations

from dataclasses import dataclass


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


# Criteo-1TB MLPerf categorical cardinalities (26 fields), the EmbeddingBag
# table sizes of the DLRM seed family; ``chip_smoke.py`` sizes its largest
# ``embed_bag`` table from the largest field.
CRITEO_TB_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771, 25641295,
    39664984, 585935, 12972, 108, 36,
)
