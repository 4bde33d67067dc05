"""colsmol-style retriever: tile-grid geometry (ColSmol-500M analogue).

Pages are resized to 512x512 and cut into a 4x3 tile grid (12 tiles) plus
1 global tile, each yielding P=64 patch tokens (832 visual tokens).
Pooling: tile-level mean (Eq. 2), 832 -> 13 vectors.
[hf:vidore/colSmol-500M]
"""
from repro_torch.configs.base import RETRIEVER_SHAPES, RetrieverConfig

CONFIG = RetrieverConfig(
    name="colsmol",
    geometry="tiles",
    d_model=768,
    n_layers=12,
    n_heads=12,
    d_ff=3072,
    out_dim=128,
    tile_patches=64,
    n_tiles=13,
    n_special=6,
    pool="tiles",
    smooth="none",
)
SHAPES = RETRIEVER_SHAPES
