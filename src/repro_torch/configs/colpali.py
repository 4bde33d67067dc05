"""colpali-style retriever: fixed-grid geometry (ColPali-v1.3 analogue).

Fixed 32x32 patch grid (1024 visual tokens, d=128 late-interaction dim).
Pooling: row-wise mean (Eq. 3), 1024 -> 32, followed by the conv1d uniform
sliding window (Eq. 4, k=3, boundary extension, 32 -> 34).
[arXiv:2407.01449]
"""
from repro_torch.configs.base import RETRIEVER_SHAPES, RetrieverConfig

CONFIG = RetrieverConfig(
    name="colpali",
    geometry="grid",
    d_model=1024,
    n_layers=16,
    n_heads=16,
    d_ff=4096,
    out_dim=128,
    grid_h=32,
    grid_w=32,
    n_special=6,
    pool="rows",
    smooth="conv1d",
)
SHAPES = RETRIEVER_SHAPES
