"""colqwen-style retriever: dynamic-resolution geometry (ColQwen2.5 analogue).

Variable H_eff x W_eff grid after a learned 2x2 PatchMerger. Pooling:
adaptive row-mean to <= T=32 rows after a same-length Gaussian smoothing
(Eq. 5; sigma=max(0.5, r/2)). [hf:vidore/colqwen2.5-v0.2]
"""
from repro_torch.configs.base import RETRIEVER_SHAPES, RetrieverConfig

CONFIG = RetrieverConfig(
    name="colqwen",
    geometry="dynamic",
    d_model=1024,
    n_layers=16,
    n_heads=16,
    d_ff=4096,
    out_dim=128,
    grid_h=28,                    # H_eff upper bound used for static shapes
    grid_w=28,
    max_rows=32,
    n_special=8,
    pool="adaptive",
    smooth="gaussian",
)
SHAPES = RETRIEVER_SHAPES
