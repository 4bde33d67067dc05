"""dcn-v2 [recsys]: 13 dense + 26 sparse, embed_dim=16, 3 cross layers,
MLP 1024-1024-512, cross interaction. [arXiv:2008.13535]
"""
from repro_torch.configs.base import RecsysConfig, RECSYS_SHAPES, CRITEO_KAGGLE_VOCABS

CONFIG = RecsysConfig(
    name="dcn-v2",
    interaction="cross",
    n_dense=13,
    n_sparse=26,
    embed_dim=16,
    vocab_sizes=CRITEO_KAGGLE_VOCABS,
    n_cross_layers=3,
    mlp=(1024, 1024, 512),
)
SHAPES = RECSYS_SHAPES
