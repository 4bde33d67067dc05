"""autoint [recsys]: 39 sparse fields, embed_dim=16, 3 self-attention layers,
2 heads, d_attn=32. Dense features are bucketised into categorical fields
(vocab 128 each), per the AutoInt paper's Criteo protocol. [arXiv:1810.11921]
"""
from repro_torch.configs.base import RecsysConfig, RECSYS_SHAPES, CRITEO_KAGGLE_VOCABS

_DENSE_BUCKET_VOCABS = tuple([128] * 13)

CONFIG = RecsysConfig(
    name="autoint",
    interaction="self_attn",
    n_dense=0,
    n_sparse=39,
    embed_dim=16,
    vocab_sizes=_DENSE_BUCKET_VOCABS + CRITEO_KAGGLE_VOCABS,
    n_attn_layers=3,
    n_heads=2,
    d_attn=32,
)
SHAPES = RECSYS_SHAPES
