"""dlrm-mlperf [recsys]: MLPerf DLRM benchmark config (Criteo 1TB).

13 dense + 26 sparse, embed_dim=128, bottom MLP 13-512-256-128,
top MLP 1024-1024-512-256-1, dot interaction. ~188M embedding rows
(vocab-sharded over the model axis). [arXiv:1906.00091]
"""
from repro_torch.configs.base import RecsysConfig, RECSYS_SHAPES, CRITEO_TB_VOCABS

CONFIG = RecsysConfig(
    name="dlrm-mlperf",
    interaction="dot",
    n_dense=13,
    n_sparse=26,
    embed_dim=128,
    vocab_sizes=CRITEO_TB_VOCABS,
    bot_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
)
SHAPES = RECSYS_SHAPES
