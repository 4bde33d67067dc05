"""bert4rec [recsys]: embed_dim=64, 2 transformer blocks, 2 heads,
seq_len=200, bidirectional sequential interaction. Item vocabulary sized to
the retrieval_cand cell (10^6 candidates). [arXiv:1904.06690]

This is the most paper-representative assigned arch: ``retrieval_cand``
scores one encoded user sequence against 1M item candidates and runs the
toolkit's multi-stage search (truncated-dim prefetch -> exact rerank).
"""
from repro_torch.configs.base import RecsysConfig, RECSYS_SHAPES

CONFIG = RecsysConfig(
    name="bert4rec",
    interaction="bidir_seq",
    embed_dim=64,
    n_blocks=2,
    n_heads=2,
    seq_len=200,
    n_items=1_000_000,
    mlp=(256,),
)
SHAPES = RECSYS_SHAPES
