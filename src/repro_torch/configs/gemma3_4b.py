"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local:global attention pattern (1024-token window), 128k context.
[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import LMConfig, LM_SHAPES

CONFIG = LMConfig(
    name="gemma3-4b",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=320,
    d_ff=10240,
    vocab_size=262144,
    attn_pattern=(1024, 1024, 1024, 1024, 1024, 0),   # 5 local : 1 global
    rope_theta=1_000_000.0,
    act="gelu",
)
SHAPES = LM_SHAPES
