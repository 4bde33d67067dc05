"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.

Local+global alternating attention (4096-token sliding window on odd layers),
attention/final logit soft-capping. [arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import LMConfig, LM_SHAPES

CONFIG = LMConfig(
    name="gemma2-9b",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=224,
    d_ff=14336,
    vocab_size=256000,
    attn_pattern=(4096, 0),          # local, global alternating
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
)
SHAPES = LM_SHAPES
