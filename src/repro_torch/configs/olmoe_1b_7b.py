"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16) d_ff=1024 vocab=50304,
MoE 64 experts top-8. [arXiv:2409.02060]
"""
from repro_torch.configs.base import LMConfig, LM_SHAPES, MoESpec

CONFIG = LMConfig(
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    attn_pattern=(0,),
    act="silu",
    moe=MoESpec(n_experts=64, top_k=8, d_ff=1024),
)
SHAPES = LM_SHAPES
