"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512,
vocab=49155, MoE 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import LMConfig, LM_SHAPES, MoESpec

CONFIG = LMConfig(
    name="granite-moe-1b-a400m",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    attn_pattern=(0,),
    act="silu",
    moe=MoESpec(n_experts=32, top_k=8, d_ff=512),
)
SHAPES = LM_SHAPES
