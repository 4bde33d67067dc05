"""minicpm-2b [dense]: 40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753.

Llama-like dense architecture trained with a WSD (warmup-stable-decay)
schedule; the WSD schedule is implemented in training/optimizer.py and is
the default for this config. [arXiv:2404.06395; hf]
"""
from repro_torch.configs.base import LMConfig, LM_SHAPES

CONFIG = LMConfig(
    name="minicpm-2b",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    attn_pattern=(0,),               # pure full attention
    act="silu",
)
SHAPES = LM_SHAPES
