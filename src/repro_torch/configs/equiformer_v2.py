"""equiformer-v2 [gnn]: 12L d_hidden=128 l_max=6 m_max=2 n_heads=8,
SO(2)-eSCN equivariant graph attention. [arXiv:2306.12059]
"""
from repro_torch.configs.base import GNNConfig, GNN_SHAPES

CONFIG = GNNConfig(
    name="equiformer-v2",
    n_layers=12,
    d_hidden=128,
    l_max=6,
    m_max=2,
    n_heads=8,
)
SHAPES = GNN_SHAPES
