from repro_torch.configs.base import (CRITEO_KAGGLE_VOCABS, CRITEO_TB_VOCABS,
                                      GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES,
                                      GNNConfig, LMConfig, MoESpec,
                                      RecsysConfig, RetrieverConfig,
                                      ShapeSpec)
from repro_torch.configs.registry import (GNN_ARCHS, LM_ARCHS, PAPER_ARCHS,
                                          RECSYS_ARCHS, get_config)

__all__ = ["CRITEO_KAGGLE_VOCABS", "CRITEO_TB_VOCABS", "GNN_SHAPES",
           "LM_SHAPES", "RECSYS_SHAPES", "GNNConfig", "LMConfig", "MoESpec",
           "RecsysConfig", "RetrieverConfig", "ShapeSpec", "GNN_ARCHS",
           "LM_ARCHS", "PAPER_ARCHS", "RECSYS_ARCHS", "get_config"]
