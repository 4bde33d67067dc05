from repro_torch.configs.base import (CRITEO_KAGGLE_VOCABS, CRITEO_TB_VOCABS,
                                      GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES,
                                      RETRIEVER_SHAPES, GNNConfig, LMConfig,
                                      MoESpec, RecsysConfig, RetrieverConfig,
                                      ShapeSpec)
from repro_torch.configs.registry import (ALL_ARCHS, ASSIGNED_ARCHS,
                                          GNN_ARCHS, LM_ARCHS, PAPER_ARCHS,
                                          RECSYS_ARCHS, get_cells,
                                          get_config, get_shapes)

__all__ = ["CRITEO_KAGGLE_VOCABS", "CRITEO_TB_VOCABS", "GNN_SHAPES",
           "LM_SHAPES", "RECSYS_SHAPES", "RETRIEVER_SHAPES", "GNNConfig",
           "LMConfig", "MoESpec", "RecsysConfig", "RetrieverConfig",
           "ShapeSpec", "ALL_ARCHS", "ASSIGNED_ARCHS", "GNN_ARCHS",
           "LM_ARCHS", "PAPER_ARCHS", "RECSYS_ARCHS", "get_cells",
           "get_config", "get_shapes"]
