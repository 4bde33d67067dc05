from repro_torch.configs.base import (CRITEO_KAGGLE_VOCABS, CRITEO_TB_VOCABS,
                                      LM_SHAPES, RECSYS_SHAPES, LMConfig,
                                      MoESpec, RecsysConfig, RetrieverConfig,
                                      ShapeSpec)
from repro_torch.configs.registry import (LM_ARCHS, PAPER_ARCHS,
                                          RECSYS_ARCHS, get_config)

__all__ = ["CRITEO_KAGGLE_VOCABS", "CRITEO_TB_VOCABS", "LM_SHAPES",
           "RECSYS_SHAPES", "LMConfig", "MoESpec", "RecsysConfig",
           "RetrieverConfig", "ShapeSpec", "LM_ARCHS", "PAPER_ARCHS",
           "RECSYS_ARCHS", "get_config"]
