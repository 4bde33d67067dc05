from repro_torch.configs.base import (CRITEO_TB_VOCABS, LM_SHAPES, LMConfig,
                                      MoESpec, RetrieverConfig, ShapeSpec)
from repro_torch.configs.registry import LM_ARCHS, PAPER_ARCHS, get_config

__all__ = ["CRITEO_TB_VOCABS", "LM_SHAPES", "LMConfig", "MoESpec",
           "RetrieverConfig", "ShapeSpec", "LM_ARCHS", "PAPER_ARCHS",
           "get_config"]
