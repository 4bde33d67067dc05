from repro_torch.configs.base import CRITEO_TB_VOCABS, RetrieverConfig
from repro_torch.configs.registry import PAPER_ARCHS, get_config

__all__ = ["CRITEO_TB_VOCABS", "RetrieverConfig", "PAPER_ARCHS",
           "get_config"]
